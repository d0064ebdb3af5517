"""The PyTorch port's bf16 products (``ops/linalg.py``) against fugue_tpu,
on the CPU.

The same bf16 data and float64 parameters, made with numpy, go through
both packages (JAX in x64, torch with float64 on): the values of
``matmul_bf16``, ``matvec_bf16``, ``matmul_bf16x2`` and
``matmul_bf16x2_fastgrad`` are float32 and agree to 1e-6 relative, and so
do the split products' custom backwards (the cotangent split into hi and
lo, or rounded once) and ``matmul_bf16``'s autodiff gradient. Under
``vmap(grad_and_value)`` over C chains a gradient through
``matmul_bf16x2_fastgrad`` is three products whatever C is, and equals the
per-chain gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from fugue_tpu.ops import linalg as jla
from fugue_tpu_torch import settings
from fugue_tpu_torch.ops import linalg as tla

REL = dict(rtol=1e-6, atol=1e-6)
PRODUCTS = ("matmul_bf16", "matvec_bf16", "matmul_bf16x2", "matmul_bf16x2_fastgrad")


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def _data(n=40, d=12, p=None, seed=0):
    """bf16-representable data (N, D) and float64 parameters (D,) or (D, P)."""
    rng = np.random.default_rng(seed)
    x = np.asarray(jnp.asarray(rng.normal(size=(n, d)) / np.sqrt(d), jnp.bfloat16),
                   np.float64)
    w = rng.normal(size=(d,) if p is None else (d, p))
    return x, w


def _both(x, w):
    return (jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
            torch.tensor(x).to(torch.bfloat16), torch.tensor(w))


@pytest.mark.parametrize("name,p", [(n, p) for n in PRODUCTS for p in (None, 3)
                                     if not (n == "matvec_bf16" and p)])
def test_value_is_float32_and_matches_jax(name, p):
    jx, jw, tx, tw = _both(*_data(p=p))
    want = np.asarray(getattr(jla, name)(jx, jw))
    got = getattr(tla, name)(tx, tw)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, **REL)


@pytest.mark.parametrize("name", ("matmul_bf16", "matmul_bf16x2", "matmul_bf16x2_fastgrad"))
@pytest.mark.parametrize("p", [None, 3], ids=["vector", "matrix"])
def test_backward_matches_jax(name, p):
    x, w = _data(p=p, seed=1)
    cot = np.random.default_rng(2).normal(size=(x.shape[0],) if p is None else (x.shape[0], p))
    jx, jw, tx, tw = _both(x, w)
    xf, xt = jnp.asarray(x), torch.tensor(x, requires_grad=True)

    def jloss(a, b):
        return jnp.sum(jnp.asarray(cot) * getattr(jla, name)(a, b))

    jga, jgw = jax.grad(jloss, argnums=(0, 1))(xf, jw)
    tw.requires_grad_(True)
    loss = torch.sum(torch.tensor(cot) * getattr(tla, name)(xt, tw))
    tga, tgw = torch.autograd.grad(loss, (xt, tw))
    np.testing.assert_allclose(tgw.numpy(), np.asarray(jgw), **REL)
    np.testing.assert_allclose(tga.numpy(), np.asarray(jga), **REL)


@pytest.mark.parametrize("c", [1, 4, 16])
def test_chain_batch_is_three_products(c):
    x, _ = _data(n=64, d=10, seed=3)
    rng = np.random.default_rng(4)
    y = torch.tensor(rng.integers(0, 2, 64), dtype=torch.float64)
    ws = torch.tensor(rng.normal(size=(c, 10)))
    tx = torch.tensor(x).to(torch.bfloat16)

    def potential(w):
        logits = tla.matmul_bf16x2_fastgrad(tx, w).to(torch.float64)
        return -torch.sum(y * logits - torch.nn.functional.softplus(logits))

    before = tla.GEMMS["cpu"]
    g, v = vmap(grad_and_value(potential))(ws)
    assert tla.GEMMS["cpu"] - before == 3
    for i in range(c):
        gi, vi = grad_and_value(potential)(ws[i])
        np.testing.assert_allclose(g[i].numpy(), gi.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(v[i].item(), vi.item(), rtol=1e-6)


def test_split_forward_keeps_parameter_precision():
    """hi + lo keeps about 16 bits of w: the split product is far closer
    to the float64 product of the same bf16 data than one bf16 pass."""
    x, w = _data(n=200, d=64, seed=5)
    _, _, tx, tw = _both(x, w)
    exact = x @ w
    one = np.abs(tla.matmul_bf16(tx, tw).numpy() - exact).max()
    split = np.abs(tla.matmul_bf16x2(tx, tw).numpy() - exact).max()
    assert split < one / 50
    assert split < 1e-5 * np.abs(exact).max()


def test_card_route_is_the_float32_out_dtype_product():
    """A CUDA tensor takes torch.mm(..., out_dtype=float32) or raises; no
    other route exists for it (checked on the card by the gpu tests)."""
    import inspect

    src = inspect.getsource(tla._gemm)
    assert "out_dtype=torch.float32" in src
    with pytest.raises(NotImplementedError):
        tla._gemm(torch.zeros((2, 2), dtype=torch.bfloat16, device="meta"),
                  torch.zeros((2, 2), dtype=torch.bfloat16, device="meta"))


def test_batched_design_matrices_match_per_member():
    """A batch of design matrices (with or without a batch of parameter
    vectors) takes one product per member, equal to the unbatched calls."""
    rng = np.random.default_rng(6)
    xs = torch.tensor(rng.normal(size=(3, 20, 5))).to(torch.bfloat16)
    ws = torch.tensor(rng.normal(size=(3, 5)))
    for name in ("matmul_bf16x2", "matmul_bf16x2_fastgrad"):
        f = getattr(tla, name)
        both = vmap(f)(xs, ws)
        only_x = vmap(lambda m: f(m, ws[0]))(xs)
        for i in range(3):
            np.testing.assert_array_equal(both[i].numpy(), f(xs[i], ws[i]).numpy())
            np.testing.assert_array_equal(only_x[i].numpy(), f(xs[i], ws[0]).numpy())
