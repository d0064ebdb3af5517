"""The Gaussian-plate likelihood kernel of the PyTorch port, on the CPU.

On the CPU the wrapper runs its plain PyTorch version; that version is held
against fugue_tpu's ``pnormal_loglik_sum`` run as tests/test_pallas_kernels.py
runs it (Pallas forced on, in TPU interpret mode), in float64 at
N = 2*8192 + 100 (a ragged tail past two 8192-element tiles), relative
tolerance 1e-9. The CUDA kernel itself runs only on a card: its test is
marked ``gpu`` and skips here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from fugue_tpu.ops import pallas_kernels as pk
from fugue_tpu_torch import settings
from fugue_tpu_torch.ops import _build
from fugue_tpu_torch.ops import kernels as K

N = 2 * 8192 + 100
PARAMS = [(1.5, 2.0), (0.3, 0.7), (-2.0, 5.0)]


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


@pytest.fixture
def pallas_interpret():
    from jax.experimental.pallas import tpu as pltpu

    pk.enable_pallas(True)
    try:
        with pltpu.force_tpu_interpret_mode():
            yield
    finally:
        pk.enable_pallas(None)


def _y(n=N, seed=5):
    return np.random.default_rng(seed).normal(1.5, 2.0, n)


@pytest.mark.parametrize("mu, sigma", PARAMS)
def test_plain_version_matches_pallas_interpret(pallas_interpret, mu, sigma):
    y = _y()
    jv, (jdy, jdmu, jds) = jax.value_and_grad(pk.pnormal_loglik_sum, argnums=(0, 1, 2))(
        jnp.asarray(y), jnp.asarray(mu), jnp.asarray(sigma)
    )
    yt = torch.tensor(y, requires_grad=True)
    mt = torch.tensor(mu, dtype=torch.float64, requires_grad=True)
    st = torch.tensor(sigma, dtype=torch.float64, requires_grad=True)
    out = K.pnormal_loglik_sum(yt, mt, st)
    out.backward()
    np.testing.assert_allclose(out.item(), float(jv), rtol=1e-9)
    np.testing.assert_allclose(mt.grad.item(), float(jdmu), rtol=1e-9)
    np.testing.assert_allclose(st.grad.item(), float(jds), rtol=1e-9)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(jdy), rtol=1e-9, atol=1e-12)


def test_batched_form_equals_unbatched_calls():
    """C=5 chains in one call equal five scalar calls (1e-12 relative)."""
    y = torch.as_tensor(_y())
    rng = np.random.default_rng(6)
    mu = torch.as_tensor(rng.normal(1.5, 0.3, 5))
    sigma = torch.as_tensor(np.exp(rng.normal(0.7, 0.2, 5)))
    out = K.pnormal_loglik_sum(y, mu, sigma)
    dmu, dsig = K.pnormal_loglik_sum_grad(y, mu, sigma)
    assert out.shape == dmu.shape == dsig.shape == (5,)
    for c in range(5):
        np.testing.assert_allclose(
            out[c].item(), K.pnormal_loglik_sum(y, mu[c], sigma[c]).item(), rtol=1e-12)
        gm, gs = K.pnormal_loglik_sum_grad(y, mu[c], sigma[c])
        np.testing.assert_allclose(dmu[c].item(), gm.item(), rtol=1e-12)
        np.testing.assert_allclose(dsig[c].item(), gs.item(), rtol=1e-12)


def test_vmap_grad_and_value_enters_once_per_batch(monkeypatch):
    """vmap(grad_and_value(U)) over 7 chains runs the forward and the
    backward once each, on the whole batch, and matches per-chain calls."""
    calls = {"fwd": [], "bwd": []}
    fwd, bwd = K.normal_loglik_sum_ref, K.normal_loglik_sum_grad_ref

    def count_fwd(y, mu, sigma):
        calls["fwd"].append(tuple(mu.shape))
        return fwd(y, mu, sigma)

    def count_bwd(y, mu, sigma):
        calls["bwd"].append(tuple(mu.shape))
        return bwd(y, mu, sigma)

    monkeypatch.setattr(K, "normal_loglik_sum_ref", count_fwd)
    monkeypatch.setattr(K, "normal_loglik_sum_grad_ref", count_bwd)
    y = torch.as_tensor(_y())

    def potential(q):
        return -K.pnormal_loglik_sum(y, q[0], torch.exp(q[1]))

    q = torch.as_tensor(np.random.default_rng(7).normal([1.5, 0.7], 0.1, (7, 2)))
    g, v = vmap(grad_and_value(potential))(q)
    assert calls == {"fwd": [(7,)], "bwd": [(7,)]}
    for c in range(7):
        qc = q[c].clone().requires_grad_(True)
        u = potential(qc)
        (gc,) = torch.autograd.grad(u, qc)
        np.testing.assert_allclose(v[c].item(), u.item(), rtol=1e-12)
        np.testing.assert_allclose(g[c].numpy(), gc.numpy(), rtol=1e-12)


def test_scalar_params_and_broadcast():
    y = torch.as_tensor(_y(1000))
    a = K.pnormal_loglik_sum(y, 1.5, torch.tensor([2.0, 3.0], dtype=torch.float64))
    b = K.normal_loglik_sum_ref(y, torch.tensor([1.5, 1.5], dtype=torch.float64),
                                torch.tensor([2.0, 3.0], dtype=torch.float64))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)
    two_d = K.pnormal_loglik_sum(y.reshape(10, 100), 1.5, 2.0)
    np.testing.assert_allclose(two_d.item(), a[0].item(), rtol=1e-12)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    y = torch.zeros(10, dtype=torch.float64)
    with pytest.raises(TypeError):
        K.pnormal_loglik_sum(y, torch.tensor(0.0, dtype=torch.float32), 1.0)
    with pytest.raises(ValueError):
        K.pnormal_loglik_sum(y.to("meta"), 0.0, 1.0)
    f32 = torch.zeros(10, dtype=torch.float32)
    with pytest.raises(TypeError):
        K._check_launch(y, f32[:1], f32[:1])
    with pytest.raises(ValueError):
        K._check_launch(y, y[::2], y[::2])  # not contiguous
    with pytest.raises(ValueError):
        K._check_launch(y, y[:2], y[:3])
    with pytest.raises(TypeError):
        K._check_launch(y.to(torch.int64), y[:1], y[:1])


@pytest.mark.parametrize("n, c", [(1, 1), (100, 3), (N, 64), (1 << 24, 1), ((1 << 20) + 17, 3)])
def test_block_partition_covers_every_row(n, c):
    nb = K._n_blocks(n, c)
    chunk = -(-n // nb)
    assert 1 <= nb <= 2048 and nb * chunk >= n and (nb - 1) * chunk < n


def test_library_name_carries_the_source_hash():
    h = _build.source_hash("normal_loglik_sum")
    assert len(h) == 16 and h == _build.source_hash("normal_loglik_sum")
    path = _build.library_path("normal_loglik_sum")
    assert path.name == f"libnormal_loglik_sum_{h}.so"
    assert path.parent == _build.BUILD_DIR
    assert (_build.CSRC / "normal_loglik_sum.cu").is_file()


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """On a card: the kernel launches (and counts) and agrees with the plain
    float64 version to 1e-12 relative, and the float32 kernel is no further
    from float64 than the plain float32 version (or one float32 eps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    n = (1 << 20) + 17
    y = 1.5 + 2.0 * torch.randn(n, generator=g, device="cuda", dtype=torch.float64)
    mu = 1.5 + 0.01 * torch.randn(3, generator=g, device="cuda", dtype=torch.float64)
    sigma = torch.full((3,), 2.0, device="cuda", dtype=torch.float64)
    before = dict(K.LAUNCHES)
    out = K.pnormal_loglik_sum(y, mu, sigma)
    dmu, dsig = K.pnormal_loglik_sum_grad(y, mu, sigma)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fwd"] == before["fwd"] + 1
    assert K.LAUNCHES["bwd"] == before["bwd"] + 1
    pairs = [(out, K.normal_loglik_sum_ref(y, mu, sigma))]
    pairs += list(zip((dmu, dsig), K.normal_loglik_sum_grad_ref(y, mu, sigma)))
    for k, p in pairs:
        torch.testing.assert_close(k, p, rtol=1e-12, atol=1e-9)
    y32, mu32, s32 = y.float(), mu.float(), sigma.float()
    ref = K.normal_loglik_sum_ref(y32.double(), mu32.double(), s32.double())
    k_err = (K.pnormal_loglik_sum(y32, mu32, s32).double() - ref).abs()
    p_err = (K.normal_loglik_sum_ref(y32, mu32, s32).double() - ref).abs()
    eps = torch.finfo(torch.float32).eps
    assert bool((k_err <= torch.maximum(p_err, eps * ref.abs())).all())
