"""The PyTorch port's transforms and numerics against fugue_tpu's, on the CPU.

- Forward, inverse and log|J| of ``Sigmoid``, ``AffineSigmoid`` (Python and
  per-element tensor bounds) and ``StickBreaking`` equal to JAX within 1e-12
  in float64, and their gradients.
- ``StickBreaking``'s log|J| against ``torch.autograd.functional.jacobian``:
  the log-determinant of the Jacobian of the first k − 1 coordinates.
- In float32, |z| >= 30 gives a finite log|J| and finite gradients, where
  the forward value has already rounded to the boundary.
- The numerics functions against JAX within 1e-12.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from fugue_tpu.core import numerics as jnum
from fugue_tpu.core import transforms as jtr
from fugue_tpu_torch import settings
from fugue_tpu_torch.core import numerics as tnum
from fugue_tpu_torch.core import transforms as ttr

TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def _z(shape, seed=0, scale=2.5):
    return np.random.default_rng(seed).normal(0.0, scale, shape)


def _pair(name, k=4):
    """(JAX transform, port transform, z) for one case."""
    if name == "sigmoid":
        return jtr.Sigmoid(), ttr.Sigmoid(), _z(40)
    if name == "affine_sigmoid":
        return jtr.AffineSigmoid(-1.5, 2.0), ttr.AffineSigmoid(-1.5, 2.0), _z(40, 1)
    if name == "affine_sigmoid_tensor_bounds":
        r = np.random.default_rng(2)
        lo = r.normal(0, 1, 40)
        hi = lo + np.exp(r.normal(0, 1, 40))
        return (jtr.AffineSigmoid(jnp.asarray(lo), jnp.asarray(hi)),
                ttr.AffineSigmoid(torch.as_tensor(lo), torch.as_tensor(hi)), _z(40, 3))
    if name.startswith("stick_breaking"):
        k = int(name.split("_")[-1])
        return jtr.StickBreaking(k), ttr.StickBreaking(k), _z((6, k - 1), k)
    raise KeyError(name)


CASES = ["sigmoid", "affine_sigmoid", "affine_sigmoid_tensor_bounds",
         "stick_breaking_2", "stick_breaking_3", "stick_breaking_5"]


@pytest.mark.parametrize("name", CASES)
def test_forward_inverse_and_log_det_match_jax(name):
    jt, tt, z = _pair(name)
    zt = torch.as_tensor(z)
    x = tt.forward(zt)
    np.testing.assert_allclose(x.numpy(), np.asarray(jt.forward(jnp.asarray(z))), **TOL)
    np.testing.assert_allclose(tt.inverse(x).numpy(), np.asarray(jt.inverse(jnp.asarray(x.numpy()))),
                               **TOL)
    np.testing.assert_allclose(tt.inverse(x).numpy(), z, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tt.log_det_jacobian(zt).numpy(),
                               np.asarray(jt.log_det_jacobian(jnp.asarray(z))), **TOL)


@pytest.mark.parametrize("name", CASES)
def test_log_det_gradient_matches_jax(name):
    jt, tt, z = _pair(name)
    jg = jax.grad(lambda v: jnp.sum(jt.log_det_jacobian(v)) + jnp.sum(jt.forward(v) ** 2))(
        jnp.asarray(z))
    tg = grad(lambda v: torch.sum(tt.log_det_jacobian(v)) + torch.sum(tt.forward(v) ** 2))(
        torch.as_tensor(z))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("k", [2, 3, 5, 8])
def test_stick_breaking_log_det_is_the_jacobian_log_det(k):
    t = ttr.StickBreaking(k)
    assert t.unconstrained_shape((7, k)) == (7, k - 1)
    with pytest.raises(ValueError):
        t.unconstrained_shape((k + 1,))
    for seed in range(4):
        z = torch.as_tensor(_z(k - 1, seed, 1.5))
        jac = torch.autograd.functional.jacobian(lambda v: t.forward(v)[: k - 1], z)
        want = torch.linalg.slogdet(jac).logabsdet.item()
        assert t.log_det_jacobian(z).item() == pytest.approx(want, rel=1e-10, abs=1e-10)
        x = t.forward(z)
        assert bool((x > 0).all()) and abs(x.sum().item() - 1.0) < 1e-12


@pytest.mark.parametrize("name", CASES)
def test_float32_extremes_keep_log_det_finite(name):
    _, tt, z = _pair(name)
    settings.enable_x64(False)
    ext = torch.as_tensor(np.sign(z) * (30.0 + 20.0 * np.abs(np.random.default_rng(9).uniform(
        size=z.shape))), dtype=torch.float32)
    if isinstance(tt, ttr.AffineSigmoid) and isinstance(tt.low, torch.Tensor):
        tt = ttr.AffineSigmoid(tt.low.float(), tt.high.float())
    ld = tt.log_det_jacobian(ext)
    assert ld.dtype == torch.float32 and bool(torch.isfinite(ld).all())
    g = grad(lambda v: torch.sum(tt.log_det_jacobian(v)))(ext)
    assert bool(torch.isfinite(g).all())
    # a log of the forward value would be -inf here: it has rounded to the boundary
    x = tt.forward(ext)
    assert bool(torch.isfinite(x).all())


def test_unconstrained_shape_of_elementwise_transforms():
    for t in (ttr.Identity(), ttr.Exp(), ttr.Sigmoid(), ttr.AffineSigmoid(0.0, 1.0)):
        assert t.unconstrained_shape((3, 2)) == (3, 2)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------


def _x(shape=(5, 30), seed=4, scale=4.0):
    x = np.random.default_rng(seed).normal(0.0, scale, shape)
    x[1] = -np.inf  # a row with no mass
    x[2, :5] = -np.inf
    return x


NUMERICS = {
    "weighted_log_sum_exp": (lambda m, x: m.weighted_log_sum_exp(x, x[::-1] * 0.5),
                             lambda m, x: m.weighted_log_sum_exp(x, torch.flip(x, [0]) * 0.5)),
    "normalize_log_probs": (lambda m, x: m.normalize_log_probs(x),
                            lambda m, x: m.normalize_log_probs(x)),
    "safe_log": (lambda m, x: m.safe_log(x), lambda m, x: m.safe_log(x)),
    "safe_log_floor": (lambda m, x: m.safe_log(x, 0.5), lambda m, x: m.safe_log(x, 0.5)),
    "logit": (lambda m, x: m.logit(x), lambda m, x: m.logit(x)),
    "log_expm1": (lambda m, x: m.log_expm1(x), lambda m, x: m.log_expm1(x)),
    "softplus": (lambda m, x: m.softplus(x), lambda m, x: m.softplus(x)),
    "inv_softplus": (lambda m, x: m.inv_softplus(x), lambda m, x: m.inv_softplus(x)),
    "log_gamma": (lambda m, x: m.log_gamma(x), lambda m, x: m.log_gamma(x)),
    "log1p_exp": (lambda m, x: m.log1p_exp(x), lambda m, x: m.log1p_exp(x)),
}


def _numerics_input(name):
    r = np.random.default_rng(len(name))
    if name in ("weighted_log_sum_exp", "normalize_log_probs"):
        return _x()
    if name == "logit":
        return r.uniform(0.0, 1.0, 60)
    if name in ("log_expm1", "inv_softplus", "log_gamma"):
        return np.concatenate([np.exp(r.normal(0, 2, 40)), [25.0, 1e-8, 21.0]])
    return np.concatenate([r.normal(0, 5, 50), [-40.0, 0.0, 40.0, 0.5]])


@pytest.mark.parametrize("name", sorted(NUMERICS))
def test_numerics_match_jax(name):
    jf, tf = NUMERICS[name]
    x = _numerics_input(name)
    want = np.asarray(jf(jnum, jnp.asarray(x)))
    got = tf(tnum, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if name == "normalize_log_probs":
        assert np.array_equal(got.numpy()[1], np.zeros(30))
        np.testing.assert_allclose(got.numpy()[[0, 2, 3, 4]].sum(-1), 1.0, **TOL)


@pytest.mark.parametrize("name", ["softplus", "log_expm1", "log_gamma", "logit", "safe_log"])
def test_numerics_gradient_matches_jax(name):
    jf, tf = NUMERICS[name]
    x = _numerics_input(name)
    if name == "safe_log":
        x = np.abs(x) + 0.1
    jg = jax.vmap(jax.grad(lambda v: jf(jnum, v)))(jnp.asarray(x))
    tg = vmap(grad(lambda v: tf(tnum, v)))(torch.as_tensor(x))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)


def test_log_beta_matches_jax_betaln_on_both_branches():
    from jax.scipy.special import betaln

    r = np.random.default_rng(6)
    a = np.concatenate([np.exp(r.normal(0, 1.5, 40)), [0.5, 7.9, 8.0, 1e3, 3e6]])
    b = np.concatenate([np.exp(r.normal(1, 1.5, 40)), [9.0, 8.1, 8.0, 2e3, 1e6]])
    want = np.asarray(betaln(jnp.asarray(a), jnp.asarray(b)))
    got = tnum.log_beta(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    jg = jax.vmap(jax.grad(betaln, argnums=(0, 1)))(jnp.asarray(a), jnp.asarray(b))
    tg = vmap(grad(tnum.log_beta, argnums=(0, 1)))(torch.as_tensor(a), torch.as_tensor(b))
    for t_, j_ in zip(tg, jg):
        np.testing.assert_allclose(t_.numpy(), np.asarray(j_), **TOL)
    assert math.isfinite(got[-1].item())
