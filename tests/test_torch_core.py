"""Parity of the PyTorch port's core layer with fugue_tpu, on the CPU.

Distributions (log_prob and its gradients), transforms, numerics, seeding,
addresses and eager validation. Inputs come from numpy with a fixed seed;
both packages run in float64. Tolerance 1e-12 (relative and absolute)
unless a test states otherwise: the formulas are the same, so only the
order of float64 operations differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from fugue_tpu.core import numerics as jnum
from fugue_tpu.core import transforms as jtr
from fugue_tpu.core.rng import address_seed as jax_address_seed
from fugue_tpu_torch import settings
from fugue_tpu_torch.core import numerics as tnum
from fugue_tpu_torch.core import transforms as ttr
from fugue_tpu_torch.core.distributions import POSITIVE, REAL, Support
from fugue_tpu_torch.core.rng import address_seed, site_seed
from fugue_tpu_torch.errors import ErrorCode, ValidationError
from fugue_tpu_torch.runtime.handler import run
from fugue_tpu_torch.runtime.interpreters import PriorHandler

TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def _grid():
    rng = np.random.default_rng(0)
    x = rng.normal(0.0, 3.0, 64)
    loc = rng.normal(0.0, 2.0, 64)
    scale = np.exp(rng.normal(0.0, 0.7, 64))
    return x, loc, scale


@pytest.mark.parametrize("name", ["Normal", "LogNormal"])
def test_log_prob_and_gradient_match_jax(name):
    x, loc, scale = _grid()
    if name == "LogNormal":
        x = np.abs(x) + 0.05
    jd, td = getattr(ft, name), getattr(ftt, name)

    def jlp(x, loc, scale):
        return jd(loc, scale).log_prob(x)

    want = np.asarray(jax.vmap(jlp)(x, loc, scale))
    jg = jax.vmap(jax.grad(jlp, argnums=(0, 1, 2)))(x, loc, scale)

    def tlp(x, loc, scale):
        return td(loc, scale).log_prob(x)

    xt, lt, st = (torch.as_tensor(a) for a in (x, loc, scale))
    got = vmap(tlp)(xt, lt, st)
    tg = vmap(grad(tlp, argnums=(0, 1, 2)))(xt, lt, st)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_lognormal_outside_support_is_minus_inf():
    lp = ftt.LogNormal(0.0, 1.0).log_prob(torch.tensor([-1.0, 0.0, 1.0], dtype=torch.float64))
    want = np.asarray(ft.LogNormal(0.0, 1.0).log_prob(jnp.array([-1.0, 0.0, 1.0])))
    np.testing.assert_array_equal(np.isinf(lp.numpy()), np.isinf(want))
    np.testing.assert_allclose(lp.numpy()[2], want[2], **TOL)


def test_python_scalar_parameters_stay_scalars():
    d = ftt.Normal(0.5, 2.0)
    assert isinstance(d.loc, float) and isinstance(d.scale, float)
    assert d.dtype == torch.float64
    lp = d.log_prob(torch.tensor([0.0, 1.0], dtype=torch.float32))
    assert lp.dtype == torch.float32  # scoring follows the value's dtype


@pytest.mark.parametrize("kind", ["identity", "exp"])
def test_transforms_match_jax(kind):
    z = np.random.default_rng(1).normal(0.0, 2.0, 50)
    jt = jtr.Identity() if kind == "identity" else jtr.Exp()
    tt = ttr.Identity() if kind == "identity" else ttr.Exp()
    zt = torch.as_tensor(z)
    x = tt.forward(zt)
    np.testing.assert_allclose(x.numpy(), np.asarray(jt.forward(z)), **TOL)
    np.testing.assert_allclose(tt.inverse(x).numpy(), z, **TOL)
    np.testing.assert_allclose(
        tt.log_det_jacobian(zt).numpy(), np.asarray(jt.log_det_jacobian(z)), **TOL
    )


def test_transform_for_support():
    assert isinstance(ttr.transform_for_support(REAL), ttr.Identity)
    assert isinstance(ttr.transform_for_support(POSITIVE), ttr.Exp)
    assert isinstance(ttr.transform_for_support(Support("unit")), ttr.Sigmoid)
    sb = ttr.transform_for_support(Support("simplex", size=3))
    assert isinstance(sb, ttr.StickBreaking) and sb.unconstrained_shape((2, 3)) == (2, 2)
    aff = ttr.transform_for_support(Support("interval", low=-1.0, high=2.0))
    assert isinstance(aff, ttr.AffineSigmoid) and (aff.low, aff.high) == (-1.0, 2.0)
    assert isinstance(ttr.transform_for_support(Support("interval")), ttr.Identity)
    assert isinstance(ttr.transform_for_support(Support("boolean")), ttr.Identity)


def test_log_sum_exp_matches_jax():
    x = np.random.default_rng(2).normal(0.0, 30.0, (6, 40))
    x[2] = -np.inf
    x[3, :5] = np.inf
    got = tnum.log_sum_exp(torch.as_tensor(x), dim=-1).numpy()
    want = np.asarray(jnum.log_sum_exp(x, axis=-1))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)
    np.testing.assert_allclose(
        tnum.log_sum_exp(torch.as_tensor(x[0]), keepdim=True).numpy(),
        np.asarray(jnum.log_sum_exp(x[0], keepdims=True)), **TOL,
    )


def test_log1p_exp_matches_jax():
    x = np.linspace(-60.0, 60.0, 241)
    np.testing.assert_allclose(
        tnum.log1p_exp(torch.as_tensor(x)).numpy(), np.asarray(jnum.log1p_exp(x)), **TOL
    )


@pytest.mark.parametrize("n", [100, 4096 * 3 + 17, 200_003])
def test_compensated_sum_matches_jax(n):
    x = np.random.default_rng(3).normal(-1.0, 5.0, n)
    got = tnum.compensated_sum(torch.as_tensor(x)).item()
    assert got == pytest.approx(float(jnum.compensated_sum(jnp.asarray(x))), rel=1e-12)


def test_compensated_sum_float32_beats_naive():
    """float32 input: the float64 accumulation lands within one float32 ulp
    of the exact sum, where a naive float32 running sum drifts further."""
    x = np.random.default_rng(4).normal(-0.5, 1.0, 1 << 20).astype(np.float32)
    exact = float(np.sum(x.astype(np.float64)))
    got = tnum.compensated_sum(torch.as_tensor(x))
    assert got.dtype == torch.float32
    assert abs(got.item() - exact) <= np.spacing(np.float32(abs(exact)))
    naive = np.float32(0.0)
    for chunk in np.split(x, 256):  # sequential float32 accumulation
        naive = np.float32(naive + np.sum(chunk, dtype=np.float32))
    assert abs(got.item() - exact) <= abs(float(naive) - exact)


def test_address_seed_matches_jax():
    for a in ["mu", "theta#3", ftt.addr("a#1"), ftt.addr("a", 1), "s::x#2"]:
        assert address_seed(a) == jax_address_seed(a)


def test_addresses_match_jax():
    pairs = [(("a#1",), ()), (("a",), (1,)), (("x",), (3, 4)), (("b\\c",), ())]
    for (name,), idx in pairs:
        assert str(ftt.addr(name, *idx)) == str(ft.addr(name, *idx))
    assert ftt.addr("a#1") != ftt.addr("a", 1)
    assert str(ftt.scoped_addr("s", "x", 2)) == str(ft.scoped_addr("s", "x", 2))
    assert ftt.addr("x", 3) is ftt.addr("x", 3)  # interned


def test_prior_draws_do_not_depend_on_site_order():
    def ab():
        ftt.sample("a", ftt.Normal(0.0, 1.0), (4,))
        ftt.sample("b", ftt.Normal(0.0, 1.0), (4,))

    def ba():
        ftt.sample("b", ftt.Normal(0.0, 1.0), (4,))
        ftt.sample("a", ftt.Normal(0.0, 1.0), (4,))

    _, t1 = run(PriorHandler(7, "cpu"), ab)
    _, t2 = run(PriorHandler(7, "cpu"), ba)
    _, t3 = run(PriorHandler(8, "cpu"), ab)
    for a in ("a", "b"):
        assert torch.equal(t1.choices[a].value, t2.choices[a].value)
        assert not torch.equal(t1.choices[a].value, t3.choices[a].value)
    assert not torch.equal(t1.choices["a"].value, t1.choices["b"].value)
    assert site_seed(7, "a") != site_seed(7, "b")


@pytest.mark.parametrize(
    "make, code",
    [
        (lambda: ftt.Normal(0.0, -1.0), ErrorCode.INVALID_VARIANCE),
        (lambda: ftt.Normal(float("nan"), 1.0), ErrorCode.INVALID_MEAN),
        (lambda: ftt.LogNormal(0.0, 0.0), ErrorCode.INVALID_VARIANCE),
        (lambda: ftt.Normal(torch.zeros(3), torch.tensor([1.0, -2.0, 1.0])),
         ErrorCode.INVALID_VARIANCE),
        (lambda: ftt.Normal(np.array([0.0, np.inf]), 1.0), ErrorCode.INVALID_MEAN),
    ],
)
def test_validation_errors_match_jax_codes(make, code):
    with pytest.raises(ValidationError) as e:
        make()
    assert e.value.code == code
    assert e.value.code == getattr(ft.ErrorCode, code.name)
    with pytest.raises(ft.ValidationError):
        ft.Normal(0.0, -1.0)


def test_no_validation_inside_a_transform():
    """Inside torch.func transforms parameters are never validated eagerly
    (the analog of skipping tracers): an invalid scale gives nan, not an
    error, and nothing is read back to the host."""

    def lp(scale):
        return ftt.Normal(0.0, scale).log_prob(torch.tensor(0.5, dtype=torch.float64))

    out = vmap(lp)(torch.tensor([1.0, -1.0], dtype=torch.float64))
    assert torch.isfinite(out[0]) and torch.isnan(out[1])
    g = grad(lp)(torch.tensor(2.0, dtype=torch.float64))
    assert torch.isfinite(g)


def test_effect_outside_handler_raises():
    with pytest.raises(ftt.ModelStructureError):
        ftt.sample("x", ftt.Normal(0.0, 1.0))


def test_guard_and_factor_accumulate():
    def model():
        x = ftt.sample("x", ftt.Normal(0.0, 1.0))
        ftt.factor(torch.tensor(-0.25, dtype=torch.float64))
        ftt.guard(x > 100.0)
        ftt.guard(True)

    _, tr = run(PriorHandler(0, "cpu"), model)
    assert tr.log_factors == -np.inf
    assert tr.total_log_weight() == -np.inf


@pytest.fixture
def jax_x64():
    """Set JAX's x64 flag for one test; the suite's True comes back after."""
    before = jax.config.jax_enable_x64

    def set_x64(on):
        jax.config.update("jax_enable_x64", on)

    yield set_x64
    jax.config.update("jax_enable_x64", before)


@pytest.mark.parametrize("x64", [True, False])
@pytest.mark.parametrize("name", ["real_dtype", "accum_dtype", "int_dtype", "counting_dtype"])
def test_settings_dtypes_match_jax(name, x64, jax_x64):
    from fugue_tpu import settings as jax_settings

    jax_x64(x64)
    settings.enable_x64(x64)
    want = np.dtype(getattr(jax_settings, name)())
    assert getattr(settings, name)() == getattr(torch, want.name)


COUNT_SAMPLERS = {
    "Binomial": (5, 0.3),
    "Poisson": (2.5,),
    "Geometric": (0.4,),
    "NegativeBinomial": (3.0, 0.6),
    "DiscreteUniform": (2, 9),
}


@pytest.mark.parametrize("x64", [True, False])
@pytest.mark.parametrize("name", sorted(COUNT_SAMPLERS))
def test_count_samplers_draw_counting_dtype(name, x64, jax_x64):
    """Each count-valued sampler draws in ``counting_dtype`` in both
    packages, and its ``dtype`` property says so."""
    jax_x64(x64)
    settings.enable_x64(x64)
    args = COUNT_SAMPLERS[name]
    jd, td = getattr(ft, name)(*args), getattr(ftt, name)(*args)
    want = np.dtype(jd.sample(jax.random.PRNGKey(0), (4,)).dtype)
    got = td.sample(torch.Generator().manual_seed(0), (4,))
    assert got.dtype == getattr(torch, want.name) == settings.counting_dtype()
    assert td.dtype == got.dtype


def test_error_context_with_item_matches_jax():
    from fugue_tpu.errors import ErrorContext as JaxErrorContext
    from fugue_tpu_torch.errors import ErrorContext

    ctx = ErrorContext()
    assert ctx.with_item("site", "x").with_item("n", 3) is ctx
    want = JaxErrorContext().with_item("site", "x").with_item("n", 3)
    assert ctx.items == want.items == {"site": "x", "n": 3}
    assert ctx.render() == want.render()
