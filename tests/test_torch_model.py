"""The PyTorch port's model language against fugue_tpu's, on the CPU.

Models that use ``masked`` (per-site and per-element), nested masks, a
masked factor and guard, ``cond`` (one- and two-armed, pytree returns) and
``plate``, after ``tests/test_cond.py``, written once for both packages: the
potential and its gradient on a grid of unconstrained positions and every
assignment of the discrete sites equal JAX within 1e-12 in float64, and the
replayed return values match. Then the ``Model`` combinators, the same way.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from fugue_tpu_torch import settings

TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


class _Jax:
    pkg = ft
    where = staticmethod(jnp.where)
    lnot = staticmethod(jnp.logical_not)

    @staticmethod
    def arr(x):
        return jnp.asarray(x, jnp.float64)


class _Torch:
    pkg = ftt
    lnot = staticmethod(torch.logical_not)

    @staticmethod
    def where(c, a, b):
        return torch.where(c, torch.as_tensor(a, dtype=torch.float64),
                           torch.as_tensor(b, dtype=torch.float64))

    @staticmethod
    def arr(x):
        return torch.as_tensor(np.asarray(x, np.float64))


Y2 = [1.1, 0.4]


def masked_observe(o):
    f = o.pkg
    b = f.sample("b", f.Bernoulli(0.5))
    mu = f.sample("mu", f.Normal(0.0, 1.0))
    with f.masked(b):
        f.observe("y_t", f.Normal(mu + 1.0, 1.0), o.arr(Y2))
    with f.masked(o.lnot(b)):
        f.observe("y_f", f.Normal(mu - 1.0, 1.0), o.arr(Y2))
    return mu


def pseudo_prior(o):
    f = o.pkg
    b = f.sample("b", f.Bernoulli(0.3))
    with f.masked(b):
        x = f.sample("x", f.Normal(0.0, 1.0))
        f.observe("y", f.Normal(x, 0.5), o.arr(2.0))
    return x


def masked_factor_guard(o):
    f = o.pkg
    x = f.sample("x", f.Normal(0.0, 1.5))
    with f.masked(x > 0.5):
        f.factor(-x * x)
        f.guard(x < 1.7)
    return x


def nested_masks(o):
    f = o.pkg
    a = f.sample("a", f.Bernoulli(0.5))
    b = f.sample("b", f.Bernoulli(0.4))
    x = f.sample("x", f.Normal(0.0, 1.0))
    with f.masked(a):
        with f.masked(b):
            f.factor(-1.0 - x * x)
        f.observe("y", f.Normal(x, 1.0), o.arr(0.3))
    with f.masked(True):
        with f.masked(False):
            f.factor(-5.0)
    return x


def per_element_mask(o):
    f = o.pkg
    x = f.sample("x", f.Normal(0.0, 1.0), sample_shape=(4,))
    s = f.sample("s", f.LogNormal(0.0, 0.5))
    with f.masked(x > 0.0):
        f.observe("y", f.Normal(x, s), o.arr([0.5, -0.2, 1.3, 0.0]))
    return x


def cond_two_armed(o):
    f = o.pkg
    b = f.sample("b", f.Bernoulli(0.5))
    loc = f.cond(b, lambda: f.sample("mu_t", f.Normal(2.0, 0.5)),
                 lambda: f.sample("mu_f", f.Normal(-2.0, 0.5)))
    f.observe("y", f.Normal(loc, 1.0), o.arr(0.3))
    return loc


def cond_one_armed(o):
    f = o.pkg
    b = f.sample("b", f.Bernoulli(0.5))
    z = f.sample("z", f.Normal(0.0, 1.0))

    def arm():
        f.observe("y", f.Normal(z, 0.7), o.arr(1.2))
        return z + 1.0

    return f.cond(b, arm)


def cond_pytree(o):
    f = o.pkg
    k = f.sample("k", f.Categorical(probs=o.arr([0.2, 0.5, 0.3])))
    w = f.sample("w", f.Beta(2.0, 3.0))
    out = f.cond(k > 0, lambda: (w, {"s": 2.0 * w}),
                 lambda: (1.0 - w, {"s": o.where(k > 0, 0.0, -w)}))
    f.observe("y", f.Normal(out[0] + out[1]["s"], 0.5), o.arr(0.9))
    return out


def plate_model(o):
    f = o.pkg
    mu = f.sample("mu", f.Normal(0.0, 2.0))
    data = o.arr([0.2, 1.4, -0.3])

    def group(i):
        theta = f.sample(f.addr("theta", i), f.Normal(mu, 1.0))
        f.observe(f.addr("y", i), f.Normal(theta, 0.5), data[i])
        return theta

    return f.plate("g", 3, group)


def dependent_cond(o):
    f = o.pkg
    n = f.sample("n", f.Poisson(2.0))
    a = f.sample("a", f.Gamma(2.0, 1.0))
    with f.masked(n > 1):
        x = f.sample("x", f.Uniform(0.0, a))
        f.observe("y", f.Normal(x, 0.3), o.arr(0.8))
    return x


MODELS = {m.__name__: m for m in (masked_observe, pseudo_prior, masked_factor_guard,
                                  nested_masks, per_element_mask, cond_two_armed,
                                  cond_one_armed, cond_pytree, plate_model, dependent_cond)}
DISCRETE_VALUES = {"bool": [False, True], "int": [0, 1, 2, 3]}


def _stage_pair(name):
    m = MODELS[name]
    js = ft.stage(lambda: m(_Jax))
    ts = ftt.stage(lambda: m(_Torch), device="cpu")
    return js, ts


def _assignments(staged):
    """Every assignment of the discrete sites (up to 16)."""
    sites = staged.discrete_sites
    choices = [DISCRETE_VALUES[s.kind] for s in sites]
    for combo in itertools.product(*choices):
        yield {s.address: v for s, v in zip(sites, combo)}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_potential_and_gradient_match_jax(name):
    js, ts = _stage_pair(name)
    assert [(s.address, s.kind, s.shape) for s in ts.sites] == \
        [(s.address, s.kind, tuple(s.shape)) for s in js.sites]
    assert ts.dim == js.dim
    z = np.random.default_rng(len(name)).normal(0.0, 1.2, (6, ts.dim))
    saw_finite = False
    for disc in _assignments(ts):
        jd = {a: jnp.asarray(v) for a, v in disc.items()}
        td = {a: torch.as_tensor(v) for a, v in disc.items()}
        ju = jax.vmap(lambda q: js.potential(q, jd))(jnp.asarray(z))
        jg = jax.vmap(jax.grad(lambda q: js.potential(q, jd)))(jnp.asarray(z))
        tg, tu = vmap(grad_and_value(lambda q: ts.potential(q, td)))(torch.as_tensor(z))
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)
        fin = np.isfinite(np.asarray(ju))
        saw_finite |= bool(fin.any())
        np.testing.assert_allclose(tg.numpy()[fin], np.asarray(jg)[fin], **TOL)
    assert saw_finite


@pytest.mark.parametrize("name", sorted(MODELS))
def test_replay_return_values_match_jax(name):
    js, ts = _stage_pair(name)
    for seed in range(3):
        lat = ts.sample_prior(seed)
        jlat = {a: jnp.asarray(v.numpy()) for a, v in lat.items()}
        jval, jtr = js.replay(jlat)
        tval, ttr = ts.replay(lat)
        for a, b in zip(jax.tree_util.tree_leaves(jval),
                        torch.utils._pytree.tree_leaves(tval)):
            np.testing.assert_allclose(np.asarray(torch.as_tensor(b)), np.asarray(a), **TOL)
        for part in ("log_prior", "log_likelihood", "log_factors"):
            np.testing.assert_allclose(float(getattr(ttr, part)), float(getattr(jtr, part)),
                                       **TOL)


def test_masked_terms_follow_the_reference_semantics():
    _, ts = _stage_pair("masked_factor_guard")
    lf = ts.log_density_parts({"x": torch.tensor(0.0, dtype=torch.float64)}).log_factors
    assert float(lf) == 0.0  # inactive: the factor and the guard add 0, not NaN
    lf = ts.log_density_parts({"x": torch.tensor(2.0, dtype=torch.float64)}).log_factors
    assert float(lf) == -np.inf  # active and violated
    _, ts = _stage_pair("pseudo_prior")
    lp = [float(ts.log_joint({"b": torch.tensor(False), "x": torch.tensor(v, dtype=torch.float64)}))
          for v in (0.0, 3.0)]
    assert lp[0] - lp[1] == pytest.approx(4.5, abs=1e-12)  # the prior term alone


# ---------------------------------------------------------------------------
# Model combinators
# ---------------------------------------------------------------------------


def _combinator_model(o, which):
    f = o.pkg
    M = f.Model
    if which == "bind_map":
        return M.sample("mu", f.Normal(0.0, 1.0)).bind(
            lambda mu: M.observe("y", f.Normal(mu, 0.5), o.arr(0.7)).map(lambda _: mu * 2.0))
    if which == "zip":
        return M.sample("a", f.Normal(0.0, 1.0)).zip(M.sample("b", f.Gamma(2.0, 2.0)))
    if which == "sequence_vec":
        return f.sequence_vec([M.sample(f.addr("x", i), f.Normal(float(i), 1.0))
                               for i in range(4)])
    if which == "traverse_vec":
        return f.traverse_vec([0.5, -0.5, 1.5],
                              lambda v: M.sample(f.addr("t", int(v * 10)), f.Normal(v, 0.3)))
    if which == "factor_guard_pure":
        return M.sample("x", f.Normal(0.0, 1.0)).and_then(
            lambda x: M.factor(-0.5 * x * x).bind(
                lambda _: M.guard(x < 2.5).bind(lambda _: f.pure(x + 1.0))))
    raise KeyError(which)


COMBINATORS = ["bind_map", "zip", "sequence_vec", "traverse_vec", "factor_guard_pure"]


@pytest.mark.parametrize("which", COMBINATORS)
def test_model_combinators_match_jax(which):
    js = ft.stage(_combinator_model(_Jax, which))
    ts = ftt.stage(_combinator_model(_Torch, which), device="cpu")
    assert [s.address for s in ts.sites] == [s.address for s in js.sites]
    z = np.random.default_rng(1).normal(0.0, 1.0, (5, ts.dim))
    ju = jax.vmap(js.potential)(jnp.asarray(z))
    jg = jax.vmap(jax.grad(js.potential))(jnp.asarray(z))
    tg, tu = vmap(grad_and_value(ts.potential))(torch.as_tensor(z))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    lat = ts.sample_prior(2)
    jval, _ = js.replay({a: jnp.asarray(v.numpy()) for a, v in lat.items()})
    tval, _ = ts.replay(lat)
    for a, b in zip(jax.tree_util.tree_leaves(jval), torch.utils._pytree.tree_leaves(tval)):
        np.testing.assert_allclose(np.asarray(torch.as_tensor(b)), np.asarray(a), **TOL)


def test_effects_outside_a_handler_raise():
    with pytest.raises(ftt.ModelStructureError):
        ftt.sample("x", ftt.Normal(0.0, 1.0))
    assert ftt.Model.pure(3)() == 3
