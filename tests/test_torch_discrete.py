"""Discrete sites, dependent bounds and simplex sites in the PyTorch port,
against fugue_tpu on the CPU.

- Staging with discrete sites: the site table, the z layout of a
  ``Dirichlet`` site (k constrained, k − 1 unconstrained coordinates),
  ``merge_discrete`` and the discovery defaults, and the potential and its
  gradient with ``discrete=`` equal to JAX (float64, 1e-12).
- Dependent bounds, as ``tests/test_dynamic_bounds.py``: x | a ~ U(0, a)
  transforms into the current (0, a), round-trips, and its unconstrained
  density integrates to 1.
- ``mh_step_from_noise`` on a model with boolean, count, bounded-count,
  range and categorical sites, fed the JAX step's own draws, equal to the
  JAX ``mh_step`` to 1e-12; and the generator-driven ``mh_step``.
- ``hmc_chain`` and ``nuts_chain`` with ``discrete=``, and
  ``HmcSession.current_trace`` through ``merge_discrete``.
- Small CPU SMC runs (8,192 particles, float64) of the three models the
  card runs: the coin flip (MH and HMC moves) and the mixed-discrete model
  against their exact answers, the mixture against the JAX package's
  131,072-particle constants, within stated multiples of the Monte-Carlo
  error.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from chip_smoke import (SMC_MIXTURE, coin_exact, coin_model, mixed_discrete_exact,
                        mixed_discrete_model, mixture_model)
from fugue_tpu.inference import mcmc_utils as jmu
from fugue_tpu.inference import mh as jmh
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference import mcmc_utils as tmu
from fugue_tpu_torch.inference import mh as tmh
from fugue_tpu_torch.inference import smc as tsmc

TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


Y = [0.4, 1.3, -0.2]


def mixed_jax():
    b = ft.sample("b", ft.Bernoulli(0.4))
    n = ft.sample("n", ft.Poisson(3.0))
    k = ft.sample("k", ft.Binomial(6, 0.4))
    r = ft.sample("r", ft.DiscreteUniform(-2, 2))
    c = ft.sample("c", ft.Categorical(probs=jnp.array([0.2, 0.5, 0.3])))
    mu = ft.sample("mu", ft.Normal(0.0, 1.5))
    s = ft.sample("s", ft.LogNormal(0.0, 0.5))
    w = ft.sample("w", ft.Dirichlet(jnp.array([1.5, 2.0, 2.5])))
    loc = (mu + jnp.where(b, 0.5, -0.5) + 0.1 * n + 0.2 * k + 0.15 * r
           + 0.3 * jnp.sum(w * jnp.arange(3.0)) + 0.25 * c)
    ft.observe("y", ft.Normal(loc, s), jnp.array(Y))
    ft.factor(-0.05 * jnp.asarray(n - k, jnp.float64) ** 2)


def mixed_torch():
    f64 = torch.float64
    b = ftt.sample("b", ftt.Bernoulli(0.4))
    n = ftt.sample("n", ftt.Poisson(3.0))
    k = ftt.sample("k", ftt.Binomial(6, 0.4))
    r = ftt.sample("r", ftt.DiscreteUniform(-2, 2))
    c = ftt.sample("c", ftt.Categorical(probs=torch.tensor([0.2, 0.5, 0.3], dtype=f64)))
    mu = ftt.sample("mu", ftt.Normal(0.0, 1.5))
    s = ftt.sample("s", ftt.LogNormal(0.0, 0.5))
    w = ftt.sample("w", ftt.Dirichlet(torch.tensor([1.5, 2.0, 2.5], dtype=f64)))
    # an integer tensor times a Python float is float32 in PyTorch: cast first
    n, k, r, c = (v.to(f64) for v in (n, k, r, c))
    loc = (mu + torch.where(b, 0.5, -0.5).to(f64) + 0.1 * n + 0.2 * k + 0.15 * r
           + 0.3 * torch.sum(w * torch.arange(3.0, dtype=f64)) + 0.25 * c)
    ftt.observe("y", ftt.Normal(loc, s), torch.tensor(Y, dtype=f64))
    ftt.factor(-0.05 * (n - k) ** 2)


def _pair():
    return ft.stage(mixed_jax), ftt.stage(mixed_torch, device="cpu")


def test_site_table_and_z_layout_match_jax():
    js, ts = _pair()
    assert [(s.address, s.kind, tuple(s.shape), s.support.kind) for s in js.sites] == \
        [(s.address, s.kind, s.shape, s.support.kind) for s in ts.sites]
    assert [s.address for s in ts.discrete_sites] == ["b", "c", "k", "n", "r"]
    assert [s.address for s in ts.continuous_sites] == ["mu", "s", "w"]
    assert ts.site("w").z_shape == (2,) and ts.site("w").z_size == 2
    assert ts.site("mu").z_shape == () and ts.site("mu").z_size == 1
    assert ts.dim == js.dim == 4 and ts.constrained_dim == js.constrained_dim == 5
    assert ts._z_offsets == js._z_offsets and ts._offsets == js._offsets
    assert ts.site("k").support == ftt.core.distributions.int_range(0, 6)
    assert ts.site("c").support.size == 3


def test_merge_discrete_defaults_to_the_discovery_values():
    _, ts = _pair()
    disc = {s.address: ts._discovery_trace.choices[s.address].value for s in ts.discrete_sites}
    merged = ts.merge_discrete({"mu": torch.tensor(0.1)})
    assert set(merged) == {"mu", "b", "c", "k", "n", "r"}
    for a, v in disc.items():
        assert torch.equal(merged[a], v)
    merged = ts.merge_discrete({}, {"n": torch.tensor(7)})
    assert int(merged["n"]) == 7 and torch.equal(merged["b"], disc["b"])
    z = torch.tensor([0.3, -0.2, 0.5, -1.0], dtype=torch.float64)
    assert float(ts.potential(z)) == float(ts.potential(z, disc))


@pytest.mark.parametrize("seed", range(4))
def test_potential_and_gradient_with_discrete_match_jax(seed):
    js, ts = _pair()
    lat = ts.sample_prior(seed)
    disc = {s.address: lat[s.address] for s in ts.discrete_sites}
    jdisc = {a: jnp.asarray(v.numpy()) for a, v in disc.items()}
    z = np.random.default_rng(seed).normal(0.0, 1.0, (5, ts.dim))
    ju = jax.vmap(lambda q: js.potential(q, jdisc))(jnp.asarray(z))
    jg = jax.vmap(jax.grad(lambda q: js.potential(q, jdisc)))(jnp.asarray(z))
    tg, tu = vmap(grad_and_value(lambda q: ts.potential(q, disc)))(torch.as_tensor(z))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    # constrain / unconstrain round trip, and the constrained values match
    cont, logdet = ts.constrain(torch.as_tensor(z[0]), disc)
    jcont, jlogdet = js.constrain(jnp.asarray(z[0]), jdisc)
    assert set(cont) == {"mu", "s", "w"}
    for a in cont:
        np.testing.assert_allclose(cont[a].numpy(), np.asarray(jcont[a]), **TOL)
    np.testing.assert_allclose(float(logdet), float(jlogdet), **TOL)
    np.testing.assert_allclose(ts.unconstrain(cont, disc).numpy(), z[0], rtol=1e-9, atol=1e-9)


def test_unconstrain_casts_integer_values_to_the_real_dtype():
    def model():
        ftt.sample("a", ftt.Exponential(1.0))

    ts = ftt.stage(model, device="cpu")
    z = ts.unconstrain({"a": torch.tensor(2)})
    assert z.dtype == torch.float64 and z.item() == pytest.approx(math.log(2.0))


# ---------------------------------------------------------------------------
# dependent bounds
# ---------------------------------------------------------------------------


def nested_uniform():
    a = ftt.sample("a", ftt.Uniform(0.0, 1.0))
    return ftt.sample("x", ftt.Uniform(0.0, a))


def test_constrain_respects_dependent_bounds():
    ts = ftt.stage(nested_uniform, device="cpu")
    assert ts.site("x").support.low is None  # a tensor bound is not static
    for zv in ([-1.0, 2.0], [3.0, -4.0], [0.0, 0.0]):
        lat, _ = ts.constrain(torch.tensor(zv, dtype=torch.float64))
        a, x = float(lat["a"]), float(lat["x"])
        assert 0.0 < a < 1.0 and 0.0 < x < a
    z = torch.tensor([0.7, -1.3], dtype=torch.float64)
    lat, _ = ts.constrain(z)
    np.testing.assert_allclose(ts.unconstrain(lat).numpy(), z.numpy(), rtol=1e-9)


def test_dependent_bound_density_integrates_to_one_and_matches_jax():
    ts = ftt.stage(nested_uniform, device="cpu")
    g = np.linspace(-9.0, 9.0, 241)
    zz = np.stack(np.meshgrid(g, g), axis=-1).reshape(-1, 2)
    lp = vmap(ts.log_joint_unconstrained)(torch.as_tensor(zz)).numpy()
    h = g[1] - g[0]
    assert float(np.sum(np.exp(lp)) * h * h) == pytest.approx(1.0, abs=3e-3)

    def jnested():
        a = ft.sample("a", ft.Uniform(0.0, 1.0))
        return ft.sample("x", ft.Uniform(0.0, a))

    js = ft.stage(jnested)
    want = np.asarray(jax.vmap(js.log_joint_unconstrained)(jnp.asarray(zz[::37])))
    np.testing.assert_allclose(lp[::37], want, **TOL)


def test_per_element_uniform_bounds():
    lo = torch.tensor([0.0, -1.0, 2.0], dtype=torch.float64)
    hi = torch.tensor([1.0, 1.0, 5.0], dtype=torch.float64)

    def model():
        return ftt.sample("u", ftt.Uniform(lo, hi))

    ts = ftt.stage(model, device="cpu")
    u, _ = ts.constrain(torch.tensor([-3.0, 0.0, 3.0], dtype=torch.float64))
    assert bool(((u["u"] > lo) & (u["u"] < hi)).all())


# ---------------------------------------------------------------------------
# MH with discrete proposals
# ---------------------------------------------------------------------------


def _jax_draws(js, keys, scales):
    """The draws ``jmh.mh_step`` makes from each key: site index, ε, log u,
    and per discrete site its walk (mag, sign) or category."""
    d_sites = js.discrete_sites

    def one(k):
        k_site, k_acc, k_cont, *k_disc = jax.random.split(k, 3 + len(d_sites))
        idx = jax.random.randint(k_site, (), 0, len(js.sites))
        eps = jax.random.normal(k_cont, (js.constrained_dim,), jnp.float64)
        log_u = jnp.log(jax.random.uniform(k_acc, (), jnp.float64, 1e-38, 1.0))
        disc = []
        for kd, s in zip(k_disc, d_sites):
            shape = tuple(s.shape)
            if s.support.kind == "categorical":
                disc.append(jax.random.randint(kd, shape, 0, s.support.size))
            elif s.support.kind != "boolean":
                k1, k2 = jax.random.split(kd)
                width = jnp.maximum(jnp.round(scales[js.site_index[s.address]]), 1.0)
                mag = jax.random.randint(k1, shape, 1, jnp.int32(1) + width.astype(jnp.int32))
                sign = jnp.where(jax.random.bernoulli(k2, 0.5, shape), 1, -1)
                disc.append((mag, sign))
            else:
                disc.append(jnp.zeros(()))
        return idx, eps, log_u, disc

    idx, eps, log_u, disc = jax.vmap(one)(keys)
    noise = {}
    for s, d in zip(d_sites, disc):
        if s.support.kind == "boolean":
            noise[s.address] = None
        elif s.support.kind == "categorical":
            noise[s.address] = torch.as_tensor(np.asarray(d))
        else:
            noise[s.address] = tuple(torch.as_tensor(np.asarray(x)) for x in d)
    return (torch.as_tensor(np.asarray(idx)).long(), torch.as_tensor(np.asarray(eps)),
            torch.as_tensor(np.asarray(log_u)), noise)


@pytest.mark.parametrize("seed", range(3))
def test_mh_step_from_noise_matches_jax_with_discrete_sites(seed):
    js, ts = _pair()
    n, n_sites = 64, len(ts.sites)
    lat = ts.sample_prior_batch(seed, n)
    rng = np.random.default_rng(seed)
    # scales above 1.5 give integer walks wider than one step
    log_scale = rng.normal(np.log(1.2), 0.6, n_sites)
    t = rng.integers(0, 5, n_sites) * 1.0
    jlat = {a: jnp.asarray(v.numpy()) for a, v in lat.items()}
    jstate = jmh.MHState(latents=jlat, log_joint=jax.vmap(js.log_joint)(jlat),
                         adapt=jmu.AdaptationState(jnp.asarray(log_scale), jnp.asarray(t)))
    keys = jax.random.split(jax.random.PRNGKey(100 + seed), n)
    new, acc = jax.vmap(lambda s, k: jmh.mh_step(js, s, k, True),
                        in_axes=(jmh.MHState(latents=0, log_joint=0, adapt=None), 0))(jstate, keys)
    idx, eps, log_u, noise = _jax_draws(js, keys, np.exp(log_scale))
    tstate = tmh.MHState(latents=lat, log_joint=vmap(ts.log_joint)(lat),
                         adapt=tmu.AdaptationState(torch.as_tensor(log_scale), torch.as_tensor(t)))
    got, tacc = tmh.mh_step_from_noise(ts, tstate, idx, eps, log_u, True, discrete_noise=noise)
    jacc = np.asarray(acc)
    assert 0 < jacc.sum() < n
    np.testing.assert_array_equal(tacc.numpy(), jacc)
    moved = {a for a in lat if not torch.equal(got.latents[a], lat[a])}
    assert len(moved & {"b", "c", "k", "n", "r"}) >= 3  # discrete sites do move
    for a in lat:
        assert got.latents[a].dtype == lat[a].dtype
        np.testing.assert_allclose(got.latents[a].numpy(), np.asarray(new.latents[a]), **TOL)
    np.testing.assert_allclose(got.log_joint.numpy(), np.asarray(new.log_joint), **TOL)
    np.testing.assert_allclose(got.adapt.log_scale.numpy(), np.asarray(new.adapt.log_scale), **TOL)


def test_discrete_proposals_match_jax():
    x = torch.tensor([0, 1, 5, 6, 3], dtype=torch.int64)
    mag = torch.tensor([1, 2, 3, 1, 9])
    sign = torch.tensor([-1, -1, 1, 1, -1])
    for lo, hi in ((0, 6), (0, None), (None, 4), (1, 5)):
        want = x.numpy() + (sign * mag).numpy()
        if lo is not None:
            want = np.where(want < lo, 2 * lo - 1 - want, want)
        if hi is not None:
            want = np.where(want > hi, 2 * hi + 1 - want, want)
        if lo is not None:
            want = np.maximum(want, lo)
        if hi is not None:
            want = np.minimum(want, hi)
        got = tmh._propose_discrete_walk(x, mag, sign, lo, hi)
        assert got.dtype == x.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    b = torch.tensor([True, False])
    assert torch.equal(tmh.make_site_proposal(ftt.Bernoulli(0.5).support)(b, None), ~b)
    cat = tmh.make_site_proposal(ftt.core.distributions.categorical_support(3))
    assert torch.equal(cat(torch.tensor([0, 2]), torch.tensor([1, 1])), torch.tensor([1, 1]))
    with pytest.raises(ValueError):
        tmh.make_site_proposal(ftt.Normal(0.0, 1.0).support)


def test_generator_driven_mh_step_moves_one_site():
    _, ts = _pair()
    lat = ts.sample_prior_batch(1, 256)
    adapt = tmu.AdaptationState.init(len(ts.sites), 2.0, dtype=torch.float64, device="cpu")
    state = tmh.MHState(latents=lat, log_joint=vmap(ts.log_joint)(lat), adapt=adapt)
    new, acc = tmh.mh_step(ts, state, torch.Generator().manual_seed(0), False)
    changed = torch.stack([(new.latents[a] != lat[a]).reshape(256, -1).any(-1) for a in lat])
    assert bool((changed.sum(0) <= 1).all()) and int(changed.sum()) > 0
    for s in ts.discrete_sites:
        v = new.latents[s.address]
        assert v.dtype == lat[s.address].dtype
        if s.support.kind in ("int_range", "categorical"):
            assert int(v.min()) >= s.support.low and int(v.max()) <= s.support.high
        if s.support.kind == "count":
            assert int(v.min()) >= 0
    assert bool(torch.isfinite(new.log_joint).all())


# ---------------------------------------------------------------------------
# HMC and NUTS with discrete= held fixed
# ---------------------------------------------------------------------------


def _switch_model():
    y = torch.tensor([1.1, 0.9], dtype=torch.float64)

    def model():
        heads = ftt.sample("heads", ftt.Bernoulli(0.5))
        mu = ftt.sample("mu", ftt.Normal(torch.where(heads, 1.0, -1.0).to(torch.float64), 1.0))
        ftt.observe("y", ftt.Normal(mu, 0.5), y)

    return model


@pytest.mark.parametrize("engine", ["hmc", "nuts"])
@pytest.mark.parametrize("heads", [False, True])
def test_chains_hold_discrete_sites_fixed(engine, heads):
    """mu | heads, y is normal with mean (±1 + 4 Σy) / 9 and variance 1/9."""
    staged = ftt.stage(_switch_model(), device="cpu")
    disc = {"heads": torch.tensor(heads)}
    kw = dict(n_samples=150, n_warmup=100, n_chains=8, staged=staged, discrete=disc)
    if engine == "hmc":
        res = ftt.hmc_chain(4, config=ftt.HMCConfig(n_leapfrog=8), **kw)
    else:
        res = ftt.nuts_chain(4, config=ftt.NUTSConfig(max_depth=5), **kw)
    mean = ((1.0 if heads else -1.0) + 4 * 2.0) / 9
    mu = res.samples["mu"]
    assert set(res.samples) == {"mu"}
    assert abs(mu.mean().item() - mean) < 5 * (1 / 3) / math.sqrt(8 * 150 / 4)


def test_session_trace_merges_the_discrete_sites():
    staged = ftt.stage(_switch_model(), device="cpu")
    sess = ftt.HmcSession(0, staged=staged, device="cpu",
                          config=ftt.HMCConfig(step_size=0.3, n_leapfrog=4))
    sess.step()
    tr = sess.current_trace()
    assert set(tr.choices) == {"heads", "mu", "y"}
    assert torch.equal(tr.choices["heads"].value, staged._discovery_trace.choices["heads"].value)


# ---------------------------------------------------------------------------
# SMC on the card's three models, small and on the CPU
# ---------------------------------------------------------------------------


N = 8192


@pytest.mark.parametrize("rejuvenation", ["mh", "hmc"])
def test_smc_coin_against_the_exact_posterior(rejuvenation):
    cfg = (ftt.SMCConfig(rejuvenation_steps=3) if rejuvenation == "mh" else
           ftt.SMCConfig(rejuvenation="hmc", rejuvenation_steps=1, hmc_leapfrog=16))
    res = ftt.adaptive_smc(5, N, coin_model("cpu"), cfg, device="cpu")
    log_z, p_mean = coin_exact()
    assert res.converged and res.n_stages >= 2
    assert abs(res.log_evidence - log_z) < 0.1
    # posterior sd 0.085: 5 standard errors at an ESS of N / 4
    assert abs(res.posterior_mean("p").item() - p_mean) < 5 * 0.085 / math.sqrt(N / 4)


def test_smc_mixture_against_the_jax_constants():
    res = ftt.adaptive_smc(6, N, mixture_model("cpu", torch.float64),
                           ftt.SMCConfig(rejuvenation_steps=5), device="cpu")
    assert res.converged
    got = {"mu0": res.posterior_mean("mu0").item(), "mu1": res.posterior_mean("mu1").item(),
           "w": res.posterior_mean("w").item(), "log_evidence": res.log_evidence}
    scale = math.sqrt(131072 / N)  # the constants' run spread is at 131,072 particles
    for k, v in got.items():
        ref = SMC_MIXTURE[k]
        assert abs(v - ref["MEAN"]) < 6 * ref["RUN_SD"] * scale, (k, v, ref)


def test_smc_mixed_discrete_against_the_closed_form():
    res = ftt.adaptive_smc(7, N, mixed_discrete_model("cpu", torch.float64),
                           ftt.SMCConfig(rejuvenation_steps=5), device="cpu")
    log_z, p_heads = mixed_discrete_exact()
    assert res.converged and res.n_stages >= 2
    assert res.particles["heads"].dtype == torch.bool
    assert abs(res.posterior_mean("heads").item() - p_heads) < 0.03
    assert abs(res.log_evidence - log_z) < 0.1


def test_smc_rejects_hmc_moves_with_discrete_sites():
    with pytest.raises(ValueError):
        ftt.adaptive_smc(0, 64, mixed_discrete_model("cpu", torch.float64),
                         ftt.SMCConfig(rejuvenation="hmc"), device="cpu")


def test_discrete_particles_resample_and_rejuvenate():
    staged = ftt.stage(mixed_discrete_model("cpu", torch.float64), device="cpu")
    parts = tsmc._density_parts(staged)
    lat = staged.sample_prior_batch(3, 512)
    lp, ll = parts(lat)
    assert lp.shape == ll.shape == (512,) and bool(torch.isfinite(lp).all())
    out, _ = tsmc._rejuvenate_mh(staged, ftt.SMCConfig(rejuvenation_steps=5), lat,
                                 tmu.AdaptationState.init(2, 0.5, dtype=torch.float64,
                                                          device="cpu"),
                                 torch.tensor(0.5, dtype=torch.float64),
                                 torch.Generator().manual_seed(1))
    assert out["heads"].dtype == torch.bool
    assert 0 < int((out["heads"] != lat["heads"]).sum()) < 512  # the flip proposal moved some
