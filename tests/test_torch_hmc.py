"""Parity of the PyTorch port's HMC with fugue_tpu, on the CPU.

Deterministic pieces (leapfrog, one transition, dual averaging, Welford,
the reasonable-epsilon search) take the same inputs in both packages, with
the JAX package's own random draws handed to the port as arguments, and
agree to float64 tolerance: 1e-10 for trajectories (L gradient steps of a
float64 potential), 1e-12 for the adaptation recursions (a few float64
operations each). Whole chains are compared by posterior moments within
Monte-Carlo error, on eight-schools.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fugue_tpu_torch as ftt
from fugue_tpu.inference import hmc as jhmc
from fugue_tpu.inference.mcmc_utils import ess_multichain as jax_ess
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference import hmc as thmc
from fugue_tpu_torch.inference.mcmc_utils import ess_multichain, split_r_hat
from fugue_tpu_torch.interop import hmc_state_from_numpy

import torch_parity_models as models

TRAJ = dict(rtol=1e-10, atol=1e-10)
ADAPT = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


@pytest.fixture(scope="module")
def pair():
    settings.enable_x64(True)
    try:
        return models.eight_schools_pair()
    finally:
        settings.enable_x64(False)


def _state(dim, n=8, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(0.0, 0.8, (n, dim))
    p = rng.normal(0.0, 1.0, (n, dim))
    eps = rng.uniform(0.05, 0.4, n)
    inv_mass = np.exp(rng.normal(0.0, 0.3, dim))
    return q, p, eps, inv_mass


def _jax_noise(keys, inv_mass, dim):
    """Momenta and accept log-uniforms exactly as jhmc.hmc_transition draws
    them from each chain's key (fugue_tpu/inference/hmc.py:333-347)."""

    def one(key):
        k_mom, k_acc = jax.random.split(key)
        p = jhmc.mass_draw_momentum(k_mom, inv_mass, (dim,), jnp.float64)
        log_u = jnp.log(jax.random.uniform(k_acc, (), jnp.float64, 1e-38, 1.0))
        return p, log_u

    p, log_u = jax.vmap(one)(keys)
    return torch.as_tensor(np.array(p)), torch.as_tensor(np.array(log_u))


def test_leapfrog_matches_jax(pair):
    js, ts = pair
    q, p, eps, im = _state(js.dim)
    jq, jp = jax.vmap(
        lambda q, p, e: jhmc.leapfrog(jax.grad(js.potential), q, p, e, 5, jnp.asarray(im))
    )(q, p, eps)
    tq, tp, tg, tu = thmc.leapfrog(
        thmc.batched_force(ts.potential), *(torch.as_tensor(a) for a in (q, p, eps)),
        5, torch.as_tensor(im),
    )
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TRAJ)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TRAJ)
    jv, jg = jax.vmap(jax.value_and_grad(js.potential))(jq)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TRAJ)
    np.testing.assert_allclose(tu.numpy(), np.asarray(jv), **TRAJ)
    with pytest.raises(ValueError):
        thmc.leapfrog(thmc.batched_force(ts.potential), tq, tp, 0.1, 0, torch.as_tensor(im))


@pytest.mark.parametrize("max_delta_energy", [1000.0, 0.5])
def test_hmc_transition_matches_jax_with_its_own_noise(pair, max_delta_energy):
    js, ts = pair
    q, _, _, im = _state(js.dim, n=16, seed=1)
    eps = np.linspace(0.05, 1.2, 16)  # from near-certain accept to rejection
    keys = jax.random.split(jax.random.PRNGKey(3), 16)
    jq, info = jax.vmap(
        lambda q, k, e: jhmc.hmc_transition(js.potential, q, k, e, 10, jnp.asarray(im),
                                            max_delta_energy)
    )(q, keys, eps)
    p, log_u = _jax_noise(keys, jnp.asarray(im), js.dim)
    tq, tinfo = thmc.hmc_transition(
        ts.potential, torch.as_tensor(q), p, log_u, torch.as_tensor(eps), 10,
        torch.as_tensor(im), max_delta_energy,
    )
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TRAJ)
    np.testing.assert_allclose(tinfo.accept_prob.numpy(), np.asarray(info.accept_prob), **TRAJ)
    np.testing.assert_array_equal(tinfo.accepted.numpy(), np.asarray(info.accepted))
    np.testing.assert_array_equal(tinfo.divergent.numpy(), np.asarray(info.divergent))
    np.testing.assert_allclose(tinfo.energy.numpy(), np.asarray(info.energy), **TRAJ)
    acc = np.asarray(info.accepted)
    assert 0 < acc.sum() < 16  # both branches exercised
    if max_delta_energy < 1:
        assert np.asarray(info.divergent).any()
    want_u = np.asarray(jax.vmap(js.potential)(jq))
    np.testing.assert_allclose(tinfo.potential.numpy(), want_u, **TRAJ)


def test_dual_averaging_matches_jax():
    accepts = np.random.default_rng(2).uniform(0.0, 1.0, 25)
    js_state = jhmc.DualAveragingState.init(0.37)
    ts_state = thmc.DualAveragingState.init(torch.tensor(0.37, dtype=torch.float64))
    for a in accepts:
        js_state = jhmc.dual_averaging_update(js_state, a, 0.85)
        ts_state = thmc.dual_averaging_update(
            ts_state, torch.tensor(a, dtype=torch.float64), 0.85)
        for f in ("log_eps", "log_eps_bar", "h_bar", "mu"):
            np.testing.assert_allclose(
                float(getattr(ts_state, f)), float(getattr(js_state, f)), **ADAPT)
        assert ts_state.t == float(js_state.t)


def test_welford_matches_jax():
    rng = np.random.default_rng(3)
    jw = jhmc.WelfordState.init(4)
    tw = thmc.WelfordState.init(4, dtype=torch.float64, device="cpu")
    for n in (16, 7, 33):
        batch = rng.normal(rng.normal(size=4), 2.0, (n, 4))
        jw = jhmc.welford_push_batch(jw, jnp.asarray(batch))
        tw = thmc.welford_push_batch(tw, torch.as_tensor(batch))
        assert tw.count == float(jw.count)
        np.testing.assert_allclose(tw.mean.numpy(), np.asarray(jw.mean), **ADAPT)
        np.testing.assert_allclose(tw.m2.numpy(), np.asarray(jw.m2), **ADAPT)
    for reg in (True, False):
        np.testing.assert_allclose(
            thmc.welford_variance(tw, reg).numpy(),
            np.asarray(jhmc.welford_variance(jw, reg)), **ADAPT)


def test_mass_algebra():
    rng = np.random.default_rng(4)
    im, p = rng.uniform(0.5, 2.0, 5), rng.normal(size=(3, 5))
    got = thmc.mass_kinetic(torch.as_tensor(im), torch.as_tensor(p)).numpy()
    want = np.asarray(jax.vmap(lambda pp: jhmc.mass_kinetic(jnp.asarray(im), pp))(p))
    np.testing.assert_allclose(got, want, **ADAPT)
    g = torch.Generator().manual_seed(0)
    draws = thmc.mass_draw_momentum(g, torch.as_tensor(im), (20000, 5))
    np.testing.assert_allclose(draws.var(0).numpy(), 1.0 / im, rtol=0.05)


@pytest.mark.parametrize("seed", [0, 1])
def test_find_reasonable_epsilon_matches_jax(pair, seed):
    js, ts = pair
    q, _, _, im = _state(js.dim, n=1, seed=seed + 10)
    key = jax.random.PRNGKey(seed)
    want = float(jhmc.find_reasonable_epsilon(js.potential, jnp.asarray(q[0]), key,
                                              jnp.asarray(im)))
    p = jhmc.mass_draw_momentum(key, jnp.asarray(im), (js.dim,), jnp.float64)
    got = thmc.find_reasonable_epsilon(ts.potential, torch.as_tensor(q[0]),
                                       torch.as_tensor(np.array(p)), torch.as_tensor(im))
    assert got.dim() == 0
    assert float(got) == pytest.approx(want, rel=1e-12)


def test_transition_from_a_jax_warmed_state(pair):
    """Warm up with the JAX package, carry its state over through interop,
    and take one transition in each package with the same noise."""
    js, ts = pair
    res = jhmc.hmc_chain(jax.random.PRNGKey(5), n_samples=4, n_warmup=60, n_chains=16,
                         config=jhmc.HMCConfig(n_leapfrog=8), staged=js)
    state = hmc_state_from_numpy(np.asarray(res.final_positions), res.step_size,
                                 np.asarray(res.inv_mass), device="cpu",
                                 dtype=torch.float64)
    keys = jax.random.split(jax.random.PRNGKey(6), 16)
    jq, info = jax.vmap(
        lambda q, k: jhmc.hmc_transition(js.potential, q, k, res.step_size, 8, res.inv_mass)
    )(res.final_positions, keys)
    p, log_u = _jax_noise(keys, res.inv_mass, js.dim)
    tq, tinfo = thmc.hmc_transition(ts.potential, state.positions, p, log_u,
                                    state.step_size, 8, state.inv_mass)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TRAJ)
    np.testing.assert_array_equal(tinfo.accepted.numpy(), np.asarray(info.accepted))


def _moments(mu, ess):
    """(mean, sd, MC-SE of the mean, MC-SE of the sd) of draws (chains, n)."""
    x = np.asarray(mu, np.float64)
    m, sd = x.mean(), x.std(ddof=1)
    sq = (x - m) ** 2
    ess_sq = float(np.asarray(jax_ess(sq)))
    se_var = sq.std(ddof=1) / math.sqrt(ess_sq)
    return m, sd, sd / math.sqrt(ess), se_var / (2 * sd)


def test_short_chain_matches_jax_moments(pair):
    """64 chains, L=8, 100 warmup + 100 samples in each package: the
    posterior mean and sd of mu agree within 4 combined MC standard errors,
    and the port's split-R-hat is below 1.05."""
    js, ts = pair
    cfg_kw = dict(n_leapfrog=8, target_accept=0.9)
    jr = jhmc.hmc_chain(jax.random.PRNGKey(0), n_samples=100, n_warmup=100, n_chains=64,
                        config=jhmc.HMCConfig(**cfg_kw), staged=js)
    tr = ftt.hmc_chain(0, n_samples=100, n_warmup=100, n_chains=64,
                       config=ftt.HMCConfig(**cfg_kw), staged=ts)
    jmu, tmu = np.asarray(jr.samples["mu"]), tr.samples["mu"]
    assert tmu.shape == (64, 100) and tr.positions.shape == (64, 100, ts.dim)
    assert tr.samples["theta_raw"].shape == (64, 100, 8)
    assert tr.log_joint.shape == (64, 100) and tr.divergences.shape == (64, 100)
    assert tr.accept_prob.shape == (100,) and isinstance(tr.step_size, float)
    assert split_r_hat(tmu).item() < 1.05
    jm, jsd, jse_m, jse_sd = _moments(jmu, float(np.asarray(jax_ess(jmu))))
    tm, tsd, tse_m, tse_sd = _moments(tmu.numpy(), ess_multichain(tmu).item())
    assert abs(tm - jm) < 4 * math.hypot(jse_m, tse_m)
    assert abs(tsd - jsd) < 4 * math.hypot(jse_sd, tse_sd)
    # log_joint is -U at the recorded positions
    u = thmc.batched_force(ts.potential)(tr.positions[:, -1])[1]
    np.testing.assert_allclose(tr.log_joint[:, -1].numpy(), -u.numpy(), **TRAJ)


def test_drive_options():
    ts = ftt.stage(models.torch_eight_schools(), device="cpu")
    g = torch.Generator().manual_seed(0)
    q = thmc.initial_positions(ts, g, 6, "uniform")
    assert q.shape == (6, ts.dim) and float(q.abs().max()) <= 2.0
    qp = thmc.initial_positions(ts, g, 3, "prior")
    assert qp.shape == (3, ts.dim) and qp.dtype == torch.float64
    with pytest.raises(ValueError):
        thmc.initial_positions(ts, g, 3, "nope")
    z0 = torch.zeros(ts.dim, dtype=torch.float64)
    warm = thmc._warm_start_batch(ts, g, 5, z0, 0.01)
    assert warm.shape == (5, ts.dim) and float(warm.abs().max()) < 0.1
    assert torch.equal(thmc._warm_start_batch(ts, g, 5, warm, 0.01), warm)
    with pytest.raises(ValueError):
        thmc._warm_start_batch(ts, g, 5, torch.zeros(3), 0.01)
    with pytest.raises(ValueError):
        thmc._warm_start_batch(ts, g, 4, warm, 0.01)
    fixed = ftt.hmc_chain(1, n_samples=3, n_warmup=4, n_chains=4, staged=ts,
                          config=ftt.HMCConfig(step_size=0.25, adapt_step_size=False,
                                               n_leapfrog=4),
                          init_position=z0)
    assert fixed.step_size == 0.25 and fixed.samples["mu"].shape == (4, 3)
    nowarm = ftt.hmc_chain(1, n_samples=2, n_warmup=0, n_chains=4, staged=ts,
                           config=ftt.HMCConfig(n_leapfrog=2, adapt_mass=False))
    assert torch.equal(nowarm.inv_mass, torch.ones(ts.dim, dtype=torch.float64))
