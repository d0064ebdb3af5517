"""Parity of the PyTorch port's ABC with fugue_tpu, on the CPU.

Float64. The distances and ``SummaryStatsDistance`` agree with the JAX
package's to 1e-12. The compaction keeps the same rows as ``lax.top_k`` on
the same 0/1 mask, ties and all. The proposal's bandwidth and importance
log-weights equal the JAX package's formulas (``abc.py:355-403``) on the
same candidates and population to 1e-12. The final distances of an
ABC-SMC run share one noise draw across particles, as the JAX package's
do. The budget and discrete-parameter ``ABCError``s match. Rejection, its
``inner_batches`` form, weighted ABC-SMC and ``abc_smc`` recover the
conjugate posterior within Monte-Carlo error and agree with the JAX
package's runs at the same small configuration within their joint error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from fugue_tpu.core.numerics import log_sum_exp as jlse
from fugue_tpu.inference import abc as jabc
from fugue_tpu_torch import settings
from fugue_tpu_torch.core.rng import fold_seed
from fugue_tpu_torch.inference import abc as tabc

EXACT = dict(rtol=1e-12, atol=1e-12)
N_OBS = 16
OBS = 1.0 + np.random.default_rng(77).standard_normal(N_OBS)
POST_MEAN = N_OBS * OBS.mean() / (0.25 + N_OBS)
POST_SD = float(np.sqrt(1.0 / (0.25 + N_OBS)))


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def jsim():
    mu = ft.sample("mu_p", ft.Normal(0.0, 2.0))
    return ft.sample("xs", ft.Normal(mu, 1.0), sample_shape=(N_OBS,))


def tsim():
    mu = ftt.sample("mu_p", ftt.Normal(0.0, 2.0))
    return ftt.sample("xs", ftt.Normal(mu, 1.0), sample_shape=(N_OBS,))


def jdist(a, b):
    return jnp.abs(jnp.mean(a) - jnp.mean(b))


def tdist(a, b):
    return torch.abs(torch.mean(a) - torch.mean(b))


def _same_error(jfn, tfn):
    with pytest.raises(jabc.ABCError) as je:
        jfn()
    with pytest.raises(tabc.ABCError) as te:
        tfn()
    assert te.value.code == je.value.code and str(te.value) == str(je.value)
    return te.value


# ---------------------------------------------------------------------------
# Pieces at the same inputs
# ---------------------------------------------------------------------------


def test_distances_match_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=7), rng.normal(size=7)
    for jf, tf in ((jabc.euclidean_distance, tabc.euclidean_distance),
                   (jabc.manhattan_distance, tabc.manhattan_distance)):
        np.testing.assert_allclose(_np(tf(torch.as_tensor(a), torch.as_tensor(b))),
                                   np.asarray(jf(jnp.asarray(a), jnp.asarray(b))), **EXACT)
    w = rng.uniform(0.5, 2.0, 2)
    for weights in (None, w):
        jd = jabc.SummaryStatsDistance(lambda x: jnp.stack([jnp.mean(x), jnp.std(x)]), weights)
        td = tabc.SummaryStatsDistance(
            lambda x: torch.stack([torch.mean(x), torch.std(x, correction=0)]), weights)
        np.testing.assert_allclose(_np(td(torch.as_tensor(a), torch.as_tensor(b))),
                                   np.asarray(jd(jnp.asarray(a), jnp.asarray(b))), **EXACT)
    scalar_j = jabc.SummaryStatsDistance(jnp.mean)
    scalar_t = tabc.SummaryStatsDistance(torch.mean)
    np.testing.assert_allclose(_np(scalar_t(torch.as_tensor(a), torch.as_tensor(b))),
                               np.asarray(scalar_j(jnp.asarray(a), jnp.asarray(b))), **EXACT)


@pytest.mark.parametrize("p_accept", [0.0, 0.01, 0.3, 0.97, 1.0])
@pytest.mark.parametrize("cap", [1, 37, 1000])
def test_compaction_keeps_the_rows_top_k_keeps(p_accept, cap):
    ok = np.random.default_rng(int(p_accept * 100) + cap).uniform(size=1000) < p_accept
    _, want = jax.lax.top_k(jnp.asarray(ok).astype(jnp.float32), cap)
    got = tabc.compact_accepted(torch.as_tensor(ok), cap)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("d", [1, 3])
def test_proposal_bandwidth_and_log_weights_match_jax(d):
    rng = np.random.default_rng(d)
    N, B = 50, 40
    thetas = rng.normal(size=(N, d))
    log_w = rng.normal(size=N)
    cand = rng.normal(size=(B, d))
    lp = rng.normal(size=B)
    lp[3] = -np.inf

    # the JAX package's formulas (fugue_tpu/inference/abc.py:368-375, :400-403)
    lw_j = jnp.asarray(log_w)
    wbar = jnp.exp(lw_j - jlse(lw_j))
    mean = jnp.sum(wbar[:, None] * thetas, axis=0)
    var = jnp.sum(wbar[:, None] * (thetas - mean) ** 2, axis=0)
    bw = jnp.sqrt(2.0 * jnp.maximum(var, 1e-12))

    def one(theta, lpi):
        log_wbar = lw_j - jlse(lw_j)
        z = (theta[None, :] - thetas) / bw
        log_k = -0.5 * jnp.sum(z * z, axis=-1) - jnp.sum(jnp.log(bw)) - 0.5 * d * jnp.log(2 * jnp.pi)
        return lpi - jlse(log_wbar + log_k)

    want = jax.vmap(one)(jnp.asarray(cand), jnp.asarray(lp))

    t_lw = torch.as_tensor(log_w)
    t_wbar, lse = ftt.inference.abc.normalize_log_weights(t_lw)
    t_bw = tabc.kernel_bandwidth(torch.as_tensor(thetas), t_wbar)
    np.testing.assert_allclose(_np(t_bw), np.asarray(bw), **EXACT)
    got = tabc.proposal_log_weights(torch.as_tensor(cand), torch.as_tensor(lp),
                                    torch.as_tensor(thetas), t_lw - lse, t_bw)
    np.testing.assert_allclose(_np(got), np.asarray(want), **EXACT)
    # a degenerate population: the variance floor
    flat = torch.zeros((N, d), dtype=torch.float64)
    np.testing.assert_allclose(_np(tabc.kernel_bandwidth(flat, t_wbar)), np.sqrt(2e-12), **EXACT)


# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------


def test_budget_exhausted_matches_jax():
    js, ts = ft.stage(jsim), ftt.stage(tsim, device="cpu")
    kw = dict(observed=OBS, epsilon=1e-9, n_samples=10, max_attempts=300, batch_size=128)
    err = _same_error(
        lambda: jabc.abc_rejection(jax.random.PRNGKey(0), staged=js, distance=jdist, **kw),
        lambda: tabc.abc_rejection(0, staged=ts, distance=tdist, **kw))
    assert err.context.items == {"accepted": 0, "needed": 10, "attempts": 384}
    cfg = tabc.ABCSMCConfig(epsilons=(1.0, 1e-9), n_particles=20, max_attempts_per_stage=500,
                            batch_size=256)
    jcfg = jabc.ABCSMCConfig(**cfg.__dict__)
    _same_error(
        lambda: jabc.abc_smc_weighted(jax.random.PRNGKey(0), staged=js, observed=OBS,
                                      distance=jdist, config=jcfg, param_addresses=("mu_p",)),
        lambda: tabc.abc_smc_weighted(0, staged=ts, observed=OBS, distance=tdist, config=cfg,
                                      param_addresses=("mu_p",)))


def test_empty_population_raises_abc_error():
    """An intended divergence: with n_particles=0 the JAX package's own
    "empty initial population" check (abc.py:335) is unreachable, because
    its stage-0 rejection fails first with an IndexError at collected[0]
    (abc.py:229). The port raises the ABCError before any simulation."""
    js, ts = ft.stage(jsim), ftt.stage(tsim, device="cpu")
    cfg = tabc.ABCSMCConfig(n_particles=0)
    with pytest.raises(IndexError):
        jabc.abc_smc_weighted(jax.random.PRNGKey(0), staged=js, observed=OBS, distance=jdist,
                              config=jabc.ABCSMCConfig(n_particles=0))
    with pytest.raises(tabc.ABCError, match="empty initial population") as te:
        tabc.abc_smc_weighted(0, staged=ts, observed=OBS, distance=tdist, config=cfg)
    assert int(te.value.code) == 302


def test_discrete_parameter_errors_match_jax():
    def jm():
        k = ft.sample("k", ft.Poisson(3.0))
        return ft.sample("x", ft.Normal(k * 1.0, 1.0), sample_shape=(4,))

    def tm():
        k = ftt.sample("k", ftt.Poisson(3.0))
        return ftt.sample("x", ftt.Normal(k.to(torch.float64), 1.0), sample_shape=(4,))

    js, ts = ft.stage(jm), ftt.stage(tm, device="cpu")
    obs = np.zeros(4)
    for addrs in (None, ("k",)):
        err = _same_error(
            lambda: jabc.abc_smc_weighted(jax.random.PRNGKey(0), staged=js, observed=obs,
                                          param_addresses=addrs),
            lambda: tabc.abc_smc_weighted(0, staged=ts, observed=obs, param_addresses=addrs))
        assert int(err.code) == 700


# ---------------------------------------------------------------------------
# Whole runs
# ---------------------------------------------------------------------------


def _mean_sd(particles):
    x = _np(particles["mu_p"])
    return x.mean(), x.std()


@pytest.mark.parametrize("inner", [1, 4])
def test_rejection_recovers_the_posterior_and_matches_jax(inner):
    js, ts = ft.stage(jsim), ftt.stage(tsim, device="cpu")
    kw = dict(observed=OBS, epsilon=0.05, n_samples=600, batch_size=2048, inner_batches=inner,
              max_attempts=1 << 22)
    tr = tabc.abc_rejection(3, staged=ts, distance=tdist, **kw)
    jr = jabc.abc_rejection(jax.random.PRNGKey(3), staged=js, distance=jdist, **kw)
    assert tr.particles["mu_p"].shape == (600,) and tr.particles["xs"].shape == (600, N_OBS)
    assert tr.distances.shape == (600,) and float(tr.distances.max()) <= 0.05
    assert tr.n_attempts % (inner * 2048) == 0 and _np(tr.log_weights).tolist() == [0.0] * 600
    # the accepted rows' data are their own simulations
    np.testing.assert_allclose(
        _np(tr.distances), np.abs(_np(tr.particles["xs"]).mean(1) - OBS.mean()), **EXACT)
    m, s = _mean_sd(tr.particles)
    jm, _ = _mean_sd(jr.particles)
    se = POST_SD / np.sqrt(600)
    assert abs(m - POST_MEAN) < 5 * se and abs(s / POST_SD - 1) < 0.2
    assert abs(m - jm) < 5 * np.sqrt(2) * se
    np.testing.assert_allclose(_np(tr.posterior_mean("mu_p")), m, **EXACT)


def test_scalar_summary_recovers_the_posterior():
    res = tabc.abc_scalar_summary(4, tsim, observed_summary=float(OBS.mean()), epsilon=0.05,
                                  n_samples=400, batch_size=4096, max_attempts=1 << 22,
                                  device="cpu")
    m, _ = _mean_sd(res.particles)
    assert abs(m - POST_MEAN) < 5 * POST_SD / np.sqrt(400)


def _smc_config():
    return tabc.ABCSMCConfig(n_particles=256, epsilons=(0.5, 0.2, 0.1, 0.05), batch_size=2048,
                             max_attempts_per_stage=1 << 20)


def test_smc_weighted_and_equal_weight_recover_the_posterior_and_match_jax():
    js, ts = ft.stage(jsim), ftt.stage(tsim, device="cpu")
    cfg = _smc_config()
    kw = dict(observed=OBS, config=cfg, param_addresses=("mu_p",))
    tr = tabc.abc_smc_weighted(5, staged=ts, distance=tdist, **kw)
    jr = jabc.abc_smc_weighted(jax.random.PRNGKey(5), staged=js, distance=jdist,
                               observed=OBS, config=jabc.ABCSMCConfig(**cfg.__dict__),
                               param_addresses=("mu_p",))
    assert set(tr.particles) == set(jr.particles) == {"mu_p"}
    w = np.exp(_np(tr.log_weights))
    assert abs(w.sum() - 1.0) < 1e-12
    ess = 1.0 / np.sum(w * w)
    means = []
    for res in (tr, jr):
        lw = np.asarray(_np(res.log_weights))
        ww = np.exp(lw) / np.exp(lw).sum()
        means.append(float(np.sum(ww * np.asarray(_np(res.particles["mu_p"])))))
    se = POST_SD / np.sqrt(ess)
    assert abs(means[0] - POST_MEAN) < 5 * se
    assert abs(means[0] - means[1]) < 5 * np.sqrt(2) * se
    np.testing.assert_allclose(_np(tr.posterior_mean("mu_p")), means[0], **EXACT)
    assert tr.n_attempts >= 4 * 2048
    eq = tabc.abc_smc(5, staged=ts, distance=tdist, device="cpu", **kw)
    x = _np(eq.particles["mu_p"])
    assert x.shape == (256,) and _np(eq.log_weights).tolist() == [0.0] * 256
    assert abs(x.mean() - POST_MEAN) < 5 * POST_SD * np.sqrt(1.0 / ess + 1.0 / 256)
    # the resample draws particles of the weighted run, with their distances
    for v, d in zip(x[:20], _np(eq.distances)[:20]):
        i = int(np.flatnonzero(_np(tr.particles["mu_p"]) == v)[0])
        assert d == _np(tr.distances)[i]


def test_final_distances_share_one_noise_draw():
    """The JAX package replays every particle with the one key fold_in(key,
    777); the port replays them with one shared draw of the seed
    fold_seed(seed, 777), so each particle's distance is that of the single
    replay at its parameter."""
    js, ts = ft.stage(jsim), ftt.stage(tsim, device="cpu")
    cfg = tabc.ABCSMCConfig(n_particles=64, epsilons=(0.5, 0.3), batch_size=2048,
                            max_attempts_per_stage=1 << 20)
    tr = tabc.abc_smc_weighted(6, staged=ts, observed=OBS, distance=tdist, config=cfg,
                               param_addresses=("mu_p",))
    thetas = _np(tr.particles["mu_p"])
    for i in (0, 17, 63):
        data, _ = ts.replay_partial(fold_seed(6, 777), {"mu_p": torch.as_tensor(thetas[i])})
        np.testing.assert_allclose(_np(tr.distances[i]), _np(tdist(data, torch.as_tensor(OBS))),
                                   **EXACT)
    # one noise draw: distance differences come from the parameters alone
    noise = _np(tr.distances)  # |theta_i + e_bar - obs_bar| with one e_bar
    e_bar = _np(ts.replay_partial(fold_seed(6, 777), {"mu_p": torch.tensor(0.0, dtype=torch.float64)})[0]).mean()
    np.testing.assert_allclose(noise, np.abs(thetas + e_bar - OBS.mean()), rtol=1e-10, atol=1e-10)
    # the JAX package does the same with its key
    key = jax.random.PRNGKey(6)
    jr = jabc.abc_smc_weighted(key, staged=js, observed=OBS, distance=jdist,
                               config=jabc.ABCSMCConfig(**cfg.__dict__), param_addresses=("mu_p",))
    jth = np.asarray(jr.particles["mu_p"])
    je = np.asarray(js.replay_partial(jax.random.fold_in(key, 777), {"mu_p": jnp.asarray(0.0)})[0]).mean()
    np.testing.assert_allclose(np.asarray(jr.distances), np.abs(jth + je - OBS.mean()),
                               rtol=1e-10, atol=1e-10)
