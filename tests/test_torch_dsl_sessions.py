"""The PyTorch port's DSL sessions against the JAX package's, on the CPU.

- The particle filter's pure step (``pf_step``), fed the JAX filter's own
  draws (the random-walk normals and the comb offset ``u0 =
  jax.random.uniform(k2, ())``), equals the JAX filter's particles,
  log-weights and (mean, var, ess) to 1e-10 over 20 observations, with
  resampling steps among them.
- ``log_joint_grid`` with every other site pinned equals JAX's (1e-10).
- ``smc_run`` returns JAX's keys, and its moments and log-evidence sit
  within Monte-Carlo error of the closed form.
- ``MhSession``: the history cap, the shapes, the pinned scale, one host
  transfer's values equal to the history, and the conjugate mean.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from fugue_tpu.dsl import compiler as jc
from fugue_tpu.dsl import sessions as js
from fugue_tpu_torch import settings
from fugue_tpu_torch.dsl import compiler as tc
from fugue_tpu_torch.dsl import sessions as ts

TOL = dict(rtol=1e-10, atol=1e-10)
Y3 = np.array([1.0, 1.2, 0.8])


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def torch_normal_model():
    y = torch.as_tensor(Y3)

    def model():
        mu = ftt.sample("mu", ftt.Normal(0.0, 2.0))
        ftt.observe("y", ftt.Normal(mu, 1.0), y)
        return mu

    return model


def test_pf_step_matches_jax_filter():
    n, q, r = 64, 0.3, 0.5
    ys = np.cumsum(np.random.default_rng(0).normal(0.0, 0.6, 20))
    pf = js.ParticleFilter(jax.random.PRNGKey(4), n_particles=n, process_sd=q, obs_sd=r)
    particles = torch.as_tensor(np.array(pf.particles))
    log_w = torch.as_tensor(np.array(pf.log_weights))
    key = jax.random.split(jax.random.PRNGKey(4))[1]  # the filter's key after its init draw
    resampled = 0
    for y in ys:
        key, k = jax.random.split(key)  # the JAX filter's schedule, step by step
        k1, k2 = jax.random.split(k)
        noise = torch.as_tensor(np.array(jax.random.normal(k1, (n,), jnp.float64)))
        u0 = torch.as_tensor(np.array(jax.random.uniform(k2, ())))
        est = pf.observe(float(y))
        particles, log_w, mean, var, ess = ts.pf_step(particles, log_w, float(y), noise, u0,
                                                       q, r)
        np.testing.assert_allclose(particles.numpy(), np.asarray(pf.particles), **TOL)
        np.testing.assert_allclose(log_w.numpy(), np.asarray(pf.log_weights), **TOL)
        np.testing.assert_allclose([mean.item(), var.item(), ess.item()],
                                   [est["mean"], est["var"], est["ess"]], **TOL)
        resampled += bool(torch.all(log_w == 0))
    assert 5 <= resampled < len(ys)


def test_particle_filter_tracks_state():
    rng = np.random.default_rng(0)
    true_x = np.cumsum(rng.normal(0, 0.3, 30))
    obs = true_x + rng.normal(0, 0.5, 30)
    pf = ts.ParticleFilter(1, n_particles=1024, process_sd=0.3, obs_sd=0.5, device="cpu")
    means = [pf.observe(y)["mean"] for y in obs]
    assert np.sqrt(np.mean((np.asarray(means) - true_x) ** 2)) < 0.5
    assert pf.estimates[-1]["ess"] > 10 and len(pf.estimates) == 30
    assert pf.particles.dtype == torch.float64 and pf.particles.shape == (1024,)


def test_log_joint_grid_matches_jax():
    src = """
let mu <- sample("mu", normal(0.0, 5.0));
let tau <- sample("tau", lognormal(0.5, 1.0));
for j in 0..8 {
    let theta_raw <- sample(("theta_raw", j), normal(0.0, 1.0));
    observe(("y", j), normal(mu + tau * theta_raw, sigma[j]), y[j]);
}
"""
    data = {"y": [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0],
            "sigma": [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]}
    fixed = {f"theta_raw#{j}": v
             for j, v in enumerate(np.random.default_rng(1).normal(size=8))}
    jg = js.log_joint_grid(jc.compile_model(src).build(data), "mu", "tau", (-5.0, 15.0),
                           (0.1, 20.0), resolution=16, fixed=fixed)
    tg = ts.log_joint_grid(tc.compile_model(src).build(data, device="cpu"), "mu", "tau",
                           (-5.0, 15.0), (0.1, 20.0), resolution=16, fixed=fixed,
                           device="cpu")
    assert tg["log_joint"].shape == (16, 16)
    for k in ("x", "y", "log_joint"):
        np.testing.assert_allclose(tg[k], np.asarray(jg[k]), **TOL)


def test_smc_run_matches_jax_keys_and_moments():
    def jax_model():
        p = ft.sample("p", ft.Beta(2.0, 2.0))
        ft.observe("y", ft.Bernoulli(p), jnp.array([True, True, False]))
        return p

    def torch_model():
        p = ftt.sample("p", ftt.Beta(2.0, 2.0))
        ftt.observe("y", ftt.Bernoulli(p), torch.tensor([True, True, False]))
        return p

    jout = js.smc_run(jax.random.PRNGKey(2), jax_model, n_particles=512)
    tout = ts.smc_run(2, torch_model, n_particles=2048, device="cpu")
    assert set(tout) == set(jout)
    assert set(tout["posterior_means"]) == set(jout["posterior_means"]) == {"p"}
    # the posterior is Beta(4, 3): mean 4/7, var 12/392; log Z = log B(4,3) - log B(2,2)
    mean, var = 4 / 7, 12 / 392
    se = math.sqrt(var / tout["ess"])
    assert abs(tout["posterior_means"]["p"] - mean) < 5 * se
    assert abs(tout["posterior_vars"]["p"] - var) < 0.25 * var
    log_b = lambda a, b: math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)  # noqa: E731
    assert abs(tout["log_evidence"] - (log_b(4, 3) - log_b(2, 2))) < 0.05
    assert tout["n_stages"] >= 1


def test_mh_session_incremental():
    sess = ts.MhSession(0, torch_normal_model(), n_chains=4, history_cap=100, device="cpu")
    out = sess.step(150)
    assert out["mu"].shape == (4,) and out["mu"].dtype == np.float64
    assert len(sess.history) == 100  # capped
    vals = sess.chain_values("mu")
    assert vals.shape == (100, 4)
    np.testing.assert_array_equal(vals[-1], out["mu"])
    np.testing.assert_array_equal(sess.history[-1]["mu"], out["mu"])
    assert 0.0 < sess.accept_rate < 1.0
    assert ts.HmcSession is ftt.HmcSession


def test_mh_session_conjugate_mean():
    """mu ~ N(0, 2²), three N(mu, 1) observations: the posterior mean is
    3.0 / 3.25, its sd 1 / sqrt(3.25)."""
    sess = ts.MhSession(3, torch_normal_model(), n_chains=64, history_cap=400, device="cpu")
    sess.step(400)
    draws = sess.chain_values("mu")[200:]
    se = draws.std() / math.sqrt(ftt.ess_multichain(torch.as_tensor(draws.T)).item())
    assert abs(draws.mean() - 3.0 / 3.25) < 5 * se


def test_mh_session_pinned_scale():
    sess = ts.MhSession(5, torch_normal_model(), n_chains=4, pinned_scale=0.7, device="cpu")
    sess.step(100)
    np.testing.assert_allclose(sess.carry["state"].adapt.scale().numpy(), 0.7, rtol=1e-6)


def test_mh_session_builds_its_proposal_tables_before_the_first_step():
    """The first ``step`` copies nothing from the host: ``init_mh_state``
    has put MH's proposal tables on the device, and the steps reuse them."""
    sess = ts.MhSession(0, torch_normal_model(), n_chains=4, device="cpu")
    tables = sess.staged.__dict__["_mh_meta_tensors"][settings.real_dtype()]
    sess.step(3)
    assert sess.staged.__dict__["_mh_meta_tensors"][settings.real_dtype()] is tables
