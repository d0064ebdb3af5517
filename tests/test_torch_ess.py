"""The PyTorch port's elliptical slice sampler against fugue_tpu, on the CPU.

One transition of the JAX package's ``make_ess_transition``, with its key
schedule replayed to draw ν, the slice level, the first angle and each
shrink round's uniform, equals the port's lock-step transition fed those
draws (float64, 1e-10), shrink counts included. The whole engine
recovers the GP regression of ``examples/gaussian_process.py`` (mean and
covariance in closed form) and the classification's latent signs; the
staging audit raises the same codes for a non-Gaussian prior and for a
centred hierarchy.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from fugue_tpu.inference import ess as jess
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference import ess as tess

EXACT = dict(rtol=1e-10, atol=1e-10)
XG = np.linspace(0.0, 1.0, 6)
K = np.exp(-0.5 * ((XG[:, None] - XG[None, :]) / 0.4) ** 2) + 1e-6 * np.eye(6)
S = 0.3
Y = np.sin(2 * np.pi * XG) + np.random.default_rng(0).normal(0, S, 6)
LABELS = np.array([True, True, True, False, False, False])


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def jax_gp():
    f = ft.sample("f", ft.MultivariateNormal(jnp.zeros(6), jnp.asarray(K)))
    b = ft.sample("b", ft.Normal(0.5, 2.0))
    ft.observe("y", ft.Normal(f + b, S), jnp.asarray(Y))


def torch_gp():
    f = ftt.sample("f", ftt.MultivariateNormal(torch.zeros(6, dtype=torch.float64),
                                               torch.tensor(K)))
    b = ftt.sample("b", ftt.Normal(0.5, 2.0))
    ftt.observe("y", ftt.Normal(f + b, S), torch.tensor(Y))


def torch_regression():
    f = ftt.sample("f", ftt.MultivariateNormal(torch.zeros(6, dtype=torch.float64),
                                               torch.tensor(K)))
    ftt.observe("y", ftt.Normal(f, S), torch.tensor(Y))


def torch_classification():
    f = ftt.sample("f", ftt.MultivariateNormal(torch.zeros(6, dtype=torch.float64),
                                               torch.tensor(K)))
    ftt.observe("y", ftt.Bernoulli(torch.sigmoid(3.0 * f)), torch.tensor(LABELS))


def test_one_transition_matches_jax():
    C, cfg = 8, jess.ESSConfig(max_shrink=12)
    js = ft.stage(jax_gp)
    ts = ftt.stage(torch_gp, device="cpu")
    mu_j = jess._gaussian_prior_means(js)
    mu_t = tess._gaussian_prior_means(ts)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), **EXACT)
    jt = jess.make_ess_transition(js, mu_j, cfg)
    rng = np.random.default_rng(3)
    f0 = rng.normal(size=(C, 7))
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    jf, jll, jits = jax.vmap(jt)(jnp.asarray(f0), keys)

    def draws(key):
        k_nu, k_u, k_theta, k_loop = jax.random.split(key, 4)
        nu = js.flatten_constrained(js.sample_prior(k_nu))
        u = jax.random.uniform(k_u, (), jnp.float64, 1e-38, 1.0)
        theta0 = jax.random.uniform(k_theta, (), jnp.float64, 0.0, 2.0 * np.pi)
        shrink = []
        for _ in range(cfg.max_shrink):
            k_loop, k_t = jax.random.split(k_loop)
            shrink.append(jax.random.uniform(k_t, (), jnp.float64))
        return nu, jnp.log(u), theta0, jnp.stack(shrink)

    nu, log_u, theta0, shrink = jax.vmap(draws)(keys)
    noise = tess.ESSNoise(nu=torch.tensor(np.asarray(nu)), log_u=torch.tensor(np.asarray(log_u)),
                          theta0=torch.tensor(np.asarray(theta0)),
                          shrink=torch.tensor(np.asarray(shrink)).T)
    tt = tess.make_ess_transition(ts, mu_t, tess.ESSConfig(max_shrink=12))
    ll0 = tess._batched_loglik(ts, None)(torch.tensor(f0))
    f, ll, its, reads = tt(torch.tensor(f0), ll0, noise)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), **EXACT)
    np.testing.assert_allclose(ll.numpy(), np.asarray(jll), **EXACT)
    np.testing.assert_array_equal(its.numpy(), np.asarray(jits))
    assert reads == int(np.asarray(jits).max()) - (1 if np.asarray(jits).max() == 12 else 0)


def test_gp_regression_against_the_closed_form():
    res = ftt.ess_chain(0, torch_regression, n_samples=300, n_warmup=60, n_chains=32,
                        device="cpu")
    fs = res.samples["f"].reshape(-1, 6).numpy()
    A = K @ np.linalg.inv(K + S**2 * np.eye(6))
    post_mean, post_cov = A @ Y, K - A @ K
    sd = np.sqrt(np.diag(post_cov))
    e = ftt.ess_multichain(res.samples["f"].movedim(-1, 0)).numpy()
    assert np.all(np.abs(fs.mean(0) - post_mean) < 5 * sd / np.sqrt(e))
    assert np.allclose(np.cov(fs.T), post_cov, atol=0.03)
    assert 1.0 <= res.mean_shrink_iters < 12
    assert res.log_lik.shape == (32, 300) and res.final_flat.shape == (32, 6)
    # one read per shrink round after the first, per transition (and one
    # for the mean): at most max_shrink - 1 per transition
    assert 360 <= res.host_reads <= 360 * 29 + 1


def test_gp_classification_signs():
    res = ftt.ess_chain(1, torch_classification, n_samples=200, n_warmup=60, n_chains=32,
                        device="cpu")
    means = res.samples["f"].reshape(-1, 6).mean(0).numpy()
    assert means[0] > 0.15 and means[-1] < -0.15


def _code(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, info.value.code.name


def test_the_audit_raises_the_same_codes():
    def jlog():
        x = ft.sample("x", ft.LogNormal(0.0, 1.0))
        ft.observe("y", ft.Normal(x, 1.0), jnp.asarray(1.0))

    def tlog():
        x = ftt.sample("x", ftt.LogNormal(0.0, 1.0))
        ftt.observe("y", ftt.Normal(x, 1.0), torch.tensor(1.0))

    def jcentred():
        m = ft.sample("m", ft.Normal(0.0, 1.0))
        x = ft.sample("x", ft.Normal(m, 1.0))
        ft.observe("y", ft.Normal(x, 1.0), jnp.asarray(1.0))

    def tcentred():
        m = ftt.sample("m", ftt.Normal(0.0, 1.0))
        x = ftt.sample("x", ftt.Normal(m, 1.0))
        ftt.observe("y", ftt.Normal(x, 1.0), torch.tensor(1.0))

    for jm, tm in ((jlog, tlog), (jcentred, tcentred)):
        want = _code(lambda: ft.ess_chain(jax.random.PRNGKey(0), jm, 2, 2, n_chains=2))
        assert _code(lambda: ftt.ess_chain(0, tm, 2, 2, n_chains=2, device="cpu")) == want
    assert math.isfinite(tess._gaussian_prior_means(ftt.stage(torch_gp, device="cpu"))[-1].item())
