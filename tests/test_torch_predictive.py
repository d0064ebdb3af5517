"""Parity of the PyTorch port's predictive sampling with fugue_tpu, on the CPU.

The cases of ``tests/test_predictive.py`` in both packages, float64: the
prior single draw, the batched prior-predictive moments, the normal-normal
posterior predictive against N(mu_n, tau_n^2 + sigma^2), the
``return_sites`` filter with a fresh latent, and the batch-shape mismatch
error. With every latent pinned the latents are exact; the observation
sites' moments agree within Monte-Carlo error (the packages' generators
differ). The whole flattened batch is one model run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from fugue_tpu.inference.predictive import predictive as jpredictive
from fugue_tpu_torch import settings


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def test_prior_predictive_single_draw():
    def jm():
        p = ft.sample("p", ft.Beta(2.0, 2.0))
        ft.observe("y", ft.Bernoulli(p), jnp.ones(10, bool))

    def tm():
        p = ftt.sample("p", ftt.Beta(2.0, 2.0))
        ftt.observe("y", ftt.Bernoulli(p), torch.ones(10, dtype=torch.bool))

    jout = jpredictive(jax.random.PRNGKey(0), jm, batch_ndim=0)
    out = ftt.predictive(0, tm, batch_ndim=0, device="cpu")
    assert set(out) == set(jout) == {"p", "y"}
    assert out["y"].shape == jout["y"].shape == (10,)
    assert out["y"].dtype == torch.bool and jout["y"].dtype == jnp.bool_
    assert 0.0 < float(out["p"]) < 1.0


def test_prior_predictive_batched_moments_and_one_model_run():
    runs = [0]

    def tm():
        runs[0] += 1
        mu = ftt.sample("mu", ftt.Normal(0.0, 1.0))
        ftt.observe("y", ftt.Normal(mu, 1.0), 0.0)

    def jm():
        mu = ft.sample("mu", ft.Normal(0.0, 1.0))
        ft.observe("y", ft.Normal(mu, 1.0), 0.0)

    n = 4000
    out = ftt.predictive(1, tm, {"_dummy": torch.zeros(n)}, batch_ndim=1, device="cpu")
    jout = jpredictive(jax.random.PRNGKey(1), jm, {"_dummy": jnp.zeros(n)}, batch_ndim=1)
    assert runs[0] == 1
    ys, jys = out["y"].numpy(), np.asarray(jout["y"])
    assert ys.shape == jys.shape == (n,) and set(out) == set(jout) == {"mu", "y"}
    for v in (ys, jys):
        assert v.mean() == pytest.approx(0.0, abs=4 * np.sqrt(2 / n))
        assert v.var() == pytest.approx(2.0, abs=0.15)
    # the two packages' predictives agree within MC error of a difference
    assert abs(ys.mean() - jys.mean()) < 5 * np.sqrt(2 * 2.0 / n)


def test_posterior_predictive_normal_normal_matches_jax():
    sigma = 1.0
    data = np.array([1.4, 2.1, 1.7, 2.4, 1.9])
    n_obs = len(data)
    tau_n2 = 1.0 / (1.0 / 4.0 + n_obs / sigma**2)
    mu_n = tau_n2 * (data.sum() / sigma**2)

    def jm():
        mu = ft.sample("mu", ft.Normal(0.0, 2.0))
        ft.observe("y", ft.Normal(mu, sigma), jnp.asarray(data))

    def tm():
        mu = ftt.sample("mu", ftt.Normal(0.0, 2.0))
        ftt.observe("y", ftt.Normal(mu, sigma), torch.as_tensor(data))

    n_chains, n_draws = 8, 2000
    mus = mu_n + np.sqrt(tau_n2) * np.random.default_rng(2).standard_normal((n_chains, n_draws))
    out = ftt.posterior_predictive(3, tm, {"mu": torch.as_tensor(mus)}, device="cpu")
    jout = jpredictive(jax.random.PRNGKey(3), jm, {"mu": jnp.asarray(mus)})
    pred_var = tau_n2 + sigma**2
    for ys in (out["y"].numpy(), np.asarray(jout["y"])):
        assert ys.shape == (n_chains, n_draws, n_obs)
        assert ys.mean() == pytest.approx(mu_n, abs=4 * np.sqrt(pred_var / ys.size))
        assert ys.var() == pytest.approx(pred_var, rel=0.05)
    assert "mu" not in out and "mu" not in jout
    # with mu pinned, y - mu is the observation noise: N(0, sigma^2) per draw
    noise = out["y"].numpy() - mus[..., None]
    assert abs(noise.mean()) < 5 * sigma / np.sqrt(noise.size)
    # with every latent pinned and returned, the latents are exact
    pinned = ftt.predictive(4, tm, {"mu": torch.as_tensor(mus)}, return_sites=["mu", "y"],
                            device="cpu")
    jpinned = jpredictive(jax.random.PRNGKey(4), jm, {"mu": jnp.asarray(mus)},
                          return_sites=["mu", "y"])
    np.testing.assert_array_equal(pinned["mu"].numpy(), np.asarray(jpinned["mu"]))
    np.testing.assert_array_equal(pinned["mu"].numpy(), mus)


def test_return_sites_filter_and_fresh_latents():
    def jm():
        mu = ft.sample("mu", ft.Normal(0.0, 1.0))
        extra = ft.sample("extra", ft.Normal(mu, 1.0))
        ft.observe("y", ft.Normal(extra, 1.0), 0.0)

    def tm():
        mu = ftt.sample("mu", ftt.Normal(0.0, 1.0))
        extra = ftt.sample("extra", ftt.Normal(mu, 1.0))
        ftt.observe("y", ftt.Normal(extra, 1.0), 0.0)

    out = ftt.predictive(4, tm, {"mu": torch.zeros((2, 3), dtype=torch.float64)}, device="cpu")
    jout = jpredictive(jax.random.PRNGKey(4), jm, {"mu": jnp.zeros((2, 3))})
    assert set(out) == set(jout) == {"extra", "y"}
    assert out["extra"].shape == jout["extra"].shape == (2, 3)
    only_y = ftt.predictive(4, tm, {"mu": torch.zeros((2, 3), dtype=torch.float64)},
                            return_sites=["y"], device="cpu")
    assert set(only_y) == {"y"}


def test_errors_match_jax():
    def jm():
        ft.sample("a", ft.Normal(0.0, 1.0))
        ft.sample("b", ft.Normal(0.0, 1.0))

    def tm():
        ftt.sample("a", ftt.Normal(0.0, 1.0))
        ftt.sample("b", ftt.Normal(0.0, 1.0))

    for posterior, match in (({"a": np.zeros((2, 3)), "b": np.zeros((2, 4))}, "batch shapes disagree"),
                             ({}, "posterior is empty")):
        with pytest.raises(ValueError, match=match) as je:
            jpredictive(jax.random.PRNGKey(0), jm, {a: jnp.asarray(v) for a, v in posterior.items()})
        with pytest.raises(ValueError, match=match) as te:
            ftt.predictive(0, tm, {a: torch.as_tensor(v) for a, v in posterior.items()}, device="cpu")
        assert str(te.value) == str(je.value)
