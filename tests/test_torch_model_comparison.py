"""The PyTorch port's WAIC and PSIS-LOO against fugue_tpu, on the CPU.

On the same numpy (S, n) log-likelihood matrices, ``waic``, ``psis_loo``
(elpd, se, p_eff, pointwise values and k̂), ``psis_smooth`` and the
generalized-Pareto fit agree to 1e-10, and ``compare`` prints the same
table. ``pointwise_log_likelihood`` of the same draws through both
packages' models (a vector observe site and a scalar one) agrees to
1e-10, from engine-shaped (chains, draws) and flat draw batches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from fugue_tpu.inference import model_comparison as jmc
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference import model_comparison as tmc

EXACT = dict(rtol=1e-10, atol=1e-10)
Y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
SIG = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def _matrices():
    rng = np.random.default_rng(0)
    heavy = rng.standard_t(2.5, size=(400, 6)) - 2.0
    return {"normal": rng.normal(-1.0, 0.5, size=(300, 10)), "heavy": heavy,
            "few": rng.normal(size=(20, 4))}


@pytest.mark.parametrize("name", ["normal", "heavy", "few"])
def test_waic_and_loo_match_jax(name):
    ll = _matrices()[name]
    for fn in ("waic", "psis_loo"):
        j = getattr(jmc, fn)(jnp.asarray(ll))
        t = getattr(tmc, fn)(torch.tensor(ll))
        for field in ("elpd", "se", "p_eff"):
            assert getattr(t, field) == pytest.approx(getattr(j, field), rel=1e-10, abs=1e-10)
        np.testing.assert_allclose(t.pointwise, j.pointwise, **EXACT)
        assert t.method == j.method
        if fn == "psis_loo":
            np.testing.assert_allclose(t.pareto_k, j.pareto_k, **EXACT)
            assert repr(t) == repr(j)


def test_psis_smooth_and_gpd_fit_match_jax():
    rng = np.random.default_rng(1)
    for lr in (rng.standard_t(1.5, size=500), rng.normal(size=64), rng.normal(size=8)):
        tw, tk = tmc.psis_smooth(lr)
        jw, jk = jmc.psis_smooth(lr)
        np.testing.assert_allclose(tw, jw, **EXACT)
        assert tk == jk or tk == pytest.approx(jk, rel=1e-10)
    x = np.sort(rng.pareto(2.0, size=100)) + 1e-3
    np.testing.assert_allclose(tmc._gpd_fit(x), jmc._gpd_fit(x), **EXACT)


def test_compare_prints_the_same_table():
    mats = _matrices()
    t = {k: tmc.psis_loo(torch.tensor(v[:, :4])) for k, v in mats.items()}
    j = {k: jmc.psis_loo(jnp.asarray(v[:, :4])) for k, v in mats.items()}
    assert tmc.compare(t) == jmc.compare(j)


def jax_schools():
    mu = ft.sample("mu", ft.Normal(0.0, 5.0))
    tau = ft.sample("tau", ft.HalfCauchy(5.0))
    eta = ft.sample("eta", ft.Normal(jnp.zeros(8), 1.0))
    ft.observe("y", ft.Normal(mu + tau * eta, jnp.asarray(SIG)), jnp.asarray(Y))
    ft.observe("extra", ft.Normal(mu, 3.0), jnp.asarray(2.0))


def torch_schools():
    mu = ftt.sample("mu", ftt.Normal(0.0, 5.0))
    tau = ftt.sample("tau", ftt.HalfCauchy(5.0))
    eta = ftt.sample("eta", ftt.Normal(torch.zeros(8, dtype=torch.float64), 1.0))
    ftt.observe("y", ftt.Normal(mu + tau * eta, torch.tensor(SIG)), torch.tensor(Y))
    ftt.observe("extra", ftt.Normal(mu, 3.0), torch.tensor(2.0, dtype=torch.float64))


def test_pointwise_log_likelihood_matches_jax():
    rng = np.random.default_rng(2)
    draws = {"mu": rng.normal(size=(3, 5)), "tau": rng.uniform(0.5, 4.0, size=(3, 5)),
             "eta": rng.normal(size=(3, 5, 8))}
    j = jmc.pointwise_log_likelihood({a: jnp.asarray(v) for a, v in draws.items()},
                                     jax_schools)
    t = ftt.pointwise_log_likelihood({a: torch.tensor(v) for a, v in draws.items()},
                                     torch_schools, device="cpu")
    assert t.shape == (15, 9)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **EXACT)
    flat = {a: torch.tensor(v.reshape((15,) + v.shape[2:])) for a, v in draws.items()}
    t1 = ftt.pointwise_log_likelihood(flat, torch_schools, n_batch_axes=1, device="cpu")
    np.testing.assert_allclose(t1.numpy(), t.numpy(), **EXACT)
    # the columns are log N(y_j | mu + tau eta_j, sigma_j), then the scalar site
    mu, tau, eta = (draws[a].reshape((15,) + draws[a].shape[2:]) for a in ("mu", "tau", "eta"))
    theta = mu[:, None] + tau[:, None] * eta
    direct = -0.5 * ((Y - theta) / SIG) ** 2 - np.log(SIG) - 0.5 * np.log(2 * np.pi)
    np.testing.assert_allclose(t.numpy()[:, 1:], direct, **EXACT)
