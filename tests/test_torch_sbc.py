"""The PyTorch port's simulation-based calibration against fugue_tpu, on
the CPU.

The datasets run as one batch of chains, each with its own dataset and its
own adaptation (``make_hmc_drive(per_chain=True)``). The lock-step
reasonable-ε search gives every chain the JAX package's
``find_reasonable_epsilon`` on that chain's dataset from the same momentum
(1e-12), so a step size is never shared across datasets; each chain's
Welford moments are the JAX package's one-chain moments of its own
trajectory, and one mass matrix per chain is each chain's own shared-mass
algebra. Dense mass runs, as under the JAX package's ``sbc``.
At ``tests/test_sbc.py``'s settings the correct pipeline passes the χ²
test and the wrong-prior control fails it; the structural guards
(discrete sites, simplex sites, a missing observed address) raise the
same codes as the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from fugue_tpu.inference import hmc as jhmc
from fugue_tpu.inference.hmc import find_reasonable_epsilon as jax_fre
from fugue_tpu.inference.sbc import sbc as jax_sbc
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference import hmc as thmc
from fugue_tpu_torch.inference import sbc as tsbc


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def torch_model(data):
    mu = ftt.sample("mu", ftt.Normal(0.0, 1.0))
    sig = ftt.sample("sig", ftt.LogNormal(0.0, 0.5))
    ftt.observe("y", ftt.Normal(mu, sig), data["y"])


def jax_model(data):
    mu = ft.sample("mu", ft.Normal(0.0, 1.0))
    sig = ft.sample("sig", ft.LogNormal(0.0, 0.5))
    ft.observe("y", ft.Normal(mu, sig), data["y"])


def test_each_dataset_gets_its_own_reasonable_epsilon():
    rng = np.random.default_rng(0)
    C = 6
    ys = rng.normal(size=(C, 8)) * np.array([0.01, 0.1, 1.0, 3.0, 10.0, 30.0])[:, None]
    q = rng.normal(size=(C, 2)) * 0.5
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    want, ps = [], []
    for c in range(C):
        js = ft.stage(jax_model, {"y": jnp.asarray(ys[c])})
        fre = jax.jit(lambda z, k: jax_fre(js.potential, z, k, jnp.ones(2)))
        want.append(float(fre(jnp.asarray(q[c]), keys[c])))
        ps.append(np.asarray(jax.random.normal(keys[c], (2,), jnp.float64)))
    ts = ftt.stage(torch_model, {"y": torch.zeros(8, dtype=torch.float64)}, device="cpu")
    data = {"y": torch.tensor(ys)}
    grad_u = vmap(grad_and_value(lambda z, d: tsbc._with_data(ts, d).potential(z)))
    unit = thmc.identity_mass(2, False, dtype=torch.float64, device="cpu", chains=C)
    eps = thmc.find_reasonable_epsilon_per_chain(lambda z: grad_u(z, data), torch.tensor(q),
                                                 torch.tensor(np.stack(ps)), unit)
    np.testing.assert_allclose(eps.numpy(), want, rtol=1e-12)
    assert len(set(np.round(want, 12))) > 3  # the datasets' scales differ


@pytest.mark.parametrize("dense", [False, True])
def test_per_chain_welford_is_each_chains_one_chain_run(dense):
    rng = np.random.default_rng(4)
    C, d, T = 5, 3, 7
    traj = rng.normal(size=(T, C, d)) * np.array([0.1, 1.0, 10.0])
    tw = thmc.WelfordState.init(d, dense, dtype=torch.float64, device="cpu", chains=C)
    for t in range(T):
        tw = thmc.welford_push_batch(tw, torch.tensor(traj[t]).unsqueeze(-2))
    if dense:
        got = thmc.welford_covariance(tw).numpy()
    else:
        got = torch.diag_embed(thmc.welford_variance(tw)).numpy()
    for c in range(C):
        jw = jhmc.WelfordState.init(d, dense)
        for t in range(T):
            jw = jhmc.welford_push_batch(jw, jnp.asarray(traj[t, c:c + 1]))
        want = jhmc.welford_covariance(jw) if dense else jnp.diag(jhmc.welford_variance(jw))
        np.testing.assert_allclose(got[c], np.asarray(want), rtol=1e-12, atol=1e-15)


def test_one_mass_per_chain_is_each_chains_own_algebra():
    rng = np.random.default_rng(5)
    C, d = 4, 3
    a = rng.normal(size=(C, d, d))
    covs = torch.tensor(a @ np.swapaxes(a, 1, 2) + 0.5 * np.eye(d))
    diags = torch.tensor(rng.uniform(0.2, 3.0, size=(C, d)))
    p, z = torch.tensor(rng.normal(size=(C, d))), torch.tensor(rng.normal(size=(C, d)))
    for per_chain, shared in ((covs, list(covs)), (torch.diag_embed(diags), list(diags))):
        vel = thmc.mass_velocity(per_chain, p)
        kin = thmc.mass_kinetic(per_chain, p)
        mom = thmc.momentum_from_normal(per_chain, z)
        for c in range(C):
            np.testing.assert_allclose(vel[c], thmc.mass_velocity(shared[c], p[c]), rtol=1e-13)
            np.testing.assert_allclose(kin[c], thmc.mass_kinetic(shared[c], p[c]), rtol=1e-13)
            np.testing.assert_allclose(mom[c], thmc.momentum_from_normal(shared[c], z[c][None])[0],
                                       rtol=1e-12)
    bad = covs.clone()
    bad[1] = -bad[1]  # not positive definite: that chain's momenta are NaN, the rest finite
    mom = thmc.momentum_from_normal(bad, z)
    assert torch.isnan(mom[1]).all() and torch.isfinite(mom[[0, 2, 3]]).all()


def test_correct_pipeline_is_calibrated():
    r = ftt.sbc(0, torch_model, {"y": np.zeros(8)}, n_datasets=96, n_posterior=63,
                n_warmup=200, thin=4, device="cpu")
    assert isinstance(r, ftt.SBCResult)
    assert r.ranks.shape == (96, 2) and r.ranks.min() >= 0 and r.ranks.max() <= 63
    assert r.coords == ["mu", "sig"] and r.n_bins == 8
    assert r.passed, r.report()
    assert "PASS" in r.report()


def test_dense_mass_pipeline_is_calibrated():
    r = ftt.sbc(2, torch_model, {"y": np.zeros(8)}, n_datasets=96, n_posterior=63,
                n_warmup=200, thin=4, config=ftt.HMCConfig(n_leapfrog=16, mass="dense"),
                device="cpu")
    assert r.ranks.shape == (96, 2) and r.passed, r.report()


def test_wrong_inference_prior_is_rejected():
    def wrong(data):
        mu = ftt.sample("mu", ftt.Normal(3.0, 0.3))
        sig = ftt.sample("sig", ftt.LogNormal(0.0, 0.5))
        ftt.observe("y", ftt.Normal(mu, sig), data["y"])

    r = ftt.sbc(1, torch_model, {"y": np.zeros(8)}, n_datasets=96, n_posterior=63,
                n_warmup=200, thin=4, inference_model_fn=wrong, device="cpu")
    assert not r.passed, r.report()
    assert r.p_values.min() < 1e-6


def _code(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, info.value.code.name


def test_structural_guards_raise_the_same_codes():
    def jdisc(data):
        ft.sample("k", ft.Bernoulli(0.5))
        mu = ft.sample("mu", ft.Normal(0.0, 1.0))
        ft.observe("y", ft.Normal(mu, 1.0), data["y"])

    def tdisc(data):
        ftt.sample("k", ftt.Bernoulli(0.5))
        mu = ftt.sample("mu", ftt.Normal(0.0, 1.0))
        ftt.observe("y", ftt.Normal(mu, 1.0), data["y"])

    def jsimplex(data):
        w = ft.sample("w", ft.Dirichlet(jnp.ones(3)))
        ft.observe("y", ft.Normal(w[0], 1.0), data["y"])

    def tsimplex(data):
        w = ftt.sample("w", ftt.Dirichlet(torch.ones(3, dtype=torch.float64)))
        ftt.observe("y", ftt.Normal(w[0], 1.0), data["y"])

    def jmissing(data):
        mu = ft.sample("mu", ft.Normal(0.0, 1.0))
        ft.observe("y", ft.Normal(mu, 1.0), data["y"])
        ft.observe("y2", ft.Normal(mu, 1.0), jnp.zeros(2))

    def tmissing(data):
        mu = ftt.sample("mu", ftt.Normal(0.0, 1.0))
        ftt.observe("y", ftt.Normal(mu, 1.0), data["y"])
        ftt.observe("y2", ftt.Normal(mu, 1.0), torch.zeros(2, dtype=torch.float64))

    for jm, tm in ((jdisc, tdisc), (jsimplex, tsimplex), (jmissing, tmissing)):
        want = _code(lambda: jax_sbc(jax.random.PRNGKey(0), jm, {"y": jnp.zeros(3)},
                                     n_datasets=4))
        assert _code(lambda: ftt.sbc(0, tm, {"y": np.zeros(3)}, n_datasets=4,
                                     device="cpu")) == want
