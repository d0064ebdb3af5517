"""The PyTorch port's exact discrete marginalization against fugue_tpu, on
the CPU.

JAX in x64 and torch in float64 on the same models and points: the
marginal log joint (constrained and unconstrained), its gradient and
``discrete_posterior`` agree to 1e-10 on a Bernoulli switch and on the
enumerated Gaussian mixture of ``tests/test_marginalize.py``. State
explosion and unbounded counts raise the same codes. HMC, NUTS, MH, VI
and MAP run on the marginalized model unchanged through ``staged=``, and
``infer_discrete`` recovers the switch's posterior within Monte-Carlo
error of a quadrature.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats
from torch.func import grad

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from fugue_tpu.inference.marginalize import marginalize as jmarginalize
from fugue_tpu_torch import settings
from fugue_tpu_torch.errors import StagingError

EXACT = dict(rtol=1e-10, atol=1e-10)
GMM_DATA = np.array([-2.1, -1.9, -2.2, 1.8, 2.2, 2.0])


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def jax_switch():
    z = ft.sample("z", ft.Bernoulli(0.3))
    theta = ft.sample("theta", ft.Normal(0.0, 1.0))
    ft.observe("y", ft.Normal(theta + jnp.where(z, 2.0, -2.0), 1.0), jnp.array(1.5))


def torch_switch():
    z = ftt.sample("z", ftt.Bernoulli(0.3))
    theta = ftt.sample("theta", ftt.Normal(0.0, 1.0))
    shift = torch.where(z, 2.0, -2.0).to(torch.float64)
    ftt.observe("y", ftt.Normal(theta + shift, 1.0), torch.tensor(1.5, dtype=torch.float64))


def jax_gmm():
    mus = jnp.stack([ft.sample("mu0", ft.Normal(-1.0, 3.0)),
                     ft.sample("mu1", ft.Normal(1.0, 3.0))])
    for i, y in enumerate(GMM_DATA):
        zi = ft.sample(f"assign#{i}", ft.Categorical(jnp.full((2,), 0.5)))
        ft.observe(f"y#{i}", ft.Normal(mus[zi], 0.5), jnp.asarray(y))


def torch_gmm(device="cpu"):
    data = torch.tensor(GMM_DATA, device=device)

    def model():
        mus = torch.stack([ftt.sample("mu0", ftt.Normal(-1.0, 3.0)),
                           ftt.sample("mu1", ftt.Normal(1.0, 3.0))])
        for i in range(len(GMM_DATA)):
            zi = ftt.sample(f"assign#{i}", ftt.Categorical.uniform(2))
            ftt.observe(f"y#{i}", ftt.Normal(mus[zi], 0.5), data[i])

    return model


@pytest.mark.parametrize("which", ["switch", "gmm"])
def test_marginal_density_gradient_and_posterior_match_jax(which):
    jm = jmarginalize(jax_switch if which == "switch" else jax_gmm)
    tm = ftt.marginalize(torch_switch if which == "switch" else torch_gmm(), device="cpu")
    assert tm.n_states == jm.n_states == (2 if which == "switch" else 64)
    assert [s.address for s in tm.sites] == [s.address for s in jm.sites]
    assert tm.discrete_sites == [] and tm.dim == jm.dim
    rng = np.random.default_rng(0)
    for z in rng.normal(size=(3, jm.dim)) * 2.0:
        jz = jnp.asarray(z)
        tz = torch.tensor(z)
        np.testing.assert_allclose(tm.log_joint_unconstrained(tz).item(),
                                   float(jm.log_joint_unconstrained(jz)), **EXACT)
        np.testing.assert_allclose(grad(tm.potential)(tz).numpy(),
                                   np.asarray(jax.grad(jm.potential)(jz)), **EXACT)
        lat = {a: v for a, v in tm.constrain(tz)[0].items()}
        np.testing.assert_allclose(tm.log_joint(lat).item(),
                                   float(jm.log_joint({a: jnp.asarray(v.numpy())
                                                       for a, v in lat.items()})), **EXACT)
        tp = tm.discrete_posterior(lat)
        jp = jm.discrete_posterior({a: jnp.asarray(v.numpy()) for a, v in lat.items()})
        assert set(tp) == set(jp)
        for a in tp:
            np.testing.assert_allclose(tp[a].numpy(), np.asarray(jp[a]), **EXACT)


def _code(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, info.value.code.name


def test_state_explosion_and_unbounded_counts_raise_the_same_codes():
    def jwide():
        for i in range(13):
            ft.sample(f"b#{i}", ft.Bernoulli(0.5))
        ft.sample("x", ft.Normal(0.0, 1.0))

    def twide():
        for i in range(13):
            ftt.sample(f"b#{i}", ftt.Bernoulli(0.5))
        ftt.sample("x", ftt.Normal(0.0, 1.0))

    def jcount():
        ft.sample("n", ft.Poisson(3.0))
        ft.sample("x", ft.Normal(0.0, 1.0))

    def tcount():
        ftt.sample("n", ftt.Poisson(3.0))
        ftt.sample("x", ftt.Normal(0.0, 1.0))

    def tnone():
        ftt.sample("x", ftt.Normal(0.0, 1.0))

    def jnone():
        ft.sample("x", ft.Normal(0.0, 1.0))

    for jm, tm in ((jwide, twide), (jcount, tcount), (jnone, tnone)):
        want = _code(lambda: jmarginalize(jm))
        assert _code(lambda: ftt.marginalize(tm, device="cpu")) == want
    assert ftt.marginalize(twide, device="cpu", max_states=8192).n_states == 8192
    with pytest.raises(StagingError):
        ftt.marginalize(torch_switch, device="cpu").log_density_parts({})


def test_engines_run_unchanged_on_the_marginal():
    m = ftt.marginalize(torch_gmm(), device="cpu")
    hmc = ftt.hmc_chain(0, staged=m, n_samples=40, n_warmup=40, n_chains=4,
                        config=ftt.HMCConfig(n_leapfrog=8))
    nuts = ftt.nuts_chain(0, staged=m, n_samples=20, n_warmup=20, n_chains=2)
    mh = ftt.adaptive_mcmc_chain(0, staged=m, n_samples=30, n_warmup=30, n_chains=8)
    vi = ftt.optimize_meanfield_vi(0, staged=m, config=ftt.VIConfig(n_iterations=50,
                                                                    n_samples=8))
    mp = ftt.map_estimate(0, staged=m, config=ftt.MAPConfig(optimizer="lbfgs",
                                                            n_iterations=100))
    for res in (hmc, nuts, mh):
        assert set(res.samples) == {"mu0", "mu1"}
        assert all(torch.isfinite(v).all() for v in res.samples.values())
    assert math.isfinite(vi.final_elbo())
    assert mp.converged
    # the MAP sits at the two clusters (either labelling)
    got = sorted([mp.latents["mu0"].item(), mp.latents["mu1"].item()])
    assert abs(got[0] + 2.0) < 0.3 and abs(got[1] - 2.0) < 0.3
    assert mh.final_state.adapt.log_scale.shape == (8, 2)


def test_infer_discrete_recovers_the_switch_posterior():
    m = ftt.marginalize(torch_switch, device="cpu")
    res = ftt.hmc_chain(4, staged=m, n_samples=300, n_warmup=200, n_chains=8,
                        config=ftt.HMCConfig(n_leapfrog=8))
    zs = m.infer_discrete(11, res.samples)
    z = zs["z"]
    assert z.shape == res.samples["theta"].shape and z.dtype == torch.bool
    grid = np.linspace(-8, 8, 20001)
    j1 = math.log(0.3) + stats.norm.logpdf(1.5, loc=grid + 2.0) + stats.norm.logpdf(grid)
    j0 = math.log(0.7) + stats.norm.logpdf(1.5, loc=grid - 2.0) + stats.norm.logpdf(grid)
    p1 = 1.0 / (1.0 + np.exp(np.logaddexp.reduce(j0) - np.logaddexp.reduce(j1)))
    freq = z.double().mean().item()
    # the draws are near-independent given theta: a 5-SE band with ESS
    # at a quarter of the draws
    assert abs(freq - p1) < 5 * math.sqrt(p1 * (1 - p1) / (z.numel() / 4)), (freq, p1)
