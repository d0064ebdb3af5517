"""The PyTorch port's adaptive MH driver against fugue_tpu, on the CPU.

``init_mh_state`` draws every chain's prior sample and scores it in one
batched model run: its adaptation state (a float scale or a per-site dict)
equals the JAX package's vmapped ``init_mh_state``, and its log joint
equals the JAX ``log_joint`` of the same latents (1e-12, float64). The two
packages' generators draw different numbers, so the draws themselves are
held to the prior in distribution. ``adaptive_mcmc_chain`` keeps the JAX
driver's contracts (exactly 1 + n_warmup + n_samples batched model runs,
scales adapted in warmup and frozen after) and the conjugate posteriors of
``tests/test_mh.py`` within Monte-Carlo error.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from chip_smoke import coin_exact, coin_model, mixed_discrete_exact, mixed_discrete_model
from fugue_tpu.inference import mh as jmh
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference import mh as tmh
from fugue_tpu_torch.interop import mh_state_from_numpy

import torch_parity_models as models

EXACT = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def _counted(model):
    runs = [0]

    def m():
        runs[0] += 1
        return model()

    return m, runs


def _mean_within(x, want, k=5.0):
    """|mean − want| < k Monte-Carlo standard errors (multi-chain ESS) for
    a (chains, samples) tensor."""
    x = x.double()
    e = ftt.ess_multichain(x).item()
    se = x.std().item() / math.sqrt(max(e, 1.0))
    return abs(x.mean().item() - want) < k * se, (x.mean().item(), want, se, e)


@pytest.mark.parametrize("scale", [0.7, {"mu": 2.0, "theta#3": 0.05, "tau": 0.3}],
                         ids=["float", "per_site"])
def test_init_mh_state_matches_jax(scale):
    js, ts = models.hierarchical_pair()
    n = 64
    st = tmh.init_mh_state(ts, 5, n, scale)
    jst = jax.vmap(lambda k: jmh.init_mh_state(js, k, scale))(jax.random.split(
        jax.random.PRNGKey(0), n))
    np.testing.assert_allclose(st.adapt.log_scale.numpy(), np.asarray(jst.adapt.log_scale),
                               **EXACT)
    np.testing.assert_array_equal(st.adapt.t.numpy(), np.asarray(jst.adapt.t))
    assert st.adapt.log_scale.shape == (n, len(ts.sites))
    want = jax.vmap(js.log_joint)({a: jnp.asarray(v.numpy()) for a, v in st.latents.items()})
    np.testing.assert_allclose(st.log_joint.numpy(), np.asarray(want), **EXACT)
    assert st.log_joint.shape == (n,) and st.log_joint.dtype == torch.float64
    # the draws come from the prior: mu ~ N(0, 2)
    mu = st.latents["mu"].numpy()
    assert mu.shape == (n,) and abs(mu.mean()) < 5 * 2.0 / math.sqrt(n)
    assert len(np.unique(mu)) == n


def test_init_mh_state_is_one_model_run():
    model, runs = _counted(models.torch_hierarchical())
    ts = ftt.stage(model, device="cpu")
    runs[0] = 0
    st = tmh.init_mh_state(ts, 1, 4096)
    assert runs[0] == 1
    lp = st.latents["tau"].log().numpy()  # tau ~ LogNormal(0, 0.5)
    assert abs(lp.mean()) < 5 * 0.5 / 64 and abs(lp.std() / 0.5 - 1) < 0.05
    # the same log joint as a separate batched replay
    np.testing.assert_allclose(st.log_joint.numpy(), vmap(ts.log_joint)(st.latents).numpy(),
                               **EXACT)


def small_pair():
    """mu ~ N(0, 2), tau ~ LogNormal(0, 0.5) (the log-space walk), p ~
    Uniform(0, 1) (the reflection walk), y ~ N(mu, tau) and a Bernoulli(p)
    observed."""
    y, heads = np.array([0.3, 1.1, 0.7]), np.array([True, True, False])

    def jmodel():
        mu = ft.sample("mu", ft.Normal(0.0, 2.0))
        tau = ft.sample("tau", ft.LogNormal(0.0, 0.5))
        p = ft.sample("p", ft.Uniform(0.0, 1.0))
        ft.observe("y", ft.Normal(mu, tau), jnp.asarray(y))
        ft.observe("h", ft.Bernoulli(p), jnp.asarray(heads))

    yt, ht = torch.as_tensor(y), torch.as_tensor(heads)

    def tmodel():
        mu = ftt.sample("mu", ftt.Normal(0.0, 2.0))
        tau = ftt.sample("tau", ftt.LogNormal(0.0, 0.5))
        p = ftt.sample("p", ftt.Uniform(0.0, 1.0))
        ftt.observe("y", ftt.Normal(mu, tau), yt)
        ftt.observe("h", ftt.Bernoulli(p), ht)

    return ft.stage(jmodel), ftt.stage(tmodel, device="cpu")


def test_a_jax_mh_state_moves_in_the_port():
    """interop.mh_state_from_numpy carries a JAX MHState batch over; the
    port's step from the JAX step's draws gives the JAX step."""
    js, ts = small_pair()
    n = 16
    jst = jax.vmap(lambda k: jmh.init_mh_state(js, k, 0.5))(jax.random.split(
        jax.random.PRNGKey(1), n))
    st = mh_state_from_numpy({a: np.asarray(v) for a, v in jst.latents.items()},
                             np.asarray(jst.log_joint), np.asarray(jst.adapt.log_scale),
                             np.asarray(jst.adapt.t), device="cpu", dtype=torch.float64)
    keys = jax.random.split(jax.random.PRNGKey(2), n)
    jnew, jacc = jax.vmap(lambda s, k: jmh.mh_step(js, s, k, True))(jst, keys)

    def noise(k):
        k_site, k_acc, k_cont = jax.random.split(k, 3)
        return (jax.random.randint(k_site, (), 0, len(js.sites)),
                jax.random.normal(k_cont, (js.constrained_dim,), jnp.float64),
                jnp.log(jax.random.uniform(k_acc, (), jnp.float64, 1e-38, 1.0)))

    idx, eps, log_u = (torch.as_tensor(np.array(a)) for a in jax.vmap(noise)(keys))
    new, acc = tmh.mh_step_from_noise(ts, st, idx.long(), eps, log_u, True)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_allclose(new.log_joint.numpy(), np.asarray(jnew.log_joint), **EXACT)
    np.testing.assert_allclose(new.adapt.log_scale.numpy(), np.asarray(jnew.adapt.log_scale),
                               **EXACT)
    for a in new.latents:
        np.testing.assert_allclose(new.latents[a].numpy(), np.asarray(jnew.latents[a]), **EXACT)
    with pytest.raises(ValueError):
        mh_state_from_numpy({"mu": np.zeros(3)}, np.zeros(4), np.zeros(2), np.zeros(2),
                            device="cpu")


@pytest.mark.parametrize("n_warmup, n_samples", [(0, 1), (5, 7), (12, 0)])
def test_model_run_count_contract(n_warmup, n_samples):
    """Exactly 1 + n_warmup + n_samples batched model runs (tests/test_mh.py:83):
    the scored prior draw, then one replay per transition, for any number
    of chains."""
    model, runs = _counted(coin_model("cpu"))
    staged = ftt.stage(model, device="cpu")
    runs[0] = 0
    res = ftt.adaptive_mcmc_chain(3, staged=staged, n_samples=n_samples, n_warmup=n_warmup,
                                  n_chains=32)
    assert runs[0] == 1 + n_warmup + n_samples
    assert res.samples["p"].shape == (32, n_samples) and res.log_joint.shape == (32, n_samples)
    assert res.accept_rate.shape == (32,)


def test_adaptation_frozen_after_warmup():
    """The scales after warmup are those of the whole run (tests/test_mh.py:104),
    and warmup moved them."""
    staged = ftt.stage(models.torch_hierarchical(), device="cpu")
    runs = [ftt.adaptive_mcmc_chain(4, staged=staged, n_samples=ns, n_warmup=40, n_chains=16)
            for ns in (1, 60)]
    a, b = (r.final_state.adapt for r in runs)
    assert torch.equal(a.log_scale, b.log_scale) and torch.equal(a.t, b.t)
    assert not torch.allclose(a.log_scale, torch.full_like(a.log_scale, math.log(0.5)))
    assert a.t.sum().item() == 16 * 40  # one site adapted per chain per warmup step
    # per-chain scales: chains adapt apart
    assert a.log_scale.std(dim=0).max().item() > 0


def test_beta_bernoulli_posterior():
    """tests/test_mh.py:19 on BASELINE's coin flip: Beta(2, 2) prior, 18 of 27
    heads, posterior mean 20/31."""
    res = ftt.adaptive_mcmc_chain(0, coin_model("cpu"), n_samples=600, n_warmup=200,
                                  n_chains=16, device="cpu")
    ps = res.samples["p"]
    ok, info = _mean_within(ps, coin_exact()[1])
    assert ok, info
    assert ps.var().item() == pytest.approx(20 * 11 / (31**2 * 32), rel=0.15)
    assert ftt.split_r_hat(ps).item() < 1.05
    assert 0.2 < res.accept_rate.mean().item() < 0.8


def test_normal_normal_posterior():
    """tests/test_mh.py:43: N(0, 2) prior, five observations at sd 1."""
    ys = torch.tensor([1.2, 0.8, 1.5, 0.9, 1.1], dtype=torch.float64)

    def model():
        mu = ftt.sample("mu", ftt.Normal(0.0, 2.0))
        ftt.observe("ys", ftt.Normal(mu, 1.0), ys)

    tau = 0.25 + 5.0
    res = ftt.adaptive_mcmc_chain(1, model, n_samples=1500, n_warmup=300, n_chains=8,
                                  device="cpu")
    mus = res.samples["mu"]
    ok, info = _mean_within(mus, ys.sum().item() / tau)
    assert ok, info
    assert mus.std().item() == pytest.approx(1 / math.sqrt(tau), rel=0.1)


def test_mixed_discrete_model():
    """The mixed model of examples/discrete_models.py (tests/test_mh.py:62's
    shape): a Bernoulli site moved by the flip proposal and a Normal that
    depends on it; P(heads | y) within MC error of the closed form."""
    res = ftt.adaptive_mcmc_chain(2, mixed_discrete_model("cpu", torch.float64), n_samples=1500,
                                  n_warmup=300, n_chains=16, device="cpu")
    heads = res.samples["heads"]
    assert heads.dtype == torch.bool and heads.shape == (16, 1500)
    ok, info = _mean_within(heads, mixed_discrete_exact()[1])
    assert ok, info


def test_continuous_and_discrete_model():
    """k ~ Poisson(3) (a discrete walk), x ~ N(k, 1), y = 4.2 ~ N(x, 0.5):
    E[k | y] by enumeration over k."""
    y = torch.tensor(4.2, dtype=torch.float64)

    def model():
        k = ftt.sample("k", ftt.Poisson(3.0))
        x = ftt.sample("x", ftt.Normal(k.to(torch.float64), 1.0))
        ftt.observe("y", ftt.Normal(x, 0.5), y)

    ks = np.arange(40)
    log_w = (ks * math.log(3.0) - 3.0 - np.array([math.lgamma(k + 1) for k in ks])
             - 0.5 * (4.2 - ks) ** 2 / 1.25)
    w = np.exp(log_w - log_w.max())
    k_mean = float((ks * w).sum() / w.sum())
    res = ftt.adaptive_mcmc_chain(6, model, n_samples=1500, n_warmup=300, n_chains=16,
                                  device="cpu")
    k = res.samples["k"]
    assert not k.dtype.is_floating_point and k.min().item() >= 0
    ok, info = _mean_within(k, k_mean)
    assert ok, info
    # x | k, y ~ N((k + 4 * 4.2) / 5, 0.2): E[x | y] = (E[k | y] + 16.8) / 5
    ok, info = _mean_within(res.samples["x"], (k_mean + 16.8) / 5)
    assert ok, info


def test_seed_reproducibility_and_per_site_scales():
    staged = ftt.stage(models.torch_hierarchical(), device="cpu")
    r1, r2 = (ftt.adaptive_mcmc_chain(9, staged=staged, n_samples=20, n_warmup=10, n_chains=4)
              for _ in range(2))
    for a in r1.samples:
        assert torch.equal(r1.samples[a], r2.samples[a])
    assert torch.equal(r1.log_joint, r2.log_joint)
    r3 = ftt.adaptive_mcmc_chain(10, staged=staged, n_samples=20, n_warmup=10, n_chains=4)
    assert not torch.equal(r3.samples["mu"], r1.samples["mu"])
    # tests/test_mh.py's per-site overrides, frozen with no warmup
    res = ftt.adaptive_mcmc_chain(11, staged=staged, n_samples=5, n_chains=4,
                                  initial_scale={"mu": 5.0, "tau": 0.005})
    sc = res.final_state.adapt.scale().numpy()
    names = [s.address for s in staged.sites]
    np.testing.assert_allclose(sc[:, names.index("mu")], 5.0, rtol=1e-12)
    np.testing.assert_allclose(sc[:, names.index("tau")], 0.005, rtol=1e-12)
    np.testing.assert_allclose(sc[:, names.index("sigma")], 0.5, rtol=1e-12)


def test_log_joint_and_acceptance_are_the_chains():
    """The recorded log joint is the model's at the recorded sample, and
    the acceptance rate counts the moves."""
    staged = ftt.stage(coin_model("cpu"), device="cpu")
    res = ftt.adaptive_mcmc_chain(12, staged=staged, n_samples=50, n_warmup=20, n_chains=8)
    p = res.samples["p"]
    np.testing.assert_allclose(res.log_joint.numpy(),
                               vmap(vmap(staged.log_joint))({"p": p}).numpy(), **EXACT)
    moved = (p[:, 1:] != p[:, :-1]).double().sum(1)
    # the first sample's move is counted too, so the rate is at least the
    # moves seen between samples and at most one more
    rate = res.accept_rate * 50
    assert bool((rate >= moved).all()) and bool((rate <= moved + 1).all())
