"""Adaptive SMC in the PyTorch port against fugue_tpu, on the CPU.

- Deterministic parts against JAX to 1e-12 (float64, JAX in x64): the
  adaptation update, ``_next_beta`` on random (log_w, ll), the constrained
  flat layout, and one batched ``mh_step`` on the hierarchical model under
  a tempered target, fed the JAX step's own draws (site index, ε, log u).
- The batched prior draw: one model run for all particles.
- The whole engine within Monte-Carlo error: conjugate evidence and moments,
  a peaked likelihood that forces several stages, HMC rejuvenation, the
  zero-rejuvenation shortcut, a split ``resume=`` run bitwise equal to an
  uninterrupted one, and a JAX ladder stopped at ``max_stages=2`` finished
  here through ``smc_state_from_numpy``.
- The count of log-sum-exp and resampling calls per stage, which the card
  run checks as kernel launches.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from fugue_tpu.inference import mcmc_utils as jmu
from fugue_tpu.inference import mh as jmh
from fugue_tpu.inference import smc as jsmc
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference import mcmc_utils as tmu
from fugue_tpu_torch.inference import mh as tmh
from fugue_tpu_torch.inference import smc as tsmc
from fugue_tpu_torch.interop import smc_state_from_numpy
from fugue_tpu_torch.ops import kernels as K

import torch_parity_models as models

TOL = dict(rtol=1e-12, atol=1e-12)
YS = np.array([1.2, 0.8, 1.5, 0.9, 1.1])


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


# ---------------------------------------------------------------------------
# models, written once per package
# ---------------------------------------------------------------------------


def normal_pair():
    """mu ~ N(0, 2), five y ~ N(mu, 1): closed-form evidence and posterior."""
    def jmodel():
        mu = ft.sample("mu", ft.Normal(0.0, 2.0))
        ft.observe("ys", ft.Normal(mu, 1.0), jnp.asarray(YS))

    y = torch.as_tensor(YS)

    def tmodel():
        mu = ftt.sample("mu", ftt.Normal(0.0, 2.0))
        ftt.observe("ys", ftt.Normal(mu, 1.0), y)

    exact = st.multivariate_normal(np.zeros(5), np.eye(5) + 4.0 * np.ones((5, 5))).logpdf(YS)
    return jmodel, tmodel, YS.sum() / 5.25, 1.0 / 5.25, exact


def peaked_pair():
    """mu ~ N(0, 10), y = 3 ~ N(mu, 0.05): a sharp likelihood, many stages."""
    def jmodel():
        mu = ft.sample("mu", ft.Normal(0.0, 10.0))
        ft.observe("y", ft.Normal(mu, 0.05), jnp.array(3.0))

    def tmodel():
        mu = ftt.sample("mu", ftt.Normal(0.0, 10.0))
        ftt.observe("y", ftt.Normal(mu, 0.05), torch.tensor(3.0, dtype=torch.float64))

    exact = st.norm(0.0, math.sqrt(100.0 + 0.05**2)).logpdf(3.0)
    return jmodel, tmodel, exact


def _stage_cpu(model):
    return ftt.stage(model, device="cpu")


# ---------------------------------------------------------------------------
# deterministic parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("batched", [False, True])
def test_adapt_update_matches_jax(frozen, batched):
    rng = np.random.default_rng(1)
    shape = (7, 5) if batched else (5,)
    ls, t = rng.normal(-0.7, 0.3, shape), rng.integers(0, 9, shape).astype(float)
    mask = np.eye(5)[rng.integers(0, 5, shape[:-1])] if batched else np.full(5, 0.2)
    acc = rng.uniform(size=shape[:-1]) if batched else np.float64(0.37)
    want = jmu.adapt_update(jmu.AdaptationState(jnp.asarray(ls), jnp.asarray(t)),
                            jnp.asarray(mask), jnp.asarray(acc), target=0.44, frozen=frozen)
    got = tmu.adapt_update(tmu.AdaptationState(torch.as_tensor(ls), torch.as_tensor(t)),
                           torch.as_tensor(mask), torch.as_tensor(acc), target=0.44,
                           frozen=frozen)
    np.testing.assert_allclose(got.log_scale.numpy(), np.asarray(want.log_scale), **TOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), **TOL)
    init = tmu.AdaptationState.init(4, 0.5, (2,))
    assert init.log_scale.shape == (2, 4) and init.scale()[0, 0].item() == pytest.approx(0.5)


@pytest.mark.parametrize("beta, scale", [(0.0, 1.0), (0.37, 1.0), (0.9, 0.01), (0.2, 30.0)])
def test_next_beta_matches_jax(beta, scale):
    rng = np.random.default_rng(int(beta * 100) + 3)
    n = 500
    log_w = rng.normal(0.0, 0.5, n)
    ll = scale * rng.normal(-2.0, 3.0, n)
    want = float(jsmc._next_beta(jnp.float64(beta), jnp.asarray(log_w), jnp.asarray(ll), 0.5 * n))
    got = tsmc._next_beta(torch.tensor(beta, dtype=torch.float64), torch.as_tensor(log_w),
                          torch.as_tensor(ll), 0.5 * n)
    assert got.dim() == 0 and beta < got.item() <= 1.0
    assert got.item() == pytest.approx(want, rel=1e-12, abs=1e-12)


def _jax_latents(js, n, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    lat = jax.vmap(js.sample_prior)(keys)
    return {a: np.array(v) for a, v in lat.items()}


def test_constrained_layout_matches_jax():
    js, ts = models.hierarchical_pair()
    lat = _jax_latents(js, 4, 0)
    want = np.asarray(jax.vmap(js.flatten_constrained)({a: jnp.asarray(v) for a, v in lat.items()}))
    got = ts.flatten_constrained({a: torch.as_tensor(v) for a, v in lat.items()})
    np.testing.assert_array_equal(got.numpy(), want)
    assert ts.constrained_dim == js.constrained_dim == 20
    assert [s.address for s in ts.continuous_sites] == [s.address for s in js.continuous_sites]
    assert ts.discrete_sites == [] and ts._offsets == js._offsets
    back = ts.unflatten_constrained(got)
    assert all(torch.equal(back[a], torch.as_tensor(lat[a])) for a in lat)
    np.testing.assert_array_equal(
        ts.flatten_constrained({a: torch.as_tensor(v[0]) for a, v in lat.items()}).numpy(), want[0])


def test_mh_step_matches_jax_with_its_draws():
    """16 particles of the hierarchical model under π_0.3, per-site scales
    not all equal: one JAX step (vmapped, shared adaptation state, adapt on)
    against one batched port step given the JAX step's own noise."""
    js, ts = models.hierarchical_pair()
    n, beta, n_sites = 16, 0.3, len(js.sites)
    lat = _jax_latents(js, n, 1)
    rng = np.random.default_rng(2)
    log_scale, t = rng.normal(np.log(0.5), 0.4, n_sites), rng.integers(0, 5, n_sites) * 1.0

    def jtemp(latents):
        p = js.log_density_parts(latents)
        return p.log_prior + beta * (p.log_likelihood + p.log_factors)

    jlat = {a: jnp.asarray(v) for a, v in lat.items()}
    jadapt = jmu.AdaptationState(jnp.asarray(log_scale), jnp.asarray(t))
    states = jmh.MHState(latents=jlat, log_joint=jax.vmap(jtemp)(jlat), adapt=jadapt)
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    new, acc = jax.vmap(
        lambda s, k: jmh.mh_step(js, s, k, True, 0.44, log_density_fn=jtemp),
        in_axes=(jmh.MHState(latents=0, log_joint=0, adapt=None), 0),
    )(states, keys)

    def noise(k):
        k_site, k_acc, k_cont = jax.random.split(k, 3)
        idx = jax.random.randint(k_site, (), 0, n_sites)
        eps = jax.random.normal(k_cont, (js.constrained_dim,), jnp.float64)
        return idx, eps, jnp.log(jax.random.uniform(k_acc, (), jnp.float64, 1e-38, 1.0))

    idx, eps, log_u = (torch.as_tensor(np.array(a)) for a in jax.vmap(noise)(keys))
    tlat = {a: torch.as_tensor(v) for a, v in lat.items()}
    parts = tsmc._density_parts(ts)

    def ttemp(latents):
        lp, ll = parts(latents)
        return lp + beta * ll

    tstate = tmh.MHState(latents=tlat, log_joint=ttemp(tlat),
                         adapt=tmu.AdaptationState(torch.as_tensor(log_scale), torch.as_tensor(t)))
    got, tacc = tmh.mh_step_from_noise(ts, tstate, idx.long(), eps, log_u, True, 0.44,
                                       log_density_fn=ttemp)
    jacc = np.asarray(acc)
    assert 0 < jacc.sum() < n  # both outcomes occur
    np.testing.assert_array_equal(tacc.numpy(), jacc)
    for a in lat:
        np.testing.assert_allclose(got.latents[a].numpy(), np.asarray(new.latents[a]), **TOL)
    np.testing.assert_allclose(got.log_joint.numpy(), np.asarray(new.log_joint), **TOL)
    np.testing.assert_allclose(got.adapt.log_scale.numpy(), np.asarray(new.adapt.log_scale), **TOL)
    np.testing.assert_allclose(got.adapt.t.numpy(), np.asarray(new.adapt.t), **TOL)
    # the generator-driven step makes the same kind of move
    step, _ = tmh.mh_step(ts, tstate, torch.Generator().manual_seed(0), False,
                          log_density_fn=ttemp)
    moved = torch.stack([step.latents[a] != tlat[a] for a in tlat]).sum(0)
    assert bool((moved <= 1).all()) and step.adapt is tstate.adapt


def test_reflect_into_folds_into_the_interval():
    y = torch.tensor([-0.25, 0.5, 1.25, 2.5, -3.75], dtype=torch.float64)
    want = np.asarray(jmh._reflect_into(jnp.asarray(y.numpy()), 0.0, 1.0))
    np.testing.assert_allclose(tmh._reflect_into(y, 0.0, 1.0).numpy(), want, **TOL)


def test_batched_prior_draw_is_one_model_run():
    runs = [0]
    base = models.torch_hierarchical()

    def counted():
        runs[0] += 1
        return base()

    ts = _stage_cpu(counted)
    runs[0] = 0
    lat = ts.sample_prior_batch(11, 8192)
    assert runs[0] == 1
    assert lat["mu"].shape == (8192,) and lat["theta#3"].shape == (8192,)
    mu = lat["mu"].numpy()
    assert abs(mu.mean()) < 4 * 2.0 / math.sqrt(8192) and abs(mu.std() / 2.0 - 1) < 0.05
    assert abs(np.log(lat["tau"].numpy()).std() / 0.5 - 1) < 0.05
    assert torch.equal(ts.sample_prior_batch(11, 8192)["mu"], lat["mu"])
    assert not torch.equal(ts.sample_prior_batch(12, 8192)["mu"], lat["mu"])


# ---------------------------------------------------------------------------
# the engine, within Monte-Carlo error
# ---------------------------------------------------------------------------


def test_normal_normal_evidence_and_moments():
    jmodel, tmodel, post_mean, post_var, exact = normal_pair()
    jres = jsmc.adaptive_smc(jax.random.PRNGKey(3), 2048, jmodel, jsmc.SMCConfig(rejuvenation_steps=3))
    tres = ftt.adaptive_smc(3, 2048, tmodel, ftt.SMCConfig(rejuvenation_steps=3), device="cpu")
    assert isinstance(tres, ftt.SMCResult) and tres.converged and tres.beta == 1.0
    assert tres.particles["mu"].shape == (2048,) and tres.weights.shape == (2048,)
    assert tres.weights.sum().item() == pytest.approx(1.0, rel=1e-12)
    for res in (jres, tres):
        assert float(res.posterior_mean("mu")) == pytest.approx(post_mean, abs=0.03)
        assert float(res.posterior_var("mu")) == pytest.approx(post_var, rel=0.25)
        assert res.log_evidence == pytest.approx(exact, abs=0.1)
    assert 100 < tres.ess <= 2048 and tres.n_stages >= 1


@pytest.mark.parametrize("resampling", ["systematic", "multinomial"])
def test_multistage_tempering_on_peaked_likelihood(resampling):
    _, tmodel, exact = peaked_pair()
    res = ftt.adaptive_smc(4, 1024, tmodel, ftt.SMCConfig(rejuvenation_steps=3,
                                                          resampling=resampling), device="cpu")
    assert res.n_stages > 1 and res.converged
    assert float(res.posterior_mean("mu")) == pytest.approx(3.0, abs=0.02)
    assert res.log_evidence == pytest.approx(exact, abs=0.2)


def test_hmc_rejuvenation():
    _, tmodel, post_mean, _, exact = normal_pair()
    res = ftt.adaptive_smc(7, 1024, tmodel, ftt.SMCConfig(rejuvenation_steps=3, rejuvenation="hmc",
                                                          hmc_leapfrog=8), device="cpu")
    assert float(res.posterior_mean("mu")) == pytest.approx(post_mean, abs=0.03)
    assert res.log_evidence == pytest.approx(exact, abs=0.1)
    # diversity: gradient moves leave many distinct particles
    assert len(np.unique(res.particles["mu"].numpy().round(6))) > 700


def test_importance_reweight_shortcut():
    _, tmodel, post_mean, _, exact = normal_pair()
    ts = _stage_cpu(tmodel)
    res = ftt.importance_reweight(2, 4096, staged=ts)
    assert res.n_stages == 1 and res.converged and res.beta == 1.0
    assert res.log_evidence == pytest.approx(exact, abs=0.1)
    assert float(res.posterior_mean("mu")) == pytest.approx(post_mean, abs=0.05)
    # resuming a shortcut result re-runs the same one-shot reweight
    again = ftt.adaptive_smc(99, 4096, staged=ts,
                             config=ftt.SMCConfig(rejuvenation_steps=0, ess_threshold=0.0),
                             resume=res)
    assert again.log_evidence == res.log_evidence
    assert torch.equal(again.weights, res.weights)


def test_resume_split_run_is_bitwise_identical():
    _, tmodel, _ = peaked_pair()
    ts = _stage_cpu(tmodel)
    cfg = ftt.SMCConfig(rejuvenation_steps=3)
    full = ftt.adaptive_smc(4, 1024, staged=ts, config=cfg)
    assert full.converged and full.n_stages >= 4
    part = ftt.adaptive_smc(4, 1024, staged=ts, config=ftt.SMCConfig(rejuvenation_steps=3,
                                                                     max_stages=2))
    assert not part.converged and part.n_stages == 2 and 0.0 < part.beta < 1.0
    done = ftt.adaptive_smc(999, 1024, staged=ts, config=cfg, resume=part)
    assert done.converged and done.n_stages == full.n_stages
    assert torch.equal(done.particles["mu"], full.particles["mu"])
    assert done.log_evidence == full.log_evidence
    assert torch.equal(done.weights, full.weights)
    # the carry alone resumes as well, and a mismatch is an error
    assert ftt.adaptive_smc(0, 1024, staged=ts, config=cfg, resume=part.state).log_evidence == \
        full.log_evidence
    with pytest.raises(ValueError, match="particles"):
        ftt.adaptive_smc(4, 512, staged=ts, config=cfg, resume=part)
    part.state = None
    with pytest.raises(ValueError, match="state"):
        ftt.adaptive_smc(4, 1024, staged=ts, config=cfg, resume=part)


def test_jax_ladder_finishes_in_the_port():
    """A JAX run stopped at max_stages=2, carried over with
    smc_state_from_numpy, reaches β = 1 here with log Z near the closed
    form."""
    jmodel, tmodel, exact = peaked_pair()
    js, ts = ft.stage(jmodel), _stage_cpu(tmodel)
    part = jsmc.adaptive_smc(jax.random.PRNGKey(5), 2048, staged=js,
                             config=jsmc.SMCConfig(rejuvenation_steps=3, max_stages=2))
    assert not part.converged
    latents, log_w, ll, beta, log_z, adapt, _key, stage_i = part.state
    state = smc_state_from_numpy(
        {a: np.asarray(v) for a, v in latents.items()}, np.asarray(log_w), np.asarray(ll),
        np.asarray(beta), np.asarray(log_z), np.asarray(adapt.log_scale), np.asarray(adapt.t),
        int(stage_i), generator=torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.float64)
    assert state.stage == 2 and state.beta.item() == float(beta)
    res = ftt.adaptive_smc(0, 2048, staged=ts, config=ftt.SMCConfig(rejuvenation_steps=3),
                           resume=state)
    assert res.converged and res.n_stages > 2
    assert res.log_evidence == pytest.approx(exact, abs=0.1)
    assert float(res.posterior_mean("mu")) == pytest.approx(3.0, abs=0.02)
    with pytest.raises(ValueError):
        smc_state_from_numpy({"mu": np.zeros(3)}, np.zeros(4), np.zeros(4), 0.5, 0.0,
                             np.zeros(1), np.zeros(1), 1, generator=torch.Generator(),
                             device="cpu")


def test_reductions_per_stage(monkeypatch):
    """Per stage: 4 log-sum-exps (2 for the full-jump ESS, 1 to normalise, 1
    for the evidence) and, when β < 1, one systematic resample (which takes
    one more, in float64, on the card); 3 more at the end. On the card that
    is 5·stages + 2 logsumexp launches and stages − 1 resample launches."""
    calls = {"lse": 0, "resample": 0}
    real_lse, real_res = K.plogsumexp, K.systematic_resample_from_u0

    def lse(x):
        calls["lse"] += 1
        return real_lse(x)

    def res(lw, u0):
        calls["resample"] += 1
        return real_res(lw, u0)

    monkeypatch.setattr(K, "plogsumexp", lse)
    monkeypatch.setattr(K, "systematic_resample_from_u0", res)
    _, tmodel, _ = peaked_pair()
    out = ftt.adaptive_smc(1, 512, tmodel, ftt.SMCConfig(rejuvenation_steps=1), device="cpu")
    s = out.n_stages
    assert s > 2
    assert calls == {"lse": 4 * s + 3, "resample": s - 1}


def test_config_errors():
    _, tmodel, _ = peaked_pair()
    ts = _stage_cpu(tmodel)
    with pytest.raises(ValueError, match="rejuvenation"):
        ftt.adaptive_smc(0, 64, staged=ts, config=ftt.SMCConfig(rejuvenation="nuts"))
    with pytest.raises(ValueError, match="resampling"):
        ftt.adaptive_smc(0, 64, staged=ts, config=ftt.SMCConfig(resampling="residual"))
