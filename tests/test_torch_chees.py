"""Parity of the PyTorch port's ChEES-HMC with fugue_tpu, on the CPU.

The pieces (Halton points, the anisotropy measure, Adam on log T, the ChEES
and SNAPER gradients, the Oja step) take the same numpy inputs in both
packages and agree to 1e-12 in float64; the float32 hardening cases of
``tests/test_chees.py`` agree in float32. ``chees_transition`` is handed
the JAX transition's own draws (``k_mom, k_acc = split(key)``, per chain
``normal(split(k_mom, C)[i], (d,))``, ``log(uniform(k_acc, (C,), 1e-38,
1))``) and matches it to 1e-12. The whole drive replays the JAX key
schedule (``JaxDraws``: the step-size search's normal from ``k_eps``, then
``split(fold_in(k_run, phase), n)`` for the two warmup halves and the
sampling phase) and matches T, ε, the mass, the positions and the leapfrog
count to 1e-10. Whole chains are held to closed forms within Monte-Carlo
error. ``criterion_advice`` on non-finite samples is an intended
divergence from the JAX package (see the test).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from fugue_tpu.inference import chees as jchees
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference import chees as tchees
from fugue_tpu_torch.interop import chees_state_from_numpy

import torch_parity_models as models

EXACT = dict(rtol=1e-12, atol=1e-12)
DRIVE = dict(rtol=1e-10, atol=1e-10)
N_CHAINS = 8


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def _t(a):
    return torch.as_tensor(np.array(a))


def _jmean(x, axis=0):
    return jnp.mean(x, axis=axis)


# ---------------------------------------------------------------------------
# Host helpers, Adam, the gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 256, 1000])
def test_halton_sequence_matches_jax(n):
    got = tchees.halton_sequence(n)
    assert got.dtype == np.float64 and got.shape == (n,)
    np.testing.assert_array_equal(got, jchees.halton_sequence(n))


@pytest.mark.parametrize("scaled", [False, True])
def test_preconditioned_anisotropy_matches_jax(scaled):
    rng = np.random.default_rng(0)
    P = rng.normal(size=(8, 300, 3)) * np.array([2.0, 1.0, 0.5])
    im = np.array([4.0, 1.0, 0.25]) if scaled else np.ones(3)
    want = jchees.preconditioned_anisotropy(P, im)
    for pos, mass in ((P, im), (_t(P), _t(im)), (jnp.asarray(P), jnp.asarray(im))):
        np.testing.assert_allclose(tchees.preconditioned_anisotropy(pos, mass), want, **EXACT)
    lead, med = want
    assert (lead / med < 1.1) if scaled else (abs(lead - 2.0) < 0.15 and abs(med - 1.0) < 0.1)


def test_adam_step_matches_jax_over_several_steps():
    grads = np.random.default_rng(1).normal(0.0, 3.0, 12)
    js, ts = jchees.AdamState.init(), tchees.AdamState.init(torch.float64)
    for g in grads:
        js, jstep = jchees._adam_step(js, jnp.asarray(g), 0.025)
        ts, tstep = tchees._adam_step(ts, torch.tensor(g), 0.025)
        np.testing.assert_allclose(tstep.item(), float(jstep), **EXACT)
        for f in ("m", "v", "t"):
            np.testing.assert_allclose(getattr(ts, f).item(), float(getattr(js, f)), **EXACT)
    assert ts.t.dtype == torch.float64 and ts.t.item() == 12.0


def _grad_inputs(seed, n=16, d=3):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=d)
    return (rng.normal(size=(n, d)), rng.normal(size=(n, d)), rng.normal(size=(n, d)),
            rng.uniform(0.2, 1.0, n), u / np.linalg.norm(u))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("criterion", ["chees", "snaper"])
def test_chees_gradient_matches_jax(criterion, seed):
    Q, Qp, V, ap, u = _grad_inputs(seed)
    proj = u if criterion == "snaper" else None
    want = float(jchees.chees_gradient(*(jnp.asarray(a) for a in (Q, Qp, V, ap)), 0.7, _jmean,
                                       proj=None if proj is None else jnp.asarray(proj)))
    got = tchees.chees_gradient(*(_t(a) for a in (Q, Qp, V, ap)), 0.7,
                                proj=None if proj is None else _t(proj))
    assert got.dtype == torch.float64 and got.dim() == 0
    np.testing.assert_allclose(got.item(), want, **EXACT)


def _f32_gradient_cases():
    """tests/test_chees.py:176-201: a finite proposal whose squared norm
    overflows float32, inf and NaN rows, and an all-rejected batch."""
    n, d = 8, 4
    Q, ap = np.zeros((n, d), np.float32), np.ones(n, np.float32)
    Qp2 = np.ones((n, d), np.float32)
    Qp2[0], Qp2[1] = np.inf, np.nan
    Qp3 = np.random.default_rng(2).normal(size=(n, d)).astype(np.float32)
    Qp3[5] = 1e20
    return {
        "overflow": (Q, np.full((n, d), 1e20, np.float32), np.full((n, d), 1e20, np.float32), ap),
        "inf_nan_rows": (Q, Qp2, np.ones((n, d), np.float32), ap),
        "all_rejected": (Q, Qp2, np.ones((n, d), np.float32), np.zeros(n, np.float32)),
        "one_huge_row": (Q + 0.5, Qp3, np.ones((n, d), np.float32), ap),
    }


@pytest.mark.parametrize("case", sorted(_f32_gradient_cases()))
@pytest.mark.parametrize("criterion", ["chees", "snaper"])
def test_chees_gradient_float32_hardening_matches_jax(case, criterion):
    """Finite for any input, in float32 as on the card, and equal to the
    JAX package's float32 value (1e-6 relative: float32 reductions in two
    orders)."""
    Q, Qp, V, ap = _f32_gradient_cases()[case]
    proj = np.full(Q.shape[1], 0.5, np.float32) if criterion == "snaper" else None
    want = float(jchees.chees_gradient(*(jnp.asarray(a) for a in (Q, Qp, V, ap)),
                                       jnp.float32(0.5), _jmean,
                                       proj=None if proj is None else jnp.asarray(proj)))
    got = tchees.chees_gradient(*(_t(a) for a in (Q, Qp, V, ap)), 0.5,
                                proj=None if proj is None else _t(proj))
    assert got.dtype == torch.float32 and math.isfinite(got.item()) and math.isfinite(want)
    assert abs(got.item()) <= 1e6
    np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=1e-30)
    if case == "all_rejected":
        assert got.item() == want == 0.0


@pytest.mark.parametrize("case", ["clean", "one_inf_row", "all_inf", "scaled_mass"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_oja_update_matches_jax(case, dtype):
    """tests/test_chees.py:441: an inf row must not poison the direction,
    and an all-inf batch keeps the previous one (float64 to 1e-12, float32
    to 1e-6)."""
    rng = np.random.default_rng(0)
    d, npdt = 8, np.dtype(dtype)
    Q = rng.normal(size=(16, d)).astype(npdt)
    if case == "one_inf_row":
        Q[3] = np.inf
    if case == "all_inf":
        Q[:] = np.inf
    u = np.full(d, 1 / np.sqrt(d), npdt)
    z = u if case == "all_inf" else (u + 0.1 * rng.normal(size=d)).astype(npdt)
    im = (rng.uniform(0.5, 2.0, d) if case == "scaled_mass" else np.ones(d)).astype(npdt)
    ju, jz = jchees.oja_update(jnp.asarray(Q), jnp.asarray(u), jnp.asarray(z), jnp.asarray(im),
                               _jmean, 0.9, jnp.dtype(dtype))
    tu, tz = tchees.oja_update(_t(Q), _t(u), _t(z), _t(im), 0.9)
    tol = EXACT if dtype == "float64" else dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **tol)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **tol)
    assert np.isfinite(tu.numpy()).all() and np.isfinite(tz.numpy()).all()
    assert np.linalg.norm(tu.numpy()) == pytest.approx(1.0, abs=1e-5)
    if case == "all_inf":
        np.testing.assert_allclose(tu.numpy(), u, atol=1e-6)


# ---------------------------------------------------------------------------
# One transition, from the JAX transition's own draws
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_draws(key, n_chains, d):
    k_mom, k_acc = jax.random.split(key)
    z = jax.vmap(lambda kk: jax.random.normal(kk, (d,), jnp.float64))(
        jax.random.split(k_mom, n_chains))
    return z, jnp.log(jax.random.uniform(k_acc, (n_chains,), jnp.float64, 1e-38, 1.0))


def jax_transition_draws(key, n_chains, d):
    """The standard normals and accept log-uniforms jchees.chees_transition
    draws from ``key``, as tensors."""
    z, log_u = _jax_draws(key, n_chains, d)
    return _t(z), _t(log_u)


@functools.lru_cache(maxsize=None)
def _pair(name):
    if name == "eight_schools":
        return models.eight_schools_pair()
    if name == "tiny":
        return tiny_pair()
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def _jax_transition(name):
    """jchees.chees_transition on the pair's JAX model, compiled once: the
    caps are traced arguments."""
    pot = _pair(name)[0].potential
    pot_all, grad_all = jax.vmap(pot), jax.vmap(jax.grad(pot))
    return jax.jit(lambda Q, k, eps, T, h, im, max_leapfrog, max_delta_energy:
                   jchees.chees_transition(pot_all, grad_all, Q, k, eps, T, h, im, max_leapfrog,
                                           max_delta_energy, jnp.float64))


TRANSITIONS = {
    # (model, eps, T, h, max_leapfrog, max_delta_energy)
    "one_step": ("eight_schools", 0.3, 0.2, 0.5, 1024, 1000.0),
    "several_steps": ("eight_schools", 0.15, 2.0, 0.8125, 1024, 1000.0),
    "capped_steps": ("eight_schools", 0.05, 3.0, 0.75, 7, 1000.0),
    "divergent": ("eight_schools", 2.5, 30.0, 0.4375, 1024, 2.0),
    "tiny_model": ("tiny", 0.4, 2.5, 0.625, 1024, 1000.0),
}


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("case", sorted(TRANSITIONS))
def test_chees_transition_matches_jax_with_its_draws(case, seed):
    name, eps, T, h, max_leapfrog, max_de = TRANSITIONS[case]
    ts = _pair(name)[1]
    d = ts.dim
    rng = np.random.default_rng(10 + seed)
    Q = rng.normal(0.0, 0.8, (N_CHAINS, d))
    im = np.exp(rng.normal(0.0, 0.4, d))  # a diagonal mass, not unit
    key = jax.random.PRNGKey(seed)
    jout = _jax_transition(name)(jnp.asarray(Q), key, eps, T, h, jnp.asarray(im), max_leapfrog,
                                 max_de)
    z, log_u = jax_transition_draws(key, N_CHAINS, d)
    tout = tchees.chees_transition(ts.potential, _t(Q), z, log_u, torch.tensor(eps, dtype=torch.float64),
                                   torch.tensor(T, dtype=torch.float64), h, _t(im), max_leapfrog,
                                   max_de)
    names = ("Q_out", "Q_prop", "P_end", "accept_prob", "accepted", "divergent")
    for n_, t_, j_ in zip(names, tout[:6], jout[:6]):
        np.testing.assert_allclose(t_.numpy(), np.asarray(j_), err_msg=n_, **EXACT)
    want_L = min(max(math.ceil(h * T / eps), 1), max_leapfrog)
    assert tout[6] == int(jout[6]) == want_L
    assert isinstance(tout[6], int)
    # U at the kept point, with no further model run
    np.testing.assert_allclose(tout[7].numpy(), np.asarray(jax.vmap(_pair(name)[0].potential)(
        jout[0])), **EXACT)
    if case == "several_steps":
        assert want_L > 5
    if case == "divergent":
        assert np.asarray(jout[5]).any()
    # both criteria on the transition's output
    V = _t(im) * tout[2]
    u = np.linspace(1.0, 2.0, d)
    u /= np.linalg.norm(u)
    for proj in (None, u):
        want = jchees.chees_gradient(jnp.asarray(Q), jout[1], jnp.asarray(im) * jout[2], jout[3],
                                     h, _jmean, proj=None if proj is None else jnp.asarray(proj))
        got = tchees.chees_gradient(_t(Q), tout[1], V, tout[3], h,
                                    proj=None if proj is None else _t(proj))
        np.testing.assert_allclose(got.item(), float(want), **EXACT)


def test_non_finite_tau_takes_one_step():
    """The JAX clip: a τ that is not finite runs one step, a huge one
    max_leapfrog."""
    ts = _pair("tiny")[1]
    Q = torch.zeros((2, ts.dim), dtype=torch.float64)
    z, log_u = torch.zeros_like(Q), torch.full((2,), -1.0, dtype=torch.float64)
    im = torch.ones(ts.dim, dtype=torch.float64)
    for T, eps, want in ((math.inf, 0.1, 1), (math.nan, 0.1, 1), (1e30, 0.1, 9),
                         (0.0, 0.1, 1)):
        out = tchees.chees_transition(ts.potential, Q, z, log_u, eps, T, 0.5, im, 9)
        assert out[6] == want, (T, out[6])


# ---------------------------------------------------------------------------
# The whole drive, replaying the JAX key schedule
# ---------------------------------------------------------------------------


def tiny_pair():
    """d = 3: mu ~ N(0, 2), tau ~ LogNormal(0, 0.5), x ~ N(mu, tau), two y
    ~ N(x, 1) observed."""
    ys = np.array([1.2, 0.8])

    def jmodel():
        mu = ft.sample("mu", ft.Normal(0.0, 2.0))
        tau = ft.sample("tau", ft.LogNormal(0.0, 0.5))
        x = ft.sample("x", ft.Normal(mu, tau))
        ft.observe("y", ft.Normal(x, 1.0), jnp.asarray(ys))

    yt = torch.as_tensor(ys)

    def tmodel():
        mu = ftt.sample("mu", ftt.Normal(0.0, 2.0))
        tau = ftt.sample("tau", ftt.LogNormal(0.0, 0.5))
        x = ftt.sample("x", ftt.Normal(mu, tau))
        ftt.observe("y", ftt.Normal(x, 1.0), yt)

    return ft.stage(jmodel), ftt.stage(tmodel, device="cpu")


class JaxDraws:
    """The draws of the JAX drive, in the port drive's order: the step-size
    search's normal from ``k_eps``, then one transition per key of
    ``split(fold_in(k_run, phase), n)`` for the warmup halves (phases 0 and
    1, each skipped when empty) and the sampling phase (2)."""

    def __init__(self, k_eps, k_run, n_warmup, n_samples):
        n_half = n_warmup // 2
        keys = []
        for phase, n in ((0, n_half), (1, n_warmup - n_half), (2, n_samples)):
            if n > 0:
                keys += list(jax.random.split(jax.random.fold_in(k_run, phase), n))
        self.k_eps, self.keys = k_eps, iter(keys)

    def search_normal(self, d, dtype):
        return _t(jax.random.normal(self.k_eps, (d,), jnp.float64))

    def transition(self, n_chains, d, dtype):
        return jax_transition_draws(next(self.keys), n_chains, d)


@functools.lru_cache(maxsize=None)
def _jax_drive(criterion, n_warmup, n_samples):
    js = _pair("tiny")[0]
    cfg = jchees.ChEESConfig(criterion=criterion)
    return jax.jit(jchees.make_chees_drive(js, cfg, N_CHAINS, n_samples, n_warmup))


@pytest.mark.parametrize("n_warmup", [0, 1, 6])
@pytest.mark.parametrize("criterion", ["chees", "snaper"])
def test_drive_matches_jax_on_its_key_schedule(criterion, n_warmup):
    n_samples = 4
    ts = _pair("tiny")[1]
    q0 = np.random.default_rng(3).uniform(-2.0, 2.0, (N_CHAINS, ts.dim))
    k_eps, k_run = jax.random.split(jax.random.PRNGKey(11))
    (jq, jqs, jljs, japs, jdivs, jeps, jT, jmean_L, jim, jleaps) = _jax_drive(
        criterion, n_warmup, n_samples)(jnp.asarray(q0), k_eps, k_run)
    drive = tchees.make_chees_drive(ts, ftt.ChEESConfig(criterion=criterion), N_CHAINS,
                                    n_samples, n_warmup)
    q, qs, ljs, aps, divs, eps, T, mean_L, im, counts = drive(
        _t(q0), JaxDraws(k_eps, k_run, n_warmup, n_samples))
    np.testing.assert_allclose(eps.item(), float(jeps), **DRIVE)
    np.testing.assert_allclose(T.item(), float(jT), **DRIVE)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), **DRIVE)
    np.testing.assert_allclose(qs.numpy(), np.asarray(jqs), **DRIVE)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), **DRIVE)
    np.testing.assert_allclose(ljs.numpy(), np.asarray(jljs), **DRIVE)
    np.testing.assert_allclose(aps.numpy(), np.asarray(japs), **DRIVE)
    np.testing.assert_array_equal(divs.numpy(), np.asarray(jdivs))
    assert counts["leapfrogs"] == int(jleaps)
    assert mean_L == pytest.approx(float(jmean_L), abs=1e-12)
    assert counts["host_syncs"] == n_warmup + n_samples
    # the mass is adapted only with a first half
    assert (n_warmup >= 2) == (not np.allclose(im.numpy(), 1.0))


def test_unknown_criterion_raises_from_the_same_call():
    cfg = ftt.ChEESConfig(criterion="nope")  # the config itself takes any name, as in JAX
    with pytest.raises(ValueError, match="unknown ChEES criterion"):
        ftt.chees_chain(0, staged=_pair("tiny")[1], n_samples=2, n_warmup=2, n_chains=4,
                        config=cfg)
    with pytest.raises(ValueError, match="unknown ChEES criterion"):
        jchees.chees_chain(jax.random.PRNGKey(0), staged=_pair("tiny")[0], n_samples=2,
                           n_warmup=2, n_chains=4, config=jchees.ChEESConfig(criterion="nope"))


# ---------------------------------------------------------------------------
# Chains, sessions, resume, errors
# ---------------------------------------------------------------------------


def _conjugate_model(ys):
    yt = torch.as_tensor(ys)

    def model():
        mu = ftt.sample("mu", ftt.Normal(0.0, 1.0))
        ftt.observe("y", ftt.Normal(mu, 1.0), yt)

    return model


def test_conjugate_normal_posterior():
    """tests/test_chees.py:48 at a CPU length: prior N(0, 1), five
    observations at sd 1, posterior N(Σy/6, 1/6)."""
    ys = np.array([0.8, 1.2, 1.0, 0.6, 1.4])
    res = ftt.chees_chain(0, _conjugate_model(ys), n_samples=500, n_warmup=300, n_chains=32,
                          device="cpu")
    mu = res.samples["mu"]
    assert mu.shape == (32, 500) and res.log_joint.shape == (32, 500)
    e = ftt.ess_multichain(mu).item()
    assert abs(mu.mean().item() - ys.sum() / 6) < 5 * math.sqrt(1 / 6 / e)
    assert mu.var().item() == pytest.approx(1 / 6, rel=0.1)
    assert res.accept_prob.mean().item() > 0.5 and res.divergences.float().mean().item() < 0.01
    assert res.host_syncs == 800 and res.n_leapfrogs >= 32 * 800
    assert res.n_leapfrogs >= int(32 * 500 * res.mean_leapfrog)
    assert res.criterion_advice()["recommendation"] is None
    assert not res.trajectory_cap_reached and res.trajectory_length <= 2 * math.pi
    # the log joint is -U at the kept point
    np.testing.assert_allclose(
        res.log_joint[:, -1].numpy(),
        -torch.func.vmap(_stage_cpu(_conjugate_model(ys)).potential)(res.final_positions).numpy(),
        **EXACT)


def _stage_cpu(model):
    return ftt.stage(model, device="cpu")


def test_seed_reproducibility_and_n_warmup_one():
    staged = _stage_cpu(_conjugate_model(np.array([0.5])))
    r1, r2 = (ftt.chees_chain(7, staged=staged, n_samples=20, n_warmup=20, n_chains=8)
              for _ in range(2))
    assert torch.equal(r1.positions, r2.positions) and r1.n_leapfrogs == r2.n_leapfrogs
    for nw in (0, 1, 2, 3):  # tests/test_chees.py:265
        r = ftt.chees_chain(5, staged=staged, n_samples=6, n_warmup=nw, n_chains=8)
        assert r.samples["mu"].shape == (8, 6) and bool(torch.isfinite(r.log_joint).all())
        assert r.host_syncs == nw + 6


def test_errors():
    def discrete_only():
        ftt.sample("b", ftt.Bernoulli(0.5))

    with pytest.raises(ValueError, match="no continuous"):
        ftt.chees_chain(0, discrete_only, n_samples=2, n_warmup=2, device="cpu")
    with pytest.raises(ValueError, match="no continuous"):
        ftt.CheesSession(0, discrete_only, device="cpu")
    staged = _stage_cpu(_conjugate_model(np.array([0.5])))
    first = ftt.chees_chain(0, staged=staged, n_samples=2, n_warmup=4, n_chains=8)
    with pytest.raises(ValueError, match="not both"):
        ftt.chees_chain(1, staged=staged, n_samples=2, n_warmup=0, n_chains=8, resume=first,
                        init_position=np.zeros(1))
    with pytest.raises(ValueError, match="resume positions"):
        ftt.chees_chain(1, staged=staged, n_samples=2, n_warmup=0, n_chains=4, resume=first)
    with pytest.raises(ValueError, match="init_position"):
        ftt.chees_chain(1, staged=staged, n_samples=2, n_warmup=2, n_chains=8,
                        init_position=np.zeros((3, 1)))


def test_resume_from_a_jax_chees_result():
    """A JAX ChEESResult resumes in the port as it is (its arrays through
    np.asarray) and through interop.chees_state_from_numpy: the same warmed
    kernel, and together the conjugate posterior."""
    ys = np.array([1.2, 0.8, 1.5, 0.9, 1.1])

    def jmodel():
        mu = ft.sample("mu", ft.Normal(0.0, 2.0))
        ft.observe("ys", ft.Normal(mu, 1.0), jnp.asarray(ys))

    yt = torch.as_tensor(ys)

    def tmodel():
        mu = ftt.sample("mu", ftt.Normal(0.0, 2.0))
        ftt.observe("ys", ftt.Normal(mu, 1.0), yt)

    jres = jchees.chees_chain(jax.random.PRNGKey(0), jmodel, n_samples=4, n_warmup=200,
                              n_chains=16)
    staged = _stage_cpu(tmodel)
    state = chees_state_from_numpy(np.asarray(jres.final_positions), jres.step_size,
                                   jres.trajectory_length, np.asarray(jres.inv_mass),
                                   device="cpu", dtype=torch.float64)
    tau = 0.25 + 5.0
    for resume in (jres, state):
        res = ftt.chees_chain(1, staged=staged, n_samples=300, n_warmup=0, n_chains=16,
                              resume=resume)
        assert res.step_size == pytest.approx(jres.step_size, rel=1e-15)
        assert res.trajectory_length == pytest.approx(jres.trajectory_length, rel=1e-14)
        np.testing.assert_array_equal(res.inv_mass.numpy(), np.asarray(jres.inv_mass))
        assert not res.trajectory_cap_reached
        mus = res.samples["mu"]
        e = ftt.ess_multichain(mus).item()
        assert abs(mus.mean().item() - ys.sum() / tau) < 5 * math.sqrt(1 / tau / e)
        assert mus.std().item() == pytest.approx(1 / math.sqrt(tau), rel=0.12)
    with pytest.raises(ValueError):
        chees_state_from_numpy(np.zeros((4, 2)), 0.1, 1.0, np.eye(2), device="cpu")


def test_session_step_matches_jax_transition():
    """CheesSession.step from the JAX transition's own draws equals
    jchees.chees_transition at the session's frozen kernel, with the
    session's Halton jitter (h_1 = 1/2, h_2 = 1/4, ...)."""
    ts = _pair("tiny")[1]
    sess = ftt.CheesSession(3, staged=ts, n_chains=N_CHAINS, n_warmup=20)
    assert sess.positions.shape == (N_CHAINS, 3) and sess.step_size > 0
    for i, h in enumerate((0.5, 0.25, 0.75)):
        key = jax.random.PRNGKey(40 + i)
        sess._draws = JaxDraws(None, None, 0, 0)
        sess._draws.keys = iter([key])
        Q = jnp.asarray(sess.positions.numpy())
        jout = _jax_transition("tiny")(Q, key, sess.step_size, sess.trajectory_length, h,
                                       jnp.asarray(sess.inv_mass.numpy()), 1024, 1000.0)
        out = sess.step()
        assert set(out) == {"positions", "accept_mean", "divergences", "n_leapfrog"}
        np.testing.assert_allclose(out["positions"], np.asarray(jout[0]), **EXACT)
        assert out["n_leapfrog"] == int(jout[6])
        assert out["accept_mean"] == pytest.approx(float(np.mean(jout[3])), abs=1e-12)
        assert out["divergences"] == int(np.sum(jout[5]))


def test_criterion_advice_is_nan_safe_an_intended_divergence():
    """INTENDED DIVERGENCE from the JAX package (ADVICE.md:4): there,
    non-finite positions either raise from eigvalsh or read as the healthy
    verdict, and a non-finite mass reads as healthy. The port returns no
    recommendation and an "undetermined: non-finite samples" reason; finite
    runs get the JAX package's verdict and numbers."""
    rng = np.random.default_rng(0)
    P = rng.normal(size=(4, 50, 3)) * np.array([3.0, 1.0, 1.0])

    def both(pos, im):
        kw = dict(samples={}, log_joint=None, accept_prob=None, divergences=None,
                  step_size=0.1, trajectory_length=1.0, trajectory_cap_reached=False,
                  mean_leapfrog=1.0, n_leapfrogs=1, final_positions=None)
        return (jchees.ChEESResult(positions=pos, inv_mass=im, **kw),
                tchees.ChEESResult(positions=_t(pos), inv_mass=_t(im), **kw))

    jr, tr = both(P, np.ones(3))
    want, got = jr.criterion_advice(), tr.criterion_advice()
    assert got["recommendation"] == want["recommendation"] == "snaper"
    for k in ("leading_sd", "median_sd", "ratio"):
        assert got[k] == pytest.approx(want[k], rel=1e-12)
    for where in ("nan_sample", "inf_sample", "inf_mass"):
        pos, im = P.copy(), np.ones(3)
        if where == "nan_sample":
            pos[1, 7, 2] = np.nan
        elif where == "inf_sample":
            pos[0, 0, 0] = np.inf
        else:
            im[1] = np.inf
        jr, tr = both(pos, im)
        got = tr.criterion_advice()
        assert got["recommendation"] is None and got["reason"].startswith("undetermined")
        assert math.isnan(got["ratio"])
        try:
            with np.errstate(invalid="ignore", over="ignore"):
                jadv = jr.criterion_advice()
        except np.linalg.LinAlgError:
            continue  # the JAX package raises here
        assert not jadv["reason"].startswith("undetermined")  # a verdict all the same
