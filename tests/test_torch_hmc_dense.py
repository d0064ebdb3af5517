"""Parity of the PyTorch port's dense mass, sessions and resume with fugue_tpu.

Deterministic pieces take the same inputs in both packages, with the JAX
package's own draws handed to the port: the dense Welford moments and
covariance (1e-12), the three mass functions from one standard-normal z
(1e-12), leapfrog trajectories and transitions under a dense mass (1e-10,
as tests/test_torch_hmc.py), ``leapfrog_recorded``, the reasonable-epsilon
search along n steps, and ``HmcSession.step_recorded``. Whole chains:
dense-mass HMC on a correlated Gaussian, and ``hmc_chain(resume=)`` from
the port's own result and from a JAX result carried over through interop.
All in float64 on the CPU.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from fugue_tpu.inference import hmc as jhmc
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference import hmc as thmc
from fugue_tpu_torch.interop import hmc_state_from_numpy

import torch_parity_models as models

TRAJ = dict(rtol=1e-10, atol=1e-10)
ADAPT = dict(rtol=1e-12, atol=1e-12)
RHO = 0.9


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


@pytest.fixture(scope="module")
def pair():
    settings.enable_x64(True)
    try:
        return models.eight_schools_pair()
    finally:
        settings.enable_x64(False)


def _cov(d, seed=0):
    """A well-conditioned symmetric positive-definite (d, d) matrix."""
    a = np.random.default_rng(seed).normal(size=(d, d))
    s = a @ a.T / d + 0.5 * np.eye(d)
    return 0.5 * (s + s.T)


def _mass(kind, d, seed=0):
    return _cov(d, seed) if kind == "dense" else np.exp(np.random.default_rng(seed).normal(0, 0.3, d))


def test_welford_dense_matches_jax():
    rng = np.random.default_rng(3)
    jw = jhmc.WelfordState.init(4, True)
    tw = thmc.WelfordState.init(4, True, dtype=torch.float64, device="cpu")
    assert tw.m2.shape == (4, 4)
    for n in (16, 7, 33):
        batch = rng.multivariate_normal(rng.normal(size=4), _cov(4), n)
        jw = jhmc.welford_push_batch(jw, jnp.asarray(batch))
        tw = thmc.welford_push_batch(tw, torch.as_tensor(batch))
        assert tw.count == float(jw.count)
        np.testing.assert_allclose(tw.mean.numpy(), np.asarray(jw.mean), **ADAPT)
        np.testing.assert_allclose(tw.m2.numpy(), np.asarray(jw.m2), **ADAPT)


@pytest.mark.parametrize("regularize", [True, False])
def test_welford_covariance_matches_jax(regularize):
    rng = np.random.default_rng(4)
    jw = jhmc.WelfordState.init(3, True)
    tw = thmc.WelfordState.init(3, True, dtype=torch.float64, device="cpu")
    for n in (5, 64):
        batch = rng.multivariate_normal(np.zeros(3), _cov(3, 1), n)
        jw = jhmc.welford_push_batch(jw, jnp.asarray(batch))
        tw = thmc.welford_push_batch(tw, torch.as_tensor(batch))
        got = thmc.welford_covariance(tw, regularize).numpy()
        np.testing.assert_allclose(got, np.asarray(jhmc.welford_covariance(jw, regularize)), **ADAPT)
        assert np.all(np.linalg.eigvalsh(got) > 0)


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_mass_functions_from_the_same_z(kind):
    """Velocity and kinetic energy on the same momenta, and momenta from the
    same standard-normal z (the z jhmc.mass_draw_momentum draws)."""
    d = 5
    im = _mass(kind, d)
    p = np.random.default_rng(5).normal(size=(6, d))
    jim, tim = jnp.asarray(im), torch.as_tensor(im)
    np.testing.assert_allclose(
        thmc.mass_velocity(tim, torch.as_tensor(p)).numpy(),
        np.asarray(jax.vmap(lambda x: jhmc.mass_velocity(jim, x))(p)), **ADAPT)
    np.testing.assert_allclose(
        thmc.mass_kinetic(tim, torch.as_tensor(p)).numpy(),
        np.asarray(jax.vmap(lambda x: jhmc.mass_kinetic(jim, x))(p)), **ADAPT)
    keys = jax.random.split(jax.random.PRNGKey(6), 6)
    z = jax.vmap(lambda k: jax.random.normal(k, (d,), jnp.float64))(keys)
    want = jax.vmap(lambda k: jhmc.mass_draw_momentum(k, jim, (d,), jnp.float64))(keys)
    got = thmc.momentum_from_normal(tim, torch.as_tensor(np.array(z)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ADAPT)
    # a single (d,) draw, and the draws' covariance is the mass M = inv(Σ)
    np.testing.assert_allclose(thmc.momentum_from_normal(tim, torch.as_tensor(np.array(z[0]))).numpy(),
                               np.asarray(want[0]), **ADAPT)
    draws = thmc.mass_draw_momentum(torch.Generator().manual_seed(0), tim, (40000, d))
    m = np.linalg.inv(im) if kind == "dense" else np.diag(1.0 / im)
    np.testing.assert_allclose(np.cov(draws.numpy().T), m, atol=0.05 * np.abs(m).max())


def test_leapfrog_and_transition_with_dense_mass_match_jax(pair):
    js, ts = pair
    d, n = js.dim, 8
    rng = np.random.default_rng(8)
    q, p = rng.normal(0.0, 0.8, (n, d)), rng.normal(size=(n, d))
    eps = np.linspace(0.05, 0.6, n)
    im = _cov(d, 2)
    jq, jp = jax.vmap(lambda q, p, e: jhmc.leapfrog(jax.grad(js.potential), q, p, e, 6,
                                                    jnp.asarray(im)))(q, p, eps)
    tq, tp, _, _ = thmc.leapfrog(thmc.batched_force(ts.potential),
                                 *(torch.as_tensor(a) for a in (q, p, eps)), 6, torch.as_tensor(im))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TRAJ)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TRAJ)
    keys = jax.random.split(jax.random.PRNGKey(9), n)
    big_eps = np.linspace(0.2, 2.0, n)  # from near-certain accept to rejection
    jq, info = jax.vmap(lambda q, k, e: jhmc.hmc_transition(js.potential, q, k, e, 10,
                                                            jnp.asarray(im)))(q, keys, big_eps)

    def noise(key):
        k_mom, k_acc = jax.random.split(key)
        return (jhmc.mass_draw_momentum(k_mom, jnp.asarray(im), (d,), jnp.float64),
                jnp.log(jax.random.uniform(k_acc, (), jnp.float64, 1e-38, 1.0)))

    p, log_u = (torch.as_tensor(np.array(a)) for a in jax.vmap(noise)(keys))
    tq, tinfo = thmc.hmc_transition(ts.potential, torch.as_tensor(q), p, log_u,
                                    torch.as_tensor(big_eps), 10, torch.as_tensor(im))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TRAJ)
    np.testing.assert_allclose(tinfo.accept_prob.numpy(), np.asarray(info.accept_prob), **TRAJ)
    np.testing.assert_array_equal(tinfo.accepted.numpy(), np.asarray(info.accepted))
    assert 0 < np.asarray(info.accepted).sum() < n


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_leapfrog_recorded_matches_jax(pair, kind):
    js, ts = pair
    d = js.dim
    rng = np.random.default_rng(10)
    q, p = rng.normal(0.0, 0.8, (3, d)), rng.normal(size=(3, d))
    im = _mass(kind, d, 3)
    want = jax.vmap(lambda q, p: jhmc.leapfrog_recorded(
        jax.grad(js.potential), js.potential, q, p, 0.2, 7, jnp.asarray(im)))(q, p)
    got = thmc.leapfrog_recorded(thmc.batched_force(ts.potential), torch.as_tensor(q),
                                 torch.as_tensor(p), 0.2, 7, torch.as_tensor(im))
    for g, w, axes in zip(got, want, ((0,), (0,), (1, 0, 2), (1, 0))):
        w = np.asarray(w) if len(axes) == 1 else np.transpose(np.asarray(w), axes)
        np.testing.assert_allclose(g.numpy(), w, **TRAJ)
    with pytest.raises(ValueError):
        thmc.leapfrog_recorded(thmc.batched_force(ts.potential), torch.as_tensor(q),
                               torch.as_tensor(p), 0.2, 0, torch.as_tensor(im))


@pytest.mark.parametrize("n_steps, kind", [(1, "dense"), (8, "diag"), (8, "dense")])
def test_find_reasonable_epsilon_along_n_steps(pair, n_steps, kind):
    js, ts = pair
    im = _mass(kind, js.dim, 4)
    q = np.random.default_rng(11).normal(0.0, 0.5, js.dim)
    key = jax.random.PRNGKey(12)
    want = float(jhmc.find_reasonable_epsilon(js.potential, jnp.asarray(q), key, jnp.asarray(im),
                                              n_steps=n_steps))
    p = jhmc.mass_draw_momentum(key, jnp.asarray(im), (js.dim,), jnp.float64)
    got = thmc.find_reasonable_epsilon(ts.potential, torch.as_tensor(q), torch.as_tensor(np.array(p)),
                                       torch.as_tensor(im), n_steps=n_steps)
    assert float(got) == pytest.approx(want, rel=1e-12)


def test_session_step_recorded_matches_jax(pair):
    """HmcSession.step_recorded from the JAX session's own draws equals its
    recorded transition."""
    js, ts = pair
    jsess = jhmc.HmcSession(jax.random.PRNGKey(0), staged=js, config=jhmc.HMCConfig(n_leapfrog=6))
    tsess = ftt.HmcSession(0, staged=ts, config=ftt.HMCConfig(n_leapfrog=6))
    for seed, eps in ((0, 0.1), (1, 0.3), (2, 0.9)):
        q = np.random.default_rng(seed).normal(0.0, 0.5, js.dim)
        key = jax.random.PRNGKey(20 + seed)
        out_j = jsess._jit_recorded(jnp.asarray(q), key, eps, jnp.ones(js.dim), 6)
        k_mom, k_acc = jax.random.split(key)
        p = jhmc.mass_draw_momentum(k_mom, jnp.ones(js.dim), (js.dim,), jnp.float64)
        log_u = jnp.log(jax.random.uniform(k_acc, (), jnp.float64, 1e-38, 1.0))
        tsess._q = torch.as_tensor(q)
        tsess.set_step_size(eps)
        tsess._noise = lambda: (torch.as_tensor(np.array(p))[None], torch.as_tensor(np.array(log_u))[None])
        out = tsess.step_recorded()
        q_out, accepted, divergent, ap, qs, hs, h0 = (np.asarray(a) for a in out_j)
        assert out["accepted"] == bool(accepted) and out["divergent"] == bool(divergent)
        assert out["accept_prob"] == pytest.approx(float(ap), abs=1e-10)
        np.testing.assert_allclose(out["trajectory"], qs, **TRAJ)
        np.testing.assert_allclose(out["hamiltonians"], hs, **TRAJ)
        assert out["initial_energy"] == pytest.approx(float(h0), abs=1e-10)
        np.testing.assert_allclose(tsess.position.numpy(), q_out, **TRAJ)


def test_session_controls(pair):
    _, ts = pair
    sess = ftt.HmcSession(3, staged=ts, config=ftt.HMCConfig(n_leapfrog=5))
    assert sess.position.shape == (ts.dim,) and sess.n_leapfrog == 5 and sess.step_size > 0
    info = sess.step()
    assert info.accept_prob.dim() == 0 and info.accepted.dtype == torch.bool
    sess.set_n_leapfrog(3)
    out = sess.step_recorded()
    assert out["trajectory"].shape == (3, ts.dim) and out["hamiltonians"].shape == (3,)
    sess.set_step_size(3.0)
    sess.warmup(30)
    assert 0.01 < sess.step_size < 3.0
    tr = sess.current_trace()
    assert set(tr.latents()) == {"mu", "tau", "theta_raw"}
    cont, _ = ts.constrain(sess.position)
    assert torch.equal(tr.get_real("mu"), cont["mu"])
    np.testing.assert_allclose(float(tr.log_prior + tr.log_likelihood),
                               -float(ts.potential(sess.position)) - float(ts.constrain(sess.position)[1]),
                               rtol=1e-12)
    fixed = ftt.HmcSession(3, staged=ts, config=ftt.HMCConfig(step_size=0.05))
    assert fixed.step_size == 0.05


def _corr_model():
    def model():
        x = ftt.sample("x", ftt.Normal(0.0, 1.0))
        ftt.sample("y", ftt.Normal(RHO * x, math.sqrt(1 - RHO**2)))

    return model


def test_dense_mass_hmc_chain():
    """Dense-mass HMC on the rho = 0.9 Gaussian learns the covariance."""
    res = ftt.hmc_chain(0, _corr_model(), n_samples=200, n_warmup=200, n_chains=16, device="cpu",
                        config=ftt.HMCConfig(mass="dense", n_leapfrog=8))
    im = res.inv_mass.numpy()
    assert im.shape == (2, 2)
    assert im[0, 1] / math.sqrt(im[0, 0] * im[1, 1]) == pytest.approx(RHO, abs=0.05)
    xs, ys = res.samples["x"], res.samples["y"]
    assert abs(xs.mean().item()) < 0.1 and xs.std().item() == pytest.approx(1.0, rel=0.1)
    assert np.corrcoef(xs.reshape(-1), ys.reshape(-1))[0, 1] == pytest.approx(RHO, abs=0.03)
    assert ftt.split_r_hat(xs).item() < 1.02
    with pytest.raises(ValueError):
        ftt.HMCConfig(mass="full")


def test_hmc_chain_resume():
    staged = ftt.stage(_corr_model(), device="cpu")
    cfg = ftt.HMCConfig(mass="dense", n_leapfrog=8)
    first = ftt.hmc_chain(0, staged=staged, n_samples=50, n_warmup=200, n_chains=8, config=cfg)
    second = ftt.hmc_chain(1, staged=staged, n_samples=200, n_warmup=500, n_chains=8, config=cfg,
                           resume=first)
    assert second.step_size == first.step_size
    assert torch.equal(second.inv_mass, first.inv_mass)
    assert second.samples["x"].shape == (8, 200)  # n_warmup is ignored: no warmup
    xs = second.samples["x"]
    assert abs(xs.mean().item()) < 0.15 and xs.std().item() == pytest.approx(1.0, rel=0.15)
    with pytest.raises(ValueError, match="not both"):
        ftt.hmc_chain(2, staged=staged, n_samples=5, n_chains=8, resume=first,
                      init_position=torch.zeros(2))
    with pytest.raises(ValueError, match="resume positions"):
        ftt.hmc_chain(2, staged=staged, n_samples=5, n_chains=4, resume=first)


def test_hmc_chain_resumes_a_jax_dense_result():
    """A dense-mass JAX HMCResult carried over through interop continues in
    the port: its step size and (d, d) mass are used as they are."""
    def jmodel():
        x = ft.sample("x", ft.Normal(0.0, 1.0))
        ft.sample("y", ft.Normal(RHO * x, math.sqrt(1 - RHO**2)))

    jres = jhmc.hmc_chain(jax.random.PRNGKey(1), jmodel, n_samples=5, n_warmup=200, n_chains=8,
                          config=jhmc.HMCConfig(mass="dense", n_leapfrog=8))
    state = hmc_state_from_numpy(np.asarray(jres.final_positions), jres.step_size,
                                 np.asarray(jres.inv_mass), device="cpu", dtype=torch.float64)
    assert state.inv_mass.shape == (2, 2) and torch.equal(state.final_positions, state.positions)
    res = ftt.hmc_chain(2, _corr_model(), n_samples=300, n_chains=8, device="cpu",
                        config=ftt.HMCConfig(n_leapfrog=8), resume=state)
    assert res.step_size == pytest.approx(jres.step_size, rel=1e-15)
    np.testing.assert_array_equal(res.inv_mass.numpy(), np.asarray(jres.inv_mass))
    xs, ys = res.samples["x"], res.samples["y"]
    assert abs(xs.mean().item()) < 0.15
    assert np.corrcoef(xs.reshape(-1), ys.reshape(-1))[0, 1] == pytest.approx(RHO, abs=0.05)


def test_interop_takes_a_dense_mass():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(4, 3))
    st = hmc_state_from_numpy(q, 0.3, _cov(3), device="cpu", dtype=torch.float64)
    assert st.inv_mass.shape == (3, 3) and st.step_size.item() == 0.3
    for bad in (np.ones((3, 2)), np.ones((2, 2)), np.ones((3, 3, 3))):
        with pytest.raises(ValueError):
            hmc_state_from_numpy(q, 0.3, bad, device="cpu")


# Not positive definite: indefinite, and singular (Cholesky's second pivot 0)
BAD_MASS = {"indefinite": [[1.0, 2.0], [2.0, 1.0]], "singular": [[1.0, 1.0], [1.0, 1.0]]}


@pytest.mark.parametrize("which", sorted(BAD_MASS))
def test_non_positive_definite_mass_gives_nan_momenta(which):
    """JAX's Cholesky of a Σ that is not positive definite is NaN, so are its
    momenta; the port reads cholesky_ex's error code on the device."""
    im = np.array(BAD_MASS[which])
    want = jhmc.mass_draw_momentum(jax.random.PRNGKey(0), jnp.asarray(im), (2,), jnp.float64)
    assert np.isnan(np.asarray(want)).all()
    got = thmc.momentum_from_normal(torch.as_tensor(im), torch.tensor([0.3, -0.7], dtype=torch.float64))
    assert torch.isnan(got).all()
    draws = thmc.mass_draw_momentum(torch.Generator().manual_seed(0), torch.as_tensor(im), (5, 2))
    assert draws.shape == (5, 2) and torch.isnan(draws).all()
    # a positive-definite Σ in the same batch of calls is untouched
    assert torch.isfinite(thmc.momentum_from_normal(torch.as_tensor(_cov(2)), torch.ones(4, 2,
                                                    dtype=torch.float64))).all()


@pytest.mark.parametrize("which", sorted(BAD_MASS))
def test_non_positive_definite_mass_rejects_every_transition(which):
    """HMC and NUTS transitions from the NaN momenta are divergent and
    rejected in both packages: the chains stay where they were."""
    from fugue_tpu.inference import nuts as jnuts
    from fugue_tpu_torch.inference import nuts as tnuts

    im = np.array(BAD_MASS[which])
    jim, tim = jnp.asarray(im), torch.as_tensor(im)
    n = 6
    q = np.random.default_rng(13).normal(size=(n, 2))
    keys = jax.random.split(jax.random.PRNGKey(14), n)

    def jpot(z):
        return 0.5 * jnp.sum(z * z)

    def tpot(z):
        return 0.5 * torch.sum(z * z)

    jq, jinfo = jax.vmap(lambda q, k: jhmc.hmc_transition(jpot, q, k, 0.2, 5, jim))(q, keys)
    gen = torch.Generator().manual_seed(15)
    p = thmc.mass_draw_momentum(gen, tim, (n, 2))
    log_u = torch.log(torch.rand(n, generator=gen, dtype=torch.float64))
    tq, tinfo = thmc.hmc_transition(tpot, torch.as_tensor(q), p, log_u, 0.2, 5, tim)
    np.testing.assert_array_equal(np.asarray(jq), q)
    np.testing.assert_array_equal(tq.numpy(), q)
    for name in ("divergent", "accepted", "accept_prob"):
        np.testing.assert_array_equal(getattr(tinfo, name).numpy(), np.asarray(getattr(jinfo, name)))
    assert tinfo.divergent.all() and not tinfo.accepted.any()

    jz, jn = jax.vmap(lambda q, k: jnuts.nuts_transition(jpot, q, k, 0.2, jim, 4, loop="while"))(q, keys)
    noise = tnuts.draw_nuts_noise(gen, tim, n, 4)
    tz, tn = tnuts.nuts_transition(tpot, torch.as_tensor(q), noise, 0.2, tim, 4)
    np.testing.assert_array_equal(np.asarray(jz), q)
    np.testing.assert_array_equal(tz.numpy(), q)
    for name in ("diverging", "accept_prob", "depth", "n_leapfrog"):
        np.testing.assert_array_equal(tn[name].numpy(), np.asarray(jn[name]))
    assert tn["diverging"].all()
