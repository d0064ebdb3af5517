"""Parity of the PyTorch port's asynchronous NUTS drive with fugue_tpu, on the CPU.

``make_nuts_drive_async`` is the default drive of both packages. Its pieces
(``_da_fractional_update``, ``welford_push_masked``, the momentum drawn from
a mass factor computed once) take the same numpy inputs in both packages and
agree to 1e-12 in float64. The whole drive replays the JAX key schedule
(``JaxDraws``): per phase ``chain_keys(fold_in(k_run, phase), C)`` and each
chain's first tree ``k_mom, k_dir, k_next = split(key, 3)``; per iteration
``kk, k_sel, k_bias, k_dir = split(key, 4)`` for the active chains, then the
next tree's split for the chains that finished; the rescue's donors from
``fold_in(k_run, 91 | 92)``. It matches positions, acceptance, depths,
divergences, step size, mass and leapfrog count to 1e-9. The first
transition of a phase equals the lock-step ``nuts_transition`` fed the same
draws. Host reads, batched model runs and (on two gloo ranks) all-reduces
are counted against the iterations the drive ran.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fugue_tpu_torch as ftt
from fugue_tpu.core.rng import chain_keys
from fugue_tpu.inference import hmc as jhmc
from fugue_tpu.inference import nuts as jnuts
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference import hmc as thmc
from fugue_tpu_torch.inference import nuts as tnuts

import torch_parity_models as models

EXACT = dict(rtol=1e-12, atol=1e-12)
DRIVE = dict(rtol=1e-9, atol=1e-9)
N_CHAINS = 8


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------


def _da_states(rng):
    """A JAX and a port dual-averaging state with the same numbers, a few
    steps in."""
    eps0, t, h_bar, log_eps_bar = 0.37, 4.0, rng.normal(0.0, 0.1), rng.normal(-1.0, 0.2)
    j = jhmc.DualAveragingState(log_eps=jnp.log(eps0), log_eps_bar=jnp.asarray(log_eps_bar),
                                h_bar=jnp.asarray(h_bar), mu=jnp.log(10.0 * eps0),
                                t=jnp.asarray(t))
    p = thmc.DualAveragingState(log_eps=torch.log(torch.tensor(eps0, dtype=torch.float64)),
                                log_eps_bar=torch.tensor(log_eps_bar, dtype=torch.float64),
                                h_bar=torch.tensor(h_bar, dtype=torch.float64),
                                mu=torch.log(torch.tensor(10.0 * eps0, dtype=torch.float64)),
                                t=t)
    return j, p


FIELDS = ("log_eps", "log_eps_bar", "h_bar", "mu", "t")


@pytest.mark.parametrize("dc", [0.0, 0.25, 1.0])
def test_da_fractional_update_matches_jax(dc):
    j, p = _da_states(np.random.default_rng(int(4 * dc)))
    accept = 0.62
    jn = jnuts._da_fractional_update(j, jnp.asarray(accept), jnp.asarray(dc), 0.8)
    pn = tnuts._da_fractional_update(p, torch.tensor(accept, dtype=torch.float64),
                                     torch.tensor(dc, dtype=torch.float64), 0.8)
    for f in FIELDS:
        np.testing.assert_allclose(float(getattr(pn, f)), float(getattr(jn, f)), **EXACT,
                                   err_msg=f)
    if dc == 0.0:  # no transition finished: the state as it was
        for f in FIELDS:
            assert float(getattr(pn, f)) == float(getattr(p, f)), f
    if dc == 1.0:  # one transition per chain: the plain update
        plain = thmc.dual_averaging_update(p, torch.tensor(accept, dtype=torch.float64), 0.8)
        for f in FIELDS:
            np.testing.assert_allclose(float(getattr(pn, f)), float(getattr(plain, f)),
                                       rtol=1e-15, atol=0.0, err_msg=f)


def _welford_pair(dense, rng, d=3):
    """A JAX and a port Welford state after one full push of the same batch."""
    batch = rng.normal(size=(6, d)) * [1.0, 2.0, 0.5]
    j = jhmc.welford_push_batch(jhmc.WelfordState.init(d, dense), jnp.asarray(batch))
    p = thmc.welford_push_batch(thmc.WelfordState.init(d, dense, dtype=torch.float64,
                                                       device="cpu"), _t(batch))
    return j, p


@pytest.mark.parametrize("dense", [False, True])
def test_welford_push_masked_matches_jax(dense):
    rng = np.random.default_rng(5 + int(dense))
    j, p = _welford_pair(dense, rng)
    batch = rng.normal(size=(8, 3)) + 1.0
    for mask in (np.array([1, 0, 1, 1, 0, 0, 1, 0], bool), np.ones(8, bool)):
        jn = jhmc.welford_push_masked(j, jnp.asarray(batch), jnp.asarray(mask))
        pn = thmc.welford_push_masked(p, _t(batch), _t(mask))
        for f in ("count", "mean", "m2"):
            np.testing.assert_allclose(np.asarray(getattr(pn, f)), np.asarray(getattr(jn, f)),
                                       **EXACT, err_msg=f)
        # the mass the drive takes from it
        var = thmc.welford_covariance(pn) if dense else thmc.welford_variance(pn)
        jvar = jhmc.welford_covariance(jn) if dense else jhmc.welford_variance(jn)
        np.testing.assert_allclose(var.numpy(), np.asarray(jvar), **EXACT)
    # a mask with every row off leaves the state as it was, from empty too
    none = _t(np.zeros(8, bool))
    pn = thmc.welford_push_masked(p, _t(batch), none)
    assert float(pn.count) == p.count
    assert torch.equal(pn.mean, p.mean) and torch.equal(pn.m2, p.m2)
    empty = thmc.WelfordState.init(3, dense, dtype=torch.float64, device="cpu")
    pe = thmc.welford_push_masked(empty, _t(batch), none)
    assert float(pe.count) == 0.0 and not pe.mean.any() and not pe.m2.any()


@pytest.mark.parametrize("dense", [False, True])
def test_momenta_from_a_factor_are_todays_draws(dense):
    """A mass factored once per phase draws exactly the momenta that
    factoring on every call draws, and they follow JAX's."""
    rng = np.random.default_rng(9)
    d = 4
    a = rng.normal(size=(d, d))
    im = a @ a.T + d * np.eye(d) if dense else rng.uniform(0.5, 2.0, d)
    z = rng.normal(size=(5, d))
    factor = thmc.mass_factor(_t(im))
    once = thmc.momentum_from_factor(factor, _t(z))
    assert torch.equal(once, thmc.momentum_from_normal(_t(im), _t(z)))
    want = jax.vmap(lambda zz: (zz / jnp.sqrt(jnp.asarray(im))) if not dense else
                    jax.scipy.linalg.solve_triangular(jnp.linalg.cholesky(jnp.asarray(im)).T,
                                                      zz, lower=False))(jnp.asarray(z))
    np.testing.assert_allclose(once.numpy(), np.asarray(want), **EXACT)
    if dense:  # a Σ that is not positive definite gives NaN momenta, no host read
        bad = thmc.mass_factor(_t(-np.eye(d)))
        assert torch.isnan(thmc.momentum_from_factor(bad, _t(z))).all()


# ---------------------------------------------------------------------------
# The JAX key schedule, replayed
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _key_fns(d):
    def leaf(key):
        kk, k_sel, k_bias, k_dir = jax.random.split(key, 4)
        sel = jnp.log(jax.random.uniform(k_sel, (), jnp.float64, 1e-38, 1.0))
        bias = jnp.log(jax.random.uniform(k_bias, (), jnp.float64, 1e-38, 1.0))
        return kk, sel, bias, jax.random.bernoulli(k_dir, 0.5)

    def fresh(key):
        k_mom, k_dir, k_next = jax.random.split(key, 3)
        return (k_next, jax.random.normal(k_mom, (d,), jnp.float64),
                jax.random.bernoulli(k_dir, 0.5))

    return jax.jit(jax.vmap(leaf)), jax.jit(jax.vmap(fresh))


class JaxDraws:
    """The draws of ``jnuts.make_nuts_drive_async`` for each chain, handed
    out in the port drive's calls: a chain's key moves only when the chain
    draws (``leaf`` for the active chains, ``restart`` for the finished
    ones), as in JAX's ``advance_chain``."""

    def __init__(self, k_run, n_chains, d):
        self.k_run, self.n_chains = k_run, n_chains
        self.leaf_fn, self.fresh_fn = _key_fns(d)
        self.counts = {"leaf": 0, "restart": 0}

    def _fresh(self, mask):
        k_next, z, right = self.fresh_fn(self.keys)
        self.keys = jnp.where(jnp.asarray(mask)[:, None], k_next, self.keys)
        return _t(z), _t(right)

    def start(self, which, q):
        self.keys = chain_keys(jax.random.fold_in(self.k_run, which), self.n_chains)
        return self._fresh(np.ones(self.n_chains, bool))

    def leaf(self, i, active):
        kk, sel, bias, right = self.leaf_fn(self.keys)
        self.keys = jnp.where(jnp.asarray(active.numpy())[:, None], kk, self.keys)
        self.counts["leaf"] += 1
        return _t(sel), _t(bias), _t(right)

    def restart(self, i, completed):
        self.counts["restart"] += 1
        return self._fresh(completed.numpy())

    def donors(self, ema, which):
        k = jax.random.fold_in(self.k_run, 91 + which)
        return _t(jax.random.categorical(k, jnp.log(jnp.asarray(ema.numpy()) + 1e-6),
                                         shape=(self.n_chains,)))


WARMUP, SAMPLES, MAX_DEPTH, EPS0 = 20, 20, 5, 0.3


@functools.lru_cache(maxsize=None)
def _jax_drive(dense):
    js = models.eight_schools_pair()[0]
    cfg = jnuts.NUTSConfig(step_size=EPS0, max_depth=MAX_DEPTH, mass="dense" if dense else "diag")
    return jax.jit(jnuts.make_nuts_drive_async(js, cfg, N_CHAINS, SAMPLES, WARMUP))


@functools.lru_cache(maxsize=None)
def _both_drives(dense):
    ts = models.eight_schools_pair()[1]
    q0 = np.random.default_rng(3).uniform(-2.0, 2.0, (N_CHAINS, ts.dim))
    k_eps, k_run = jax.random.split(jax.random.PRNGKey(17))
    jout = _jax_drive(dense)(jnp.asarray(q0), k_eps, k_run)
    cfg = ftt.NUTSConfig(step_size=EPS0, max_depth=MAX_DEPTH, mass="dense" if dense else "diag")
    runs = [0]

    def counted(z, discrete=None):
        runs[0] += 1  # one call per batched model run (vmap traces it once)
        return ts.potential(z, discrete)

    class Staged:  # the port's staged model with its potential counted
        dim, potential = ts.dim, staticmethod(counted)

    draws = JaxDraws(k_run, N_CHAINS, ts.dim)
    tout = tnuts.make_nuts_drive(Staged, cfg, N_CHAINS, SAMPLES, WARMUP)(_t(q0), draws)
    return [np.asarray(x) for x in jout], tout, runs[0], draws.counts


@pytest.mark.parametrize("dense", [False, True])
def test_drive_matches_jax_on_its_key_schedule(dense):
    jout, tout, runs, draw_calls = _both_drives(dense)
    jq, jqs, japs, jdivs, jdeps, jeps, jim, jleaps = jout
    q, qs, aps, divs, deps, eps, im, leaps, counts = tout
    np.testing.assert_allclose(qs.numpy(), jqs, **DRIVE)
    np.testing.assert_allclose(q.numpy(), jq, **DRIVE)
    np.testing.assert_allclose(aps.numpy(), japs, **DRIVE)
    np.testing.assert_array_equal(deps.numpy(), jdeps)
    np.testing.assert_array_equal(divs.numpy(), jdivs)
    np.testing.assert_allclose(float(eps), float(jeps), **DRIVE)
    np.testing.assert_allclose(im.numpy(), jim, **DRIVE)
    np.testing.assert_array_equal(leaps.numpy(), jleaps)
    assert deps.dtype == torch.int32 and divs.dtype == torch.bool
    # the trees differ in size, so the chains finish at different iterations
    assert np.ptp(jleaps) > 0 and 1 < jdeps.mean() < MAX_DEPTH
    # one batched model run per iteration, one at each phase's start; one
    # host read per chunk of 16 iterations
    assert counts["leaves"] % tnuts.CHUNK == 0 and counts["host_syncs"] == counts["leaves"] // 16
    assert runs == counts["leaves"] + 3 == draw_calls["leaf"] + 3
    assert draw_calls["restart"] == counts["leaves"]
    assert 0 < counts["warmup_leaves"] < counts["leaves"]


def test_first_transition_of_a_phase_is_the_lockstep_transition():
    """With every clock at 0 the chains start their trees together, so the
    async build's first transition of each chain, fed the lock-step
    transition's draws leaf by leaf, is ``nuts_transition``'s."""
    ts = models.eight_schools_pair()[1]
    force = thmc.batched_force(ts.potential)
    rng = np.random.default_rng(21)
    q = _t(rng.normal(0.0, 0.8, (N_CHAINS, ts.dim)))
    im = _t(np.exp(rng.normal(0.0, 0.3, ts.dim)))
    max_depth, eps = 6, 0.25
    noise = tnuts.draw_nuts_noise(torch.Generator().manual_seed(2), im, N_CHAINS, max_depth)
    normals = noise.r0 * torch.sqrt(im)  # the normals of the lock-step momenta
    want, info = tnuts.nuts_transition(ts.potential, q, noise, eps, im, max_depth)

    build = tnuts._AsyncBuild(force, max_depth, 1000.0, torch.float64, "cpu")
    factor = thmc.mass_factor(im)
    g, u = force(q)
    trees = build.start(q, u, g, normals, noise.go_right0, torch.tensor(eps, dtype=torch.float64),
                        factor, im)
    t = torch.zeros(N_CHAINS, dtype=torch.int32)
    got, stats = torch.zeros_like(q), {k: torch.zeros(N_CHAINS, dtype=torch.float64)
                                       for k in ("accept", "depth", "div", "leaves")}
    k = 0
    while bool((t < 1).any()):
        active = t < 1
        leaf = (noise.log_u_sel[k], noise.log_u_bias[k], noise.go_right[k])
        trees, done, accept, depth, div = build.iterate(
            trees, active, leaf, lambda m: (torch.zeros_like(q), m),
            torch.tensor(eps, dtype=torch.float64), factor, im)
        got = torch.where(done[:, None], trees.V[:, tnuts.V_["q"]], got)
        for key, v in (("accept", accept), ("depth", depth), ("div", div),
                       ("leaves", torch.full_like(accept, k + 1.0))):
            stats[key] = torch.where(done, v, stats[key])
        t = t + done
        k += 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), **EXACT)
    np.testing.assert_allclose(stats["accept"].numpy(), info["accept_prob"].numpy(), **EXACT)
    np.testing.assert_array_equal(stats["depth"].numpy(), info["depth"].numpy())
    np.testing.assert_array_equal(stats["div"].numpy() > 0, info["diverging"].numpy())
    np.testing.assert_array_equal(stats["leaves"].numpy(), info["n_leapfrog"].numpy())
    assert k == info["leaves"]  # the last chain finished at the batch maximum
    assert np.ptp(info["n_leapfrog"].numpy()) > 0


# ---------------------------------------------------------------------------
# Whole chains
# ---------------------------------------------------------------------------


def test_ring_and_lockstep_sampling_agree():
    """tests/test_nuts.py's coin: the asynchronous sampling phase and the
    lock-step build after the asynchronous warmup both recover the Beta(14,
    10) posterior mean 14/24."""
    def coin():
        obs = torch.tensor([1.0] * 12 + [0.0] * 7, dtype=torch.float64)
        p = ftt.sample("p", ftt.Beta(2.0, 3.0))
        ftt.observe("obs", ftt.Bernoulli(p), obs)
        return p

    staged = ftt.stage(coin, device="cpu")
    means = {}
    for mode in ("ring", "lockstep"):
        res = ftt.nuts_chain(4, staged=staged, n_samples=600, n_warmup=400, n_chains=16,
                             config=ftt.NUTSConfig(sampling_loop=mode))
        ps = res.samples["p"].numpy()
        assert ps.shape == (16, 600) and np.isfinite(ps).all()
        means[mode] = ps.mean()
    assert means["ring"] == pytest.approx(14 / 24, abs=0.015)
    assert means["lockstep"] == pytest.approx(14 / 24, abs=0.015)
    assert means["ring"] == pytest.approx(means["lockstep"], abs=0.02)


def test_async_fixed_eps_warmup_respects_configured_step_size_f32():
    """tests/test_nuts.py's invariant in float32: with adaptation of the step
    size off, dual averaging still runs but nothing reads it, so the whole
    run is bitwise independent of target_accept."""
    settings.enable_x64(False)

    def model():
        return ftt.sample("x", ftt.Normal(0.0, 1.0), sample_shape=(4,))

    def run(target_accept):
        return ftt.nuts_chain(11, model, n_samples=300, n_warmup=200, n_chains=8, device="cpu",
                              config=ftt.NUTSConfig(step_size=0.5, adapt_step_size=False,
                                                    target_accept=target_accept))

    lo, hi = run(0.3), run(0.95)
    xs = lo.samples["x"].numpy()
    assert xs.dtype == np.float32
    np.testing.assert_array_equal(xs, hi.samples["x"].numpy())
    assert lo.step_size == pytest.approx(0.5, abs=1e-6)
    assert xs.std() == pytest.approx(1.0, rel=0.1)
    assert abs(xs.mean()) < 0.1
    assert lo.divergences.float().mean().item() < 0.02
    im = lo.inv_mass.numpy()
    assert np.all(im > 0.3) and np.all(im < 3.0)


def test_default_is_async_and_counts_its_iterations():
    """NUTSConfig() runs the async drive: every batched model run is an
    iteration, a phase start, the step-size search or the constrain replay;
    host reads are one per 16 iterations; n_leapfrogs counts each chain's
    own leaves, fewer than the iterations times the chains."""
    runs = [0]

    def model():
        runs[0] += 1
        ftt.sample("x", ftt.Normal(0.0, 1.0), sample_shape=(3,))
        ftt.sample("y", ftt.Normal(0.0, 5.0))

    staged = ftt.stage(model, device="cpu")
    assert ftt.NUTSConfig().loop is None and ftt.NUTSConfig(loop="async").loop == "async"
    searched = [0]
    real = thmc.find_reasonable_epsilon

    def search(potential_fn, *args, **kwargs):
        def counted(z, *a):
            searched[0] += 1
            return potential_fn(z, *a)

        return real(counted, *args, **kwargs)

    thmc.find_reasonable_epsilon = search
    try:
        runs[0] = 0
        res = ftt.nuts_chain(2, staged=staged, n_samples=30, n_warmup=30, n_chains=6,
                             config=ftt.NUTSConfig(max_depth=5))
    finally:
        thmc.find_reasonable_epsilon = real
    constrain_runs = 30  # one batched replay of n_chains draws per sample row
    assert searched[0] > 0
    assert runs[0] == res.lockstep_leaves + 3 + searched[0] + constrain_runs
    assert res.lockstep_leaves % 16 == 0 and res.host_syncs == res.lockstep_leaves // 16
    assert 0 < res.warmup_leaves < res.lockstep_leaves
    depths = res.tree_depths.double()
    assert int(torch.sum(2**depths - 1)) <= res.n_leapfrogs - 6 * 30  # warmup's leaves too
    assert res.n_leapfrogs <= 6 * res.lockstep_leaves
    xs = res.samples["x"]
    assert xs.shape == (6, 30, 3) and bool(torch.isfinite(xs).all())
    assert res.divergences.dtype == torch.bool and res.tree_depths.dtype == torch.int32


def test_resume_through_the_async_drive():
    """resume= skips warmup and samples on with the warmed kernel through
    the async sampling phase; the draws of both runs match the posterior."""
    ys = torch.tensor([1.2, 0.8, 1.5, 0.9, 1.1], dtype=torch.float64)

    def model():
        mu = ftt.sample("mu", ftt.Normal(0.0, 2.0))
        ftt.observe("ys", ftt.Normal(mu, 1.0), ys)

    staged = ftt.stage(model, device="cpu")
    first = ftt.nuts_chain(0, staged=staged, n_samples=300, n_warmup=200, n_chains=8)
    second = ftt.nuts_chain(1, staged=staged, n_samples=300, n_warmup=0, n_chains=8,
                            resume=first)
    assert second.step_size == first.step_size and torch.equal(second.inv_mass, first.inv_mass)
    assert second.warmup_leaves == 0 and second.lockstep_leaves > 0
    tau = 0.25 + 5.0
    mus = torch.cat([first.samples["mu"], second.samples["mu"]], dim=1)
    assert mus.mean().item() == pytest.approx(5.5 / tau, abs=0.03)
    assert mus.std().item() == pytest.approx(1 / math.sqrt(tau), rel=0.08)


def test_sharded_async_on_two_gloo_ranks(tmp_path):
    """``sharded_nuts_chain`` (the async drive, dense mass) on two gloo
    ranks: every rank returns the same global result, the posterior's first
    two moments are within 5 MC-SE of JAX's sharded driver's on the same
    model and mesh size, and the collectives are one all-reduce per warmup
    iteration besides the run's fixed ones."""
    import test_torch_parallel_ranks as ranks_file
    from fugue_tpu.parallel.sharded import sharded_nuts_chain

    procs = ranks_file._spawn("nuts_async", tmp_path)
    jn = sharded_nuts_chain(jax.random.PRNGKey(3), staged=ranks_file._jax_normal_staged(),
                            n_samples=200, n_warmup=100, n_chains=16,
                            config=jnuts.NUTSConfig(mass="dense"), mesh=ranks_file._jax_mesh2())
    ranks = ranks_file._join(procs, tmp_path)
    ranks_file._same_on_every_rank(ranks, ("mu", "eps", "mass", "final"))
    r = ranks[0]
    jmu = np.asarray(jn.samples["mu"])
    assert r["mu"].shape == jmu.shape == (16, 200)
    ranks_file._within_5_mcse(r["mu"], jmu, "async sharded NUTS mean")
    ranks_file._within_5_mcse(r["mu"] ** 2, jmu**2, "async sharded NUTS second moment")
    collectives, warm, leaves, syncs, leaps = (int(x) for x in r["counts"])
    per_rank = warm // 2  # every rank runs the same warmup iterations
    assert warm == 2 * per_rank and per_rank % tnuts.CHUNK == 0 and per_rank > 0
    # the chain count once, the ε₀ consensus, the midpoint's Welford merge
    # (two sums) and the result's seven gathers
    assert collectives == per_rank + 1 + 1 + 2 + 7
    assert syncs == leaves // tnuts.CHUNK and leaps > 16 * 300
