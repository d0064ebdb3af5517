"""Parity of the PyTorch port's NUTS with fugue_tpu, on the CPU.

Single transitions: the test replays the JAX key schedule of
``fugue_tpu.inference.nuts.nuts_transition`` (``k_mom, k_dir0, k_loop =
split(key, 3)``, then per leaf ``kk, k_sel, k_bias, k_dir = split(k, 4)``,
each uniform ``uniform(., (), f64, 1e-38, 1.0)`` and each direction
``bernoulli(., 0.5)``), hands those draws to the port's batched transition,
and compares it with the JAX ``"while"`` build vmapped over chains, to
1e-12 in float64: new position, acceptance statistic, depth, leapfrog
count and divergence flag. Whole chains are compared with the closed-form
posteriors of ``tests/test_nuts.py``'s models, at lengths cut for the CPU.
"""

import functools
import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from fugue_tpu.inference import nuts as jnuts
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference import nuts as tnuts
from fugue_tpu_torch.interop import hmc_state_from_numpy

import torch_parity_models as models

EXACT = dict(rtol=1e-12, atol=1e-12)
SEEDS = range(6)
N_CHAINS = 4


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


# ---------------------------------------------------------------------------
# The JAX key schedule, replayed
# ---------------------------------------------------------------------------


def jax_noise(keys, inv_mass, d, max_depth) -> tnuts.NutsNoise:
    """Every draw jnuts.nuts_transition makes from each chain's key, as the
    port's noise for a batch of chains."""

    def one(key):
        k_mom, k_dir0, k_loop = jax.random.split(key, 3)
        r0 = jnuts.mass_draw_momentum(k_mom, inv_mass, (d,), jnp.float64)
        dir0 = jax.random.bernoulli(k_dir0, 0.5)

        def leaf(k, _):
            kk, k_sel, k_bias, k_dir = jax.random.split(k, 4)
            sel = jnp.log(jax.random.uniform(k_sel, (), jnp.float64, 1e-38, 1.0))
            bias = jnp.log(jax.random.uniform(k_bias, (), jnp.float64, 1e-38, 1.0))
            return kk, (sel, bias, jax.random.bernoulli(k_dir, 0.5))

        _, (sel, bias, right) = jax.lax.scan(leaf, k_loop, None, length=(1 << max_depth) - 1)
        return r0, dir0, sel, bias, right

    r0, dir0, sel, bias, right = jax.vmap(one)(keys)

    def leafwise(a):  # (C, L) -> (L, C)
        return torch.as_tensor(np.array(a)).T.contiguous()

    return tnuts.NutsNoise(r0=torch.as_tensor(np.array(r0)), go_right0=torch.as_tensor(np.array(dir0)),
                           log_u_sel=leafwise(sel), log_u_bias=leafwise(bias), go_right=leafwise(right))


@dataclass(frozen=True)
class Case:
    d: int
    eps: float
    max_depth: int
    max_delta_energy: float = 1000.0
    dense: bool = False


CASES = {
    "standard_normal": Case(d=3, eps=0.4, max_depth=6),
    "eight_schools": Case(d=10, eps=0.25, max_depth=8),
    "dense_mass": Case(d=3, eps=0.5, max_depth=6, dense=True),
    # tests/test_nuts.py:112-121: x ~ N(0, 1e-4) at step size 10
    "tiny_scale_divergent": Case(d=1, eps=10.0, max_depth=8),
    # a low energy cap: divergences part-way through the tree
    "energy_cap_divergent": Case(d=5, eps=1.1, max_depth=6, max_delta_energy=0.3),
    # tests/test_nuts.py:160-177: the potential is NaN for z[0] <= 0
    "nan_cliff": Case(d=2, eps=5.0, max_depth=4),
}

RHO = 0.9
_COV = np.array([[1.0, RHO, 0.5], [RHO, 1.0, 0.3], [0.5, 0.3, 2.0]])
_PREC = np.linalg.inv(_COV)


@functools.lru_cache(maxsize=None)
def _potentials(case):
    if case == "eight_schools":
        js, ts = models.eight_schools_pair()
        return js.potential, ts.potential
    if case == "dense_mass":
        pj, pt = jnp.asarray(_PREC), torch.as_tensor(_PREC)
        return (lambda z: 0.5 * z @ pj @ z), (lambda z: 0.5 * z @ pt @ z)
    if case == "tiny_scale_divergent":
        return (lambda z: 0.5 * jnp.sum((z / 1e-4) ** 2)), (lambda z: 0.5 * torch.sum((z / 1e-4) ** 2))
    if case == "nan_cliff":
        return (lambda z: 0.5 * jnp.sum(z * z) - jnp.log(z[0])), (
            lambda z: 0.5 * torch.sum(z * z) - torch.log(z[0]))
    return (lambda z: 0.5 * jnp.sum(z * z)), (lambda z: 0.5 * torch.sum(z * z))


def _start(case, seed):
    """(q (C, d), inv_mass) for a case."""
    spec = CASES[case]
    rng = np.random.default_rng(100 + seed)
    if case == "nan_cliff":
        return np.tile([0.01, 0.0], (N_CHAINS, 1)), np.ones(2)
    if case == "tiny_scale_divergent":
        return rng.normal(0.0, 1e-4, (N_CHAINS, 1)), np.ones(1)
    if spec.dense:
        # a perturbed covariance: preconditioned, but not perfectly
        a = np.eye(spec.d) + 0.1 * rng.normal(size=(spec.d, spec.d))
        return rng.normal(size=(N_CHAINS, spec.d)), a @ _COV @ a.T
    return rng.normal(0.0, 0.8, (N_CHAINS, spec.d)), np.exp(rng.normal(0.0, 0.3, spec.d))


@functools.lru_cache(maxsize=None)
def _jax_transition(case, record=False):
    spec = CASES[case]
    jpot = _potentials(case)[0]
    return jax.jit(jax.vmap(
        lambda q, k, im: jnuts.nuts_transition(jpot, q, k, spec.eps, im, spec.max_depth,
                                               spec.max_delta_energy, loop="while", record=record),
        in_axes=(0, 0, None)))


@functools.lru_cache(maxsize=None)
def _both(case, seed, record=False):
    spec = CASES[case]
    q, im = _start(case, seed)
    keys = jax.random.split(jax.random.PRNGKey(seed), N_CHAINS)
    jz, jinfo = _jax_transition(case, record)(jnp.asarray(q), keys, jnp.asarray(im))
    noise = jax_noise(keys, jnp.asarray(im), spec.d, spec.max_depth)
    tz, tinfo = tnuts.nuts_transition(_potentials(case)[1], torch.as_tensor(q), noise, spec.eps,
                                      torch.as_tensor(im), spec.max_depth, spec.max_delta_energy,
                                      record=record)
    return (np.asarray(jz), {k: np.asarray(v) for k, v in jinfo.items()}), (tz, tinfo)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_transition_matches_jax(case, seed):
    (jz, jinfo), (tz, tinfo) = _both(case, seed)
    np.testing.assert_allclose(tz.numpy(), jz, **EXACT)
    np.testing.assert_allclose(tinfo["accept_prob"].numpy(), jinfo["accept_prob"], **EXACT)
    np.testing.assert_array_equal(tinfo["depth"].numpy(), jinfo["depth"])
    np.testing.assert_array_equal(tinfo["n_leapfrog"].numpy(), jinfo["n_leapfrog"])
    np.testing.assert_array_equal(tinfo["diverging"].numpy(), jinfo["diverging"])
    ap = tinfo["accept_prob"].numpy()
    assert np.isfinite(ap).all() and (ap >= 0).all() and (ap <= 1).all()
    # the lock-step build runs the batch maximum of leaves, one host read
    # after each leaf that leaves the tree below max_depth
    assert tinfo["leaves"] == int(jinfo["n_leapfrog"].max())
    reached_max = int(jinfo["depth"].max()) == CASES[case].max_depth
    assert tinfo["host_syncs"] == tinfo["leaves"] - int(reached_max)
    if case.endswith("divergent"):
        assert jinfo["diverging"].any()


def test_transition_cases_cover_what_they_name():
    """The divergent cases diverge, the nan cliff stays finite, and the
    batches stop at different leaves (so the lock-step masking counts)."""
    div, spread = {}, {}
    for case in CASES:
        for seed in SEEDS:
            (_, jinfo), _ = _both(case, seed)
            div[case] = div.get(case, 0) + int(jinfo["diverging"].sum())
            spread[case] = max(spread.get(case, 0), int(np.ptp(jinfo["n_leapfrog"])))
    assert div["tiny_scale_divergent"] == N_CHAINS * len(SEEDS)
    assert 0 < div["energy_cap_divergent"] < N_CHAINS * len(SEEDS)
    assert div["nan_cliff"] > 0
    for case in ("standard_normal", "eight_schools", "dense_mass", "energy_cap_divergent"):
        assert spread[case] > 0, case


def test_every_running_chain_is_at_the_same_leaf():
    """The invariant the lock-step build rests on: a chain still running at
    global leaf k is at leaf k of its own tree, so it completes doubling j
    exactly at leaf 2^j - 1. JAX's per-chain leaf-ordered trajectories
    (record=True, written at the chain's own leaf count) equal the port's
    lock-step ones row for row over a batch of chains that stop at different
    leaves; and every chain's (depth, leaf count) is one the invariant
    allows."""
    for seed in range(3):
        (jz, jinfo), (tz, tinfo) = _both("eight_schools", seed, record=True)
        np.testing.assert_allclose(tinfo["trajectory"].numpy(),
                                   np.moveaxis(jinfo["trajectory"], 0, 1), **EXACT)
        np.testing.assert_allclose(tinfo["hamiltonians"].numpy(), jinfo["hamiltonians"].T, **EXACT)
        np.testing.assert_allclose(tinfo["initial_energy"].numpy(), jinfo["initial_energy"], **EXACT)
        for depth, n in zip(jinfo["depth"], jinfo["n_leapfrog"].astype(int)):
            # stopped by a U-turn of the whole tree at a completion, at max
            # depth, or part-way through doubling `depth`
            assert n == 2**depth - 1 or 2**depth <= n <= 2 ** (depth + 1) - 1, (depth, n)


def test_bit_helpers_match_jax():
    ns = np.arange(600, dtype=np.int32)
    want_pc = np.asarray(jnuts._popcount(jnp.asarray(ns)))
    want_t = np.asarray(jnuts._trailing_ones(jnp.asarray(ns)))
    assert [tnuts._popcount(int(n)) for n in ns] == want_pc.tolist()
    assert [tnuts._trailing_ones(int(n)) for n in ns] == want_t.tolist()
    assert tnuts._count_trailing_zeros(0) == int(jnuts._count_trailing_zeros(jnp.uint32(0))) == 32


@pytest.mark.parametrize("dense", [False, True])
def test_uturn_matches_jax(dense):
    rng = np.random.default_rng(7)
    d = 4
    im = np.cov(rng.normal(size=(d, 50))) if dense else rng.uniform(0.5, 2.0, d)
    s, a, b = (rng.normal(size=(64, d)) for _ in range(3))
    want = np.asarray(jax.vmap(lambda *x: jnuts._uturn(*x, jnp.asarray(im)))(s, a, b))
    got = tnuts._uturn(*(torch.as_tensor(x) for x in (s, a, b)), torch.as_tensor(im)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < 64


def test_transition_and_chain_are_bitwise_repeatable():
    staged = ftt.stage(_normal_model(3), device="cpu")
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    im = torch.ones(3, dtype=torch.float64)
    q = torch.zeros((6, 3), dtype=torch.float64)
    n1, n2 = (tnuts.draw_nuts_noise(g, im, 6, 5) for g in (g1, g2))
    assert n1.log_u_sel.shape == (31, 6) and n1.r0.shape == (6, 3)
    assert bool((n1.log_u_sel < 0).all()) and bool(torch.isfinite(n1.log_u_bias).all())
    a = tnuts.nuts_transition(staged.potential, q, n1, 0.5, im, 5)
    b = tnuts.nuts_transition(staged.potential, q, n2, 0.5, im, 5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1]["n_leapfrog"], b[1]["n_leapfrog"])
    r1, r2 = (ftt.nuts_chain(4, staged=staged, n_samples=20, n_warmup=20, n_chains=4,
                             config=ftt.NUTSConfig(max_depth=5)) for _ in range(2))
    assert torch.equal(r1.positions, r2.positions) and r1.n_leapfrogs == r2.n_leapfrogs
    assert r1.step_size == r2.step_size and r1.lockstep_leaves == r2.lockstep_leaves


# ---------------------------------------------------------------------------
# Chains: the moment tests of tests/test_nuts.py in their port form
# ---------------------------------------------------------------------------


def _normal_model(d):
    def model():
        ftt.sample("x", ftt.Normal(0.0, 1.0), sample_shape=(d,))

    return model


def _conjugate_model():
    ys = torch.tensor([1.2, 0.8, 1.5, 0.9, 1.1], dtype=torch.float64)

    def model():
        mu = ftt.sample("mu", ftt.Normal(0.0, 2.0))
        ftt.observe("ys", ftt.Normal(mu, 1.0), ys)
        return mu

    return model


CONJ_TAU = 0.25 + 5.0  # posterior precision of the conjugate model
CONJ_MEAN = 5.5 / CONJ_TAU


def test_standard_normal_posterior():
    def model():
        return ftt.sample("x", ftt.Normal(0.0, 1.0))

    # the lock-step build, for which the ESS bound was set: the async drive's
    # dual averaging settles at a smaller step size on this target (ESS 0.36-
    # 0.45 of the draws against 0.43-0.46 over seeds 0-3)
    res = ftt.nuts_chain(0, model, n_samples=500, n_warmup=300, n_chains=8, device="cpu",
                         config=ftt.NUTSConfig(loop="while"))
    xs = res.samples["x"]
    e = ftt.ess_multichain(xs).item()
    assert abs(xs.mean().item()) < 3.5 / math.sqrt(max(e, 1))
    assert xs.std().item() == pytest.approx(1.0, rel=0.05)
    assert ftt.split_r_hat(xs).item() < 1.01
    assert e > 0.4 * xs.numel()  # NUTS on a Gaussian: near-iid draws
    assert res.tree_depths.shape == (8, 500) and res.tree_depths.dtype == torch.int32
    assert res.accept_prob.shape == (500,) and res.divergences.shape == (8, 500)


def test_conjugate_posterior_and_resume():
    """tests/test_nuts.py's conjugate and resume tests: a run, then a
    resumed run with the warmed kernel (no re-warmup), together match the
    closed-form posterior."""
    staged = ftt.stage(_conjugate_model(), device="cpu")
    first = ftt.nuts_chain(0, staged=staged, n_samples=700, n_warmup=400, n_chains=8)
    second = ftt.nuts_chain(1, staged=staged, n_samples=700, n_warmup=0, n_chains=8,
                            resume=first)
    assert second.step_size == first.step_size
    assert torch.equal(second.inv_mass, first.inv_mass)
    # the resumed chains start where the first run ended
    assert abs(second.positions[:, 0, 0].mean().item()
               - first.final_positions[:, 0].mean().item()) < 0.5
    mus = torch.cat([first.samples["mu"], second.samples["mu"]], dim=1)
    assert mus.mean().item() == pytest.approx(CONJ_MEAN, abs=0.02)
    assert mus.std().item() == pytest.approx(1 / math.sqrt(CONJ_TAU), rel=0.06)
    with pytest.raises(ValueError, match="not both"):
        ftt.nuts_chain(3, staged=staged, n_samples=10, n_warmup=0, n_chains=8, resume=first,
                       init_position=np.zeros(1))
    with pytest.raises(ValueError, match="resume positions"):
        ftt.nuts_chain(3, staged=staged, n_samples=10, n_warmup=0, n_chains=4, resume=first)


def test_resume_from_a_jax_nuts_result():
    """A JAX NUTSResult (final positions, step size, mass) carried over
    through interop samples on in the port with its warmed kernel."""
    ys = jnp.array([1.2, 0.8, 1.5, 0.9, 1.1])

    def jmodel():
        mu = ft.sample("mu", ft.Normal(0.0, 2.0))
        ft.observe("ys", ft.Normal(mu, 1.0), ys)

    jres = jnuts.nuts_chain(jax.random.PRNGKey(0), jmodel, n_samples=5, n_warmup=300,
                            n_chains=8, config=jnuts.NUTSConfig(loop="while"))
    state = hmc_state_from_numpy(np.asarray(jres.final_positions), jres.step_size,
                                 np.asarray(jres.inv_mass), device="cpu", dtype=torch.float64)
    res = ftt.nuts_chain(1, _conjugate_model(), n_samples=600, n_warmup=0, n_chains=8,
                         device="cpu", resume=state)
    assert res.step_size == pytest.approx(jres.step_size, rel=1e-15)
    np.testing.assert_array_equal(res.inv_mass.numpy(), np.asarray(jres.inv_mass))
    mus = res.samples["mu"]
    assert mus.mean().item() == pytest.approx(CONJ_MEAN, abs=0.03)
    assert mus.std().item() == pytest.approx(1 / math.sqrt(CONJ_TAU), rel=0.1)


def test_dense_mass_nuts():
    """tests/test_nuts.py:138-157: dense-mass NUTS on the rho = 0.9
    Gaussian learns the covariance and samples the posterior."""
    def model():
        x = ftt.sample("x", ftt.Normal(0.0, 1.0))
        ftt.sample("y", ftt.Normal(RHO * x, math.sqrt(1 - RHO**2)))

    res = ftt.nuts_chain(7, model, n_samples=250, n_warmup=250, n_chains=8, device="cpu",
                         config=ftt.NUTSConfig(mass="dense"))
    im = res.inv_mass.numpy()
    assert im.shape == (2, 2)
    assert im[0, 1] / np.sqrt(im[0, 0] * im[1, 1]) == pytest.approx(RHO, abs=0.1)
    xs = res.samples["x"]
    assert abs(xs.mean().item()) < 0.1
    assert ftt.split_r_hat(xs).item() < 1.02
    assert np.corrcoef(xs.reshape(-1), res.samples["y"].reshape(-1))[0, 1] == pytest.approx(
        RHO, abs=0.05)


def test_n_leapfrogs_counted_exactly():
    """With max_depth=1 every transition runs exactly one leapfrog; deeper,
    the count sits inside the structural bounds, and the lock-step leaves
    are at least each chain's own count (the lock-step build, loop="while")."""
    staged = ftt.stage(_normal_model(3), device="cpu")
    res = ftt.nuts_chain(0, staged=staged, n_samples=50, n_warmup=30, n_chains=4,
                         config=ftt.NUTSConfig(max_depth=1, loop="while"))
    assert res.n_leapfrogs == 4 * 80 and res.lockstep_leaves == 80 and res.host_syncs == 0
    assert res.warmup_leaves == 30
    res = ftt.nuts_chain(1, staged=staged, n_samples=60, n_warmup=40, n_chains=4,
                         config=ftt.NUTSConfig(max_depth=5, loop="while"))
    total_tr = 4 * 100
    lower = int(torch.sum(2 ** res.tree_depths.double() - 1))
    assert lower <= res.n_leapfrogs <= total_tr * (2**5 - 1)
    assert res.n_leapfrogs > total_tr
    assert res.n_leapfrogs / 4 <= res.lockstep_leaves <= res.n_leapfrogs
    assert res.host_syncs <= res.lockstep_leaves


def test_divergences_on_pathological_step():
    def model():
        return ftt.sample("x", ftt.Normal(0.0, 1e-4))

    res = ftt.nuts_chain(5, model, n_samples=50, n_warmup=0, n_chains=2, device="cpu",
                         config=ftt.NUTSConfig(step_size=10.0, adapt_step_size=False))
    assert res.divergences.float().mean().item() > 0.5
    assert res.step_size == 10.0


def test_warm_start_and_options():
    staged = ftt.stage(_conjugate_model(), device="cpu")
    z0 = torch.tensor([CONJ_MEAN], dtype=torch.float64)
    res = ftt.nuts_chain(2, staged=staged, n_samples=30, n_warmup=30, n_chains=4,
                         init_position=z0, config=ftt.NUTSConfig(adapt_mass=False))
    assert res.samples["mu"].shape == (4, 30)
    assert torch.equal(res.inv_mass, torch.ones(1, dtype=torch.float64))
    fixed = ftt.nuts_chain(2, staged=staged, n_samples=5, n_warmup=4, n_chains=4,
                           config=ftt.NUTSConfig(step_size=0.3, adapt_step_size=False))
    assert fixed.step_size == pytest.approx(0.3)
    prior = ftt.nuts_chain(2, staged=staged, n_samples=5, n_warmup=0, n_chains=3,
                           config=ftt.NUTSConfig(init="prior"))
    assert prior.positions.shape == (3, 5, 1)
    for bad in (dict(loop="chunked"), dict(loop="scan"), dict(mass="full"),
                dict(sampling_loop="chunked")):
        with pytest.raises(ValueError):
            ftt.NUTSConfig(**bad)
    assert ftt.NUTSConfig(loop="while").loop == "while"
    assert ftt.NUTSConfig(loop="async", sampling_loop="lockstep").sampling_loop == "lockstep"


def test_depth_adapts_to_geometry():
    """A wide target needs longer trajectories than a narrow one at the same
    adaptation, so deeper trees."""
    def narrow():
        ftt.sample("x", ftt.Normal(0.0, 1.0))

    def wide():
        ftt.sample("x", ftt.Normal(0.0, 1.0))
        ftt.sample("y", ftt.Normal(0.0, 30.0))

    cfg = ftt.NUTSConfig(adapt_mass=False)
    r_n, r_w = (ftt.nuts_chain(3, m, n_samples=30, n_warmup=60, n_chains=4, device="cpu",
                               config=cfg) for m in (narrow, wide))
    assert r_w.tree_depths.float().mean() > r_n.tree_depths.float().mean()


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------


def test_session_step_recorded_matches_jax():
    """NutsSession.step_recorded from the JAX transition's own draws equals
    jnuts.nuts_transition(record=True) for one chain."""
    def model():
        ftt.sample("x", ftt.Normal(0.0, 1.0), sample_shape=(2,))

    def jmodel():
        ft.sample("x", ft.Normal(0.0, 1.0), sample_shape=(2,))

    sess = ftt.NutsSession(0, model, ftt.NUTSConfig(max_depth=6), device="cpu")
    pot = ft.stage(jmodel).potential
    for seed in range(3):
        q = np.random.default_rng(seed).normal(size=2)
        sess._q = torch.as_tensor(q)
        sess.set_step_size(0.3 + 0.2 * seed)
        key = jax.random.PRNGKey(seed)
        sess._noise = lambda: jax_noise(key[None], jnp.ones(2), 2, 6)
        jz, jinfo = jnuts.nuts_transition(pot, jnp.asarray(q), key, sess.step_size, jnp.ones(2),
                                          6, loop="while", record=True)
        out = sess.step_recorded()
        n = int(jinfo["n_leapfrog"])
        assert out["n_leapfrog"] == n and out["depth"] == int(jinfo["depth"])
        assert out["diverging"] == bool(jinfo["diverging"])
        assert out["accept_prob"] == pytest.approx(float(jinfo["accept_prob"]), abs=1e-12)
        np.testing.assert_allclose(out["position"], np.asarray(jz), **EXACT)
        np.testing.assert_allclose(sess.position.numpy(), np.asarray(jz), **EXACT)
        np.testing.assert_allclose(out["trajectory"], np.asarray(jinfo["trajectory"])[:n], **EXACT)
        np.testing.assert_allclose(out["hamiltonians"], np.asarray(jinfo["hamiltonians"])[:n],
                                   **EXACT)
        assert out["initial_energy"] == pytest.approx(float(jinfo["initial_energy"]), abs=1e-12)


def test_session_steps_and_warmup():
    def model():
        ftt.sample("x", ftt.Normal(0.0, 1.0), sample_shape=(2,))

    sess = ftt.NutsSession(1, model, device="cpu")
    assert sess.position.shape == (2,) and sess.step_size > 0
    out = sess.step()
    assert set(out) == {"accept_prob", "depth", "diverging", "n_leapfrog", "position"}
    assert 0.0 <= out["accept_prob"] <= 1.0 and out["n_leapfrog"] >= 1
    sess.set_step_size(5.0)
    sess.warmup(40)
    assert 0.3 < sess.step_size < 3.0  # adapted back from the bad setting
    with pytest.raises(ValueError):
        ftt.NutsSession(0, lambda: None, device="cpu")
