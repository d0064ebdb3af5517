"""The port's multi-device layer (``fugue_tpu_torch/parallel``) on gloo ranks
in spawned processes, on the CPU, against the JAX package's collectives and
sharded drivers on 2 of the suite's 8 virtual CPU devices.

The file is also the child script. ``python tests/test_torch_parallel_ranks.py
SCENARIO RANK WORLD PORT OUT`` joins a gloo process group over localhost,
runs the scenario on its rank and writes the rank's results to
``OUT/rankR.npz``. A test starts the ranks, computes the JAX references
while they run, and then compares: every rank returns the same global
result; collectives match JAX's ``shard_map`` to 1e-12 in float64; MH on
two ranks is bitwise MH on one; VI's data mode follows unsharded VI to
1e-6; SMC's log-evidence is within its Monte-Carlo error of the one-rank
run, of JAX's ``sharded_smc`` and of the exact value; and each engine's
posterior mean is within 5 MC-SE of JAX's sharded driver's. The children
import torch and numpy only, and run one torch and OpenMP thread each (the
suite runs under 6 workers on 8 cores).
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The conjugate normal model: mu ~ N(0, 2^2), 64 rows y_i ~ N(mu, 1).
Y = np.random.default_rng(7).normal(1.8, 1.0, 64)
PRIOR_SD = 2.0
POST_PREC = 1.0 / PRIOR_SD**2 + len(Y)
POST_MEAN, POST_SD = Y.sum() / POST_PREC, POST_PREC**-0.5
# The plate rule's dangerous case: a (2,) prior-mean argument that divides
# by the rank count beside a (64, 2) plate.
PRIOR_W = np.full((2,), 0.5)
YS_W = np.random.default_rng(11).normal(0.5, 1.0, (64, 2))
# Collectives: Welford batches (3 pushes of 8 chains in 3-d), ε₀ per rank,
# and a particle tree of 24 over 3 ranks with random global ancestors.
WELFORD_X = np.random.default_rng(3).normal(size=(3, 8, 3)) * [1.0, 3.0, 0.2] + [0.5, -1.0, 2.0]
EPS0 = np.array([0.3, 0.7])
RING_N = 24
_ring_rng = np.random.default_rng(1)
RING_TREE = {"a": _ring_rng.normal(size=RING_N), "b": _ring_rng.normal(size=(RING_N, 3)),
             "c": _ring_rng.integers(0, 100, RING_N), "d": _ring_rng.random(RING_N) < 0.5}
RING_ANC = _ring_rng.integers(0, RING_N, RING_N)
CKPT_Q = np.arange(12.0).reshape(6, 2)
FLIPS = np.array([1, 1, 1, 0, 1, 0, 1, 1, 0, 1], dtype=bool)
SWITCH_Y = 0.8


# ---------------------------------------------------------------------------
# the children (torch only)
# ---------------------------------------------------------------------------


def _torch_normal_staged(ftt, torch):
    """The conjugate normal model staged on the CPU with its rows as the
    argument (VI's data mode splits the arguments)."""
    def normal_model(ys):
        mu = ftt.sample("mu", ftt.Normal(0.0, PRIOR_SD))
        ftt.observe("ys", ftt.Normal(mu, 1.0), ys)
        return mu

    return ftt.stage(normal_model, torch.as_tensor(Y), device="cpu")


def _children_collectives(rank, world, out):
    import torch
    import torch.distributed as dist

    from fugue_tpu_torch.inference.hmc import (WelfordState, eps_consensus,
                                               welford_merge_across, welford_push_batch)
    from fugue_tpu_torch.inference.smc import _ring_gather
    from fugue_tpu_torch.parallel.mesh import (COUNTS, ShardLayout, all_gather_tiled,
                                               chain_sharded, cross_min, make_chain_mesh)
    from fugue_tpu_torch.runtime.checkpoint import (load_checkpoint_sharded,
                                                    save_checkpoint_sharded)

    res = {}
    pair = dist.new_group([0, 1])  # every rank makes it; ranks 0 and 1 use it
    if rank < 2:
        for dense in (False, True):
            st = WelfordState.init(3, dense, dtype=torch.float64, device="cpu")
            for t in range(WELFORD_X.shape[0]):
                st = welford_push_batch(st, torch.as_tensor(WELFORD_X[t, 4 * rank:4 * rank + 4]))
            m = welford_merge_across(st, pair)
            res[f"welford{int(dense)}"] = np.concatenate(
                [m.mean.numpy().ravel(), m.m2.numpy().ravel(), [m.count]])
        res["eps"] = eps_consensus(torch.tensor(EPS0[rank], dtype=torch.float64), pair).numpy()
    mesh = make_chain_mesh(device="cpu")
    shard = ShardLayout.of(mesh)
    n_local = shard.split(RING_N, "particles")
    rows = shard.rows(n_local)
    local = {a: torch.as_tensor(v[rows]) for a, v in RING_TREE.items()}
    got = _ring_gather(local, torch.as_tensor(RING_ANC[rows]), shard)
    res.update({f"ring_{a}": v.numpy() for a, v in got.items()})
    res["min"] = cross_min(torch.tensor([rank + 1.0]), shard.group).numpy()
    res["gathered"] = all_gather_tiled(torch.tensor([[rank, 10 + rank]]), shard.group, 1).numpy()
    res["host_staged"] = np.array(COUNTS["host_staged"])  # CPU tensors: never staged
    # a (hosts, chains) mesh with the batch split over both axes: the group
    # over several axes, and the row-major flat index
    from fugue_tpu_torch.parallel import make_hybrid_mesh
    from fugue_tpu_torch.parallel.mesh import cross_sum

    hybrid = ShardLayout.of(make_hybrid_mesh({"chains": -1}, {"hosts": 1}, device="cpu"),
                            ("hosts", "chains"))
    res["hybrid"] = np.array([hybrid.size, hybrid.index, hybrid.seed_index,
                              cross_sum(torch.tensor(rank + 1.0), hybrid.group).item()])
    state = {"q": chain_sharded(torch.as_tensor(CKPT_Q), mesh),
             "eps": torch.tensor(0.25, dtype=torch.float64),
             "gen": torch.Generator().manual_seed(5), "n": 7}
    path = os.path.join(out, "ckpt")
    save_checkpoint_sharded(path, state)
    template = {"q": chain_sharded(torch.zeros(CKPT_Q.shape, dtype=torch.float64), mesh),
                "eps": torch.tensor(0.0, dtype=torch.float64), "gen": torch.Generator(),
                "n": 0}
    back = load_checkpoint_sharded(path, template)
    res["ckpt_q"] = back["q"].to_local().numpy()
    res["ckpt_rest"] = np.array([back["eps"].item(), back["n"],
                                 torch.equal(back["gen"].get_state(), state["gen"].get_state())])
    return res


def _children_hmc_nuts(rank, world, out):
    import torch

    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.parallel import make_chain_mesh, sharded_hmc_chain, sharded_nuts_chain

    staged = _torch_normal_staged(ftt, torch)
    mesh = make_chain_mesh(device="cpu")
    res = {}
    h = sharded_hmc_chain(0, staged=staged, n_samples=200, n_warmup=200, n_chains=32,
                          config=ftt.HMCConfig(n_leapfrog=8), mesh=mesh)
    n = sharded_nuts_chain(0, staged=staged, n_samples=150, n_warmup=100, n_chains=16,
                           mesh=mesh)
    for name, r in (("hmc", h), ("nuts", n)):
        res[f"{name}_mu"] = r.samples["mu"].numpy()
        res[f"{name}_eps"] = np.array(r.step_size)
        res[f"{name}_mass"] = r.inv_mass.numpy()
        res[f"{name}_final"] = r.final_positions.numpy()
    res["nuts_leaps"] = np.array(n.n_leapfrogs)
    return res


def _children_nuts_async(rank, world, out):
    """The async drive on two ranks, dense mass: its collectives counted."""
    import torch

    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.parallel import make_chain_mesh, sharded_nuts_chain
    from fugue_tpu_torch.parallel.mesh import COUNTS

    staged = _torch_normal_staged(ftt, torch)
    mesh = make_chain_mesh(device="cpu")
    COUNTS["collectives"] = 0
    r = sharded_nuts_chain(3, staged=staged, n_samples=200, n_warmup=100, n_chains=16,
                           config=ftt.NUTSConfig(mass="dense"), mesh=mesh)
    return {"mu": r.samples["mu"].numpy(), "eps": np.array(r.step_size),
            "mass": r.inv_mass.numpy(), "final": r.final_positions.numpy(),
            "counts": np.array([COUNTS["collectives"], r.warmup_leaves, r.lockstep_leaves,
                                r.host_syncs, r.n_leapfrogs])}


def _switch_model(ftt, torch):
    def switch():
        z = ftt.sample("z", ftt.Bernoulli(0.7))
        th = ftt.sample("theta", ftt.Normal(0.0, 1.0))
        shift = torch.where(z, torch.tensor(1.0, dtype=torch.float64),
                            torch.tensor(-1.0, dtype=torch.float64))
        ftt.observe("y", ftt.Normal(th + shift, 1.0), torch.tensor(SWITCH_Y, dtype=torch.float64))

    return switch


def _mixed_discrete_model(ftt, torch):
    """A count (walk proposal) and a categorical (redraw) beside a
    continuous site: every kind of MH noise."""
    def mixed():
        k = ftt.sample("k", ftt.Poisson(3.0))
        c = ftt.sample("c", ftt.Categorical(torch.tensor([0.2, 0.3, 0.5], dtype=torch.float64)))
        mu = ftt.sample("mu", ftt.Normal(0.0, 1.0))
        loc = mu + 0.1 * k.to(torch.float64) + c.to(torch.float64)
        ftt.observe("y", ftt.Normal(loc, 1.0), torch.tensor(2.5, dtype=torch.float64))

    return mixed


def _children_smc_mh_vi(rank, world, out):
    import torch

    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.parallel import (make_chain_mesh, sharded_chees_chain, sharded_smc,
                                          sharded_vi)

    staged = _torch_normal_staged(ftt, torch)
    mesh = make_chain_mesh(device="cpu")
    res = {}
    smc2 = sharded_smc(3, 2048, staged=staged, mesh=mesh)
    smc1 = ftt.adaptive_smc(3, 2048, staged=staged, device="cpu")
    res["smc_logz"] = np.array([smc2.log_evidence, smc1.log_evidence])
    res["smc_mean"] = np.array([smc2.posterior_mean("mu").item(), smc1.posterior_mean("mu").item()])
    res["smc_particles"] = smc2.particles["mu"].numpy()
    part = sharded_smc(3, 2048, staged=staged, mesh=mesh,
                       config=ftt.SMCConfig(max_stages=1))
    done = sharded_smc(0, 2048, staged=staged, mesh=mesh, resume=part)
    res["smc_resume_equal"] = np.array(
        torch.equal(done.particles["mu"], smc2.particles["mu"])
        and done.log_evidence == smc2.log_evidence and not part.converged)

    mixed = ftt.stage(_mixed_discrete_model(ftt, torch), device="cpu")
    mh2 = ftt.adaptive_mcmc_chain(11, staged=mixed, n_samples=60, n_warmup=40, n_chains=8,
                                  mesh=mesh)
    mh1 = ftt.adaptive_mcmc_chain(11, staged=mixed, n_samples=60, n_warmup=40, n_chains=8)
    res["mh_equal"] = np.array(
        all(torch.equal(mh2.samples[a], mh1.samples[a]) for a in mh1.samples)
        and torch.equal(mh2.log_joint, mh1.log_joint)
        and torch.equal(mh2.final_state.adapt.log_scale, mh1.final_state.adapt.log_scale))
    res["mh_k"] = mh2.samples["k"].numpy()

    cfg = ftt.VIConfig(n_iterations=200, n_samples=8, learning_rate=0.05)
    vi2 = sharded_vi(0, staged=staged, config=cfg, mesh=mesh, shard="data")
    vi1 = ftt.optimize_meanfield_vi(0, staged=staged, config=cfg, device="cpu")
    res["vi_loc"] = np.array([vi2.params["mu"]["loc"].item(), vi1.params["mu"]["loc"].item()])
    res["vi_elbo"] = np.array([vi2.final_elbo(), vi1.final_elbo()])

    def wmodel(prior_mu, ys):
        w = ftt.sample("w", ftt.Normal(prior_mu, 1.0))
        ftt.observe("ys", ftt.Normal(w[None, :], 1.0), ys)

    st_w = ftt.stage(wmodel, torch.as_tensor(PRIOR_W), torch.as_tensor(YS_W), device="cpu")
    cfg_w = ftt.VIConfig(n_iterations=200, n_samples=8)
    w2 = ftt.optimize_meanfield_vi(0, staged=st_w, config=cfg_w, mesh=mesh)  # auto: data
    w1 = ftt.optimize_meanfield_vi(0, staged=st_w, config=cfg_w, device="cpu")
    res["w_loc"] = np.stack([w2.params["w"]["loc"].numpy(), w1.params["w"]["loc"].numpy()])

    c = sharded_chees_chain(0, staged=staged, n_samples=150, n_warmup=150, n_chains=32,
                            mesh=mesh)
    res["chees_mu"] = c.samples["mu"].numpy()
    res["chees_kernel"] = np.array([c.step_size, c.trajectory_length, c.n_leapfrogs])
    res["chees_mass"] = c.inv_mass.numpy()
    return res


def _children_engines(rank, world, out):
    import torch

    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.parallel import (make_chain_mesh, sharded_abc_rejection,
                                          sharded_ess_chain, sharded_gibbs_chain,
                                          sharded_pt_chain)

    staged = _torch_normal_staged(ftt, torch)
    mesh = make_chain_mesh(device="cpu")
    res = {}
    pt = sharded_pt_chain(0, staged=staged, n_samples=100, n_warmup=100, n_chains=8,
                          config=ftt.PTConfig(n_temps=4, beta_min=0.1, n_leapfrog=8), mesh=mesh)
    res["pt_mu"] = pt.samples["mu"].numpy()
    res["pt_eps"] = pt.step_size.numpy()
    es = sharded_ess_chain(0, staged=staged, n_samples=200, n_warmup=50, n_chains=16, mesh=mesh)
    res["ess_mu"] = es.samples["mu"].numpy()
    gb = sharded_gibbs_chain(0, staged=ftt.stage(_switch_model(ftt, torch), device="cpu"),
                             n_samples=200, n_warmup=100, n_chains=16,
                             config=ftt.HMCConfig(n_leapfrog=8), mesh=mesh)
    res["gibbs_theta"] = gb.samples["theta"].numpy()
    res["gibbs_z"] = gb.samples["z"].numpy()
    res["gibbs_eps"] = np.array(gb.step_size)
    flips = torch.as_tensor(FLIPS)

    def coin():
        p = ftt.sample("p", ftt.Beta(2.0, 2.0))
        return ftt.sample("flips", ftt.Bernoulli(p), sample_shape=(10,))

    ab = sharded_abc_rejection(
        0, coin, observed=flips,
        distance=lambda a, b: torch.abs(a.to(torch.float64).sum(-1) - b.to(torch.float64).sum(-1)),
        epsilon=0.5, n_samples=400, batch_size=4096, mesh=mesh, device="cpu")
    res["abc_p"] = ab.particles["p"].numpy()
    res["abc_attempts"] = np.array(ab.n_attempts)
    return res


CHILDREN = {"collectives": _children_collectives, "hmc_nuts": _children_hmc_nuts,
            "nuts_async": _children_nuts_async,
            "smc_mh_vi": _children_smc_mh_vi, "engines": _children_engines}


def _child_main(scenario, rank, world, port, out):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from fugue_tpu_torch import settings
    from fugue_tpu_torch.parallel import DistributedConfig, initialize_distributed

    settings.enable_x64(True)
    initialize_distributed(DistributedConfig(f"localhost:{port}", world, rank, backend="gloo"),
                           device="cpu")
    try:
        res = CHILDREN[scenario](rank, world, out)
        np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests (the parent)
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(scenario, out, world=2):
    port = _free_port()
    env = {"PATH": os.environ.get("PATH", ""), "HOME": os.environ.get("HOME", "/root"),
           "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "TMPDIR": os.environ.get("TMPDIR", "/tmp")}
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), scenario, str(r),
                              str(world), str(port), str(out)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _join(procs, out, timeout=65.0):
    """Every rank's results, once each has exited 0 (or the test fails
    with its output); no child outlives the test."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed (rc={p.returncode}):\n{text}"
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(len(procs))]


def _same_on_every_rank(ranks, keys=None):
    for k in keys or ranks[0]:
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


def _mcse(x):
    """(mean, MC standard error from the multi-chain ESS) of (chains, draws)."""
    import torch

    from fugue_tpu_torch.inference.mcmc_utils import ess_multichain

    x = np.array(x, np.float64)
    ess = float(ess_multichain(torch.as_tensor(x)))
    return x.mean(), x.std() / np.sqrt(max(ess, 1.0))


def _within_5_mcse(ours, theirs, what):
    (m1, s1), (m2, s2) = _mcse(ours), _mcse(theirs)
    z = (m1 - m2) / np.hypot(s1, s2)
    assert abs(z) < 5.0, f"{what}: {m1} vs JAX {m2} is {z:.2f} MC-SE"


def _jax_normal_staged():
    import jax.numpy as jnp

    import fugue_tpu as ft

    y = jnp.asarray(Y)

    def normal_model():
        mu = ft.sample("mu", ft.Normal(0.0, PRIOR_SD))
        ft.observe("ys", ft.Normal(mu, 1.0), y)
        return mu

    return ft.stage(normal_model)


def _jax_mesh2():
    from fugue_tpu.parallel.mesh import make_chain_mesh

    return make_chain_mesh(2)


def test_collectives_match_jax_shard_map(tmp_path):
    """Welford's Chan merge (diagonal and dense) and the ε₀ consensus on
    two gloo ranks against ``shard_map`` on two virtual devices (1e-12,
    float64), the ring gather on three ranks (both directions) exactly
    against indexing the whole tree, a batch split over both axes of a
    (hosts, chains) mesh, and a sharded checkpoint written and read back by
    three ranks, each writing its own block."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from fugue_tpu.inference.hmc import WelfordState as JW
    from fugue_tpu.inference.hmc import welford_merge_across as jmerge
    from fugue_tpu.inference.hmc import welford_push_batch as jpush
    from fugue_tpu.parallel.sharded import _shard_map

    procs = _spawn("collectives", tmp_path, world=3)
    mesh = _jax_mesh2()
    jax_welford = {}
    for dense in (False, True):
        def merged(xs, dense=dense):
            st = JW.init(3, dense)
            for t in range(xs.shape[0]):
                st = jpush(st, xs[t])
            m = jmerge(st, "chains")
            return jnp.concatenate([m.mean.ravel(), m.m2.ravel(), jnp.reshape(m.count, (1,))])[None]

        f = _shard_map(merged, mesh, in_specs=(P(None, "chains", None),), out_specs=P("chains"))
        jax_welford[dense] = np.asarray(jax.jit(f)(jnp.asarray(WELFORD_X)))
    f = _shard_map(lambda e: jnp.exp(jax.lax.pmean(jnp.log(e), "chains")), mesh,
                   in_specs=(P("chains"),), out_specs=P("chains"))
    jax_eps = np.asarray(jax.jit(f)(jnp.asarray(EPS0)))

    ranks = _join(procs, tmp_path)
    _same_on_every_rank(ranks[:2], ["welford0", "welford1", "eps"])
    whole = WELFORD_X.reshape(-1, 3)
    for dense in (False, True):
        np.testing.assert_allclose(ranks[0][f"welford{int(dense)}"], jax_welford[dense][0],
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(jax_welford[dense][1], jax_welford[dense][0], rtol=0, atol=0)
        mean = ranks[0][f"welford{int(dense)}"][:3]
        np.testing.assert_allclose(mean, whole.mean(0), rtol=1e-12)
    np.testing.assert_allclose(ranks[0]["eps"], jax_eps[0], rtol=1e-12)
    np.testing.assert_allclose(ranks[0]["eps"], np.sqrt(EPS0.prod()), rtol=1e-12)
    for r, res in enumerate(ranks):
        rows = slice(8 * r, 8 * r + 8)
        for a, v in RING_TREE.items():
            np.testing.assert_array_equal(res[f"ring_{a}"], v[RING_ANC][rows], err_msg=a)
        assert res["min"].tolist() == [1.0]
        assert res["gathered"].tolist() == [[0, 10, 1, 11, 2, 12]]
        assert int(res["host_staged"]) == 0
        assert res["hybrid"].tolist() == [3, r, r, 6.0]
        np.testing.assert_array_equal(res["ckpt_q"], CKPT_Q[2 * r:2 * r + 2])
        assert res["ckpt_rest"].tolist() == [0.25, 7.0, 1.0]
    assert sorted(p for p in os.listdir(tmp_path / "ckpt") if p.endswith(".distcp")) == [
        "__0_0.distcp", "__1_0.distcp", "__2_0.distcp"]


def test_hmc_and_nuts_on_two_ranks(tmp_path):
    """Both ranks return the same global samples, ε and mass; the
    posterior mean of mu is within 5 MC-SE of JAX's sharded driver's on
    the same conjugate model and mesh size."""
    import jax

    import fugue_tpu as ft
    from fugue_tpu.parallel.sharded import sharded_hmc_chain, sharded_nuts_chain

    procs = _spawn("hmc_nuts", tmp_path)
    staged, mesh, key = _jax_normal_staged(), _jax_mesh2(), jax.random.PRNGKey(0)
    jh = sharded_hmc_chain(key, staged=staged, n_samples=200, n_warmup=200, n_chains=32,
                           config=ft.HMCConfig(n_leapfrog=8), mesh=mesh)
    jn = sharded_nuts_chain(key, staged=staged, n_samples=150, n_warmup=100, n_chains=16,
                            mesh=mesh)
    ranks = _join(procs, tmp_path)
    _same_on_every_rank(ranks)
    r = ranks[0]
    assert r["hmc_mu"].shape == (32, 200) and r["nuts_mu"].shape == (16, 150)
    _within_5_mcse(r["hmc_mu"], np.asarray(jh.samples["mu"]), "sharded HMC")
    _within_5_mcse(r["nuts_mu"], np.asarray(jn.samples["mu"]), "sharded NUTS")
    for name in ("hmc", "nuts"):
        assert abs(r[f"{name}_mu"].mean() - POST_MEAN) < 5 * _mcse(r[f"{name}_mu"])[1] + 1e-3
        assert 0 < float(r[f"{name}_eps"]) < 10
    # the chains differ between the ranks' blocks: the streams are folded
    assert not np.allclose(r["hmc_mu"][0], r["hmc_mu"][16])
    assert int(r["nuts_leaps"]) > 16 * 250


def test_smc_mh_vi_chees_on_two_ranks(tmp_path):
    """SMC's log Z on two ranks against the one-rank run, JAX's
    ``sharded_smc`` and the exact evidence; a split ladder resumes
    bitwise; MH on two ranks is bitwise MH on one (discrete walk and
    categorical noise included); VI's data mode follows unsharded VI and
    keeps the (2,) prior-mean leaf whole; ChEES agrees on ε, T and L on
    both ranks and with JAX's sharded ChEES within 5 MC-SE."""
    import jax

    from fugue_tpu.parallel.sharded import sharded_chees_chain, sharded_smc

    procs = _spawn("smc_mh_vi", tmp_path)
    staged, mesh = _jax_normal_staged(), _jax_mesh2()
    js = [sharded_smc(jax.random.PRNGKey(s), 2048, staged=staged, mesh=mesh).log_evidence
          for s in range(4)]
    jc = sharded_chees_chain(jax.random.PRNGKey(0), staged=staged, n_samples=150,
                             n_warmup=150, n_chains=32, mesh=mesh)
    ranks = _join(procs, tmp_path)
    _same_on_every_rank(ranks)
    r = ranks[0]
    cov = np.eye(len(Y)) + PRIOR_SD**2
    exact = -0.5 * (Y @ np.linalg.solve(cov, Y) + np.linalg.slogdet(cov)[1]
                    + len(Y) * np.log(2 * np.pi))
    # MC error of one run's log Z at 2,048 particles: the JAX runs' spread
    # (4 seeds) with a floor of 0.02
    sd = max(float(np.std(js, ddof=1)), 0.02)
    for what, logz in (("two ranks", r["smc_logz"][0]), ("one rank", r["smc_logz"][1]),
                       ("JAX", float(np.mean(js)))):
        assert abs(logz - exact) < 5 * sd, f"SMC {what}: log Z {logz} vs exact {exact}"
    assert abs(r["smc_logz"][0] - r["smc_logz"][1]) < 5 * np.sqrt(2) * sd
    assert abs(r["smc_mean"][0] - POST_MEAN) < 0.05
    assert bool(r["smc_resume_equal"])
    assert bool(r["mh_equal"]) and r["mh_k"].shape == (8, 60)
    np.testing.assert_allclose(r["vi_loc"][0], r["vi_loc"][1], atol=1e-6)
    np.testing.assert_allclose(r["vi_elbo"][0], r["vi_elbo"][1], rtol=1e-6)
    assert abs(r["vi_loc"][0] - POST_MEAN) < 0.05
    post_w = (PRIOR_W + YS_W.sum(0)) / (1.0 + len(YS_W))
    np.testing.assert_allclose(r["w_loc"][0], r["w_loc"][1], atol=1e-6)
    np.testing.assert_allclose(r["w_loc"][0], post_w, atol=0.1)
    _within_5_mcse(r["chees_mu"], np.asarray(jc.samples["mu"]), "sharded ChEES")
    assert r["chees_kernel"][0] > 0 and r["chees_kernel"][1] > 0


def test_pt_gibbs_ess_abc_on_two_ranks(tmp_path):
    """PT, Gibbs, ESS and ABC rejection on two ranks: the same global result
    on both, and each posterior mean within 5 MC-SE of JAX's sharded
    driver's (ABC's draws are independent: its MC-SE is sd/sqrt(n))."""
    import jax
    import jax.numpy as jnp

    import fugue_tpu as ft
    from fugue_tpu.parallel.sharded import (sharded_abc_rejection, sharded_ess_chain,
                                            sharded_gibbs_chain, sharded_pt_chain)
    from fugue_tpu.inference.tempering import PTConfig

    procs = _spawn("engines", tmp_path)
    staged, mesh, key = _jax_normal_staged(), _jax_mesh2(), jax.random.PRNGKey(0)
    jpt = sharded_pt_chain(key, staged=staged, n_samples=100, n_warmup=100, n_chains=8,
                           config=PTConfig(n_temps=4, beta_min=0.1, n_leapfrog=8), mesh=mesh)
    jes = sharded_ess_chain(key, staged=staged, n_samples=200, n_warmup=50, n_chains=16,
                            mesh=mesh)

    def switch():
        z = ft.sample("z", ft.Bernoulli(0.7))
        th = ft.sample("theta", ft.Normal(0.0, 1.0))
        ft.observe("y", ft.Normal(th + jnp.where(z, 1.0, -1.0), 1.0), jnp.array(SWITCH_Y))

    jgb = sharded_gibbs_chain(key, switch, n_samples=200, n_warmup=100, n_chains=16,
                              config=ft.HMCConfig(n_leapfrog=8), mesh=mesh)

    def coin():
        p = ft.sample("p", ft.Beta(2.0, 2.0))
        return ft.sample("flips", ft.Bernoulli(p), sample_shape=(10,))

    jab = sharded_abc_rejection(
        key, coin, observed=jnp.asarray(FLIPS),
        distance=lambda a, b: jnp.abs(jnp.sum(a.astype(jnp.float64))
                                      - jnp.sum(b.astype(jnp.float64))),
        epsilon=0.5, n_samples=400, batch_size=4096, mesh=mesh)
    ranks = _join(procs, tmp_path)
    _same_on_every_rank(ranks)
    r = ranks[0]
    _within_5_mcse(r["pt_mu"], np.asarray(jpt.samples["mu"]), "sharded PT")
    _within_5_mcse(r["ess_mu"], np.asarray(jes.samples["mu"]), "sharded ESS")
    _within_5_mcse(r["gibbs_theta"], np.asarray(jgb.samples["theta"]), "sharded Gibbs theta")
    _within_5_mcse(r["gibbs_z"].astype(np.float64),
                   np.asarray(jgb.samples["z"]).astype(np.float64), "sharded Gibbs z")
    ours, theirs = r["abc_p"], np.asarray(jab.particles["p"])
    z = (ours.mean() - theirs.mean()) / np.hypot(ours.std() / 20.0, theirs.std() / 20.0)
    assert ours.shape == (400,) and abs(z) < 5.0, f"sharded ABC: {z:.2f} MC-SE"
    assert int(r["abc_attempts"]) >= 4096
    assert r["pt_eps"].shape == (4,) and np.all(r["pt_eps"] > 0)
    assert not np.allclose(r["ess_mu"][0], r["ess_mu"][8])  # the ranks' streams differ


if __name__ == "__main__":
    scenario, rank, world, port, out = sys.argv[1:]
    sys.path.insert(0, REPO)
    _child_main(scenario, int(rank), int(world), int(port), out)
