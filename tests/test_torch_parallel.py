"""The port's multi-device layer in one process, on the CPU, over a one-rank
gloo group (the group the port makes when none exists):

- at one rank each gradient drive (HMC diagonal and dense, NUTS, ChEES)
  equals its single-device drive fed the same positions and generator,
  float64, to 1e-12: the collectives at world size 1 are identities;
- the nine sharded drivers run and return the single-device result types
  with global shapes; VI's mesh= routes to ``sharded_vi``; SMC's sharded
  ladder resumes bitwise;
- the mesh vocabulary: placements, padding, the collectives without a
  group, the counts;
- the service: ``hmc.sharded`` answers through ``FugueService.handle``,
  and a ``vi.run`` reply reads its summaries to the host once;
- a sharded checkpoint round trip over one rank.

Two and three ranks in spawned processes are in
``tests/test_torch_parallel_ranks.py``.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import fugue_tpu_torch as ftt
from fugue_tpu_torch import parallel as P
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference import chees, hmc, nuts
from fugue_tpu_torch.parallel.mesh import (COUNTS, ShardLayout, all_gather_tiled, cross_mean,
                                           cross_min, cross_sum, pad_to_multiple)

import torch_parity_models as models

FLIPS = [1, 1, 1, 0, 1, 0, 1, 1, 0, 1]


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


@pytest.fixture(scope="module")
def mesh():
    made = not dist.is_initialized()
    m = P.make_chain_mesh(device="cpu")
    yield m
    if made:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def staged():
    return ftt.stage(models.torch_eight_schools(), device="cpu")


def _same(a, b):
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            np.testing.assert_allclose(x.double().numpy(), y.double().numpy(),
                                       rtol=1e-12, atol=1e-12)
        elif isinstance(x, dict):
            assert x == y
        else:
            assert x == pytest.approx(y, rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("engine", ["hmc_diag", "hmc_dense", "nuts", "chees"])
def test_world_one_drive_equals_the_single_device_drive(mesh, staged, engine):
    group = ShardLayout.of(mesh).group
    q0 = hmc.initial_positions(staged, torch.Generator().manual_seed(0), 8, "uniform")
    if engine.startswith("hmc"):
        cfg = ftt.HMCConfig(n_leapfrog=6, mass="dense" if engine == "hmc_dense" else "diag")
        make = lambda **kw: hmc.make_hmc_drive(staged, cfg, 8, 20, 30, **kw)  # noqa: E731
        run = lambda d: d(q0, torch.Generator().manual_seed(1))  # noqa: E731
    elif engine == "nuts":
        cfg = ftt.NUTSConfig(max_depth=5)
        make = lambda **kw: nuts.make_nuts_drive(staged, cfg, 8, 15, 20, **kw)  # noqa: E731
        run = lambda d: d(q0, torch.Generator().manual_seed(1))  # noqa: E731
    else:
        cfg = ftt.ChEESConfig()
        make = lambda **kw: chees.make_chees_drive(staged, cfg, 8, 15, 30, **kw)  # noqa: E731
        run = lambda d: d(q0, chees.GeneratorDraws(torch.Generator().manual_seed(1)))  # noqa: E731
    COUNTS["collectives"] = 0
    sharded = run(make(chain_group=group))
    assert COUNTS["collectives"] > 0  # the world-one group really reduced
    _same(run(make()), sharded)


def test_collectives_without_a_group_are_the_plain_operations():
    x = torch.arange(6.0).reshape(2, 3)
    for op in (cross_mean, cross_sum, cross_min, all_gather_tiled):
        assert op(x, None) is x


def test_collectives_over_one_rank(mesh):
    group = ShardLayout.of(mesh).group
    x = torch.tensor([[1.0, -2.0], [3.0, 4.0]], dtype=torch.float64)
    COUNTS.update(collectives=0, host_staged=0)
    for op in (cross_mean, cross_sum, cross_min):
        y = op(x, group)
        assert torch.equal(y, x) and y is not x  # reduced into a copy
    assert torch.equal(all_gather_tiled(x, group, dim=1), x)
    assert torch.equal(all_gather_tiled(x > 0, group), x > 0)  # bool moves as bytes
    assert COUNTS == {"collectives": 5, "host_staged": 0}  # CPU tensors stay on the host


def test_mesh_placements_and_padding(mesh):
    from torch.distributed.tensor import Replicate, Shard

    assert mesh.mesh_dim_names == (P.CHAIN_AXIS,)
    assert P.chain_sharding(mesh, 2) == [Shard(0)]
    assert P.replicated(mesh) == [Replicate()]
    m2 = P.make_chain_data_mesh(1, 1, device="cpu")
    assert m2.mesh_dim_names == (P.CHAIN_AXIS, P.DATA_AXIS)
    assert P.chain_sharding(m2) == [Shard(0), Replicate()]
    assert [pad_to_multiple(n, 4) for n in (0, 1, 4, 5)] == [0, 4, 4, 8]
    layout = ShardLayout.of(mesh)
    assert (layout.size, layout.index, layout.seed_index) == (1, 0, 0)
    assert layout.split(6) == 6 and layout.rows(6) == slice(0, 6)
    with pytest.raises(ValueError, match="not divisible"):
        ShardLayout(size=4).split(6)
    with pytest.raises(ValueError):
        P.make_chain_data_mesh(2, 1, device="cpu")


def test_the_parallel_namespace_is_the_jax_packages():
    import fugue_tpu.parallel as jp

    assert sorted(P.__all__) == sorted(jp.__all__)
    assert all(hasattr(P, name) for name in P.__all__)


def _gaussian_staged():
    def model():
        mu = ftt.sample("mu", ftt.Normal(1.0, 2.0))
        ftt.observe("y", ftt.Normal(mu, 1.0), torch.tensor(3.0, dtype=torch.float64))

    return ftt.stage(model, device="cpu")


DRIVERS = {
    "hmc": lambda s, m: P.sharded_hmc_chain(0, staged=s, n_samples=10, n_warmup=10,
                                            n_chains=4, mesh=m),
    "nuts": lambda s, m: P.sharded_nuts_chain(0, staged=s, n_samples=5, n_warmup=5,
                                              n_chains=4, config=ftt.NUTSConfig(max_depth=4),
                                              mesh=m),
    "chees": lambda s, m: P.sharded_chees_chain(0, staged=s, n_samples=5, n_warmup=10,
                                                n_chains=4, mesh=m),
    "pt": lambda s, m: P.sharded_pt_chain(0, staged=s, n_samples=5, n_warmup=5, n_chains=2,
                                          config=ftt.PTConfig(n_temps=3), mesh=m),
    "gibbs": lambda s, m: P.sharded_gibbs_chain(0, staged=s, n_samples=5, n_warmup=5,
                                                n_chains=2, mesh=m),
    # elliptical slice needs Gaussian priors: eight-schools' tau is not
    "ess": lambda s, m: P.sharded_ess_chain(0, staged=_gaussian_staged(), n_samples=5,
                                            n_warmup=5, n_chains=4, mesh=m),
    "smc": lambda s, m: P.sharded_smc(0, 256, staged=s, mesh=m),
    "vi": lambda s, m: P.sharded_vi(0, staged=s, mesh=m,
                                    config=ftt.VIConfig(n_iterations=20, n_samples=2)),
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_sharded_driver_runs_at_world_one(mesh, staged, name):
    res = DRIVERS[name](staged, mesh)
    if name == "smc":
        assert isinstance(res, ftt.SMCResult) and res.particles["mu"].shape == (256,)
        assert res.converged and np.isfinite(res.log_evidence)
    elif name == "vi":
        assert isinstance(res, ftt.VIResult) and np.isfinite(res.final_elbo())
    else:
        mu = res.samples["mu"]
        assert mu.shape[1] == 5 if name != "hmc" else mu.shape == (4, 10)
        assert bool(torch.isfinite(mu).all())


def test_sharded_abc_rejection_at_world_one(mesh):
    def coin():
        p = ftt.sample("p", ftt.Beta(2.0, 2.0))
        return ftt.sample("flips", ftt.Bernoulli(p), sample_shape=(10,))

    obs = torch.tensor(FLIPS, dtype=torch.bool)
    res = P.sharded_abc_rejection(
        0, coin, observed=obs,
        distance=lambda a, b: torch.abs(a.double().sum() - b.double().sum()),
        epsilon=0.5, n_samples=64, batch_size=512, mesh=mesh, device="cpu")
    assert res.particles["p"].shape == (64,) and res.n_attempts % 512 == 0
    assert bool((res.distances <= 0.5).all())


def test_vi_mesh_routes_to_sharded_vi(mesh, staged):
    cfg = ftt.VIConfig(n_iterations=30, n_samples=4)
    for opt, guide in ((ftt.optimize_meanfield_vi, "meanfield"),
                       (ftt.optimize_fullrank_vi, "fullrank")):
        a = opt(3, staged=staged, config=cfg, mesh=mesh)
        b = P.sharded_vi(3, staged=staged, config=cfg, mesh=mesh, guide=guide)
        np.testing.assert_array_equal(a.elbo_history, b.elbo_history)
    resumed = P.sharded_vi(3, staged=staged, config=cfg, mesh=mesh, resume=b, guide="fullrank")
    assert np.isfinite(resumed.final_elbo())


def test_sharded_vi_data_mode_matches_unsharded_at_world_one(mesh):
    y = torch.as_tensor(np.random.default_rng(7).normal(1.8, 1.0, 64))

    def model(ys):
        mu = ftt.sample("mu", ftt.Normal(0.0, 2.0))
        ftt.observe("ys", ftt.Normal(mu, 1.0), ys)

    st = ftt.stage(model, y, device="cpu")
    cfg = ftt.VIConfig(n_iterations=100, n_samples=8)
    a = P.sharded_vi(0, staged=st, config=cfg, mesh=mesh, shard="data")
    b = ftt.optimize_meanfield_vi(0, staged=st, config=cfg, device="cpu")
    np.testing.assert_allclose(a.elbo_history, b.elbo_history, rtol=1e-12)


def test_sharded_vi_validation(mesh):
    st = ftt.stage(lambda: ftt.sample("x", ftt.Normal(0.0, 1.0)), device="cpu")
    with pytest.raises(ValueError, match="data leaf"):
        P.sharded_vi(0, staged=st, config=ftt.VIConfig(n_iterations=10), mesh=mesh,
                     shard="data")
    for kw in ({"shard": "rows"}, {"factors": "both"}, {"guide": "laplace"}):
        with pytest.raises(ValueError, match="unknown"):
            P.sharded_vi(0, staged=st, config=ftt.VIConfig(n_iterations=10), mesh=mesh, **kw)
    res = P.sharded_vi(0, staged=st, config=ftt.VIConfig(n_iterations=50, n_samples=4),
                       mesh=mesh)  # auto: no data leaf, so samples
    assert np.isfinite(res.final_elbo())


def test_sharded_smc_resumes_bitwise(mesh, staged):
    cfg = ftt.SMCConfig(rejuvenation_steps=2)
    full = P.sharded_smc(4, 512, staged=staged, config=cfg, mesh=mesh)
    part = P.sharded_smc(4, 512, staged=staged, mesh=mesh,
                         config=ftt.SMCConfig(rejuvenation_steps=2, max_stages=1))
    assert not part.converged and full.n_stages > 1
    done = P.sharded_smc(0, 512, staged=staged, config=cfg, mesh=mesh, resume=part)
    assert torch.equal(done.particles["mu"], full.particles["mu"])
    assert done.log_evidence == full.log_evidence and done.n_stages == full.n_stages
    with pytest.raises(ValueError, match="mesh"):
        ftt.adaptive_smc(0, 512, staged=staged, config=cfg, resume=part, device="cpu")


def test_sharded_mh_equals_mh_at_world_one(mesh, staged):
    a = ftt.adaptive_mcmc_chain(5, staged=staged, n_samples=10, n_warmup=10, n_chains=4,
                                mesh=mesh)
    b = ftt.adaptive_mcmc_chain(5, staged=staged, n_samples=10, n_warmup=10, n_chains=4)
    for addr in b.samples:
        assert torch.equal(a.samples[addr], b.samples[addr])
    assert torch.equal(a.accept_rate, b.accept_rate)


def test_sharded_checkpoint_round_trip_over_one_rank(mesh, tmp_path):
    from fugue_tpu_torch.parallel.mesh import chain_sharded
    from fugue_tpu_torch.runtime.checkpoint import (load_checkpoint_sharded,
                                                    save_checkpoint_sharded)

    q = torch.arange(8.0, dtype=torch.float64).reshape(4, 2)
    state = {"q": chain_sharded(q, mesh), "eps": torch.tensor(0.5),
             "gen": torch.Generator().manual_seed(3), "stage": 2, "w": np.arange(3.0)}
    save_checkpoint_sharded(tmp_path / "ck", state)
    tmpl = {"q": chain_sharded(torch.zeros_like(q), mesh), "eps": torch.tensor(0.0),
            "gen": torch.Generator(), "stage": 0, "w": np.zeros(3)}
    back = load_checkpoint_sharded(tmp_path / "ck", tmpl)
    assert torch.equal(back["q"].to_local(), q) and back["q"].placements == tmpl["q"].placements
    assert back["eps"].item() == 0.5 and back["stage"] == 2
    assert torch.equal(back["gen"].get_state(), state["gen"].get_state())
    np.testing.assert_array_equal(back["w"], np.arange(3.0))
    assert torch.equal(tmpl["q"].to_local(), torch.zeros_like(q))  # the template is untouched


def test_hmc_sharded_answers_through_the_service(mesh):
    """One Normal observation of a Normal mean: the posterior is N(0.25,
    0.5); the reply holds each site's mean, sd and split-R-hat."""
    from fugue_tpu_torch.serve import FugueService

    src = ('let m <- sample("m", normal(0.0, 1.0)); observe("y", normal(m, 1.0), 0.5);'
           'return m;')
    svc = FugueService(seed=0, device="cpu")
    mid = svc.handle({"method": "compile", "params": {"source": src}})["result"]["model_id"]
    out = svc.handle({"method": "hmc.sharded", "params": {
        "model_id": mid, "n_samples": 100, "n_warmup": 100, "n_chains": 4}})
    res = out["result"]
    assert res["n_devices"] == 1 and res["n_chains"] == 4 and res["step_size"] > 0
    m = res["summaries"]["m"]
    assert set(m) == {"mean", "sd", "r_hat"} and len(m["mean"]) == 1
    assert m["mean"][0] == pytest.approx(0.25, abs=0.2)
    assert m["sd"][0] == pytest.approx(np.sqrt(0.5), rel=0.25)
    assert m["r_hat"][0] < 1.1
    assert svc.handle({"method": "hmc.sharded", "params": {"model_id": "x"}})["error"][
        "code"] == -32602


def test_hmc_sharded_refuses_a_service_that_is_one_of_several_ranks(monkeypatch):
    """Under torchrun's environment of two processes a request reaches one
    of them, and the other would never join its collectives: the service
    answers -32000 and makes no group."""
    import torch.distributed as dist

    from fugue_tpu_torch.serve import FugueService

    src = 'let m <- sample("m", normal(0.0, 1.0)); return m;'
    svc = FugueService(seed=0, device="cpu")
    mid = svc.handle({"method": "compile", "params": {"source": src}})["result"]["model_id"]
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    out = svc.handle({"method": "hmc.sharded", "params": {"model_id": mid}})
    assert out["error"]["code"] == -32000 and "one rank" in out["error"]["message"]


def test_vi_run_reads_its_summaries_once(monkeypatch):
    """After the optimization, a ``vi.run`` reply makes ONE device-to-host
    read for every site's mean and sd (two sites here), where the JAX
    service reads each leaf on its own."""
    from fugue_tpu_torch.inference import vi as vi_mod
    from fugue_tpu_torch.serve import FugueService

    src = ('let p <- sample("p", beta(2.0, 2.0)); let m <- sample("m", normal(0.0, 1.0));'
           'observe("y", normal(m, 1.0), 0.5); return p;')
    svc = FugueService(seed=0, device="cpu")
    mid = svc.handle({"method": "compile", "params": {"source": src}})["result"]["model_id"]
    reads = []
    counting = [False]
    # (``numpy()`` of a host tensor copies nothing: it is not counted)
    for name in ("cpu", "tolist", "item", "__float__", "__int__", "__bool__"):
        real = getattr(torch.Tensor, name)

        def wrapped(self, *a, _real=real, _name=name, **k):
            if counting[0]:
                reads.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    real_opt = vi_mod.optimize_meanfield_vi

    def optimize(*a, **k):  # the optimization's own reads are not the reply's
        res = real_opt(*a, **k)
        counting[0] = True
        return res

    monkeypatch.setattr(vi_mod, "optimize_meanfield_vi", optimize)
    out = svc.handle({"method": "vi.run", "params": {"model_id": mid, "n_iterations": 60,
                                                     "posterior_draws": 64}})
    counting[0] = False
    post = out["result"]["posterior"]
    assert set(post) == {"p", "m"} and all(len(v["mean"]) == 1 for v in post.values())
    assert reads == ["cpu"], reads


def test_a_jax_sharded_smc_state_finishes_over_the_ports_ranks(mesh):
    """JAX's ``sharded_smc`` on two virtual devices, stopped at
    max_stages=2; its global carry, converted with ``smc_state_from_numpy``
    and a seed, finishes the ladder through the port's sharded SMC, with log
    Z near the closed form (as the single-device resume test holds it)."""
    import math

    import jax
    import jax.numpy as jnp
    from scipy import stats

    import fugue_tpu as ft
    from fugue_tpu.inference.smc import SMCConfig as JSMCConfig
    from fugue_tpu.parallel.mesh import make_chain_mesh as jax_chain_mesh
    from fugue_tpu.parallel.sharded import sharded_smc as jax_sharded_smc
    from fugue_tpu_torch.interop import smc_state_from_numpy

    def jmodel():
        mu = ft.sample("mu", ft.Normal(0.0, 10.0))
        ft.observe("y", ft.Normal(mu, 0.05), jnp.array(3.0))

    def tmodel():
        mu = ftt.sample("mu", ftt.Normal(0.0, 10.0))
        ftt.observe("y", ftt.Normal(mu, 0.05), torch.tensor(3.0, dtype=torch.float64))

    part = jax_sharded_smc(jax.random.PRNGKey(5), 2048, staged=ft.stage(jmodel),
                           config=JSMCConfig(rejuvenation_steps=3, max_stages=2),
                           mesh=jax_chain_mesh(2))
    assert not part.converged
    latents, log_w, ll, beta, log_z, adapt, _key, stage_i = part.state
    state = smc_state_from_numpy(
        {a: np.asarray(v) for a, v in latents.items()}, np.asarray(log_w), np.asarray(ll),
        np.asarray(beta), np.asarray(log_z), np.asarray(adapt.log_scale), np.asarray(adapt.t),
        int(stage_i), generator=torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.float64, seed=11)
    assert state.seed == 11 and state.log_weights.shape == (2048,)
    res = P.sharded_smc(0, 2048, staged=ftt.stage(tmodel, device="cpu"),
                        config=ftt.SMCConfig(rejuvenation_steps=3), mesh=mesh, resume=state)
    exact = stats.norm(0.0, math.sqrt(100.0 + 0.05**2)).logpdf(3.0)
    assert res.converged and res.n_stages > 2
    assert res.log_evidence == pytest.approx(exact, abs=0.1)
    assert float(res.posterior_mean("mu")) == pytest.approx(3.0, abs=0.02)
