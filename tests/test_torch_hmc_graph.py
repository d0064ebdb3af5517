"""The HMC drive's CUDA-graph path, on the CPU: when it engages, what a
captured transition is keyed by, the per-model cache and its claim, and
the drive's handling of a replay's outputs (the same tensors, rewritten by
the next transition), held against the eager drive bitwise. The card's own
capture and replay are held in ``tests/test_torch_gpu.py``.
"""

import collections
from types import SimpleNamespace

import pytest
import torch

import fugue_tpu_torch as ftt
from chip_smoke import eight_schools_model
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference import hmc


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


ON_CARD = SimpleNamespace(is_cuda=True)


@pytest.mark.parametrize("q, force_fn, discrete, engages", [
    (ON_CARD, None, None, True),
    (torch.zeros(4, 3), None, None, False),
    (ON_CARD, lambda q: (q, q[:, 0]), None, False),
    (ON_CARD, None, {}, False),
    (ON_CARD, None, {"k": torch.zeros(())}, False),
], ids=["cuda", "cpu", "force_fn", "empty_discrete", "discrete"])
def test_graph_engages_only_on_the_card_with_the_staged_force(q, force_fn, discrete, engages):
    assert hmc.graph_engages(q, force_fn, discrete) is engages


def _key_inputs(chains=8, d=3, dtype=torch.float64, eps_shape=(8,), mass_shape=(3,)):
    return (torch.zeros(chains, d, dtype=dtype), torch.zeros(eps_shape, dtype=dtype),
            torch.zeros(mass_shape, dtype=dtype))


@pytest.mark.parametrize("changed, L, mde", [
    (dict(chains=16, eps_shape=(16,)), 8, 1000.0),
    (dict(d=4, mass_shape=(4,)), 8, 1000.0),
    (dict(dtype=torch.float32), 8, 1000.0),
    (dict(mass_shape=(3, 3)), 8, 1000.0),
    (dict(mass_shape=(8, 3, 3)), 8, 1000.0),
    (dict(eps_shape=()), 8, 1000.0),
    ({}, 16, 1000.0),
    ({}, 8, 100.0),
], ids=["n_chains", "d", "dtype", "dense", "per_chain", "eps_scalar", "L", "max_delta"])
def test_graph_key_tells_apart_what_a_capture_is_specific_to(changed, L, mde):
    base = hmc.graph_key(*_key_inputs(), 8, 1000.0)
    assert hmc.graph_key(*_key_inputs(), 8, 1000.0) == base
    assert hmc.graph_key(*_key_inputs(**changed), L, mde) != base


def test_the_cache_evicts_the_least_recently_used_beyond_its_bound():
    graphs = hmc.TransitionGraphs()
    n = hmc.GRAPHS_PER_MODEL
    for k in range(n):
        graphs.put(k, str(k))
    assert graphs.get(0) == "0"  # 0 is now the newest
    graphs.put(n, str(n))
    assert list(graphs.entries) == [*range(2, n), 0, n] and graphs.get(1) is None
    graphs.put(2, "again")
    graphs.put(n + 1, str(n + 1))
    assert list(graphs.entries) == [*range(3, n), 0, n, 2, n + 1][-n:]
    assert graphs.get(2) == "again" and len(graphs.entries) == n


def test_a_replay_adds_what_its_capture_counted():
    """No Python code runs in a replay: each one adds its capture's counts
    (gradients, kernel launches) to the cache's ``replayed``."""
    q, eps, inv_mass = _key_inputs()
    p, log_u = torch.ones_like(q), torch.zeros(8, dtype=q.dtype)
    replays = []
    graph = SimpleNamespace(replay=lambda: replays.append(1))
    counts = collections.Counter(gradients=9, nll=9)
    graphs = hmc.TransitionGraphs()
    graphs.put(hmc.graph_key(q, eps, inv_mass, 8, 1000.0),
               hmc._Captured(graph, tuple(x.clone() for x in (q, p, log_u, eps, inv_mass)),
                             ("q_out", "info"), counts))
    for _ in range(3):
        assert graphs.transition(None, q, p, log_u, eps, 8, inv_mass, 1000.0) == \
            ("q_out", "info")
    assert len(replays) == 3 and graphs.replayed == collections.Counter(gradients=27, nll=27)


def test_one_drive_at_a_time_claims_a_models_graphs():
    staged = ftt.stage(eight_schools_model("cpu", torch.float64), device="cpu")
    graphs = hmc.transition_graphs(staged)
    assert hmc.transition_graphs(staged) is graphs
    with hmc.claimed(graphs) as held:
        assert held is graphs
        with hmc.claimed(graphs) as other:
            assert other is None
    with hmc.claimed(graphs) as again:
        assert again is graphs
    with hmc.claimed(None) as none:
        assert none is None
    graphs.failed = True
    with hmc.claimed(graphs) as failed:
        assert failed is None
    assert not graphs.lock.locked()


def test_a_cpu_hmc_chain_never_touches_torch_cuda(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU drive reached torch.cuda")

    for name in ("CUDAGraph", "Stream", "current_stream", "stream", "graph", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(hmc, "TransitionGraphs", refuse)
    staged = ftt.stage(eight_schools_model("cpu", torch.float64), device="cpu")
    cfg = ftt.HMCConfig(n_leapfrog=4)
    first = ftt.hmc_chain(1, staged=staged, n_chains=8, n_samples=3, n_warmup=6, config=cfg)
    ftt.hmc_chain(2, staged=staged, n_chains=8, n_samples=3, n_warmup=0, config=cfg,
                  resume=first)
    assert "hmc_transition_graphs" not in vars(staged)


class _StaticOutputs(hmc.TransitionGraphs):
    """The graph path's contract without a card: each key's outputs are the
    same tensors, which the next transition rewrites, as a replay's are."""

    calls = 0

    def transition(self, potential_fn, q, p, log_u, eps, n_leapfrog, inv_mass,
                   max_delta_energy):
        type(self).calls += 1
        q_out, info = hmc.hmc_transition(potential_fn, q, p, log_u, eps, n_leapfrog, inv_mass,
                                         max_delta_energy)
        key = hmc.graph_key(q, eps, inv_mass, n_leapfrog, max_delta_energy)
        fresh = (q_out, *vars(info).values())
        kept = self.get(key)
        if kept is None:
            self.put(key, fresh)
            return q_out, info
        for buf, x in zip(kept, fresh):
            buf.copy_(x)
        return kept[0], hmc.HmcStepInfo(*kept[1:])


@pytest.mark.parametrize("mass", ["diag", "dense"])
def test_the_drive_reads_rewritten_outputs_as_the_eager_drive_does(monkeypatch, mass):
    """A fresh call (warmup and sampling) and a resumed call through outputs
    that each transition rewrites give the eager drive's draws, step size and
    mass bitwise, and the first result's final positions stay as they were."""
    cfg = ftt.HMCConfig(n_leapfrog=4, mass=mass)
    kw = dict(n_chains=8, n_samples=5, config=cfg)

    def runs():
        staged = ftt.stage(eight_schools_model("cpu", torch.float64), device="cpu")
        first = ftt.hmc_chain(1, staged=staged, n_warmup=10, **kw)
        kept = first.final_positions.clone()
        second = ftt.hmc_chain(2, staged=staged, n_warmup=0, resume=first, **kw)
        assert torch.equal(first.final_positions, kept)
        return first, second

    eager = runs()
    monkeypatch.setattr(hmc, "graph_engages", lambda q, force_fn, discrete: True)
    monkeypatch.setattr(hmc, "TransitionGraphs", _StaticOutputs)
    _StaticOutputs.calls = 0
    static = runs()
    assert _StaticOutputs.calls == 10 + 5 + 5
    for e, s in zip(eager, static):
        for field in ("positions", "final_positions", "log_joint", "accept_prob",
                      "divergences", "inv_mass"):
            assert torch.equal(getattr(e, field), getattr(s, field)), field
        assert e.step_size == s.step_size
