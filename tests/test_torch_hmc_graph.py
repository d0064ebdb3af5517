"""The transitions' CUDA-graph path (``hmc.TransitionGraphs``, which the HMC
drive replays and ChEES replays as ``chees.ChEESGraphs``), on the CPU: the
shared transition as its head, leapfrog and tail, when the path engages,
what a capture is keyed by, the per-model caches and their claims, what a
replay tallies, and the path itself through a stand-in for the card's
graphs whose replays run the recorded function again and write into the
first call's outputs, as a replay rewrites a graph's tensors
(``_RerunGraphs``), held against the eager drive bitwise. The card's own
capture and replay are held in ``tests/test_torch_gpu.py`` and
``tests/test_torch_chees_graph.py``.
"""

import collections
import time
from types import SimpleNamespace

import pytest
import torch

import fugue_tpu_torch as ftt
from chip_smoke import eight_schools_model
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference import chees, hmc
from fugue_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


ON_CARD = SimpleNamespace(is_cuda=True)
GRAPHS = {"hmc": hmc.TransitionGraphs, "chees": chees.ChEESGraphs}


def graph_counts(fn, prefix):
    """(fn(), the ``<prefix>.graph_*`` counts it made), recorded under a
    profiler session."""
    from torch.profiler import ProfilerActivity, profile

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    counts = collections.Counter()
    for r in profiling.records(t0, time.time_ns()):
        if isinstance(r, profiling.Count) and r.name.startswith(f"{prefix}.graph_"):
            counts[r.name] += r.n
    return out, dict(counts)


def _leaves(out):
    """The tensors of a recorded function's output (``HmcStepInfo``'s fields
    among them)."""
    if out is None:
        return []
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, hmc.HmcStepInfo):
        return list(vars(out).values())
    return [t for x in out for t in _leaves(x)]


def _rerun(fn):
    """The card's ``record`` on the CPU: (graph, fn()), where the graph's
    ``replay()`` runs ``fn`` again and writes its outputs into the first
    call's, as a replay rewrites the captured tensors."""
    out = fn()

    def replay():
        for buf, x in zip(_leaves(out), _leaves(fn())):
            buf.copy_(x)

    return SimpleNamespace(replay=replay), out


class _RerunGraphs(hmc.TransitionGraphs):
    """``TransitionGraphs`` whose first call for a key runs eagerly in place
    and records the graphs with ``_rerun``: the real replay sequence, inputs
    and outputs, without a card."""

    def _warm_up(self, fn, device):
        return fn(), _rerun


def _inputs(mass="diag", n_chains=16, seed=0):
    """(q, z, log_u, eps, inv_mass) for eight-schools (d = 10) in float64."""
    g = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64)

    q, z = 0.3 * normal(n_chains, 10), normal(n_chains, 10)
    log_u = torch.log(torch.rand((n_chains,), generator=g, dtype=torch.float64))
    if mass == "dense":
        a = normal(10, 10)
        inv_mass = a @ a.T / 10 + 0.5 * torch.eye(10, dtype=torch.float64)
    else:
        inv_mass = 0.5 + torch.rand((10,), generator=g, dtype=torch.float64)
    return q, z, log_u, torch.tensor(0.15, dtype=torch.float64), inv_mass


@pytest.mark.parametrize("mass", ["diag", "dense"])
def test_the_transition_is_its_head_leapfrog_and_tail_and_chees_shares_it(mass):
    """``hmc_transition`` equals the head, ``leapfrog`` and the tail, and
    ChEES's transition equals that transition from the momenta
    ``momentum_from_normal(inv_mass, z)``, bitwise."""
    staged = ftt.stage(eight_schools_model("cpu", torch.float64), device="cpu")
    q, z, log_u, eps, inv_mass = _inputs(mass)
    p = hmc.momentum_from_normal(inv_mass, z)
    force = hmc.batched_force(staged.potential)
    g0, u0, h0 = hmc.transition_head(force, q, p, inv_mass)
    q_new, p_new, _, u1 = hmc.leapfrog(force, q, p, eps, 8, inv_mass, g0)
    q_out, info = hmc.transition_tail(q, q_new, p_new, u0, h0, u1, log_u, inv_mass, 1000.0)
    assert 0 < int(info.accepted.sum()) < len(q)
    got_q, got_info = hmc.hmc_transition(staged.potential, q, p, log_u, eps, 8, inv_mass)
    assert torch.equal(got_q, q_out)
    for field, want in vars(info).items():
        assert torch.equal(getattr(got_info, field), want), field
    got = chees.chees_transition(staged.potential, q, z, log_u, eps, 1.0, 0.5, inv_mass, 1024,
                                 n_leapfrog=8)
    want = (q_out, q_new, p_new, info.accept_prob, info.accepted, info.divergent, 8,
            info.potential)
    for g, w in zip(got, want):
        assert torch.equal(g, w) if isinstance(w, torch.Tensor) else g == w


@pytest.mark.parametrize("engine", ["hmc", "chees"])
@pytest.mark.parametrize("q, force_fn, discrete, engages", [
    (ON_CARD, None, None, True),
    (torch.zeros(4, 3), None, None, False),
    (ON_CARD, lambda q: (q, q[:, 0]), None, False),
    (ON_CARD, None, {}, False),
    (ON_CARD, None, {"k": torch.zeros(())}, False),
], ids=["cuda", "cpu", "force_fn", "empty_discrete", "discrete"])
def test_graph_engages_only_on_the_card_with_the_staged_force(engine, q, force_fn, discrete,
                                                              engages):
    cls = GRAPHS[engine]
    assert hmc.graph_engages(q, force_fn, discrete) is engages
    staged = ftt.stage(eight_schools_model("cpu"), device="cpu")
    with hmc.claim_graphs(staged, cls, q, force_fn, discrete) as graphs:
        if engages:
            assert graphs is hmc.transition_graphs(staged, cls)
            assert type(graphs) is cls and graphs.lock.locked()
            with hmc.claim_graphs(staged, cls, q, force_fn, discrete) as other:
                assert other is None  # one drive or session at a time
        else:
            assert graphs is None
    assert not hmc.transition_graphs(staged, cls).lock.locked()


def _key_inputs(chains=8, d=3, dtype=torch.float64, eps_per_chain=True, mass="diag"):
    mass_shape = {"diag": (d,), "dense": (d, d), "per_chain": (chains, d, d)}[mass]
    return (torch.zeros(chains, d, dtype=dtype),
            torch.zeros((chains,) if eps_per_chain else (), dtype=dtype),
            torch.zeros(mass_shape, dtype=dtype))


@pytest.mark.parametrize("eps_per_chain", [True, False], ids=["eps_per_chain", "eps_scalar"])
@pytest.mark.parametrize("changed, steps, mde", [
    (dict(chains=16), 8, 1000.0),
    (dict(d=4), 8, 1000.0),
    (dict(dtype=torch.float32), 8, 1000.0),
    (dict(mass="dense"), 8, 1000.0),
    (dict(mass="per_chain"), 8, 1000.0),
    (dict(eps_shape=True), 8, 1000.0),
    ({}, 16, 1000.0),
    ({}, 8, 100.0),
], ids=["n_chains", "d", "dtype", "dense", "per_chain", "eps_shape", "steps", "max_delta"])
def test_graph_key_tells_apart_what_a_capture_is_specific_to(eps_per_chain, changed, steps,
                                                             mde):
    """The key changes with what a capture is specific to (HMC's L through
    its block's ``steps``) and not with the values copied into the inputs."""
    base = hmc.graph_key(*_key_inputs(eps_per_chain=eps_per_chain), 8, 1000.0)
    q, eps, inv_mass = _key_inputs(eps_per_chain=eps_per_chain)
    assert hmc.graph_key(q + 1.0, eps + 0.5, inv_mass * 3.0, 8, 1000.0) == base
    changed = dict(changed)
    flip = changed.pop("eps_shape", False)
    other = _key_inputs(eps_per_chain=eps_per_chain != flip, **changed)
    assert hmc.graph_key(*other, steps, mde) != base


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


@pytest.mark.parametrize("engine, entries, blocks", [("hmc", 2, 3), ("chees", 1, 8 + 16 + 8)])
def test_a_replay_adds_what_its_capture_counted(engine, entries, blocks):
    """No Python code runs in a replay: each transition adds its head's and
    tail's counts once and its block's once per replay of the block, L /
    ``steps`` times. HMC's block is the whole trajectory, so each L is a key
    of its own; ChEES's is one step, so one key serves L = 8 and 16."""
    cls = GRAPHS[engine]
    q, eps, inv_mass = _key_inputs()
    p, log_u = torch.ones_like(q), torch.zeros(8, dtype=q.dtype)
    replays = []

    def graph(name):
        return SimpleNamespace(replay=lambda: replays.append(name))

    graphs = cls()
    for L in (8, 16):
        steps = cls.steps or L
        graphs.put(hmc.graph_key(q, eps, inv_mass, steps, 1000.0),
                   hmc._Entry(tuple(x.clone() for x in (q, p, log_u, eps, inv_mass)),
                              graph("head"), graph("block"), graph("tail"), ("outputs", steps),
                              (), collections.Counter(gradients=1, nll=1),
                              collections.Counter(gradients=steps, nll=steps)))
    for L in (8, 16, 8):
        assert graphs.transition(None, q, p, log_u, eps, L, inv_mass, 1000.0) == \
            ("outputs", cls.steps or L)
    assert len(graphs.entries) == entries
    assert replays.count("head") == replays.count("tail") == 3
    assert replays.count("block") == blocks
    n = 9 + 17 + 9
    assert graphs.replayed == collections.Counter(gradients=n, nll=n)


@pytest.mark.parametrize("steps", [1, 4])
def test_the_entry_holds_every_tensor_its_pieces_read_or_write(steps):
    """A CUDA graph holds no reference to the memory it reads and writes:
    every tensor a recorded graph closes over is held by the entry, or the
    allocator hands its memory to the next tensor made."""
    recorded = []

    def record(fn):
        recorded.append(fn)
        return _rerun(fn)

    staged = ftt.stage(eight_schools_model("cpu", torch.float64), device="cpu")
    q, z, log_u, eps, inv_mass = _inputs()
    entry = hmc.record_transition(record, staged.potential, (q, z, log_u, eps, inv_mass), steps,
                                  1000.0)
    held = {id(t) for t in (*entry.inputs, *_leaves(entry.outputs), *entry.kept)}
    closed_over = [c.cell_contents for fn in recorded for c in fn.__closure__ or ()
                   if isinstance(c.cell_contents, torch.Tensor)]
    assert len(recorded) == 3 and len(closed_over) >= 12
    assert all(id(t) in held for t in closed_over)


def test_one_drive_at_a_time_claims_a_models_graphs():
    """One claim per cache; HMC's and ChEES's caches of one model are two,
    so an HMC drive and a ChEES session do not wait for each other."""
    staged = ftt.stage(eight_schools_model("cpu", torch.float64), device="cpu")
    graphs = hmc.transition_graphs(staged, hmc.TransitionGraphs)
    assert hmc.transition_graphs(staged, hmc.TransitionGraphs) is graphs
    with hmc.claimed(graphs) as held:
        assert held is graphs
        with hmc.claimed(graphs) as other:
            assert other is None
        with hmc.claimed(hmc.transition_graphs(staged, chees.ChEESGraphs)) as theirs:
            assert isinstance(theirs, chees.ChEESGraphs)
    with hmc.claimed(graphs) as again:
        assert again is graphs
    with hmc.claimed(None) as none:
        assert none is None
    graphs.failed = True
    with hmc.claimed(graphs) as failed:
        assert failed is None
    assert not graphs.lock.locked()


def _hmc_runs(staged):
    cfg = ftt.HMCConfig(n_leapfrog=4)
    first = ftt.hmc_chain(1, staged=staged, n_chains=8, n_samples=3, n_warmup=6, config=cfg)
    return ftt.hmc_chain(2, staged=staged, n_chains=8, n_samples=3, n_warmup=0, config=cfg,
                         resume=first).positions.shape[1]


def _chees_runs(staged):
    first = ftt.chees_chain(1, staged=staged, n_chains=8, n_samples=3, n_warmup=6)
    ftt.chees_chain(2, staged=staged, n_chains=8, n_samples=3, n_warmup=0, resume=first)
    return ftt.CheesSession(3, staged=staged, n_chains=8, n_warmup=4).step()["n_leapfrog"]


@pytest.mark.parametrize("engine", ["hmc", "chees"])
def test_a_cpu_run_never_touches_torch_cuda_nor_counts_a_graph(monkeypatch, engine):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU run reached torch.cuda or the graphs")

    for name in ("CUDAGraph", "Stream", "current_stream", "stream", "graph", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(hmc, "TransitionGraphs", refuse)
    monkeypatch.setattr(chees, "ChEESGraphs", refuse)
    staged = ftt.stage(eight_schools_model("cpu", torch.float64), device="cpu")
    runs = {"hmc": _hmc_runs, "chees": _chees_runs}[engine]
    out, counts = graph_counts(lambda: runs(staged), engine)
    assert counts == {} and out >= 1
    assert not any(isinstance(v, hmc.GraphCache) for v in vars(staged).values())


@pytest.mark.parametrize("mass", ["diag", "dense"])
def test_the_drive_reads_rewritten_outputs_as_the_eager_drive_does(monkeypatch, mass):
    """A fresh call (warmup and sampling) and a resumed call through the
    recorded head, block of L steps and tail, whose outputs each transition
    rewrites, give the eager drive's draws, step size and mass bitwise, and
    the first result's final positions stay as they were."""
    cfg = ftt.HMCConfig(n_leapfrog=4, mass=mass)
    kw = dict(n_chains=8, n_samples=5, config=cfg)

    def runs():
        staged = ftt.stage(eight_schools_model("cpu", torch.float64), device="cpu")
        first = ftt.hmc_chain(1, staged=staged, n_warmup=10, **kw)
        kept = first.final_positions.clone()
        second = ftt.hmc_chain(2, staged=staged, n_warmup=0, resume=first, **kw)
        assert torch.equal(first.final_positions, kept)
        return first, second

    eager, eager_counts = graph_counts(runs, "hmc")
    monkeypatch.setattr(hmc, "graph_engages", lambda q, force_fn, discrete: True)
    monkeypatch.setattr(hmc, "TransitionGraphs", _RerunGraphs)
    rerun, counts = graph_counts(runs, "hmc")
    assert eager_counts == {}
    assert counts == {"hmc.graph_capture": 1, "hmc.graph_replay": 10 + 5 + 5 - 1}
    for e, s in zip(eager, rerun):
        for field in ("positions", "final_positions", "log_joint", "accept_prob",
                      "divergences", "inv_mass"):
            assert torch.equal(getattr(e, field), getattr(s, field)), field
        assert e.step_size == s.step_size
