"""The ChEES transition's CUDA-graph path (``chees.ChEESGraphs``, the
``hmc.TransitionGraphs`` whose block is one leapfrog step).

On the CPU, through ``_RerunGraphs``, a stand-in for the card's graphs
whose replays run the recorded function again and write into the first
call's outputs, as a replay rewrites a graph's tensors: one transition
across Halton lengths, what its replays tally, the drive (warmup and a
resumed call) and two sessions of one model with their own step size and
mass, each held against the eager path bitwise. When the path engages,
its key, the caches' claims and a CPU run's untouched ``torch.cuda`` are
held in ``tests/test_torch_hmc_graph.py`` for both drives.

On the card (marked ``gpu``; this file imports no JAX, so it runs past the
suite's conftest): the captured head, leapfrog step and tail against the
eager transition bitwise for every L from 1 to 13, two sessions on one
model stepped in turns, a whole ``chees_chain`` with its warmup, the
fallback of a potential that reads the host and a replayed session step's
host syncs, all on eight-schools, whose potential is elementwise; and a
logistic model, whose GEMM cuBLAS may pick anew under capture, within
float32 rounding of the eager transition, small and at ``scale_chees``'s shape:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_chees_graph.py
"""

import collections

import pytest
import torch

import fugue_tpu_torch as ftt
from chip_smoke import _host_syncs, eight_schools_model
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference import chees, hmc
from fugue_tpu_torch.ops import kernels
from test_torch_hmc_graph import _RerunGraphs, graph_counts

OUTPUTS = ("Q_out", "Q_prop", "P_end", "accept_prob", "accepted", "divergent", "L", "U_out")


@pytest.fixture
def x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    settings.enable_x64(False)  # the benchmark's precision


def _graph_counts(fn):
    """(fn(), the ``chees.graph_*`` counts it made)."""
    return graph_counts(fn, "chees")


def _assert_same(got, want):
    for name, g, w in zip(OUTPUTS, got, want):
        if isinstance(w, torch.Tensor):
            assert torch.equal(g, w), name
        else:
            assert g == w, name


def _assert_same_results(got, want):
    for field in ("positions", "final_positions", "log_joint", "accept_prob", "divergences",
                  "inv_mass"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    assert (got.step_size, got.trajectory_length, got.n_leapfrogs, got.host_syncs) == \
        (want.step_size, want.trajectory_length, want.n_leapfrogs, want.host_syncs)


def _inputs(device, dtype, n_chains=64, seed=0):
    """(Q, z, log_u, eps, T, inv_mass) for eight-schools (d = 10): T/eps =
    12.5, so the Halton points give every L from 1 to 13."""
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=dtype)

    Q = 0.3 * normal(n_chains, 10)
    z = normal(n_chains, 10)
    log_u = torch.log(torch.rand((n_chains,), generator=g, device=device, dtype=dtype))
    eps = torch.tensor(0.08, device=device, dtype=dtype)
    T = torch.tensor(1.0, device=device, dtype=dtype)
    inv_mass = 0.5 + torch.rand((10,), generator=g, device=device, dtype=dtype)
    return Q, z, log_u, eps, T, inv_mass


# -- on the CPU ----------------------------------------------------------------


class _RerunChEESGraphs(_RerunGraphs, chees.ChEESGraphs):
    """``ChEESGraphs`` recorded with the CPU stand-in."""


def test_the_recorded_pieces_give_the_eager_transition_for_every_L(x64):
    """One key's head, one-step block and tail, replayed for h over the Halton
    sequence (L from 1 to 13), equal the eager transition bitwise, and only
    Q_out is a new tensor on each call."""
    staged = ftt.stage(eight_schools_model("cpu", torch.float64), device="cpu")
    Q, z, log_u, eps, T, inv_mass = _inputs("cpu", torch.float64)
    graphs = _RerunChEESGraphs()
    Ls, kept = set(), []
    for h in chees.halton_sequence(40).tolist():
        args = (staged.potential, Q, z, log_u, eps, T, h, inv_mass, 1024)
        got = chees.chees_transition(*args, graphs=graphs)
        _assert_same(got, chees.chees_transition(*args))
        Ls.add(got[6])
        kept.append(got)
    assert Ls == set(range(1, 14)) and len(graphs.entries) == 1
    assert len({id(k[0]) for k in kept}) == len(kept)
    assert len({id(k[1]) for k in kept[1:]}) == 1  # the graph's own q


def test_a_replay_counts_the_gradients_and_launches_its_capture_counted(monkeypatch, x64):
    """No Python code runs in a replay, so the cache's ``replayed`` adds what
    each graph's capture counted: one gradient and its kernel launch for the
    head and for each of the L replays of the one-step block, none for the
    tail."""
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.LAUNCHES, 0))
    staged = ftt.stage(eight_schools_model("cpu", torch.float64), device="cpu")

    def launching(z):  # a potential that launches one kernel a run
        kernels.LAUNCHES["nll"] += 1
        return staged.potential(z)

    Q, z, log_u, eps, T, inv_mass = _inputs("cpu", torch.float64)
    graphs = _RerunChEESGraphs()
    Ls = [chees.chees_transition(launching, Q, z, log_u, eps, T, h, inv_mass, 1024,
                                 graphs=graphs)[6]
          for h in chees.halton_sequence(20).tolist()]
    n = sum(L + 1 for L in Ls[1:])  # the first call runs eagerly, then captures
    assert len(set(Ls)) > 5
    assert graphs.replayed == collections.Counter(gradients=n, nll=n)


def _graph_path_on_cpu(monkeypatch):
    monkeypatch.setattr(hmc, "graph_engages", lambda q, force_fn, discrete: True)
    monkeypatch.setattr(chees, "ChEESGraphs", _RerunChEESGraphs)


def test_the_drive_through_rewritten_outputs_equals_the_eager_drive(monkeypatch, x64):
    """A fresh chees_chain (warmup and sampling) and a resumed call through
    the recorded graphs give the eager drive's draws, step size, T and mass
    bitwise, and the first result's final positions stay as they were."""
    kw = dict(n_chains=8, n_samples=5)

    def runs():
        staged = ftt.stage(eight_schools_model("cpu", torch.float64), device="cpu")
        first = ftt.chees_chain(1, staged=staged, n_warmup=10, **kw)
        kept = first.final_positions.clone()
        second = ftt.chees_chain(2, staged=staged, n_warmup=0, resume=first, **kw)
        assert torch.equal(first.final_positions, kept)
        return first, second

    eager, eager_counts = _graph_counts(runs)
    _graph_path_on_cpu(monkeypatch)
    rerun, counts = _graph_counts(runs)
    assert eager_counts == {}
    assert counts == {"chees.graph_capture": 1, "chees.graph_replay": 10 + 5 + 5 - 1}
    for got, want in zip(rerun, eager):
        _assert_same_results(got, want)


def _two_sessions(steps=6):
    """Two sessions of one staged model (their own step size and mass),
    stepped in turns: (each step's replies, each session's positions)."""
    staged = ftt.stage(eight_schools_model("cpu", torch.float64), device="cpu")
    sessions = [ftt.CheesSession(s, staged=staged, n_chains=8, n_warmup=8) for s in (1, 2)]
    assert sessions[0].step_size != sessions[1].step_size
    assert not torch.equal(sessions[0].inv_mass, sessions[1].inv_mass)
    replies = [s.step() for _ in range(steps) for s in sessions]
    return replies, [s.positions for s in sessions]


def test_two_sessions_of_one_model_share_the_pieces_and_keep_their_chains(monkeypatch, x64):
    (eager, eager_q), eager_counts = _graph_counts(_two_sessions)
    _graph_path_on_cpu(monkeypatch)
    (rerun, rerun_q), counts = _graph_counts(_two_sessions)
    assert eager_counts == {}
    # the first warmup transition captures; 2 × (8 warmup + 1 sample + 6 steps) in all
    assert counts == {"chees.graph_capture": 1, "chees.graph_replay": 2 * 15 - 1}
    for got, want in zip(rerun, eager):
        assert got.keys() == want.keys()
        assert (got["positions"] == want["positions"]).all()
        assert [got[k] for k in ("accept_mean", "divergences", "n_leapfrog")] == \
            [want[k] for k in ("accept_mean", "divergences", "n_leapfrog")]
    for got, want in zip(rerun_q, eager_q):
        assert torch.equal(got, want)


# -- on the card ---------------------------------------------------------------


def _eager_on_the_card(monkeypatch):
    monkeypatch.setattr(hmc, "graph_engages", lambda q, force_fn, discrete: False)


@pytest.mark.gpu
def test_replayed_transitions_equal_the_eager_ones_for_every_L(cuda):
    """Float32 eight-schools, 1,024 chains: one capture (the first call,
    which runs eagerly) and replays for h over the Halton sequence, L from 1
    to 13, each equal to the eager transition bitwise."""
    staged = ftt.stage(eight_schools_model("cuda"), device="cuda")
    Q, z, log_u, eps, T, inv_mass = _inputs("cuda", torch.float32, n_chains=1024)
    graphs = chees.ChEESGraphs()

    def run():
        Ls = set()
        for h in chees.halton_sequence(40).tolist():
            args = (staged.potential, Q, z, log_u, eps, T, h, inv_mass, 1024)
            got = chees.chees_transition(*args, graphs=graphs)
            _assert_same(got, chees.chees_transition(*args))
            Ls.add(got[6])
        return Ls

    Ls, counts = _graph_counts(run)
    assert Ls == set(range(1, 14))
    assert counts == {"chees.graph_capture": 1, "chees.graph_replay": 39}


@pytest.mark.gpu
def test_a_chees_chain_with_its_warmup_replays_as_the_eager_drive_runs(monkeypatch, cuda):
    """A fresh call (20 warmup, 10 samples) captures once and replays the
    other 29 transitions; a resumed call replays all 10; every output
    equals the eager drive's bitwise."""
    kw = dict(n_chains=256, n_samples=10)

    def runs():
        staged = ftt.stage(eight_schools_model("cuda"), device="cuda")
        first, c1 = _graph_counts(lambda: ftt.chees_chain(1, staged=staged, n_warmup=20, **kw))
        second, c2 = _graph_counts(lambda: ftt.chees_chain(2, staged=staged, n_warmup=0,
                                                           resume=first, **kw))
        return (first, second), (c1, c2)

    graph, counts = runs()
    assert counts == ({"chees.graph_capture": 1, "chees.graph_replay": 29},
                      {"chees.graph_replay": 10})
    _eager_on_the_card(monkeypatch)
    eager, eager_counts = runs()
    assert eager_counts == ({}, {})
    for got, want in zip(graph, eager):
        _assert_same_results(got, want)


def _sessions_on_the_card(steps=8):
    staged = ftt.stage(eight_schools_model("cuda"), device="cuda")
    sessions = [ftt.CheesSession(s, staged=staged, n_chains=1024, n_warmup=20) for s in (5, 6)]
    replies = [s.step() for _ in range(steps) for s in sessions]
    return sessions, replies


@pytest.mark.gpu
def test_two_sessions_on_one_model_stepped_in_turns_keep_their_eager_chains(monkeypatch,
                                                                               cuda):
    """Two 1,024-chain sessions of one staged model, with their own step
    size and mass, share one capture and each reproduce their eager chains
    bitwise: no scalar is baked into a capture and no caller keeps a graph's
    output."""
    (sessions, replies), counts = _graph_counts(_sessions_on_the_card)
    assert sessions[0].step_size != sessions[1].step_size
    assert counts == {"chees.graph_capture": 1, "chees.graph_replay": 2 * (20 + 1 + 8) - 1}
    _eager_on_the_card(monkeypatch)
    eager_sessions, eager_replies = _sessions_on_the_card()
    for got, want in zip(replies, eager_replies):
        assert (got["positions"] == want["positions"]).all()
        assert [got[k] for k in ("accept_mean", "divergences", "n_leapfrog")] == \
            [want[k] for k in ("accept_mean", "divergences", "n_leapfrog")]
    for got, want in zip(sessions, eager_sessions):
        assert torch.equal(got.positions, want.positions)


@pytest.mark.gpu
def test_a_potential_that_reads_the_host_falls_back_once(monkeypatch, cuda):
    """A model whose potential reads a device value back to the host cannot
    be captured: the first transition counts one fallback and every later
    one runs eagerly, and the chains equal the eager drive's."""
    y = torch.tensor([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0], device="cuda")
    sigma = torch.tensor([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0], device="cuda")

    def reads_the_host():
        mu = ftt.sample("mu", ftt.Normal(0.0, float(sigma.max()) / 3.6))
        tau = ftt.sample("tau", ftt.LogNormal(0.5, 1.0))
        theta_raw = ftt.sample("theta_raw", ftt.Normal(0.0, 1.0), sample_shape=(8,))
        ftt.observe("y", ftt.Normal(mu + tau * theta_raw, sigma), y)

    def run():
        staged = ftt.stage(reads_the_host, device="cuda")
        return ftt.chees_chain(3, staged=staged, n_chains=64, n_samples=5, n_warmup=10)

    fell_back, counts = _graph_counts(run)
    assert counts == {"chees.graph_fallback": 1}
    _eager_on_the_card(monkeypatch)
    _assert_same_results(fell_back, run())


@pytest.mark.gpu
def test_a_replayed_session_step_makes_no_more_host_syncs_than_the_eager_one(monkeypatch,
                                                                             cuda):
    """A session step reads the positions, the mean acceptance and the
    divergence count: three syncs, replayed or eager."""
    staged = ftt.stage(eight_schools_model("cuda"), device="cuda")
    sess = ftt.CheesSession(7, staged=staged, n_chains=1024, n_warmup=10)
    _, counts = _graph_counts(sess.step)
    assert counts == {"chees.graph_replay": 1}
    replayed = _host_syncs(sess.step)
    _eager_on_the_card(monkeypatch)
    assert replayed == _host_syncs(sess.step) == 3


@pytest.mark.gpu
@pytest.mark.parametrize("d, n, c, eps", [(64, 4096, 256, 0.3), (1024, 100_000, 256, 0.05)],
                         ids=["small", "scale_chees"])
def test_a_gemm_model_replays_within_rounding_of_the_eager_transition(cuda, d, n, c, eps):
    """The logistic model of ``scale_chees`` (split-bf16 products, a GEMM
    over the chains), small and at that phase's shape and correlated
    design: cuBLAS may take another GEMM under capture, so a replay is held
    to float32 rounding of the eager transition rather than bitwise, for
    every L from 1 to 13. The accept decision is held exactly wherever the
    uniform is not within 1e-3 of the acceptance probability."""
    from chip_smoke import correlated_logistic_data, logistic_data, logistic_model

    data = correlated_logistic_data if d == 1024 else logistic_data
    x, y, w_true = data(d, n, seed=3)
    staged = ftt.stage(logistic_model(x, y), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(4)
    Q = w_true + 0.2 * torch.randn((c, d), generator=g, device="cuda")
    z = torch.randn((c, d), generator=g, device="cuda")
    log_u = torch.log(torch.rand((c,), generator=g, device="cuda"))
    eps, T = torch.tensor(eps, device="cuda"), torch.tensor(12.5 * eps, device="cuda")
    inv_mass = 0.5 + torch.rand((d,), generator=g, device="cuda")
    graphs = chees.ChEESGraphs()
    worst = collections.Counter()
    Ls, bitwise = set(), True
    for h in chees.halton_sequence(40).tolist():
        args = (staged.potential, Q, z, log_u, eps, T, h, inv_mass, 1024)
        got = chees.chees_transition(*args, graphs=graphs)
        want = chees.chees_transition(*args)
        Ls.add(got[6])
        bitwise &= all(torch.equal(a, b) for a, b in zip(got, want)
                       if isinstance(a, torch.Tensor))
        for i in (1, 2, 3, 7):  # Q_prop, P_end, accept_prob, U_out
            worst[OUTPUTS[i]] = max(worst[OUTPUTS[i]], float((got[i] - want[i]).abs().max()))
        clear = (torch.exp(log_u) - want[3]).abs() > 1e-3
        assert torch.equal(got[4][clear], want[4][clear]) and torch.equal(got[5], want[5])
        same = got[4] == want[4]
        worst["Q_out"] = max(worst["Q_out"], float((got[0] - want[0])[same].abs().max()))
    print(f"gemm replay against eager, d = {d}: bitwise {bitwise}, largest differences "
          f"{dict(worst)}, mean acceptance {float(want[3].mean()):.3f}")
    assert Ls == set(range(1, 14))
    assert max(worst[k] for k in ("Q_out", "Q_prop", "P_end", "accept_prob")) <= 1e-4
    assert worst["U_out"] <= 1e-5 * float(want[7].abs().max())
