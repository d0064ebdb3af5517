"""The program's spans and named host reads (``fugue_tpu_torch/utils/profiling.py``)
on the CPU: recorded only while a ``torch.profiler`` session runs, from every
thread, on the profiler's own clock, in a bounded buffer; the drives' and
the service's spans and read sites; ``device_trace``'s export; and the
benchmark's readers of them (``perfbench/metrics/``) on synthetic runs.

The same spans beside the card's kernels are held in
``tests/test_torch_gpu.py::test_traced_hmc_call_records_one_potential_span_per_gradient``.
"""

import collections
import http.client
import json
import sys
import threading
import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

import fugue_tpu_torch as ftt
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference.chees import CheesSession
from fugue_tpu_torch.serve import FugueService, serve
from fugue_tpu_torch.utils import profiling
from fugue_tpu_torch.utils.profiling import Count, Recorder, Span
from perfbench import harness
from perfbench.trace import DeviceOp, Trace

NORMAL3 = ('let mu <- sample("mu", normal(0.0, 2.0));'
           'for i in 0..3 { observe(("y", i), normal(mu, 1.0), ys[i]); }'
           'return mu;')


@pytest.fixture(autouse=True)
def _x64_and_empty_buffer():
    settings.enable_x64(True)
    profiling.clear()
    yield
    settings.enable_x64(False)
    profiling.clear()


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _spans(recs, name=None):
    return [r for r in recs if isinstance(r, Span) and (name is None or r.name == name)]


def _reads(recs):
    sites = collections.Counter()
    for r in recs:
        if isinstance(r, Count) and r.name == "host_read":
            sites[r.attrs["site"]] += r.n
    return dict(sites)


def _everything():
    return profiling.records(0, 2**63)


def normal_model():
    mu = ftt.sample("mu", ftt.Normal(torch.tensor(0.0, dtype=torch.float64), 2.0))
    sd = ftt.sample("sd", ftt.LogNormal(torch.tensor(0.0, dtype=torch.float64), 1.0))
    ftt.observe("y", ftt.Normal(mu, sd), torch.tensor([0.5, 1.5, 1.0], dtype=torch.float64))
    return mu


# -- the recorder ------------------------------------------------------------


def test_the_profilers_process_wide_flag_is_there():
    """The recorder reads this flag; an upgrade of PyTorch that drops it
    would turn the program's tracing off without a word."""
    from torch.autograd import profiler

    assert profiler._is_profiler_enabled is False
    with _session():
        assert profiler._is_profiler_enabled is True
    assert profiler._is_profiler_enabled is False


def test_nothing_is_recorded_outside_a_profiler_session():
    off = profiling.span("potential")
    assert off is profiling.span("other", request=3, k=1)  # one shared object, no record
    with off:
        profiling.count("x")
        profiling.host_read("site")
    assert _everything() == []


def test_spans_and_counts_are_recorded_from_a_thread_started_in_the_session():
    seen = {}

    def worker():
        seen["thread"] = threading.get_native_id()
        seen["per_thread_flag"] = torch._C._autograd._profiler_enabled()
        with profiling.span("in.thread", k=1):
            profiling.count("items", 3, kind="a")

    with _session():
        with profiling.span("in.main"):
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=30)
    assert not th.is_alive()
    assert seen["per_thread_flag"] is False  # why the recorder reads the process-wide flag
    recs = _everything()
    (main,), (other,) = _spans(recs, "in.main"), _spans(recs, "in.thread")
    (items,) = [r for r in recs if isinstance(r, Count)]
    assert other.thread == seen["thread"] != main.thread
    assert other.parent is None and other.attrs == {"k": 1}
    assert (items.name, items.n, items.attrs, items.thread) == ("items", 3, {"kind": "a"},
                                                                 seen["thread"])
    assert main.start <= other.start <= items.time <= other.end <= main.end


def test_spans_nest_with_parent_ids_and_inherit_the_request_id():
    with _session():
        with profiling.span("a", request=7) as a:
            assert profiling.request_id() == 7
            with profiling.span("b") as b:
                with profiling.span("c"):
                    pass
            with profiling.span("d", request=8):
                pass
        with profiling.span("e"):
            pass
    assert profiling.request_id() is None
    got = {s.name: s for s in _everything()}
    assert got["a"].id == a.id and got["b"].id == b.id
    assert [got[k].parent for k in "abcde"] == [None, a.id, b.id, a.id, None]
    assert [got[k].request for k in "abcde"] == [7, 7, 7, 8, None]
    assert len({s.id for s in got.values()}) == 5
    assert got["a"].start <= got["b"].start <= got["c"].start <= got["c"].end <= got["b"].end


def test_a_span_contains_its_record_function_range_on_the_profilers_clock():
    with _session() as prof:
        with profiling.span("outer"):
            with record_function("pb.inner"):
                torch.mm(torch.ones(16, 16), torch.ones(16, 16))
    (outer,) = _spans(_everything(), "outer")
    (inner,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "pb.inner" and e.device_type() == DeviceType.CPU]
    assert outer.start <= inner.start_ns() <= inner.end_ns() <= outer.end


def test_records_selects_by_start_time():
    with _session():
        with profiling.span("first"):
            pass
        t = time.time_ns()
        profiling.count("late")
    recs = profiling.records(t, 2**63)
    assert [r.name for r in recs] == ["late"]
    assert [r.name for r in profiling.records(0, t - 1)] == ["first"]


def test_the_buffer_drops_the_oldest_records_and_counts_them():
    rec = Recorder(capacity=4)
    with _session():
        for i in range(6):
            rec.count("c", i)
    assert [r.n for r in rec.records(0, 2**63)] == [2, 3, 4, 5]
    assert rec.dropped == 2
    rec.clear()
    assert rec.records(0, 2**63) == [] and rec.dropped == 0


def test_threads_recording_at_once_lose_no_record():
    """More threads than cores, switching every microsecond: every span
    and count is kept, ids are unique and each span's parent ran on its own
    thread."""
    rec = Recorder(capacity=1 << 16)
    n_threads, n_each = 16, 200
    switch = sys.getswitchinterval()

    def worker():
        for i in range(n_each):
            with rec.span("outer", request=i):
                with rec.span("inner"):
                    rec.count("c")

    sys.setswitchinterval(1e-6)
    try:
        with _session():
            threads = [threading.Thread(target=worker) for _ in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    recs = rec.records(0, 2**63)
    spans = _spans(recs)
    assert len(spans) == 2 * n_threads * n_each and rec.dropped == 0
    assert sum(isinstance(r, Count) for r in recs) == n_threads * n_each
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        if s.name == "inner":
            parent = by_id[s.parent]
            assert parent.name == "outer" and parent.thread == s.thread
            assert parent.request == s.request


def test_device_trace_writes_the_programs_records_into_its_chrome_trace(tmp_path):
    with profiling.span("before"):  # no session yet: not recorded
        pass
    with profiling.device_trace(str(tmp_path), device="cpu"):
        with profiling.span("potential", k="v"):
            torch.mm(torch.ones(32, 32), torch.ones(32, 32))
        profiling.host_read("here")
    (path,) = tmp_path.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    program = [e for e in events if e.get("cat") == "program"]
    assert [(e["name"], e["ph"]) for e in program] == [("potential", "X"), ("host_read", "i")]
    span, read = program
    assert span["args"]["k"] == "v" and read["args"] == {"site": "here", "n": 1}
    # on the trace's own time base: the product ran inside the span
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert span["ts"] <= mm["ts"] <= mm["ts"] + mm["dur"] <= span["ts"] + span["dur"]
    assert span["tid"] == mm["tid"]


# -- the drives and the service ---------------------------------------------


def test_a_resumed_hmc_chain_names_its_one_host_read():
    staged = ftt.stage(normal_model, device="cpu")
    cfg = ftt.HMCConfig(n_leapfrog=4)
    first = ftt.hmc_chain(1, staged=staged, n_chains=8, n_samples=2, n_warmup=10, config=cfg)
    with _session():
        ftt.hmc_chain(2, staged=staged, n_chains=8, n_samples=3, n_warmup=0, config=cfg,
                      resume=first)
    recs = _everything()
    assert _reads(recs) == {"hmc_chain.step_size": 1}
    steps = _spans(recs, "hmc.transition")
    potentials = _spans(recs, "potential")
    assert len(steps) == 3 and len(potentials) == 3 * (4 + 1)
    assert {p.parent for p in potentials} == {s.id for s in steps}


def test_a_fresh_hmc_chain_names_the_step_size_search_and_warmup():
    staged = ftt.stage(normal_model, device="cpu")
    with _session():
        ftt.hmc_chain(3, staged=staged, n_chains=4, n_samples=2, n_warmup=6,
                      config=ftt.HMCConfig(n_leapfrog=2))
    recs = _everything()
    reads = _reads(recs)
    assert reads.pop("hmc_chain.step_size") == 1
    assert reads.pop("find_reasonable_epsilon.h0") == 1
    assert reads.pop("find_reasonable_epsilon.h") >= 1
    assert reads == {}
    assert len(_spans(recs, "hmc.transition")) == 6 + 2


def test_the_async_nuts_drive_names_one_read_per_chunk():
    staged = ftt.stage(normal_model, device="cpu")
    cfg = ftt.NUTSConfig(max_depth=3)
    first = ftt.nuts_chain(1, staged=staged, n_chains=4, n_samples=1, n_warmup=10, config=cfg)
    with _session():
        res = ftt.nuts_chain(2, staged=staged, n_chains=4, n_samples=3, n_warmup=0, config=cfg,
                             resume=first)
    recs = _everything()
    assert _reads(recs) == {"nuts.sampling.any_running": res.host_syncs,
                            "nuts_chain.step_size": 1, "nuts_chain.n_leapfrogs": 1}
    iterations = _spans(recs, "nuts.iteration")
    assert len(iterations) == res.lockstep_leaves
    # every iteration is one batched gradient, the first tree's root one more
    potentials = _spans(recs, "potential")
    assert len(potentials) == res.lockstep_leaves + 1
    assert sum(p.parent in {i.id for i in iterations} for p in potentials) == len(iterations)


def test_a_chees_session_step_names_its_three_reads():
    staged = ftt.stage(normal_model, device="cpu")
    sess = CheesSession(4, staged=staged, n_chains=8, n_warmup=10)
    with _session():
        out = sess.step()
    recs = _everything()
    # step size and trajectory length are host floats: tau needs no read
    assert _reads(recs) == {"chees_session.positions": 1, "chees_session.accept_mean": 1,
                            "chees_session.divergences": 1}
    (step,) = _spans(recs, "chees.transition")
    potentials = _spans(recs, "potential")
    assert len(potentials) == out["n_leapfrog"] + 1
    assert {p.parent for p in potentials} == {step.id}


def test_a_chees_chain_reads_tau_once_per_transition():
    staged = ftt.stage(normal_model, device="cpu")
    with _session():
        res = ftt.chees_chain(5, staged=staged, n_chains=8, n_samples=3, n_warmup=4)
    reads = _reads(_everything())
    assert reads.pop("chees.tau") == res.host_syncs == 7
    assert reads.pop("find_reasonable_epsilon.h0") == 1
    assert reads.pop("find_reasonable_epsilon.h") >= 1
    assert reads == {"chees_chain.trajectory_length": 1, "chees_chain.step_size": 1}


def test_an_smc_run_nests_its_stages_moves_and_potentials():
    """``smc.run`` ⊃ ``smc.stage`` ⊃ ``smc.reweight``, ``smc.resample`` and
    ``smc.move`` ⊃ ``potential``; one ``smc.stage`` count and one
    ``smc.beta`` read per stage, inside it; one ``smc.result`` read."""
    staged = ftt.stage(normal_model, device="cpu")
    cfg = ftt.SMCConfig(rejuvenation="hmc", rejuvenation_steps=2, hmc_leapfrog=3)
    with _session():
        res = ftt.adaptive_smc(3, 256, config=cfg, staged=staged)
    recs = _everything()
    n = res.n_stages
    assert res.converged and n >= 2
    (run,) = _spans(recs, "smc.run")
    stages = _spans(recs, "smc.stage")
    assert len(stages) == n and all(s.parent == run.id for s in stages)
    assert sum(r.n for r in recs if isinstance(r, Count) and r.name == "smc.stage") == n
    ids = {s.id for s in stages}
    assert len(_spans(recs, "smc.reweight")) == n
    for name in ("smc.reweight", "smc.resample", "smc.move"):
        assert all(s.parent in ids for s in _spans(recs, name))
    moves = _spans(recs, "smc.move")
    assert len(moves) == len(_spans(recs, "smc.resample")) == n - 1
    potentials = _spans(recs, "potential")
    assert len(potentials) == (n - 1) * cfg.rejuvenation_steps * (cfg.hmc_leapfrog + 1)
    assert {p.parent for p in potentials} == {m.id for m in moves}
    assert _reads(recs) == {"smc.beta": n, "smc.result": 1}
    beta_reads = [r for r in recs if isinstance(r, Count) and r.attrs.get("site") == "smc.beta"]
    assert all(any(s.start <= r.time <= s.end for s in stages) for r in beta_reads)
    for s in stages + moves + potentials:
        assert run.start <= s.start <= s.end <= run.end
    profiling.clear()
    ftt.adaptive_smc(4, 256, config=cfg, staged=staged)
    assert _everything() == []


def test_a_resumed_smc_run_names_its_read_of_beta():
    staged = ftt.stage(normal_model, device="cpu")
    first = ftt.adaptive_smc(3, 128, config=ftt.SMCConfig(max_stages=1), staged=staged)
    assert not first.converged
    with _session():
        res = ftt.adaptive_smc(3, 128, config=ftt.SMCConfig(), staged=staged, resume=first)
    reads = _reads(_everything())
    assert reads == {"smc.resume_beta": 1, "smc.beta": res.n_stages - 1, "smc.result": 1}


def _service_spans(recs):
    return {name: _spans(recs, name) for name in
            ("serve.request", "serve.lock_wait", "serve.method", "serve.reply")}


def test_handle_without_a_transport_gives_its_spans_one_request_id():
    svc = FugueService(seed=0, device="cpu")
    mid = svc.handle({"method": "compile", "params": {"source": NORMAL3,
                                                      "data": {"ys": [1.0, 1.2, 0.8]}}})
    sid = svc.handle({"method": "mh.new", "params": {"model_id": mid["result"]["model_id"],
                                                     "n_chains": 4}})["result"]["session_id"]
    with _session():
        out = svc.handle({"method": "mh.step", "params": {"session_id": sid, "n": 2}})
        svc.handle({"method": "methods"})
    assert "result" in out
    got = _service_spans(_everything())
    assert got["serve.request"] == []
    assert [len(got[k]) for k in ("serve.lock_wait", "serve.method", "serve.reply")] == [2, 2, 2]
    first = {k: v[0] for k, v in got.items() if v}
    assert len({s.request for s in first.values()}) == 1
    assert {s.request for s in got["serve.method"]} == {s.request for s in got["serve.reply"]}
    assert len({s.request for s in got["serve.method"]}) == 2
    assert first["serve.method"].attrs == {"method": "mh.step"}
    assert first["serve.lock_wait"].end <= first["serve.method"].start
    assert first["serve.method"].end <= first["serve.reply"].start
    assert _reads(_everything()) == {"mh_session.step": 1}


def test_http_requests_keep_their_request_ids_apart():
    """Two clients at once: each ``serve.request`` holds its own lock wait,
    method and reply, all with its id, in its handler thread."""
    svc = FugueService(seed=0, device="cpu")
    httpd = serve(port=0, service=svc, block=False)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    port = httpd.server_address[1]

    def post(method, **params):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.request("POST", "/", body=json.dumps({"method": method, "params": params}))
            return json.loads(conn.getresponse().read())["result"]
        finally:
            conn.close()

    try:
        mid = post("compile", source=NORMAL3, data={"ys": [1.0, 1.2, 0.8]})["model_id"]
        sids = [post("hmc.new", model_id=mid, seed=i)["session_id"] for i in range(2)]
        replies = [None, None]

        def client(i):
            replies[i] = [post("hmc.step", session_id=sids[i]) for _ in range(3)]

        with _session():
            clients = [threading.Thread(target=client, args=(i,)) for i in range(2)]
            for th in clients:
                th.start()
            for th in clients:
                th.join(timeout=120)
        assert not any(th.is_alive() for th in clients)
    finally:
        httpd.shutdown()
        httpd.server_close()
    server.join(timeout=30)
    assert not server.is_alive()
    assert all(len(r) == 3 for r in replies)
    got = _service_spans(_everything())
    requests = {s.request: s for s in got["serve.request"]}
    assert len(requests) == len(got["serve.request"]) == 6
    for name in ("serve.lock_wait", "serve.method", "serve.reply"):
        assert sorted(s.request for s in got[name]) == sorted(requests)
        for s in got[name]:
            outer = requests[s.request]
            assert s.parent == outer.id and s.thread == outer.thread
            assert outer.start <= s.start <= s.end <= outer.end
    assert _reads(_everything()) == {"serve.hmc_step": 18, "serve.reply": 6}


# -- the benchmark's readers -------------------------------------------------

W0 = 1_000_000_000


def _run(recs, workload="eight_schools_nc.hmc", ops=(), transitions=2, monkeypatch=None):
    rec = Recorder()
    for r in recs:
        rec._append(r)
    monkeypatch.setattr(profiling, "records", rec.records)
    trace = Trace(ops=list(ops), spans={}, window=(W0, W0 + 100_000_000))
    return SimpleNamespace(trace=trace, workload={"traffic": workload.split(".")[1]},
                           name=workload, counters={"trace": {"transitions": transitions}})


def _span(name, start_ms, end_ms, sid, parent=None, request=None):
    return Span(name, W0 + int(start_ms * 1e6), W0 + int(end_ms * 1e6), sid, parent, request,
                1, {})


def _read(metric, run):
    return harness.metric(metric).read(run)


def test_readers_return_none_without_program_records(monkeypatch):
    run = _run([], monkeypatch=monkeypatch)
    for m in ("potential.host_ms_per_grad", "hmc.drive_host_ms_per_transition",
              "drive.host_reads_per_transition", "serve.lock_queue_ms",
              "serve.reply_in_lock_ms", "dsl.host_ms_per_grad",
              "serve.idle_outside_method_share"):
        assert _read(m, run) is None
        assert _read(m, SimpleNamespace(trace=None, counters={})) is None


def test_potential_host_ms_per_grad_reader(monkeypatch):
    recs = [_span("potential", 1, 3, 2, parent=1), _span("potential", 4, 8, 3, parent=1),
            _span("hmc.transition", 0, 10, 1), _span("potential", 200, 300, 9)]
    assert _read("potential.host_ms_per_grad", _run(recs, monkeypatch=monkeypatch)) == \
        pytest.approx(3.0)


def test_hmc_drive_host_ms_per_transition_reader(monkeypatch):
    recs = [_span("potential", 1, 3, 2, parent=1), _span("potential", 4, 8, 3, parent=1),
            _span("hmc.transition", 0, 10, 1), _span("potential", 11, 12, 5, parent=4),
            _span("hmc.transition", 10, 20, 4), _span("potential", 30, 40, 6)]
    # (10 - 2 - 4) and (10 - 1) over two transitions
    assert _read("hmc.drive_host_ms_per_transition", _run(recs, monkeypatch=monkeypatch)) == \
        pytest.approx(6.5)


def test_drive_host_reads_per_transition_reader(monkeypatch):
    recs = [Count("host_read", W0 + 5, 1, 1, {"site": "a"}),
            Count("host_read", W0 + 6, 2, 1, {"site": "b"}),
            Count("other", W0 + 7, 5, 1, {}), Count("host_read", W0 - 1, 1, 1, {"site": "a"})]
    run = _run(recs, transitions=2, monkeypatch=monkeypatch)
    assert _read("drive.host_reads_per_transition", run) == pytest.approx(1.5)


def test_serve_lock_queue_and_reply_readers(monkeypatch):
    recs = [_span("serve.lock_wait", 1, 3, 1, request=1), _span("serve.lock_wait", 2, 8, 2,
                                                                 request=2),
            _span("serve.reply", 10, 11, 3, request=1), _span("serve.reply", 20, 23, 4,
                                                              request=2)]
    run = _run(recs, workload="eight_schools_nc.serve", monkeypatch=monkeypatch)
    assert _read("serve.lock_queue_ms", run) == pytest.approx(4.0)
    assert _read("serve.reply_in_lock_ms", run) == pytest.approx(2.0)


def test_dsl_host_ms_per_grad_reader(monkeypatch):
    recs = [_span("potential", 1, 6, 2, parent=1), _span("potential", 6, 7, 3, parent=1),
            _span("chees.transition", 0, 10, 1)]
    run = _run(recs, workload="eight_schools_nc.serve", monkeypatch=monkeypatch)
    assert _read("dsl.host_ms_per_grad", run) == pytest.approx(3.0)


def test_serve_idle_outside_method_share_reader(monkeypatch):
    ms = 1_000_000
    # device busy over [10, 20) and [50, 60) ms of a 100 ms window: 80 ms idle;
    # methods open over [0, 30) and [25, 55) ms cover 10 + 30 + 0 = 40 ms of it
    ops = [DeviceOp("k", W0 + 10 * ms, W0 + 20 * ms, W0 + 10 * ms),
           DeviceOp("k", W0 + 50 * ms, W0 + 60 * ms, W0 + 50 * ms)]
    recs = [_span("serve.method", 0, 30, 1), _span("serve.method", 25, 55, 2),
            _span("serve.request", 0, 99, 3)]
    run = _run(recs, workload="eight_schools_nc.serve", ops=ops, monkeypatch=monkeypatch)
    assert _read("serve.idle_outside_method_share", run) == pytest.approx(50.0)


def test_hmc_graph_replay_share_reader(monkeypatch):
    recs = [Count("hmc.graph_replay", W0 + 5, 1, 1, {}),
            Count("hmc.graph_replay", W0 + 6, 1, 1, {}),
            Count("hmc.graph_capture", W0 + 7, 1, 1, {}),
            Count("hmc.graph_replay", W0 - 1, 1, 1, {}),
            Count("host_read", W0 + 8, 1, 1, {"site": "a"})]
    run = _run(recs, transitions=4, monkeypatch=monkeypatch)
    assert _read("hmc.graph_replay_share", run) == pytest.approx(50.0)
    eager = _run([Count("host_read", W0 + 8, 1, 1, {"site": "a"})], transitions=4,
                 monkeypatch=monkeypatch)
    assert _read("hmc.graph_replay_share", eager) == 0.0
    assert _read("hmc.graph_replay_share", _run([], monkeypatch=monkeypatch)) is None
    assert _read("hmc.graph_replay_share", SimpleNamespace(trace=None, counters={})) is None


def test_hmc_graph_replay_share_reader_is_silent_on_a_program_without_the_graph(monkeypatch):
    from fugue_tpu_torch.inference import hmc

    monkeypatch.delattr(hmc, "TransitionGraphs")
    run = _run([Count("hmc.graph_replay", W0 + 5, 1, 1, {})], transitions=2,
               monkeypatch=monkeypatch)
    assert _read("hmc.graph_replay_share", run) is None


def test_chees_graph_replay_share_reader(monkeypatch):
    recs = [_span("chees.transition", 0, 1, 1), _span("chees.transition", 2, 3, 2),
            _span("chees.transition", 4, 5, 3), _span("chees.transition", 6, 7, 4),
            _span("chees.transition", -5, -4, 5), _span("potential", 8, 9, 6),
            Count("chees.graph_replay", W0 + 5, 1, 1, {}),
            Count("chees.graph_replay", W0 + 6, 1, 1, {}),
            Count("chees.graph_replay", W0 + 7, 1, 1, {}),
            Count("chees.graph_capture", W0 + 8, 1, 1, {}),
            Count("chees.graph_replay", W0 - 1, 1, 1, {})]
    run = _run(recs, workload="eight_schools_nc.serve", monkeypatch=monkeypatch)
    assert _read("chees.graph_replay_share", run) == pytest.approx(75.0)
    eager = _run([_span("chees.transition", 0, 1, 1)], workload="eight_schools_nc.serve",
                 monkeypatch=monkeypatch)
    assert _read("chees.graph_replay_share", eager) == 0.0
    no_transition = _run([Count("chees.graph_replay", W0 + 5, 1, 1, {})],
                         workload="eight_schools_nc.serve", monkeypatch=monkeypatch)
    assert _read("chees.graph_replay_share", no_transition) is None
    assert _read("chees.graph_replay_share", SimpleNamespace(trace=None, counters={})) is None


def test_chees_graph_replay_share_reader_is_silent_on_a_program_without_the_graphs(
        monkeypatch):
    from fugue_tpu_torch.inference import chees

    monkeypatch.delattr(chees, "ChEESGraphs")
    run = _run([_span("chees.transition", 0, 1, 1)], workload="eight_schools_nc.serve",
               monkeypatch=monkeypatch)
    assert _read("chees.graph_replay_share", run) is None


def _smc_run(recs, monkeypatch, ops=(), chains=1000):
    run = _run(recs, workload="gmm_mixture.smc", ops=ops, monkeypatch=monkeypatch)
    run.cell = {"chains": chains}
    return run


def _smc_stage(start_ms, end_ms, sid, run_id=1):
    return _span("smc.stage", start_ms, end_ms, sid, parent=run_id)


def test_smc_readers_return_none_without_program_records(monkeypatch):
    run = _smc_run([], monkeypatch)
    for m in ("smc.stages_per_run", "smc.host_ms_per_stage", "smc.host_reads_per_stage",
              "smc.move_device_ms_per_grad", "smc.logsumexp_roofline",
              "smc.resample_roofline"):
        assert _read(m, run) is None
        assert _read(m, SimpleNamespace(trace=None, counters={}, cell={})) is None


def test_smc_stages_per_run_reader(monkeypatch):
    recs = [_span("smc.run", 0, 50, 1), Count("smc.stage", W0 + 1, 1, 1, {}),
            Count("smc.stage", W0 + 2, 1, 1, {}), Count("smc.stage", W0 + 3, 1, 1, {}),
            _span("smc.run", 50, 90, 9), Count("smc.stage", W0 + 60_000_000, 1, 1, {})]
    assert _read("smc.stages_per_run", _smc_run(recs, monkeypatch)) == pytest.approx(2.0)


def test_smc_host_ms_per_stage_reader(monkeypatch):
    # stage 2 (10 ms) holds a move with potentials of 2 + 3 ms; stage 5 (6 ms) none
    recs = [_span("smc.run", 0, 40, 1), _smc_stage(0, 10, 2), _span("smc.move", 4, 10, 3, 2),
            _span("potential", 4, 6, 4, 3), _span("potential", 6, 9, 6, 3),
            _smc_stage(10, 16, 5), _span("potential", 20, 30, 7)]
    assert _read("smc.host_ms_per_stage", _smc_run(recs, monkeypatch)) == pytest.approx(5.5)


def test_smc_host_reads_per_stage_reader(monkeypatch):
    ms = 1_000_000
    recs = [_smc_stage(0, 10, 2), _smc_stage(10, 20, 3),
            Count("host_read", W0 + 5 * ms, 1, 1, {"site": "smc.beta"}),
            Count("host_read", W0 + 15 * ms, 1, 1, {"site": "smc.beta"}),
            Count("host_read", W0 + 16 * ms, 2, 1, {"site": "x"}),
            Count("host_read", W0 + 16 * ms, 1, 7, {"site": "another thread"}),
            Count("host_read", W0 + 30 * ms, 1, 1, {"site": "smc.result"})]
    assert _read("smc.host_reads_per_stage", _smc_run(recs, monkeypatch)) == pytest.approx(2.0)


def test_smc_move_device_ms_per_grad_reader(monkeypatch):
    ms = 1_000_000
    recs = [_smc_stage(0, 40, 2), _span("smc.move", 10, 40, 3, 2),
            _span("potential", 10, 20, 4, 3), _span("potential", 20, 30, 5, 3),
            _span("potential", 50, 60, 6)]
    ops = [DeviceOp("k", W0 + 12 * ms, W0 + 15 * ms, W0 + 11 * ms),
           DeviceOp("k", W0 + 25 * ms, W0 + 26 * ms, W0 + 21 * ms),
           DeviceOp("k", W0 + 31 * ms, W0 + 39 * ms, W0 + 31 * ms),
           DeviceOp("k", W0 + 51 * ms, W0 + 59 * ms, W0 + 51 * ms)]
    run = _smc_run(recs, monkeypatch, ops=ops)
    assert _read("smc.move_device_ms_per_grad", run) == pytest.approx(2.0)


def _plane_call(ms, thread=1):
    return Count("density.normal_plane", W0 + int(ms * 1e6), 1, thread, {})


@pytest.mark.parametrize("calls, want", [
    # two calls in each of the move's two gradients; one in a potential
    # outside any move, one on another thread, one between spans: not counted
    ([11, 12, 21, 22, 55, (23, 7), 35], 2.0),
    ([11, 12, 21], 1.5),
    ([55, (23, 7)], 0.0),
    ([], None),  # a program without the kernel's count (the parent) reads nothing
], ids=["two_per_gradient", "uneven", "none_inside", "no_counts"])
def test_density_normal_plane_per_grad_reader(calls, want, monkeypatch):
    recs = [_smc_stage(0, 40, 2), _span("smc.move", 10, 40, 3, 2),
            _span("potential", 10, 20, 4, 3), _span("potential", 20, 30, 5, 3),
            _span("potential", 50, 60, 6)]
    recs += [_plane_call(*c) if isinstance(c, tuple) else _plane_call(c) for c in calls]
    got = _read("density.normal_plane_per_grad", _smc_run(recs, monkeypatch))
    assert got == (None if want is None else pytest.approx(want))


def test_density_normal_plane_per_grad_reader_without_moves(monkeypatch):
    recs = [_span("potential", 10, 20, 4), _plane_call(11)]
    assert _read("density.normal_plane_per_grad", _smc_run(recs, monkeypatch)) is None
    assert _read("density.normal_plane_per_grad",
                 SimpleNamespace(trace=None, counters={}, cell={})) is None


def test_smc_roofline_readers(monkeypatch):
    """Least bytes over the HBM rate over the kernels' device time: 2 calls
    of each at N = 1,000 take 2 µs (logsumexp) and 4 µs (resample)."""
    from perfbench.peaks import HBM_BYTES_PER_S

    us = 1_000
    names = {"lse_partial": "void (anonymous namespace)::lse_partial<float>(float const*, long, "
                            "fugue_lse::Part*)",
             "lse_finish": "void (anonymous namespace)::lse_finish<float>(fugue_lse::Part const*, "
                           "long, float*)",
             "lse_parts": "void (anonymous namespace)::lse_parts<float>(float const*, long, "
                          "fugue_lse::Part*, unsigned long*, long, unsigned long long*)",
             "emit": "void (anonymous namespace)::emit<float>(float const*, float const*, ...)"}
    ops, t = [], W0
    for name, dur in [("lse_partial", 0.7), ("lse_finish", 0.3)] * 2 + \
            [("lse_parts", 0.5), ("emit", 1.5)] * 2 + [("elementwise_kernel", 9.0)]:
        ops.append(DeviceOp(names.get(name, name), t, t + int(dur * us), t))
        t += 10 * us
    run = _smc_run([], monkeypatch, ops=ops, chains=1000)
    lse = 100.0 * 2 * (4 * 1000 + 4) / HBM_BYTES_PER_S / 2e-6
    resample = 100.0 * 2 * (12 * 1000) / HBM_BYTES_PER_S / 4e-6
    assert _read("smc.logsumexp_roofline", run) == pytest.approx(lse)
    assert _read("smc.resample_roofline", run) == pytest.approx(resample)
    assert _read("device.idle_share.smc", run) == pytest.approx(100.0 * (1 - 15e-6 / 0.1))
