"""Serving traffic: interactive users of the JSON-RPC service, as the
browser clients of ``docs/explorables/`` are, each waiting for its reply.

Cell parameters: ``clients`` (a closed loop of that many clients, each
with its own session), ``chains`` and ``warmup`` of each ``chees.new``
session, ``steps`` (the ``n`` of each ``chees.step`` request),
``trace_seconds`` (the traced stretch of requests after the window),
``config_args`` (for tests at a small size).

Set-up: the port's ``serve(port=0, block=False)`` in this process on
localhost, the configuration's DSL model compiled through ``compile``,
one ``chees.new`` session per client (its warmup runs there), and one
request per session. Window: every client sends ``chees.step`` to its
session over HTTP, back to back, until ``--seconds`` have passed; the
window ends with the last reply. ``request_p95_ms`` is the 95th percentile
of every request's client-side latency.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import checks
from perfbench.harness import derived_seed
from perfbench.trace import spanned, traced


class Client:
    """One HTTP client of the service: a new connection per request, as a
    browser's fetch without keep-alive."""

    def __init__(self, port: int):
        self.port = port

    def __call__(self, method: str, **params):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=300)
        try:
            conn.request("POST", "/", body=json.dumps({"method": method, "params": params}),
                         headers={"Content-Type": "application/json"})
            return json.loads(conn.getresponse().read())
        finally:
            conn.close()


def _result(reply):
    if "error" in reply:
        raise RuntimeError(f"service error: {reply['error']}")
    return reply["result"]


def _timed_service(service, lock_waits: list):
    """Wrap this service instance's ``handle`` and its ``chees.step`` method:
    each request appends (time in handle) - (time in the method)."""
    local = threading.local()
    method = service.methods["chees.step"]
    handle = service.handle

    def timed_method(params):
        t = time.perf_counter()
        try:
            return method(params)
        finally:
            local.method_s = time.perf_counter() - t

    def timed_handle(request):
        local.method_s = None
        t = time.perf_counter()
        out = handle(request)
        total = time.perf_counter() - t
        if local.method_s is not None:
            lock_waits.append(total - local.method_s)
        return out

    service.methods["chees.step"] = timed_method
    service.handle = timed_handle


def setup(run):
    from fugue_tpu_torch.serve import FugueService, serve

    c = run.cell
    service = FugueService(seed=derived_seed(run.seed, 1), device=run.device)
    lock_waits = []
    _timed_service(service, lock_waits)
    httpd = serve(port=0, service=service, block=False)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    client = Client(httpd.server_address[1])
    mid = _result(client("compile", source=run.config.DSL, data=run.config.DSL_DATA))["model_id"]
    sessions = [_result(client("chees.new", model_id=mid, n_chains=c["chains"],
                               n_warmup=c["warmup"], seed=derived_seed(run.seed, 2, i)))
                ["session_id"] for i in range(c["clients"])]
    for sid in sessions:
        _result(client("chees.step", session_id=sid, n=c["steps"]))
    run.state = SimpleNamespace(service=service, httpd=httpd, thread=thread, port=client.port,
                                model_id=mid, sessions=sessions, lock_waits=lock_waits)


def _loop(run, seconds: float, keep: bool):
    """Every client sends back to back until ``seconds`` have passed; (the
    window's length, [(latency, positions or None, ok)] per client)."""
    s, c = run.state, run.cell
    records = [[] for _ in s.sessions]
    t_start = time.perf_counter()

    def client_loop(i):
        client = Client(s.port)
        while time.perf_counter() - t_start < seconds:
            t = time.perf_counter()
            reply = client("chees.step", session_id=s.sessions[i], n=c["steps"])
            lat = time.perf_counter() - t
            ok = "result" in reply
            pos = np.asarray(reply["result"]["positions"], np.float64) if ok and keep else None
            records[i].append((lat, pos, ok))

    threads = [threading.Thread(target=client_loop, args=(i,)) for i in range(len(s.sessions))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return time.perf_counter() - t_start, records


def window(run):
    s = run.state
    del s.lock_waits[:]
    run.window_s, records = _loop(run, run.seconds, keep=True)
    lat = [r[0] for rec in records for r in rec]
    run.attempted = len(lat)
    run.failed = sum(1 for rec in records for r in rec if not r[2])
    run.e2e = {"request_p95_ms": 1e3 * float(np.percentile(lat, 95))}
    run.counters.update(latencies_s=lat, lock_waits_s=list(s.lock_waits), requests=len(lat))
    # each session's chains over its replies, to the fewest replies a
    # session got: (C, steps, d)
    steps = min(sum(1 for r in rec if r[2]) for rec in records)
    s.positions = [np.stack([r[1] for r in rec if r[2]][:steps], axis=1) for rec in records]


def trace(run):
    """``trace_seconds`` more of the same requests under the profiler, then
    one batched value-and-gradient of the DSL model on its own."""
    from fugue_tpu_torch.inference.hmc import batched_force

    s, c = run.state, run.cell
    svc = s.service
    handle, step = svc.handle, svc.methods["chees.step"]
    svc.handle = spanned("pb.handle", handle)  # a request inside the service
    svc.methods["chees.step"] = spanned("pb.chees.step", step)  # the method, lock held
    try:
        _, tr = traced(lambda: _loop(run, c["trace_seconds"], keep=False))
    finally:
        svc.handle, svc.methods["chees.step"] = handle, step
    run.trace = tr
    staged = s.service._models[s.model_id][2]
    q = torch.as_tensor(s.positions[0][:, -1], dtype=torch.float32, device=run.device)
    force = spanned("pb.potential", batched_force(staged.potential))
    force(q)
    _, one = traced(lambda: force(q))
    run.counters["dsl_kernels_per_grad"] = len(one.in_span("pb.potential"))


def _stop(run):
    s = run.state
    s.httpd.shutdown()
    s.httpd.server_close()
    s.thread.join(timeout=60)


def check(run):
    from fugue_tpu_torch.inference.hmc import batched_force

    s = run.state
    _stop(run)
    positions = np.concatenate(s.positions, axis=0)  # (clients · C, steps, d)
    rng = np.random.default_rng(derived_seed(run.seed, 30))
    n_chains, n = positions.shape[0], positions.shape[1]
    j = checks.pick_draws(rng, n_chains, n)
    pick = rng.choice(n_chains, size=run.cell["chains"], replace=False)
    states_np = positions[pick, j[pick]]
    staged = s.service._models[s.model_id][2]
    states = torch.as_tensor(states_np, dtype=torch.float32, device=run.device)
    g, u = batched_force(staged.potential)(states)
    u_prog, g_prog = u.detach().cpu().double(), g.detach().cpu().double()
    run.state = None
    del s, staged, g, u
    if run.device != "cpu":
        torch.cuda.empty_cache()
    ref = run.reference
    data = run.config.build(0, "cpu").data
    states64 = torch.as_tensor(states_np, dtype=torch.float32).double()
    nums = checks.density_numbers(ref, data, states64, u_prog, g_prog)
    nums.update(checks.chain_numbers(positions, *ref.posterior(data)))
    run.check_inputs = (ref, data, states64)
    return nums
