#!/usr/bin/env python3
"""The program's spans and named host reads (``utils.profiling``) against
the benchmark's own trace, on the card.

For each cell named (``eight_schools_nc.hmc``, ``eight_schools_nc.serve``):
one traced run of the benchmark (``perfbench.harness.run_cell``, at
``--seconds``), then from its traced window:

- HMC: the program's ``potential`` spans against the ``pb.potential``
  ranges, the device operations launched inside the program's spans per
  span, the ``pb.potential`` operations launched outside every program
  span (0 when the two clocks agree), and the ``host_read`` count against
  the sync-debug count;
- serve: the ``serve.lock_wait``, ``serve.method`` and ``serve.reply``
  spans that do not lie inside the ``serve.request`` span of their request
  id (0 expected), and the spans of each name;
- both: the metrics of the result line, and the program's records per
  second of window.

Then the synchronizing CUDA calls of one resumed ``hmc_chain`` call, one
resumed ``nuts_chain`` call and one ``chees.step`` request at the cells'
sizes, each by the program's stack where PyTorch's sync debugging warned,
beside the named reads of the same call; and the recorder's cost per span
and per count, on and off. One JSON line per part on standard output,
and appended to ``--out`` where given:

    python3 scripts/check_program_spans.py --seconds 5 --out spans.jsonl
"""

import argparse
import collections
import json
import os
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "perfbench", ".cache", "triton"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from fugue_tpu_torch.utils import profiling  # noqa: E402
from fugue_tpu_torch.utils.profiling import Count, Span  # noqa: E402
from perfbench import harness  # noqa: E402

OUT = None  # --out


def emit(row):
    line = json.dumps(row)
    print(line, flush=True)
    if OUT:
        with open(OUT, "a") as f:
            f.write(line + "\n")


def spans(recs, name):
    return [r for r in recs if isinstance(r, Span) and r.name == name]


def inside(t, ivs):
    return any(s <= t <= e for s, e in ivs)


def traced_cell(name, seed, seconds):
    run = harness.new_run(name, seed, seconds, True)
    out = harness.run_cell(run)
    tr = run.trace
    recs = profiling.records(*tr.window)
    row = {"part": name, "seed": seed, "correct": out["correct"],
           "metrics": {k: v["value"] for k, v in out["metrics"].items()},
           "window_s": tr.window_s, "records": len(recs),
           "records_per_s": len(recs) / tr.window_s,
           "spans": dict(collections.Counter(r.name for r in recs if isinstance(r, Span))),
           "dropped": profiling.RECORDER.dropped}
    if name.endswith(".hmc"):
        pot = [(s.start, s.end) for s in spans(recs, "potential")]
        in_pb = tr.in_span("pb.potential")
        in_prog = [o for o in tr.ops if inside(o.launch, pot)]
        reads = collections.Counter()
        for r in recs:
            if isinstance(r, Count) and r.name == "host_read":
                reads[r.attrs["site"]] += r.n
        row.update(program_potentials=len(pot), pb_potentials=tr.calls.get("pb.potential", 0),
                   ops_in_program_potential_per_span=len(in_prog) / max(len(pot), 1),
                   pb_ops_outside_program_spans=sum(not inside(o.launch, pot) for o in in_pb),
                   host_reads=dict(reads), sync_debug=run.counters["trace"]["host_syncs"])
    else:
        requests = {s.request: s for s in spans(recs, "serve.request")}
        bad = 0
        for n in ("serve.lock_wait", "serve.method", "serve.reply"):
            for s in spans(recs, n):
                outer = requests.get(s.request)
                bad += outer is None or not (outer.start <= s.start <= s.end <= outer.end)
        row.update(requests=len(requests), spans_outside_their_request=bad)
    emit(row)
    return run


def sync_sites(fn):
    """(fn(), {program stack: synchronizing calls}, {site: named reads}):
    PyTorch's sync debugging in its warning mode, inside a CPU-only
    profiler session so that the recorder is on."""
    sites = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        frames = [f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}"
                  for f in traceback.extract_stack()[:-1] if "fugue_tpu_torch" in f.filename]
        sites[" < ".join(reversed(frames[-3:])) or f"{filename}:{lineno}"] += 1

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        t1 = time.time_ns()
    reads = collections.Counter()
    for r in profiling.records(t0, t1):
        if isinstance(r, Count) and r.name == "host_read":
            reads[r.attrs["site"]] += r.n
    return out, dict(sites), dict(reads)


def drive_syncs(seed):
    import fugue_tpu_torch as ftt

    hmc_cell, cfg_mod = harness.cell("eight_schools_nc.hmc"), harness.config("eight_schools_nc")
    staged = ftt.stage(cfg_mod.build(seed, "cuda").model_fn, device="cuda")
    hcfg = ftt.HMCConfig(n_leapfrog=hmc_cell["n_leapfrog"], target_accept=0.9)
    kw = dict(staged=staged, n_chains=hmc_cell["chains"])
    first = ftt.hmc_chain(seed, n_samples=1, n_warmup=20, config=hcfg, **kw)
    _, sites, reads = sync_sites(lambda: ftt.hmc_chain(seed + 1, n_samples=2, n_warmup=0,
                                                       config=hcfg, resume=first, **kw))
    emit({"part": "syncs.hmc_chain", "sync_debug": sites, "host_reads": reads})
    ncfg = ftt.NUTSConfig(max_depth=8)
    first = ftt.nuts_chain(seed, n_samples=1, n_warmup=20, config=ncfg, **kw)
    res, sites, reads = sync_sites(lambda: ftt.nuts_chain(seed + 1, n_samples=2, n_warmup=0,
                                                          config=ncfg, resume=first, **kw))
    emit({"part": "syncs.nuts_chain", "sync_debug": sites, "host_reads": reads,
          "host_syncs": res.host_syncs, "iterations": res.lockstep_leaves})


def serve_syncs(seed):
    from fugue_tpu_torch.serve import FugueService

    cfg_mod, cell = harness.config("eight_schools_nc"), harness.cell("eight_schools_nc.serve")
    svc = FugueService(seed=seed, device="cuda")
    mid = svc.handle({"method": "compile", "params": {"source": cfg_mod.DSL,
                                                      "data": cfg_mod.DSL_DATA}})
    mid = mid["result"]["model_id"]
    sid = svc.handle({"method": "chees.new", "params": {
        "model_id": mid, "n_chains": cell["chains"], "n_warmup": 20, "seed": seed}})
    sid = sid["result"]["session_id"]
    step = {"method": "chees.step", "params": {"session_id": sid, "n": 1}}
    svc.handle(step)
    out, sites, reads = sync_sites(lambda: svc.handle(step))
    emit({"part": "syncs.chees_step", "sync_debug": sites, "host_reads": reads,
          "ok": "result" in out})


def recorder_cost(n=2_000, reps=50):
    """ns per span and per count, off and on (on: inside a CPU-only
    profiler session), on this host: the median over ``reps`` batches of
    ``n`` calls, the buffer emptied before each batch (a traced call holds
    a few thousand records at most)."""
    rec = profiling.Recorder(capacity=1 << 20)

    def per_call(fn):
        times = []
        for _ in range(reps):
            rec.clear()
            t = time.perf_counter_ns()
            for _ in range(n):
                fn()
            times.append((time.perf_counter_ns() - t) / n)
        return sorted(times)[reps // 2]

    def one_span():
        with rec.span("potential"):
            pass

    def one_read():
        rec.host_read("site")

    row = {"part": "recorder_cost_ns", "empty_loop": per_call(lambda: None),
           "span_off": per_call(one_span), "host_read_off": per_call(one_read)}
    with profile(activities=[ProfilerActivity.CPU]):
        row["span_on"] = per_call(one_span)
        row["host_read_on"] = per_call(one_read)
    emit(row)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=2**33 + 161)
    ap.add_argument("--cells", default="eight_schools_nc.hmc,eight_schools_nc.serve")
    ap.add_argument("--out", help="a file to append the JSON lines to")
    args = ap.parse_args()
    global OUT
    OUT = args.out
    if OUT and os.path.dirname(OUT):
        os.makedirs(os.path.dirname(OUT), exist_ok=True)
    import subprocess

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    emit({"part": "card", "card": card.strip(), "torch": torch.__version__})
    recorder_cost()
    for i, name in enumerate(c for c in args.cells.split(",") if c):
        traced_cell(name, args.seed + i, args.seconds)
        torch.cuda.empty_cache()
    drive_syncs(harness.derived_seed(args.seed, 7))
    serve_syncs(harness.derived_seed(args.seed, 8))


if __name__ == "__main__":
    main()
