#!/usr/bin/env python3
"""How often a torch.profiler session loses the CUDA kernels it should hold.

Runs one ``pf.observe`` of the port's particle filter at 2^20 particles
(about 3 ms, 40 kernels) in each of ``--sessions`` CUDA-only profiler
sessions, in four variants: plain; with a ~25 ms ``torch.cuda._sleep``
kernel before or after the observe; and with a 5 ms host wait first. Then
the same observe in ``--sessions`` ``utils.profiling.device_trace``
sessions (host and device, written as a Chrome trace; its priming
kernels are not counted). Then, over the
JSON-RPC service in its handler thread, ``pf.observe`` in
``device_trace`` sessions and a 10-transition ``mh.step`` of the DSL coin
in CUDA-only sessions, and one batched gradient of the hand-written
eight-schools model at 1,024 chains. Prints, per variant, the first
session's count, the sessions that recorded no CUDA event, those that
recorded fewer than the most any session did, the distinct counts, and
the card's name and power limit.

``--graph`` first captures and replays a CUDA graph, as ``chip_smoke.py``'s
kernel phases do; ``TEARDOWN_CUPTI=0`` in the environment keeps CUPTI set
up between sessions (Kineto tears it down by default). Neither removed
the losses (PERF.md, section 6):

    python3 scripts/probe_profiler_sessions.py --sessions 60 --graph
    TEARDOWN_CUPTI=0 python3 scripts/probe_profiler_sessions.py --sessions 60 --graph

``--serving`` runs ``serving()`` instead: the batched gradients that
``chip_smoke.py``'s serve_eight_schools phase traces, with and without
padding kernels before or after the traced call, which shows where in a
session the lost records were:

    python3 scripts/probe_profiler_sessions.py --serving --sessions 6
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # the repo root

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from fugue_tpu_torch.dsl.sessions import ParticleFilter  # noqa: E402
from fugue_tpu_torch.utils.profiling import device_trace  # noqa: E402

SLEEP_CYCLES = 50_000_000  # about 25 ms of torch.cuda._sleep on an H100


MARKERS = 128  # the "prime" padding: one-cycle torch.cuda._sleep kernels


def kernel_names(fn, pad=None):
    """(the CUDA kernels of one ``fn()`` call in a CUDA-only session, by
    start time; the padding kernels recorded). ``pad`` "before" or "after"
    adds a ~25 ms ``torch.cuda._sleep`` kernel on that side of the call;
    "prime" launches ``MARKERS`` one-cycle ones and waits for them before
    the call. Padding kernels are left out of the names."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        if pad == "before":
            torch.cuda._sleep(SLEEP_CYCLES)
        if pad == "prime":
            for _ in range(MARKERS):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        fn()
        if pad == "after":
            torch.cuda._sleep(SLEEP_CYCLES)
        torch.cuda.synchronize()
    events = sorted((e for e in p.events() if e.device_type.name == "CUDA"),
                    key=lambda e: e.time_range.start)
    names = [e.name for e in events]
    block = [n for n in names if "spin_kernel" not in n]
    return block, len(names) - len(block)


def serving(sessions):
    """chip_smoke.py's serve_coin phase, then its serve_eight_schools
    sequence up to the gradients it traces: per padding (none, "prime",
    "after", "before"; ``kernel_names``), the DSL and the
    hand-written eight-schools gradient at the ChEES session's positions
    in ``sessions`` sessions each, a fresh force and one warm-up call
    first. Prints the counts and whether each session's kernels are a
    prefix or a suffix of the fullest session's (a loss at the end or at
    the start of the session)."""
    import chip_smoke as smoke
    from fugue_tpu_torch.inference.hmc import batched_force
    from fugue_tpu_torch.runtime.staging import stage

    smoke.phase_serve_coin()
    with smoke.Rpc() as rpc:
        mid = rpc("compile", source=smoke.EIGHT_SCHOOLS_DSL,
                  data={"y": smoke.EIGHT_SCHOOLS_Y, "sigma": smoke.EIGHT_SCHOOLS_SIGMA})["model_id"]
        new = rpc("chees.new", model_id=mid, n_chains=1024, n_warmup=200)
        for _ in range(20):
            rpc("chees.step", session_id=new["session_id"])
        q = rpc.service._sessions[new["session_id"]].positions
        models = (("dsl", rpc.service._models[mid][2]),
                  ("hand", stage(smoke.eight_schools_model("cuda"), device="cuda")))
        for pad in (None, "prime", "after", "before"):
            for name, staged in models:
                force = batched_force(staged.potential)
                force(q)
                runs = [kernel_names(lambda: force(q), pad) for _ in range(sessions)]
                seqs = [x for x, _ in runs]
                full = max(seqs, key=len)
                print(json.dumps({"pad": pad, "model": name, "counts": [len(x) for x in seqs],
                                  "padding_kernels": [m for _, m in runs],
                                  "prefix": [x == full[:len(x)] for x in seqs],
                                  "suffix": [x == full[len(full) - len(x):] for x in seqs],
                                  "fullest_first": [x[:60] for x in full[:3]],
                                  "shortest_first": [x[:60] for x in min(seqs, key=len)[:3]]}),
                      flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=60)
    ap.add_argument("--graph", action="store_true",
                    help="capture and replay a CUDA graph before the sessions")
    ap.add_argument("--serving", action="store_true",
                    help="only the gradients of chip_smoke.py's serve_eight_schools (serving())")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if args.serving:
        serving(args.sessions)
        return
    import chip_smoke as smoke
    from fugue_tpu_torch.inference.hmc import batched_force
    from fugue_tpu_torch.runtime.staging import stage

    print(json.dumps({"TEARDOWN_CUPTI": os.environ.get("TEARDOWN_CUPTI"),
                      "graph": args.graph, "torch": torch.__version__}), flush=True)
    if args.graph:
        x = torch.randn(1 << 20, device="cuda")
        graph, _ = smoke.capture(lambda: torch.logsumexp(x, 0))
        graph.replay()
        torch.cuda.synchronize()
    pf = ParticleFilter(1, n_particles=1 << 20)
    pf.observe(0.1)
    torch.cuda.synchronize()

    def cuda_session(before=False, after=False, host_wait=0.0):
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            if host_wait:
                time.sleep(host_wait)
            if before:
                torch.cuda._sleep(SLEEP_CYCLES)
            pf.observe(0.3)
            if after:
                torch.cuda._sleep(SLEEP_CYCLES)
            torch.cuda.synchronize()
        return sum(e.device_type.name == "CUDA" for e in p.events())

    def trace_session():
        with tempfile.TemporaryDirectory() as tmp:
            with device_trace(tmp):
                pf.observe(0.2)
            (path,) = glob.glob(os.path.join(tmp, "*.json"))
            events = json.load(open(path))["traceEvents"]
        return sum(e.get("cat") == "kernel" and "spin_kernel" not in e["name"] for e in events)

    def cuda_count(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            fn()
            torch.cuda.synchronize()
        return sum(e.device_type.name == "CUDA" for e in p.events())

    rpc = smoke.Rpc().__enter__()
    pf_sid = rpc("pf.new", n_particles=1 << 20, process_sd=0.3, obs_sd=0.5)["session_id"]
    rpc("pf.observe", session_id=pf_sid, y=0.1)
    coin = rpc("compile", source=smoke.COIN_DSL, data={"flips": smoke.COIN_FLIPS})["model_id"]
    mh_sid = rpc("mh.new", model_id=coin, n_chains=4096)["session_id"]
    rpc("mh.step", session_id=mh_sid, n=10)
    force = batched_force(stage(smoke.eight_schools_model("cuda"), device="cuda").potential)
    q = torch.randn(1024, 10, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    force(q)

    def rpc_trace_session():
        with tempfile.TemporaryDirectory() as tmp:
            with device_trace(tmp):
                rpc("pf.observe", session_id=pf_sid, y=0.2)
            (path,) = glob.glob(os.path.join(tmp, "*.json"))
            events = json.load(open(path))["traceEvents"]
        return sum(e.get("cat") == "kernel" and "spin_kernel" not in e["name"] for e in events)

    variants = (("cuda_plain", lambda: cuda_session()),
                ("cuda_sleep_before", lambda: cuda_session(before=True)),
                ("cuda_sleep_after", lambda: cuda_session(after=True)),
                ("cuda_host_wait_5ms", lambda: cuda_session(host_wait=0.005)),
                ("device_trace", trace_session),
                ("rpc_pf_observe_device_trace", rpc_trace_session),
                ("rpc_mh_step_10", lambda: cuda_count(
                    lambda: rpc("mh.step", session_id=mh_sid, n=10))),
                ("hand_eight_schools_gradient", lambda: cuda_count(lambda: force(q))))
    for name, run in variants:
        counts = [run() for _ in range(args.sessions)]
        full = max(counts)
        print(json.dumps({"variant": name, "sessions": len(counts), "first": counts[0],
                          "no_cuda_event": sum(c == 0 for c in counts),
                          "fewer_events": sum(0 < c < full for c in counts),
                          "most_events": full, "distinct": sorted(set(counts))}), flush=True)
    rpc.__exit__(None, None, None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0] if card.stdout else "nvidia-smi: no output")


if __name__ == "__main__":
    main()
