"""The harness: finds a cell's files by name, runs it once, and prints the
result line.

Everything that belongs to one configuration, traffic kind, cell or
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives:

- ``configs/<config>.py``: the model in the port's language, its data from
  the seed, its shapes and operation counts;
- ``reference/<config>.py``: the plain reference (imports nothing of the
  program);
- ``traffic/<traffic>.py``: ``setup``, ``window``, ``trace`` and ``check`` of
  the workload's ``traffic`` (``nuts``, ``hmc``, ``serve``);
- ``cells/<workload>.json``: the cell's parameters and the limits of its
  correctness numbers;
- ``metrics/<metric>.py``: ``read(run)`` of one per-layer metric, None
  where there is nothing to read.

A later cell, configuration or metric is a set of new files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fugue_tpu")


def load_file(path: Path, name: str):
    """The module at ``path``, loaded under ``name`` (file names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def cell(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return json.loads((bench_dir / "cells" / f"{name}.json").read_text())


def config(name: str, bench_dir: Path = BENCH_DIR):
    return load_file(bench_dir / "configs" / f"{name}.py", f"perfbench_config_{name}")


def reference(name: str, bench_dir: Path = BENCH_DIR):
    return load_file(bench_dir / "reference" / f"{name}.py", f"perfbench_reference_{name}")


def traffic(kind: str, bench_dir: Path = BENCH_DIR):
    return load_file(bench_dir / "traffic" / f"{kind}.py", f"perfbench_traffic_{kind}")


def metric(name: str, bench_dir: Path = BENCH_DIR):
    return load_file(bench_dir / "metrics" / f"{name}.py", f"perfbench_metric_{name}")


def applies(entry: dict, workload_name: str) -> bool:
    return "workloads" not in entry or workload_name in entry["workloads"]


def derived_seed(seed: int, *salt: int) -> int:
    """A seed below 2**31 derived from the run's seed and ``salt``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *[int(s) for s in salt]])
    return int(ss.generate_state(1, dtype=np.uint32)[0] >> 1)


def forbidden_modules() -> list:
    """The loaded modules whose whole top-level name is forbidden."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def new_run(workload_name: str, seed: int, seconds: float, trace: bool, *,
            device="cuda", bench: dict | None = None, overrides: dict | None = None,
            t0: float | None = None):
    """The state of one run: its cell, configuration, traffic and reference
    modules, the seeds, and places for what the traffic records."""
    bench = bench if bench is not None else benchmark()
    w = workload(bench, workload_name)
    params = cell(workload_name)
    params.update(overrides or {})
    return SimpleNamespace(
        name=workload_name, workload=w, cell=params, seed=int(seed), seconds=float(seconds),
        trace_on=bool(trace), device=device, bench=bench,
        t0=time.perf_counter() if t0 is None else t0,
        config=config(w["config"]), reference=reference(w["config"]),
        traffic=traffic(w["traffic"]),
        e2e={}, counters={}, trace=None, setup_s=None, window_s=None,
        attempted=0, failed=0, memory_peak_bytes=None)


def run_cell(run) -> dict:
    """Set-up, window, (trace), check; the result line as a dict, the check
    numbers beside their limits under "checks", last."""
    import torch

    t = run.traffic
    t.setup(run)
    run.setup_s = time.perf_counter() - run.t0
    t.window(run)
    if run.device != "cpu" and torch.cuda.is_available():
        torch.cuda.synchronize()
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    if run.trace_on:
        t.trace(run)
    numbers = t.check(run)
    limits = run.cell.get("limits", {})
    checks = {}
    correct = True
    for name, value in numbers.items():
        limit = limits.get(name)
        ok = limit is not None and value is not None and math.isfinite(value) and value <= limit
        correct = correct and ok
        checks[name] = {"value": value, "limit": limit}
    metrics = {}
    if run.trace_on:
        for m in run.bench["per_layer"]:
            if not applies(m, run.name):
                continue
            value = metric(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(run.e2e, setup_s=run.setup_s)
        for m in run.bench["end_to_end"]:
            if applies(m, run.name) and m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    device = {"platform": "cpu", "kind": "cpu", "count": 1}
    if run.device != "cpu":
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": run.workload["chips"]}
    device["memory_peak_bytes"] = run.memory_peak_bytes
    out = {"correct": bool(correct), "attempted": int(run.attempted), "failed": int(run.failed),
           "metrics": metrics, "device": device}
    if run.trace_on and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = checks
    return out


def main(argv=None, t0: float | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = benchmark()
    chips = workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell needs {chips} CUDA device(s), this machine has {n}",
              file=sys.stderr)
        return 2
    run = new_run(args.workload, args.seed, args.seconds, bool(args.trace), bench=bench, t0=t0)
    out = run_cell(run)
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    if run.counters.get("call_s"):
        print("window calls (s): " + " ".join(f"{t:.4f}" for t in run.counters["call_s"]),
              file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
