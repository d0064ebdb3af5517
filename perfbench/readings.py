"""Readings of a cell's correctness numbers over many seeds, and of its
control, in one process: the lower and upper readings its limits are set
from. Not part of a benchmark run.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 --seconds <s> [--out FILE]

For each seed: a whole run of the cell (set-up, window, check) and then the
control at the same visited states: the reference computed in bfloat16
put in the program's place (``checks.control_numbers``). One JSON line per
seed: the program's numbers, the control's, the end-to-end metrics.
"""

import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache", "torch_extensions")

from perfbench import checks, harness  # noqa: E402


def readings(workload: str, seeds, seconds: float, device="cuda", overrides=None):
    """One dict per seed: {"seed", "program", "control", "metrics", "setup_s"}."""
    import torch

    for seed in seeds:
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        run = harness.new_run(workload, seed, seconds, False, device=device, overrides=overrides)
        out = harness.run_cell(run)
        ref, data, states = run.check_inputs
        control = checks.control_numbers(ref, data, states)
        yield {"seed": seed, "program": {k: v["value"] for k, v in out["checks"].items()},
               "control": control, "metrics": out["metrics"], "correct": out["correct"],
               "memory_peak_bytes": out["device"]["memory_peak_bytes"]}
        del run, out
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    sink = open(args.out, "a") if args.out else None
    try:
        for row in readings(args.workload, seeds, args.seconds):
            row["at"] = time.time()
            line = json.dumps(row)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()


if __name__ == "__main__":
    main()
