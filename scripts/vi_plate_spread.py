#!/usr/bin/env python3
"""The vi_plate phase's configuration over several seeds on the card, and a
control whose gradient is wrong: the readings behind the phase's gate.

    python scripts/vi_plate_spread.py --runs 12

For each seed s (segment seeds 1000 s + i), ``chip_smoke.vi_plate_run`` on
the 2^20-row plate in float32, then ``chip_smoke.vi_plate_stats`` and each
statistic's offset from the JAX package's constant (``chip_smoke.VI_PLATE``)
in its run-SDs: what the gate reads (it fails at 5). Then the control: the
same drive on a plate whose log-likelihood value is the kernel's over all
rows but whose gradient is the kernel's over the first half of the rows (a
gradient that drops half its blocks). One JSON line per run, then one with,
for each statistic, the largest |z| of the sound runs and the control's z.
Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import fugue_tpu_torch as ftt  # noqa: E402
from chip_smoke import (MAIN_SHAPE, VI_PLATE, VI_REF_RUNS, card_line, plate_model,  # noqa: E402
                        plate_numpy_data, run_sd_z, vi_plate_run, vi_plate_stats)


def half_gradient_model(y):
    """The plate's model with the right value and the gradient of the first
    half of the rows only."""
    half = y[: y.numel() // 2]

    def plate():
        mu = ftt.sample("mu", ftt.Normal(0.0, 10.0))
        sigma = ftt.sample("sigma", ftt.LogNormal(0.0, 1.0))
        full = ftt.pnormal_loglik_sum(y, mu, sigma)
        part = ftt.pnormal_loglik_sum(half, mu, sigma)
        ftt.factor(full.detach() + part - part.detach())

    return plate


def reading(what, seed, staged, y_np):
    t0 = time.perf_counter()
    res = vi_plate_run(staged, seed)
    stats = vi_plate_stats(res.params, y_np)
    row = {"run": what, "seed": seed, "wall_s": time.perf_counter() - t0, **stats,
           "z": {k: run_sd_z(v, VI_PLATE[k], VI_REF_RUNS["plate"]) for k, v in stats.items()}}
    print(json.dumps(row), flush=True)
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("vi_plate_spread: no CUDA device")
    print(card_line(), flush=True)
    y_np = plate_numpy_data(MAIN_SHAPE[1])
    y = torch.as_tensor(y_np, dtype=torch.float32, device="cuda")
    staged = ftt.stage(plate_model(y), device="cuda")
    sound = [reading("sound", 1000 * s, staged, y_np) for s in range(args.runs)]
    control = reading("half_gradient", 700, ftt.stage(half_gradient_model(y), device="cuda"), y_np)
    print(json.dumps({"runs": args.runs, "sound_max_abs_z": {
        k: max(abs(r["z"][k]) for r in sound) for k in VI_PLATE},
        "control_z": control["z"]}), flush=True)


if __name__ == "__main__":
    main()
