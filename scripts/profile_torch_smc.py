#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's adaptive SMC, on a GPU.

    python3 scripts/profile_torch_smc.py [--out DIR]

For chip_smoke.py's SMC cells at 131,072 particles in float32: bench.py's
20-site hierarchical model with MH rejuvenation (3 steps) and with HMC
rejuvenation (1 move of 16 leapfrogs), the coin flip with the same two,
and the mixture and mixed-discrete models with 5 MH steps. Per cell: one
warm-up run (its wall is reported: it pays the first use of each CUDA
kernel the model needs), one run timed with CUDA synchronisation (no
profiler), then one run traced under ``torch.profiler``. It reports the
wall time, the device kernels and their device time per ladder stage, the
device's idle share (one less the traced device time over the untraced
wall time, and within the traced window), the device time of the two SMC
kernels (logsumexp, systematic resampling) and the kernels with the most
device time.

Then the resampling kernel alone, broken into its CUDA kernels, at 131,072
float32 log-weights of two kinds: normal x 0.83 (ESS about N/2, the weights
a ladder stage resamples) and normal x 4 (degenerate: one particle takes
thousands of slots; chip_smoke's accuracy input). One JSON line per item on
stdout; the key_averages tables go to ``--out``. Needs a CUDA device;
imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import fugue_tpu_torch as ftt  # noqa: E402
from chip_smoke import (N_PARTICLES, coin_model, hierarchical_model,  # noqa: E402
                        mixed_discrete_model, mixture_model)
from fugue_tpu_torch.ops import kernels as K  # noqa: E402

# CUDA kernel names of csrc/logsumexp.cu and csrc/systematic_resample.cu
SMC_KERNELS = {"lse": ("lse_partial", "lse_finish"),
               "resample": ("lse_parts", "emit")}


def _device_events(prof):
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _by_name(events):
    out = {}
    for e in events:
        out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us()
    return out


def _ours(per_kernel, which):
    return sum(us for name, us in per_kernel.items()
               if any(k in name for k in SMC_KERNELS[which]))


MH = ftt.SMCConfig(rejuvenation_steps=3)
HMC = ftt.SMCConfig(rejuvenation="hmc", rejuvenation_steps=1, hmc_leapfrog=16)
MH5 = ftt.SMCConfig(rejuvenation_steps=5)
CELLS = {
    "mh": (lambda: hierarchical_model("cuda"), MH),
    "hmc": (lambda: hierarchical_model("cuda"), HMC),
    "coin_mh": (lambda: coin_model("cuda"), MH),
    "coin_hmc": (lambda: coin_model("cuda"), HMC),
    "mixture_mh": (lambda: mixture_model("cuda"), MH5),
    "discrete_mh": (lambda: mixed_discrete_model("cuda"), MH5),
}


def profile_smc(name, out_dir):
    make, config = CELLS[name]
    staged = ftt.stage(make(), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ftt.adaptive_smc(0, N_PARTICLES, staged=staged, config=config)  # warm-up
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = ftt.adaptive_smc(1, N_PARTICLES, staged=staged, config=config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        traced = ftt.adaptive_smc(1, N_PARTICLES, staged=staged, config=config)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    events = _device_events(prof)
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    per_kernel = _by_name(events)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    stages = traced.n_stages
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"smc_{name}_key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=60))
    return {
        "cell": f"smc_{name}", "particles": N_PARTICLES, "stages": res.n_stages,
        "traced_stages": stages, "first_run_wall_s": first_wall, "wall_s": wall,
        "ms_per_stage": wall * 1e3 / res.n_stages,
        "particle_stages_per_s": N_PARTICLES * res.n_stages / wall,
        "kernels_per_stage": len(events) / stages,
        "device_ms_per_stage": busy_us * 1e-3 / stages,
        "device_idle_share": 1.0 - busy_us * 1e-6 / wall,
        "device_idle_share_under_profiler": 1.0 - busy_us * 1e-6 / traced_wall,
        "lse_device_ms_per_stage": _ours(per_kernel, "lse") * 1e-3 / stages,
        "resample_device_ms_per_stage": _ours(per_kernel, "resample") * 1e-3 / stages,
        "top_kernels_ms_per_stage": [[k[:80], v * 1e-3 / stages] for k, v in top],
    }


def profile_resample(kind, scale, reps=20):
    lw = torch.as_tensor(np.random.default_rng(7).normal(size=N_PARTICLES) * scale,
                         dtype=torch.float32, device="cuda")
    u0 = torch.tensor(0.5, device="cuda")
    for _ in range(3):
        K.systematic_resample_from_u0(lw, u0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            K.systematic_resample_from_u0(lw, u0)
        torch.cuda.synchronize()
    per_kernel = _by_name(_device_events(prof))
    w = torch.softmax(lw.double(), 0)
    return {"item": "resample_kernels", "weights": kind, "n": N_PARTICLES,
            "ess_over_n": (1.0 / (w * w).sum() / N_PARTICLES).item(),
            "max_slots_one_particle": int(torch.bincount(
                K.systematic_resample_from_u0(lw, u0)).max()),
            "device_us_per_call": {k[:40]: v / reps for k, v in per_kernel.items()}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="profile_out",
                    help="directory for the key_averages tables")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_smc: no CUDA device")
    for name in CELLS:
        print(json.dumps(profile_smc(name, args.out)), flush=True)
    for kind, scale in (("ess_half", 0.83), ("degenerate_x4", 4.0)):
        print(json.dumps(profile_resample(kind, scale)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
