#!/usr/bin/env python3
"""Where the time goes in one HMC transition of the PyTorch port, on a GPU.

    python3 scripts/profile_torch_hmc.py [--out DIR]

For chip_smoke.py's two models at its shapes, eight-schools (1024 chains,
L=32) and the 2^20-row Gaussian plate (64 chains, L=16): it times transitions with CUDA
synchronisation (no profiler), then traces a few under ``torch.profiler``
and reports, per batched gradient evaluation, the number of device kernels,
their device time, and the host wall time, plus the device's idle share
and the kernels with the most device time. The idle share is one less the
traced device time per transition over the wall time per transition
measured without the profiler, whose own host overhead lengthens the traced
window; the traced window's share is printed beside it. One JSON line
per model on stdout; the full ``key_averages`` tables go to ``--out``.
Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import fugue_tpu_torch as ftt  # noqa: E402
from chip_smoke import eight_schools_model, plate_data, plate_model  # noqa: E402
from fugue_tpu_torch.inference import hmc  # noqa: E402


def profile_model(name, model, n_chains, n_leapfrog, eps, out_dir):
    staged = ftt.stage(model, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    q = hmc.initial_positions(staged, g, n_chains, "uniform")
    inv_mass = torch.ones(staged.dim, device="cuda")

    def transition(q):
        p = hmc.mass_draw_momentum(g, inv_mass, q.shape)
        log_u = torch.log1p(-torch.rand(n_chains, generator=g, device="cuda"))
        return hmc.hmc_transition(staged.potential, q, p, log_u, eps, n_leapfrog,
                                  inv_mass)[0]

    for _ in range(2):  # warm-up: allocator, library load
        q = transition(q)
    torch.cuda.synchronize()
    n_timed = 5
    t0 = time.perf_counter()
    for _ in range(n_timed):
        q = transition(q)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n_timed

    n_traced = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_traced):
            q = transition(q)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    per_kernel = {}
    for e in kernels:
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    evals = n_traced * (n_leapfrog + 1)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}_key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=60))
    return {
        "model": name, "chains": n_chains, "n_leapfrog": n_leapfrog,
        "transition_ms": wall * 1e3,
        "ms_per_batched_gradient": wall * 1e3 / (n_leapfrog + 1),
        "kernels_per_batched_gradient": len(kernels) / evals,
        "device_us_per_batched_gradient": busy_us / evals,
        "device_idle_share": 1.0 - busy_us * 1e-6 / (n_traced * wall),
        "device_idle_share_under_profiler": 1.0 - busy_us * 1e-6 / traced_wall,
        "top_kernels_us_per_gradient": [[k[:80], v / evals] for k, v in top],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="profile_out",
                    help="directory for the key_averages tables")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_hmc: no CUDA device")
    for name, model, c, L, eps in (
        ("eight_schools", eight_schools_model("cuda"), 1024, 32, 0.3),
        ("gaussian_plate", plate_model(plate_data(1 << 20)), 64, 16, 0.001),
    ):
        print(json.dumps(profile_model(name, model, c, L, eps, args.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
