#!/usr/bin/env python3
"""Where the time goes in one HMC, NUTS, ChEES or MH transition of the PyTorch port, on a GPU.

    python3 scripts/profile_torch_hmc.py [--engine hmc|nuts|chees|mh] [--out DIR]

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

``--engine nuts`` runs NUTS transitions (max_depth 8, unit diagonal mass,
the same fixed step sizes) and reports per lock-step leaf instead of per
gradient: each leaf is one batched value-and-grad with the tree's
bookkeeping, and the root's evaluation counts as one more leaf. It also
reports the leaves per transition and the host syncs per leaf.

``--engine chees`` runs ChEES transitions at the same fixed step sizes,
unit mass and a fixed trajectory length T with the Halton jitter (L =
ceil(h·T/ε): about 4 steps on eight-schools, 1 to 2 on the plate, the
smoke's mean lengths), per batched gradient, with the host syncs (τ reads)
per transition.

``--engine mh`` runs adaptive MH transitions (``mh_step`` with adaptation,
as ``adaptive_mcmc_chain``'s warmup) on chip_smoke.py's MH cells, the coin
flip at 4,096 chains and the 20-site hierarchical model at 262,144, and
reports per transition (one batched model run each).
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
from chip_smoke import (coin_model, eight_schools_model, hierarchical_model,  # noqa: E402
                        plate_data, plate_model)
from fugue_tpu_torch.inference import chees, hmc, mh, nuts  # noqa: E402

MAX_DEPTH = 8


def profile_model(name, model, n_chains, n_leapfrog, eps, out_dir, engine="hmc", T=None):
    staged = ftt.stage(model, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    counts = {"evals": 0, "syncs": 0, "steps": 0}  # batched evaluations, host syncs, transitions
    if engine == "mh":
        q = mh.init_mh_state(staged, 0, n_chains)
    else:
        q = hmc.initial_positions(staged, g, n_chains, "uniform")
        inv_mass = torch.ones(staged.dim, device="cuda")
        eps_t, T_t = (torch.tensor(x, device="cuda") for x in (eps, T or eps))

    def transition(q):
        counts["steps"] += 1
        if engine == "mh":
            counts["evals"] += 1
            return mh.mh_step(staged, q, g, True)[0]
        if engine == "chees":
            h = chees._halton_point(counts["steps"])
            z = torch.randn(q.shape, generator=g, device="cuda")
            log_u = torch.log1p(-torch.rand(n_chains, generator=g, device="cuda"))
            out = chees.chees_transition(staged.potential, q, z, log_u, eps_t, T_t, h, inv_mass,
                                         1024)
            counts["evals"] += out[6] + 1
            counts["syncs"] += 1
            return out[0]
        if engine == "nuts":
            noise = nuts.draw_nuts_noise(g, inv_mass, n_chains, MAX_DEPTH)
            q, info = nuts.nuts_transition(staged.potential, q, noise, eps, inv_mass, MAX_DEPTH)
            counts["evals"] += info["leaves"] + 1
            counts["syncs"] += info["host_syncs"]
            return q
        p = hmc.mass_draw_momentum(g, inv_mass, q.shape)
        log_u = torch.log1p(-torch.rand(n_chains, generator=g, device="cuda"))
        counts["evals"] += n_leapfrog + 1
        return hmc.hmc_transition(staged.potential, q, p, log_u, eps, n_leapfrog,
                                  inv_mass)[0]

    for _ in range(2):  # warm-up: allocator, library load
        q = transition(q)
    torch.cuda.synchronize()
    n_timed = 5
    counts.update(evals=0, syncs=0)
    t0 = time.perf_counter()
    for _ in range(n_timed):
        q = transition(q)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n_timed
    timed_evals = counts["evals"]

    n_traced = 2
    counts.update(evals=0, syncs=0)  # the step count runs on: the Halton jitter moves
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
    evals = counts["evals"]
    # the idle share compares device time per evaluation with the untraced
    # wall per evaluation (NUTS transitions differ in length)
    wall_per_eval = wall * n_timed / timed_evals
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}_{engine}_key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=60))
    unit = {"nuts": "lockstep_leaf", "mh": "transition"}.get(engine, "batched_gradient")
    row = {
        "model": name, "engine": engine, "chains": n_chains, "transition_ms": wall * 1e3,
        f"ms_per_{unit}": wall_per_eval * 1e3,
        f"kernels_per_{unit}": len(kernels) / evals,
        f"device_us_per_{unit}": busy_us / evals,
        "device_idle_share": 1.0 - busy_us * 1e-6 / (evals * wall_per_eval),
        "device_idle_share_under_profiler": 1.0 - busy_us * 1e-6 / traced_wall,
        f"top_kernels_us_per_{unit}": [[k[:80], v / evals] for k, v in top],
    }
    if engine == "nuts":
        row.update(max_depth=MAX_DEPTH, leaves_per_transition=timed_evals / n_timed - 1,
                   host_syncs_per_leaf=counts["syncs"] / (evals - n_traced))
    elif engine == "chees":
        row.update(step_size=eps, trajectory_length=T,
                   leapfrogs_per_transition=timed_evals / n_timed - 1,
                   host_syncs_per_transition=counts["syncs"] / n_traced)
    elif engine == "hmc":
        row["n_leapfrog"] = n_leapfrog
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="profile_out",
                    help="directory for the key_averages tables")
    ap.add_argument("--engine", choices=("hmc", "nuts", "chees", "mh"), default="hmc",
                    help="profile HMC transitions (L fixed), NUTS, ChEES or MH transitions")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_hmc: no CUDA device")
    if args.engine == "mh":
        cells = (("coin", coin_model("cuda"), 4096, None, None, None),
                 ("hierarchical", hierarchical_model("cuda"), 262144, None, None, None))
    else:
        # T: with the Halton jitter's mean of 1/2, about 4 steps on
        # eight-schools and 1 to 2 on the plate (ChEES only)
        cells = (("eight_schools", eight_schools_model("cuda"), 1024, 32, 0.3, 2.4),
                 ("gaussian_plate", plate_model(plate_data(1 << 20)), 64, 16, 0.001, 0.003))
    for name, model, c, L, eps, T in cells:
        print(json.dumps(profile_model(name, model, c, L, eps, args.out, args.engine, T)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
