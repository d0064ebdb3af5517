#!/usr/bin/env python3
"""Where the time goes in one HMC, NUTS, ChEES or MH transition, VI iteration or ABC dispatch of the PyTorch port, on a GPU.

    python3 scripts/profile_torch_hmc.py [--engine hmc|nuts|chees|mh|vi|abc|logistic] [--out DIR]

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

``--engine vi`` runs mean-field VI iterations (``vi._iteration``: one
batched model run over the MC samples, one gradient, Adam and the clamp)
on chip_smoke.py's VI cells, the 20-site model at 128 MC samples and the
2^20-row plate at 64, and reports per iteration.

``--engine abc`` runs chip_smoke.py's ABC cells whole: rejection (16
sub-batches of 2^17 per dispatch) and weighted ABC-SMC (2,048 particles,
4 epsilons, batch 16,384), and reports per dispatch (the run over its
dispatches, one host read each).
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
from chip_smoke import (ABC_N_OBS, LOGISTIC_SHAPE, _abc_distance, _abc_sim,  # noqa: E402
                        _gemm_events, abc_data, coin_model, eight_schools_model,
                        hierarchical_model, logistic_data, logistic_model, plate_data,
                        plate_model, traced_kernels)
from fugue_tpu_torch.inference import chees, hmc, mh, nuts, vi  # noqa: E402

MAX_DEPTH = 8


def _trace(name, engine, step, n_traced, out_dir):
    """``step()`` run ``n_traced`` times under the profiler
    (``chip_smoke.traced_kernels``), its key_averages table written to
    ``out_dir``: (the kernel events, their device µs, the eight kernels with
    the most device µs, the traced wall seconds)."""
    out = {}

    def run():
        t0 = time.perf_counter()
        for _ in range(n_traced):
            step()
        torch.cuda.synchronize()
        out["wall"] = time.perf_counter() - t0

    prof, kernels = traced_kernels(run, cpu=True)
    per_kernel = {}
    for e in kernels:
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}_{engine}_key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=60))
    return kernels, sum(per_kernel.values()), top, out["wall"]


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
    state = {"q": q}

    def step():
        state["q"] = transition(state["q"])

    kernels, busy_us, top, traced_wall = _trace(name, engine, step, n_traced, out_dir)
    evals = counts["evals"]
    # the idle share compares device time per evaluation with the untraced
    # wall per evaluation (NUTS transitions differ in length)
    wall_per_eval = wall * n_timed / timed_evals
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
    gemms = _gemm_events(kernels)
    if gemms:
        row[f"gemms_per_{unit}"] = len(gemms) / evals
        row[f"gemm_device_us_per_{unit}"] = sum(e.time_range.elapsed_us() for e in gemms) / evals
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


def profile_calls(name, engine, call, units_per_call, unit, out_dir, n_timed=5, n_traced=2):
    """``call()`` timed ``n_timed`` times without the profiler (after one
    warm-up) and traced ``n_traced`` times: per unit (``units_per_call()``
    units per call), the wall ms, kernels, device µs and the idle share."""
    call()
    torch.cuda.synchronize()
    units = 0
    t0 = time.perf_counter()
    for _ in range(n_timed):
        call()
        units += units_per_call()
    torch.cuda.synchronize()
    wall_per_unit = (time.perf_counter() - t0) / units
    counted = {"units": 0}

    def step():
        call()
        counted["units"] += units_per_call()

    kernels, busy_us, top, traced_wall = _trace(name, engine, step, n_traced, out_dir)
    traced_units = counted["units"]
    return {
        "model": name, "engine": engine, f"ms_per_{unit}": wall_per_unit * 1e3,
        f"kernels_per_{unit}": len(kernels) / traced_units,
        f"device_us_per_{unit}": busy_us / traced_units,
        "device_idle_share": 1.0 - busy_us * 1e-6 / (traced_units * wall_per_unit),
        "device_idle_share_under_profiler": 1.0 - busy_us * 1e-6 / traced_wall,
        f"top_kernels_us_per_{unit}": [[k[:80], v / traced_units] for k, v in top],
    }


def vi_rows(out_dir):
    """Mean-field VI iterations on the 20-site model (128 MC samples) and
    the 2^20-row plate (64)."""
    for name, model, n_mc in (("hierarchical", hierarchical_model("cuda"), 128),
                              ("gaussian_plate", plate_model(plate_data(1 << 20)), 64)):
        staged = ftt.stage(model, device="cuda")
        guide = vi._meanfield_guide_for(staged)
        loss = vi._loss(guide, n_mc)
        opt = vi._optimizer(vi.VIConfig(n_iterations=2000))
        draws = vi.GeneratorDraws(torch.Generator(device="cuda").manual_seed(0))
        state = {"theta": guide.init_flat()}

        def ten():
            for _ in range(10):
                state["theta"], _ = vi._iteration(guide, loss, opt, state["theta"], draws)

        row = profile_calls(name, "vi", ten, lambda: 10, "iteration", out_dir)
        row["mc_samples"] = n_mc
        yield row


def abc_rows(out_dir):
    """The ABC cells whole, per dispatch."""
    staged = ftt.stage(_abc_sim(ABC_N_OBS), device="cuda")
    obs = abc_data()
    last = {}

    def rejection():
        last["res"] = ftt.abc_rejection(30, staged=staged, observed=obs, distance=_abc_distance,
                                        epsilon=0.02, n_samples=4096, batch_size=1 << 17,
                                        inner_batches=16, max_attempts=1 << 26)

    row = profile_calls("rejection", "abc", rejection,
                        lambda: last["res"].n_attempts // (16 << 17), "dispatch", out_dir)
    row["sims_per_dispatch"] = 16 << 17
    yield row
    cfg = ftt.ABCSMCConfig(n_particles=2048, epsilons=(0.5, 0.2, 0.1, 0.05), batch_size=16384,
                           max_attempts_per_stage=1 << 22)

    def smc():
        last["res"] = ftt.abc_smc_weighted(31, staged=staged, observed=obs,
                                           distance=_abc_distance, config=cfg,
                                           param_addresses=("mu_p",))

    row = profile_calls("smc_weighted", "abc", smc,
                        lambda: last["res"].n_attempts // 16384, "dispatch", out_dir)
    row["sims_per_dispatch"] = 16384
    yield row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="profile_out",
                    help="directory for the key_averages tables")
    ap.add_argument("--engine", choices=("hmc", "nuts", "chees", "mh", "vi", "abc", "logistic"),
                    default="hmc", help="profile HMC transitions (L fixed), NUTS, ChEES or MH "
                    "transitions, VI iterations, ABC dispatches or HMC on the d = 1024 "
                    "logistic row")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_hmc: no CUDA device")
    if args.engine in ("vi", "abc"):
        for row in (vi_rows if args.engine == "vi" else abc_rows)(args.out):
            print(json.dumps(row), flush=True)
        return 0
    if args.engine == "logistic":
        d, n, c = LOGISTIC_SHAPE
        x, y, _ = logistic_data(d, n)
        row = profile_model("logistic", logistic_model(x, y), c, 16, 0.3, args.out)
        print(json.dumps(row), flush=True)
        return 0
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
