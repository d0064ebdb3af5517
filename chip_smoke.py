#!/usr/bin/env python3
"""Drive the PyTorch port's HMC and SMC main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py                      # all phases
    python3 chip_smoke.py --phases build,kernel
    python3 chip_smoke.py --phases build,smc_kernels,smc

Phases (each prints JSON lines; any failure raises and exits non-zero):

1. build         nvcc-build (or load) the three CUDA kernel libraries from
                 fugue_tpu_torch/csrc, one nvcc per source, all at once.
2. kernel        the Gaussian-plate value-and-grad kernel against its plain
                 PyTorch version and a float64 reference, in float32, at
                 (C, N) = (1, 2^24), (64, 2^20), (3, 2^20 + 17); gates for
                 an unaligned y[k:], data far from 0, an outlier first row
                 and mu far from ybar (float32, and float64 to 1e-12 of
                 plain), non-finite rows and parameters (the plain
                 version's NaN/inf pattern), run-to-run determinism, and a
                 second derivative that raises. Times: device time per
                 call (CUDA-graph replays) and the eager call's time (host
                 dispatch included), each the median of 25
                 CUDA-event-timed repetitions, for kernel and plain.
3. eight_schools vectorized HMC, 1024 chains, L=32, target_accept 0.9,
                 200 warmup + 200 samples; gates on split-R-hat, divergence
                 rate and the posterior mean of mu.
4. gaussian_plate HMC on a 2^20-row Gaussian plate whose likelihood runs
                 through the CUDA kernel (64 chains, L=16, jitter 0.5,
                 200 + 200); gates on the posterior of (mu, sigma), R-hat and
                 one kernel call per batched model run.
5. smc_kernels   the logsumexp and systematic-resampling kernels against
                 their plain versions and float64 references, at SMC's
                 131,072 particles, 2^24 / 2^20 and ragged sizes, from
                 unaligned x[1:] views, with logits near +-1e4, one
                 outlier, -inf, +inf and NaN inputs and degenerate
                 weights, in both dtypes; each bitwise the same run to run
                 and from a CUDA-graph replay. Device times of kernel,
                 plain version and torch.logsumexp at 131,072 and 2^24,
                 and launch_floor_ms, the device time of the least launch
                 (an in-place add on one element).
6. smc           ftt.adaptive_smc in float32: bench.py's 20-site
                 hierarchical model at 131,072 particles with MH and with
                 HMC rejuvenation, and the conjugate model at 8,192; gates
                 on convergence, the posterior mean of mu, the conjugate
                 log-evidence and both kernels' launch counts (4 * stages
                 + 3 logsumexp, stages - 1 resample).

Then it prints the card's name and power limit, one JSON line describing
the kernels, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It needs a CUDA device and nvcc, and imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "kernel", "eight_schools", "gaussian_plate", "smc_kernels", "smc")
SOURCES = ("normal_loglik_sum", "logsumexp", "systematic_resample")
REPLACES = {
    # _nll_fwd_kernel and _nll_bwd_kernel, one value-and-grad kernel here
    "nll": "fugue_tpu/ops/pallas_kernels.py:310, fugue_tpu/ops/pallas_kernels.py:332",
    "lse": "fugue_tpu/ops/pallas_kernels.py:83",  # _plogsumexp_kernel
    "resample": "fugue_tpu/ops/pallas_kernels.py:186",  # _presample_kernel
}
MAIN_SHAPE = (64, 1 << 20)  # (chains, rows) of the plate phase
N_PARTICLES = 131072  # bench_smc / bench_smc_hmc

# The card's peaks (NVIDIA's H100 SXM data sheet): HBM bytes/s, and FP64
# operations/s on the CUDA cores (the kernels accumulate in double there).
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12

# Weighted posterior mean of mu in bench.py's hierarchical_model under the
# JAX package's adaptive_smc at 131,072 particles, on the CPU in float64,
# seeds PRNGKey(0..47), one constant per rejuvenation mode of the smc phase
# (scripts/smc_reference_mu.py --runs 48). MU_RUN_SD is the standard
# deviation of one run's estimate across the 48 seeds: the Monte-Carlo
# error of ONE run at this size; the constant's own standard error is
# MU_RUN_SD / sqrt(48).
SMC_MU_RUNS = 48
SMC_MU = {
    "mh": {"MU_MEAN": 0.57400469713508, "MU_RUN_SD": 0.026926052783615886},
    "hmc": {"MU_MEAN": 0.5713615302539027, "MU_RUN_SD": 0.009740783104405557},
}

# Posterior mean of mu in eight-schools (bench.eight_schools_model), from the
# JAX package's hmc_chain on the CPU in float64: PRNGKey(0), 1024 chains,
# 1000 warmup + 2000 samples, L=32, target_accept 0.9 (split-R-hat 1.000002,
# divergences 0.61%). MC standard error sd/sqrt(ESS) with ESS capped at the
# 2,048,000 draws.
EIGHT_SCHOOLS_MU_MEAN = 4.53634169179409
EIGHT_SCHOOLS_MU_MCSE = 0.0022488537649182944


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, reps: int = 25) -> float:
    """Median of ``reps`` CUDA-event timings of one eager ``fn()`` call,
    after one warm-up: the caller's view, host dispatch included."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def capture(fn, calls: int = 1):
    """``calls`` calls of ``fn`` captured in a CUDA graph, after one warm-up
    call off the default stream (as capture requires): (graph, the last
    call's output, which each replay rewrites)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            out = fn()
    return graph, out


def device_ms(fn, reps: int = 25, calls: int = 10) -> float:
    """Device time of one ``fn()`` call: ``calls`` calls captured in a CUDA
    graph, the graph replayed ``reps`` times between CUDA events, and the
    median replay divided by ``calls``. No host dispatch is in the window."""
    graph, _ = capture(fn, calls)
    graph.replay()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events) / calls


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def bound_ms(n_bytes: float, n_ops: float):
    """(least time in ms, what sets it): bytes over the HBM rate against
    double operations over the FP64 peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP64_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from fugue_tpu_torch.ops import _build, kernels

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source, at once
        paths = list(pool.map(_build.build, SOURCES))
    for name in SOURCES:
        kernels._lib(name)
    emit({
        "phase": "build",
        "seconds": time.perf_counter() - t0,
        "source_hashes": {name: _build.source_hash(name) for name in SOURCES},
        "libraries": [os.path.relpath(path, REPO) for path in paths],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    })


def _plate_inputs(c, n, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    y = 1.5 + 2.0 * torch.randn(n, generator=g, device="cuda", dtype=dtype)
    mu = 1.5 + 0.01 * torch.randn(c, generator=g, device="cuda", dtype=dtype)
    sigma = 2.0 * torch.exp(0.01 * torch.randn(c, generator=g, device="cuda", dtype=dtype))
    return y, mu, sigma


def _hard_plate_inputs(case, dtype, n=(1 << 20) + 17):
    """The cases where moments lose digits that per-row sums keep: data far
    from 0, a first row 1e3 sigma out, mu 1e3 away from ybar (the CPU
    mirror test's cases, tests/test_torch_kernels.py)."""
    g = torch.Generator(device="cuda").manual_seed(17)
    if case == "far_from_zero":
        y = (1e4 + torch.randn(n, generator=g, device="cuda", dtype=torch.float64)).to(dtype)
        off, sigma = [-0.5, 0.05, 1.3], [0.8, 1.0, 1.7]
    else:
        y = (1.5 + 2.0 * torch.randn(n, generator=g, device="cuda", dtype=torch.float64)).to(dtype)
        if case == "outlier_first":
            y[0] = 1.5 + 1e3 * 2.0
            off, sigma = [-0.3, 0.004, 0.7], [1.5, 2.0, 3.0]
        else:  # mu_far
            off, sigma = [1e3, -1e3, 1.5e3], [2.0, 5.0, 50.0]
    mu = (y.double().mean() + torch.tensor(off, dtype=torch.float64, device="cuda")).to(dtype)
    return y, mu, torch.tensor(sigma, dtype=dtype, device="cuda")


PLATE_OUTPUTS = ("value", "dmu", "dsigma")


def _hold_plate_f32(K, y, mu, sigma, what):
    """One float32 value-and-grad call against the plain float32 version
    and a float64 reference, and against itself run again.

    Tolerance, elementwise per chain and output: |kernel - f64| <=
    max(|plain - f64|, eps32 * |f64|). The kernel widens every row to double
    and rounds once at the end, so its error is about half an ulp of the
    result; the plain float32 version rounds every row and partial sum, so
    its error is at least that (eps32*|f64| is one or more ulps and covers a
    plain version that happens to land exactly). Kernel vs plain then
    agrees to the sum of the two errors: |kernel - plain| <= twice that."""
    eps32 = torch.finfo(torch.float32).eps
    got = K.pnormal_loglik_sum_value_and_grad(y, mu, sigma)
    plain = K.normal_loglik_sum_value_and_grad_ref(y, mu, sigma)
    ref = K.normal_loglik_sum_value_and_grad_ref(y.double(), mu.double(), sigma.double())
    errs = {}
    for name, k, p, r in zip(PLATE_OUTPUTS, got, plain, ref):
        check(k.shape == mu.shape and bool(torch.isfinite(k).all()),
              f"{what} {name}: shape {tuple(k.shape)} or non-finite")
        ke, pe, kp = (k.double() - r).abs(), (p.double() - r).abs(), (k.double() - p.double()).abs()
        tol = torch.maximum(pe, eps32 * r.abs())
        check(bool((ke <= tol).all()), f"{what} {name} vs f64: err {ke.tolist()} > tol {tol.tolist()}")
        check(bool((kp <= 2 * tol).all()), f"{what} {name} vs plain: {kp.tolist()} > {(2 * tol).tolist()}")
        errs[name] = {"kernel_vs_f64": ke.max().item(), "plain_vs_f64": pe.max().item(),
                      "kernel_vs_plain": kp.max().item()}
    again = K.pnormal_loglik_sum_value_and_grad(y, mu, sigma)
    check(all(torch.equal(a, b) for a, b in zip(again, got)), f"{what}: not deterministic")
    return errs


def _hold_plate_f64(K, y, mu, sigma, what):
    """One float64 call against the plain float64 version: within 1e-12
    relative (both sum in double; order and the moments' rounding differ),
    and bitwise the same when run again. Returns the relative error."""
    got = K.pnormal_loglik_sum_value_and_grad(y, mu, sigma)
    plain = K.normal_loglik_sum_value_and_grad_ref(y, mu, sigma)
    rel = max(((k - p).abs() / p.abs().clamp(min=1.0)).max().item() for k, p in zip(got, plain))
    check(rel <= 1e-12, f"{what} float64 kernel vs plain: relative error {rel} > 1e-12")
    again = K.pnormal_loglik_sum_value_and_grad(y, mu, sigma)
    check(all(torch.equal(a, b) for a, b in zip(again, got)), f"{what} float64: not deterministic")
    return rel


def _same_special(k, p):
    """The same NaN and +-inf pattern, and finite entries within 1e-5."""
    kf, pf = torch.isfinite(k), torch.isfinite(p)
    return (torch.equal(k.isnan(), p.isnan()) and torch.equal(kf, pf)
            and torch.equal(k[k.isinf()], p[p.isinf()])
            and bool(((k[kf] - p[pf]).abs() <= 1e-5 * p[pf].abs().clamp(min=1.0)).all()))


def phase_kernel():
    """The Gaussian-plate value-and-grad kernel against its plain PyTorch
    version and a float64 reference; times at the main path's shapes."""
    from fugue_tpu_torch.ops import kernels as K

    results = {}
    for c, n in ((1, 1 << 24), MAIN_SHAPE, (3, (1 << 20) + 17)):
        y, mu, sigma = _plate_inputs(c, n, torch.float32, seed=c * 1000 + 7)
        row = {"phase": "kernel", "chains": c, "rows": n, "dtype": "float32",
               "tolerance": "per chain: |kernel-f64| <= max(|plain-f64|, eps32*|f64|), "
                            "|kernel-plain| <= twice that",
               **_hold_plate_f32(K, y, mu, sigma, f"plate at {(c, n)}")}

        def kfn():
            return K.pnormal_loglik_sum_value_and_grad(y, mu, sigma)

        def pfn():
            return K.normal_loglik_sum_value_and_grad_ref(y, mu, sigma)

        # y read once, mu and sigma read and three outputs written once; per
        # row the moments take a subtraction, an add and an FMA in double
        bound, bound_by = bound_ms(4 * n + 5 * 4 * c, 3 * n)
        row.update(kernel_vs_plain=max(row[o]["kernel_vs_plain"] for o in PLATE_OUTPUTS),
                   kernel_ms=device_ms(kfn), plain_ms=device_ms(pfn),
                   kernel_call_ms=median_ms(kfn), plain_call_ms=median_ms(pfn),
                   bound_ms=bound, bound_by=bound_by, library_ms=None,
                   # PyTorch's own one-read reduction over the same bytes: what
                   # a single pass over y takes under this timing (not the
                   # same function, so not library_ms)
                   torch_sum_ms=device_ms(lambda: torch.sum(y)))
        if c == 1:
            # one PyTorch call computes the one-chain value: the Gaussian
            # NLL summed (full=True), i.e. minus the result. It checks
            # var >= 0 on the host, so it cannot be captured in a graph:
            # timed eagerly, that check's sync included.
            def lfn():
                return torch.nn.functional.gaussian_nll_loss(
                    mu.expand(n), y, (sigma * sigma).expand(n), full=True, reduction="sum")
            row["library_ms"] = median_ms(lfn)
            ref = K.normal_loglik_sum_value_and_grad_ref(y.double(), mu.double(), sigma.double())
            row["library_vs_f64"] = (-lfn().double() - ref[0]).abs().max().item()
        results[(c, n)] = row
        emit(row)

    gates = {}
    # y at any element boundary: y[k:] starts k elements past y's start
    y, mu, sigma = _plate_inputs(3, (1 << 20) + 17, torch.float32, seed=3007)
    for k in (1, 2, 3):
        check(y[k:].data_ptr() % 16 != 0, "y[k:] should be unaligned")
        gates[f"f32_y[{k}:]"] = _hold_plate_f32(K, y[k:], mu, sigma, f"plate y[{k}:]")
    y, mu, sigma = _plate_inputs(3, (1 << 20) + 17, torch.float64, seed=11)
    for k in (0, 1):
        gates[f"f64_y[{k}:]_rel"] = _hold_plate_f64(K, y[k:], mu, sigma, f"plate y[{k}:]")
    for case in ("far_from_zero", "outlier_first", "mu_far"):
        gates[f"f32_{case}"] = _hold_plate_f32(K, *_hard_plate_inputs(case, torch.float32), case)
        gates[f"f64_{case}_rel"] = _hold_plate_f64(K, *_hard_plate_inputs(case, torch.float64), case)
    # non-finite rows, and chains whose mu or sigma is not finite or < 0
    for dtype in (torch.float32, torch.float64):
        base = _plate_inputs(1, (1 << 20) + 17, dtype, seed=5)[0]
        mu = torch.tensor([1.4, math.inf, -math.inf, math.nan, 1.4, 1.4, 1.4], dtype=dtype, device="cuda")
        sigma = torch.tensor([2.0, 2.0, 2.0, 2.0, math.inf, -1.0, math.nan], dtype=dtype, device="cuda")
        for special, at in (("nan", {17: math.nan}), ("pos_inf", {17: math.inf, 400000: math.inf}),
                            ("neg_inf", {123: -math.inf}), ("both_inf", {17: math.inf, 400000: -math.inf})):
            y = base.clone()
            for i, v in at.items():
                y[i] = v
            got = K.pnormal_loglik_sum_value_and_grad(y, mu, sigma)
            plain = K.normal_loglik_sum_value_and_grad_ref(y, mu, sigma)
            for name, k, p in zip(PLATE_OUTPUTS, got, plain):
                check(_same_special(k, p), f"special {special} {dtype} {name}: {k.tolist()} vs plain {p.tolist()}")
            check(all(torch.equal(a.nan_to_num(), b.nan_to_num()) for a, b in
                      zip(K.pnormal_loglik_sum_value_and_grad(y, mu, sigma), got)),
                  f"special {special}: not deterministic")
        gates[f"special_{str(dtype)[6:]}"] = "nan, pos_inf, neg_inf, both_inf: plain's pattern"
    # a second derivative raises on the card as on the CPU
    y, mu, sigma = _plate_inputs(1, 4096, torch.float32, seed=1)
    m = mu.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(K.pnormal_loglik_sum(y, m, sigma).sum(), m, create_graph=True)
    try:
        torch.autograd.grad(g.sum(), m)
        raised = False
    except NotImplementedError:
        raised = True
    check(raised, "a second derivative through pnormal_loglik_sum did not raise")
    emit({"phase": "kernel", "gates": gates, "second_derivative_raises": raised})
    return results


def eight_schools_model(device, dtype=torch.float32):
    """Non-centred eight-schools (bench.py's eight_schools_model), its data
    on ``device`` in ``dtype``. The port's one definition of the model: the
    tests and scripts import it from here."""
    import fugue_tpu_torch as ftt

    y = torch.tensor([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0], dtype=dtype, device=device)
    sigma = torch.tensor([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0], dtype=dtype,
                         device=device)

    def eight_schools():
        mu = ftt.sample("mu", ftt.Normal(0.0, 5.0))
        tau = ftt.sample("tau", ftt.LogNormal(0.5, 1.0))
        theta_raw = ftt.sample("theta_raw", ftt.Normal(0.0, 1.0), sample_shape=(8,))
        ftt.observe("y", ftt.Normal(mu + tau * theta_raw, sigma), y)
        return mu

    return eight_schools


def phase_eight_schools():
    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.inference.mcmc_utils import ess_multichain, split_r_hat

    n_chains, n_warmup, n_samples, L = 1024, 200, 200, 32
    staged = ftt.stage(eight_schools_model("cuda"), device="cuda")
    cfg = ftt.HMCConfig(n_leapfrog=L, target_accept=0.9)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ftt.hmc_chain(1, n_samples=n_samples, n_warmup=n_warmup, config=cfg,
                        n_chains=n_chains, staged=staged)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mu_dtype = res.samples["mu"].dtype
    mu = res.samples["mu"].double().cpu()
    check(mu.shape == (n_chains, n_samples) and bool(torch.isfinite(mu).all()),
          f"eight_schools mu samples: shape {tuple(mu.shape)} or non-finite")
    tau = res.samples["tau"].double().cpu()
    # ESS(mu) can reach its cap of chains x samples (antithetic draws), and
    # then cannot show a loss of mixing. ESS(tau), the funnel's slow
    # direction, is reported beside it, and ESS/s reads the smaller of the two.
    ess, ess_tau = ess_multichain(mu).item(), ess_multichain(tau).item()
    rhat = split_r_hat(mu).item()
    div = res.divergences.float().mean().item()
    mean, sd = mu.mean().item(), mu.std().item()
    mcse = sd / math.sqrt(ess)
    z = (mean - EIGHT_SCHOOLS_MU_MEAN) / math.hypot(mcse, EIGHT_SCHOOLS_MU_MCSE)
    grad_evals = n_chains * (n_warmup + n_samples) * (L + 1)
    emit({"phase": "eight_schools", "chains": n_chains, "warmup": n_warmup,
          "samples": n_samples, "n_leapfrog": L, "dtype": str(mu_dtype), "wall_s": wall,
          "grad_evals_per_s": grad_evals / wall, "ess_mu": ess,
          "ess_mu_capped": ess >= n_chains * n_samples, "ess_tau": ess_tau,
          "ess_per_s": min(ess, ess_tau) / wall, "split_rhat_mu": rhat, "divergence_rate": div,
          "mu_mean": mean, "mu_sd": sd, "mu_ref": EIGHT_SCHOOLS_MU_MEAN,
          "mu_z": z, "step_size": res.step_size})
    check(rhat < 1.02, f"eight_schools split-R-hat(mu) {rhat} >= 1.02")
    check(div < 0.02, f"eight_schools divergence rate {div} >= 0.02")
    check(abs(z) < 5.0, f"eight_schools mu mean {mean} is {z:.2f} MC-SE from {EIGHT_SCHOOLS_MU_MEAN}")


def plate_data(n):
    """n rows from N(1.5, 2^2), made on the card from a seeded generator."""
    g = torch.Generator(device="cuda").manual_seed(2)
    return 1.5 + 2.0 * torch.randn(n, generator=g, device="cuda")


def plate_model(y, runs=None):
    """mu ~ N(0, 10), sigma ~ LogNormal(0, 1), the plate likelihood through
    the CUDA kernel. ``runs[0]`` counts batched model evaluations."""
    import fugue_tpu_torch as ftt

    def plate():
        if runs is not None:
            runs[0] += 1
        mu = ftt.sample("mu", ftt.Normal(0.0, 10.0))
        sigma = ftt.sample("sigma", ftt.LogNormal(0.0, 1.0))
        ftt.factor(ftt.pnormal_loglik_sum(y, mu, sigma))

    return plate


def phase_gaussian_plate():
    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.inference.mcmc_utils import ess_multichain, split_r_hat
    from fugue_tpu_torch.ops import kernels as K

    n_chains, n_warmup, n_samples, L = MAIN_SHAPE[0], 200, 200, 16
    n = MAIN_SHAPE[1]
    y = plate_data(n)
    model_runs = [0]
    staged = ftt.stage(plate_model(y, model_runs), device="cuda")
    cfg = ftt.HMCConfig(n_leapfrog=L, jitter=0.5)
    torch.cuda.synchronize()
    model_runs[0] = 0
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    res = ftt.hmc_chain(3, n_samples=n_samples, n_warmup=n_warmup, config=cfg,
                        n_chains=n_chains, staged=staged)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)

    y64 = y.double()
    ybar, s = y64.mean().item(), y64.std(correction=0).item()
    mu = res.samples["mu"].double().cpu()
    sig = res.samples["sigma"].double().cpu()
    for name, x in (("mu", mu), ("sigma", sig)):
        check(x.shape == (n_chains, n_samples) and bool(torch.isfinite(x).all()),
              f"plate {name} samples: shape {tuple(x.shape)} or non-finite")
    mu_z = (mu.mean().item() - ybar) / (s / math.sqrt(n))
    sig_z = (sig.mean().item() - s) / (s / math.sqrt(2 * n))
    rhat = max(split_r_hat(mu).item(), split_r_hat(sig).item())
    ess = min(ess_multichain(mu).item(), ess_multichain(sig).item())
    n_transitions = n_warmup + n_samples
    grad_evals = n_transitions * (L + 1)
    emit({"phase": "gaussian_plate", "chains": n_chains, "rows": n,
          "warmup": n_warmup, "samples": n_samples, "n_leapfrog": L,
          "dtype": str(res.samples["mu"].dtype),
          "wall_s": wall, "grad_evals_per_s": n_chains * grad_evals / wall,
          "rows_per_s": n_chains * grad_evals * n / wall,
          "ess_min": ess, "ess_per_sampling_grad_eval": ess / (n_chains * n_samples * (L + 1)),
          "mu_mean": mu.mean().item(), "ybar": ybar, "mu_z": mu_z,
          "sigma_mean": sig.mean().item(), "sample_sd": s, "sigma_z": sig_z,
          "max_split_rhat": rhat,
          "divergence_rate": res.divergences.float().mean().item(),
          "batched_model_runs": model_runs[0], "launches": launches,
          "step_size": res.step_size})
    check(abs(mu_z) < 5.0, f"plate mu mean is {mu_z:.2f} s/sqrt(N) from ybar")
    check(abs(sig_z) < 5.0, f"plate sigma mean is {sig_z:.2f} s/sqrt(2N) from s")
    check(rhat < 1.05, f"plate max split-R-hat {rhat} >= 1.05")
    # one value-and-grad call per batched model run (never one per chain),
    # the final constrain pass included
    check(launches["nll"] > 0 and launches["nll"] == model_runs[0],
          f"{launches['nll']} plate kernel calls for {model_runs[0]} batched model runs")
    check(launches["nll"] < 2 * grad_evals,
          f"{launches['nll']} plate kernel calls for {grad_evals} batched gradients")
    return launches


def hierarchical_model(device, dtype=torch.float32):
    """bench.py's 20-site hierarchical_model (17 groups of 5 observations),
    its data on ``device`` in ``dtype``. The port's one definition of the
    model: the tests import it from here."""
    import fugue_tpu_torch as ftt

    n_groups = 17
    data = torch.as_tensor(np.random.default_rng(0).normal(0.5, 1.0, (n_groups, 5)),
                           dtype=dtype, device=device)

    def hierarchical():
        mu = ftt.sample("mu", ftt.Normal(0.0, 2.0))
        tau = ftt.sample("tau", ftt.LogNormal(0.0, 0.5))
        sigma = ftt.sample("sigma", ftt.LogNormal(0.0, 0.5))
        thetas = []
        for i in range(n_groups):
            theta_i = ftt.sample(ftt.addr("theta", i), ftt.Normal(mu, tau))
            ftt.observe(ftt.addr("y", i), ftt.Normal(theta_i, sigma), data[i])
            thetas.append(theta_i)
        return thetas

    return hierarchical


def conjugate_data():
    return np.random.default_rng(7).normal(0.3, 1.0, 32)


def conjugate_evidence_model(device, dtype=torch.float32):
    """bench.py's conjugate_evidence_model: mu ~ N(0, 1), 32 y_i ~ N(mu, 1)."""
    import fugue_tpu_torch as ftt

    y = torch.as_tensor(conjugate_data(), dtype=dtype, device=device)

    def conjugate():
        mu = ftt.sample("mu", ftt.Normal(0.0, 1.0))
        ftt.observe("y", ftt.Normal(mu, 1.0), y)
        return mu

    return conjugate


def conjugate_log_evidence() -> float:
    """Closed-form log-evidence of ``conjugate_evidence_model``: y is
    multivariate normal with covariance I + 11^T."""
    y = conjugate_data()
    n = y.size
    quad = float(y @ y - (y.sum() ** 2) / (1.0 + n))
    return -0.5 * (n * math.log(2 * math.pi) + math.log(1.0 + n) + quad)


def _lse_inputs(n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    finite = 10.0 * torch.randn(n + 1, generator=g, device="cuda")
    ninf = torch.full((n,), -math.inf, device="cuda")
    one = ninf.clone()
    one[n // 3] = 3.0
    z = torch.randn(n, generator=g, device="cuda", dtype=torch.float64)
    outlier = z.float()
    outlier[n // 2] = 50.0  # one weight e^50 above the rest
    return {"normal_x10": finite[:n], "normal_x10[1:]": finite[1:], "all_neg_inf": ninf,
            "one_finite": one, "near_+1e4": (1e4 + z).float(), "near_-1e4": (-1e4 + z).float(),
            "one_outlier": outlier}


def _same_from_graph(fn, what):
    """``fn()`` captured in a CUDA graph and replayed twice gives the eager
    call's result bitwise: the kernels reset what they need inside the call."""
    want = fn()
    graph, out = capture(fn)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(out, want), f"{what}: a graph replay differs from the eager call")


def _exact_systematic(logits64: np.ndarray, u0: float) -> np.ndarray:
    """Systematic resampling in float64 numpy: the exact reference."""
    n = logits64.size
    w = np.exp(logits64 - np.max(logits64))
    cdf = np.cumsum(w / np.sum(w))
    us = (np.arange(n) + u0) / n
    return np.clip(np.searchsorted(cdf, us, side="left"), 0, n - 1)


def _check_indices(idx, n, what):
    check(idx.dtype == torch.int64 and idx.shape == (n,), f"{what}: {idx.dtype} {tuple(idx.shape)}")
    check(bool((idx[1:] >= idx[:-1]).all()), f"{what}: indices not sorted")
    check(int(idx[0]) >= 0 and int(idx[-1]) < n, f"{what}: indices out of range")


def phase_smc_kernels():
    """logsumexp and systematic resampling against their plain versions.

    logsumexp tolerance (float32): |kernel - f64| <= max(|plain - f64|,
    eps32 * |f64|), as for the plate kernel: the kernel sums in double and
    rounds once. Infinite results must match exactly. float64 input: within
    1e-12 relative of the plain float64 version.

    Resampling: at 2^17 float32 logits (normal x 4) against an exact float64
    reference with the same u0, the JAX package's contract: max ancestor
    deviation <= max(4, 2 x the plain float32 version's), and fewer than 2%
    of slots differ. float64 input: deviation <= 1 on fewer than 0.1% of
    slots against the plain float64 version. Every output sorted, in range
    and the same from run to run.
    """
    from fugue_tpu_torch.ops import kernels as K

    eps32 = torch.finfo(torch.float32).eps
    rows = {}
    for n in (N_PARTICLES, 1 << 24, 3 * 8192 + 17):
        for kind, x in _lse_inputs(n, seed=n % 1000).items():
            k, p, r = K.plogsumexp(x), K.logsumexp_ref(x), K.logsumexp_ref(x.double())
            check(k.dtype == torch.float32 and k.dim() == 0, f"lse output {k.dtype} {k.shape}")
            check(torch.equal(K.plogsumexp(x), k), f"lse not deterministic at {n} {kind}")
            row = {"phase": "smc_kernels", "kernel": "logsumexp", "n": n, "input": kind,
                   "kernel_value": k.item(), "plain_value": p.item(), "f64_value": r.item()}
            if math.isfinite(r.item()):
                ke, pe = abs(k.double().item() - r.item()), abs(p.double().item() - r.item())
                tol = max(pe, eps32 * abs(r.item()))
                row.update(kernel_vs_f64=ke, plain_vs_f64=pe, tolerance=tol,
                           kernel_vs_plain=abs(k.item() - p.item()))
                check(ke <= tol, f"lse at {n} {kind}: |kernel - f64| {ke} > {tol}")
            else:
                check(k.item() == r.item() == p.item(), f"lse at {n} {kind}: {k} {p} {r}")
                row["kernel_vs_plain"] = 0.0
            if kind == "normal_x10":
                _same_from_graph(lambda: K.plogsumexp(x), f"lse at {n}")
            if kind == "normal_x10" and n in (N_PARTICLES, 1 << 24):
                n_bytes, n_ops = 4 * n + 4, 4 * n  # x read once; sub, exp, add, compare
                row.update(kernel_ms=device_ms(lambda: K.plogsumexp(x)),
                           plain_ms=device_ms(lambda: K.logsumexp_ref(x)),
                           library_ms=device_ms(lambda: torch.logsumexp(x, 0)))
                row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_ops)
                rows[("lse", n)] = row
            emit(row)
    for special, want in ((math.nan, "nan"), (math.inf, "inf")):
        x = torch.zeros(N_PARTICLES, device="cuda")
        x[7] = special
        got = K.plogsumexp(x).item()
        check((math.isnan(got) if want == "nan" else got == math.inf), f"lse of a {want} input: {got}")
        x64 = torch.zeros(N_PARTICLES, device="cuda", dtype=torch.float64)
        x64[7] = special
        got = K.plogsumexp(x64).item()
        check((math.isnan(got) if want == "nan" else got == math.inf), f"lse f64 of a {want}: {got}")
    rel = 0.0
    for n in (3 * 8192 + 17, N_PARTICLES, 1 << 20):
        x64 = 10.0 * torch.randn(n + 1, device="cuda", dtype=torch.float64)
        for x in (x64[:n], x64[1:], 1e4 + x64[:n]):
            k, p = K.plogsumexp(x), K.logsumexp_ref(x)
            rel = max(rel, abs(k.item() - p.item()) / abs(p.item()))
            check(torch.equal(K.plogsumexp(x), k), f"lse float64 not deterministic at {n}")
    check(rel <= 1e-12, f"lse float64 kernel vs plain: {rel}")
    x64 = torch.full((N_PARTICLES,), -math.inf, device="cuda", dtype=torch.float64)
    check(K.plogsumexp(x64).item() == -math.inf, "lse f64 of all -inf")
    _same_from_graph(lambda: K.plogsumexp(x64[1:] + 1.0), "lse float64")
    emit({"phase": "smc_kernels", "kernel": "logsumexp", "dtype": "float64", "max_rel_err": rel})

    g = torch.Generator(device="cuda").manual_seed(5)
    # the JAX package's contract at 2^17 float32 (tests/test_pallas_kernels.py)
    n = N_PARTICLES
    logits = np.random.default_rng(7).normal(size=n) * 4.0
    lw32 = torch.as_tensor(logits, dtype=torch.float32, device="cuda")
    for u0v in (torch.rand((), generator=g, device="cuda").item(), 0.0, 1.0 - 2.0**-24):
        u0 = torch.tensor(u0v, dtype=torch.float32, device="cuda")
        got = K.systematic_resample_from_u0(lw32, u0)
        _check_indices(got, n, f"resample f32 u0={u0v}")
        check(torch.equal(got, K.systematic_resample_from_u0(lw32, u0)),
              f"resample not deterministic, u0={u0v}")
        ref = torch.as_tensor(_exact_systematic(logits, float(u0.item())), device="cuda")
        plain = K.systematic_resample_ref(u0, torch.exp(lw32 - K.logsumexp_ref(lw32)))
        floor = (plain - ref).abs().max().item()
        dev = (got - ref).abs()
        row = {"phase": "smc_kernels", "kernel": "systematic_resample", "n": n, "dtype": "float32",
               "u0": u0v, "max_dev_vs_f64": dev.max().item(), "plain_max_dev_vs_f64": floor,
               "frac_differ": (dev > 0).float().mean().item(),
               "kernel_vs_plain": (got - plain).abs().max().item(),
               "tolerance": "max dev <= max(4, 2 * plain's), < 2% differ"}
        check(row["max_dev_vs_f64"] <= max(4, 2 * floor) and row["frac_differ"] < 0.02,
              f"resample f32 contract: {row}")
        emit(row)
    # the same contract from an unaligned view, lw32[1:]
    u0 = torch.tensor(0.37, device="cuda")
    got = K.systematic_resample_from_u0(lw32[1:], u0)
    _check_indices(got, n - 1, "resample f32 from lw[1:]")
    ref = torch.as_tensor(_exact_systematic(logits[1:], float(u0.item())), device="cuda")
    plain = K.systematic_resample_ref(u0, torch.exp(lw32[1:] - K.logsumexp_ref(lw32[1:])))
    floor, dev = (plain - ref).abs().max().item(), (got - ref).abs()
    check(dev.max().item() <= max(4, 2 * floor) and (dev > 0).float().mean().item() < 0.02,
          f"resample f32 contract from lw[1:]: max dev {dev.max().item()}, plain {floor}")
    _same_from_graph(lambda: K.systematic_resample_from_u0(lw32, u0), "resample f32")
    # times at the weights a ladder stage resamples: ESS about N/2
    lw_main = torch.as_tensor(np.random.default_rng(8).normal(size=n) * 0.83,
                              dtype=torch.float32, device="cuda")
    u0 = torch.rand((), generator=g, device="cuda")
    got = K.systematic_resample_from_u0(lw_main, u0)
    _check_indices(got, n, "resample f32, ESS about N/2")

    def plain_fn():
        return K.systematic_resample_ref(u0, torch.exp(lw_main - K.logsumexp_ref(lw_main)))

    row = {"phase": "smc_kernels", "kernel": "systematic_resample", "n": n, "dtype": "float32",
           "weights": "normal x 0.83 (ESS about N/2)",
           "kernel_vs_plain": (got - plain_fn()).abs().max().item(),
           "kernel_ms": device_ms(lambda: K.systematic_resample_from_u0(lw_main, u0)),
           "plain_ms": device_ms(plain_fn), "library_ms": None}
    # lw read once, the int64 indices written once; per element an exp, a
    # subtraction, a scan add and the count's four operations
    row["bound_ms"], row["bound_by"] = bound_ms(12 * n + 4, 7 * n)
    rows[("resample", n)] = row
    emit(row)
    # the same weights at 2^24: device time and bound only
    big = torch.as_tensor(np.random.default_rng(9).normal(size=1 << 24) * 0.83,
                          dtype=torch.float32, device="cuda")
    _check_indices(K.systematic_resample_from_u0(big, u0), 1 << 24, "resample f32 at 2^24")
    big_bound, big_by = bound_ms(12 * (1 << 24) + 4, 7 * (1 << 24))
    emit({"phase": "smc_kernels", "kernel": "systematic_resample", "n": 1 << 24,
          "dtype": "float32", "weights": "normal x 0.83",
          "kernel_ms": device_ms(lambda: K.systematic_resample_from_u0(big, u0)),
          "bound_ms": big_bound, "bound_by": big_by})
    del big
    # float64 against the plain float64 version, at 2^20 and a ragged size
    for n_all in (1 << 20, 5 * 2048 + 17, N_PARTICLES):
        lw64_all = 3.0 * torch.randn(n_all, generator=g, device="cuda", dtype=torch.float64)
        for u0v, view in ((0.0, slice(None)), (0.37, slice(None)), (1.0 - 2.0**-52, slice(None)),
                          (0.37, slice(1, None))):
            u0 = torch.tensor(u0v, dtype=torch.float64, device="cuda")
            lw64 = lw64_all[view]
            n = lw64.numel()
            got = K.systematic_resample_from_u0(lw64, u0)
            _check_indices(got, n, f"resample f64 n={n} u0={u0v}")
            plain = K.systematic_resample_ref(u0, torch.exp(lw64 - K.logsumexp_ref(lw64)))
            dev = (got - plain).abs()
            check(dev.max().item() <= 1 and (dev > 0).float().mean().item() < 1e-3,
                  f"resample f64 n={n} u0={u0v}: max dev {dev.max().item()}, "
                  f"{(dev > 0).float().mean().item()} differ")
            got32 = K.systematic_resample_from_u0(lw64.float(), u0.float())
            _check_indices(got32, n, f"resample f32 n={n} u0={u0v}")
            check(torch.equal(got32, K.systematic_resample_from_u0(lw64.float(), u0.float())),
                  f"resample f32 not deterministic at n={n}")
        emit({"phase": "smc_kernels", "kernel": "systematic_resample", "n": n_all, "dtype": "float64",
              "max_dev_vs_plain": dev.max().item(), "frac_differ": (dev > 0).float().mean().item()})
    _same_from_graph(lambda: K.systematic_resample_from_u0(lw64_all[1:], u0), "resample f64")
    # degenerate weights, in both dtypes: one particle takes every slot (one
    # tile owns all), two share them equally; no finite weight, a NaN or a
    # +inf weight gives the identity
    ident = torch.arange(N_PARTICLES, device="cuda")
    for dt in (torch.float32, torch.float64):
        half = torch.tensor(0.5, device="cuda", dtype=dt)
        lw = torch.full((N_PARTICLES,), -math.inf, device="cuda", dtype=dt)
        check(torch.equal(K.systematic_resample_from_u0(lw, half), ident), f"resample all -inf {dt}")
        lw[12345] = 0.0
        got = K.systematic_resample_from_u0(lw, half)
        check(bool((got == 12345).all()), f"resample of one live particle {dt}")
        lw[100000] = 0.0
        got = K.systematic_resample_from_u0(lw, half)
        check(int((got == 12345).sum()) == N_PARTICLES // 2
              and int((got == 100000).sum()) == N_PARTICLES // 2, f"resample of two live particles {dt}")
        for special in (math.nan, math.inf):
            lw_s = lw.clone()
            lw_s[777] = special
            check(torch.equal(K.systematic_resample_from_u0(lw_s, half), ident),
                  f"resample with a {special} weight {dt}: not the identity")
    # the least a one-launch design can take: an in-place add on one element
    one = torch.zeros(1, device="cuda")
    rows["launch_floor_ms"] = device_ms(lambda: one.add_(1.0))
    emit({"phase": "smc_kernels", "launch_floor_ms": rows["launch_floor_ms"]})
    return rows


def _smc_run(name, staged, n, seed, config):
    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.ops import kernels as K

    torch.cuda.synchronize()
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    res = ftt.adaptive_smc(seed, n, staged=staged, config=config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    mu = res.particles["mu"]
    check(mu.shape == (n,) and bool(torch.isfinite(mu).all()), f"{name}: mu {tuple(mu.shape)} or non-finite")
    check(abs(res.weights.double().sum().item() - 1.0) < 1e-4, f"{name}: weights do not sum to 1")
    mean = res.posterior_mean("mu").item()
    sd = math.sqrt(res.posterior_var("mu").item())
    row = {"phase": "smc", "run": name, "particles": n, "dtype": str(mu.dtype),
           "rejuvenation": config.rejuvenation, "rejuvenation_steps": config.rejuvenation_steps,
           "wall_s": wall, "particle_stages_per_s": n * res.n_stages / wall,
           "stages": res.n_stages, "beta": res.beta, "log_evidence": res.log_evidence,
           "ess": res.ess, "mu_mean": mean, "mu_sd": sd, "launches": launches}
    check(res.converged and res.beta == 1.0, f"{name}: not converged, beta {res.beta}")
    # No terminal resample: every stage but the last (beta = 1) resampled.
    # logsumexp per stage: 2 in _next_beta's ESS, 1 to normalise, 1 for the
    # evidence increment (the resample takes its own lse, not plogsumexp);
    # at the end 1 to normalise and 2 for the ESS: 4 * stages + 3.
    s = res.n_stages
    check(launches["resample"] == s - 1, f"{name}: {launches['resample']} resample launches, {s} stages")
    check(launches["lse"] == 4 * s + 3, f"{name}: {launches['lse']} logsumexp launches, want {4 * s + 3}")
    return row


def phase_smc():
    import fugue_tpu_torch as ftt

    launches = {"lse": 0, "resample": 0}
    staged = ftt.stage(hierarchical_model("cuda"), device="cuda")
    runs = (("hierarchical_mh", "mh", 3, ftt.SMCConfig(rejuvenation_steps=3)),
            ("hierarchical_hmc", "hmc", 13,
             ftt.SMCConfig(rejuvenation="hmc", rejuvenation_steps=1, hmc_leapfrog=16)))
    for name, mode, seed, cfg in runs:
        row = _smc_run(name, staged, N_PARTICLES, seed, cfg)
        ref = SMC_MU[mode]
        mcse = math.hypot(ref["MU_RUN_SD"], ref["MU_RUN_SD"] / math.sqrt(SMC_MU_RUNS))
        row.update(mu_ref=ref["MU_MEAN"], mu_mcse=mcse, mu_z=(row["mu_mean"] - ref["MU_MEAN"]) / mcse)
        emit(row)
        check(abs(row["mu_z"]) < 5.0, f"{name}: mu mean {row['mu_mean']} is {row['mu_z']:.2f} MC-SE "
              f"from {ref['MU_MEAN']}")
        for k in launches:
            launches[k] += row["launches"][k]
    staged_c = ftt.stage(conjugate_evidence_model("cuda"), device="cuda")
    row = _smc_run("conjugate", staged_c, 8192, 33, ftt.SMCConfig(rejuvenation_steps=3))
    exact = conjugate_log_evidence()
    row.update(log_evidence_exact=exact, log_evidence_err=row["log_evidence"] - exact)
    emit(row)
    check(abs(row["log_evidence_err"]) < 0.1, f"conjugate log Z {row['log_evidence']} vs {exact}")
    for k in launches:
        launches[k] += row["launches"][k]
    return launches


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    import fugue_tpu_torch  # noqa: F401  (fails outside a checkout)

    kernel_rows = launches = smc_rows = smc_launches = None
    if "build" in phases:
        phase_build()
    if "kernel" in phases:
        kernel_rows = phase_kernel()
    if "eight_schools" in phases:
        phase_eight_schools()
    if "gaussian_plate" in phases:
        launches = phase_gaussian_plate()
    if "smc_kernels" in phases:
        smc_rows = phase_smc_kernels()
    if "smc" in phases:
        smc_launches = phase_smc()

    print(card_line(), flush=True)
    if set(phases) != set(PHASES):
        emit({"partial": phases})
        return 0

    def entry(name, key, source, row, n_launches):
        return {"name": name, "route": "cuda", "source": f"fugue_tpu_torch/csrc/{source}.cu",
                "replaces": REPLACES[key], "launches": n_launches,
                "max_abs_err": row["kernel_vs_plain"], "ms": row["kernel_ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    emit({"kernels": [
        entry("normal_loglik_sum_value_and_grad", "nll", "normal_loglik_sum",
              kernel_rows[MAIN_SHAPE], launches["nll"]),
        entry("logsumexp", "lse", "logsumexp", smc_rows[("lse", N_PARTICLES)],
              smc_launches["lse"]),
        entry("systematic_resample", "resample", "systematic_resample",
              smc_rows[("resample", N_PARTICLES)], smc_launches["resample"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
