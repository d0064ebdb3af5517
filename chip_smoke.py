#!/usr/bin/env python3
"""Drive the PyTorch port's HMC main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py                      # all phases
    python3 chip_smoke.py --phases build,kernel

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. build         nvcc-build (or load) the CUDA kernel library from
                 fugue_tpu_torch/csrc.
2. kernel        the Gaussian-plate kernels against their plain PyTorch
                 versions and a float64 reference, in float32, at
                 (C, N) = (1, 2^24), (64, 2^20), (3, 2^20 + 17), plus a
                 float64 launch and a run-to-run determinism check. Times:
                 device time per call (CUDA-graph replays) and the eager
                 call's time (host dispatch included), each the median of
                 25 CUDA-event-timed repetitions, for kernel and plain.
3. eight_schools vectorized HMC, 1024 chains, L=32, target_accept 0.9,
                 200 warmup + 200 samples; gates on split-R-hat, divergence
                 rate and the posterior mean of mu.
4. gaussian_plate HMC on a 2^20-row Gaussian plate whose likelihood runs
                 through the CUDA kernels (64 chains, L=16, jitter 0.5,
                 200 + 200); gates on the posterior of (mu, sigma), R-hat and
                 the kernels' launch counts.

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

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "kernel", "eight_schools", "gaussian_plate")
SOURCE = "fugue_tpu_torch/csrc/normal_loglik_sum.cu"
REPLACES = {
    "fwd": "fugue_tpu/ops/pallas_kernels.py:310",  # _nll_fwd_kernel
    "bwd": "fugue_tpu/ops/pallas_kernels.py:332",  # _nll_bwd_kernel
}
MAIN_SHAPE = (64, 1 << 20)  # (chains, rows) of the plate phase

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


def device_ms(fn, reps: int = 25, calls: int = 10) -> float:
    """Device time of one ``fn()`` call: ``calls`` calls captured in a CUDA
    graph, the graph replayed ``reps`` times between CUDA events, and the
    median replay divided by ``calls``. No host dispatch is in the window."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the default stream, as capture requires
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
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


def phase_build():
    from fugue_tpu_torch.ops import _build, kernels

    t0 = time.perf_counter()
    path = _build.build("normal_loglik_sum")
    kernels._lib()
    emit({
        "phase": "build",
        "seconds": time.perf_counter() - t0,
        "source_hash": _build.source_hash("normal_loglik_sum"),
        "library": os.path.relpath(path, REPO),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    })


def _plate_inputs(c, n, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    y = 1.5 + 2.0 * torch.randn(n, generator=g, device="cuda", dtype=dtype)
    mu = 1.5 + 0.01 * torch.randn(c, generator=g, device="cuda", dtype=dtype)
    sigma = 2.0 * torch.exp(0.01 * torch.randn(c, generator=g, device="cuda", dtype=dtype))
    return y, mu, sigma


def phase_kernel():
    """Kernel vs plain float32 vs float64 reference.

    Tolerance, elementwise per chain, for the forward and both gradients:
    |kernel - f64| <= max(|plain - f64|, eps32 * |f64|). The kernel widens
    every element to double and rounds once at the end, so its error is at
    most half an ulp of the result; the plain float32 version rounds every
    element and partial sum, so its error is at least that (eps32*|f64| is
    one or more ulps and covers a plain version that happens to land
    exactly). Kernel vs plain then agrees to the sum of the two errors:
    |kernel - plain| <= 2 * max(|plain - f64|, eps32 * |f64|).
    """
    from fugue_tpu_torch.ops import kernels as K

    eps32 = torch.finfo(torch.float32).eps
    results = {}
    for c, n in ((1, 1 << 24), MAIN_SHAPE, (3, (1 << 20) + 17)):
        y, mu, sigma = _plate_inputs(c, n, torch.float32, seed=c * 1000 + 7)
        y64, mu64, s64 = y.double(), mu.double(), sigma.double()
        got = {"fwd": [K.pnormal_loglik_sum(y, mu, sigma)],
               "bwd": list(K.pnormal_loglik_sum_grad(y, mu, sigma))}
        plain = {"fwd": [K.normal_loglik_sum_ref(y, mu, sigma)],
                 "bwd": list(K.normal_loglik_sum_grad_ref(y, mu, sigma))}
        ref = {"fwd": [K.normal_loglik_sum_ref(y64, mu64, s64)],
               "bwd": list(K.normal_loglik_sum_grad_ref(y64, mu64, s64))}
        row = {"phase": "kernel", "chains": c, "rows": n, "dtype": "float32",
               "tolerance": "per chain: |kernel-f64| <= max(|plain-f64|, eps32*|f64|), "
                            "|kernel-plain| <= twice that", "eps32": eps32}
        for d in ("fwd", "bwd"):
            k_err = p_err = kp_err = 0.0
            for k, p, r in zip(got[d], plain[d], ref[d]):
                check(k.shape == (c,) and bool(torch.isfinite(k).all()),
                      f"{d} kernel output at {(c, n)}: shape {tuple(k.shape)} or non-finite")
                ke = (k.double() - r).abs()
                pe = (p.double() - r).abs()
                tol = torch.maximum(pe, eps32 * r.abs())
                kp = (k.double() - p.double()).abs()
                check(bool((ke <= tol).all()),
                      f"{d} kernel vs f64 at {(c, n)}: err {ke.tolist()} > tol {tol.tolist()}")
                check(bool((kp <= 2 * tol).all()),
                      f"{d} kernel vs plain at {(c, n)}: {kp.tolist()} > {(2 * tol).tolist()}")
                k_err, p_err = max(k_err, ke.max().item()), max(p_err, pe.max().item())
                kp_err = max(kp_err, kp.max().item())
            again = ([K.pnormal_loglik_sum(y, mu, sigma)] if d == "fwd"
                     else list(K.pnormal_loglik_sum_grad(y, mu, sigma)))
            check(all(torch.equal(a, b) for a, b in zip(again, got[d])),
                  f"{d} kernel is not deterministic at {(c, n)}")
            kfn = ((lambda: K.pnormal_loglik_sum(y, mu, sigma)) if d == "fwd"
                   else (lambda: K.pnormal_loglik_sum_grad(y, mu, sigma)))
            pfn = ((lambda: K.normal_loglik_sum_ref(y, mu, sigma)) if d == "fwd"
                   else (lambda: K.normal_loglik_sum_grad_ref(y, mu, sigma)))
            row[d] = {"kernel_vs_f64": k_err, "plain_vs_f64": p_err,
                      "kernel_vs_plain": kp_err,
                      "kernel_ms": device_ms(kfn), "plain_ms": device_ms(pfn),
                      "kernel_call_ms": median_ms(kfn), "plain_call_ms": median_ms(pfn)}
            results[(c, n, d)] = row[d]
        emit(row)

    # float64 inputs take the f64 entry points: agree with the plain f64
    # version to 1e-12 relative (both sum in double; only order differs)
    y, mu, sigma = _plate_inputs(3, (1 << 20) + 17, torch.float64, seed=11)
    pairs = [(K.pnormal_loglik_sum(y, mu, sigma), K.normal_loglik_sum_ref(y, mu, sigma))]
    pairs += list(zip(K.pnormal_loglik_sum_grad(y, mu, sigma),
                      K.normal_loglik_sum_grad_ref(y, mu, sigma)))
    rel = max(((k - p).abs() / p.abs().clamp(min=1.0)).max().item() for k, p in pairs)
    check(rel <= 1e-12, f"float64 kernel vs plain: relative error {rel} > 1e-12")
    emit({"phase": "kernel", "chains": 3, "rows": (1 << 20) + 17, "dtype": "float64",
          "max_rel_err": rel, "tolerance": 1e-12})
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
    check(launches["fwd"] > 0 and launches["bwd"] > 0, f"kernel not launched: {launches}")
    # one forward launch per batched model run (never one per chain); every
    # run but the final constrain pass takes a gradient
    check(launches["fwd"] == model_runs[0],
          f"{launches['fwd']} forward launches for {model_runs[0]} batched model runs")
    check(launches["bwd"] == launches["fwd"] - 1,
          f"{launches['bwd']} backward launches, expected {launches['fwd'] - 1}")
    check(launches["fwd"] < 2 * grad_evals,
          f"{launches['fwd']} forward launches for {grad_evals} batched gradients")
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

    kernel_rows = launches = None
    if "build" in phases:
        phase_build()
    if "kernel" in phases:
        kernel_rows = phase_kernel()
    if "eight_schools" in phases:
        phase_eight_schools()
    if "gaussian_plate" in phases:
        launches = phase_gaussian_plate()

    print(card_line(), flush=True)
    if set(phases) != set(PHASES):
        emit({"partial": phases})
        return 0
    emit({"kernels": [
            {"name": f"normal_loglik_sum_{d}", "route": "cuda", "source": SOURCE,
             "replaces": REPLACES[d], "launches": launches[d],
             "max_abs_err": kernel_rows[(*MAIN_SHAPE, d)]["kernel_vs_plain"],
             "ms": kernel_rows[(*MAIN_SHAPE, d)]["kernel_ms"],
             "plain_ms": kernel_rows[(*MAIN_SHAPE, d)]["plain_ms"]}
            for d in ("fwd", "bwd")
        ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
