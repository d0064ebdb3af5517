#!/usr/bin/env python3
"""Drive the PyTorch port's HMC, SMC, NUTS, ChEES, MH, VI, ABC and other engines' main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py                      # all phases
    python3 chip_smoke.py --phases build,kernel
    python3 chip_smoke.py --phases build,smc_kernels,smc
    python3 chip_smoke.py --phases build,nuts_eight_schools,nuts_plate
    python3 chip_smoke.py --phases build,smc_coin,smc_mixture,smc_discrete
    python3 chip_smoke.py --phases build,chees_eight_schools,chees_plate,mh_coin,mh_hierarchical
    python3 chip_smoke.py --phases build,vi_hierarchical,vi_plate,vi_scale,abc_rejection,abc_smc
    python3 chip_smoke.py --phases logistic_scale,laplace_regression,marginal_gmm,gibbs_mixed
    python3 chip_smoke.py --phases ess_gp,pt_bimodal,validation_conjugate,sbc_normal,mh_transdimensional

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
                 131,072 particles, 2^24 / 2^20, 2,048 and ragged sizes, from
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
7. nuts_eight_schools  ftt.nuts_chain at bench_nuts's shape: 1024 chains,
                 NUTSConfig() (max_depth 8, target 0.8, diagonal mass),
                 float32, 100 warmup + 100 samples (cut from 200 + 200 when
                 the other engines' phases joined the smoke); gates on
                 split-R-hat, divergence rate and the posterior mean of mu
                 (the HMC phase's constant: the same posterior). Reports
                 grad-evals/s, ESS/s, mean tree depth, the lock-step leaves
                 per transition (batch maximum) beside each chain's mean,
                 and host syncs per transition.
8. nuts_plate    ftt.nuts_chain on the 2^20-row plate (64 chains, uniform
                 init, 100 + 100, cut from 200 + 200, diagonal mass); the
                 HMC plate's gates and
                 one kernel call per batched model run.
9. smc_coin      ftt.adaptive_smc, float32, 131,072 particles, on the
                 Beta-Bernoulli coin flip (BASELINE config 1), with 3 MH
                 moves and with one 16-leapfrog HMC move (gradients through
                 Beta and the Sigmoid Jacobian); gates on log Z against the
                 exact log B(20, 11) - log B(2, 2) and mean p against 20/31.
10. smc_mixture  the same on the Gaussian mixture of examples/mixture_models.py
                 (BASELINE config 4: a guard, a Beta weight, a factor), 5 MH
                 moves; gates on mu0, mu1, w and log Z against the JAX
                 package's constants (scripts/smc_mixture_reference.py).
11. smc_discrete the same on the mixed model of examples/discrete_models.py
                 (a Bernoulli site moved by MH's flip proposal), 5 MH moves;
                 gates on P(heads) and log Z against the closed form.
                 Each SMC run of phases 6 and 9-11 checks both kernels'
                 launch counts (4 * stages + 3 logsumexp, stages - 1
                 resample), and the kernels line sums them over all five.
12. chees_eight_schools  ftt.chees_chain at bench_chees's shape: 1024 chains,
                 ChEESConfig(target_accept=0.8), float32, 200 warmup + 200
                 samples; gates on split-R-hat, divergence rate (< 3%), the
                 posterior mean of mu, criterion_advice (no switch), one tau
                 read per transition (counted by the drive, and one host
                 sync measured in one transition under CUDA sync debugging).
                 Reports grad-evals/s, ESS/s, mean L, T, epsilon, host syncs
                 per transition and ms per batched gradient.
13. chees_plate  ftt.chees_chain on the 2^20-row plate, 64 chains, target
                 0.8, 200 + 200, from a warm start at the data's moments
                 (mean, log sd) with jitter 0.01 per chain: from the uniform
                 init ChEES, which has no chain rescue, leaves chains stuck
                 where the shared step size diverges (so does the JAX
                 package; scripts/chees_plate_uniform_init.py). The plate's
                 gates, one kernel call per batched model run and one tau
                 read per transition.
14. mh_coin      ftt.adaptive_mcmc_chain on the coin flip (BASELINE config 1),
                 4,096 chains, 300 warmup + 300 samples; gates on mean p
                 within 5 MC-SE of 20/31 and exactly 1 + n_warmup + n_samples
                 batched model runs.
15. mh_hierarchical  ftt.adaptive_mcmc_chain on the 20-site hierarchical
                 model at bench_mh's shape, 262,144 chains, 50 + 50, float32;
                 transitions/s and ms per transition; gates on the run
                 count, finite log joints and per-chain acceptance rates in
                 (0, 1) (not the posterior: 100 transitions from the prior
                 have not mixed).
16. vi_hierarchical  ftt.optimize_meanfield_vi at bench_vi's shape: the
                 20-site model, Adam, 2,000 iterations of 128 MC samples, one
                 chunk, float32; gates on the final ELBO (mean of the last
                 200) and q(mu)'s loc within 5 run-SDs of the JAX package's
                 (VI_HIERARCHICAL), then ftt.predictive of 4,096 guide draws
                 in exactly one batched model run, each of the 85 y means
                 within 5 MC-SE of its theta's. Reports iterations/s, ms and
                 kernels per iteration and host syncs per run (one: the
                 history).
17. vi_plate     mean-field VI on the 2^20-row plate (numpy data), 64 MC
                 samples at lr 0.05, 10 segments of 100 iterations chained
                 through resume= (a single run's Adam steps shrink with the
                 guide scales' gradients and stall far from the posterior):
                 one plate-kernel call per iteration at (64, 2^20), counted
                 against the loss evaluations, one host sync per segment;
                 q(mu)'s loc - ybar, q(sigma)'s median - s and both guide
                 scales, in posterior sds, within 5 run-SDs of the JAX
                 package's in float32 (VI_PLATE).
18. vi_scale     bench_vi_scale at full width (d = 512, N = 16,384, an
                 MVN(0, Sigma_ij = exp(-|i-j|/16)) prior): mean-field 3,000 x 8
                 at lr 0.02, full-rank 6 x 3,000 x 16 through resume= on the
                 lr ladder; the max standardized loc errors and the full-rank
                 sd-ratio range no worse than the JAX package's by 5 run-SDs
                 (VI_SCALE).
19. abc_rejection  ftt.abc_rejection at bench_abc's shape: 64 observations,
                 eps 0.02, 4,096 samples, batch 2^17 x 16 inner batches;
                 the mean within 5 SE of the conjugate posterior mean and the
                 sd ratio within 1 +- 0.06. Reports sims/s and host syncs.
20. abc_smc      ftt.abc_smc_weighted and ftt.abc_smc at bench_abc's SMC
                 shape (2,048 particles, eps 0.5/0.2/0.1/0.05, batch 16,384):
                 the weighted and the equal-weight mean within 5 MC-SE (from
                 the weights' ESS) of the conjugate mean; 4 logsumexp
                 launches per run and abc_smc's one systematic_resample;
                 both kernels against their plain versions on the run's own
                 2,048 log-weights (smc_kernels' tolerances).

21. logistic_scale  bench_scale_logistic at full width, float32: D = 1024,
                 N = 100,000 bf16 rows made on the card, 256 chains. The
                 split-bf16 products return float32 within 1e-3 relative of
                 float64 products of the same bf16 data (the fastgrad
                 gradient, one bf16 rounding of the cotangent, within
                 2^-8); a batched gradient is at most 3 GEMM calls at C = 1
                 and C = 256 (counted and traced); ftt.map_estimate by
                 L-BFGS (120 iterations) within 0.05 posterior sds of a
                 float64 Newton point; ftt.hmc_chain from the MAP (L = 16,
                 300 + 128): max split-R-hat over w[::16] < 1.01,
                 divergences < 1%, mean |w_bar - w_true| / sd in [0.70,
                 0.90], at most 3 GEMMs per model run. Reports grad-evals/s,
                 ESS per gradient, ms, kernels and device us per gradient,
                 the GEMMs' device us against their bound, the idle share of
                 one transition, MAP iterations/s and host syncs.
22. laplace_regression  examples/map_laplace.py: the ridge MAP by Adam and
                 L-BFGS within 1e-4 of the closed form, Laplace sds within
                 1e-4 of exact; the quadratic model's Laplace evidence beats
                 the linear one's, whose evidence is exact to 1e-3.
23. marginal_gmm the enumerated mixture of tests/test_marginalize.py on 12
                 points (4,096 states) through ftt.marginalize and
                 ftt.hmc_chain, 1024 chains, L = 16, 80 + 80 (cut from
                 200 + 200): each labelling's chains' means within 5 MC-SE
                 of a 2-D quadrature of that half-plane; infer_discrete's
                 co-assignments > 0.95 within and < 0.05 across clusters.
24. gibbs_mixed  ftt.gibbs_chain on the mixed model, 1024 chains, 200 + 300:
                 P(heads | y) and E[mu | y] within 5 MC-SE of the closed form.
25. ess_gp       ftt.ess_chain on the GP regression and classification of
                 examples/gaussian_process.py, 1024 chains, 200 + 400 (cut
                 from 300 + 1000): the regression's mean and covariance
                 within 5 SE of the closed form, the classification's
                 latent signs; likelihood evaluations and host reads per
                 transition.
26. pt_bimodal   ftt.pt_chain on examples/parallel_tempering.py's target,
                 8 rungs x 1024 chains, L = 12, 200 + 400: P(x > 0) and E[x]
                 within 5 MC-SE of 0.7 and 1.6; per-pair swap rates.
27. loo_eight_schools  ftt.pointwise_log_likelihood of the eight_schools
                 phase's draws (its own 256-chain run when that phase did
                 not run) within 1e-5 of log N(y_j | theta_j, sigma_j),
                 ftt.waic and ftt.psis_loo the same from the card's matrix
                 and its CPU copy; k-hat.
28. validation_conjugate  ftt.validate_conjugate_normal and
                 ftt.validate_beta_bernoulli through the hmc (100 + 100),
                 mh and smc adapters at 256 chains: each mean and variance
                 within 5 MC-SE, the harness's own 2-SE verdict reported.
29. sbc_normal   ftt.sbc at tests/test_sbc.py's settings: every p-value
                 > 1e-4, and the wrong-prior control rejected.
30. mh_transdimensional  ftt.adaptive_mcmc_chain_dynamic on
                 examples/transdimensional.py, 1000 + 6000, the model on the
                 card: P(b present | y) within 5 MC-SE (the indicator's
                 ESS) of its analytic value; births, deaths, transitions/s.

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
PHASES = ("build", "kernel", "eight_schools", "gaussian_plate", "smc_kernels", "smc",
          "nuts_eight_schools", "nuts_plate", "smc_coin", "smc_mixture", "smc_discrete",
          "chees_eight_schools", "chees_plate", "mh_coin", "mh_hierarchical",
          "vi_hierarchical", "vi_plate", "vi_scale", "abc_rejection", "abc_smc",
          "logistic_scale", "laplace_regression", "marginal_gmm", "gibbs_mixed", "ess_gp",
          "pt_bimodal", "loo_eight_schools", "validation_conjugate", "sbc_normal",
          "mh_transdimensional")
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

# The mixture example (examples/mixture_models.py) under the JAX package's
# adaptive_smc at 131,072 particles with 5 MH moves, on the CPU in float64,
# seeds PRNGKey(0..31) (scripts/smc_mixture_reference.py --runs 32): for the
# posterior means of mu0, mu1 and w and the log-evidence, the mean over runs
# and the run-to-run standard deviation (one run's Monte-Carlo error).
SMC_MIXTURE_RUNS = 32
SMC_MIXTURE = {
    "mu0": {"MEAN": -2.029626420331642, "RUN_SD": 0.0005162852972850393},
    "mu1": {"MEAN": 2.0873063883955867, "RUN_SD": 0.0003461514304083394},
    "w": {"MEAN": 0.403848374278331, "RUN_SD": 0.00021113446700997957},
    "log_evidence": {"MEAN": -145.91377433878702, "RUN_SD": 0.017770533246677385},
}

# The JAX package's VI at the VI phases' configurations, on the CPU in
# float32 (the card's dtype), seeds PRNGKey(0..runs-1), on the same numpy
# data: for each quantity the mean over runs and the run-to-run standard
# deviation (one run's Monte-Carlo error). Made by
#   python scripts/vi_abc_reference.py --phase vi_hierarchical --runs 16 --x32
#   python scripts/vi_abc_reference.py --phase vi_plate --runs 32 --x32
#   python scripts/vi_abc_reference.py --phase vi_scale --runs 4 --x32
VI_REF_RUNS = {"hierarchical": 16, "plate": 32, "scale": 4}
VI_HIERARCHICAL = {  # final ELBO: the mean of the last 200 iterations
    "final_elbo": {"MEAN": -125.13169956207275, "RUN_SD": 0.19431057050125558},
    "mu_loc": {"MEAN": 0.571377731859684, "RUN_SD": 0.0063165766221502115},
}
VI_PLATE_SEGMENTS, VI_PLATE_ITERATIONS = 10, 100  # the plate's VI, chained through resume=
VI_PLATE = {  # vi_plate_stats after the 10 x 100 iterations
    "mu_loc_z": {"MEAN": 0.01169378898233707, "RUN_SD": 0.13296648534538838},
    "sigma_median_z": {"MEAN": -0.1833272354415104, "RUN_SD": 0.10368903609565289},
    "mu_scale_ratio": {"MEAN": 0.9996068441192489, "RUN_SD": 0.012303401313489871},
    "log_sigma_scale_ratio": {"MEAN": 1.0069102694484235, "RUN_SD": 0.06136693671571514},
}
VI_SCALE_LADDER = (0.02, 0.01, 0.005, 0.0025, 0.00125, 0.00125)  # full-rank lr per segment
VI_SCALE_SEGMENT = 1500  # full-rank iterations per segment (bench_vi_scale: 3,000)
VI_SCALE = {  # max |loc - post mean| / post sd, and the full-rank sd ratio's range
    "mf_err": {"MEAN": 0.22059992770428538, "RUN_SD": 0.021316448470296644},
    "fr_err": {"MEAN": 0.05069009093805741, "RUN_SD": 0.0031038735898052997},
    "fr_sd_ratio_min": {"MEAN": 0.9880055753022343, "RUN_SD": 0.003564216158760753},
    "fr_sd_ratio_max": {"MEAN": 1.0729604325317248, "RUN_SD": 0.002313733846307404},
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


def _eight_schools_posterior(res, n_chains, n_samples, what):
    """mu's split-R-hat, ESS(mu), ESS(tau), mean, sd, and its distance from
    the JAX package's long-run mean in MC standard errors; checks shapes
    and finiteness."""
    from fugue_tpu_torch.inference.mcmc_utils import ess_multichain, split_r_hat

    mu = res.samples["mu"].double().cpu()
    tau = res.samples["tau"].double().cpu()
    check(mu.shape == (n_chains, n_samples) and bool(torch.isfinite(mu).all())
          and bool(torch.isfinite(tau).all()),
          f"{what} samples: shape {tuple(mu.shape)} or non-finite")
    # ESS(mu) can reach its cap of chains x samples (antithetic draws), and
    # then cannot show a loss of mixing. ESS(tau), the funnel's slow
    # direction, is reported beside it, and ESS/s reads the smaller of the two.
    ess, ess_tau = ess_multichain(mu).item(), ess_multichain(tau).item()
    mean, sd = mu.mean().item(), mu.std().item()
    mcse = sd / math.sqrt(ess)
    return {"ess_mu": ess, "ess_mu_capped": ess >= n_chains * n_samples, "ess_tau": ess_tau,
            "split_rhat_mu": split_r_hat(mu).item(),
            "divergence_rate": res.divergences.float().mean().item(),
            "mu_mean": mean, "mu_sd": sd, "mu_ref": EIGHT_SCHOOLS_MU_MEAN,
            "mu_z": (mean - EIGHT_SCHOOLS_MU_MEAN) / math.hypot(mcse, EIGHT_SCHOOLS_MU_MCSE),
            "dtype": str(res.samples["mu"].dtype), "step_size": res.step_size}


def phase_eight_schools():
    import fugue_tpu_torch as ftt

    n_chains, n_warmup, n_samples, L = 1024, 200, 200, 32
    staged = ftt.stage(eight_schools_model("cuda"), device="cuda")
    cfg = ftt.HMCConfig(n_leapfrog=L, target_accept=0.9)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ftt.hmc_chain(1, n_samples=n_samples, n_warmup=n_warmup, config=cfg,
                        n_chains=n_chains, staged=staged)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    post = _eight_schools_posterior(res, n_chains, n_samples, "eight_schools mu")
    grad_evals = n_chains * (n_warmup + n_samples) * (L + 1)
    emit({"phase": "eight_schools", "chains": n_chains, "warmup": n_warmup,
          "samples": n_samples, "n_leapfrog": L, "wall_s": wall,
          "grad_evals_per_s": grad_evals / wall,
          "ess_per_s": min(post["ess_mu"], post["ess_tau"]) / wall, **post})
    rhat, div, z = post["split_rhat_mu"], post["divergence_rate"], post["mu_z"]
    check(rhat < 1.02, f"eight_schools split-R-hat(mu) {rhat} >= 1.02")
    check(div < 0.02, f"eight_schools divergence rate {div} >= 0.02")
    check(abs(z) < 5.0, f"eight_schools mu mean {post['mu_mean']} is {z:.2f} MC-SE "
          f"from {EIGHT_SCHOOLS_MU_MEAN}")
    return res


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


def _plate_posterior(res, y, n_chains, n_samples, what):
    """The numbers the plate's gates read (``_check_plate``); shapes and
    finiteness checked."""
    from fugue_tpu_torch.inference.mcmc_utils import ess_multichain, split_r_hat

    n = y.numel()
    y64 = y.double()
    ybar, s = y64.mean().item(), y64.std(correction=0).item()
    mu = res.samples["mu"].double().cpu()
    sig = res.samples["sigma"].double().cpu()
    for name, x in (("mu", mu), ("sigma", sig)):
        check(x.shape == (n_chains, n_samples) and bool(torch.isfinite(x).all()),
              f"{what} {name} samples: shape {tuple(x.shape)} or non-finite")
    post = {"ess_min": min(ess_multichain(mu).item(), ess_multichain(sig).item()),
            "mu_mean": mu.mean().item(), "ybar": ybar,
            "mu_z": (mu.mean().item() - ybar) / (s / math.sqrt(n)),
            "sigma_mean": sig.mean().item(), "sample_sd": s,
            "sigma_z": (sig.mean().item() - s) / (s / math.sqrt(2 * n)),
            "max_split_rhat": max(split_r_hat(mu).item(), split_r_hat(sig).item()),
            "divergence_rate": res.divergences.float().mean().item(),
            "dtype": str(res.samples["mu"].dtype), "step_size": res.step_size}
    return post


def _check_plate(post, launches, model_runs, what):
    """Mean mu within 5 s/sqrt(N) of ybar, mean sigma within 5 s/sqrt(2N)
    of s, max split-R-hat < 1.05, and one value-and-grad call per batched
    model run (never one per chain), the epsilon search and the final
    constrain pass included."""
    check(abs(post["mu_z"]) < 5.0, f"{what} mu mean is {post['mu_z']:.2f} s/sqrt(N) from ybar")
    check(abs(post["sigma_z"]) < 5.0, f"{what} sigma mean is {post['sigma_z']:.2f} s/sqrt(2N) from s")
    check(post["max_split_rhat"] < 1.05, f"{what} max split-R-hat {post['max_split_rhat']} >= 1.05")
    check(launches["nll"] > 0 and launches["nll"] == model_runs,
          f"{what}: {launches['nll']} plate kernel calls for {model_runs} batched model runs")


def _plate_run(run):
    """``run(staged, y)`` on the plate model over y = plate_data at
    MAIN_SHAPE's rows, timed, with the kernel's launch counts and the
    batched model runs set to 0 just before and read just after."""
    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.ops import kernels as K

    y = plate_data(MAIN_SHAPE[1])
    model_runs = [0]
    staged = ftt.stage(plate_model(y, model_runs), device="cuda")
    torch.cuda.synchronize()
    model_runs[0] = 0
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    res = run(staged, y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return y, res, wall, dict(K.LAUNCHES), model_runs[0]


def phase_gaussian_plate():
    import fugue_tpu_torch as ftt

    n_chains, n_warmup, n_samples, L = MAIN_SHAPE[0], 200, 200, 16
    n = MAIN_SHAPE[1]
    cfg = ftt.HMCConfig(n_leapfrog=L, jitter=0.5)
    y, res, wall, launches, model_runs = _plate_run(
        lambda staged, y: ftt.hmc_chain(3, n_samples=n_samples, n_warmup=n_warmup, config=cfg,
                                        n_chains=n_chains, staged=staged))
    post = _plate_posterior(res, y, n_chains, n_samples, "plate")
    n_transitions = n_warmup + n_samples
    grad_evals = n_transitions * (L + 1)
    emit({"phase": "gaussian_plate", "chains": n_chains, "rows": n,
          "warmup": n_warmup, "samples": n_samples, "n_leapfrog": L,
          "wall_s": wall, "grad_evals_per_s": n_chains * grad_evals / wall,
          "rows_per_s": n_chains * grad_evals * n / wall,
          "ess_per_sampling_grad_eval": post["ess_min"] / (n_chains * n_samples * (L + 1)),
          "batched_model_runs": model_runs, "launches": launches, **post})
    _check_plate(post, launches, model_runs, "plate")
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


def plate_numpy_data(n):
    """n rows from N(1.5, 2^2), made with numpy: the VI plate phase's data,
    which scripts/vi_abc_reference.py hands the JAX package too."""
    return np.random.default_rng(2).normal(1.5, 2.0, n)


VI_SCALE_D, VI_SCALE_N = 512, 16384  # bench_vi_scale's width and rows


def vi_scale_data(d=VI_SCALE_D, n=VI_SCALE_N):
    """bench_vi_scale's regression, made with numpy in float64: X (n, d)
    with N(0, 1/d) entries, a prior w ~ N(0, Sigma) with Sigma_ij =
    exp(-|i - j| / 16) given by its Cholesky factor L, y = X w_true + N(0, 1)
    noise, and the exact Gaussian posterior's mean and marginal sds:
    (X, y, L, post_mean, post_sd)."""
    rng = np.random.default_rng(96)
    ii = np.arange(d)
    sigma = np.exp(-np.abs(ii[:, None] - ii[None, :]) / 16.0)
    L = np.linalg.cholesky(sigma)
    X = rng.standard_normal((n, d)) / np.sqrt(d)
    w_true = L @ rng.standard_normal(d)
    y = X @ w_true + rng.standard_normal(n)
    cov = np.linalg.inv(np.linalg.inv(sigma) + X.T @ X)
    return X, y, L, cov @ (X.T @ y), np.sqrt(np.diag(cov))


ABC_N_OBS = 64  # bench_abc's simulator: 64 observations


def abc_data():
    """bench_abc's observed data, made with numpy: 64 draws of N(1, 1)."""
    return 1.0 + np.random.default_rng(77).standard_normal(ABC_N_OBS)


def abc_posterior(obs):
    """(mean, sd) of mu_p's exact posterior under mu_p ~ N(0, 2^2) and
    N(mu_p, 1) observations: the rejection and SMC gates' target (an ABC
    posterior on the mean statistic at small epsilon)."""
    n = obs.size
    return n * float(obs.mean()) / (0.25 + n), math.sqrt(1.0 / (0.25 + n))


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


def coin_model(device):
    """The Beta-Bernoulli coin flip (BASELINE config 1, ``coin_model`` of
    tests/test_smc.py): p ~ Beta(2, 2), 18 heads of 27 observed."""
    import fugue_tpu_torch as ftt

    obs = torch.tensor([True] * 18 + [False] * 9, device=device)

    def coin():
        p = ftt.sample("p", ftt.Beta(2.0, 2.0))
        ftt.observe("obs", ftt.Bernoulli(p), obs)
        return p

    return coin


def coin_exact():
    """(log-evidence, posterior mean of p) of ``coin_model``: the posterior
    is Beta(20, 11), so log Z = log B(20, 11) - log B(2, 2)."""
    def log_b(a, b):
        return math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)

    return log_b(20.0, 11.0) - log_b(2.0, 2.0), 20.0 / 31.0


def mixture_data():
    """The 100 points of examples/mixture_models.py."""
    rng = np.random.default_rng(0)
    return np.concatenate([rng.normal(-2.0, 0.5, 40), rng.normal(2.0, 0.5, 60)])


def mixture_model(device, dtype=torch.float32):
    """The two-component Gaussian mixture of examples/mixture_models.py
    (BASELINE config 4): ordered means, a Beta weight, memberships summed
    out in one factor."""
    import fugue_tpu_torch as ftt

    data = torch.as_tensor(mixture_data(), dtype=dtype, device=device)

    def gmm():
        mu0 = ftt.sample("mu0", ftt.Normal(0.0, 5.0))
        mu1 = ftt.sample("mu1", ftt.Normal(0.0, 5.0))
        ftt.guard(mu0 < mu1)  # ordering breaks label switching
        w = ftt.sample("w", ftt.Beta(2.0, 2.0))
        lp0 = torch.log(w) + ftt.Normal(mu0, 0.5).log_prob(data)
        lp1 = torch.log1p(-w) + ftt.Normal(mu1, 0.5).log_prob(data)
        ftt.factor(torch.sum(torch.logaddexp(lp0, lp1)))
        return mu0, mu1

    return gmm


def mixed_discrete_model(device, dtype=torch.float32):
    """The mixed model of examples/discrete_models.py: heads ~ Bernoulli(0.5),
    mu ~ Normal(+-1, 1), y = (1.1, 0.9) ~ Normal(mu, 0.5)."""
    import fugue_tpu_torch as ftt

    y = torch.tensor([1.1, 0.9], dtype=dtype, device=device)

    def mixed():
        heads = ftt.sample("heads", ftt.Bernoulli(0.5))
        mu = ftt.sample("mu", ftt.Normal(torch.where(heads, 1.0, -1.0).to(dtype), 1.0))
        ftt.observe("y", ftt.Normal(mu, 0.5), y)
        return mu

    return mixed


def mixed_discrete_exact():
    """(log-evidence, P(heads | y)) of ``mixed_discrete_model`` in closed
    form: given heads, y ~ N(+-1 * 1, 0.25 I + 1 1^T)."""
    y = np.array([1.1, 0.9])
    cov = 0.25 * np.eye(2) + np.ones((2, 2))
    prec, (_, logdet) = np.linalg.inv(cov), np.linalg.slogdet(cov)

    def log_lik(m):
        d = y - m
        return -0.5 * (d @ prec @ d + logdet + 2 * math.log(2 * math.pi))

    a, b = float(log_lik(1.0)), float(log_lik(-1.0))
    top = max(a, b)
    log_z = math.log(0.5) + top + math.log(math.exp(a - top) + math.exp(b - top))
    return log_z, 1.0 / (1.0 + math.exp(b - a))


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


def _lse_f32_check(x, what):
    """The logsumexp kernel on float32 ``x`` against the plain version and
    float64: |kernel - f64| <= max(|plain - f64|, eps32 * |f64|), infinite
    results exactly; the same result twice. The numbers, for a row."""
    from fugue_tpu_torch.ops import kernels as K

    k, p, r = K.plogsumexp(x), K.logsumexp_ref(x), K.logsumexp_ref(x.double())
    check(k.dtype == torch.float32 and k.dim() == 0, f"{what}: output {k.dtype} {k.shape}")
    check(torch.equal(K.plogsumexp(x), k), f"{what}: not deterministic")
    row = {"kernel_value": k.item(), "plain_value": p.item(), "f64_value": r.item()}
    if not math.isfinite(r.item()):
        check(k.item() == r.item() == p.item(), f"{what}: {k} {p} {r}")
        return dict(row, kernel_vs_plain=0.0)
    ke, pe = abs(k.double().item() - r.item()), abs(p.double().item() - r.item())
    tol = max(pe, torch.finfo(torch.float32).eps * abs(r.item()))
    check(ke <= tol, f"{what}: |kernel - f64| {ke} > {tol}")
    return dict(row, kernel_vs_f64=ke, plain_vs_f64=pe, tolerance=tol,
                kernel_vs_plain=abs(k.item() - p.item()))


def _resample_f32_contract(lw32, logits64, u0v, what):
    """The resample kernel on float32 log-weights against the exact float64
    reference on ``logits64`` with the same u0, under the JAX package's
    contract (tests/test_pallas_kernels.py): max ancestor deviation <=
    max(4, 2 x the plain float32 version's), fewer than 2% of slots differ;
    indices sorted, in range, the same twice. The numbers, for a row."""
    from fugue_tpu_torch.ops import kernels as K

    n = lw32.numel()
    u0 = torch.tensor(u0v, dtype=torch.float32, device="cuda")
    got = K.systematic_resample_from_u0(lw32, u0)
    _check_indices(got, n, what)
    check(torch.equal(got, K.systematic_resample_from_u0(lw32, u0)), f"{what}: not deterministic")
    ref = torch.as_tensor(_exact_systematic(logits64, float(u0.item())), device="cuda")
    plain = K.systematic_resample_ref(u0, torch.exp(lw32 - K.logsumexp_ref(lw32)))
    floor = (plain - ref).abs().max().item()
    dev = (got - ref).abs()
    row = {"u0": u0v, "max_dev_vs_f64": dev.max().item(), "plain_max_dev_vs_f64": floor,
           "frac_differ": (dev > 0).float().mean().item(),
           "kernel_vs_plain": (got - plain).abs().max().item(),
           "tolerance": "max dev <= max(4, 2 * plain's), < 2% differ"}
    check(row["max_dev_vs_f64"] <= max(4, 2 * floor) and row["frac_differ"] < 0.02,
          f"{what}: contract {row}")
    return row


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

    rows = {}
    for n in (N_PARTICLES, 1 << 24, 3 * 8192 + 17, 2048):
        for kind, x in _lse_inputs(n, seed=n % 1000).items():
            row = {"phase": "smc_kernels", "kernel": "logsumexp", "n": n, "input": kind,
                   **_lse_f32_check(x, f"lse at {n} {kind}")}
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
        emit({"phase": "smc_kernels", "kernel": "systematic_resample", "n": n, "dtype": "float32",
              **_resample_f32_contract(lw32, logits, u0v, f"resample f32 u0={u0v}")})
    # the same contract from an unaligned view, lw32[1:], and at abc_smc's 2,048
    _resample_f32_contract(lw32[1:], logits[1:], 0.37, "resample f32 from lw[1:]")
    _resample_f32_contract(lw32[:2048], logits[:2048], 0.37, "resample f32 at 2,048")
    u0 = torch.tensor(0.37, device="cuda")
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


def _smc_run(name, staged, n, seed, config, site="mu", phase="smc"):
    """One ftt.adaptive_smc run, timed, with the kernels' launch counts set
    to 0 just before and read just after; checks convergence, the weights
    and both kernels' launch counts, and reports ``site``'s posterior."""
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
    x = res.particles[site]
    check(x.shape == (n,) and bool(torch.isfinite(x).all()),
          f"{name}: {site} {tuple(x.shape)} or non-finite")
    check(abs(res.weights.double().sum().item() - 1.0) < 1e-4, f"{name}: weights do not sum to 1")
    mean = res.posterior_mean(site).item()
    sd = math.sqrt(res.posterior_var(site).item())
    row = {"phase": phase, "run": name, "particles": n, "dtype": str(x.dtype),
           "rejuvenation": config.rejuvenation, "rejuvenation_steps": config.rejuvenation_steps,
           "wall_s": wall, "particle_stages_per_s": n * res.n_stages / wall,
           "stages": res.n_stages, "beta": res.beta, "log_evidence": res.log_evidence,
           "ess": res.ess, f"{site}_mean": mean, f"{site}_sd": sd, "launches": launches}
    check(res.converged and res.beta == 1.0, f"{name}: not converged, beta {res.beta}")
    # No terminal resample: every stage but the last (beta = 1) resampled.
    # logsumexp per stage: 2 in _next_beta's ESS, 1 to normalise, 1 for the
    # evidence increment (the resample takes its own lse, not plogsumexp);
    # at the end 1 to normalise and 2 for the ESS: 4 * stages + 3.
    s = res.n_stages
    check(launches["resample"] == s - 1, f"{name}: {launches['resample']} resample launches, {s} stages")
    check(launches["lse"] == 4 * s + 3, f"{name}: {launches['lse']} logsumexp launches, want {4 * s + 3}")
    return row, res


def _add_launches(total, launches):
    for k in total:
        total[k] += launches[k]


def phase_smc():
    import fugue_tpu_torch as ftt

    launches = {"lse": 0, "resample": 0}
    staged = ftt.stage(hierarchical_model("cuda"), device="cuda")
    runs = (("hierarchical_mh", "mh", 3, ftt.SMCConfig(rejuvenation_steps=3)),
            ("hierarchical_hmc", "hmc", 13,
             ftt.SMCConfig(rejuvenation="hmc", rejuvenation_steps=1, hmc_leapfrog=16)))
    for name, mode, seed, cfg in runs:
        row, _ = _smc_run(name, staged, N_PARTICLES, seed, cfg)
        ref = SMC_MU[mode]
        mcse = math.hypot(ref["MU_RUN_SD"], ref["MU_RUN_SD"] / math.sqrt(SMC_MU_RUNS))
        row.update(mu_ref=ref["MU_MEAN"], mu_mcse=mcse, mu_z=(row["mu_mean"] - ref["MU_MEAN"]) / mcse)
        emit(row)
        check(abs(row["mu_z"]) < 5.0, f"{name}: mu mean {row['mu_mean']} is {row['mu_z']:.2f} MC-SE "
              f"from {ref['MU_MEAN']}")
        _add_launches(launches, row["launches"])
    staged_c = ftt.stage(conjugate_evidence_model("cuda"), device="cuda")
    row, _ = _smc_run("conjugate", staged_c, 8192, 33, ftt.SMCConfig(rejuvenation_steps=3))
    exact = conjugate_log_evidence()
    row.update(log_evidence_exact=exact, log_evidence_err=row["log_evidence"] - exact)
    emit(row)
    check(abs(row["log_evidence_err"]) < 0.1, f"conjugate log Z {row['log_evidence']} vs {exact}")
    _add_launches(launches, row["launches"])
    return launches


def phase_smc_coin():
    """The coin flip with MH moves, and with HMC moves, which take gradients
    through Beta and the Sigmoid Jacobian: log Z within 0.1 of the exact
    value, mean p within 0.005 of 20/31."""
    import fugue_tpu_torch as ftt

    launches = {"lse": 0, "resample": 0}
    staged = ftt.stage(coin_model("cuda"), device="cuda")
    log_z, p_mean = coin_exact()
    runs = (("coin_mh", 21, ftt.SMCConfig(rejuvenation_steps=3)),
            ("coin_hmc", 22, ftt.SMCConfig(rejuvenation="hmc", rejuvenation_steps=1,
                                           hmc_leapfrog=16)))
    for name, seed, cfg in runs:
        row, _ = _smc_run(name, staged, N_PARTICLES, seed, cfg, site="p", phase="smc_coin")
        row.update(log_evidence_exact=log_z, log_evidence_err=row["log_evidence"] - log_z,
                   p_exact=p_mean, p_err=row["p_mean"] - p_mean)
        emit(row)
        check(abs(row["log_evidence_err"]) < 0.1, f"{name}: log Z {row['log_evidence']} vs {log_z}")
        check(abs(row["p_err"]) < 0.005, f"{name}: mean p {row['p_mean']} vs {p_mean}")
        _add_launches(launches, row["launches"])
    return launches


def phase_smc_mixture():
    """The mixture example with 5 MH moves: the posterior means of mu0, mu1
    and w and log Z each within 5 MC-SE of the JAX package's constants."""
    import fugue_tpu_torch as ftt

    staged = ftt.stage(mixture_model("cuda"), device="cuda")
    row, res = _smc_run("mixture_mh", staged, N_PARTICLES, 31, ftt.SMCConfig(rejuvenation_steps=5),
                        site="mu0", phase="smc_mixture")
    got = {"mu0": row["mu0_mean"], "mu1": res.posterior_mean("mu1").item(),
           "w": res.posterior_mean("w").item(), "log_evidence": row["log_evidence"]}
    z = {}
    for k, v in got.items():
        ref = SMC_MIXTURE[k]
        mcse = math.hypot(ref["RUN_SD"], ref["RUN_SD"] / math.sqrt(SMC_MIXTURE_RUNS))
        z[k] = (v - ref["MEAN"]) / mcse
    row.update(means=got, refs={k: v["MEAN"] for k, v in SMC_MIXTURE.items()}, z=z)
    emit(row)
    for k, v in z.items():
        check(abs(v) < 5.0, f"mixture {k} {got[k]} is {v:.2f} MC-SE from {SMC_MIXTURE[k]['MEAN']}")
    return row["launches"]


def phase_smc_discrete():
    """The mixed discrete model with 5 MH moves, whose flip proposal moves
    heads: P(heads) within 0.01 and log Z within 0.1 of the closed form."""
    import fugue_tpu_torch as ftt

    staged = ftt.stage(mixed_discrete_model("cuda"), device="cuda")
    row, res = _smc_run("discrete_mh", staged, N_PARTICLES, 41, ftt.SMCConfig(rejuvenation_steps=5),
                        phase="smc_discrete")
    log_z, p_heads = mixed_discrete_exact()
    heads = res.particles["heads"]
    check(heads.dtype == torch.bool and heads.shape == (N_PARTICLES,), f"heads {heads.dtype}")
    got = res.posterior_mean("heads").item()
    row.update(p_heads=got, p_heads_exact=p_heads, p_heads_err=got - p_heads,
               log_evidence_exact=log_z, log_evidence_err=row["log_evidence"] - log_z)
    emit(row)
    check(row["stages"] >= 2, "smc_discrete: one stage, so no MH move ran")
    check(abs(row["p_heads_err"]) < 0.01, f"P(heads) {got} vs {p_heads}")
    check(abs(row["log_evidence_err"]) < 0.1, f"discrete log Z {row['log_evidence']} vs {log_z}")
    return row["launches"]


def _nuts_tree_stats(res, n_chains, n_transitions, wall):
    """The tree build's costs: lock-step leaves per transition (the batch
    maximum, what every chain waits for) beside the mean over chains of its
    own leaves, their ratio, host syncs per transition and wall ms per
    lock-step leaf."""
    mean_leaves = res.n_leapfrogs / (n_chains * n_transitions)
    max_leaves = res.lockstep_leaves / n_transitions
    return {"mean_tree_depth": res.tree_depths.double().mean().item(),
            "n_leapfrogs": res.n_leapfrogs, "lockstep_leaves": res.lockstep_leaves,
            "leaves_per_transition_max": max_leaves, "leaves_per_transition_mean": mean_leaves,
            "lockstep_over_mean": max_leaves / mean_leaves,
            "host_syncs_per_transition": res.host_syncs / n_transitions,
            "ms_per_lockstep_leaf": 1e3 * wall / res.lockstep_leaves}


def phase_nuts_eight_schools():
    import fugue_tpu_torch as ftt

    n_chains, n_warmup, n_samples = 1024, 200, 200
    staged = ftt.stage(eight_schools_model("cuda"), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ftt.nuts_chain(5, n_samples=n_samples, n_warmup=n_warmup, config=ftt.NUTSConfig(),
                         n_chains=n_chains, staged=staged)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    post = _eight_schools_posterior(res, n_chains, n_samples, "nuts eight_schools")
    n_transitions = n_warmup + n_samples
    # grad-evals as bench.py's bench_nuts counts them: every chain's own
    # leapfrogs plus one root evaluation per transition
    grad_evals = res.n_leapfrogs + n_chains * n_transitions
    emit({"phase": "nuts_eight_schools", "chains": n_chains, "warmup": n_warmup,
          "samples": n_samples, "max_depth": 8, "wall_s": wall,
          "grad_evals_per_s": grad_evals / wall,
          "ess_per_s": min(post["ess_mu"], post["ess_tau"]) / wall, **post,
          **_nuts_tree_stats(res, n_chains, n_transitions, wall)})
    rhat, div, z = post["split_rhat_mu"], post["divergence_rate"], post["mu_z"]
    check(rhat < 1.02, f"nuts eight_schools split-R-hat(mu) {rhat} >= 1.02")
    check(div < 0.05, f"nuts eight_schools divergence rate {div} >= 0.05")
    check(abs(z) < 5.0, f"nuts eight_schools mu mean {post['mu_mean']} is {z:.2f} MC-SE "
          f"from {EIGHT_SCHOOLS_MU_MEAN}")


def phase_nuts_plate():
    import fugue_tpu_torch as ftt

    n_chains, n_warmup, n_samples = MAIN_SHAPE[0], 200, 200
    n = MAIN_SHAPE[1]
    y, res, wall, launches, model_runs = _plate_run(
        lambda staged, y: ftt.nuts_chain(3, n_samples=n_samples, n_warmup=n_warmup,
                                         config=ftt.NUTSConfig(), n_chains=n_chains,
                                         staged=staged))
    post = _plate_posterior(res, y, n_chains, n_samples, "nuts plate")
    n_transitions = n_warmup + n_samples
    grad_evals = res.n_leapfrogs + n_chains * n_transitions  # each chain's own
    emit({"phase": "nuts_plate", "chains": n_chains, "rows": n, "warmup": n_warmup,
          "samples": n_samples, "max_depth": 8, "wall_s": wall,
          "grad_evals_per_s": grad_evals / wall, "rows_per_s": grad_evals * n / wall,
          # the lock-step build evaluates every chain at every leaf
          "rows_evaluated_per_s": n_chains * (res.lockstep_leaves + n_transitions) * n / wall,
          "ess_per_s": post["ess_min"] / wall, "batched_model_runs": model_runs,
          "launches": launches, **post, **_nuts_tree_stats(res, n_chains, n_transitions, wall)})
    _check_plate(post, launches, model_runs, "nuts plate")
    # a batched model run for the root and every lock-step leaf, besides the
    # epsilon search and the final constrain pass
    check(launches["nll"] >= res.lockstep_leaves + n_transitions,
          f"{launches['nll']} plate kernel calls for {res.lockstep_leaves} leaves")
    return launches


def _host_syncs(fn) -> int:
    """The synchronizing CUDA operations (device-to-host reads) one ``fn()``
    call makes, counted by PyTorch's sync debugging in its warning mode."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (the mode's own notice that it is a prototype is a warning too)
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def _chees_stats(res, n_chains, n_transitions, wall):
    """ChEES's costs: grad-evals as bench_chees counts them (every chain's
    leapfrogs plus one evaluation at each trajectory's start), the batched
    gradient runs, and the tau reads per transition."""
    batched = res.n_leapfrogs // n_chains + n_transitions
    return {"grad_evals_per_s": (res.n_leapfrogs + n_chains * n_transitions) / wall,
            "mean_leapfrog": res.mean_leapfrog, "n_leapfrogs": res.n_leapfrogs,
            "trajectory_length": res.trajectory_length, "step_size": res.step_size,
            "trajectory_cap_reached": res.trajectory_cap_reached,
            "batched_gradients": batched, "ms_per_batched_gradient": 1e3 * wall / batched,
            "host_syncs_per_transition": res.host_syncs / n_transitions}


def phase_chees_eight_schools():
    """ChEES-HMC at bench_chees's shape, cut to 200 + 200 transitions."""
    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.inference import chees

    n_chains, n_warmup, n_samples = 1024, 200, 200
    staged = ftt.stage(eight_schools_model("cuda"), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ftt.chees_chain(7, n_samples=n_samples, n_warmup=n_warmup,
                          config=ftt.ChEESConfig(target_accept=0.8), n_chains=n_chains,
                          staged=staged)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    post = _eight_schools_posterior(res, n_chains, n_samples, "chees eight_schools")
    n_transitions = n_warmup + n_samples
    advice = res.criterion_advice()
    # one more transition at the learned kernel, its step size and T on the
    # card as in the drive: the host reads it makes
    g = torch.Generator(device="cuda").manual_seed(1)
    eps, T = (torch.tensor(x, device="cuda") for x in (res.step_size, res.trajectory_length))

    def one():
        z = torch.randn(res.final_positions.shape, generator=g, device="cuda")
        log_u = torch.log1p(-torch.rand(n_chains, generator=g, device="cuda"))
        return chees.chees_transition(staged.potential, res.final_positions, z, log_u, eps, T,
                                      0.75, res.inv_mass, 1024)

    one()
    syncs = _host_syncs(one)
    emit({"phase": "chees_eight_schools", "card": card_line(), "chains": n_chains,
          "warmup": n_warmup, "samples": n_samples, "target_accept": 0.8, "wall_s": wall,
          "ess_per_s": min(post["ess_mu"], post["ess_tau"]) / wall, **post,
          **_chees_stats(res, n_chains, n_transitions, wall),
          "host_syncs_of_one_transition": syncs, "criterion_advice": advice})
    rhat, div, z = post["split_rhat_mu"], post["divergence_rate"], post["mu_z"]
    check(rhat < 1.02, f"chees eight_schools split-R-hat(mu) {rhat} >= 1.02")
    check(div < 0.03, f"chees eight_schools divergence rate {div} >= 0.03")
    check(abs(z) < 5.0, f"chees eight_schools mu mean {post['mu_mean']} is {z:.2f} MC-SE "
          f"from {EIGHT_SCHOOLS_MU_MEAN}")
    check(advice["recommendation"] is None, f"chees eight_schools advice: {advice}")
    check(res.host_syncs == n_transitions,
          f"chees eight_schools: {res.host_syncs} tau reads in {n_transitions} transitions")
    check(syncs == 1, f"one chees transition made {syncs} host syncs, not 1")


def phase_chees_plate():
    """ChEES-HMC on the 2^20-row plate from a warm start at the data's
    moments; the plate kernel once per batched model run."""
    import fugue_tpu_torch as ftt

    n_chains, n_warmup, n_samples = MAIN_SHAPE[0], 200, 200
    n = MAIN_SHAPE[1]

    def run(staged, y):
        y64 = y.double()
        z0 = torch.stack([y64.mean(), torch.log(y64.std(correction=0))]).float()
        return ftt.chees_chain(3, n_samples=n_samples, n_warmup=n_warmup,
                               config=ftt.ChEESConfig(target_accept=0.8), n_chains=n_chains,
                               staged=staged, init_position=z0, init_jitter=0.01)

    y, res, wall, launches, model_runs = _plate_run(run)
    post = _plate_posterior(res, y, n_chains, n_samples, "chees plate")
    n_transitions = n_warmup + n_samples
    stats = _chees_stats(res, n_chains, n_transitions, wall)
    emit({"phase": "chees_plate", "card": card_line(), "chains": n_chains, "rows": n,
          "warmup": n_warmup, "samples": n_samples, "target_accept": 0.8,
          "init": "data moments + 0.01 jitter",
          "wall_s": wall, "rows_per_s": stats["grad_evals_per_s"] * n,
          "ess_per_s": post["ess_min"] / wall, "batched_model_runs": model_runs,
          "launches": launches, **post, **stats})
    _check_plate(post, launches, model_runs, "chees plate")
    # L + 1 batched runs per transition, besides the epsilon search and the
    # final constrain pass
    check(model_runs > stats["batched_gradients"],
          f"chees plate: {model_runs} model runs for {stats['batched_gradients']} gradients")
    check(res.host_syncs == n_transitions,
          f"chees plate: {res.host_syncs} tau reads in {n_transitions} transitions")
    return launches


def _counted(model):
    """``model`` with a counter of its runs: (counted model, [runs])."""
    runs = [0]

    def counted():
        runs[0] += 1
        return model()

    return counted, runs


def _mh_run(phase, model, n_chains, n_warmup, n_samples, seed):
    """One ftt.adaptive_mcmc_chain run, timed, with its batched model runs
    counted from just before to just after; checks the run-count contract
    and the log joints."""
    import fugue_tpu_torch as ftt

    counted, runs = _counted(model)
    staged = ftt.stage(counted, device="cuda")
    torch.cuda.synchronize()
    runs[0] = 0
    t0 = time.perf_counter()
    res = ftt.adaptive_mcmc_chain(seed, staged=staged, n_samples=n_samples, n_warmup=n_warmup,
                                  n_chains=n_chains)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_transitions = n_warmup + n_samples
    rate = res.accept_rate.double().cpu()
    row = {"phase": phase, "card": card_line(), "chains": n_chains, "warmup": n_warmup,
           "samples": n_samples, "dtype": str(res.log_joint.dtype), "wall_s": wall,
           "transitions_per_s": n_chains * n_transitions / wall,
           "ms_per_transition": 1e3 * wall / n_transitions, "batched_model_runs": runs[0],
           "accept_rate_mean": rate.mean().item(), "accept_rate_min": rate.min().item(),
           "accept_rate_max": rate.max().item()}
    check(runs[0] == 1 + n_transitions,
          f"{phase}: {runs[0]} batched model runs, want 1 + {n_warmup} + {n_samples}")
    check(res.log_joint.shape == (n_chains, n_samples)
          and bool(torch.isfinite(res.log_joint).all()), f"{phase}: log joints not finite")
    return row, res


def phase_mh_coin():
    """Adaptive MH on the coin flip: mean p within 5 MC-SE of 20/31."""
    from fugue_tpu_torch.inference.mcmc_utils import ess_multichain

    row, res = _mh_run("mh_coin", coin_model("cuda"), 4096, 300, 300, 11)
    p = res.samples["p"].double().cpu()
    p_exact = coin_exact()[1]
    ess = ess_multichain(p).item()
    mcse = p.std().item() / math.sqrt(ess)
    row.update(p_mean=p.mean().item(), p_exact=p_exact, ess_p=ess, p_mcse=mcse,
               p_z=(p.mean().item() - p_exact) / mcse)
    emit(row)
    check(abs(row["p_z"]) < 5.0, f"mh_coin: mean p {row['p_mean']} is {row['p_z']:.2f} MC-SE "
          f"from {p_exact}")


def phase_mh_hierarchical():
    """Adaptive MH at bench_mh's shape: 262,144 chains of the 20-site
    hierarchical model, 50 warmup + 50 samples, float32, not cut. At this
    length from the prior the chains have not mixed, so the phase gates the
    driver's contracts (1 + 50 + 50 batched model runs, finite log joints,
    every chain's acceptance rate strictly between 0 and 1), not the
    posterior."""
    row, res = _mh_run("mh_hierarchical", hierarchical_model("cuda"), 262144, 50, 50, 13)
    row["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    emit(row)
    check(row["accept_rate_min"] > 0.0 and row["accept_rate_max"] < 1.0,
          f"mh_hierarchical: acceptance rates span [{row['accept_rate_min']}, "
          f"{row['accept_rate_max']}]")


def traced_kernels(fn, cpu=False):
    """One ``fn()`` call under torch.profiler, from a synchronised start to
    a synchronised end: (the profiler, the CUDA kernel events). ``cpu``
    traces the host side too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return prof, [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def run_sd_z(x, ref, runs):
    """x's offset from the JAX package's mean over ``runs`` runs, in run-SDs
    (the SD of one run, widened by the constant's own standard error)."""
    return (x - ref["MEAN"]) / math.hypot(ref["RUN_SD"], ref["RUN_SD"] / math.sqrt(runs))


def _within(x, ref, runs, what, side=0):
    """x within 5 run-SDs of the JAX package's mean (``run_sd_z``); ``side``
    +1 bounds x from above only, -1 from below only. The offset."""
    z = run_sd_z(x, ref, runs)
    check(abs(z) < 5.0 if side == 0 else side * z < 5.0,
          f"{what} {x} is {z:.2f} run-SDs from the JAX package's {ref['MEAN']}"
          + ("" if side == 0 else f" (bounded {'above' if side > 0 else 'below'} only)"))
    return z


def _timed_syncs(fn):
    """(fn's result, wall seconds, host syncs): one ``fn()`` call timed from
    a synchronised start to a synchronised end, its device-to-host syncs
    counted (``_host_syncs``)."""
    out = {}

    def run():
        t0 = time.perf_counter()
        out["res"] = fn()
        torch.cuda.synchronize()
        out["wall"] = time.perf_counter() - t0

    syncs = _host_syncs(run)
    return out["res"], out["wall"], syncs


def phase_vi_hierarchical():
    """bench_vi: mean-field VI on the 20-site model, then the predictive of
    4,096 guide draws in one batched model run."""
    import fugue_tpu_torch as ftt

    n_iter, n_mc, n_pred = 2000, 128, 4096
    model = hierarchical_model("cuda")
    staged = ftt.stage(model, device="cuda")
    cfg = ftt.VIConfig(n_iterations=n_iter, n_samples=n_mc, plateau_window=10**9,
                       check_every=n_iter)
    short = ftt.VIConfig(n_iterations=20, n_samples=n_mc, plateau_window=10**9, check_every=20)
    ftt.optimize_meanfield_vi(0, staged=staged, config=short)  # first use of torch.func
    _, ks = traced_kernels(lambda: ftt.optimize_meanfield_vi(1, staged=staged, config=short))
    kernels, device_us = len(ks), sum(e.time_range.elapsed_us() for e in ks)
    res, wall, syncs = _timed_syncs(
        lambda: ftt.optimize_meanfield_vi(4, staged=staged, config=cfg))
    hist = res.elbo_history
    check(hist.shape == (n_iter,) and bool(np.isfinite(hist).all()), "vi_hierarchical: ELBO history")
    final_elbo = float(np.mean(hist[-200:]))
    mu_loc = res.params["mu"]["loc"].item()
    row = {"phase": "vi_hierarchical", "card": card_line(), "iterations": n_iter,
           "mc_samples": n_mc, "dtype": str(res.params["mu"]["loc"].dtype), "wall_s": wall,
           "vi_elbo_grad_iterations_per_sec_20site_128mc": n_iter / wall,
           "ms_per_iteration": 1e3 * wall / n_iter, "kernels_per_iteration": kernels / 20,
           "device_us_per_iteration": device_us / 20, "host_syncs_per_run": syncs,
           "final_elbo": final_elbo, "mu_loc": mu_loc,
           "final_elbo_z": _within(final_elbo, VI_HIERARCHICAL["final_elbo"], VI_REF_RUNS["hierarchical"],
                                   "vi_hierarchical final ELBO"),
           "mu_loc_z": _within(mu_loc, VI_HIERARCHICAL["mu_loc"], VI_REF_RUNS["hierarchical"],
                               "vi_hierarchical q(mu) loc")}
    counted, runs = _counted(model)
    draws = res.posterior_sample(5, n_pred)
    runs[0] = 0
    pred = ftt.predictive(6, counted, draws, batch_ndim=1, device="cuda")
    row["predictive_model_runs"] = runs[0]
    check(runs[0] == 1, f"vi_hierarchical: {runs[0]} predictive model runs, want 1")
    zs = []
    for i in range(17):
        y = pred[f"y#{i}"].double()
        check(y.shape == (n_pred, 5) and bool(torch.isfinite(y).all()), f"predictive y#{i}")
        diff = y - draws[f"theta#{i}"].double()[:, None]
        zs.append((diff.mean(0) / (diff.std(0) / math.sqrt(n_pred))).abs().max().item())
    row["predictive_max_abs_z"] = max(zs)
    emit(row)
    check(syncs == 1, f"vi_hierarchical: {syncs} host syncs per run, want 1 (the history)")
    check(max(zs) < 5.0, f"vi_hierarchical: a predictive y mean is {max(zs):.2f} MC-SE from its theta")


def vi_plate_stats(params, y_np):
    """q on the plate against the exact posterior, in its sds (s/sqrt(N)
    for mu, s/sqrt(2N) for sigma, 1/sqrt(2N) for log sigma): q(mu)'s loc -
    ybar, q(sigma)'s median - s, and the two guide scales over those sds.
    ``params`` of either package."""
    n = y_np.size
    ybar, s = float(y_np.mean()), float(y_np.std())
    sd_mu, sd_ls = s / math.sqrt(n), 1.0 / math.sqrt(2 * n)

    def scale(p):
        return math.log1p(math.exp(float(p["raw_scale"])))  # softplus

    return {"mu_loc_z": (float(params["mu"]["loc"]) - ybar) / sd_mu,
            "sigma_median_z": (math.exp(float(params["sigma"]["loc"])) - s) / (s * sd_ls),
            "mu_scale_ratio": scale(params["mu"]) / sd_mu,
            "log_sigma_scale_ratio": scale(params["sigma"]) / sd_ls}


def vi_plate_run(staged, seed):
    """The vi_plate configuration: 64 MC samples at lr 0.05, VI_PLATE_SEGMENTS
    segments of VI_PLATE_ITERATIONS iterations chained through resume=,
    which restarts Adam's moments and schedule; segment i takes seed + i."""
    import fugue_tpu_torch as ftt

    cfg = ftt.VIConfig(n_iterations=VI_PLATE_ITERATIONS, n_samples=64, learning_rate=0.05,
                       plateau_window=10**9, check_every=VI_PLATE_ITERATIONS)
    res = None
    for i in range(VI_PLATE_SEGMENTS):
        res = ftt.optimize_meanfield_vi(seed + i, staged=staged, config=cfg, resume=res)
    return res


def phase_vi_plate():
    """Mean-field VI on the 2^20-row plate: 64 MC samples per iteration, so
    each iteration is one plate-kernel call at (64, 2^20)."""
    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.ops import kernels as K

    n_iter = VI_PLATE_SEGMENTS * VI_PLATE_ITERATIONS
    y_np = plate_numpy_data(MAIN_SHAPE[1])
    y = torch.as_tensor(y_np, dtype=torch.float32, device="cuda")
    model_runs = [0]
    staged = ftt.stage(plate_model(y, model_runs), device="cuda")
    torch.cuda.synchronize()
    model_runs[0] = 0
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    res, wall, syncs = _timed_syncs(lambda: vi_plate_run(staged, 700))
    launches = dict(K.LAUNCHES)
    runs = model_runs[0]
    stats = vi_plate_stats(res.params, y_np)
    row = {"phase": "vi_plate", "card": card_line(), "rows": MAIN_SHAPE[1], "mc_samples": 64,
           "iterations": n_iter, "segments": VI_PLATE_SEGMENTS, "wall_s": wall,
           "iterations_per_s": n_iter / wall, "ms_per_iteration": 1e3 * wall / n_iter,
           "host_syncs_per_run": syncs, "batched_model_runs": runs, "launches": launches, **stats}
    emit(row)
    for k, v in stats.items():
        _within(v, VI_PLATE[k], VI_REF_RUNS["plate"], f"vi_plate {k}")
    check(runs == n_iter and launches["nll"] == runs,
          f"vi_plate: {launches['nll']} plate kernel calls, {runs} model runs, {n_iter} iterations")
    check(syncs == VI_PLATE_SEGMENTS, f"vi_plate: {syncs} host syncs, want one per segment")
    return launches


def phase_vi_scale():
    """bench_vi_scale at full width: d = 512, N = 16,384, mean-field 3,000 x
    8 and full-rank 6 x 3,000 x 16 on the lr ladder, against the exact
    posterior."""
    import fugue_tpu_torch as ftt

    X, y, L, pmean, psd = vi_scale_data()
    Xt, yt, Lt = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (X, y, L))
    zero = torch.zeros(VI_SCALE_D, device="cuda")

    def model():
        w = ftt.sample("w", ftt.MultivariateNormal(zero, scale_tril=Lt))
        ftt.observe("y", ftt.Normal(Xt @ w, 1.0), yt)

    staged = ftt.stage(model, device="cuda")
    cfg = ftt.VIConfig(n_iterations=3000, n_samples=8, plateau_window=10**9, check_every=3000,
                       learning_rate=0.02)
    rm, mf_wall, mf_syncs = _timed_syncs(lambda: ftt.optimize_meanfield_vi(40, staged=staged,
                                                                            config=cfg))
    mf_err = float(np.max(np.abs(rm.params["w"]["loc"].double().cpu().numpy() - pmean) / psd))

    def fullrank():
        rf = None
        for si, lr in enumerate(VI_SCALE_LADDER):
            seg = ftt.VIConfig(n_iterations=VI_SCALE_SEGMENT, n_samples=16,
                               plateau_window=10**9, check_every=VI_SCALE_SEGMENT,
                               learning_rate=lr)
            rf = ftt.optimize_fullrank_vi(41 + si, staged=staged, config=seg, resume=rf)
        return rf

    rf, fr_wall, fr_syncs = _timed_syncs(fullrank)
    fr_err = float(np.max(np.abs(rf.params["loc"].double().cpu().numpy() - pmean) / psd))
    cov = rf.guide.covariance(rf.params).double().cpu().numpy()
    ratio = np.sqrt(np.diag(cov)) / psd
    fr_iters = VI_SCALE_SEGMENT * len(VI_SCALE_LADDER)
    row = {"phase": "vi_scale", "card": card_line(), "d": VI_SCALE_D, "rows": VI_SCALE_N,
           "meanfield_wall_s": mf_wall, "meanfield_ms_per_iteration": 1e3 * mf_wall / 3000,
           "fullrank_wall_s": fr_wall, "fullrank_ms_per_iteration": 1e3 * fr_wall / fr_iters,
           "fullrank_iterations": fr_iters, "host_syncs": mf_syncs + fr_syncs,
           "mf_err": mf_err, "fr_err": fr_err, "fr_sd_ratio_min": float(ratio.min()),
           "fr_sd_ratio_max": float(ratio.max()), "reference": VI_SCALE}
    emit(row)
    check(np.isfinite(ratio).all() and np.isfinite(mf_err) and np.isfinite(fr_err),
          "vi_scale: non-finite result")
    # no worse than the JAX package's: the errors bounded from above, the sd
    # ratios' range from outside
    runs = VI_REF_RUNS["scale"]
    for name, x, side in (("mf_err", mf_err, 1), ("fr_err", fr_err, 1),
                          ("fr_sd_ratio_min", ratio.min(), -1), ("fr_sd_ratio_max", ratio.max(), 1)):
        _within(float(x), VI_SCALE[name], runs, f"vi_scale {name}", side)


def _abc_sim(n_obs):
    """bench_abc's simulator: mu_p ~ N(0, 2^2), n_obs draws of N(mu_p, 1)."""
    import fugue_tpu_torch as ftt

    def sim():
        mu = ftt.sample("mu_p", ftt.Normal(0.0, 2.0))
        return ftt.sample("xs", ftt.Normal(mu, 1.0), sample_shape=(n_obs,))

    return sim


def _abc_distance(a, b):
    return torch.abs(torch.mean(a) - torch.mean(b))


def phase_abc_rejection():
    """bench_abc's rejection: eps 0.02, 4,096 samples, batch 2^17 x 16."""
    import fugue_tpu_torch as ftt

    obs_np = abc_data()
    post_m, post_sd = abc_posterior(obs_np)
    obs = torch.as_tensor(obs_np, dtype=torch.float32, device="cuda")
    staged = ftt.stage(_abc_sim(ABC_N_OBS), device="cuda")
    batch, inner = 1 << 17, 16
    ftt.abc_rejection(0, staged=staged, observed=obs, distance=_abc_distance, epsilon=0.02,
                      n_samples=16, batch_size=batch, max_attempts=1 << 26)  # first use
    res, wall, syncs = _timed_syncs(lambda: ftt.abc_rejection(
        30, staged=staged, observed=obs, distance=_abc_distance, epsilon=0.02, n_samples=4096,
        batch_size=batch, inner_batches=inner, max_attempts=1 << 26))
    x = res.particles["mu_p"].double().cpu().numpy()
    check(x.shape == (4096,) and np.isfinite(x).all(), "abc_rejection particles")
    check(float(res.distances.max()) <= 0.02, "abc_rejection: a particle farther than epsilon")
    z = (x.mean() - post_m) / (post_sd / math.sqrt(x.size))
    ratio = x.std() / post_sd
    row = {"phase": "abc_rejection", "card": card_line(), "n_obs": ABC_N_OBS, "epsilon": 0.02,
           "batch": batch, "inner_batches": inner, "wall_s": wall,
           "abc_rejection_sims_per_sec_64obs": res.n_attempts / wall,
           "n_attempts": res.n_attempts, "dispatches": res.n_attempts // (batch * inner),
           "host_syncs_per_run": syncs, "mean": x.mean(), "post_mean": post_m, "mean_z": z,
           "sd_ratio": ratio}
    emit(row)
    check(abs(z) < 5.0, f"abc_rejection mean {x.mean()} is {z:.2f} SE from {post_m}")
    check(abs(ratio - 1.0) < 0.06, f"abc_rejection sd ratio {ratio}")
    check(syncs == row["dispatches"], f"abc_rejection: {syncs} host syncs for {row['dispatches']} "
          "dispatches, want one read each")


def phase_abc_smc():
    """bench_abc's ABC-SMC: 2,048 particles, eps (0.5, 0.2, 0.1, 0.05),
    batch 16,384; the weighted run, and abc_smc (the same weighted run and
    the terminal systematic resample)."""
    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.ops import kernels as K

    obs_np = abc_data()
    post_m, post_sd = abc_posterior(obs_np)
    obs = torch.as_tensor(obs_np, dtype=torch.float32, device="cuda")
    staged = ftt.stage(_abc_sim(ABC_N_OBS), device="cuda")
    eps = (0.5, 0.2, 0.1, 0.05)
    cfg = ftt.ABCSMCConfig(n_particles=2048, epsilons=eps, batch_size=16384,
                           max_attempts_per_stage=1 << 22)
    kw = dict(staged=staged, observed=obs, distance=_abc_distance, config=cfg,
              param_addresses=("mu_p",))
    ftt.abc_smc_weighted(0, **dict(kw, config=ftt.ABCSMCConfig(
        n_particles=256, epsilons=eps[:2], batch_size=16384)))  # first use
    launches = {}
    rows = {}
    for name, fn in (("weighted", ftt.abc_smc_weighted), ("equal_weight", ftt.abc_smc)):
        for k in K.LAUNCHES:
            K.LAUNCHES[k] = 0
        res, wall, syncs = _timed_syncs(lambda: fn(31, **kw))
        launches[name] = dict(K.LAUNCHES)
        rows[name] = (res, wall, syncs)
    rw, wall, syncs = rows["weighted"]
    w = torch.exp(rw.log_weights.double()).cpu().numpy()
    x = rw.particles["mu_p"].double().cpu().numpy()
    ess = 1.0 / float(np.sum(w * w))
    wm = float(np.sum(w * x))
    eq = rows["equal_weight"][0].particles["mu_p"].double().cpu().numpy()
    se_w = post_sd / math.sqrt(ess)
    se_eq = post_sd * math.sqrt(1.0 / ess + 1.0 / eq.size)
    n_dispatch = rw.n_attempts // cfg.batch_size
    row = {"phase": "abc_smc", "card": card_line(), "particles": 2048, "epsilons": list(eps),
           "weighted_wall_s": wall, "abc_smc_wall_s": rows["equal_weight"][1],
           "n_attempts": rw.n_attempts, "sims_per_s": rw.n_attempts / wall,
           "dispatches": n_dispatch, "host_syncs_per_run": syncs,
           "ms_per_dispatch": 1e3 * wall / n_dispatch, "ess": ess,
           "weighted_mean": wm, "equal_weight_mean": float(eq.mean()), "post_mean": post_m,
           "weighted_mean_z": (wm - post_m) / se_w, "equal_weight_mean_z": (eq.mean() - post_m) / se_eq,
           "launches": launches}
    emit(row)
    check(np.isfinite(x).all() and abs(w.sum() - 1.0) < 1e-6, "abc_smc weights")
    check(abs(row["weighted_mean_z"]) < 5.0, f"abc_smc weighted mean {wm} vs {post_m}")
    check(abs(row["equal_weight_mean_z"]) < 5.0, f"abc_smc equal-weight mean {eq.mean()} vs {post_m}")
    check(syncs == n_dispatch, f"abc_smc: {syncs} host syncs for {n_dispatch} dispatches")
    # both kernels against their plain versions on this run's own 2,048
    # log-weights (these launches come after the counts were read)
    lw = rw.log_weights.float()
    kernel_rows = {"logsumexp": _lse_f32_check(lw, "abc_smc logsumexp"),
                   "systematic_resample": [
                       _resample_f32_contract(lw, lw.double().cpu().numpy(), u0v,
                                              f"abc_smc resample u0={u0v}")
                       for u0v in (0.37, 0.0, 1.0 - 2.0**-24)]}
    emit({"phase": "abc_smc", "kernels_vs_plain_on_the_run_weights": kernel_rows})
    # one logsumexp per proposal stage (its weights' normalisation) and one
    # for the final normalisation; abc_smc adds the one terminal resample
    n_stages = len(eps)
    for name, want_resample in (("weighted", 0), ("equal_weight", 1)):
        got = launches[name]
        check(got["lse"] == n_stages and got["resample"] == want_resample and got["nll"] == 0,
              f"abc_smc {name}: launches {got}, want {n_stages} logsumexp, {want_resample} resample")
    return launches["equal_weight"]


# ---------------------------------------------------------------------------
# the other engines: MAP/Laplace and the bf16 products at d = 1024,
# marginalization, Gibbs, elliptical slice, tempering, LOO, the validation
# harness, SBC and trans-dimensional MH
# ---------------------------------------------------------------------------

# The card's dense bf16 tensor-core peak (NVIDIA's H100 SXM data sheet,
# without sparsity): the operations side of the logistic row's bound.
BF16_OPS_PER_S = 989.4e12
LOGISTIC_SHAPE = (1024, 100_000, 256)  # bench_scale_logistic's D, N and chains
GEMM_KERNEL = ("gemm", "nvjet", "cutlass", "xmma", "sm90_")


def logistic_data(d, n, seed=0, device="cuda"):
    """bench_scale_logistic's data, made on the card: X = N(0, 1)/sqrt(D)
    in bf16, w_true ~ N(0, 1), y ~ Bernoulli(sigmoid(X w_true)) with the
    logits in float32."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn((n, d), generator=g, device=device) / math.sqrt(d)).to(torch.bfloat16)
    w_true = torch.randn(d, generator=g, device=device)
    logits = x.float() @ w_true
    y = torch.rand(n, generator=g, device=device) < torch.sigmoid(logits)
    return x, y, w_true


def logistic_model(x, y):
    """w ~ Normal(0, 1) over D coefficients, y ~ BernoulliLogits(X w), the
    product split-bf16 with the single-pass backward."""
    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.ops.linalg import matmul_bf16x2_fastgrad

    zeros = torch.zeros(x.shape[1], device=x.device)

    def logistic():
        w = ftt.sample("w", ftt.Normal(zeros, 1.0))
        ftt.observe("y", ftt.BernoulliLogits(matmul_bf16x2_fastgrad(x, w)), y)

    return logistic


def newton_logistic(x, y, iters=12):
    """The MAP of the logistic model in float64 on the same bf16 data, by
    Newton's method with plain float64 products: (w, posterior sds from the
    inverse negative Hessian, Newton steps taken)."""
    x64, y64 = x.double(), y.double()
    w = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    eye = torch.eye(x.shape[1], dtype=torch.float64, device=x.device)
    for it in range(iters):
        p = torch.sigmoid(x64 @ w)
        g = x64.T @ (y64 - p) - w
        h = (x64 * (p * (1 - p))[:, None]).T @ x64 + eye
        step = torch.linalg.solve(h, g)
        w = w + step
        if step.abs().max().item() < 1e-12:
            break
    p = torch.sigmoid(x64 @ w)
    h = (x64 * (p * (1 - p))[:, None]).T @ x64 + eye
    sd = torch.sqrt(torch.diagonal(torch.linalg.inv(h)))
    return w, sd, it + 1


def _gemm_events(events):
    return [e for e in events if any(k in e.name.lower() for k in GEMM_KERNEL)]


def phase_logistic_scale():
    """bench_scale_logistic at full width: the split-bf16 products, a MAP
    warm start by L-BFGS and 256 HMC chains, D = 1024, N = 100,000."""
    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.inference.mcmc_utils import ess_multichain, split_r_hat
    from fugue_tpu_torch.ops import linalg

    d, n, c = LOGISTIC_SHAPE
    L, n_warmup, n_samples = 16, 300, 128
    x, y, w_true = logistic_data(d, n)
    row = {"phase": "logistic_scale", "card": card_line(), "D": d, "N": n, "chains": c}

    # the products: float32 out, value and gradient against float64 products
    # of the same bf16 data. matmul_bf16x2 splits both directions (1e-3);
    # the fastgrad backward rounds the cotangent to bf16 once by design, so
    # its gradient is held to twice bf16's unit roundoff, 2^-8
    w = torch.randn(d, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    cot = torch.rand(n, generator=torch.Generator(device="cuda").manual_seed(2), device="cuda")
    exact = x.double() @ w.double()
    g_exact = x.double().T @ cot.double()
    for name, grad_tol in (("matmul_bf16x2", 1e-3), ("matmul_bf16x2_fastgrad", 2.0**-8)):
        wg = w.clone().requires_grad_(True)
        out = getattr(linalg, name)(x, wg)
        check(out.dtype == torch.float32, f"logistic_scale: {name} returns {out.dtype}")
        (g,) = torch.autograd.grad(torch.sum(cot * out), wg)
        rel_v = ((out.double() - exact).abs().max() / exact.abs().max()).item()
        rel_g = ((g.double() - g_exact).abs().max() / g_exact.abs().max()).item()
        row[f"{name}_rel_err"] = rel_v
        row[f"{name}_grad_rel_err"] = rel_g
        check(rel_v < 1e-3 and rel_g < grad_tol, f"logistic_scale: {name} value {rel_v} / "
              f"gradient {rel_g} off float64 by >= 1e-3 / {grad_tol}")

    counted, runs = _counted(logistic_model(x, y))
    staged = ftt.stage(counted, device="cuda")
    grad_u = torch.func.vmap(torch.func.grad_and_value(staged.potential))

    # three GEMMs per batched gradient whatever the chain count
    for chains in (1, c):
        q = 0.1 * torch.randn((chains, d), device="cuda")
        grad_u(q)
        torch.cuda.synchronize()
        before = linalg.GEMMS["cuda"]
        _, events = traced_kernels(lambda: grad_u(q))
        gemms = linalg.GEMMS["cuda"] - before
        kernels = _gemm_events(events)
        row[f"gemm_calls_per_gradient_c{chains}"] = gemms
        row[f"gemm_kernels_per_gradient_c{chains}"] = len(kernels)
        check(gemms <= 3, f"logistic_scale: {gemms} GEMM calls per batched gradient at C={chains}")
    q = 0.1 * torch.randn((c, d), device="cuda")
    prof, events = traced_kernels(lambda: grad_u(q))
    row["kernels_per_gradient"] = len(events)
    row["device_us_per_gradient"] = sum(e.time_range.elapsed_us() for e in events)
    row["gemm_device_us_per_gradient"] = sum(e.time_range.elapsed_us() for e in _gemm_events(events))
    row["ms_per_gradient"] = median_ms(lambda: grad_u(q), reps=10)
    bytes_x = 3 * n * d * 2  # three reads of the bf16 X
    t_ops, t_bytes = 6 * c * n * d / BF16_OPS_PER_S, bytes_x / HBM_BYTES_PER_S
    row["gemm_bound_us"] = 1e6 * max(t_ops, t_bytes)
    row["gemm_bound_by"] = "operations" if t_ops > t_bytes else "bytes"

    # the float64 Newton point and posterior sds on the same data
    t0 = time.perf_counter()
    w_newton, sd, steps = newton_logistic(x, y)
    row.update(newton_s=time.perf_counter() - t0, newton_steps=steps)

    cfg = ftt.MAPConfig(n_iterations=120, optimizer="lbfgs", n_restarts=1)
    m, map_wall, map_syncs = _timed_syncs(lambda: ftt.map_estimate(0, staged=staged,
                                                                   config=cfg))
    map_z = ((m.z.double() - w_newton) / sd).abs().max().item()
    row.update(map_wall_s=map_wall, map_iterations_per_s=cfg.n_iterations / map_wall,
               map_host_syncs=map_syncs, map_host_syncs_counted=m.host_syncs,
               map_grad_norm=m.grad_norm, map_max_sd_from_newton=map_z)
    check(map_z < 0.05, f"logistic_scale: MAP {map_z} posterior sds from the Newton point")

    hcfg = ftt.HMCConfig(n_leapfrog=L, target_accept=0.8)
    runs[0] = 0
    before = linalg.GEMMS["cuda"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ftt.hmc_chain(2, staged=staged, n_samples=n_samples, n_warmup=n_warmup, config=hcfg,
                        n_chains=c, init_position=m.z, init_jitter=0.05)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gemms, model_runs = linalg.GEMMS["cuda"] - before, runs[0]
    ws = res.samples["w"].double()  # (C, S, D)
    sub = ws[:, :, ::16].permute(2, 0, 1)  # (64, C, S)
    rhat = split_r_hat(sub).max().item()
    ess = ess_multichain(sub)
    div = res.divergences.float().mean().item()
    err = ((ws.mean(dim=(0, 1)) - w_true.double()).abs() / sd).mean().item()
    grad_evals = c * (n_warmup + n_samples) * (L + 1)
    # one sampling transition's idle share: device time over its wall
    q_f = res.final_positions

    def one_transition():
        return ftt.hmc_chain(3, staged=staged, n_samples=1, n_warmup=0,
                             config=ftt.HMCConfig(n_leapfrog=L, step_size=res.step_size),
                             n_chains=c, init_position=q_f)

    one_transition()
    t_ms = median_ms(one_transition, reps=3)
    _, tev = traced_kernels(one_transition)
    busy_ms = sum(e.time_range.elapsed_us() for e in tev) / 1e3
    row.update(warmup=n_warmup, samples=n_samples, n_leapfrog=L, hmc_wall_s=wall,
               grad_evals_per_s=grad_evals / wall,
               ess_min=ess.min().item(), ess_median=ess.median().item(),
               ess_per_grad=ess.min().item() / grad_evals,
               split_rhat_max=rhat, divergence_rate=div, step_size=res.step_size,
               mean_abs_err_in_sd=err, gemm_calls=gemms, model_runs=model_runs,
               transition_ms=t_ms, transition_device_ms=busy_ms,
               idle_share=1.0 - busy_ms / t_ms, dtype=str(res.samples["w"].dtype))
    emit(row)
    check(gemms <= 3 * model_runs, f"logistic_scale: {gemms} GEMMs in {model_runs} model runs")
    check(rhat < 1.01, f"logistic_scale: max split-R-hat over w[::16] {rhat} >= 1.01")
    check(div < 0.01, f"logistic_scale: divergence rate {div} >= 1%")
    check(0.70 <= err <= 0.90, f"logistic_scale: mean |w_bar - w_true| / sd {err} "
          "outside [0.70, 0.90] (E|Z| = 0.798)")


def phase_laplace_regression():
    """examples/map_laplace.py: the ridge regression by Adam and L-BFGS
    against its closed form, and the Laplace evidence of a linear and a
    quadratic model."""
    import fugue_tpu_torch as ftt

    rng = np.random.default_rng(42)
    x = rng.normal(size=50)
    y = 1.5 * x + 0.5 + rng.normal(size=50) * 0.4
    y2 = 0.8 * x**2 - 0.2 * x + rng.normal(size=50) * 0.4
    tau, sigma = 10.0, 0.4
    xt, yt, y2t = (torch.tensor(v, dtype=torch.float32, device="cuda") for v in (x, y, y2))

    def regression():
        a = ftt.sample("a", ftt.Normal(0.0, tau))
        b = ftt.sample("b", ftt.Normal(0.0, tau))
        ftt.observe("y", ftt.Normal(a * xt + b, sigma), yt)

    def linear():
        a = ftt.sample("a", ftt.Normal(0.0, 2.0))
        b = ftt.sample("b", ftt.Normal(0.0, 2.0))
        ftt.observe("y", ftt.Normal(a * xt + b, sigma), y2t)

    def quadratic():
        a = ftt.sample("a", ftt.Normal(0.0, 2.0))
        b = ftt.sample("b", ftt.Normal(0.0, 2.0))
        c = ftt.sample("c", ftt.Normal(0.0, 2.0))
        ftt.observe("y", ftt.Normal(c * xt**2 + a * xt + b, sigma), y2t)

    A = np.stack([x, np.ones_like(x)], axis=1)
    prec = A.T @ A / sigma**2 + np.eye(2) / tau**2
    ridge, cov = np.linalg.solve(prec, A.T @ y / sigma**2), np.linalg.inv(prec)
    row = {"phase": "laplace_regression", "card": card_line()}
    for opt in ("adam", "lbfgs"):
        t0 = time.perf_counter()
        r = ftt.map_estimate(0, regression, ftt.MAPConfig(optimizer=opt), device="cuda")
        la = ftt.laplace_approximation(r)
        wall = time.perf_counter() - t0
        err = max(abs(r.latents["a"].item() - ridge[0]), abs(r.latents["b"].item() - ridge[1]))
        sd_err = max(abs(la.sd("a").item() - math.sqrt(cov[0, 0])),
                     abs(la.sd("b").item() - math.sqrt(cov[1, 1])))
        row.update({f"{opt}_map_err": err, f"{opt}_sd_err": sd_err, f"{opt}_wall_s": wall,
                    f"{opt}_host_syncs": r.host_syncs})
        check(err < 1e-4, f"laplace_regression: {opt} MAP {err} from the ridge solution")
        check(sd_err < 1e-4, f"laplace_regression: {opt} Laplace sd {sd_err} from exact")
    cfg = ftt.MAPConfig(optimizer="lbfgs")
    lz_lin = ftt.laplace_approximation(ftt.map_estimate(1, linear, cfg, device="cuda"))
    lz_quad = ftt.laplace_approximation(ftt.map_estimate(1, quadratic, cfg, device="cuda"))
    cov_y = sigma**2 * np.eye(50) + 4.0 * A @ A.T
    exact = -0.5 * (y2 @ np.linalg.solve(cov_y, y2) + np.linalg.slogdet(cov_y)[1]
                    + 50 * math.log(2 * math.pi))
    row.update(log_evidence_linear=lz_lin.log_evidence, log_evidence_linear_exact=exact,
               log_evidence_quadratic=lz_quad.log_evidence)
    emit(row)
    check(lz_quad.log_evidence > lz_lin.log_evidence, "laplace_regression: the linear model won")
    check(abs(lz_lin.log_evidence - exact) < 1e-3,
          f"laplace_regression: linear log evidence {lz_lin.log_evidence} != exact {exact}")


def gmm_data():
    """12 points from np.random.default_rng(0): 5 from N(-2, 0.5), 7 from
    N(2, 0.5)."""
    rng = np.random.default_rng(0)
    return np.concatenate([rng.normal(-2.0, 0.5, 5), rng.normal(2.0, 0.5, 7)])


def gmm_model(data, device, dtype=torch.float32):
    """The enumerated mixture of tests/test_marginalize.py: mu0 ~ N(-1, 3),
    mu1 ~ N(1, 3), one Categorical(1/2, 1/2) assignment per point, y ~
    N(mu_z, 0.5)."""
    import fugue_tpu_torch as ftt

    y = torch.tensor(data, dtype=dtype, device=device)

    def gmm():
        mus = torch.stack([ftt.sample("mu0", ftt.Normal(-1.0, 3.0)),
                           ftt.sample("mu1", ftt.Normal(1.0, 3.0))])
        for i in range(len(data)):
            zi = ftt.sample(f"assign#{i:02d}", ftt.Categorical.uniform(2))
            ftt.observe(f"y#{i:02d}", ftt.Normal(mus[zi], 0.5), y[i])

    return gmm


def gmm_quadrature(data, half, lo=-6.0, hi=6.0, m=1201):
    """E[mu0], E[mu1] of the exact marginal posterior restricted to one
    half-plane (``half`` +1: mu0 < mu1; -1: mu0 > mu1), by 2-D quadrature
    in float64 on the card, and the half-plane's posterior mass."""
    g = torch.linspace(lo, hi, m, dtype=torch.float64, device="cuda")
    m0, m1 = torch.meshgrid(g, g, indexing="ij")
    lp = -0.5 * ((m0 + 1.0) / 3.0) ** 2 - 0.5 * ((m1 - 1.0) / 3.0) ** 2
    for v in data:
        l0 = -0.5 * ((v - m0) / 0.5) ** 2
        l1 = -0.5 * ((v - m1) / 0.5) ** 2
        lp = lp + torch.logaddexp(l0, l1)
    w = torch.exp(lp - lp.max())
    mask = (m1 > m0) if half > 0 else (m1 < m0)
    wm = w * mask
    return ((wm * m0).sum() / wm.sum()).item(), ((wm * m1).sum() / wm.sum()).item(), \
        (wm.sum() / w.sum()).item()


def phase_marginal_gmm():
    """The enumerated GMM (2^12 = 4,096 states) through marginalize and
    HMC, 1024 chains, then infer_discrete's co-assignments."""
    import fugue_tpu_torch as ftt

    data = gmm_data()
    n_chains, n_warmup, n_samples, L = 1024, 80, 80, 16  # cut from 200 + 200
    marg = ftt.marginalize(gmm_model(data, "cuda"), device="cuda")
    check(marg.n_states == 4096, f"marginal_gmm: {marg.n_states} states, want 4096")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ftt.hmc_chain(0, staged=marg, n_samples=n_samples, n_warmup=n_warmup,
                        n_chains=n_chains, config=ftt.HMCConfig(n_leapfrog=L))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mu0, mu1 = res.samples["mu0"].double(), res.samples["mu1"].double()
    # HMC does not cross between the two labellings: hold each chain's
    # draws to the quadrature of its own half-plane
    order = torch.sign((mu1 - mu0).mean(dim=1))
    row = {"phase": "marginal_gmm", "card": card_line(), "chains": n_chains, "states": 4096,
           "warmup": n_warmup, "samples": n_samples, "n_leapfrog": L, "wall_s": wall,
           "grad_evals_per_s": n_chains * (n_warmup + n_samples) * (L + 1) / wall,
           "divergence_rate": res.divergences.float().mean().item()}
    for half, name in ((1.0, "ordered"), (-1.0, "swapped")):
        sel = order == half
        k = int(sel.sum().item())
        e0, e1, mass = gmm_quadrature(data, half)
        row[f"{name}_chains"], row[f"{name}_mass_exact"] = k, mass
        if k < 8:
            continue
        for v, want, site in ((mu0[sel], e0, "mu0"), (mu1[sel], e1, "mu1")):
            row[f"{name}_{site}"] = _moment_gate(v, want, f"marginal_gmm {name} {site}")
    check(row["ordered_chains"] >= 8, "marginal_gmm: fewer than 8 chains in the ordered mode")
    # the discrete posterior: co-assignment of the points over 4,096 draws
    last = {a: v[:, -4:] for a, v in res.samples.items()}
    zs = marg.infer_discrete(5, last)
    lab = torch.stack([zs[f"assign#{i:02d}"].reshape(-1) for i in range(12)], dim=1)
    co = (lab[:, :, None] == lab[:, None, :]).double().mean(0)  # (12, 12)
    first, second = slice(0, 5), slice(5, 12)
    within = torch.cat([co[first, first].reshape(-1), co[second, second].reshape(-1)]).min()
    across = co[first, second].max()
    row.update(coassign_within_min=within.item(), coassign_across_max=across.item())
    emit(row)
    check(within.item() > 0.95, f"marginal_gmm: co-assignment within a cluster {within.item()}")
    check(across.item() < 0.05, f"marginal_gmm: co-assignment across clusters {across.item()}")


def _moment_gate(x, want, what):
    """x's mean within 5 MC-SE (multi-chain ESS) of ``want``: the z."""
    from fugue_tpu_torch.inference.mcmc_utils import ess_multichain

    x = x.double()
    ess = ess_multichain(x).item()
    se = x.std().item() / math.sqrt(max(ess, 1.0))
    z = (x.mean().item() - want) / se
    check(abs(z) < 5.0, f"{what}: mean {x.mean().item()} is {z:.2f} MC-SE from {want}")
    return {"mean": x.mean().item(), "exact": want, "z": z, "ess": ess}


def phase_gibbs_mixed():
    """HMC-within-Gibbs on the mixed model of examples/discrete_models.py,
    1024 chains."""
    import fugue_tpu_torch as ftt

    n_chains, n_warmup, n_samples = 1024, 200, 300
    staged = ftt.stage(mixed_discrete_model("cuda"), device="cuda")
    res, wall, syncs = _timed_syncs(lambda: ftt.gibbs_chain(
        0, staged=staged, n_samples=n_samples, n_warmup=n_warmup, n_chains=n_chains))
    _, p_heads = mixed_discrete_exact()
    mean_mu = p_heads * (1.0 + 8.0) / 9.0 + (1.0 - p_heads) * (-1.0 + 8.0) / 9.0
    row = {"phase": "gibbs_mixed", "card": card_line(), "chains": n_chains,
           "warmup": n_warmup, "samples": n_samples, "wall_s": wall,
           "sweeps_per_s": n_chains * (n_warmup + n_samples) / wall, "host_syncs": syncs,
           "step_size": res.step_size, "accept_hmc": res.accept_prob_hmc.mean().item(),
           "accept_discrete": res.accept_rate_discrete.item(),
           "heads": _moment_gate(res.samples["heads"], p_heads, "gibbs_mixed P(heads)"),
           "mu": _moment_gate(res.samples["mu"], mean_mu, "gibbs_mixed E[mu]")}
    emit(row)


def gp_data():
    """examples/gaussian_process.py's inputs: six points on [0, 1], an RBF
    kernel (length 0.4, jitter 1e-6), noise 0.3, y = sin(2 pi x) + noise
    from np.random.default_rng(0), and the class labels."""
    xg = np.linspace(0.0, 1.0, 6)
    k = np.exp(-0.5 * ((xg[:, None] - xg[None, :]) / 0.4) ** 2) + 1e-6 * np.eye(6)
    y = np.sin(2 * np.pi * xg) + np.random.default_rng(0).normal(0, 0.3, 6)
    return k, y, np.array([True, True, True, False, False, False])


def phase_ess_gp():
    """Elliptical slice sampling on the GP regression (against its closed
    form) and the GP classification, 1024 chains."""
    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.inference.mcmc_utils import ess_multichain

    n_chains, n_warmup, n_samples = 1024, 300, 1000
    k, y, labels = gp_data()
    kt = torch.tensor(k, dtype=torch.float32, device="cuda")
    yt = torch.tensor(y, dtype=torch.float32, device="cuda")
    lt = torch.tensor(labels, device="cuda")
    zeros = torch.zeros(6, device="cuda")

    def regression():
        f = ftt.sample("f", ftt.MultivariateNormal(zeros, kt))
        ftt.observe("y", ftt.Normal(f, 0.3), yt)

    def classification():
        f = ftt.sample("f", ftt.MultivariateNormal(zeros, kt))
        ftt.observe("y", ftt.Bernoulli(torch.sigmoid(3.0 * f)), lt)

    row = {"phase": "ess_gp", "card": card_line(), "chains": n_chains, "warmup": n_warmup,
           "samples": n_samples}
    n_t = n_warmup + n_samples
    for name, model in (("regression", regression), ("classification", classification)):
        res, wall, syncs = _timed_syncs(lambda: ftt.ess_chain(
            0, model, n_samples=n_samples, n_warmup=n_warmup, n_chains=n_chains,
            device="cuda"))
        row[name] = {"wall_s": wall, "transitions_per_s": n_chains * n_t / wall,
                     "likelihood_evals_per_transition": res.mean_shrink_iters,
                     "host_reads_per_transition": res.host_reads / n_t,
                     "host_syncs_per_transition": syncs / n_t}
        fs = res.samples["f"].double()  # (C, S, 6)
        if name == "regression":
            a = k @ np.linalg.inv(k + 0.09 * np.eye(6))
            mean, cov = a @ y, k - a @ k
            ess = ess_multichain(fs.permute(2, 0, 1))
            flat = fs.reshape(-1, 6)
            got_mean = flat.mean(0).cpu().numpy()
            got_cov = torch.cov(flat.T).cpu().numpy()
            e = ess.cpu().numpy()
            z_mean = (got_mean - mean) / np.sqrt(np.diag(cov) / e)
            # the standard error of a covariance entry: sqrt((s_ii s_jj + s_ij^2) / ESS)
            d = np.diag(cov)
            se_cov = np.sqrt((np.outer(d, d) + cov**2) / e.min())
            z_cov = (got_cov - cov) / se_cov
            row[name].update(max_mean_z=float(np.abs(z_mean).max()),
                             max_cov_z=float(np.abs(z_cov).max()), ess_min=float(e.min()))
            check(np.abs(z_mean).max() < 5.0, f"ess_gp: regression mean {z_mean} MC-SE off")
            check(np.abs(z_cov).max() < 5.0, f"ess_gp: regression covariance {z_cov} SE off")
        else:
            m = fs.reshape(-1, 6).mean(0).cpu().numpy()
            row[name]["latent_means"] = m.tolist()
            check(m[0] > 0.15 and m[-1] < -0.15, f"ess_gp: classification latent means {m}")
    emit(row)


def bimodal_model():
    """examples/parallel_tempering.py: x ~ 0.3 N(-4, 0.4) + 0.7 N(4, 0.4),
    scored as a factor over a broad N(0, 10) instrumental prior."""
    import fugue_tpu_torch as ftt

    def bimodal():
        x = ftt.sample("x", ftt.Normal(0.0, 10.0))
        mix = torch.logaddexp(math.log(0.3) + ftt.Normal(-4.0, 0.4).log_prob(x),
                              math.log(0.7) + ftt.Normal(4.0, 0.4).log_prob(x))
        ftt.factor(mix - ftt.Normal(0.0, 10.0).log_prob(x))
        return x

    return bimodal


def phase_pt_bimodal():
    """Parallel tempering on the bimodal target, 1024 chains x 8 rungs."""
    import fugue_tpu_torch as ftt

    n_chains, n_warmup, n_samples = 1024, 200, 400
    cfg = ftt.PTConfig(n_temps=8, beta_min=0.02, n_leapfrog=12)
    res, wall, syncs = _timed_syncs(lambda: ftt.pt_chain(
        0, bimodal_model(), n_samples=n_samples, n_warmup=n_warmup, config=cfg,
        n_chains=n_chains, device="cuda"))
    x = res.samples["x"]
    n_rep = cfg.n_temps * n_chains
    row = {"phase": "pt_bimodal", "card": card_line(), "chains": n_chains,
           "replicas": n_rep, "warmup": n_warmup, "samples": n_samples, "wall_s": wall,
           "grad_evals_per_s": n_rep * (n_warmup + n_samples) * (cfg.n_leapfrog + 1) / wall,
           "host_syncs": syncs, "swap_rate": res.swap_rate.tolist(),
           "step_size": res.step_size.tolist(), "accept_prob": res.accept_prob.tolist(),
           "p_right": _moment_gate((x > 0).double(), 0.7, "pt_bimodal P(x > 0)"),
           "mean": _moment_gate(x, 1.6, "pt_bimodal E[x]")}
    emit(row)


def phase_loo_eight_schools(hmc_result=None):
    """The pointwise log-likelihood, WAIC and PSIS-LOO of an eight-schools
    HMC run's draws (the eight_schools phase's, when it ran)."""
    import fugue_tpu_torch as ftt

    staged = ftt.stage(eight_schools_model("cuda"), device="cuda")
    if hmc_result is None:
        hmc_result = ftt.hmc_chain(1, staged=staged, n_samples=100, n_warmup=100,
                                   config=ftt.HMCConfig(n_leapfrog=32, target_accept=0.9),
                                   n_chains=256)
    s = hmc_result.samples
    ll, wall, syncs = _timed_syncs(lambda: ftt.pointwise_log_likelihood(s, staged=staged))
    y = torch.tensor([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0], dtype=torch.float64)
    sig = torch.tensor([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0], dtype=torch.float64)
    theta = (s["mu"][..., None] + s["tau"][..., None] * s["theta_raw"]).double().cpu()
    direct = (-0.5 * ((y - theta) / sig) ** 2 - torch.log(sig)
              - 0.5 * math.log(2 * math.pi)).reshape(-1, 8)
    err = (ll.double().cpu() - direct).abs().max().item()
    card_waic, cpu_waic = ftt.waic(ll), ftt.waic(ll.cpu())
    card_loo, cpu_loo = ftt.psis_loo(ll), ftt.psis_loo(ll.cpu())
    row = {"phase": "loo_eight_schools", "card": card_line(), "draws": ll.shape[0],
           "observations": ll.shape[1], "pointwise_wall_s": wall, "pointwise_host_syncs": syncs,
           "max_abs_err": err, "waic_elpd": card_waic.elpd, "waic_elpd_cpu": cpu_waic.elpd,
           "loo_elpd": card_loo.elpd, "loo_elpd_cpu": cpu_loo.elpd, "loo_se": card_loo.se,
           "p_eff": card_loo.p_eff, "pareto_k": card_loo.pareto_k.tolist(),
           "pareto_k_max": float(card_loo.pareto_k.max())}
    emit(row)
    check(ll.shape == (direct.shape[0], 8) and ll.device.type == "cuda",
          f"loo_eight_schools: matrix {tuple(ll.shape)} on {ll.device}")
    check(err < 1e-5, f"loo_eight_schools: matrix {err} from the direct log-densities")
    for a, b, what in ((card_waic.elpd, cpu_waic.elpd, "waic"), (card_loo.elpd, cpu_loo.elpd,
                                                                 "loo")):
        check(abs(a - b) <= 1e-9 * max(1.0, abs(b)), f"loo_eight_schools: {what} elpd {a} "
              f"from the card's matrix, {b} from its CPU copy")


def phase_validation_conjugate():
    """The conjugate harnesses through the hmc, mh and smc adapters at
    256 chains, each moment gated at 5 MC-SE from the result's own fields.
    The smc adapter runs adaptive_smc on 256 x 1,500 = 384,000 particles
    and a terminal systematic resample: both SMC kernels are on this path.
    Their launches are counted per run (4 * stages + 3 logsumexp, stages
    resamples), and both are then held against their plain versions on
    each run's own 384,000 log-weights. Returns the smc runs' launches."""
    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.inference import smc as smc_mod
    from fugue_tpu_torch.ops import kernels as K

    runs = []  # the smc adapter's adaptive_smc results, recorded as they return
    real_adaptive_smc = smc_mod.adaptive_smc

    def recording_adaptive_smc(*args, **kwargs):
        res = real_adaptive_smc(*args, **kwargs)
        runs.append(res)
        return res

    row = {"phase": "validation_conjugate", "card": card_line()}
    launches = {"lse": 0, "resample": 0}
    smc_mod.adaptive_smc = recording_adaptive_smc
    try:
        for sampler in ("hmc", "mh", "smc"):
            cut = dict(n_samples=100, n_warmup=100) if sampler == "hmc" else {}
            for name, fn, cfg in (
                    ("normal", ftt.validate_conjugate_normal,
                     ftt.ConjugateNormalConfig(n_chains=256, **cut)),
                    ("beta_bernoulli", ftt.validate_beta_bernoulli,
                     ftt.ConjugateBetaBernoulliConfig(n_chains=256, **cut))):
                torch.cuda.synchronize()
                for k in K.LAUNCHES:
                    K.LAUNCHES[k] = 0
                r, wall, _ = _timed_syncs(lambda: fn(0, sampler, cfg, device="cuda"))
                got = dict(K.LAUNCHES)
                se_mean = math.sqrt(r.expected_var / r.ess)
                se_var = r.expected_var * math.sqrt(2.0 / max(r.ess - 1.0, 1.0))
                z_mean = (r.observed_mean - r.expected_mean) / se_mean
                z_var = (r.observed_var - r.expected_var) / se_var
                row[f"{sampler}_{name}"] = {"wall_s": wall, "draws": r.n_draws, "ess": r.ess,
                                            "z_mean": z_mean, "z_var": z_var,
                                            "harness_2se_passed": bool(r.passed),
                                            "checks": {k: bool(v) for k, v in r.checks.items()},
                                            "launches": got}
                check(abs(z_mean) < 5.0 and abs(z_var) < 5.0,
                      f"validation_conjugate {sampler} {name}: mean {z_mean:.2f}, variance "
                      f"{z_var:.2f} MC-SE from the closed form")
                if sampler != "smc":
                    check(got["lse"] == got["resample"] == 0,
                          f"validation_conjugate {sampler} {name}: SMC kernel launches {got}")
                    continue
                res = runs[-1]
                s = res.n_stages
                row[f"{sampler}_{name}"].update(particles=res.log_weights.numel(), stages=s)
                # adaptive_smc's 4 * stages + 3 logsumexp and stages - 1
                # resamples, and the adapter's terminal resample
                check(got["lse"] == 4 * s + 3 and got["resample"] == s,
                      f"validation_conjugate smc {name}: launches {got}, want {4 * s + 3} "
                      f"logsumexp, {s} resample for {s} stages")
                _add_launches(launches, got)
    finally:
        smc_mod.adaptive_smc = real_adaptive_smc
    emit(row)
    # both kernels against their plain versions on each smc run's own
    # 384,000 log-weights (these launches come after the counts were read)
    kernel_rows = {}
    for name, res in zip(("normal", "beta_bernoulli"), runs):
        lw = res.log_weights.float()
        check(lw.numel() == 256 * 1500, f"validation_conjugate smc {name}: {lw.numel()} particles")
        kernel_rows[name] = {
            "logsumexp": _lse_f32_check(lw, f"validation_conjugate {name} logsumexp"),
            "systematic_resample": [
                _resample_f32_contract(lw, lw.double().cpu().numpy(), u0v,
                                       f"validation_conjugate {name} resample u0={u0v}")
                for u0v in (0.37, 0.0, 1.0 - 2.0**-24)]}
    emit({"phase": "validation_conjugate", "kernels_vs_plain_on_the_run_weights": kernel_rows})
    return launches


def phase_sbc_normal():
    """SBC at tests/test_sbc.py's settings (96 datasets, 63 draws, thin 4,
    200 warmup), and its wrong-prior control."""
    import fugue_tpu_torch as ftt

    def model(data):
        mu = ftt.sample("mu", ftt.Normal(0.0, 1.0))
        sig = ftt.sample("sig", ftt.LogNormal(0.0, 0.5))
        ftt.observe("y", ftt.Normal(mu, sig), data["y"])

    def wrong(data):
        mu = ftt.sample("mu", ftt.Normal(3.0, 0.3))
        sig = ftt.sample("sig", ftt.LogNormal(0.0, 0.5))
        ftt.observe("y", ftt.Normal(mu, sig), data["y"])

    kw = dict(n_datasets=96, n_posterior=63, n_warmup=200, thin=4, device="cuda")
    r, wall, syncs = _timed_syncs(lambda: ftt.sbc(0, model, {"y": np.zeros(8)}, **kw))
    bad, bad_wall, _ = _timed_syncs(lambda: ftt.sbc(1, model, {"y": np.zeros(8)},
                                                    inference_model_fn=wrong, **kw))
    row = {"phase": "sbc_normal", "card": card_line(), "datasets": 96, "posterior_draws": 63,
           "thin": 4, "warmup": 200, "wall_s": wall, "host_syncs": syncs,
           "p_values": r.p_values.tolist(), "chi2": r.chi2.tolist(), "passed": r.passed,
           "control_wall_s": bad_wall, "control_p_values": bad.p_values.tolist(),
           "control_passed": bad.passed}
    emit(row)
    check(float(r.p_values.min()) > 1e-4, f"sbc_normal: p-values {r.p_values} (want > 1e-4)")
    check(not bad.passed and float(bad.p_values.min()) < 1e-4,
          f"sbc_normal: the wrong-prior control was not rejected ({bad.p_values})")


def phase_mh_transdimensional():
    """examples/transdimensional.py: trans-dimensional MH, 1000 + 6000, the
    model on the card; P(b present | y) against its analytic value."""
    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.inference.mcmc_utils import ess

    y_obs = torch.tensor(2.4, device="cuda")

    def model():
        use_b = ftt.sample("use_b", ftt.Bernoulli(0.3))
        a = ftt.sample("a", ftt.Normal(0.0, 1.0))
        mean = a + ftt.sample("b", ftt.Normal(0.0, 1.0)) if bool(use_b) else a
        ftt.observe("y", ftt.Normal(mean, 0.5), y_obs)
        return mean

    n_warmup, n_samples = 1000, 6000
    res, wall, syncs = _timed_syncs(lambda: ftt.adaptive_mcmc_chain_dynamic(
        0, model, n_samples=n_samples, n_warmup=n_warmup, device="cuda"))

    def pdf(v, var):
        return math.exp(-0.5 * v * v / var) / math.sqrt(2 * math.pi * var)

    z0, z1 = pdf(2.4, 1.25), pdf(2.4, 2.25)
    exact = 0.3 * z1 / (0.3 * z1 + 0.7 * z0)
    present = torch.tensor(res.presence("b"), dtype=torch.float64)
    e = ess(present).item()
    se = math.sqrt(exact * (1 - exact) / max(e, 1.0))
    z = (present.mean().item() - exact) / se
    row = {"phase": "mh_transdimensional", "card": card_line(), "warmup": n_warmup,
           "samples": n_samples, "wall_s": wall,
           "transitions_per_s": (n_warmup + n_samples) / wall,
           "host_syncs_per_transition": syncs / (n_warmup + n_samples),
           "births": res.birth_count, "deaths": res.death_count,
           "accept_rate": res.accept_rate, "p_present": present.mean().item(),
           "exact": exact, "ess": e, "z": z}
    emit(row)
    check(abs(z) < 5.0, f"mh_transdimensional: P(b present) {present.mean().item()} is "
          f"{z:.2f} MC-SE from {exact}")


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

    kernel_rows = launches = smc_rows = nuts_launches = chees_launches = vi_launches = None
    eight_schools_run = None
    smc_launches = {"lse": 0, "resample": 0}
    if "build" in phases:
        phase_build()
    if "kernel" in phases:
        kernel_rows = phase_kernel()
    if "eight_schools" in phases:
        eight_schools_run = phase_eight_schools()
    if "gaussian_plate" in phases:
        launches = phase_gaussian_plate()
    if "smc_kernels" in phases:
        smc_rows = phase_smc_kernels()
    if "smc" in phases:
        _add_launches(smc_launches, phase_smc())
    if "nuts_eight_schools" in phases:
        phase_nuts_eight_schools()
    if "nuts_plate" in phases:
        nuts_launches = phase_nuts_plate()
    for name, phase in (("smc_coin", phase_smc_coin), ("smc_mixture", phase_smc_mixture),
                        ("smc_discrete", phase_smc_discrete)):
        if name in phases:
            _add_launches(smc_launches, phase())
    if "chees_eight_schools" in phases:
        phase_chees_eight_schools()
    if "chees_plate" in phases:
        chees_launches = phase_chees_plate()
    if "mh_coin" in phases:
        phase_mh_coin()
    if "mh_hierarchical" in phases:
        phase_mh_hierarchical()
    if "vi_hierarchical" in phases:
        phase_vi_hierarchical()
    if "vi_plate" in phases:
        vi_launches = phase_vi_plate()
    if "vi_scale" in phases:
        phase_vi_scale()
    if "abc_rejection" in phases:
        phase_abc_rejection()
    if "abc_smc" in phases:
        _add_launches(smc_launches, phase_abc_smc())
    for name, phase in (("logistic_scale", phase_logistic_scale),
                        ("laplace_regression", phase_laplace_regression),
                        ("marginal_gmm", phase_marginal_gmm), ("gibbs_mixed", phase_gibbs_mixed),
                        ("ess_gp", phase_ess_gp), ("pt_bimodal", phase_pt_bimodal)):
        if name in phases:
            phase()
    if "loo_eight_schools" in phases:
        phase_loo_eight_schools(eight_schools_run)
    eight_schools_run = None
    if "validation_conjugate" in phases:
        _add_launches(smc_launches, phase_validation_conjugate())
    for name, phase in (("sbc_normal", phase_sbc_normal),
                        ("mh_transdimensional", phase_mh_transdimensional)):
        if name in phases:
            phase()

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
        # the plate kernel's calls on its four paths: HMC, NUTS, ChEES and VI
        entry("normal_loglik_sum_value_and_grad", "nll", "normal_loglik_sum",
              kernel_rows[MAIN_SHAPE],
              launches["nll"] + nuts_launches["nll"] + chees_launches["nll"]
              + vi_launches["nll"]),
        # the SMC kernels' calls on their seven paths: the smc phase's three
        # runs, the coin (two runs), mixture and discrete phases, abc_smc and
        # the validation harness's smc adapter (two runs)
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
