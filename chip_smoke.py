#!/usr/bin/env python3
"""Drive the PyTorch port's HMC, SMC, NUTS, ChEES, MH, VI, ABC and other engines' main paths, its JSON-RPC service and its multi-device layer, on one NVIDIA GPU and check them.

    python3 chip_smoke.py                      # all phases
    python3 chip_smoke.py --phases build,kernel
    python3 chip_smoke.py --phases build,smc_kernels,smc
    python3 chip_smoke.py --phases build,nuts_eight_schools,nuts_plate
    python3 chip_smoke.py --phases build,smc_coin,smc_mixture,smc_discrete
    python3 chip_smoke.py --phases build,chees_eight_schools,chees_plate,mh_coin,mh_hierarchical
    python3 chip_smoke.py --phases build,vi_hierarchical,vi_plate,vi_scale,abc_rejection,abc_smc
    python3 chip_smoke.py --phases logistic_scale,laplace_regression,marginal_gmm,gibbs_mixed
    python3 chip_smoke.py --phases logistic_scale,scale_nuts,scale_chees,scale_densemass,scale_plate
    python3 chip_smoke.py --phases ess_gp,pt_bimodal,validation_conjugate,sbc_normal,mh_transdimensional
    python3 chip_smoke.py --phases build,serve_coin,serve_eight_schools,serve_pf
    python3 chip_smoke.py --phases build,sharded_hmc,sharded_smc,sharded_vi_plate,two_ranks,serve_sharded

Phases (each prints JSON lines; any failure raises and exits non-zero):

1. build         nvcc-build (or load) the three CUDA kernel libraries from
                 fugue_tpu_torch/csrc, one nvcc per source, all at once.
2. kernel        the Gaussian-plate value-and-grad kernel against its plain
                 PyTorch version and a float64 reference, in float32, at
                 (C, N) = (1, 2^24), (64, 2^20), (64, 2^19) (the two ranks'
                 VI slices), (3, 2^20 + 17); gates for
                 an unaligned y[k:], data far from 0, an outlier first row
                 and mu far from ybar (float32, and float64 to 1e-12 of
                 plain), non-finite rows and parameters (the plain
                 version's NaN/inf pattern), run-to-run determinism, and a
                 second derivative that raises. Times: device time per
                 call (CUDA-graph replays) and the eager call's time (host
                 dispatch included), each the median of 25
                 CUDA-event-timed repetitions, for kernel and plain.
3. eight_schools vectorized HMC, 1024 chains, L=32, target_accept 0.9,
                 100 warmup + 100 samples (bench: 200 + 200); gates on
                 split-R-hat, divergence rate and the posterior mean of mu.
4. gaussian_plate HMC on a 2^20-row Gaussian plate whose likelihood runs
                 through the CUDA kernel (64 chains, L=16, jitter 0.5,
                 100 + 100); gates on the posterior of (mu, sigma), R-hat and
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
                 NUTSConfig() (the async drive, max_depth 8, target 0.8,
                 diagonal mass), float32, 200 warmup + 200 samples; beside
                 it the lock-step build (loop="while") at 100 + 100. Each
                 gated on split-R-hat, divergence rate and the posterior
                 mean of mu (the HMC phase's constant: the same posterior),
                 the async drive on one host read per 16 iterations.
                 Reports for each grad-evals/s (bench_nuts's count and the
                 batched model runs made), ESS/s, mean tree depth, batched
                 leaves per transition beside each chain's mean, host syncs
                 per transition, and kernels and ms per batched leaf of one
                 traced transition from the run's end.
8. nuts_plate    the async drive on the 2^20-row plate (64 chains, uniform
                 init, 100 + 100, diagonal mass); the HMC plate's gates,
                 the kernel held against its plain version on one of the
                 run's own calls, and exactly one kernel call per
                 iteration, phase start (3), step-size search evaluation
                 and constrain replay.
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
                 100 + 100, bench: 300 + 128): max split-R-hat over w[::16] < 1.01,
                 divergences < 1%, mean |w_bar - w_true| / sd in [0.70,
                 0.90], at most 3 GEMMs per model run. Reports grad-evals/s,
                 ESS per gradient, ms, kernels and device us per gradient,
                 the GEMMs' device us against their bound, the idle share of
                 one transition, MAP iterations/s and host syncs.
22. scale_nuts   bench_scale_nuts at full width: ftt.nuts_chain
                 (NUTSConfig(max_depth=6)) on logistic_scale's target from its
                 MAP (jitter 0.05), 256 chains, 60 + 60 (bench: 300 + 128);
                 logistic_scale's gates. Grad-evals counted exactly (every
                 chain's leapfrogs plus one root gradient per transition),
                 transitions/s, mean tree depth, the async drive's
                 batched leaves per transition beside each chain's mean,
                 host syncs per transition and per leaf, the lock-step
                 build's factor on one transition from the run's end, ESS
                 per gradient beside logistic_scale's HMC.
23. scale_chees  bench_scale_chees at full width: the correlated design
                 X = bf16(Z Q diag(s) Q^T), s from 0.2 to 3, made on the card
                 after logistic_scale's is freed; the MAP by L-BFGS within
                 0.05 sds of a float64 Newton point; ftt.chees_chain
                 (criterion "snaper", 300 + 256) and fixed-L16 ftt.hmc_chain
                 (100 + 100: ESS per gradient is a rate) on the same target,
                 256 chains each, from the MAP; ChEES's R-hat < 1.01,
                 divergences < 1%, error in [0.70, 0.90] and ESS per gradient
                 at least HMC's. Reports mean L, T, tau reads per transition
                 and both drives' grad-evals/s.
24. scale_densemass  bench_scale_densemass at full width: d = 256, N = 8,192,
                 w ~ MVN(0, Sigma_ij = exp(-|i-j|/32)), 128 chains,
                 HMCConfig(n_leapfrog=32, mass="dense", target_accept=0.85,
                 jitter=0.5) (bench: jitter 0.2), 200 + 200 (bench: 600 +
                 1024) from the MAP (within 0.05 sds of the closed form)
                 with jitter 0.1 (bench: the prior's init); every
                 coordinate's mean within 5 MC-SE and every marginal sd
                 ratio within 5 standard errors of the float64 closed form
                 (computed on the card), max split-R-hat < 1.01, no host sync
                 in a batched gradient. Reports grad-evals/s, ms per
                 transition, the device time of the dense algebra (one
                 cholesky_ex and triangular solve per momentum draw, L + 2
                 products Sigma p), the adapted Sigma's condition number.
25. scale_plate  bench_scale_plate at full width: mu, theta (128) and one
                 vectorized observe of 128 x 8,192 rows, 64 chains, L = 16,
                 jitter 0.5, 200 + 200 (bench: 400 + 256), from bench.py's
                 conjugate warm start; mu and every
                 group within 5 MC-SE of the exact posterior, max split-R-hat
                 over all 128 groups < 1.01. Reports obs-grad rows/s, ms,
                 kernels and device us per batched gradient, the idle share
                 and torch.cuda.max_memory_allocated.
26. laplace_regression  examples/map_laplace.py: the ridge MAP by Adam and
                 L-BFGS within 1e-4 of the closed form, Laplace sds within
                 1e-4 of exact; the quadratic model's Laplace evidence beats
                 the linear one's, whose evidence is exact to 1e-3.
27. marginal_gmm the enumerated mixture of tests/test_marginalize.py on 12
                 points (4,096 states) through ftt.marginalize and
                 ftt.hmc_chain, 1024 chains, L = 16, 60 + 60 (cut from
                 200 + 200): each labelling's chains' means within 5 MC-SE
                 of a 2-D quadrature of that half-plane; infer_discrete's
                 co-assignments > 0.95 within and < 0.05 across clusters.
28. gibbs_mixed  ftt.gibbs_chain on the mixed model, 1024 chains, 100 + 200
                 (cut from 200 + 300): P(heads | y) and E[mu | y] within 5 MC-SE of the closed form.
29. ess_gp       ftt.ess_chain on the GP regression and classification of
                 examples/gaussian_process.py, 1024 chains, 150 + 300 (cut
                 from 300 + 1000): the regression's mean and covariance
                 within 5 SE of the closed form, the classification's
                 latent signs; likelihood evaluations and host reads per
                 transition.
30. pt_bimodal   ftt.pt_chain on examples/parallel_tempering.py's target,
                 8 rungs x 1024 chains, L = 12, 150 + 300: P(x > 0) and E[x]
                 within 5 MC-SE of 0.7 and 1.6; per-pair swap rates.
31. loo_eight_schools  ftt.pointwise_log_likelihood of the eight_schools
                 phase's draws (its own 256-chain run when that phase did
                 not run) within 1e-5 of log N(y_j | theta_j, sigma_j),
                 ftt.waic and ftt.psis_loo the same from the card's matrix
                 and its CPU copy; k-hat.
32. validation_conjugate  ftt.validate_conjugate_normal and
                 ftt.validate_beta_bernoulli through the hmc (60 + 60),
                 mh and smc adapters at 256 chains: each mean and variance
                 within 5 MC-SE, the harness's own 2-SE verdict reported.
33. sbc_normal   ftt.sbc at tests/test_sbc.py's settings: every p-value
                 > 1e-4, and the wrong-prior control (50 warmup, thin 1)
                 rejected.
34. mh_transdimensional  ftt.adaptive_mcmc_chain_dynamic on
                 examples/transdimensional.py, 1000 + 6000, the model on the
                 card: P(b present | y) within 5 MC-SE (the indicator's
                 ESS) of its analytic value; births, deaths, transitions/s.

Phases 35-37 each start ``serve(port=0, service=FugueService(),
block=False)`` in this process and POST JSON-RPC requests over urllib:

35. serve_coin   the coin flip (BASELINE config 1) compiled from DSL source,
                 one observe per flip: an MH session at 4,096 chains, 300 +
                 300 transitions, mh.history's mean within 5 MC-SE of 20/31,
                 host reads per mh.step request the same for n = 1, 10, 100;
                 the session's state and generator saved mid-run, restored
                 into a fresh session, both stepped 50 times: bitwise equal;
                 smc.run at 131,072 particles, mean p and log Z within 5 of
                 the run's standard errors of 20/31 and log B(20, 11) -
                 log B(2, 2), 4 * stages + 3 logsumexp and stages - 1
                 resample launches; hmc.step and nuts.step (warmup 100)
                 recorded; vi.run with both guides, 600 iterations
                 (tests/test_serve.py's, and its gates); vi.run's two
                 -32602 repairs; hmc.sharded on an unknown model -32602.
36. serve_eight_schools  non-centred eight-schools in the DSL (18 sites,
                 bench.py's priors): chees.new at 1,024 chains, 200 warmup,
                 then 100 chees.step requests (from 200); mean mu within 5 MC-SE of the
                 eight_schools constant; grad-evals/s through the service,
                 kernels and device us per batched gradient of the DSL model
                 and of the hand-written one, ms per request; one grid
                 request of 512 x 512 log joints over (mu, tau), theta_raw
                 fixed, within 3e-5 (relative, float32) of a float64 numpy
                 closed form.
37. serve_pf     pf.new at 2^20 particles (q = 0.3, r = 0.5), 200 pf.observe
                 requests on a random walk made with numpy: every filtered
                 mean within 5 sqrt(P_t (1/ESS_t + 1/N)) of the exact Kalman
                 filter's; 3 logsumexp + 1 resample launches and one host
                 read per observe; one observe under
                 utils.profiling.device_trace, whose trace names both
                 kernels.

Phases 38-42 drive fugue_tpu_torch.parallel, the multi-device layer. The
card is one GPU: phases 38-40 and 42 run one NCCL rank (the backend and
code path of one rank per GPU), phase 41 two gloo ranks in two processes
on the card (NCCL refuses two ranks on one device):

38. sharded_hmc  parallel.sharded_hmc_chain on eight-schools (1024 chains,
                 L=32, 100 + 100) and the plate (64 x 2^20, L=16, 100 + 100,
                 through the value-and-grad kernel, held against its plain
                 version on one of the run's own calls), each with its
                 single-device phase's gates and ms per transition beside
                 that phase's; exactly one collective per warmup transition
                 plus the run's 8 others, none staged through the host, and
                 no host sync added to 10 warmup transitions of the drive
                 against the single-device drive (_host_syncs); the NCCL
                 drive's ms per warmup transition over the single-device
                 drive's, both warm, timed in turns from the same start (8
                 warmup transitions per drive, 3 rounds). Then
                 parallel.sharded_nuts_chain (the async drive) on
                 eight-schools, 1024 chains, 50 + 50: eight-schools'
                 gates, exactly one all-reduce per warmup iteration plus the
                 run's 11 others, none through the host, and no host sync
                 beyond one per 16 iterations, with or without the group;
                 and on the plate (64 x 2^20, 50 + 50), the kernel held on
                 one of its calls, exactly one kernel call per iteration,
                 phase start, search evaluation and constrain replay.
39. sharded_smc  parallel's adaptive_smc(mesh=) on the hierarchical model at
                 131,072 particles, 3 MH moves: the smc phase's gates and
                 launch contracts, and both kernels against their plain
                 versions on the gathered (N,) log-weights of the run's last
                 resample.
40. sharded_vi_plate  parallel.sharded_vi in data mode (the plate likelihood
                 a sharded factor), the vi_plate configuration and gates;
                 one plate-kernel call and one all-reduce per iteration, one
                 host sync per segment; the kernel held against its plain
                 version on one of the run's own calls.
41. two_ranks    two processes (this script with --two-ranks-worker), one
                 gloo rank each: HMC on eight-schools at 2 x 512 chains (L=32,
                 60 + 60), SMC at 131,072 particles through the ring, VI's
                 data mode at 2 x 2^19 rows; results bitwise the same on both
                 ranks, the eight_schools, smc and vi_plate gates, the launch
                 contracts per rank, gloo's host stagings counted; the median
                 ms of one ring gather of the SMC run's particles; the plate
                 kernel held against its plain version on one VI call of
                 each rank (2^19 rows).
42. serve_sharded  hmc.sharded over HTTP on the DSL coin flip (256 chains,
                 L=32, 25 + 25): mean within 5 sd/sqrt(chains) of 20/31, sd within
                 10% of the exact, split-R-hat < 1.05; vi.run's host syncs
                 exactly one more than the same optimization's called
                 directly (one read for every site's summaries); a sharded
                 checkpoint of a sharded HMC state restored into its
                 template resumes bitwise.

Then it prints the card's name and power limit, one JSON line describing
the kernels, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It needs a CUDA device and nvcc, and imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
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
          "logistic_scale", "scale_nuts", "scale_chees", "scale_densemass", "scale_plate",
          "laplace_regression", "marginal_gmm", "gibbs_mixed", "ess_gp",
          "pt_bimodal", "loo_eight_schools", "validation_conjugate", "sbc_normal",
          "mh_transdimensional", "serve_coin", "serve_eight_schools", "serve_pf",
          "sharded_hmc", "sharded_smc", "sharded_vi_plate", "two_ranks", "serve_sharded")
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
VI_PLATE_MC = 64  # its MC samples per iteration: the plate kernel's chain count
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


def reset_launches():
    """Every kernel wrapper's launch count set to 0, after the work already
    queued has run."""
    from fugue_tpu_torch.ops import kernels as K

    torch.cuda.synchronize()
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0


def read_launches():
    """The launch counts since ``reset_launches``, once the work queued has
    run: {"nll", "lse", "resample"}."""
    from fugue_tpu_torch.ops import kernels as K

    torch.cuda.synchronize()
    return dict(K.LAUNCHES)


@contextlib.contextmanager
def recording(module, name):
    """``module.name`` wrapped for the block: each call's (args, result) is
    appended to the list the block gets. The wrapper calls the real
    function and launches nothing of its own."""
    real = getattr(module, name)
    calls = []

    def wrapper(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, out))
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, real)


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


# each kernel's largest |kernel - plain| on the inputs of its main-path
# calls, by the call's name: the kernels line reports the largest of
# these and the kernel phase's row
PATH_HOLDS = {"nll": {}, "lse": {}, "resample": {}}


def _path_plate_call(calls, n_chains, what):
    """(y, mu, sigma) of the last recorded plate-kernel call of a run
    (``recording(K, "_value_and_grad")``) at ``n_chains`` chains whose
    results are finite (a divergent trajectory's infinite values are
    held in the kernel phase's special cases instead)."""
    for args, out in reversed(calls):
        if args[1].numel() == n_chains and all(bool(torch.isfinite(o).all()) for o in out):
            return tuple(t.detach() for t in args)
    check(False, f"{what}: no finite plate-kernel call at {n_chains} chains among {len(calls)}")


def _hold_path_plate(K, y, mu, sigma, what):
    """``_hold_plate_f32`` on a main-path call's own inputs, recorded."""
    errs = _hold_plate_f32(K, y, mu, sigma, what)
    PATH_HOLDS["nll"][what] = max(e["kernel_vs_plain"] for e in errs.values())
    return {"rows": y.numel(), "chains": mu.numel(), **errs}


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
    # the one-chain long vector, the main path's shape, the two ranks' VI
    # slices (a rank's half of the rows) and an odd length
    for c, n in ((1, 1 << 24), MAIN_SHAPE, (MAIN_SHAPE[0], MAIN_SHAPE[1] // 2),
                 (3, (1 << 20) + 17)):
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

    n_chains, n_warmup, n_samples, L = 1024, 100, 100, 32  # bench_hmc: 200 + 200
    staged = ftt.stage(eight_schools_model("cuda"), device="cuda")
    cfg = ftt.HMCConfig(n_leapfrog=L, target_accept=0.9)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ftt.hmc_chain(1, n_samples=n_samples, n_warmup=n_warmup, config=cfg,
                        n_chains=n_chains, staged=staged)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    post = _eight_schools_posterior(res, n_chains, n_samples, "eight_schools mu")
    SINGLE_DEVICE_MS["eight_schools"] = 1e3 * wall / (n_warmup + n_samples)
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


def plate_arg_model(runs=None):
    """mu ~ N(0, 10), sigma ~ LogNormal(0, 1), the plate likelihood of its
    argument y through the CUDA kernel. ``runs[0]`` counts batched model
    evaluations."""
    import fugue_tpu_torch as ftt

    def plate(y):
        if runs is not None:
            runs[0] += 1
        mu = ftt.sample("mu", ftt.Normal(0.0, 10.0))
        sigma = ftt.sample("sigma", ftt.LogNormal(0.0, 1.0))
        ftt.factor(ftt.pnormal_loglik_sum(y, mu, sigma))

    return plate


def plate_model(y, runs=None):
    """``plate_arg_model`` over ``y``, a model of no argument."""
    plate = plate_arg_model(runs)
    return lambda: plate(y)


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


def _plate_run(run, pass_runs=False):
    """``run(staged, y)`` on the plate model over y = plate_data at
    MAIN_SHAPE's rows, timed, with the kernel's launch counts and the
    batched model runs set to 0 just before and read just after;
    ``pass_runs``: ``run(staged, y, runs)`` with the model's run counter."""
    import fugue_tpu_torch as ftt

    y = plate_data(MAIN_SHAPE[1])
    model_runs = [0]
    staged = ftt.stage(plate_model(y, model_runs), device="cuda")
    model_runs[0] = 0
    reset_launches()
    t0 = time.perf_counter()
    res = run(staged, y, model_runs) if pass_runs else run(staged, y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return y, res, wall, read_launches(), model_runs[0]


def phase_gaussian_plate():
    import fugue_tpu_torch as ftt

    n_chains, n_warmup, n_samples, L = MAIN_SHAPE[0], 100, 100, 16  # cut from 200 + 200
    n = MAIN_SHAPE[1]
    cfg = ftt.HMCConfig(n_leapfrog=L, jitter=0.5)
    y, res, wall, launches, model_runs = _plate_run(
        lambda staged, y: ftt.hmc_chain(3, n_samples=n_samples, n_warmup=n_warmup, config=cfg,
                                        n_chains=n_chains, staged=staged))
    post = _plate_posterior(res, y, n_chains, n_samples, "plate")
    n_transitions = n_warmup + n_samples
    SINGLE_DEVICE_MS["gaussian_plate"] = 1e3 * wall / n_transitions
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


def _smc_run(name, staged, n, seed, config, site="mu", phase="smc", mesh=None):
    """One ftt.adaptive_smc run (over ``mesh``'s ranks when given), timed,
    with the kernels' launch counts set to 0 just before and read just
    after; checks convergence, the weights and both kernels' launch counts,
    and reports ``site``'s posterior."""
    import fugue_tpu_torch as ftt

    reset_launches()
    t0 = time.perf_counter()
    res = ftt.adaptive_smc(seed, n, staged=staged, config=config, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
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
    """The tree build's costs: batched leaf evaluations per transition (the
    lock-step build's batch maximum, or the async drive's iterations) beside
    the mean over chains of its own leaves, their ratio, host syncs per
    transition and wall ms per batched leaf."""
    mean_leaves = res.n_leapfrogs / (n_chains * n_transitions)
    batched = res.lockstep_leaves / n_transitions
    return {"mean_tree_depth": res.tree_depths.double().mean().item(),
            "n_leapfrogs": res.n_leapfrogs, "lockstep_leaves": res.lockstep_leaves,
            "warmup_leaves": res.warmup_leaves,
            "leaves_per_transition_max": batched, "leaves_per_transition_mean": mean_leaves,
            "lockstep_over_mean": batched / mean_leaves,
            "host_syncs_per_transition": res.host_syncs / n_transitions,
            "ms_per_lockstep_leaf": 1e3 * wall / res.lockstep_leaves}


@contextlib.contextmanager
def runs_during(module, name, runs):
    """``module.name`` wrapped for the block: the batched model runs
    (``runs[0]``, the model's own counter) made inside its calls are added
    to the one-element list the block gets."""
    real = getattr(module, name)
    made = [0]

    def wrapper(*args, **kwargs):
        before = runs[0]
        out = real(*args, **kwargs)
        made[0] += runs[0] - before
        return out

    setattr(module, name, wrapper)
    try:
        yield made
    finally:
        setattr(module, name, real)


def counted_eight_schools(runs):
    """The eight-schools model with ``runs[0]`` counting its batched runs."""
    model = eight_schools_model("cuda")

    def counted():
        runs[0] += 1
        return model()

    return counted


def _nuts_eight_schools_run(loop, n_warmup, n_samples, n_chains=1024):
    """One eight-schools NUTS run (seed 5, max depth 8) through
    ``ftt.nuts_chain`` with ``NUTSConfig(loop=loop)``: its row (posterior,
    tree costs, grad-evals/s both ways, ESS/s, and one resumed transition
    traced: kernels and ms per batched leaf) after the phase's gates."""
    import fugue_tpu_torch as ftt

    runs = [0]
    staged = ftt.stage(counted_eight_schools(runs), device="cuda")
    cfg = ftt.NUTSConfig(loop=loop)
    runs[0] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ftt.nuts_chain(5, n_samples=n_samples, n_warmup=n_warmup, config=cfg,
                         n_chains=n_chains, staged=staged)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    model_runs = runs[0]
    what = f"nuts eight_schools ({loop or 'async'})"
    post = _eight_schools_posterior(res, n_chains, n_samples, what)
    n_transitions = n_warmup + n_samples
    # one resumed transition from the run's end, traced: its kernels over its
    # batched leaf evaluations and its start (the lock-step root, or the
    # async phase start)
    one, one_res = _one_transition(lambda: ftt.nuts_chain(
        6, staged=staged, n_samples=1, n_warmup=0, config=cfg, n_chains=n_chains, resume=res),
        reps=1)
    per_leaf = one_res.lockstep_leaves + 1
    row = {"phase": "nuts_eight_schools", "drive": loop or "async", "card": card_line(),
           "chains": n_chains, "warmup": n_warmup, "samples": n_samples, "max_depth": 8,
           "wall_s": wall, "transitions_per_s": n_chains * n_transitions / wall,
           # bench_nuts's count: every chain's own leapfrogs plus one root per
           # transition; and the batched model runs the drive made, times the
           # chains (the eight-schools replays of every chain at every leaf)
           "grad_evals_per_s": (res.n_leapfrogs + n_chains * n_transitions) / wall,
           "batched_model_runs": model_runs,
           "evaluated_grad_evals_per_s": n_chains * model_runs / wall,
           "ess_per_s": min(post["ess_mu"], post["ess_tau"]) / wall,
           "one_transition": {**one, "batched_leaves": one_res.lockstep_leaves,
                              "kernels_per_leaf": one["transition_kernels"] / per_leaf,
                              "device_us_per_leaf": 1e3 * one["transition_device_ms"] / per_leaf,
                              "ms_per_leaf": one["transition_ms"] / per_leaf},
           **post, **_nuts_tree_stats(res, n_chains, n_transitions, wall)}
    emit(row)
    rhat, div, z = post["split_rhat_mu"], post["divergence_rate"], post["mu_z"]
    check(rhat < 1.02, f"{what} split-R-hat(mu) {rhat} >= 1.02")
    check(div < 0.05, f"{what} divergence rate {div} >= 0.05")
    check(abs(z) < 5.0, f"{what} mu mean {post['mu_mean']} is {z:.2f} MC-SE "
          f"from {EIGHT_SCHOOLS_MU_MEAN}")
    return row


def phase_nuts_eight_schools():
    """bench_nuts: NUTSConfig() (the async drive) at 1,024 chains, 200 +
    200; beside it the lock-step build (loop="while") at 100 + 100."""
    rows = {"async": _nuts_eight_schools_run(None, 200, 200)}
    rows["while"] = _nuts_eight_schools_run("while", 100, 100)
    a, w = rows["async"], rows["while"]
    check(a["host_syncs_per_transition"] * 400 <= math.ceil(a["lockstep_leaves"] / 16),
          f"async nuts eight_schools: {a['host_syncs_per_transition'] * 400} host reads for "
          f"{a['lockstep_leaves']} iterations")
    emit({"phase": "nuts_eight_schools", "async_over_lockstep": {
        "ms_per_transition": (a["wall_s"] / 400) / (w["wall_s"] / 200),
        "batched_leaves_per_transition": (a["leaves_per_transition_max"]
                                          / w["leaves_per_transition_max"]),
        "kernels_per_leaf": (a["one_transition"]["kernels_per_leaf"]
                             / w["one_transition"]["kernels_per_leaf"]),
        "ess_per_s": a["ess_per_s"] / w["ess_per_s"]}})


def _nuts_plate_run(drive, what):
    """``drive(staged)``, a NUTS run on the plate model, through
    ``_plate_run`` with the kernel's calls recorded and the batched model
    runs of the step-size search and the constrain replay counted: (y,
    res, wall, launches, model_runs, those runs, the kernel held against
    its plain version on one of the run's own calls), after the gates of
    exactly one kernel call per iteration, phase start (3), search
    evaluation and constrain replay, and one host read per 16 iterations."""
    from fugue_tpu_torch.inference import hmc as hmc_mod
    from fugue_tpu_torch.inference import nuts as nuts_mod
    from fugue_tpu_torch.ops import kernels as K

    made = {}

    def run(staged, y, runs):
        # nuts_chain replays through nuts's name, sharded_nuts_chain through hmc's
        with runs_during(hmc_mod, "find_reasonable_epsilon", runs) as search, \
                runs_during(nuts_mod, "constrain_positions", runs) as replay, \
                runs_during(hmc_mod, "constrain_positions", runs) as replay_sharded:
            res = drive(staged)
        made.update(search=search[0], constrain=replay[0] + replay_sharded[0])
        return res

    with recording(K, "_value_and_grad") as calls:
        y, res, wall, launches, model_runs = _plate_run(run, pass_runs=True)
    hold = _hold_path_plate(K, *_path_plate_call(calls, MAIN_SHAPE[0], what), what)
    calls.clear()
    want = res.lockstep_leaves + 3 + made["search"] + made["constrain"]
    check(launches["nll"] == want,
          f"{what}: {launches['nll']} plate kernel calls, want {res.lockstep_leaves} "
          f"iterations + 3 + {made['search']} search + {made['constrain']} constrain = {want}")
    check(res.host_syncs == res.lockstep_leaves // 16,
          f"{what}: {res.host_syncs} host reads for {res.lockstep_leaves} iterations")
    return y, res, wall, launches, model_runs, made, hold


def phase_nuts_plate():
    """The async drive on the 2^20-row plate: the plate's gates, the kernel
    held against its plain version on one of the path's own calls, and
    exactly one kernel call per iteration, phase start, step-size search
    evaluation and constrain replay."""
    import fugue_tpu_torch as ftt

    n_chains, n_warmup, n_samples = MAIN_SHAPE[0], 100, 100  # cut from 200 + 200
    n = MAIN_SHAPE[1]
    y, res, wall, launches, model_runs, made, hold = _nuts_plate_run(
        lambda staged: ftt.nuts_chain(3, n_samples=n_samples, n_warmup=n_warmup,
                                      config=ftt.NUTSConfig(), n_chains=n_chains,
                                      staged=staged), "nuts_plate")
    post = _plate_posterior(res, y, n_chains, n_samples, "nuts plate")
    n_transitions = n_warmup + n_samples
    grad_evals = res.n_leapfrogs + n_chains * n_transitions  # each chain's own
    emit({"phase": "nuts_plate", "drive": "async", "card": card_line(), "chains": n_chains,
          "rows": n, "warmup": n_warmup, "samples": n_samples, "max_depth": 8, "wall_s": wall,
          "grad_evals_per_s": grad_evals / wall, "rows_per_s": grad_evals * n / wall,
          # every chain is evaluated at every iteration
          "rows_evaluated_per_s": n_chains * model_runs * n / wall,
          "ess_per_s": post["ess_min"] / wall, "batched_model_runs": model_runs,
          "search_runs": made["search"], "constrain_runs": made["constrain"],
          "launches": launches, "kernel_vs_plain_on_a_call_of_the_run": hold, **post,
          **_nuts_tree_stats(res, n_chains, n_transitions, wall)})
    _check_plate(post, launches, model_runs, "nuts plate")
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
    stats = _chees_stats(res, n_chains, n_transitions, wall)
    emit({"phase": "chees_eight_schools", "card": card_line(), "chains": n_chains,
          "warmup": n_warmup, "samples": n_samples, "target_accept": 0.8, "wall_s": wall,
          "ess_per_s": min(post["ess_mu"], post["ess_tau"]) / wall, **post, **stats,
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
    return stats["grad_evals_per_s"]


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


# torch.profiler drops the first kernel records of a session: usually 4 or
# 5, now and then hundreds or all (PERF.md, section 6). Each traced session is
# primed (utils.profiling.prime_session) and kept only when a priming
# kernel is in it; a session that kept none is traced again, up to
# TRACE_SESSIONS in all. TRACES counts them for the run's last lines.
TRACE_SESSIONS = 3
TRACES = {"sessions": 0, "rejected": 0}


def whole_session(trace_once, what):
    """``trace_once()``'s result, or None when its session kept no priming
    kernel: the first result that is not None, in TRACE_SESSIONS tries."""
    for _ in range(TRACE_SESSIONS):
        TRACES["sessions"] += 1
        out = trace_once()
        if out is not None:
            return out
        TRACES["rejected"] += 1
    raise SmokeFailure(f"{what}: no priming kernel left in {TRACE_SESSIONS} profiler sessions")


def traced_kernels(fn, cpu=False):
    """One ``fn()`` call under torch.profiler, from a primed, synchronised
    start to a synchronised end: (the profiler, fn's CUDA kernel events).
    ``cpu`` traces the host side too. A session that lost every priming
    kernel is traced again (``whole_session``); one that recorded no
    kernel of ``fn`` fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fugue_tpu_torch.utils.profiling import is_priming_kernel, prime_session

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])

    def once():
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            prime_session()
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        events = [e for e in kernels if not is_priming_kernel(e.name)]
        return (prof, events) if len(events) < len(kernels) else None

    prof, events = whole_session(once, "a traced call")
    check(bool(events), "the profiler recorded no CUDA kernel of the traced call")
    return prof, events


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


def vi_plate_run(staged, seed, optimize=None):
    """The vi_plate configuration: 64 MC samples at lr 0.05, VI_PLATE_SEGMENTS
    segments of VI_PLATE_ITERATIONS iterations chained through resume=,
    which restarts Adam's moments and schedule; segment i takes seed + i.
    ``optimize`` (default ftt.optimize_meanfield_vi) runs a segment."""
    import fugue_tpu_torch as ftt

    optimize = optimize or ftt.optimize_meanfield_vi
    cfg = ftt.VIConfig(n_iterations=VI_PLATE_ITERATIONS, n_samples=VI_PLATE_MC, learning_rate=0.05,
                       plateau_window=10**9, check_every=VI_PLATE_ITERATIONS)
    res = None
    for i in range(VI_PLATE_SEGMENTS):
        res = optimize(seed + i, staged=staged, config=cfg, resume=res)
    return res


def phase_vi_plate():
    """Mean-field VI on the 2^20-row plate: 64 MC samples per iteration, so
    each iteration is one plate-kernel call at (64, 2^20)."""
    import fugue_tpu_torch as ftt

    n_iter = VI_PLATE_SEGMENTS * VI_PLATE_ITERATIONS
    y_np = plate_numpy_data(MAIN_SHAPE[1])
    y = torch.as_tensor(y_np, dtype=torch.float32, device="cuda")
    model_runs = [0]
    staged = ftt.stage(plate_model(y, model_runs), device="cuda")
    model_runs[0] = 0
    reset_launches()
    res, wall, syncs = _timed_syncs(lambda: vi_plate_run(staged, 700))
    launches = read_launches()
    runs = model_runs[0]
    stats = vi_plate_stats(res.params, y_np)
    SINGLE_DEVICE_MS["vi_plate"] = 1e3 * wall / n_iter
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
        reset_launches()
        res, wall, syncs = _timed_syncs(lambda: fn(31, **kw))
        launches[name] = read_launches()
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


def logistic_map(staged, x, y, row, what):
    """The float64 Newton point and posterior sds of the logistic model on
    (x, y), and ftt.map_estimate by L-BFGS (120 iterations) gated within
    0.05 posterior sds of it; their costs go into ``row``. (sds, MAP)."""
    import fugue_tpu_torch as ftt

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
    check(map_z < 0.05, f"{what}: MAP {map_z} posterior sds from the Newton point")
    return sd, m


def logistic_stats(ws, divergences, w_true, sd):
    """bench.py's _logistic_stats on (C, S, D) draws of w: the max
    split-R-hat and min multichain ESS over w[::16], the mean |w_bar -
    w_true| in posterior sds (``sd``, the Newton point's), the divergence
    rate. ESS is capped at C * S draws (both packages cap it)."""
    from fugue_tpu_torch.inference.mcmc_utils import ess_multichain, split_r_hat

    ws = ws.double()
    c, s = ws.shape[:2]
    sub = ws[:, :, ::16].permute(2, 0, 1)  # (D / 16, C, S)
    ess = ess_multichain(sub)
    return {"split_rhat_max": split_r_hat(sub).max().item(),
            "divergence_rate": divergences.float().mean().item(),
            "mean_abs_err_in_sd": ((ws.mean(dim=(0, 1)) - w_true.double()).abs()
                                   / sd).mean().item(),
            "ess_min": ess.min().item(), "ess_median": ess.median().item(),
            "ess_min_at_cap": bool(ess.min().item() >= c * s)}


def check_logistic_stats(stats, what):
    """The logistic rows' gates: max split-R-hat < 1.01, divergences < 1%,
    mean coefficient error in [0.70, 0.90] posterior sds (E|Z| = 0.798 when
    the truth is a posterior draw)."""
    rhat, div, err = (stats[k] for k in ("split_rhat_max", "divergence_rate",
                                         "mean_abs_err_in_sd"))
    check(rhat < 1.01, f"{what}: max split-R-hat over w[::16] {rhat} >= 1.01")
    check(div < 0.01, f"{what}: divergence rate {div} >= 1%")
    check(0.70 <= err <= 0.90, f"{what}: mean |w_bar - w_true| / sd {err} "
          "outside [0.70, 0.90] (E|Z| = 0.798)")


def _gemm_events(events):
    return [e for e in events if any(k in e.name.lower() for k in GEMM_KERNEL)]


def _one_transition(one_call, reps=3):
    """One ``one_call()`` (a one-transition drive from a run's end) timed and
    traced: (its row, the traced call's result). The row has the median of
    ``reps`` CUDA-event timings, the traced call's kernels and device time,
    and the idle share, device time over that wall."""
    one_call()
    t_ms = median_ms(one_call, reps=reps)
    out = []
    _, events = traced_kernels(lambda: out.append(one_call()))
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    return {"transition_ms": t_ms, "transition_kernels": len(events),
            "transition_device_ms": busy_ms, "idle_share": 1.0 - busy_ms / t_ms}, out[-1]


def phase_logistic_scale():
    """bench_scale_logistic at full width: the split-bf16 products, a MAP
    warm start by L-BFGS and 256 HMC chains, D = 1024, N = 100,000."""
    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.ops import linalg

    d, n, c = LOGISTIC_SHAPE
    L, n_warmup, n_samples = 16, 100, 100  # bench.py's 300 + 128, from the MAP
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

    sd, m = logistic_map(staged, x, y, row, "logistic_scale")

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
    stats = logistic_stats(res.samples["w"], res.divergences, w_true, sd)
    grad_evals = c * (n_warmup + n_samples) * (L + 1)
    one, _ = _one_transition(lambda: ftt.hmc_chain(3, staged=staged, n_samples=1, config=hcfg,
                                                   n_chains=c, resume=res))
    # ESS per gradient of each chain, as bench.py's scale rows count it
    ess_per_grad = stats["ess_min"] / (grad_evals / c)
    row.update(warmup=n_warmup, samples=n_samples, n_leapfrog=L, hmc_wall_s=wall,
               grad_evals_per_s=grad_evals / wall, **stats, ess_per_grad=ess_per_grad,
               step_size=res.step_size, gemm_calls=gemms, model_runs=model_runs, **one,
               dtype=str(res.samples["w"].dtype))
    emit(row)
    check(gemms <= 3 * model_runs, f"logistic_scale: {gemms} GEMMs in {model_runs} model runs")
    check_logistic_stats(stats, "logistic_scale")
    # scale_nuts samples the same target from the same warm start
    return {"x": x, "y": y, "w_true": w_true, "staged": staged, "sd": sd, "map_z": m.z,
            "hmc_ess_per_grad": ess_per_grad}


# ---------------------------------------------------------------------------
# bench.py's scale rows: NUTS and ChEES-SNAPER on the d = 1024 logistic
# targets, dense-mass HMC at d = 256, the 128-group plate. Each runs at
# bench.py's width; depth (warmup, samples) is cut to fit the smoke's time.
# ---------------------------------------------------------------------------

SCALE_DEPTH = {  # (warmup, samples); bench.py's in the comment
    "scale_nuts": (60, 60),  # 300 + 128 (100 + 100 before the async drive, PERF.md §4)
    "scale_chees": (300, 256),  # 300 + 256
    # the fixed-L16 HMC beside it: ESS per gradient is a rate, so a shorter
    # drive with a larger sampling share (1/2 against 256/556) is fair to HMC
    "scale_chees_hmc": (100, 100),  # 300 + 256
    "scale_densemass": (200, 200),  # 600 + 1024, from the MAP (bench: the prior's init)
    "scale_plate": (200, 200),  # 400 + 256
}
DENSEMASS_SHAPE = (256, 8192, 128)  # bench_scale_densemass's d, N and chains
DENSEMASS_JITTER = 0.1  # the warm start's spread: the posterior sds are 0.13-0.15
GROUP_PLATE_SHAPE = (128, 8192, 64)  # bench_scale_plate's groups, rows and chains


def correlated_logistic_data(d, n, seed=107, device="cuda"):
    """bench_scale_chees's correlated design, made on ``device``: Z =
    N(0, 1)/sqrt(D) in bf16, A = Q diag(s) Q^T with Q from the QR of a D x D
    normal matrix and s = exp(linspace(log 0.2, log 3, D)), X = Z A as one
    bf16 product with float32 accumulation rounded to bf16; w_true ~ N(0, 1)
    and y ~ Bernoulli(sigmoid(X w_true)), the logits from bf16 w_true."""
    from fugue_tpu_torch.ops.linalg import matmul_bf16

    g = torch.Generator(device=device).manual_seed(seed)
    z = (torch.randn((n, d), generator=g, device=device) / math.sqrt(d)).to(torch.bfloat16)
    q, _ = torch.linalg.qr(torch.randn((d, d), generator=g, device=device))
    s = torch.exp(torch.linspace(math.log(0.2), math.log(3.0), d, device=device))
    a = (q * s) @ q.T
    x = matmul_bf16(z, a.to(torch.bfloat16)).to(torch.bfloat16)
    del z
    w_true = torch.randn(d, generator=g, device=device)
    logits = matmul_bf16(x, w_true.to(torch.bfloat16))
    y = torch.rand(n, generator=g, device=device) < torch.sigmoid(logits)
    return x, y, w_true


def densemass_data(d, n, seed=98, device="cuda", dtype=torch.float32):
    """bench_scale_densemass's target: Sigma_ij = exp(-|i - j|/32) with its
    Cholesky factor (numpy float64, then ``dtype``), X ~ N(0, 1)/sqrt(d),
    w_true = chol(Sigma) N(0, I), y = X w_true + N(0, 1). (x, y, w_true,
    scale_tril)."""
    i = np.arange(d)
    sigma = np.exp(-np.abs(i[:, None] - i[None, :]) / 32.0)
    tril = torch.as_tensor(np.linalg.cholesky(sigma), dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=device, dtype=dtype) / math.sqrt(d)
    w_true = tril @ torch.randn(d, generator=g, device=device, dtype=dtype)
    y = x @ w_true + torch.randn(n, generator=g, device=device, dtype=dtype)
    return x, y, w_true, tril


def densemass_model(x, y, tril):
    """w ~ MultivariateNormal(0, scale_tril), y ~ Normal(X w, 1)."""
    import fugue_tpu_torch as ftt

    zeros = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)

    def dense():
        w = ftt.sample("w", ftt.MultivariateNormal(zeros, scale_tril=tril))
        ftt.observe("y", ftt.Normal(x @ w, 1.0), y)

    return dense


def densemass_posterior(x, y, tril):
    """The closed-form posterior in float64 on x's device: precision
    Lambda = Sigma^-1 + X^T X, covariance Lambda^-1, mean Lambda^-1 X^T y.
    (mean, covariance)."""
    x64, y64 = x.double(), y.double()
    lam = torch.cholesky_inverse(tril.double()) + x64.T @ x64
    chol = torch.linalg.cholesky(lam)
    return torch.cholesky_solve((x64.T @ y64)[:, None], chol)[:, 0], torch.cholesky_inverse(chol)


def group_plate_data(groups, rows, seed=97, device="cuda", dtype=torch.float32):
    """bench_scale_plate's data: theta_true ~ N(0, 1) per group, Y =
    theta_true[:, None] + N(0, 1), shape (groups, rows)."""
    g = torch.Generator(device=device).manual_seed(seed)
    theta = torch.randn(groups, generator=g, device=device, dtype=dtype)
    return theta[:, None] + torch.randn((groups, rows), generator=g, device=device, dtype=dtype)


def group_plate_model(y):
    """mu ~ N(0, 1), theta ~ N(mu, 1) per group, one vectorized observe of
    Y ~ N(theta[:, None], 1)."""
    import fugue_tpu_torch as ftt

    def group_plate():
        mu = ftt.sample("mu", ftt.Normal(0.0, 1.0))
        theta = ftt.sample("theta", ftt.Normal(mu, 1.0), sample_shape=(y.shape[0],))
        ftt.observe("Y", ftt.Normal(theta[:, None], 1.0), y)

    return group_plate


def group_plate_posterior(y):
    """The exact posterior of the group plate in float64: with ybar_g | mu
    ~ N(mu, (n + 1)/n), mu | Y ~ N(m, v), v = 1/(1 + G n/(n + 1)), m =
    v n/(n + 1) sum_g ybar_g, and theta_g | Y has mean (n ybar_g + m)/(n + 1)
    and variance 1/(n + 1) + v/(n + 1)^2. (mean, sd) of [mu, theta_1..G]."""
    groups, n = y.shape
    ybar = y.double().mean(dim=1)
    v = 1.0 / (1.0 + groups * n / (n + 1.0))
    m = v * n / (n + 1.0) * ybar.sum()
    mean = torch.cat([m[None], (n * ybar + m) / (n + 1.0)])
    var = torch.cat([torch.full((1,), v, dtype=torch.float64, device=y.device),
                     torch.full((groups,), 1.0 / (n + 1.0) + v / (n + 1.0) ** 2,
                                dtype=torch.float64, device=y.device)])
    return mean, var.sqrt()


def closed_form_stats(draws, mean, sd):
    """(C, S, k) draws against a closed-form posterior's (k,) means and sds,
    coordinate by coordinate: the mean's offset in Monte-Carlo standard
    errors (sd / sqrt(ESS), the coordinate's multichain ESS, capped at C * S
    by design), the draws' sd over the closed form's and that ratio's offset
    from 1 in its standard errors (1 / sqrt(2 ESS) from the ESS of the
    squared deviations), and split-R-hat. Tensors of shape (k,)."""
    from fugue_tpu_torch.inference.mcmc_utils import ess_multichain, split_r_hat

    x = draws.double().permute(2, 0, 1)  # (k, C, S)
    ess = ess_multichain(x)
    dev2 = (x - mean[:, None, None]) ** 2
    ratio = dev2.mean(dim=(1, 2)).sqrt() / sd
    return {"mean_z": (x.mean(dim=(1, 2)) - mean) / (sd / ess.sqrt()), "ess": ess,
            "sd_ratio": ratio, "sd_ratio_z": (ratio - 1.0) * (2.0 * ess_multichain(dev2)).sqrt(),
            "split_rhat": split_r_hat(x)}


def densemass_stats(draws, divergences, mean, cov):
    """Dense-mass HMC's (C, S, d) draws against the closed form
    (``closed_form_stats``), reduced to the row's worst cases."""
    st = closed_form_stats(draws, mean, torch.diagonal(cov).sqrt())
    return {"max_abs_mean_z": st["mean_z"].abs().max().item(),
            "sd_ratio_min": st["sd_ratio"].min().item(),
            "sd_ratio_max": st["sd_ratio"].max().item(),
            "max_abs_sd_ratio_z": st["sd_ratio_z"].abs().max().item(),
            "ess_min": st["ess"].min().item(), "split_rhat_max": st["split_rhat"].max().item(),
            "divergence_rate": divergences.float().mean().item()}


def check_densemass(row, what):
    """Every coordinate's mean within 5 MC-SE of the closed form, every
    marginal sd ratio within 5 of its standard errors, max split-R-hat <
    1.01."""
    check(row["max_abs_mean_z"] < 5.0, f"{what}: a coordinate's mean is "
          f"{row['max_abs_mean_z']:.2f} MC-SE from the closed form")
    check(row["max_abs_sd_ratio_z"] < 5.0, f"{what}: a marginal sd ratio is "
          f"{row['max_abs_sd_ratio_z']:.2f} standard errors from 1 (range "
          f"{row['sd_ratio_min']:.4f}-{row['sd_ratio_max']:.4f})")
    check(row["split_rhat_max"] < 1.01, f"{what}: max split-R-hat {row['split_rhat_max']} >= 1.01")


def group_plate_stats(mu, theta, divergences, mean, sd):
    """The group plate's draws of mu (C, S) and theta (C, S, G) against the
    exact posterior (``closed_form_stats``), reduced to the row's worst
    cases."""
    st = closed_form_stats(torch.cat([mu[..., None], theta], dim=-1), mean, sd)
    z, rhat = st["mean_z"], st["split_rhat"]
    return {"mu_z": z[0].item(), "max_abs_group_z": z[1:].abs().max().item(),
            "max_split_rhat_groups": rhat[1:].max().item(), "split_rhat_mu": rhat[0].item(),
            "ess_min": st["ess"].min().item(), "sd_ratio_min": st["sd_ratio"].min().item(),
            "sd_ratio_max": st["sd_ratio"].max().item(),
            "divergence_rate": divergences.float().mean().item()}


def check_group_plate(row, what):
    """mu and every group's theta within 5 MC-SE of the exact posterior, max
    split-R-hat over all groups < 1.01."""
    check(abs(row["mu_z"]) < 5.0, f"{what}: mu's mean is {row['mu_z']:.2f} MC-SE from exact")
    check(row["max_abs_group_z"] < 5.0, f"{what}: a group's theta mean is "
          f"{row['max_abs_group_z']:.2f} MC-SE from exact")
    check(row["max_split_rhat_groups"] < 1.01,
          f"{what}: max split-R-hat over the groups {row['max_split_rhat_groups']} >= 1.01")


def phase_scale_nuts(logistic=None):
    """bench_scale_nuts: NUTS (max depth 6) on logistic_scale's d = 1024
    target from its MAP, 256 chains; ``logistic`` is that phase's handover
    (target, Newton sds, MAP, HMC ESS per gradient), made here when it did
    not run."""
    import fugue_tpu_torch as ftt

    d, n, c = LOGISTIC_SHAPE
    n_warmup, n_samples = SCALE_DEPTH["scale_nuts"]
    row = {"phase": "scale_nuts", "card": card_line(), "D": d, "N": n, "chains": c,
           "warmup": n_warmup, "samples": n_samples, "max_depth": 6}
    if logistic is None:
        x, y, w_true = logistic_data(d, n)
        staged = ftt.stage(logistic_model(x, y), device="cuda")
        sd, m = logistic_map(staged, x, y, row, "scale_nuts")
        logistic = {"staged": staged, "w_true": w_true, "sd": sd, "map_z": m.z,
                    "hmc_ess_per_grad": None}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ftt.nuts_chain(41, staged=logistic["staged"], n_samples=n_samples,
                         n_warmup=n_warmup, config=ftt.NUTSConfig(max_depth=6), n_chains=c,
                         init_position=logistic["map_z"], init_jitter=0.05)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = logistic_stats(res.samples["w"], res.divergences, logistic["w_true"], logistic["sd"])
    n_transitions = n_warmup + n_samples
    # exact: every chain's own leapfrogs plus one root gradient per transition
    grad_evals = res.n_leapfrogs + c * n_transitions
    one, one_res = _one_transition(lambda: ftt.nuts_chain(
        3, staged=logistic["staged"], n_samples=1, config=ftt.NUTSConfig(max_depth=6),
        n_chains=c, resume=res))
    # per lock-step leaf of that transition (its root gradient included)
    per_leaf = one_res.lockstep_leaves + 1
    row.update(one_transition={**one, "lockstep_leaves": one_res.lockstep_leaves,
                               "kernels_per_leaf": one["transition_kernels"] / per_leaf,
                               "device_us_per_leaf": 1e3 * one["transition_device_ms"] / per_leaf})
    # the lock-step build's factor on one transition from the same state,
    # beside the async drive's ratio of the run
    lock, lock_res = _one_transition(lambda: ftt.nuts_chain(
        3, staged=logistic["staged"], n_samples=1, n_warmup=0,
        config=ftt.NUTSConfig(max_depth=6, loop="while"), n_chains=c, resume=res), reps=1)
    row.update(lockstep_one_transition={
        **lock, "lockstep_leaves": lock_res.lockstep_leaves,
        "lockstep_over_mean": lock_res.lockstep_leaves / (lock_res.n_leapfrogs / c),
        "ms_per_leaf": lock["transition_ms"] / (lock_res.lockstep_leaves + 1)})
    row.update(wall_s=wall, grad_evals_per_s=grad_evals / wall,
               transitions_per_s=c * n_transitions / wall, step_size=res.step_size,
               **_nuts_tree_stats(res, c, n_transitions, wall),
               host_syncs_per_lockstep_leaf=res.host_syncs / res.lockstep_leaves, **stats,
               ess_per_grad=stats["ess_min"] / (grad_evals / c),
               hmc_ess_per_grad=logistic["hmc_ess_per_grad"])
    emit(row)
    check_logistic_stats(stats, "scale_nuts")


def phase_scale_chees():
    """bench_scale_chees: ChEES (SNAPER) and fixed-L16 HMC on the correlated
    d = 1024 logistic target from its MAP, 256 chains each; ChEES's ESS per
    gradient at least HMC's."""
    import fugue_tpu_torch as ftt

    torch.cuda.empty_cache()  # logistic_scale's design and intermediates are gone
    d, n, c = LOGISTIC_SHAPE
    L = 16
    n_warmup, n_samples = SCALE_DEPTH["scale_chees"]
    n_transitions = n_warmup + n_samples
    row = {"phase": "scale_chees", "card": card_line(), "D": d, "N": n, "chains": c,
           "warmup": n_warmup, "samples": n_samples, "criterion": "snaper"}
    t0 = time.perf_counter()
    x, y, w_true = correlated_logistic_data(d, n)
    torch.cuda.synchronize()
    row["data_s"] = time.perf_counter() - t0
    staged = ftt.stage(logistic_model(x, y), device="cuda")
    sd, m = logistic_map(staged, x, y, row, "scale_chees")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ftt.chees_chain(47, staged=staged, n_samples=n_samples, n_warmup=n_warmup,
                          config=ftt.ChEESConfig(criterion="snaper"), n_chains=c,
                          init_position=m.z, init_jitter=0.05)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = logistic_stats(res.samples["w"], res.divergences, w_true, sd)
    ess_per_grad = stats["ess_min"] / (res.n_leapfrogs / c + n_transitions)
    one, one_res = _one_transition(lambda: ftt.chees_chain(
        3, staged=staged, n_samples=1, config=ftt.ChEESConfig(criterion="snaper"), n_chains=c,
        resume=res))
    per_grad = one_res.n_leapfrogs // c + 1  # its L leapfrogs and the start's gradient
    row.update(wall_s=wall, **_chees_stats(res, c, n_transitions, wall), **stats,
               ess_per_grad=ess_per_grad,
               one_transition={**one, "batched_gradients": per_grad,
                               "kernels_per_gradient": one["transition_kernels"] / per_grad,
                               "device_us_per_gradient": 1e3 * one["transition_device_ms"]
                               / per_grad})

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h_warmup, h_samples = SCALE_DEPTH["scale_chees_hmc"]
    h_grads = (h_warmup + h_samples) * (L + 1)  # batched gradients, each chain's count
    hres = ftt.hmc_chain(48, staged=staged, n_samples=h_samples, n_warmup=h_warmup,
                         config=ftt.HMCConfig(n_leapfrog=L, target_accept=0.8), n_chains=c,
                         init_position=m.z, init_jitter=0.05)
    torch.cuda.synchronize()
    h_wall = time.perf_counter() - t0
    h_stats = logistic_stats(hres.samples["w"], hres.divergences, w_true, sd)
    h_ess_per_grad = h_stats["ess_min"] / h_grads
    row.update(hmc_l16={"warmup": h_warmup, "samples": h_samples, "wall_s": h_wall,
                        "step_size": hres.step_size, "grad_evals_per_s": c * h_grads / h_wall,
                        "ms_per_batched_gradient": 1e3 * h_wall / h_grads,
                        **h_stats, "ess_per_grad": h_ess_per_grad},
               ess_per_grad_over_hmc_l16=ess_per_grad / h_ess_per_grad)
    emit(row)
    check_logistic_stats(stats, "scale_chees")
    check(ess_per_grad >= h_ess_per_grad, f"scale_chees: ChEES ESS per gradient "
          f"{ess_per_grad} below fixed-L16 HMC's {h_ess_per_grad}")


def phase_scale_densemass():
    """bench_scale_densemass: dense-mass HMC (L = 32, target 0.85) on the
    d = 256 correlated linear model, 128 chains, against its closed form."""
    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.inference import hmc

    d, n, c = DENSEMASS_SHAPE
    L = 32
    n_warmup, n_samples = SCALE_DEPTH["scale_densemass"]
    n_transitions = n_warmup + n_samples
    x, y, _, tril = densemass_data(d, n)
    mean, cov = densemass_posterior(x, y, tril)
    sd = torch.diagonal(cov).sqrt()
    staged = ftt.stage(densemass_model(x, y, tril), device="cuda")
    row = {"phase": "scale_densemass", "card": card_line(), "d": d, "N": n, "chains": c,
           "n_leapfrog": L, "warmup": n_warmup, "samples": n_samples, "mass": "dense",
           "step_jitter": 0.5, "init": f"MAP + {DENSEMASS_JITTER} jitter"}

    # the batched gradient: no host read, its kernels and device time
    grad_u = torch.func.vmap(torch.func.grad_and_value(staged.potential))
    q = mean.float() + 0.1 * torch.randn((c, d), device="cuda")
    grad_u(q)
    syncs = _host_syncs(lambda: grad_u(q))
    _, events = traced_kernels(lambda: grad_u(q))
    row.update(potential_host_syncs=syncs, kernels_per_gradient=len(events),
               device_us_per_gradient=sum(e.time_range.elapsed_us() for e in events),
               ms_per_gradient=median_ms(lambda: grad_u(q), reps=10))
    check(syncs == 0, f"scale_densemass: {syncs} host syncs in a batched gradient")

    # the warm start of the logistic rows: from the prior's init (bench.py's)
    # the first window's covariance takes in the chains' way in, which the
    # mass adaptation then carries (PERF.md §6); the MAP is the
    # Gaussian posterior's mean, checked against the closed form
    cfg_map = ftt.MAPConfig(n_iterations=120, optimizer="lbfgs", n_restarts=1)
    m, map_wall, _ = _timed_syncs(lambda: ftt.map_estimate(0, staged=staged, config=cfg_map))
    map_z = ((m.z.double() - mean) / sd).abs().max().item()
    row.update(map_wall_s=map_wall, map_max_sd_from_mean=map_z)
    check(map_z < 0.05, f"scale_densemass: MAP {map_z} posterior sds from the closed form")
    # step jitter 0.5, as bench_scale_plate's: with a well adapted Sigma every
    # direction turns at about the same rate, and epsilon * 32 at the default
    # 0.2 lands near two turns (ESS 0.29 of a draw, R-hat 1.014 at 200 + 200;
    # PERF.md §6)
    cfg = ftt.HMCConfig(n_leapfrog=L, mass="dense", target_accept=0.85, jitter=0.5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ftt.hmc_chain(22, staged=staged, n_samples=n_samples, n_warmup=n_warmup, config=cfg,
                        n_chains=c, init_position=m.z, init_jitter=DENSEMASS_JITTER)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = densemass_stats(res.samples["w"], res.divergences, mean, cov)

    # the dense algebra of a transition: one momentum draw (cholesky_ex of
    # Sigma and a triangular solve, on every draw) and L + 2 products Sigma p
    # (one per leapfrog position update, two kinetic energies)
    sigma = res.inv_mass
    z = torch.randn((c, d), device="cuda")
    _, draw_events = traced_kernels(lambda: hmc.momentum_from_normal(sigma, z))
    _, vel_events = traced_kernels(lambda: hmc.mass_velocity(sigma, z))
    draw_us = sum(e.time_range.elapsed_us() for e in draw_events)
    vel_us = sum(e.time_range.elapsed_us() for e in vel_events)
    one, _ = _one_transition(lambda: ftt.hmc_chain(3, staged=staged, n_samples=1, config=cfg,
                                                   n_chains=c, resume=res))
    row.update(wall_s=wall, grad_evals_per_s=c * n_transitions * (L + 1) / wall,
               ms_per_transition=1e3 * wall / n_transitions, step_size=res.step_size,
               **stats, sigma_condition_number=torch.linalg.cond(sigma.double()).item(),
               momentum_draw_host_syncs=_host_syncs(lambda: hmc.momentum_from_normal(sigma, z)),
               momentum_draw_kernels=len(draw_events), momentum_draw_device_us=draw_us,
               mass_velocity_device_us=vel_us,
               dense_algebra_device_us_per_transition=draw_us + (L + 2) * vel_us, **one)
    emit(row)
    check_densemass(row, "scale_densemass")


def phase_scale_plate():
    """bench_scale_plate: 128 groups x 8,192 rows in one vectorized observe,
    64 chains, L = 16, jitter 0.5, from the conjugate warm start; every
    group against its exact posterior."""
    import fugue_tpu_torch as ftt

    groups, rows, c = GROUP_PLATE_SHAPE
    L = 16
    n_warmup, n_samples = SCALE_DEPTH["scale_plate"]
    n_transitions = n_warmup + n_samples
    y = group_plate_data(groups, rows)
    mean, sd = group_plate_posterior(y)
    staged = ftt.stage(group_plate_model(y), device="cuda")
    row = {"phase": "scale_plate", "card": card_line(), "groups": groups, "rows": rows,
           "chains": c, "n_leapfrog": L, "warmup": n_warmup, "samples": n_samples}

    grad_u = torch.func.vmap(torch.func.grad_and_value(staged.potential))
    q = mean.float().expand(c, -1).contiguous()
    grad_u(q)
    _, events = traced_kernels(lambda: grad_u(q))
    row.update(potential_host_syncs=_host_syncs(lambda: grad_u(q)),
               kernels_per_gradient=len(events),
               device_us_per_gradient=sum(e.time_range.elapsed_us() for e in events),
               ms_per_gradient=median_ms(lambda: grad_u(q), reps=10))

    # bench.py's warm start: mu = 0, theta_g = ybar_g n/(n + 1)
    ybar = y.double().mean(dim=1)
    z0 = torch.cat([torch.zeros(1, device="cuda"), (ybar * rows / (rows + 1.0)).float()])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = ftt.HMCConfig(n_leapfrog=L, jitter=0.5)
    res = ftt.hmc_chain(23, staged=staged, n_samples=n_samples, n_warmup=n_warmup, config=cfg,
                        n_chains=c, init_position=z0, init_jitter=0.01)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    stats = group_plate_stats(res.samples["mu"], res.samples["theta"], res.divergences, mean, sd)
    n_grad = n_transitions * (L + 1)
    one, _ = _one_transition(lambda: ftt.hmc_chain(3, staged=staged, n_samples=1, config=cfg,
                                                   n_chains=c, resume=res))
    row.update(wall_s=wall, obs_grad_rows_per_s=c * n_grad * groups * rows / wall,
               ms_per_batched_gradient=1e3 * wall / n_grad, step_size=res.step_size,
               max_memory_allocated_bytes=peak, **stats, **one)
    emit(row)
    check_group_plate(row, "scale_plate")


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
    n_chains, n_warmup, n_samples, L = 1024, 60, 60, 16  # cut from 200 + 200 (PERF.md §4)
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

    n_chains, n_warmup, n_samples = 1024, 100, 200  # cut from 200 + 300 (PERF.md §4)
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

    n_chains, n_warmup, n_samples = 1024, 150, 300  # cut from 300 + 1000 (PERF.md §4)
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

    n_chains, n_warmup, n_samples = 1024, 150, 300  # cut from 200 + 400 (PERF.md §4)
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

    row = {"phase": "validation_conjugate", "card": card_line()}
    launches = {"lse": 0, "resample": 0}
    # the smc adapter's adaptive_smc results, recorded as they return
    with recording(smc_mod, "adaptive_smc") as calls:
        for sampler in ("hmc", "mh", "smc"):
            cut = dict(n_samples=60, n_warmup=60) if sampler == "hmc" else {}
            for name, fn, cfg in (
                    ("normal", ftt.validate_conjugate_normal,
                     ftt.ConjugateNormalConfig(n_chains=256, **cut)),
                    ("beta_bernoulli", ftt.validate_beta_bernoulli,
                     ftt.ConjugateBetaBernoulliConfig(n_chains=256, **cut))):
                reset_launches()
                r, wall, _ = _timed_syncs(lambda: fn(0, sampler, cfg, device="cuda"))
                got = read_launches()
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
                res = calls[-1][1]
                s = res.n_stages
                row[f"{sampler}_{name}"].update(particles=res.log_weights.numel(), stages=s)
                # adaptive_smc's 4 * stages + 3 logsumexp and stages - 1
                # resamples, and the adapter's terminal resample
                check(got["lse"] == 4 * s + 3 and got["resample"] == s,
                      f"validation_conjugate smc {name}: launches {got}, want {4 * s + 3} "
                      f"logsumexp, {s} resample for {s} stages")
                _add_launches(launches, got)
    emit(row)
    # both kernels against their plain versions on each smc run's own
    # 384,000 log-weights (these launches come after the counts were read)
    kernel_rows = {}
    runs = [res for _, res in calls]
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
    # the control's wrong prior sits 10 of its sds off: 50 warmup transitions
    # and unthinned draws reject it as surely as the run's settings (cut for
    # the scale rows' time)
    control = {**kw, "n_warmup": 50, "thin": 1}
    bad, bad_wall, _ = _timed_syncs(lambda: ftt.sbc(1, model, {"y": np.zeros(8)},
                                                    inference_model_fn=wrong, **control))
    row = {"phase": "sbc_normal", "card": card_line(), "datasets": 96, "posterior_draws": 63,
           "thin": 4, "warmup": 200, "wall_s": wall, "host_syncs": syncs,
           "p_values": r.p_values.tolist(), "chi2": r.chi2.tolist(), "passed": r.passed,
           "control_warmup": 50, "control_thin": 1, "control_wall_s": bad_wall,
           "control_p_values": bad.p_values.tolist(),
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


# ---------------------------------------------------------------------------
# the serving surface: the DSL, the sessions and the JSON-RPC service
# ---------------------------------------------------------------------------

COIN_DSL = ('let p <- sample("p", beta(2.0, 2.0));'
            'for i in 0..27 { observe(("y", i), bernoulli(p), flips[i]); }'
            'return p;')
COIN_FLIPS = [1] * 18 + [0] * 9  # coin_model's data: 18 heads of 27
EIGHT_SCHOOLS_DSL = """
let mu <- sample("mu", normal(0.0, 5.0));
let tau <- sample("tau", lognormal(0.5, 1.0));
for j in 0..8 {
    let theta_raw <- sample(("theta_raw", j), normal(0.0, 1.0));
    observe(("y", j), normal(mu + tau * theta_raw, sigma[j]), y[j]);
}
return mu
"""
EIGHT_SCHOOLS_Y = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
EIGHT_SCHOOLS_SIGMA = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]


class Rpc:
    """``serve(port=0, service=FugueService(), block=False)`` in this process,
    its ``serve_forever`` in a thread; ``rpc(method, **params)`` POSTs one
    JSON-RPC request over urllib and returns its result (an error raises).
    A context manager: leaving it shuts the server down and joins the
    thread."""

    def __enter__(self):
        import threading

        from fugue_tpu_torch.serve import FugueService, serve

        self.service = FugueService()
        self.httpd = serve(port=0, service=self.service, block=False)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)
        check(not self.thread.is_alive(), "the JSON-RPC server thread did not stop")

    def post(self, method, **params):
        """The whole response: {"result"} or {"error"}."""
        import urllib.request

        body = json.dumps({"method": method, "params": params, "id": 1}).encode()
        req = urllib.request.Request(self.url, data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read())

    def __call__(self, method, **params):
        out = self.post(method, **params)
        check("error" not in out, f"{method}: {out.get('error')}")
        return out["result"]

    def device_time(self, method, **params):
        """({CUDA kernels, their device µs, untraced wall ms, idle share},
        the traced request's result) of one request: the request traced once
        (``traced_kernels``; CUPTI sees the handler thread's launches), then
        timed once without the profiler."""
        result = {}
        _, ks = traced_kernels(lambda: result.update(self(method, **params)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self(method, **params)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        device_us = sum(e.time_range.elapsed_us() for e in ks)
        return {"kernels": len(ks), "device_us": device_us, "wall_ms": wall_ms,
                "idle_share": 1.0 - 1e-3 * device_us / wall_ms}, result

    def host_reads(self, method, **params) -> int:
        """The device-to-host syncs of one request, made through the service
        in this thread (``_host_syncs``; the HTTP layer runs no CUDA)."""
        out = {}
        syncs = _host_syncs(lambda: out.update(self.service.handle(
            {"method": method, "params": params})))
        check("error" not in out, f"{method}: {out.get('error')}")
        return syncs


def phase_serve_coin():
    """The coin flip (BASELINE config 1) compiled from DSL source and driven
    over HTTP: an MH session (with a checkpoint on the card), SMC, HMC and
    NUTS sessions, both VI guides and the two -32602 repairs."""
    import tempfile

    from fugue_tpu_torch.dsl import sessions
    from fugue_tpu_torch.dsl.sessions import MhSession
    from fugue_tpu_torch.inference.mcmc_utils import ess_multichain
    from fugue_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint

    log_z, p_exact = coin_exact()
    p_sd = math.sqrt(20.0 * 11.0 / (31.0 ** 2 * 32.0))  # Beta(20, 11)
    row = {"phase": "serve_coin", "card": card_line()}
    with Rpc() as rpc:
        t0 = time.perf_counter()
        model = rpc("compile", source=COIN_DSL, data={"flips": COIN_FLIPS})
        row["compile_ms"] = 1e3 * (time.perf_counter() - t0)
        check(model["dim"] == 1 and len(model["observed"]) == 27 and not model["warnings"],
              f"serve_coin compile: {model}")
        mid = model["model_id"]

        # MH: 4,096 chains, 300 + 300 transitions in two requests
        chains = 4096
        sid = rpc("mh.new", model_id=mid, n_chains=chains)["session_id"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rpc("mh.step", session_id=sid, n=300)
        out = rpc("mh.step", session_id=sid, n=300)
        mh_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        hist = np.asarray(rpc("mh.history", session_id=sid, address="p")["values"])
        history_ms = 1e3 * (time.perf_counter() - t0)
        check(hist.shape == (600, chains) and np.isfinite(hist).all(),
              f"serve_coin mh.history {hist.shape}")
        draws = torch.as_tensor(hist[300:].T)  # (chains, 300)
        ess = ess_multichain(draws).item()
        mcse = draws.std().item() / math.sqrt(ess)
        z = (draws.mean().item() - p_exact) / mcse
        reads = {n: rpc.host_reads("mh.step", session_id=sid, n=n) for n in (1, 10, 100)}
        # ten MH transitions launch the same kernels in any request: two
        # traced requests that differ fail (a session lost events)
        step10, _ = rpc.device_time("mh.step", session_id=sid, n=10)
        again, _ = rpc.device_time("mh.step", session_id=sid, n=10)
        check(step10["kernels"] == again["kernels"],
              f"serve_coin mh.step: {step10['kernels']} and {again['kernels']} kernels traced")
        row["mh"] = {"chains": chains, "transitions": 600, "wall_s": mh_wall,
                     "transitions_per_s": chains * 600 / mh_wall,
                     "accept_rate": out["accept_rate"], "history_ms": history_ms,
                     "p_mean": draws.mean().item(), "p_exact": p_exact, "ess": ess,
                     "mcse": mcse, "z": z, "host_reads_per_step_call": reads,
                     "one_request_of_10_transitions": step10}
        check(abs(z) < 5.0, f"serve_coin mh: mean p {draws.mean().item()} is {z:.2f} MC-SE "
              f"from {p_exact}")
        check(len(set(reads.values())) == 1,
              f"serve_coin mh.step: host reads {reads} grow with n")

        # a checkpoint on the card: save the session's state and generator
        # mid-run, restore them into a fresh session, step both
        sess = rpc.service._sessions[sid]
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "mh.npz")
            save_checkpoint(path, sess.carry)
            fresh = MhSession(12345, staged=sess.staged, n_chains=chains)
            fresh.carry = load_checkpoint(path, fresh.carry)
        check(fresh.carry["state"].log_joint.is_cuda, "serve_coin: restored state not on the card")
        a, b = sess.step(50)["p"], fresh.step(50)["p"]
        same = all(torch.equal(x, y) for x, y in zip(
            (sess.carry["state"].latents["p"], sess.carry["state"].log_joint,
             sess.carry["state"].adapt.log_scale),
            (fresh.carry["state"].latents["p"], fresh.carry["state"].log_joint,
             fresh.carry["state"].adapt.log_scale)))
        row["checkpoint_resume_bitwise"] = bool(np.array_equal(a, b) and same)
        check(row["checkpoint_resume_bitwise"], "serve_coin: the resumed session differs")

        # SMC at 131,072 particles, its kernel launches counted
        with recording(sessions, "adaptive_smc") as calls:  # the run's result, for its weights
            reset_launches()
            t0 = time.perf_counter()
            smc = rpc("smc.run", model_id=mid, n_particles=N_PARTICLES)
            smc_wall = time.perf_counter() - t0
            launches = read_launches()
        s = smc["n_stages"]
        # the run's standard errors: every stage's incremental weights keep
        # an ESS of at least N/2, so log Z's variance is at most stages / N
        # (x2 for the resampling's duplicates); the mean's is var / ESS x2
        se_z = math.sqrt(2.0 * s / N_PARTICLES)
        mean, var = smc["posterior_means"]["p"], smc["posterior_vars"]["p"]
        se_mean = math.sqrt(2.0 * var / smc["ess"])
        row["smc"] = {"particles": N_PARTICLES, "wall_s": smc_wall, "stages": s,
                      "ess": smc["ess"], "log_evidence": smc["log_evidence"],
                      "log_evidence_exact": log_z, "log_evidence_se": se_z,
                      "log_evidence_z": (smc["log_evidence"] - log_z) / se_z,
                      "p_mean": mean, "p_se": se_mean, "p_z": (mean - p_exact) / se_mean,
                      "launches": {k: launches[k] for k in ("lse", "resample")}}
        check(abs(row["smc"]["log_evidence_z"]) < 5.0,
              f"serve_coin smc: log Z {smc['log_evidence']} vs {log_z} (se {se_z})")
        check(abs(row["smc"]["p_z"]) < 5.0, f"serve_coin smc: mean p {mean} vs {p_exact}")
        check(launches["lse"] == 4 * s + 3 and launches["resample"] == s - 1,
              f"serve_coin smc: {launches} for {s} stages")
        # both kernels against their plain versions on the run's own
        # 131,072 log-weights (these launches come after the counts were read)
        (_, res), = calls
        lw = res.log_weights
        check(lw.dtype == torch.float32 and lw.shape == (N_PARTICLES,),
              f"serve_coin smc: log-weights {lw.dtype} {tuple(lw.shape)}")
        row["smc"]["kernels_vs_plain_on_the_run_weights"] = {
            "logsumexp": _lse_f32_check(lw, "serve_coin smc logsumexp"),
            "systematic_resample": [
                _resample_f32_contract(lw, lw.double().cpu().numpy(), u0v,
                                       f"serve_coin smc resample u0={u0v}")
                for u0v in (0.37, 0.0, 1.0 - 2.0**-24)]}

        # HMC and NUTS sessions, recorded transitions
        hmc = rpc("hmc.new", model_id=mid, n_leapfrog=16)
        rec = rpc("hmc.step", session_id=hmc["session_id"], recorded=True)
        check(len(rec["trajectory"]) == 16 and len(rec["hamiltonians"]) == 16
              and np.isfinite(rec["hamiltonians"]).all(), "serve_coin hmc.step recorded")
        t0 = time.perf_counter()
        nuts = rpc("nuts.new", model_id=mid, warmup=100)
        nuts_new_s = time.perf_counter() - t0
        nrec = rpc("nuts.step", session_id=nuts["session_id"], recorded=True)
        check(nrec["n_leapfrog"] == len(nrec["trajectory"]) >= 1
              and np.isfinite(nrec["hamiltonians"]).all(), "serve_coin nuts.step recorded")
        row["hmc"] = {"step_size": hmc["step_size"], "trajectory": len(rec["trajectory"])}
        row["nuts"] = {"warmup_s": nuts_new_s, "step_size": nuts["step_size"],
                       "n_leapfrog": nrec["n_leapfrog"]}

        # VI, both guides, gated as tests/test_serve.py gates them
        vi = {}
        for guide in ("meanfield", "fullrank"):
            t0 = time.perf_counter()
            out = rpc("vi.run", model_id=mid, guide=guide, n_iterations=600,
                      posterior_draws=4096)
            post = out["posterior"]["p"]
            vi[guide] = {"wall_s": time.perf_counter() - t0, "mean": post["mean"][0],
                         "sd": post["sd"][0], "final_elbo": out["final_elbo"],
                         "n_iterations_run": out["n_iterations_run"]}
            check(len(out["elbo_history"]) >= 2 and out["final_elbo"] == out["elbo_history"][-1],
                  f"serve_coin vi.run {guide}: ELBO history")
        check(abs(vi["meanfield"]["mean"] - p_exact) < 0.04
              and abs(vi["meanfield"]["sd"] - p_sd) < 0.04, f"serve_coin vi meanfield: {vi}")
        check(abs(vi["fullrank"]["mean"] - p_exact) < 0.05, f"serve_coin vi fullrank: {vi}")
        row["vi"] = vi

        # the repairs of the reference's IndexError / NaN, and the sharded
        # engine on an unknown model (serve_sharded runs it)
        codes = {k: rpc.post("vi.run", model_id=mid, **{k: 0})["error"]["code"]
                 for k in ("n_iterations", "posterior_draws")}
        codes["hmc.sharded"] = rpc.post("hmc.sharded", model_id="model-0")["error"]["code"]
        row["error_codes"] = codes
        check(codes == {"n_iterations": -32602, "posterior_draws": -32602,
                        "hmc.sharded": -32602}, f"serve_coin error codes {codes}")
    emit(row)
    return row["smc"]["launches"]


def _one_gradient_kernels(staged, q):
    """(CUDA kernels, device µs) of one batched value-and-gradient of
    ``staged.potential`` at the (C, d) positions ``q``, traced twice: the
    same gradient launches the same kernels, so two sessions that differ
    fail (one of them lost events)."""
    from fugue_tpu_torch.inference.hmc import batched_force

    force = batched_force(staged.potential)
    force(q)  # warm
    first, ks = (traced_kernels(lambda: force(q))[1] for _ in range(2))
    check(len(first) == len(ks), f"one gradient traced as {len(first)} and {len(ks)} kernels")
    return len(ks), sum(e.time_range.elapsed_us() for e in ks)


def eight_schools_log_joint64(mu, tau, theta):
    """The DSL eight-schools' log joint in float64 numpy on a (mu, tau) grid,
    the eight theta_raw values given: mu ~ N(0, 5), tau ~ LogNormal(0.5, 1),
    theta_j ~ N(0, 1), y_j ~ N(mu + tau theta_j, sigma_j)."""
    def log_n(x, m, s):
        return -0.5 * ((x - m) / s) ** 2 - np.log(s) - 0.5 * np.log(2 * np.pi)

    y, sigma = np.asarray(EIGHT_SCHOOLS_Y), np.asarray(EIGHT_SCHOOLS_SIGMA)
    out = log_n(mu, 0.0, 5.0) + log_n(np.log(tau), 0.5, 1.0) - np.log(tau)
    out = out + np.sum(log_n(theta, 0.0, 1.0))
    for j in range(8):
        out = out + log_n(y[j], mu + tau * theta[j], sigma[j])
    return out


def phase_serve_eight_schools(direct_grad_evals_per_s=None):
    """Non-centred eight-schools written in the DSL (18 sites): ChEES over
    HTTP at 1,024 chains, and the 512 x 512 log-joint grid."""
    import fugue_tpu_torch as ftt

    n_chains, n_warmup, n_steps = 1024, 200, 100  # steps cut from 200 (PERF.md §4)
    row = {"phase": "serve_eight_schools", "card": card_line(), "chains": n_chains,
           "warmup": n_warmup, "steps": n_steps}
    with Rpc() as rpc:
        mid = rpc("compile", source=EIGHT_SCHOOLS_DSL,
                  data={"y": EIGHT_SCHOOLS_Y, "sigma": EIGHT_SCHOOLS_SIGMA})["model_id"]
        staged = rpc.service._models[mid][2]
        check(staged.sites[0].address == "mu" and staged.dim == 10,
              f"serve_eight_schools sites {[s.address for s in staged.sites]}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new = rpc("chees.new", model_id=mid, n_chains=n_chains, n_warmup=n_warmup)
        row["chees_new_s"] = time.perf_counter() - t0
        mu, leapfrogs, walls = [], 0, []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            out = rpc("chees.step", session_id=new["session_id"])
            walls.append(time.perf_counter() - t0)
            mu.append(np.asarray(out["positions"])[:, 0])  # mu is z's first coordinate
            leapfrogs += out["n_leapfrog"]
        wall = sum(walls)
        mu = torch.as_tensor(np.stack(mu, axis=1))  # (chains, steps)
        post = {"mu_mean": mu.mean().item(), "mu_sd": mu.std().item(),
                "ess_mu": ftt.ess_multichain(mu).item(),
                "split_rhat_mu": ftt.split_r_hat(mu).item()}
        mcse = post["mu_sd"] / math.sqrt(post["ess_mu"])
        post["mu_z"] = ((post["mu_mean"] - EIGHT_SCHOOLS_MU_MEAN)
                        / math.hypot(mcse, EIGHT_SCHOOLS_MU_MCSE))
        grad_evals = n_chains * (leapfrogs + n_steps)  # bench_chees's count
        row.update(post, step_size=new["step_size"], trajectory_length=new["trajectory_length"],
                   mean_leapfrog=leapfrogs / n_steps, wall_s=wall,
                   grad_evals_per_s=grad_evals / wall,
                   direct_grad_evals_per_s=direct_grad_evals_per_s,
                   ms_per_request=statistics.median(walls) * 1e3,
                   ms_per_request_mean=1e3 * wall / n_steps)
        check(abs(post["mu_z"]) < 5.0, f"serve_eight_schools mu mean {post['mu_mean']} is "
              f"{post['mu_z']:.2f} MC-SE from {EIGHT_SCHOOLS_MU_MEAN}")

        # kernels per batched gradient: the DSL model against the hand-written one
        q = rpc.service._sessions[new["session_id"]].positions
        hand = ftt.stage(eight_schools_model("cuda"), device="cuda")
        k_dsl, us_dsl = _one_gradient_kernels(staged, q)
        k_hand, us_hand = _one_gradient_kernels(hand, q)
        step, out = rpc.device_time("chees.step", session_id=new["session_id"])
        row.update(kernels_per_gradient_dsl=k_dsl, device_us_per_gradient_dsl=us_dsl,
                   kernels_per_gradient_hand=k_hand, device_us_per_gradient_hand=us_hand,
                   one_chees_step=dict(step, n_leapfrog=out["n_leapfrog"]))
        # each leapfrog of the traced request takes one batched gradient
        check(step["kernels"] >= out["n_leapfrog"] * k_dsl,
              f"serve_eight_schools: a chees.step of {out['n_leapfrog']} leapfrogs traced as "
              f"{step['kernels']} kernels, {k_dsl} per gradient")

        # the log-joint grid over (mu, tau): 262,144 evaluations in one request
        res = 512
        theta = np.random.default_rng(3).normal(size=8)
        fixed = {f"theta_raw#{j}": float(theta[j]) for j in range(8)}
        t0 = time.perf_counter()
        g = rpc("grid", model_id=mid, x_address="mu", y_address="tau", x_range=[-10.0, 20.0],
                y_range=[0.05, 20.0], resolution=res, fixed=fixed)
        grid_ms = 1e3 * (time.perf_counter() - t0)
        z = np.asarray(g["log_joint"], np.float64)
        xs, ys = np.asarray(g["x"], np.float64), np.asarray(g["y"], np.float64)
        ref = eight_schools_log_joint64(xs[None, :], ys[:, None], theta)
        err = float(np.max(np.abs(z - ref) / np.maximum(1.0, np.abs(ref))))
        row.update(grid_resolution=res, grid_ms=grid_ms, grid_max_rel_err=err)
        check(z.shape == (res, res) and np.isfinite(z).all(), f"grid {z.shape}")
        check(err < 3e-5, f"serve_eight_schools grid: {err} from float64 (float32 tolerance 3e-5)")
    emit(row)


def kalman_filter(ys, q, r, p0=1.0):
    """The exact filtered means and variances of x_t = x_{t-1} + N(0, q²),
    y_t ~ N(x_t, r²), x_0 ~ N(0, p0)."""
    m, p, out = 0.0, p0, []
    for y in ys:
        p = p + q * q
        k = p / (p + r * r)
        m, p = m + k * (y - m), (1.0 - k) * p
        out.append((m, p))
    return out


def phase_serve_pf():
    """pf.new at 2^20 particles, 200 pf.observe requests on a random walk,
    against the exact Kalman filter; both SMC kernels against their plain
    versions on one observe's own inputs; one observe under device_trace."""
    import glob
    import re
    import tempfile
    import warnings

    from fugue_tpu_torch.dsl import sessions
    from fugue_tpu_torch.ops import kernels as K
    from fugue_tpu_torch.utils.profiling import device_trace, is_priming_kernel

    n, q, r, steps = 1 << 20, 0.3, 0.5, 200
    rng = np.random.default_rng(17)
    x = rng.normal() + np.cumsum(rng.normal(0.0, q, steps))
    ys = x + rng.normal(0.0, r, steps)
    exact = kalman_filter(ys, q, r)
    row = {"phase": "serve_pf", "card": card_line(), "particles": n, "q": q, "r": r,
           "observations": steps}
    with Rpc() as rpc:
        sid = rpc("pf.new", n_particles=n, process_sd=q, obs_sd=r)["session_id"]
        reset_launches()
        walls, worst = [], 0.0
        for t, y in enumerate(ys):
            t0 = time.perf_counter()
            est = rpc("pf.observe", session_id=sid, y=float(y))
            walls.append(time.perf_counter() - t0)
            m, p = exact[t]
            se = math.sqrt(p * (1.0 / est["ess"] + 1.0 / n))
            worst = max(worst, abs(est["mean"] - m) / se)
        launches = read_launches()
        reads = rpc.host_reads("pf.observe", session_id=sid, y=float(ys[-1]))

        # both kernels against their plain versions on the inputs one
        # observe gives them at 2^20: logsumexp's three (the log-weights,
        # twice them, the weights kept) and the resample's (log-weights, u0)
        with recording(K, "plogsumexp") as lses, \
                recording(sessions, "systematic_resample_from_u0") as draws:
            rpc("pf.observe", session_id=sid, y=float(ys[-2]))
        check(len(lses) == 3 and len(draws) == 1,
              f"serve_pf: {len(lses)} logsumexp and {len(draws)} resample calls in one observe")
        (lw, u0), _ = draws[0]
        check(lw.dtype == torch.float32 and lw.shape == (n,), f"serve_pf: log-weights {lw.shape}")
        row["kernels_vs_plain_on_an_observe"] = {
            "logsumexp": [_lse_f32_check(x, f"serve_pf logsumexp {i}")
                          for i, ((x,), _) in enumerate(lses)],
            "systematic_resample": [
                _resample_f32_contract(lw, lw.double().cpu().numpy(), u0v,
                                       f"serve_pf resample u0={u0v}")
                for u0v in (u0.item(), 0.37, 0.0, 1.0 - 2.0**-24)]}

        # one observe under the port's device_trace (a session that lost
        # every priming kernel is traced again): the trace holds each kernel
        # of the launch contract, and as many kernels as a CUDA-only session
        # of the next observe (whose device events also hold the copies and
        # fills)
        def trace_once():
            with tempfile.TemporaryDirectory() as tmp:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    with device_trace(tmp):
                        rpc("pf.observe", session_id=sid, y=float(ys[-1]))
                files = glob.glob(os.path.join(tmp, "*.json"))
                check(len(files) == 1, f"serve_pf: device_trace wrote {files}")
                with open(files[0]) as f:
                    events = json.load(f)["traceEvents"]
            if any("lost every priming kernel" in str(w.message) for w in caught):
                return None
            return [e for e in events if e.get("cat") == "kernel"
                    and not is_priming_kernel(e["name"])]

        kernels = whole_session(trace_once, "serve_pf device_trace")
        named = {k: sum(bool(re.search(rf"\b{k}<", e["name"])) for e in kernels)
                 for k in ("lse_partial", "lse_finish", "lse_parts", "emit")}
        _, again = traced_kernels(lambda: rpc("pf.observe", session_id=sid, y=float(ys[-1])))
        again = [e for e in again if not e.name.startswith(("Memcpy", "Memset"))]
        device_us = sum(e["dur"] for e in kernels)
    row.update(ms_per_observe=statistics.median(walls) * 1e3,
               ms_per_observe_mean=1e3 * sum(walls) / steps, worst_z=worst,
               launches={k: launches[k] for k in ("lse", "resample")},
               host_reads_per_observe=reads, trace_kernel_counts=named,
               traced_observe={"kernels": len(kernels), "kernels_cuda_only_session": len(again),
                               "device_us": device_us,
                               "idle_share": 1.0 - 1e-3 * device_us
                               / (statistics.median(walls) * 1e3)})
    emit(row)
    check(worst < 5.0, f"serve_pf: a filtered mean is {worst:.2f} SE from the Kalman filter's")
    check(launches["lse"] == 3 * steps and launches["resample"] == steps,
          f"serve_pf: {launches} in {steps} observes (want 3 lse + 1 resample each)")
    check(reads == 1, f"serve_pf: {reads} host reads in one observe")
    check(named == {"lse_partial": 3, "lse_finish": 3, "lse_parts": 1, "emit": 1},
          f"serve_pf: the traced observe's kernels {named}, want logsumexp's two 3 times "
          "and the resample's two once")
    check(len(kernels) == len(again),
          f"serve_pf: {len(kernels)} kernels in the device_trace session, {len(again)} in the next")
    return row["launches"]


# ---------------------------------------------------------------------------
# the multi-device layer (fugue_tpu_torch/parallel): NCCL at world size 1,
# two gloo ranks on the one card, the sharded service and checkpoints
# ---------------------------------------------------------------------------

# The per-transition numbers of the single-device phases, for the sharded
# phases to compare with (filled when those phases run).
SINGLE_DEVICE_MS = {}
TWO_RANKS_TIMEOUT_S = 420


def _nccl_mesh():
    """The chain mesh over the default process group: one NCCL rank on the
    card (the group the port makes when none exists). The communicator's
    first collective runs here, outside every count. NCCL allocates its
    buffers outside PyTorch's caching allocator, so the memory that the
    earlier phases left cached is returned to the card first (else NCCL's
    first allocation fails once the cache holds the card)."""
    from fugue_tpu_torch.parallel import make_chain_mesh
    from fugue_tpu_torch.parallel.mesh import ShardLayout, cross_sum

    if not torch.distributed.is_initialized():
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        emit({"phase": "nccl_group", "cached_gb_returned": reserved / 2**30,
              "free_gb": free / 2**30, "total_gb": total / 2**30})
    mesh = make_chain_mesh(device="cuda")
    check(torch.distributed.get_backend() == "nccl" and mesh.size() == 1,
          f"the card's mesh: backend {torch.distributed.get_backend()}, {mesh.size()} ranks")
    cross_sum(torch.zeros((), device="cuda"), ShardLayout.of(mesh).group)
    torch.cuda.synchronize()
    return mesh


def _reset_collectives():
    from fugue_tpu_torch.parallel.mesh import COUNTS

    torch.cuda.synchronize()
    COUNTS.update(collectives=0, host_staged=0)


def _read_collectives():
    from fugue_tpu_torch.parallel.mesh import COUNTS

    torch.cuda.synchronize()
    return dict(COUNTS)


# the collectives of one sharded HMC run besides one acceptance mean per
# warmup transition: the ε₀ consensus, the Welford merge's two sums and the
# five gathers of the result (positions, log joints, acceptances,
# divergences, final positions)
HMC_FIXED_COLLECTIVES = 1 + 2 + 5


def _added_host_syncs(staged, cfg, group, n_chains, n_warmup):
    """Host syncs of the sharded HMC drive and of the single-device drive
    from the same positions and generator seed, n_warmup warmup
    transitions each (the ε search's reads are the same in both)."""
    from fugue_tpu_torch.inference.hmc import initial_positions, make_hmc_drive

    q0 = initial_positions(staged, torch.Generator(device="cuda").manual_seed(5), n_chains,
                           cfg.init)
    out = {}
    for name, grp in (("single_device", None), ("nccl", group)):
        drive = make_hmc_drive(staged, cfg, n_chains, 0, n_warmup, chain_group=grp)
        out[name] = _host_syncs(lambda: drive(q0, torch.Generator(device="cuda").manual_seed(6)))
    return out


def _interleaved_drive_ms(staged, cfg, group, n_chains, n_warmup=8, rounds=3):
    """ms per drive (the ε search and n_warmup warmup transitions) of the
    single-device drive and the NCCL drive from the same positions and
    generator seed: each run once first, then timed in turns (single,
    NCCL, NCCL, single) ``rounds`` times; NCCL over single per round."""
    from fugue_tpu_torch.inference.hmc import initial_positions, make_hmc_drive

    q0 = initial_positions(staged, torch.Generator(device="cuda").manual_seed(5), n_chains,
                           cfg.init)
    drives = {name: make_hmc_drive(staged, cfg, n_chains, 0, n_warmup, chain_group=grp)
              for name, grp in (("single_device", None), ("nccl", group))}

    def once(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drives[name](q0, torch.Generator(device="cuda").manual_seed(6))
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    for name in drives:
        once(name)
    ms = {name: [] for name in drives}
    ratios = []
    for _ in range(rounds):
        turn = {name: 0.0 for name in drives}
        for name in ("single_device", "nccl", "nccl", "single_device"):
            t = once(name)
            ms[name].append(t)
            turn[name] += t
        ratios.append(turn["nccl"] / turn["single_device"])
    return {"warmup_transitions_per_drive": n_warmup, "ms_per_drive": ms,
            "nccl_over_single_device": ratios,
            "ratio_median": statistics.median(ratios), "ratio_min": min(ratios),
            "ratio_max": max(ratios)}


# the collectives of one sharded NUTS run besides one all-reduce per warmup
# iteration: the chain count, the ε₀ consensus, the Welford merge's two sums
# and the seven gathers of the result
NUTS_FIXED_COLLECTIVES = 1 + 1 + 2 + 7


def _nuts_drive_syncs(staged, group, n_chains, n_warmup):
    """Host syncs measured in one async warmup of ``n_warmup`` transitions
    per chain at a fixed ε₀ (no search), single-device and over the group,
    from the same positions and seed, beside the reads the drive counted."""
    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.inference.hmc import initial_positions
    from fugue_tpu_torch.inference.nuts import make_nuts_drive

    q0 = initial_positions(staged, torch.Generator(device="cuda").manual_seed(5), n_chains,
                           "uniform")
    cfg = ftt.NUTSConfig(step_size=0.2)
    out = {}
    for name, grp in (("single_device", None), ("nccl", group)):
        drive = make_nuts_drive(staged, cfg, n_chains, 0, n_warmup, chain_group=grp)
        got = {}
        out[name] = _host_syncs(lambda: got.update(
            counts=drive(q0, torch.Generator(device="cuda").manual_seed(6))[-1]))
        out[name + "_counted"] = got["counts"]["host_syncs"]
    return out


def _sharded_nuts(staged, mesh, group):
    """parallel.sharded_nuts_chain (the async drive) at one NCCL rank on
    eight-schools, 1,024 chains, 50 + 50 (nuts_eight_schools: 200 + 200):
    its gates, one all-reduce per warmup iteration, and no host read beyond
    one per chunk of 16 iterations (the syncs measured in two warmups of
    different lengths differ by the chunk reads counted, with and without
    the group)."""
    from fugue_tpu_torch.parallel import sharded_nuts_chain

    n_chains, n_warmup, n_samples = 1024, 50, 50
    _reset_collectives()
    t0 = time.perf_counter()
    res = sharded_nuts_chain(5, staged=staged, n_samples=n_samples, n_warmup=n_warmup,
                             n_chains=n_chains, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_collectives()
    post = _eight_schools_posterior(res, n_chains, n_samples, "sharded_nuts mu")
    short, long = (_nuts_drive_syncs(staged, group, n_chains, w) for w in (4, 12))
    n_trans = n_warmup + n_samples
    emit({"phase": "sharded_hmc", "run": "nuts_eight_schools", "card": card_line(),
          "backend": "nccl", "ranks": 1, "chains": n_chains, "warmup": n_warmup,
          "samples": n_samples, "wall_s": wall, "ms_per_transition": 1e3 * wall / n_trans,
          "grad_evals_per_s": (res.n_leapfrogs + n_chains * n_trans) / wall,
          "collectives": counts, "warmup_iterations": res.warmup_leaves,
          "collectives_per_warmup_iteration":
              (counts["collectives"] - NUTS_FIXED_COLLECTIVES) / res.warmup_leaves,
          "host_syncs_warmup_4": short, "host_syncs_warmup_12": long,
          **post, **_nuts_tree_stats(res, n_chains, n_trans, wall)})
    rhat, div, z = post["split_rhat_mu"], post["divergence_rate"], post["mu_z"]
    check(rhat < 1.02, f"sharded_nuts split-R-hat(mu) {rhat} >= 1.02")
    check(div < 0.05, f"sharded_nuts divergence rate {div} >= 0.05")
    check(abs(z) < 5.0, f"sharded_nuts mu mean {post['mu_mean']} is {z:.2f} MC-SE from "
          f"{EIGHT_SCHOOLS_MU_MEAN}")
    check(counts == {"collectives": res.warmup_leaves + NUTS_FIXED_COLLECTIVES,
                     "host_staged": 0},
          f"sharded_nuts collectives {counts}, want {res.warmup_leaves} warmup iterations + "
          f"{NUTS_FIXED_COLLECTIVES}, none through the host")
    check(res.host_syncs == res.lockstep_leaves // 16,
          f"sharded_nuts: {res.host_syncs} host reads for {res.lockstep_leaves} iterations")
    for name in ("single_device", "nccl"):
        added, counted = (long[name] - short[name],
                          long[name + "_counted"] - short[name + "_counted"])
        check(added == counted, f"sharded_nuts ({name}): {added} more host syncs in the longer "
              f"warmup for {counted} more chunk reads")
    check(short["nccl"] == short["single_device"] and long["nccl"] == long["single_device"],
          f"sharded_nuts: the NCCL collectives add host syncs {short} {long}")


def phase_sharded_hmc():
    """parallel.sharded_hmc_chain at world size 1 under NCCL: eight-schools
    at 1,024 chains (the eight_schools phase's configuration) and the 2^20
    plate at 64 chains through the value-and-grad kernel (gaussian_plate's),
    the kernel held against its plain version on one of the run's calls;
    the single-device phases' gates, ms per transition beside theirs, NCCL
    collectives per warmup transition and the host syncs they add, and the
    NCCL drive against the single-device drive timed in turns."""
    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.ops import kernels as K
    from fugue_tpu_torch.parallel import sharded_hmc_chain, sharded_nuts_chain
    from fugue_tpu_torch.parallel.mesh import ShardLayout

    mesh = _nccl_mesh()
    group = ShardLayout.of(mesh).group
    n_chains, n_warmup, n_samples, L = 1024, 100, 100, 32  # the eight_schools phase's
    staged = ftt.stage(eight_schools_model("cuda"), device="cuda")
    cfg = ftt.HMCConfig(n_leapfrog=L, target_accept=0.9)
    _reset_collectives()
    t0 = time.perf_counter()
    res = sharded_hmc_chain(1, staged=staged, n_samples=n_samples, n_warmup=n_warmup,
                            config=cfg, n_chains=n_chains, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_collectives()
    post = _eight_schools_posterior(res, n_chains, n_samples, "sharded_hmc mu")
    n_trans = n_warmup + n_samples
    syncs = _added_host_syncs(staged, cfg, group, n_chains, 10)
    in_turns = _interleaved_drive_ms(staged, cfg, group, n_chains)
    row = {"phase": "sharded_hmc", "run": "eight_schools", "card": card_line(),
           "backend": "nccl", "ranks": 1, "chains": n_chains, "warmup": n_warmup,
           "samples": n_samples, "n_leapfrog": L, "wall_s": wall,
           "ms_per_transition": 1e3 * wall / n_trans,
           "single_device_ms_per_transition": SINGLE_DEVICE_MS.get("eight_schools"),
           "grad_evals_per_s": n_chains * n_trans * (L + 1) / wall,
           "collectives": counts,
           "collectives_per_warmup_transition":
               (counts["collectives"] - HMC_FIXED_COLLECTIVES) / n_warmup,
           "host_syncs_10_warmup_transitions": syncs,
           "added_host_syncs_per_warmup_transition":
               (syncs["nccl"] - syncs["single_device"]) / 10,
           "drives_in_turns": in_turns, **post}
    emit(row)
    rhat, div, z = post["split_rhat_mu"], post["divergence_rate"], post["mu_z"]
    check(rhat < 1.02, f"sharded_hmc split-R-hat(mu) {rhat} >= 1.02")
    check(div < 0.02, f"sharded_hmc divergence rate {div} >= 0.02")
    check(abs(z) < 5.0, f"sharded_hmc mu mean {post['mu_mean']} is {z:.2f} MC-SE from "
          f"{EIGHT_SCHOOLS_MU_MEAN}")
    check(counts == {"collectives": n_warmup + HMC_FIXED_COLLECTIVES, "host_staged": 0},
          f"sharded_hmc collectives {counts}, want {n_warmup} + {HMC_FIXED_COLLECTIVES}, "
          "none through the host")
    check(syncs["nccl"] == syncs["single_device"],
          f"sharded_hmc: the NCCL collectives add host syncs {syncs}")

    _sharded_nuts(staged, mesh, group)

    n_chains, n = MAIN_SHAPE
    n_warmup = n_samples = 100  # gaussian_plate's
    n_trans = n_warmup + n_samples
    cfg = ftt.HMCConfig(n_leapfrog=16, jitter=0.5)
    with recording(K, "_value_and_grad") as calls:
        y, res, wall, launches, model_runs = _plate_run(
            lambda staged, y: sharded_hmc_chain(3, staged=staged, n_samples=n_samples,
                                                n_warmup=n_warmup, config=cfg,
                                                n_chains=n_chains, mesh=mesh))
    hold = _hold_path_plate(K, *_path_plate_call(calls, n_chains, "sharded plate"),
                            "sharded_hmc plate")
    calls.clear()
    post = _plate_posterior(res, y, n_chains, n_samples, "sharded plate")
    emit({"phase": "sharded_hmc", "run": "plate", "card": card_line(), "chains": n_chains,
          "rows": n, "warmup": n_warmup, "samples": n_samples, "n_leapfrog": 16,
          "wall_s": wall, "ms_per_transition": 1e3 * wall / n_trans,
          "single_device_ms_per_transition": SINGLE_DEVICE_MS.get("gaussian_plate"),
          "rows_per_s": n_chains * n_trans * 17 * n / wall, "batched_model_runs": model_runs,
          "launches": launches, "kernel_vs_plain_on_a_call_of_the_run": hold, **post})
    _check_plate(post, launches, model_runs, "sharded plate")

    # the async NUTS drive over the mesh on the plate (nuts_plate: 100 + 100)
    n_warmup = n_samples = 50
    _reset_collectives()
    y, res, wall, nuts_launches, model_runs, made, hold = _nuts_plate_run(
        lambda staged: sharded_nuts_chain(3, staged=staged, n_samples=n_samples,
                                          n_warmup=n_warmup, n_chains=n_chains, mesh=mesh),
        "sharded_nuts plate")
    counts = _read_collectives()
    post = _plate_posterior(res, y, n_chains, n_samples, "sharded nuts plate")
    n_trans = n_warmup + n_samples
    emit({"phase": "sharded_hmc", "run": "nuts_plate", "card": card_line(), "backend": "nccl",
          "ranks": 1, "chains": n_chains, "rows": n, "warmup": n_warmup, "samples": n_samples,
          "wall_s": wall, "ms_per_transition": 1e3 * wall / n_trans,
          "batched_model_runs": model_runs, "search_runs": made["search"],
          "constrain_runs": made["constrain"], "launches": nuts_launches,
          "collectives": counts, "kernel_vs_plain_on_a_call_of_the_run": hold, **post,
          **_nuts_tree_stats(res, n_chains, n_trans, wall)})
    _check_plate(post, nuts_launches, model_runs, "sharded nuts plate")
    check(counts == {"collectives": res.warmup_leaves + NUTS_FIXED_COLLECTIVES,
                     "host_staged": 0},
          f"sharded nuts plate collectives {counts}, want {res.warmup_leaves} warmup "
          f"iterations + {NUTS_FIXED_COLLECTIVES}, none through the host")
    return {k: launches[k] + nuts_launches[k] for k in launches}


def phase_sharded_smc():
    """parallel.sharded_smc at world size 1 under NCCL: the 20-site
    hierarchical model at 131,072 particles with 3 MH moves (the smc
    phase's first run and gates), the launch contracts, and both kernels
    against their plain versions on the gathered vectors of the run."""
    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.ops import kernels as K

    mesh = _nccl_mesh()
    staged = ftt.stage(hierarchical_model("cuda"), device="cuda")
    cfg = ftt.SMCConfig(rejuvenation_steps=3)
    _reset_collectives()
    with recording(K, "psystematic_resample") as resamples:
        row, res = _smc_run("sharded_hierarchical_mh", staged, N_PARTICLES, 3, cfg,
                            phase="sharded_smc", mesh=mesh)
    counts = _read_collectives()
    ref = SMC_MU["mh"]
    mcse = math.hypot(ref["MU_RUN_SD"], ref["MU_RUN_SD"] / math.sqrt(SMC_MU_RUNS))
    row.update(card=card_line(), backend="nccl", ranks=1, collectives=counts,
               mu_ref=ref["MU_MEAN"], mu_mcse=mcse, mu_z=(row["mu_mean"] - ref["MU_MEAN"]) / mcse)
    emit(row)
    check(abs(row["mu_z"]) < 5.0, f"sharded_smc: mu mean {row['mu_mean']} is "
          f"{row['mu_z']:.2f} MC-SE from {ref['MU_MEAN']}")
    check(counts["host_staged"] == 0, f"sharded_smc: {counts}")
    # the gathered (N,) log-weights that the run's last resample read
    lw = resamples[-1][0][1].float()
    check(lw.shape == (N_PARTICLES,), f"sharded_smc: resampled {tuple(lw.shape)}")
    holds = {"logsumexp": _lse_f32_check(lw, "sharded_smc logsumexp"),
             "systematic_resample": [
                 _resample_f32_contract(lw, lw.double().cpu().numpy(), u0v,
                                        f"sharded_smc resample u0={u0v}")
                 for u0v in (0.37, 0.0, 1.0 - 2.0**-24)]}
    PATH_HOLDS["lse"]["sharded_smc"] = holds["logsumexp"]["kernel_vs_plain"]
    PATH_HOLDS["resample"]["sharded_smc"] = max(
        r["kernel_vs_plain"] for r in holds["systematic_resample"])
    emit({"phase": "sharded_smc", "kernels_vs_plain_on_the_gathered_vectors": holds})
    return row["launches"]


def phase_sharded_vi_plate():
    """parallel.sharded_vi in data mode (the plate likelihood a sharded
    factor) at world size 1 under NCCL on the 2^20-row plate, the vi_plate
    phase's configuration and gates: one plate-kernel call and one NCCL
    all-reduce per iteration, one host sync per segment; the kernel held
    against its plain version on one of the run's calls."""
    import functools

    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.ops import kernels as K
    from fugue_tpu_torch.parallel import sharded_vi

    mesh = _nccl_mesh()
    n_iter = VI_PLATE_SEGMENTS * VI_PLATE_ITERATIONS
    y_np = plate_numpy_data(MAIN_SHAPE[1])
    y = torch.as_tensor(y_np, dtype=torch.float32, device="cuda")
    model_runs = [0]
    staged = ftt.stage(plate_arg_model(model_runs), y, device="cuda")
    model_runs[0] = 0
    optimize = functools.partial(sharded_vi, mesh=mesh, shard="data", factors="sharded")
    reset_launches()
    _reset_collectives()
    with recording(K, "_value_and_grad") as calls:
        res, wall, syncs = _timed_syncs(lambda: vi_plate_run(staged, 700, optimize))
        launches, counts, runs = read_launches(), _read_collectives(), model_runs[0]
    hold = _hold_path_plate(K, *_path_plate_call(calls, VI_PLATE_MC, "sharded_vi_plate"),
                            "sharded_vi_plate")
    calls.clear()
    stats = vi_plate_stats(res.params, y_np)
    emit({"phase": "sharded_vi_plate", "card": card_line(), "backend": "nccl", "ranks": 1,
          "rows": MAIN_SHAPE[1], "iterations": n_iter, "wall_s": wall,
          "ms_per_iteration": 1e3 * wall / n_iter,
          "single_device_ms_per_iteration": SINGLE_DEVICE_MS.get("vi_plate"),
          "host_syncs_per_run": syncs, "collectives": counts, "batched_model_runs": runs,
          "launches": launches, "kernel_vs_plain_on_a_call_of_the_run": hold, **stats})
    for k, v in stats.items():
        _within(v, VI_PLATE[k], VI_REF_RUNS["plate"], f"sharded_vi_plate {k}")
    check(runs == n_iter and launches["nll"] == runs,
          f"sharded_vi_plate: {launches['nll']} plate kernel calls, {runs} model runs")
    check(counts == {"collectives": n_iter, "host_staged": 0},
          f"sharded_vi_plate: collectives {counts}, want one all-reduce per iteration")
    check(syncs == VI_PLATE_SEGMENTS, f"sharded_vi_plate: {syncs} host syncs, want one per segment")
    return launches


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def two_ranks_worker(rank: int, world: int, port: int, out: str) -> None:
    """One of two ranks on the one card over gloo (NCCL refuses two ranks
    on one device): HMC on eight-schools at 2 x 512 chains, SMC on the
    hierarchical model at 131,072 particles through the ring, and VI's data
    mode on 2 x 2^19 plate rows. Writes the rank's results, and the
    inputs of one of its VI plate-kernel calls, to ``out/rank{rank}.npz``."""
    import functools

    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.ops import kernels as K
    from fugue_tpu_torch.parallel import (DistributedConfig, initialize_distributed,
                                          make_chain_mesh, sharded_hmc_chain, sharded_vi)
    from fugue_tpu_torch.parallel.mesh import COUNTS

    initialize_distributed(DistributedConfig(f"localhost:{port}", world, rank, backend="gloo"),
                           device="cuda")
    try:
        mesh = make_chain_mesh(device="cuda")
        res, walls, staged_reads = {}, {}, {}

        def timed(name, fn):
            reset_launches()
            COUNTS.update(collectives=0, host_staged=0)
            torch.distributed.barrier()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            staged_reads[name] = COUNTS["host_staged"]
            res[f"{name}_launches"] = np.array([read_launches()[k] for k in ("nll", "lse",
                                                                             "resample")])
            return out

        n_warmup, n_samples = TWO_RANKS_HMC
        staged = ftt.stage(eight_schools_model("cuda"), device="cuda")
        h = timed("hmc", lambda: sharded_hmc_chain(
            1, staged=staged, n_samples=n_samples, n_warmup=n_warmup,
            config=ftt.HMCConfig(n_leapfrog=32, target_accept=0.9), n_chains=1024, mesh=mesh))
        res.update(hmc_mu=h.samples["mu"].cpu().numpy(), hmc_tau=h.samples["tau"].cpu().numpy(),
                   hmc_div=h.divergences.cpu().numpy(), hmc_eps=np.array(h.step_size),
                   hmc_mass=h.inv_mass.cpu().numpy())
        staged = ftt.stage(hierarchical_model("cuda"), device="cuda")
        s = timed("smc", lambda: ftt.adaptive_smc(
            3, N_PARTICLES, staged=staged, config=ftt.SMCConfig(rejuvenation_steps=3),
            mesh=mesh))
        res.update(smc_scalars=np.array([s.log_evidence, s.n_stages, s.beta,
                                         s.posterior_mean("mu").item(),
                                         s.weights.double().sum().item()]),
                   smc_mu=s.particles["mu"].cpu().numpy())
        res["ring_ms"] = np.array(_ring_exchange_ms(s.particles, mesh))
        y = torch.as_tensor(plate_numpy_data(MAIN_SHAPE[1]), dtype=torch.float32, device="cuda")
        staged = ftt.stage(plate_arg_model(), y, device="cuda")
        with recording(K, "_value_and_grad") as calls:
            v = timed("vi", lambda: vi_plate_run(staged, 700, functools.partial(
                sharded_vi, mesh=mesh, shard="data", factors="sharded")))
        # one kernel call's inputs on this rank's rows, for the parent to hold
        hold = _path_plate_call(calls, VI_PLATE_MC, f"two_ranks vi rank {rank}")
        calls.clear()
        res.update({f"hold_{k}": t.cpu().numpy() for k, t in zip(("y", "mu", "sigma"), hold)})
        res.update(vi_loc=np.array([v.params[a][k].item() for a in ("mu", "sigma")
                                    for k in ("loc", "raw_scale")]))
        res["walls"] = np.array([walls[k] for k in ("hmc", "smc", "vi")])
        res["host_staged"] = np.array([staged_reads[k] for k in ("hmc", "smc", "vi")])
        np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    finally:
        torch.distributed.destroy_process_group()


TWO_RANKS_HMC = (60, 60)  # warmup, samples (cut from 100 + 100, PERF.md §4)


def _ring_exchange_ms(particles, mesh, reps: int = 20):
    """Median ms of one ring gather of this rank's block of ``particles``
    (every site) by random global ancestors, synchronised on both sides;
    every rank calls it together."""
    from fugue_tpu_torch.inference.smc import _ring_gather
    from fugue_tpu_torch.parallel.mesh import ShardLayout

    shard = ShardLayout.of(mesh)
    n = next(iter(particles.values())).shape[0]
    rows = shard.rows(shard.split(n, "particles"))
    local = {a: v[rows].contiguous() for a, v in particles.items()}
    g = torch.Generator(device="cuda").manual_seed(4)
    times = []
    for _ in range(reps):
        anc = torch.randint(0, n, (n,), generator=g, device="cuda")[rows]
        torch.cuda.synchronize()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        _ring_gather(local, anc, shard)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def phase_two_ranks():
    """Two processes on the one card, one gloo rank each, running
    ``two_ranks_worker``; both must return the same global results, and
    the single-device phases' posterior gates hold for them."""
    import subprocess
    import tempfile
    from types import SimpleNamespace

    from fugue_tpu_torch.ops import kernels as K

    port = _free_port()
    with tempfile.TemporaryDirectory(dir=REPO) as out:
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--two-ranks-worker",
                                   f"{r},2,{port},{out}"],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        texts = []
        try:
            for p in procs:
                texts.append(p.communicate(timeout=TWO_RANKS_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for r, (p, text) in enumerate(zip(procs, texts)):
            check(p.returncode == 0, f"two_ranks: rank {r} exited {p.returncode}:\n{text[-4000:]}")
        ranks = [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(2)]
    holds = []
    for r, rank in enumerate(ranks):
        y, mu, sigma = (torch.as_tensor(rank[f"hold_{k}"], device="cuda")
                        for k in ("y", "mu", "sigma"))
        check(y.numel() == MAIN_SHAPE[1] // 2 and y.dtype == torch.float32,
              f"two_ranks vi rank {r}: the kernel saw {y.numel()} rows of {y.dtype}")
        holds.append(_hold_path_plate(K, y, mu, sigma, f"two_ranks vi rank {r}"))
    same = {k: bool(np.array_equal(ranks[0][k], ranks[1][k])) for k in ranks[0]
            if k not in ("walls", "host_staged", "ring_ms") and not k.endswith("_launches")
            and not k.startswith("hold_")}
    r0 = ranks[0]
    n_warmup, n_samples = TWO_RANKS_HMC
    hres = SimpleNamespace(samples={"mu": torch.as_tensor(r0["hmc_mu"]),
                                    "tau": torch.as_tensor(r0["hmc_tau"])},
                           divergences=torch.as_tensor(r0["hmc_div"]),
                           step_size=float(r0["hmc_eps"]))
    post = _eight_schools_posterior(hres, 1024, n_samples, "two_ranks mu")
    log_z, stages, beta, smc_mu, wsum = r0["smc_scalars"].tolist()
    ref = SMC_MU["mh"]
    mcse = math.hypot(ref["MU_RUN_SD"], ref["MU_RUN_SD"] / math.sqrt(SMC_MU_RUNS))
    loc = r0["vi_loc"]
    stats = vi_plate_stats({"mu": {"loc": loc[0], "raw_scale": loc[1]},
                            "sigma": {"loc": loc[2], "raw_scale": loc[3]}},
                           plate_numpy_data(MAIN_SHAPE[1]))
    row = {"phase": "two_ranks", "card": card_line(), "backend": "gloo", "ranks": 2,
           "wall_s": wall, "walls_per_rank": {k: [float(r["walls"][i]) for r in ranks]
                                              for i, k in enumerate(("hmc", "smc", "vi"))},
           "hmc_ms_per_transition": [1e3 * float(r["walls"][0]) / (n_warmup + n_samples)
                                     for r in ranks],
           "vi_ms_per_iteration": [1e3 * float(r["walls"][2])
                                   / (VI_PLATE_SEGMENTS * VI_PLATE_ITERATIONS) for r in ranks],
           "ms_per_ring_gather": [float(r["ring_ms"]) for r in ranks],
           "gloo_host_staged_reads": {k: [int(r["host_staged"][i]) for r in ranks]
                                      for i, k in enumerate(("hmc", "smc", "vi"))},
           "identical_on_both_ranks": same, "hmc": post, "smc_log_evidence": log_z,
           "smc_stages": stages, "smc_mu_mean": smc_mu,
           "smc_mu_z": (smc_mu - ref["MU_MEAN"]) / mcse, "vi": stats,
           "vi_kernel_vs_plain_on_a_call_per_rank": holds,
           "launches": {k: {"nll": [int(r[f"{k}_launches"][0]) for r in ranks],
                            "lse": [int(r[f"{k}_launches"][1]) for r in ranks],
                            "resample": [int(r[f"{k}_launches"][2]) for r in ranks]}
                        for k in ("hmc", "smc", "vi")}}
    emit(row)
    check(all(same.values()), f"two_ranks: results differ between the ranks: {same}")
    check(post["split_rhat_mu"] < 1.02 and post["divergence_rate"] < 0.02
          and abs(post["mu_z"]) < 5.0, f"two_ranks hmc: {post}")
    check(beta == 1.0 and abs(wsum - 1.0) < 1e-4 and abs(row["smc_mu_z"]) < 5.0,
          f"two_ranks smc: beta {beta}, weights {wsum}, mu z {row['smc_mu_z']}")
    s = int(stages)
    for r in ranks:
        _, lse, resample = (int(x) for x in r["smc_launches"])
        check(lse == 4 * s + 3 and resample == s - 1,
              f"two_ranks smc launches: {lse} logsumexp, {resample} resample, {s} stages")
        # one call per iteration, and one per segment: each segment stages
        # the model on the rank's rows (one discovery run)
        nll = int(r["vi_launches"][0])
        check(nll == VI_PLATE_SEGMENTS * (VI_PLATE_ITERATIONS + 1),
              f"two_ranks vi: {nll} plate kernel calls")
    for k, v in stats.items():
        _within(v, VI_PLATE[k], VI_REF_RUNS["plate"], f"two_ranks vi {k}")
    return {"nll": sum(int(r["vi_launches"][0]) + int(r["hmc_launches"][0]) for r in ranks),
            "lse": sum(int(r["smc_launches"][1]) for r in ranks),
            "resample": sum(int(r["smc_launches"][2]) for r in ranks)}


def phase_serve_sharded():
    """``hmc.sharded`` over HTTP on the DSL coin flip (the service's
    one-rank NCCL chain mesh): the posterior mean, sd and split-R-hat
    against Beta(20, 11); ``vi.run``'s summaries read to the host once
    (its host syncs against the same optimization called directly); and a
    sharded checkpoint of a sharded HMC state, restored into its template,
    resuming bitwise."""
    import tempfile
    from types import SimpleNamespace

    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.parallel import sharded_hmc_chain
    from fugue_tpu_torch.parallel.mesh import chain_sharded
    from fugue_tpu_torch.runtime.checkpoint import load_checkpoint_sharded, save_checkpoint_sharded

    mesh = _nccl_mesh()
    heads = sum(COIN_FLIPS)
    a, b = 2 + heads, 2 + len(COIN_FLIPS) - heads
    p_exact, p_sd = a / (a + b), math.sqrt(a * b / ((a + b) ** 2 * (a + b + 1)))
    n_chains = 256
    row = {"phase": "serve_sharded", "card": card_line()}
    with Rpc() as rpc:
        mid = rpc("compile", source=COIN_DSL, data={"flips": COIN_FLIPS})["model_id"]
        t0 = time.perf_counter()
        out = rpc("hmc.sharded", model_id=mid, n_chains=n_chains, n_samples=25, n_warmup=25)
        p = out["summaries"]["p"]
        row["hmc_sharded"] = {"wall_s": time.perf_counter() - t0, "n_devices": out["n_devices"],
                              "n_chains": out["n_chains"], "step_size": out["step_size"],
                              "mean": p["mean"][0], "sd": p["sd"][0], "r_hat": p["r_hat"][0],
                              "mean_z_one_draw_per_chain":
                                  (p["mean"][0] - p_exact) / (p_sd / math.sqrt(n_chains))}
        check(out["n_devices"] == 1 and out["n_chains"] == n_chains, f"hmc.sharded: {out}")
        check(abs(row["hmc_sharded"]["mean_z_one_draw_per_chain"]) < 5.0
              and abs(p["sd"][0] / p_sd - 1.0) < 0.1 and p["r_hat"][0] < 1.05,
              f"hmc.sharded posterior: {row['hmc_sharded']}")

        # vi.run's summaries: one read over the optimization's own
        params = {"model_id": mid, "n_iterations": 200, "posterior_draws": 1024}
        _, _, staged = rpc.service._models[mid]
        cfg = ftt.VIConfig(n_iterations=200)

        def direct_run():
            return ftt.optimize_meanfield_vi(rpc.service._key(params, 8), staged=staged,
                                             config=cfg).posterior_sample(
                rpc.service._key(params, 9), 1024)

        direct_run()  # first use (lazy library set-up) outside the counts
        direct = _host_syncs(direct_run)
        served = rpc.host_reads("vi.run", **params)
        row["vi_run_host_reads"] = {"service": served, "direct": direct}
        check(served == direct + 1, f"vi.run: {served} host reads against {direct} direct + 1")

    # a sharded checkpoint of a sharded HMC state, resumed bitwise
    staged = ftt.stage(eight_schools_model("cuda"), device="cuda")
    res = sharded_hmc_chain(5, staged=staged, n_samples=20, n_warmup=40, n_chains=128,
                            config=ftt.HMCConfig(n_leapfrog=8), mesh=mesh)
    state = {"final_positions": chain_sharded(res.final_positions, mesh),
             "step_size": res.step_size, "inv_mass": res.inv_mass}
    template = {"final_positions": chain_sharded(torch.zeros_like(res.final_positions), mesh),
                "step_size": 0.0, "inv_mass": torch.zeros_like(res.inv_mass)}
    with tempfile.TemporaryDirectory(dir=REPO) as d:
        save_checkpoint_sharded(os.path.join(d, "hmc"), state)
        back = load_checkpoint_sharded(os.path.join(d, "hmc"), template)
    restored = SimpleNamespace(final_positions=back["final_positions"].full_tensor(),
                               step_size=back["step_size"], inv_mass=back["inv_mass"])
    runs = [ftt.hmc_chain(9, staged=staged, n_samples=20, n_chains=128, resume=r,
                          config=ftt.HMCConfig(n_leapfrog=8)) for r in (res, restored)]
    row["checkpoint"] = {"resumed_bitwise": bool(torch.equal(runs[0].positions,
                                                             runs[1].positions)),
                         "placements": str(back["final_positions"].placements)}
    emit(row)
    check(row["checkpoint"]["resumed_bitwise"], "serve_sharded: the restored checkpoint "
          "does not resume as the original state")


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
    ap.add_argument("--two-ranks-worker", metavar="RANK,WORLD,PORT,OUT",
                    help="run one rank of the two_ranks phase (the phase starts these)")
    args = ap.parse_args(argv)
    if args.two_ranks_worker:
        rank, world, port, out = args.two_ranks_worker.split(",", 3)
        two_ranks_worker(int(rank), int(world), int(port), out)
        return 0
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    import fugue_tpu_torch  # noqa: F401  (fails outside a checkout)

    started = time.perf_counter()
    walls = {}  # seconds per phase, for the smoke's time budget

    def run(name, fn, *args):
        """``fn(*args)`` when phase ``name`` was asked for, timed; else None."""
        if name not in phases:
            return None
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        emit({"phase_seconds": {name: walls[name]}})
        return out

    smc_launches = {"lse": 0, "resample": 0}

    def add_smc(launches):
        if launches is not None:
            _add_launches(smc_launches, launches)

    run("build", phase_build)
    kernel_rows = run("kernel", phase_kernel)
    eight_schools_run = run("eight_schools", phase_eight_schools)
    launches = run("gaussian_plate", phase_gaussian_plate)
    smc_rows = run("smc_kernels", phase_smc_kernels)
    add_smc(run("smc", phase_smc))
    run("nuts_eight_schools", phase_nuts_eight_schools)
    nuts_launches = run("nuts_plate", phase_nuts_plate)
    for name, phase in (("smc_coin", phase_smc_coin), ("smc_mixture", phase_smc_mixture),
                        ("smc_discrete", phase_smc_discrete)):
        add_smc(run(name, phase))
    chees_rate = run("chees_eight_schools", phase_chees_eight_schools)
    chees_launches = run("chees_plate", phase_chees_plate)
    for name, phase in (("mh_coin", phase_mh_coin), ("mh_hierarchical", phase_mh_hierarchical),
                        ("vi_hierarchical", phase_vi_hierarchical)):
        run(name, phase)
    vi_launches = run("vi_plate", phase_vi_plate)
    run("vi_scale", phase_vi_scale)
    run("abc_rejection", phase_abc_rejection)
    add_smc(run("abc_smc", phase_abc_smc))
    logistic_run = run("logistic_scale", phase_logistic_scale)
    run("scale_nuts", phase_scale_nuts, logistic_run)
    logistic_run = None  # its design goes before scale_chees makes its own
    for name, phase in (("scale_chees", phase_scale_chees),
                        ("scale_densemass", phase_scale_densemass),
                        ("scale_plate", phase_scale_plate),
                        ("laplace_regression", phase_laplace_regression),
                        ("marginal_gmm", phase_marginal_gmm), ("gibbs_mixed", phase_gibbs_mixed),
                        ("ess_gp", phase_ess_gp), ("pt_bimodal", phase_pt_bimodal)):
        run(name, phase)
    run("loo_eight_schools", phase_loo_eight_schools, eight_schools_run)
    eight_schools_run = None
    add_smc(run("validation_conjugate", phase_validation_conjugate))
    for name, phase in (("sbc_normal", phase_sbc_normal),
                        ("mh_transdimensional", phase_mh_transdimensional)):
        run(name, phase)
    add_smc(run("serve_coin", phase_serve_coin))
    run("serve_eight_schools", phase_serve_eight_schools, chees_rate)
    add_smc(run("serve_pf", phase_serve_pf))
    sharded_launches = run("sharded_hmc", phase_sharded_hmc)
    add_smc(run("sharded_smc", phase_sharded_smc))
    sharded_vi_launches = run("sharded_vi_plate", phase_sharded_vi_plate)
    two_ranks_launches = run("two_ranks", phase_two_ranks)
    add_smc(two_ranks_launches)
    run("serve_sharded", phase_serve_sharded)
    if torch.distributed.is_initialized():  # the sharded phases' one-rank group
        torch.distributed.destroy_process_group()
    emit({"phase_seconds": walls, "main_seconds": time.perf_counter() - started,
          "profiler_sessions": TRACES})

    print(card_line(), flush=True)
    if set(phases) != set(PHASES):
        emit({"partial": phases})
        return 0

    def entry(name, key, source, row, n_launches):
        # the largest error of the kernel phase's row and of the holds on
        # the main path's own calls (PATH_HOLDS)
        return {"name": name, "route": "cuda", "source": f"fugue_tpu_torch/csrc/{source}.cu",
                "replaces": REPLACES[key], "launches": n_launches,
                "max_abs_err": max(row["kernel_vs_plain"], *PATH_HOLDS[key].values()),
                "ms": row["kernel_ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    emit({"kernel_vs_plain_on_main_path_calls": PATH_HOLDS})
    emit({"kernels": [
        # the plate kernel's calls on its paths: HMC, NUTS, ChEES and VI, and
        # the sharded HMC and NUTS, the sharded VI and the two ranks' HMC and VI
        entry("normal_loglik_sum_value_and_grad", "nll", "normal_loglik_sum",
              kernel_rows[MAIN_SHAPE],
              launches["nll"] + nuts_launches["nll"] + chees_launches["nll"]
              + vi_launches["nll"] + sharded_launches["nll"] + sharded_vi_launches["nll"]
              + two_ranks_launches["nll"]),
        # the SMC kernels' calls on their paths: the smc phase's three runs,
        # the coin (two runs), mixture and discrete phases, abc_smc, the
        # validation harness's smc adapter (two runs), the service's smc.run
        # (serve_coin) and pf.observe (serve_pf), the sharded SMC and the two
        # ranks' SMC (each rank's calls)
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
