#!/usr/bin/env python3
"""The JAX package's VI and ABC results at chip_smoke.py's VI and ABC phases.

    python scripts/vi_abc_reference.py --phase vi_hierarchical --runs 16 --x32
    python scripts/vi_abc_reference.py --phase vi_plate --runs 32 --x32
    python scripts/vi_abc_reference.py --phase vi_scale --runs 4 --x32
    python scripts/vi_abc_reference.py --phase abc --runs 8

Runs fugue_tpu on the CPU in float64, seeds ``PRNGKey(0..runs-1)``, at the
exact configuration of each phase and on the same numpy data
(``chip_smoke.plate_numpy_data``, ``vi_scale_data``, ``abc_data``):

- ``vi_hierarchical``: bench_vi, mean-field Adam on bench.py's 20-site
  ``hierarchical_model``, 2,000 iterations of 128 MC samples, one chunk, no
  plateau stop. The final ELBO (mean of the last 200 iterations) and
  q(mu)'s loc.
- ``vi_plate``: mean-field VI on the 2^20-row plate (mu ~ N(0, 10), sigma ~
  LogNormal(0, 1), ``factor(pnormal_loglik_sum)``), 64 MC samples at lr
  0.05, ``chip_smoke.VI_PLATE_SEGMENTS`` segments of
  ``VI_PLATE_ITERATIONS`` iterations chained through ``resume=`` (segment i
  keyed ``fold_in(PRNGKey(seed), i)``): ``chip_smoke.vi_plate_stats``, q's
  locs and scales against the exact posterior in its sds.
- ``vi_scale``: bench_vi_scale at d = 512, N = 16,384: mean-field 3,000 x 8
  at lr 0.02, and full-rank 6 segments of ``chip_smoke.VI_SCALE_SEGMENT``
  iterations x 16 MC samples chained through ``resume=`` on the lr ladder
  ``chip_smoke.VI_SCALE_LADDER``; max |loc - post mean| / post sd for both,
  and the full-rank marginal sd ratio's range.
- ``abc``: bench_abc's rejection (eps 0.02, 4,096 samples, batch 2^17 x 16)
  and ABC-SMC (2,048 particles, eps (0.5, 0.2, 0.1, 0.05), batch 16,384)
  on the 64-observation simulator: means and sds against the exact
  posterior.

``--x32`` runs in float32, the card's dtype, instead: the VI phases' gates
take their constants from float32 runs. For each quantity it prints the
mean over runs and the run-to-run standard deviation (one run's
Monte-Carlo error), one JSON line per phase.
``chip_smoke.py`` pins these as constants. Needs JAX; the port does not.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
import chip_smoke  # noqa: E402
import fugue_tpu as ft  # noqa: E402
from fugue_tpu.inference.abc import ABCSMCConfig, abc_rejection, abc_smc_weighted  # noqa: E402
from fugue_tpu.inference.vi import (  # noqa: E402
    VIConfig, optimize_fullrank_vi, optimize_meanfield_vi)
from fugue_tpu.ops.pallas_kernels import pnormal_loglik_sum  # noqa: E402

PLATE_ROWS = 1 << 20


def vi_hierarchical(seed):
    staged = ft.stage(bench.hierarchical_model)
    cfg = VIConfig(n_iterations=2000, n_samples=128, plateau_window=10**9, check_every=2000)
    r = optimize_meanfield_vi(jax.random.PRNGKey(seed), staged=staged, config=cfg)
    return {"final_elbo": float(np.mean(r.elbo_history[-200:])),
            "mu_loc": float(r.params["mu"]["loc"])}


def vi_plate(seed):
    y_np = chip_smoke.plate_numpy_data(PLATE_ROWS)
    y = jnp.asarray(y_np)

    def plate():
        mu = ft.sample("mu", ft.Normal(0.0, 10.0))
        sigma = ft.sample("sigma", ft.LogNormal(0.0, 1.0))
        ft.factor(pnormal_loglik_sum(y, mu, sigma))

    m = chip_smoke.VI_PLATE_ITERATIONS
    cfg = VIConfig(n_iterations=m, n_samples=64, learning_rate=0.05,
                   plateau_window=10**9, check_every=m)
    staged = ft.stage(plate)
    r = None
    for i in range(chip_smoke.VI_PLATE_SEGMENTS):
        r = optimize_meanfield_vi(jax.random.fold_in(jax.random.PRNGKey(seed), i),
                                  staged=staged, config=cfg, resume=r)
    return chip_smoke.vi_plate_stats(r.params, y_np)


def vi_scale(seed):
    X, y, L, pmean, psd = chip_smoke.vi_scale_data()
    d = X.shape[1]
    Lj = jnp.asarray(L)

    def model(Xd, yd):
        w = ft.sample("w", ft.MultivariateNormal(jnp.zeros(d), scale_tril=Lj))
        ft.observe("y", ft.Normal(Xd @ w, 1.0), yd)

    staged = ft.stage(model, jnp.asarray(X), jnp.asarray(y))
    cfg = VIConfig(n_iterations=3000, n_samples=8, plateau_window=10**9, check_every=3000,
                   learning_rate=0.02)
    r = optimize_meanfield_vi(jax.random.fold_in(jax.random.PRNGKey(seed), 0),
                              staged=staged, config=cfg)
    mf_err = float(np.max(np.abs(np.asarray(r.params["w"]["loc"]) - pmean) / psd))
    rf = None
    seg = chip_smoke.VI_SCALE_SEGMENT
    for si, lr in enumerate(chip_smoke.VI_SCALE_LADDER):
        cfg_s = VIConfig(n_iterations=seg, n_samples=16, plateau_window=10**9,
                         check_every=seg, learning_rate=lr)
        rf = optimize_fullrank_vi(jax.random.fold_in(jax.random.PRNGKey(seed), 1 + si),
                                  staged=staged, config=cfg_s, resume=rf)
    fr_err = float(np.max(np.abs(np.asarray(rf.params["loc"]) - pmean) / psd))
    ratio = np.sqrt(np.diag(np.asarray(rf.guide.covariance(rf.params)))) / psd
    return {"mf_err": mf_err, "fr_err": fr_err, "fr_sd_ratio_min": float(ratio.min()),
            "fr_sd_ratio_max": float(ratio.max())}


def abc(seed):
    obs_np = chip_smoke.abc_data()
    obs = jnp.asarray(obs_np)
    n_obs = obs_np.size
    post_m, post_sd = chip_smoke.abc_posterior(obs_np)

    def sim():
        mu = ft.sample("mu_p", ft.Normal(0.0, 2.0))
        return ft.sample("xs", ft.Normal(mu, 1.0), sample_shape=(n_obs,))

    staged = ft.stage(sim)

    def dist(a, b):
        return jnp.abs(jnp.mean(a) - jnp.mean(b))

    key = jax.random.PRNGKey(seed)
    res = abc_rejection(jax.random.fold_in(key, 0), staged=staged, observed=obs, distance=dist,
                        epsilon=0.02, n_samples=4096, batch_size=1 << 17, inner_batches=16,
                        max_attempts=1 << 26)
    ps = np.asarray(res.particles["mu_p"])
    rs = abc_smc_weighted(
        jax.random.fold_in(key, 1), staged=staged, observed=obs, distance=dist,
        config=ABCSMCConfig(n_particles=2048, epsilons=(0.5, 0.2, 0.1, 0.05),
                            batch_size=16384, max_attempts_per_stage=1 << 22),
        param_addresses=("mu_p",))
    w = np.exp(np.asarray(rs.log_weights))
    w = w / w.sum()
    x = np.asarray(rs.particles["mu_p"])
    wm = float((w * x).sum())
    return {"rejection_mean_z": (ps.mean() - post_m) / (post_sd / np.sqrt(ps.size)),
            "rejection_sd_ratio": float(ps.std()) / post_sd,
            "rejection_attempts": int(res.n_attempts),
            "smc_weighted_mean_z": (wm - post_m) / (post_sd / np.sqrt(1.0 / (w * w).sum())),
            "smc_ess": float(1.0 / (w * w).sum()), "smc_attempts": int(rs.n_attempts)}


PHASES = {"vi_hierarchical": vi_hierarchical, "vi_plate": vi_plate, "vi_scale": vi_scale,
          "abc": abc}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=sorted(PHASES), required=True)
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--x32", action="store_true", help="float32 instead of float64")
    args = ap.parse_args()
    jax.config.update("jax_enable_x64", not args.x32)
    t0 = time.perf_counter()
    rows = []
    for seed in range(args.runs):
        rows.append(PHASES[args.phase](seed))
        print(json.dumps({"seed": seed, **rows[-1]}), file=sys.stderr, flush=True)
    out = {"phase": args.phase, "runs": args.runs, "x64": not args.x32,
           "seconds": time.perf_counter() - t0}
    for k in rows[0]:
        vals = [r[k] for r in rows]
        out[k] = {"MEAN": statistics.fmean(vals),
                  "RUN_SD": statistics.stdev(vals) if len(vals) > 1 else None}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
