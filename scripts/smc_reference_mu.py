#!/usr/bin/env python3
"""The JAX package's posterior mean of mu under adaptive SMC, for chip_smoke.

    python scripts/smc_reference_mu.py [--runs 48]

Runs fugue_tpu's ``adaptive_smc`` on the CPU in float64 on bench.py's
20-site ``hierarchical_model`` at 131,072 particles, with the two
configurations of ``chip_smoke.py``'s SMC phase (bench_smc's MH moves and
bench_smc_hmc's HMC moves), seeds ``PRNGKey(0..runs-1)``. For each it prints
one JSON line: the mean over runs of the weighted posterior mean of mu, the
run-to-run standard deviation (the Monte-Carlo error of ONE run, which the
smoke's gate uses), the standard error of the mean, and the stage counts.
Needs JAX; the port does not.
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

import bench  # noqa: E402
import fugue_tpu as ft  # noqa: E402
from fugue_tpu.inference.smc import SMCConfig, adaptive_smc  # noqa: E402

N_PARTICLES = 131072
CONFIGS = {
    "mh": SMCConfig(rejuvenation_steps=3),
    "hmc": SMCConfig(rejuvenation="hmc", rejuvenation_steps=1, hmc_leapfrog=16),
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=48)
    args = ap.parse_args()
    staged = ft.stage(bench.hierarchical_model)
    for name, cfg in CONFIGS.items():
        t0 = time.perf_counter()
        means, stages = [], []
        for i in range(args.runs):
            res = adaptive_smc(jax.random.PRNGKey(i), N_PARTICLES, staged=staged, config=cfg)
            means.append(float(res.posterior_mean("mu")))
            stages.append(int(res.n_stages))
        sd = statistics.stdev(means)
        print(json.dumps({
            "rejuvenation": name, "particles": N_PARTICLES, "runs": args.runs,
            "mu_mean": statistics.fmean(means), "mu_run_sd": sd,
            "mu_mean_se": sd / args.runs ** 0.5, "stages": stages,
            "seconds": time.perf_counter() - t0,
        }), flush=True)


if __name__ == "__main__":
    main()
