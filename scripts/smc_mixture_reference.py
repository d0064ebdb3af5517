#!/usr/bin/env python3
"""The JAX package's SMC posterior of the mixture example, for chip_smoke.

    python scripts/smc_mixture_reference.py [--runs 16]

Runs fugue_tpu's ``adaptive_smc`` on the CPU in float64 on the Gaussian
mixture of ``examples/mixture_models.py`` (its model and its 100 data
points) at 131,072 particles with 5 MH rejuvenation steps, the
configuration of ``chip_smoke.py``'s ``smc_mixture`` phase, seeds
``PRNGKey(0..runs-1)``. It prints one JSON line: for each of the weighted
posterior means of mu0, mu1 and w and the log-evidence, the mean over runs,
the run-to-run standard deviation (the Monte-Carlo error of ONE run, which
the smoke's gate uses) and the standard error of the mean; and the stage
counts. Needs JAX; the port does not.
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

import fugue_tpu as ft  # noqa: E402
from examples.mixture_models import gmm  # noqa: E402

N_PARTICLES = 131072
CONFIG = ft.SMCConfig(rejuvenation_steps=5)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=16)
    args = ap.parse_args()
    staged = ft.stage(gmm)
    t0 = time.perf_counter()
    values = {"mu0": [], "mu1": [], "w": [], "log_evidence": []}
    stages = []
    for i in range(args.runs):
        res = ft.adaptive_smc(jax.random.PRNGKey(i), N_PARTICLES, staged=staged, config=CONFIG)
        for site in ("mu0", "mu1", "w"):
            values[site].append(float(res.posterior_mean(site)))
        values["log_evidence"].append(float(res.log_evidence))
        stages.append(int(res.n_stages))
        print(json.dumps({"run": i, "stages": stages[-1],
                          **{k: v[-1] for k, v in values.items()}}), file=sys.stderr, flush=True)
    out = {"particles": N_PARTICLES, "runs": args.runs, "rejuvenation_steps": 5}
    for k, v in values.items():
        sd = statistics.stdev(v)
        out[k] = {"mean": statistics.fmean(v), "run_sd": sd, "mean_se": sd / args.runs ** 0.5}
    out.update(stages=stages, seconds=time.perf_counter() - t0)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
