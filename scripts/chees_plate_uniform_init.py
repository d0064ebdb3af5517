#!/usr/bin/env python3
"""How many ChEES chains stay stuck on the Gaussian plate from the uniform init, in both packages.

    python3 scripts/chees_plate_uniform_init.py [--rows 16384,131072] [--seeds 2]

chip_smoke.py's plate model (mu ~ N(0, 10), sigma ~ LogNormal(0, 1), rows
from N(1.5, 2^2)) through the JAX package's chees_chain and the port's, on
the CPU in float64: 64 chains from z ~ U(-2, 2)^2, 200 warmup + 200
samples, ChEESConfig(target_accept=...) at 0.651 and 0.8. ChEES shares one
step size over the batch and has no chain rescue, so a chain that starts
where that step size diverges (small sigma, mu far from the data: the
curvature grows as N / sigma^2) rejects every proposal. A chain counts as
stuck when its final mu is more than 0.1 from the data mean. One JSON line
per run. Imports JAX (the reference); the runs take a few minutes.
"""

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import fugue_tpu_torch as ftt  # noqa: E402
import torch_parity_models as models  # noqa: E402
from fugue_tpu.inference import chees as jchees  # noqa: E402
from fugue_tpu_torch import settings  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="16384,131072")
    ap.add_argument("--seeds", type=int, default=2)
    args = ap.parse_args(argv)
    settings.enable_x64(True)
    for n in (int(r) for r in args.rows.split(",")):
        js, ts = models.plate_pair(n)
        ybar = models.plate_data(n).mean()
        for target in (0.651, 0.8):
            for seed in range(args.seeds):
                jres = jchees.chees_chain(jax.random.PRNGKey(seed), staged=js, n_samples=200,
                                          n_warmup=200, n_chains=64,
                                          config=jchees.ChEESConfig(target_accept=target))
                tres = ftt.chees_chain(seed, staged=ts, n_samples=200, n_warmup=200,
                                       n_chains=64, config=ftt.ChEESConfig(target_accept=target))
                for pkg, res in (("jax", jres), ("torch", tres)):
                    fp = np.asarray(res.final_positions)
                    print(json.dumps({
                        "package": pkg, "rows": n, "target_accept": target, "seed": seed,
                        "chains": 64, "stuck_chains": int(np.sum(np.abs(fp[:, 0] - ybar) > 0.1)),
                        "divergence_rate": float(np.mean(np.asarray(res.divergences))),
                        "step_size": float(res.step_size),
                        "trajectory_length": float(res.trajectory_length)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
