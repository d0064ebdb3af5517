#!/usr/bin/env python3
"""The port's SMC ladder against the JAX package's, in distribution, on the CPU.

    python scripts/smc_cloud_check.py [--particles 8192] [--runs 300]

bench.py's 20-site hierarchical model, SMCConfig(rejuvenation_steps=3),
float64. Two experiments, one JSON line each:

- ``ladder``: ONE stage-0 prior cloud (the JAX package's, PRNGKey(0)); from
  it, ``--runs`` JAX ladders (keys PRNGKey(1000 + r)) and as many port
  ladders (generators seeded 1000 + r). Same distribution of the final
  weighted mean of mu means the two ladders agree.
- ``clouds``: for each source of the stage-0 cloud (torch's generator, as
  the port draws it; JAX's; numpy's), ``--runs`` clouds seeded r, each
  finished by the JAX ladder with PRNGKey(r). A difference here is a
  property of where the cloud's random numbers come from.

Needs JAX and the port; takes about 15 minutes at the defaults.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import bench  # noqa: E402
import fugue_tpu as ft  # noqa: E402
import fugue_tpu_torch as ftt  # noqa: E402
from chip_smoke import hierarchical_model  # noqa: E402
from fugue_tpu.inference.mcmc_utils import AdaptationState  # noqa: E402
from fugue_tpu.inference.smc import SMCConfig, SMCResult, adaptive_smc  # noqa: E402
from fugue_tpu_torch import settings  # noqa: E402
from fugue_tpu_torch.inference.smc import _density_parts  # noqa: E402
from fugue_tpu_torch.interop import smc_state_from_numpy  # noqa: E402

CFG = SMCConfig(rejuvenation_steps=3)
TCFG = ftt.SMCConfig(rejuvenation_steps=3)


def summary(xs):
    return {"mean": statistics.fmean(xs), "sd": statistics.stdev(xs),
            "se": statistics.stdev(xs) / len(xs) ** 0.5}


def jax_resume(js, n, lat, ll, key):
    """The JAX ladder from a stage-0 cloud (numpy latents and log-likelihoods)."""
    dt = jnp.float64
    adapt = AdaptationState.init(len(js.sites), CFG.initial_scale)
    state = ({a: jnp.asarray(v) for a, v in lat.items()}, jnp.zeros(n, dt),
             jnp.asarray(ll), jnp.zeros((), dt), jnp.zeros((), dt), adapt, key,
             jnp.zeros((), jnp.int32))
    start = SMCResult(particles=None, log_weights=None, weights=None, log_evidence=0.0,
                      n_stages=0, ess=0.0, state=state)
    return float(adaptive_smc(key, n, staged=js, config=CFG, resume=start).posterior_mean("mu"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--particles", type=int, default=8192)
    ap.add_argument("--runs", type=int, default=300)
    args = ap.parse_args()
    n, runs = args.particles, args.runs
    settings.enable_x64(True)
    js = ft.stage(bench.hierarchical_model)
    ts = ftt.stage(hierarchical_model("cpu", torch.float64), device="cpu")
    parts = _density_parts(ts)

    def torch_ll(lat):
        return parts({a: torch.as_tensor(np.array(v)) for a, v in lat.items()})[1].numpy()

    cloud0 = adaptive_smc(jax.random.PRNGKey(0), n, staged=js,
                          config=SMCConfig(rejuvenation_steps=3, max_stages=0)).state
    lat0 = {a: np.asarray(v) for a, v in cloud0[0].items()}
    ll0 = np.asarray(cloud0[2])
    jm, tm = [], []
    for r in range(runs):
        jm.append(jax_resume(js, n, lat0, ll0, jax.random.PRNGKey(1000 + r)))
        state = smc_state_from_numpy(
            lat0, np.zeros(n), ll0, 0.0, 0.0, np.full(len(ts.sites), np.log(0.5)),
            np.zeros(len(ts.sites)), 0, generator=torch.Generator().manual_seed(1000 + r),
            device="cpu", dtype=torch.float64)
        tm.append(ftt.adaptive_smc(0, n, staged=ts, config=TCFG, resume=state)
                  .posterior_mean("mu").item())
    print(json.dumps({"experiment": "ladder", "particles": n, "runs": runs,
                      "jax_ladder": summary(jm), "port_ladder": summary(tm)}), flush=True)

    def torch_cloud(r):
        lat = ts.sample_prior_batch(r, n)
        return {a: v.numpy() for a, v in lat.items()}

    def jax_cloud(r):
        lat = jax.vmap(js.sample_prior)(jax.random.split(jax.random.PRNGKey(r), n))
        return {a: np.asarray(v) for a, v in lat.items()}

    def numpy_cloud(r):
        rng = np.random.default_rng(r)
        mu = rng.normal(0.0, 2.0, n)
        lat = {"mu": mu, "tau": np.exp(rng.normal(0.0, 0.5, n)),
               "sigma": np.exp(rng.normal(0.0, 0.5, n))}
        lat.update({f"theta#{i}": mu + lat["tau"] * rng.normal(size=n)
                    for i in range(bench.N_GROUPS)})
        return lat

    out = {}
    for name, make in (("torch", torch_cloud), ("jax", jax_cloud), ("numpy", numpy_cloud)):
        ms = []
        for r in range(runs):
            lat = make(r)
            ms.append(jax_resume(js, n, lat, torch_ll(lat), jax.random.PRNGKey(r)))
        out[name] = summary(ms)
    print(json.dumps({"experiment": "clouds", "particles": n, "runs": runs,
                      "ladder": "jax", **out}), flush=True)


if __name__ == "__main__":
    main()
