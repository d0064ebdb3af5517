"""SMC traffic: back-to-back whole runs of ``adaptive_smc`` from the prior
(β 0 → 1), as a user estimates a posterior and its evidence.

Cell parameters (``cells/<workload>.json``): ``chains`` (the particles of
a run, under the key ``step.mfu`` reads), ``rejuvenation``,
``rejuvenation_steps``, ``hmc_leapfrog``, ``ess_threshold`` and
``resampling`` (``SMCConfig``), ``min_runs`` (the fewest runs a window
holds, so that their spread exists), ``check_particles`` (the particles
the density is checked at), ``reference_draws`` (the reference's
importance sample), ``config_args`` (keyword arguments of the
configuration's ``build``, for tests at a small size).

Set-up: the data on the device, the staged model, and one untimed whole
run, which builds the CUDA kernels and pays torch's lazy imports. Window:
whole runs, each on a seed derived from the run's, from the window's start
to the end of the first run that ends after ``--seconds`` (and at least
``min_runs``). Off the clock: ``draws_per_s`` (particles of the window's
runs over the window).

Check (after the window, the program's state freed before the reference
runs): ``u_gap``, ``g_gap`` and ``draw_gap`` (``checks``) at
``check_particles`` particles of the last run picked by the seed, at
β = 1; ``mean_z``: the largest over mu_1, mu_2, sigma_1, sigma_2 and theta
of |the mean of the runs' weighted posterior means − the reference's|, in
standard errors sqrt(s² / runs + the reference's own error variance);
``logz_z`` the same for log Z; ``unconverged_share``: the share of runs
that stopped short of β = 1.

s² is the runs' sample variance, but never less than the variance that
one run's weights imply alone (a floor, since a window holds few runs and
two or three of them can agree by chance): for a mean the weighted
variance of the particles over the final weights' ESS, for log Z the
stages over N (each stage's increment is estimated at the ladder's target
ESS, N / 2, so with a relative variance of about 1 / N).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import checks
from perfbench.harness import derived_seed
from perfbench.sampling import _patched
from perfbench.trace import spanned, traced


def _sync(run):
    if run.device != "cpu":
        torch.cuda.synchronize()


def _smc_config(c):
    import fugue_tpu_torch as ftt

    return ftt.SMCConfig(rejuvenation=c["rejuvenation"],
                         rejuvenation_steps=c["rejuvenation_steps"],
                         hmc_leapfrog=c["hmc_leapfrog"], ess_threshold=c["ess_threshold"],
                         resampling=c["resampling"])


def setup(run):
    import fugue_tpu_torch as ftt

    c = run.cell
    problem = run.config.build(derived_seed(run.seed, 1), run.device, **c.get("config_args", {}))
    staged = ftt.stage(problem.model_fn, device=run.device)
    cfg = _smc_config(c)

    def call(seed):
        return ftt.adaptive_smc(seed, c["chains"], config=cfg, staged=staged)

    call(derived_seed(run.seed, 3))
    _sync(run)
    run.state = SimpleNamespace(problem=problem, staged=staged, call=call, results=[])


def _kept(res):
    """What the check reads of a run: its particles and weights (on the
    device), log Z, β and stages."""
    return SimpleNamespace(particles=res.particles, weights=res.weights, ess=res.ess,
                           log_evidence=res.log_evidence, beta=res.beta, n_stages=res.n_stages)


def window(run):
    s, c = run.state, run.cell
    ends = []
    t_start = time.perf_counter()
    while True:
        res = s.call(derived_seed(run.seed, 10, len(ends)))
        _sync(run)
        s.results.append(_kept(res))
        ends.append(time.perf_counter() - t_start)
        if ends[-1] >= run.seconds and len(ends) >= c.get("min_runs", 2):
            break
    run.window_s = ends[-1]
    run.counters["call_s"] = [b - a for a, b in zip([0.0] + ends, ends)]
    runs = s.results
    moves = sum(r.n_stages - 1 for r in runs) * c["rejuvenation_steps"]
    grads = moves * (c["hmc_leapfrog"] + 1) if c["rejuvenation"] == "hmc" else 0
    run.attempted = len(runs)
    run.failed = sum(not np.isfinite(r.log_evidence) for r in runs)
    run.e2e = {"draws_per_s": c["chains"] * len(runs) / run.window_s}
    run.counters.update(runs=len(runs), stages=[r.n_stages for r in runs], batched_grads=grads,
                        chains=c["chains"])


def trace(run):
    """One more whole run after the window, traced, with the benchmark's
    range around each batched gradient."""
    from fugue_tpu_torch.inference import hmc

    s = run.state

    def force(real):
        return lambda potential_fn: spanned("pb.potential", real(potential_fn))

    with _patched([(hmc, "batched_force", force)]):
        res, tr = traced(lambda: s.call(derived_seed(run.seed, 20)))
    run.trace = tr
    run.counters["trace"] = {"runs": 1, "stages": res.n_stages,
                             "grads": tr.calls.get("pb.potential", 0)}


def _flat(particles, staged):
    """(S, k) constrained values in site order."""
    return torch.cat([particles[site.address].reshape(particles[site.address].shape[0], -1)
                      for site in staged.continuous_sites], dim=1)


def check(run):
    from torch.func import vmap

    from fugue_tpu_torch.inference.hmc import batched_force

    s, c = run.state, run.cell
    staged, data = s.staged, s.problem.data
    last = s.results[-1]
    n = last.weights.shape[0]
    rng = np.random.default_rng(derived_seed(run.seed, 30))
    rows = torch.as_tensor(rng.choice(n, size=min(c["check_particles"], n), replace=False),
                           device=last.weights.device)
    latents = {a: v[rows] for a, v in last.particles.items()}
    states = vmap(staged.unconstrain)(latents)
    g, u = batched_force(staged.potential)(states)
    u_prog, g_prog = u.detach().cpu().double(), g.detach().cpu().double()
    constrained = _flat(latents, staged).detach().cpu().double()
    states64 = states.detach().double()
    means, floor = [], []
    for r in s.results:
        w, x = r.weights.double(), _flat(r.particles, staged).double()
        m = w @ x
        means.append(m)
        floor.append((w @ (x - m) ** 2) / r.ess)
    means, floor = torch.stack(means).cpu().numpy(), torch.stack(floor).cpu().numpy()
    log_z = np.array([r.log_evidence for r in s.results], np.float64)
    floor_z = np.array([r.n_stages / n for r in s.results], np.float64)
    betas = np.array([r.beta for r in s.results], np.float64)
    # the program's state goes before the reference runs
    run.state = SimpleNamespace(problem=s.problem)
    del s, last, latents, g, u
    if run.device != "cpu":
        torch.cuda.empty_cache()
    ref = run.reference
    nums = checks.density_numbers(ref, data, states64, u_prog, g_prog)
    nums["draw_gap"] = checks.draw_gap(ref, states64, constrained)
    post = ref.posterior(data, draws=c["reference_draws"], device=run.device)
    r = len(log_z)
    s2 = np.maximum(np.var(means, axis=0, ddof=1), floor.mean(axis=0))
    se = np.sqrt(s2 / r + post["mean_err_var"].numpy())
    nums["mean_z"] = float(np.max(np.abs(means.mean(axis=0) - post["mean"].numpy()) / se))
    s2_z = max(float(np.var(log_z, ddof=1)), float(floor_z.mean()))
    nums["logz_z"] = float(abs(log_z.mean() - post["log_z"]) / np.sqrt(s2_z / r
                                                                        + post["log_z_err_var"]))
    nums["unconverged_share"] = float(np.mean(betas < 1.0))
    run.check_inputs = (ref, data, states64)
    return nums
