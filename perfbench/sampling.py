"""Sampling traffic: a batch of chains of one of the port's drives,
``nuts_chain`` (the default asynchronous drive) or ``hmc_chain`` (fixed L),
as a user runs a posterior: set-up, warmup, then back-to-back resumed
calls. The drive is the workload's ``traffic`` in ``BENCHMARK.json``
("nuts" or "hmc"), whose file in ``traffic/`` takes these functions.

Cell parameters (``cells/<workload>.json``): ``chains``, ``warmup`` (transitions, in set-up), ``call_samples``
(transitions per window call), ``trace_samples`` (transitions of the traced
call), ``max_depth`` (NUTS), ``n_leapfrog`` and ``target_accept`` (HMC),
``mass`` ("diag", the default, or "dense"), ``map_iterations`` (L-BFGS iterations of the MAP the warmup starts from,
where the configuration asks for a MAP start), ``config_args`` (keyword
arguments of the configuration's ``build``, for tests at a small size).

Set-up: the data from the seed on the device, the staged model, the MAP
where asked, and one call of ``warmup`` warmup transitions and one
sampling transition, which runs every kernel the window runs. Window:
calls of ``call_samples`` transitions, each resuming the last, from the
window's start to the end of the first call that ends after ``--seconds``;
every call's seed derives from the run's. Off the clock: ``draws_per_s``
(transitions × chains over the window) and ``ess_per_s`` (the smallest
ESS over the constrained parameters of all the window's draws, over the
window).
"""

from __future__ import annotations

import contextlib
import time
import warnings
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import checks
from perfbench.harness import derived_seed
from perfbench.trace import spanned, traced


def _sync(run):
    if run.device != "cpu":
        torch.cuda.synchronize()


def engine(run) -> str:
    return run.workload["traffic"]


def _caller(run, staged):
    import fugue_tpu_torch as ftt

    c = run.cell
    if engine(run) == "nuts":
        cfg = ftt.NUTSConfig(max_depth=c["max_depth"], mass=c.get("mass", "diag"))
        return lambda seed, **kw: ftt.nuts_chain(seed, config=cfg, n_chains=c["chains"],
                                                 staged=staged, **kw)
    if engine(run) == "hmc":
        cfg = ftt.HMCConfig(n_leapfrog=c["n_leapfrog"], target_accept=c["target_accept"])
        return lambda seed, **kw: ftt.hmc_chain(seed, config=cfg, n_chains=c["chains"],
                                                staged=staged, **kw)
    raise ValueError(f"unknown drive {engine(run)!r}")


def setup(run):
    import fugue_tpu_torch as ftt

    c = run.cell
    problem = run.config.build(derived_seed(run.seed, 1), run.device, **c.get("config_args", {}))
    staged = ftt.stage(problem.model_fn, device=run.device)
    init = None
    if problem.map_init:
        m = ftt.map_estimate(derived_seed(run.seed, 2), staged=staged,
                             config=ftt.MAPConfig(n_iterations=c["map_iterations"],
                                                  optimizer="lbfgs", n_restarts=1))
        init = m.z
    call = _caller(run, staged)
    last = call(derived_seed(run.seed, 3), n_samples=1, n_warmup=c["warmup"], init_position=init)
    _sync(run)
    run.state = SimpleNamespace(problem=problem, staged=staged, call=call, last=last, results=[])


def window(run):
    s, c = run.state, run.cell
    k = 0
    ends = []
    t_start = time.perf_counter()
    while True:
        s.last = s.call(derived_seed(run.seed, 10, k), n_samples=c["call_samples"], n_warmup=0,
                        resume=s.last)
        _sync(run)
        s.results.append(s.last)
        k += 1
        ends.append(time.perf_counter() - t_start)
        if ends[-1] >= run.seconds:
            break
    run.window_s = ends[-1]
    run.counters["call_s"] = [b - a for a, b in zip([0.0] + ends, ends)]
    _after_window(run)


def _after_window(run):
    s, c = run.state, run.cell
    n_chains = c["chains"]
    s.positions = torch.cat([r.positions for r in s.results], dim=1)  # (C, n, d)
    n = s.positions.shape[1]
    s.constrained = torch.cat([checks.flat_constrained(r.samples, n_chains, r.positions.shape[1])
                               for r in s.results], dim=1)
    s.positions_np = s.positions.detach().cpu().double().numpy()
    constrained_np = s.constrained.detach().cpu().double().numpy()
    finite = [bool(torch.isfinite(r.positions).all()) for r in s.results]
    run.attempted, run.failed = len(s.results), finite.count(False)
    ess = checks.min_ess(constrained_np)
    if engine(run) == "nuts":
        leaves = sum(r.lockstep_leaves for r in s.results)
        chain_grads = sum(r.n_leapfrogs for r in s.results)
    else:
        leaves = n * (c["n_leapfrog"] + 1)
        chain_grads = n_chains * n * c["n_leapfrog"]
    run.e2e = {"draws_per_s": n_chains * n / run.window_s, "ess_per_s": ess / run.window_s}
    run.counters.update(transitions=n, batched_grads=leaves, chain_grads=chain_grads,
                        min_ess=ess, chains=n_chains)


@contextlib.contextmanager
def _patched(pairs):
    """Each (module, attribute, wrap) replaced by wrap(original) for the block."""
    saved = [(m, a, getattr(m, a)) for m, a, _ in pairs]
    try:
        for m, a, wrap in pairs:
            setattr(m, a, wrap(getattr(m, a)))
        yield
    finally:
        for m, a, orig in saved:
            setattr(m, a, orig)


def spans():
    """The benchmark's spans around calls into the drives' layers."""
    from fugue_tpu_torch.inference import hmc, nuts

    def force(real):
        return lambda potential_fn: spanned("pb.potential", real(potential_fn))

    return [(hmc, "batched_force", force), (nuts, "batched_force", force),
            (nuts._AsyncBuild, "iterate", lambda f: spanned("pb.nuts.iterate", f)),
            (hmc, "hmc_transition", lambda f: spanned("pb.hmc.transition", f)),
            (hmc, "constrain_positions", lambda f: spanned("pb.constrain", f)),
            (nuts, "constrain_positions", lambda f: spanned("pb.constrain", f))]


def count_syncs(fn):
    """(fn(), the synchronizing CUDA calls it made), counted by PyTorch's
    sync debugging in its warning mode."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def trace(run):
    """One more call of ``trace_samples`` transitions after the window, traced,
    with the benchmark's spans and the host syncs counted."""
    s, c = run.state, run.cell
    k = c["trace_samples"]
    with _patched(spans()):
        (res, syncs), tr = traced(lambda: count_syncs(
            lambda: s.call(derived_seed(run.seed, 20), n_samples=k, n_warmup=0, resume=s.last)))
    run.trace = tr
    leapfrogs = k * c["n_leapfrog"] if engine(run) == "hmc" else None
    run.counters["trace"] = {"transitions": k, "iterations": getattr(res, "lockstep_leaves", None),
                             "leapfrogs": leapfrogs, "host_syncs": syncs,
                             "grads": tr.calls.get("pb.potential", 0)}


def check(run):
    from fugue_tpu_torch.inference.hmc import batched_force

    s, c = run.state, run.cell
    rng = np.random.default_rng(derived_seed(run.seed, 30))
    n_chains, n = s.positions.shape[0], s.positions.shape[1]
    j = torch.as_tensor(checks.pick_draws(rng, n_chains, n), device=s.positions.device)
    rows = torch.arange(n_chains, device=s.positions.device)
    states = s.positions[rows, j]
    g, u = batched_force(s.staged.potential)(states)
    u_prog, g_prog = u.detach().cpu().double(), g.detach().cpu().double()
    constrained = s.constrained[rows, j].detach().cpu().double()
    states64 = states.detach().double()
    data, positions_np = s.problem.data, s.positions_np
    # the program's state goes before the reference runs
    run.state = SimpleNamespace(problem=s.problem)
    del s, g, u
    if run.device != "cpu":
        torch.cuda.empty_cache()
    ref = run.reference
    nums = checks.density_numbers(ref, data, states64, u_prog, g_prog)
    nums["draw_gap"] = checks.draw_gap(ref, states64, constrained)
    nums.update(checks.chain_numbers(positions_np, *ref.posterior(data)))
    run.check_inputs = (ref, data, states64)
    return nums
