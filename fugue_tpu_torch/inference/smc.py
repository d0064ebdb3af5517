"""Likelihood-tempered adaptive Sequential Monte Carlo.

The port of the single-device path of ``fugue_tpu/inference/smc.py``:
``SMCConfig``, ``SMCResult``, ``_next_beta``, ``adaptive_smc`` and
``importance_reweight``. The semantics are the reference's: prior particles
weighted by the tempered likelihood only (the prior cancels), an adaptive β
ladder chosen by ESS, an unbiased log-evidence increment per stage,
resampling only while β < 1 (no terminal resample), π_β-invariant
rejuvenation that leaves the weights alone, and the zero-rejuvenation
shortcut as one importance reweight.

How it is expressed in PyTorch:

- Particles are a dict of tensors with a leading (N,) dimension. Stage 0 is
  ONE batched prior run (``StagedModel.sample_prior_batch``); every density
  evaluation is one ``vmap`` replay of the model over all particles.
- The β ladder is a Python loop. Each stage reads β back to the host once,
  to decide whether to resample and whether to go on; everything else
  (weights, evidence, adaptation) stays on the device.
- Every (N,) weight reduction (evidence, normalisation, ESS) is
  ``ops.kernels.plogsumexp``, and the default resampler is
  ``ops.kernels.psystematic_resample``: CUDA kernels on the card.
  ``_next_beta``'s (64, N) candidate batch is plain tensor code.
- One ``torch.Generator`` on the device draws every random number after
  stage 0; its state is part of the carry (``SMCState``), so a run stopped
  at ``config.max_stages`` and resumed is bitwise the uninterrupted run.
- While a profiler session runs (``utils.profiling``) a run records the
  spans ``smc.run`` ⊃ ``smc.stage`` ⊃ ``smc.reweight`` (the β search and
  the log-evidence increment), ``smc.resample`` (the ancestors and the
  particles' gather) and ``smc.move`` (the rejuvenation and the new
  likelihoods, with HMC's ``potential`` spans inside), one ``smc.stage``
  count per stage, and its named host reads: ``smc.beta`` once per
  stage, ``smc.result`` once per run, ``smc.resume_beta`` on a resume.

With ``mesh=`` the particles split over the ranks of the mesh's chain
axis, and every rank runs the ladder on its block:

- per stage only the (N,) log-weight and log-likelihood vectors are
  all-gathered, and every rank runs ``plogsumexp`` and the resampler on
  the gathered N, so β, log Z, the stop test and the ancestors are the
  same on every rank (the resampler's generator is seeded alike on every
  rank and draws nothing else);
- a rank fetches its ancestors' particles over the bidirectional ring
  (``_ring_gather``): particle blocks move between neighbours and are
  never all-gathered during the ladder;
- stage 0 and the rejuvenation draw from generators folded with the
  rank's index, and the rejuvenation's acceptance mean reduces over the
  ranks;
- the result holds the global particles, gathered once at the end, on
  every rank; its ``state`` resumes on any layout.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

import torch
from torch.func import vmap

from .. import settings
from ..core.rng import fold_seed, site_seed
from ..ops import kernels as K
from ..ops.resampling import RESAMPLERS, effective_sample_size
from ..parallel.mesh import CHAIN_AXIS, ShardLayout, cross_mean, ring_exchange
from ..runtime.staging import StagedModel, stage
from ..utils import profiling
from .hmc import hmc_transition
from .mcmc_utils import AdaptationState, adapt_update
from .mh import MHState, mh_step

MAX_STAGES = 64  # safety net on the ladder's length
_REJUVENATION = ("mh", "hmc")


@dataclass(frozen=True)
class SMCConfig:
    ess_threshold: float = 0.5  # resample/temper when ESS < threshold * N
    rejuvenation_steps: int = 3
    # "mh": single-site MH moves; "hmc": gradient moves on the flat
    # unconstrained space (continuous models only)
    rejuvenation: str = "mh"
    hmc_leapfrog: int = 8
    resampling: str = "systematic"
    initial_scale: float = 0.5
    target_accept: float = 0.44
    # stop after this many TOTAL ladder stages (cumulative across resumed
    # runs) even if beta < 1; the result's ``state`` then continues the
    # ladder as ``resume=``. None -> run to beta = 1 (at most MAX_STAGES).
    max_stages: Optional[int] = None


@dataclass
class SMCState:
    """The carry between ladder stages: all a resumed run needs."""

    particles: Dict[str, Any]  # address -> (N, *site_shape)
    log_weights: Any  # (N,)
    log_likelihoods: Any  # (N,) log-likelihood + factors at β = 1
    beta: Any  # 0-dim tensor
    log_evidence: Any  # 0-dim tensor
    adapt: AdaptationState
    generator_state: Any  # torch.Generator.get_state() after the last stage
    stage: int
    # a sharded run's seed: its ranks' rejuvenation generators derive from it
    seed: Optional[int] = None


@dataclass
class SMCResult:
    """``particles`` have a leading particle dimension; ``weights`` are
    normalized."""

    particles: Dict[str, Any]
    log_weights: Any
    weights: Any
    log_evidence: float
    n_stages: int
    ess: float
    # inverse temperature reached (1.0 = the full posterior); < 1 when the
    # run stopped at config.max_stages
    beta: float = 1.0
    converged: bool = True
    state: Optional[SMCState] = None

    def _vals(self, address: str):
        vals = self.particles[str(address)].to(settings.real_dtype())
        w = self.weights.to(vals.dtype).reshape(self.weights.shape + (1,) * (vals.dim() - 1))
        return vals, w

    def posterior_mean(self, address: str):
        vals, w = self._vals(address)
        return torch.sum(w * vals, dim=0)

    def posterior_var(self, address: str):
        vals, w = self._vals(address)
        m = torch.sum(w * vals, dim=0)
        return torch.sum(w * (vals - m) ** 2, dim=0)


def _next_beta(beta, log_w, ll, target_ess):
    """The next inverse temperature β' in (β, 1]: the ESS of
    log_w + (β' − β)·ll meets ``target_ess``; 1 when the full jump keeps the
    ESS above it.

    ESS(β') does not increase with β', so a two-level grid search (64
    coarse candidates as one (64, N) batch, then 64 inside the chosen
    bracket) finds it to (1 − β)/64² in two batched reductions. The ladder
    only shapes efficiency: any schedule keeps the estimator unbiased."""
    G = 64
    dt, dev = log_w.dtype, log_w.device
    ar = torch.arange(1, G + 1, dtype=dt, device=dev)
    idx = torch.arange(G, device=dev)

    def ess_batch(bs):
        # (G,) candidate betas -> (G,) ESS values, one batched reduction
        lw = log_w[None, :] + (bs[:, None] - beta) * ll[None, :]
        m = torch.amax(lw, dim=1, keepdim=True)
        w = torch.exp(lw - m)
        s1 = torch.sum(w, dim=1)
        s2 = torch.sum(w * w, dim=1)
        return s1 * s1 / torch.clamp(s2, min=1e-38)

    def last_ok(grid, fallback):
        # the largest candidate still meeting the target (grid[0] if none)
        ok = ess_batch(grid) >= target_ess
        i = torch.amax(torch.where(ok, idx, -1)).clamp(min=0)
        return torch.where(torch.any(ok), grid.gather(0, i.reshape(1))[0], fallback)

    full = effective_sample_size(log_w + (1.0 - beta) * ll)
    lo1 = last_ok(beta + (1.0 - beta) * ar / G, beta)
    out = last_ok(lo1 + (1.0 - beta) / G * ar / G, lo1)
    out = torch.where(full >= target_ess, torch.ones_like(out), out)
    # guarantee ladder progress so the loop cannot stall short of 1
    return torch.clamp(torch.maximum(out, beta + 1e-4), max=1.0)


def _ring_gather(latents_local, ancestors, shard: ShardLayout):
    """This rank's particles of the GLOBAL ancestor indices ``ancestors``
    (n_local,), fetched over a bidirectional ring: the particle blocks
    travel between neighbours, ⌊D/2⌋ steps forward and ⌈D/2⌉ − 1 back for
    D ranks, and each block that arrives fills the slots whose ancestor it
    holds. No (N, ...) buffer exists on any rank."""
    n_local = ancestors.shape[0]
    block_of, pos = ancestors // n_local, ancestors % n_local
    keys = list(latents_local)

    def take_from(out, block, b):
        sel = block_of == b
        return {a: torch.where(sel.reshape(sel.shape + (1,) * (out[a].dim() - 1)),
                               block[a][pos], out[a]) for a in keys}

    out = take_from({a: torch.zeros_like(v) for a, v in latents_local.items()},
                    latents_local, shard.index)
    n, me = shard.size, shard.index
    fwd = bwd = [latents_local[a] for a in keys]
    for t in range(1, n // 2 + 1):
        fwd = ring_exchange(fwd, shard.group, forward=True)  # block me - t
        out = take_from(out, dict(zip(keys, fwd)), (me - t) % n)
        if t <= (n - 1) // 2:  # for even D the last backward block came forward
            bwd = ring_exchange(bwd, shard.group, forward=False)  # block me + t
            out = take_from(out, dict(zip(keys, bwd)), (me + t) % n)
    return out


def _particle_layout(mesh) -> ShardLayout:
    """The particles split over the chain axis (the first axis of a mesh
    without one)."""
    names = tuple(mesh.mesh_dim_names)
    return ShardLayout.of(mesh, (CHAIN_AXIS if CHAIN_AXIS in names else names[0],))


def _density_parts(staged: StagedModel) -> Callable:
    """Batched latents → (log prior (N,), log likelihood + factors (N,)) in
    one batched model replay. A likelihood that is undefined at a particle
    (NaN: a prior draw can give a normal scale of exactly 0, where the
    log-density is -inf + inf) scores -inf, outside the model's support, so
    that one particle cannot turn every weight, β and log Z into NaN."""
    dt = settings.real_dtype()

    def parts(latents):
        p = staged.log_density_parts(latents)
        # a model without observations scores its likelihood as 0.0
        ll = torch.as_tensor(p.log_likelihood + p.log_factors, dtype=dt, device=staged.device)
        return (torch.as_tensor(p.log_prior, dtype=dt, device=staged.device),
                torch.where(torch.isnan(ll), -math.inf, ll))

    return vmap(parts)


def _init_state(staged, config, seed, n, generator, shard=None) -> SMCState:
    """Stage 0: N prior particles in one batched run, weights 1/N (the
    prior cancels in the importance weight, so only the likelihood
    enters). A sharded run draws this rank's block from a folded seed."""
    dt = settings.real_dtype()
    dev = staged.device
    init_seed = site_seed(seed, "smc/init")
    if shard is not None:
        init_seed = fold_seed(init_seed, shard.seed_index)
    latents = staged.sample_prior_batch(init_seed, n)
    _, ll = _density_parts(staged)(latents)
    return SMCState(
        particles=latents,
        log_weights=torch.zeros((n,), dtype=dt, device=dev),
        log_likelihoods=ll,
        beta=torch.zeros((), dtype=dt, device=dev),
        log_evidence=torch.zeros((), dtype=dt, device=dev),
        adapt=AdaptationState.init(len(staged.sites), config.initial_scale, dtype=dt, device=dev),
        generator_state=generator.get_state(),
        stage=0,
        seed=None if shard is None else int(seed),
    )


def _rejuvenate_mh(staged, config, latents, adapt, beta, generator, group=None):
    """``rejuvenation_steps`` π_β-invariant single-site MH sweeps of all
    particles, with one proposal scale per site shared by the particles and
    adapted from their mean acceptance (over every rank's particles in a
    sharded run's ``group``)."""
    parts = _density_parts(staged)

    def tempered(lat):
        lp, ll = parts(lat)
        return lp + beta * ll

    n_sites = len(staged.sites)
    state = MHState(latents=latents, log_joint=tempered(latents), adapt=adapt)
    for _ in range(config.rejuvenation_steps):
        state, accepted = mh_step(staged, state, generator, False, config.target_accept,
                                  log_density_fn=tempered)
        acc_mean = cross_mean(torch.mean(accepted.to(adapt.log_scale.dtype)), group)
        ones = torch.full((n_sites,), 1.0 / n_sites, dtype=adapt.log_scale.dtype,
                          device=adapt.log_scale.device)
        adapt = adapt_update(adapt, ones, acc_mean, target=config.target_accept)
        state = MHState(latents=state.latents, log_joint=state.log_joint, adapt=adapt)
    return state.latents, adapt


def _rejuvenate_hmc(staged, config, latents, adapt, beta, generator, group=None):
    """``rejuvenation_steps`` π_β-invariant HMC moves on the flat
    unconstrained space; the step size (slot 0 of the adaptation state, as
    log ε) follows the particles' mean acceptance between moves."""
    def u_beta(z):
        p, logdet = staged.log_density_parts_unconstrained(z)
        return -(p.log_prior + logdet + beta * (p.log_likelihood + p.log_factors))

    z = vmap(staged.unconstrain)(latents)
    n, d = z.shape
    dt, dev = z.dtype, z.device
    inv_mass = torch.ones((d,), dtype=dt, device=dev)
    for _ in range(config.rejuvenation_steps):
        eps = torch.exp(adapt.log_scale[0])
        p = torch.randn((n, d), generator=generator, device=dev, dtype=dt)
        log_u = torch.log1p(-torch.rand((n,), generator=generator, device=dev, dtype=dt))
        z, info = hmc_transition(u_beta, z, p, log_u, eps, config.hmc_leapfrog, inv_mass)
        step = torch.zeros_like(adapt.log_scale)
        step[0] = 0.5 * (cross_mean(torch.mean(info.accept_prob), group) - 0.8)
        adapt = AdaptationState(log_scale=adapt.log_scale + step, t=adapt.t)
    return vmap(lambda zz: staged.constrain(zz)[0])(z), adapt


def _ladder(staged, config, state: SMCState, beta_f: float, n, generator,
            shard: Optional[ShardLayout] = None) -> SMCState:
    """Run ladder stages from ``state`` (whose β the host holds as
    ``beta_f``) until β = 1 or the stage cap. With a ``shard`` the state
    holds this rank's block of the particles (see the module docstring)."""
    resampler = RESAMPLERS[config.resampling]
    rejuvenate = _rejuvenate_hmc if config.rejuvenation == "hmc" else _rejuvenate_mh
    loglik = _density_parts(staged)
    target_ess = config.ess_threshold * n
    cap = MAX_STAGES if config.max_stages is None else min(MAX_STAGES, config.max_stages)
    group = None if shard is None else shard.group

    latents, log_w, ll = state.particles, state.log_weights, state.log_likelihoods
    beta, log_z, adapt, stage_i = state.beta, state.log_evidence, state.adapt, state.stage
    while beta_f < 1.0 and stage_i < cap:
        with profiling.span("smc.stage"):
            profiling.count("smc.stage")
            with profiling.span("smc.reweight"):
                # the (N,) vectors, gathered so that every rank computes the
                # same β, log Z and ancestors; the particles stay on their ranks
                lwg = log_w if shard is None else shard.gather(log_w)
                llg = ll if shard is None else shard.gather(ll)
                beta_new = _next_beta(beta, lwg, llg, target_ess)
                delta = beta_new - beta
                # unbiased log-evidence increment under the current normalized
                # weights: log Σ_i w̄_i exp(δ·ll_i)
                log_wbar = lwg - K.plogsumexp(lwg)
                log_z = log_z + K.plogsumexp(log_wbar + delta * llg)
                lw_all = lwg + delta * llg
                log_w = lw_all if shard is None else lw_all[shard.rows(log_w.shape[0])]
                beta_f = float(beta_new)  # the one read of β per stage
                profiling.host_read("smc.beta")
            if beta_f < 1.0:  # no terminal resample
                with profiling.span("smc.resample"):
                    idx = resampler(generator, lw_all)
                    if shard is None:
                        latents = {a: v[idx] for a, v in latents.items()}
                        rejuv_gen = generator
                    else:
                        idx = idx[shard.rows(log_w.shape[0])]
                        latents = _ring_gather(latents, idx, shard)
                        rejuv_gen = torch.Generator(device=log_w.device).manual_seed(
                            fold_seed(state.seed, 5, shard.seed_index, stage_i))
                    log_w = torch.zeros_like(log_w)
                with profiling.span("smc.move"):
                    if config.rejuvenation_steps > 0:
                        latents, adapt = rejuvenate(staged, config, latents, adapt, beta_new,
                                                    rejuv_gen, group)
                        ll = loglik(latents)[1]
                    else:
                        ll = llg[idx]
        beta, stage_i = beta_new, stage_i + 1
    return SMCState(latents, log_w, ll, beta, log_z, adapt, generator.get_state(), stage_i,
                    state.seed)


def _reweight(state: SMCState, n, shard=None) -> SMCState:
    """The zero-rejuvenation shortcut: one importance reweight by the full
    likelihood."""
    ll = state.log_likelihoods
    log_z = K.plogsumexp(ll if shard is None else shard.gather(ll)) - math.log(n)
    return SMCState(state.particles, ll, ll, torch.ones_like(state.beta), log_z,
                    state.adapt, state.generator_state, 1, state.seed)


def _local(state: SMCState, shard: ShardLayout) -> SMCState:
    """This rank's block of a global state (a resumed sharded run)."""
    rows = shard.rows(shard.split(state.log_weights.shape[0], "n_particles"))
    return SMCState({a: v[rows] for a, v in state.particles.items()},
                    state.log_weights[rows], state.log_likelihoods[rows], state.beta,
                    state.log_evidence, state.adapt, state.generator_state, state.stage,
                    state.seed)


def _global(state: SMCState, shard: ShardLayout) -> SMCState:
    """The global state from every rank's block: one gather per tensor."""
    return SMCState({a: shard.gather(v) for a, v in state.particles.items()},
                    shard.gather(state.log_weights), shard.gather(state.log_likelihoods),
                    state.beta, state.log_evidence, state.adapt, state.generator_state,
                    state.stage, state.seed)


def adaptive_smc(
    seed: int,
    n_particles: int,
    model_fn: Optional[Callable] = None,
    config: SMCConfig = SMCConfig(),
    *,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    device="cuda",
    resume: Optional[Union[SMCResult, SMCState]] = None,
    mesh=None,
) -> SMCResult:
    """Likelihood-tempered adaptive SMC with ``n_particles`` particles.

    ``seed`` seeds the stage-0 prior draw and one ``torch.Generator`` on the
    staged model's device, which draws every later random number. ``device``
    is used only when ``staged`` is not given.

    ``resume``: an ``SMCResult`` (or its ``state``) whose ladder stopped
    short of β = 1 at ``config.max_stages``. The run continues from that
    state, generator included, and is bitwise the uninterrupted run; the
    seed is then unused. ``log_evidence`` keeps accumulating.

    ``mesh``: a ``DeviceMesh``; every rank calls this with the same
    arguments, the particles split over the mesh's chain axis, and every
    rank returns the global result (see the module docstring)."""
    with profiling.span("smc.run"):
        if staged is None:
            staged = stage(model_fn, *model_args, device=device)
        if config.rejuvenation not in _REJUVENATION:
            raise ValueError(f"unknown rejuvenation {config.rejuvenation!r}; use 'mh' or 'hmc'")
        if config.resampling not in RESAMPLERS:
            raise ValueError(f"unknown resampling {config.resampling!r}; "
                             f"use one of {sorted(RESAMPLERS)}")
        if config.rejuvenation == "hmc" and staged.discrete_sites:
            raise ValueError("HMC rejuvenation requires continuous latents only; use "
                             "rejuvenation='mh' for models with discrete sites")
        n = int(n_particles)
        shard = None if mesh is None else _particle_layout(mesh)
        generator = torch.Generator(device=staged.device)
        if resume is not None:
            state = resume.state if isinstance(resume, SMCResult) else resume
            if state is None:
                raise ValueError("resume= needs an SMCResult carrying its state")
            if state.log_weights.shape[0] != n:
                raise ValueError(f"resume state holds {state.log_weights.shape[0]} particles; "
                                 f"this run is configured for {n}")
            if (shard is None) != (state.seed is None):
                raise ValueError("resume a sharded run with mesh=, an unsharded one without")
            generator.set_state(state.generator_state)
            beta_f = float(state.beta)
            profiling.host_read("smc.resume_beta")
            if shard is not None:
                state = _local(state, shard)
        else:
            generator.manual_seed(int(seed))
            n_init = n if shard is None else shard.split(n, "n_particles")
            state = _init_state(staged, config, seed, n_init, generator, shard)
            beta_f = 0.0

        if config.rejuvenation_steps == 0 and config.ess_threshold <= 0.0:
            state = _reweight(state, n, shard)
        else:
            state = _ladder(staged, config, state, beta_f, n, generator, shard)
        if shard is not None:
            state = _global(state, shard)

        log_w = state.log_weights
        weights = torch.exp(log_w - K.plogsumexp(log_w))
        # one transfer to the host for the scalar results
        log_z, ess, beta = torch.stack(
            [state.log_evidence, effective_sample_size(log_w), state.beta]).tolist()
        profiling.host_read("smc.result")
        return SMCResult(
            particles=state.particles,
            log_weights=log_w,
            weights=weights,
            log_evidence=log_z,
            n_stages=state.stage,
            ess=ess,
            beta=beta,
            converged=beta >= 1.0,
            state=state,
        )


def importance_reweight(seed: int, n_particles: int, model_fn=None, *, staged=None,
                        model_args: tuple = (), device="cuda") -> SMCResult:
    """Plain prior-proposal importance sampling: the zero-rejuvenation
    shortcut as an entry point of its own."""
    cfg = SMCConfig(rejuvenation_steps=0, ess_threshold=0.0)
    return adaptive_smc(seed, n_particles, model_fn, cfg, staged=staged,
                        model_args=model_args, device=device)
