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

``mesh=`` and the ring gather of the sharded run wait for the parallel
slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

import torch
from torch.func import vmap

from .. import settings
from ..core.rng import site_seed
from ..ops import kernels as K
from ..ops.resampling import RESAMPLERS, effective_sample_size
from ..runtime.staging import StagedModel, stage
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


def _density_parts(staged: StagedModel) -> Callable:
    """Batched latents → (log prior (N,), log likelihood + factors (N,)) in
    one batched model replay."""
    dt = settings.real_dtype()

    def parts(latents):
        p = staged.log_density_parts(latents)
        # a model without observations scores its likelihood as 0.0
        return (torch.as_tensor(p.log_prior, dtype=dt, device=staged.device),
                torch.as_tensor(p.log_likelihood + p.log_factors, dtype=dt,
                                device=staged.device))

    return vmap(parts)


def _init_state(staged, config, seed, n, generator) -> SMCState:
    """Stage 0: N prior particles in one batched run, weights 1/N (the
    prior cancels in the importance weight, so only the likelihood
    enters)."""
    dt = settings.real_dtype()
    dev = staged.device
    latents = staged.sample_prior_batch(site_seed(seed, "smc/init"), n)
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
    )


def _rejuvenate_mh(staged, config, latents, adapt, beta, generator):
    """``rejuvenation_steps`` π_β-invariant single-site MH sweeps of all
    particles, with one proposal scale per site shared by the particles and
    adapted from their mean acceptance."""
    parts = _density_parts(staged)

    def tempered(lat):
        lp, ll = parts(lat)
        return lp + beta * ll

    n_sites = len(staged.sites)
    state = MHState(latents=latents, log_joint=tempered(latents), adapt=adapt)
    for _ in range(config.rejuvenation_steps):
        state, accepted = mh_step(staged, state, generator, False, config.target_accept,
                                  log_density_fn=tempered)
        acc_mean = torch.mean(accepted.to(adapt.log_scale.dtype))
        ones = torch.full((n_sites,), 1.0 / n_sites, dtype=adapt.log_scale.dtype,
                          device=adapt.log_scale.device)
        adapt = adapt_update(adapt, ones, acc_mean, target=config.target_accept)
        state = MHState(latents=state.latents, log_joint=state.log_joint, adapt=adapt)
    return state.latents, adapt


def _rejuvenate_hmc(staged, config, latents, adapt, beta, generator):
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
        step[0] = 0.5 * (torch.mean(info.accept_prob) - 0.8)
        adapt = AdaptationState(log_scale=adapt.log_scale + step, t=adapt.t)
    return vmap(lambda zz: staged.constrain(zz)[0])(z), adapt


def _ladder(staged, config, state: SMCState, beta_f: float, n, generator) -> SMCState:
    """Run ladder stages from ``state`` (whose β the host holds as
    ``beta_f``) until β = 1 or the stage cap."""
    resampler = RESAMPLERS[config.resampling]
    rejuvenate = _rejuvenate_hmc if config.rejuvenation == "hmc" else _rejuvenate_mh
    loglik = _density_parts(staged)
    target_ess = config.ess_threshold * n
    cap = MAX_STAGES if config.max_stages is None else min(MAX_STAGES, config.max_stages)

    latents, log_w, ll = state.particles, state.log_weights, state.log_likelihoods
    beta, log_z, adapt, stage_i = state.beta, state.log_evidence, state.adapt, state.stage
    while beta_f < 1.0 and stage_i < cap:
        beta_new = _next_beta(beta, log_w, ll, target_ess)
        delta = beta_new - beta
        # unbiased log-evidence increment under the current normalized
        # weights: log Σ_i w̄_i exp(δ·ll_i)
        log_wbar = log_w - K.plogsumexp(log_w)
        log_z = log_z + K.plogsumexp(log_wbar + delta * ll)
        log_w = log_w + delta * ll
        beta_f = float(beta_new)  # the one read of β per stage
        if beta_f < 1.0:  # no terminal resample
            idx = resampler(generator, log_w)
            latents = {a: v[idx] for a, v in latents.items()}
            log_w = torch.zeros_like(log_w)
            if config.rejuvenation_steps > 0:
                latents, adapt = rejuvenate(staged, config, latents, adapt, beta_new, generator)
                ll = loglik(latents)[1]
            else:
                ll = ll[idx]
        beta, stage_i = beta_new, stage_i + 1
    return SMCState(latents, log_w, ll, beta, log_z, adapt, generator.get_state(), stage_i)


def _reweight(state: SMCState, n) -> SMCState:
    """The zero-rejuvenation shortcut: one importance reweight by the full
    likelihood."""
    ll = state.log_likelihoods
    log_z = K.plogsumexp(ll) - math.log(n)
    return SMCState(state.particles, ll, ll, torch.ones_like(state.beta), log_z,
                    state.adapt, state.generator_state, 1)


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
) -> SMCResult:
    """Likelihood-tempered adaptive SMC with ``n_particles`` particles.

    ``seed`` seeds the stage-0 prior draw and one ``torch.Generator`` on the
    staged model's device, which draws every later random number. ``device``
    is used only when ``staged`` is not given.

    ``resume``: an ``SMCResult`` (or its ``state``) whose ladder stopped
    short of β = 1 at ``config.max_stages``. The run continues from that
    state, generator included, and is bitwise the uninterrupted run; the
    seed is then unused. ``log_evidence`` keeps accumulating."""
    if staged is None:
        staged = stage(model_fn, *model_args, device=device)
    if config.rejuvenation not in _REJUVENATION:
        raise ValueError(f"unknown rejuvenation {config.rejuvenation!r}; use 'mh' or 'hmc'")
    if config.resampling not in RESAMPLERS:
        raise ValueError(f"unknown resampling {config.resampling!r}; use one of {sorted(RESAMPLERS)}")
    if config.rejuvenation == "hmc" and staged.discrete_sites:
        raise ValueError("HMC rejuvenation requires continuous latents only; use "
                         "rejuvenation='mh' for models with discrete sites")
    n = int(n_particles)
    generator = torch.Generator(device=staged.device)
    if resume is not None:
        state = resume.state if isinstance(resume, SMCResult) else resume
        if state is None:
            raise ValueError("resume= needs an SMCResult carrying its state")
        if state.log_weights.shape[0] != n:
            raise ValueError(f"resume state holds {state.log_weights.shape[0]} particles; "
                             f"this run is configured for {n}")
        generator.set_state(state.generator_state)
        beta_f = float(state.beta)
    else:
        generator.manual_seed(int(seed))
        state = _init_state(staged, config, seed, n, generator)
        beta_f = 0.0

    if config.rejuvenation_steps == 0 and config.ess_threshold <= 0.0:
        state = _reweight(state, n)
    else:
        state = _ladder(staged, config, state, beta_f, n, generator)

    log_w = state.log_weights
    weights = torch.exp(log_w - K.plogsumexp(log_w))
    # one transfer to the host for the scalar results
    log_z, ess, beta = torch.stack(
        [state.log_evidence, effective_sample_size(log_w), state.beta]).tolist()
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
