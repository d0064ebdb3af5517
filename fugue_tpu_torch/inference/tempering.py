"""Parallel tempering (replica exchange) over a batched temperature axis.

The port of ``fugue_tpu/inference/tempering.py``: ``PTConfig``,
``PTResult``, ``geometric_ladder``, ``make_pt_drive`` and ``pt_chain``
with its ``resume=`` mode. K tempered copies π_β ∝ prior · likelihood^β
run at once, and states migrate from the hot, flattened rungs down to
β = 1.

- Positions are one (K·C, d) batch: every rung × every chain leapfrogs in
  the same batched HMC transition (β enters each replica's potential as a
  per-replica argument, so a force evaluation is one batched model run).
- Swaps are the deterministic even/odd neighbour scheme: each phase
  proposes all disjoint adjacent pairs at once as a masked gather, with
  the exchange acceptance log α = (β_k − β_{k+1}) · (ll_{k+1} − ll_k) and
  one uniform per pair.
- Per-rung step sizes adapt during warmup by the Robbins–Monro rule
  ε ← ε · exp((t + 1)^-0.6 · (ā_k − target)), ā_k the rung's cross-chain
  mean acceptance; hot rungs tolerate larger steps. In the sharded drive
  (``chain_group``) ā_k is the mean over every rank's chains; the ladder
  and the swaps stay on the rank.

``pt_step`` holds one transition's arithmetic and takes its noise
(momenta, accept log-uniforms, swap uniforms) as arguments, so the tests
can hand it the JAX package's own draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from .. import settings
from ..core.rng import fold_seed
from ..parallel.mesh import cross_mean
from ..runtime.staging import StagedModel, stage
from .hmc import constrain_positions, hmc_transition, initial_positions, prior_positions


@dataclass(frozen=True)
class PTConfig:
    n_temps: int = 8
    beta_min: float = 0.02  # hottest rung; the ladder is geometric up to 1.0
    n_leapfrog: int = 16
    step_size: float = 0.2  # initial per-rung ε (adapted during warmup)
    target_accept: float = 0.8
    swap_every: int = 1  # HMC transitions between swap phases
    init: str = "prior"


@dataclass
class PTResult:
    samples: Dict[str, Any]  # β=1 chain samples: (n_chains, n_samples, ...)
    positions: Any  # (n_chains, n_samples, d) at β=1
    betas: Any  # (K,)
    swap_rate: Any  # (K-1,) mean exchange acceptance per adjacent pair
    accept_prob: Any  # (K,) mean HMC acceptance per rung
    step_size: Any  # (K,) adapted ε per rung
    final_positions: Any  # (K, n_chains, d)


def geometric_ladder(n_temps: int, beta_min: float, *, device="cuda"):
    """β_{K−1} = 1 down to β_0 = beta_min, geometrically spaced."""
    if n_temps < 2:
        return torch.ones((1,), dtype=settings.real_dtype(), device=device)
    r = np.exp(np.linspace(np.log(beta_min), 0.0, n_temps))
    return torch.as_tensor(r, dtype=settings.real_dtype(), device=device)


def _parts(staged: StagedModel, discrete):
    """z → (log prior + log|J|, log likelihood + log factors)."""

    def parts_at(z):
        parts, logdet = staged.log_density_parts_unconstrained(z, discrete)
        return parts.log_prior + logdet, parts.log_likelihood + parts.log_factors

    return parts_at


def swap_phase(q, ll, betas, parity: int, u):
    """One even/odd exchange phase over the (K, C) ladder: pairs (k, k+1)
    with k ≡ parity (mod 2). ``u`` (K, C) uniforms, the pair's left rung's
    used for both. Returns (q, ll, pair acceptances (K, C), NaN off the
    pairs' left rungs)."""
    K = q.shape[0]
    ks = torch.arange(K, device=q.device)
    left = (ks % 2 == parity) & (ks + 1 < K)
    right = torch.roll(left, 1) & (ks > 0)
    partner = torch.where(left, ks + 1, torch.where(right, ks - 1, ks))
    log_a = (betas[ks] - betas[partner])[:, None] * (ll[partner] - ll)
    pair_left = torch.where(right, ks - 1, ks)
    u_shared = u[pair_left]  # one draw per pair
    accept = (torch.log(u_shared) < log_a) & (partner != ks)[:, None]
    src = torch.where(accept, partner[:, None], ks[:, None])  # (K, C)
    q_sw = torch.take_along_dim(q, src[:, :, None], dim=0)
    ll_sw = torch.take_along_dim(ll, src, dim=0)
    pair_acc = torch.where(left[:, None], accept.to(q.dtype), torch.nan)
    return q_sw, ll_sw, pair_acc


def pt_step(staged: StagedModel, config: PTConfig, betas, q, eps, t: int, adapting: bool,
            p, log_u, u_swap, discrete=None, chain_group=None):
    """One transition of the (K, C, d) ladder, given its noise: a batched
    HMC transition of every replica, the swap phase of parity t mod 2, and
    the warmup's per-rung step-size update. ``p`` (K, C, d), ``log_u`` (K,
    C), ``u_swap`` (K, C). Returns (q, eps, ll (K, C), HMC accept prob (K,
    C), pair acceptances (K, C)). ``chain_group``: the rung means reduce
    over the process group's chains."""
    K, C, d = q.shape
    parts_at = _parts(staged, discrete)

    def u_beta(z, beta):
        base, lik = parts_at(z)
        return -(base + beta * lik)

    force = vmap(grad_and_value(u_beta))
    beta_r = betas[:, None].expand(K, C).reshape(K * C)
    eps_r = eps[:, None].expand(K, C).reshape(K * C)
    inv_mass = torch.ones((d,), dtype=q.dtype, device=q.device)
    q_new, info = hmc_transition(None, q.reshape(K * C, d), p.reshape(K * C, d),
                                 log_u.reshape(K * C), eps_r, config.n_leapfrog, inv_mass,
                                 force_fn=lambda z: force(z, beta_r))
    q_new = q_new.reshape(K, C, d)
    ll = vmap(lambda z: parts_at(z)[1])(q_new.reshape(K * C, d)).reshape(K, C)
    q_new, ll, pair_acc = swap_phase(q_new, ll, betas, t % 2, u_swap)
    acc_k = cross_mean(torch.mean(info.accept_prob.reshape(K, C), dim=1), chain_group)
    if adapting:
        eps = eps * torch.exp((t + 1.0) ** -0.6 * (acc_k - config.target_accept))
    return q_new, eps, ll, info.accept_prob.reshape(K, C), pair_acc


def make_pt_drive(staged: StagedModel, config: PTConfig, n_chains: int, n_samples: int,
                  n_warmup: int, *, discrete: Optional[Dict[str, Any]] = None,
                  chain_group=None):
    """Build ``drive(generator, seed, q_over=None, eps_over=None) → (q_f,
    eps_f, q1s (n_samples, C, d), accs (n_samples, K), pair_accs
    (n_samples, K, C))``; ``q_over`` (K, C, d) and ``eps_over`` (K,)
    resume a run. ``chain_group``: the sharded drive over this rank's
    ``n_chains``; ``accs`` are then means over every rank's chains."""
    K, C, d = config.n_temps, n_chains, staged.dim
    betas = geometric_ladder(K, config.beta_min, device=staged.device)

    def drive(generator: torch.Generator, seed: int, q_over=None, eps_over=None):
        dt, dev = settings.real_dtype(), staged.device
        if q_over is not None:
            q = torch.as_tensor(q_over).to(device=dev, dtype=dt)
        elif config.init == "prior":  # one batched prior run for every replica
            q = prior_positions(staged, fold_seed(seed, 23), K * C)[0].reshape(K, C, d)
        else:
            q = initial_positions(staged, generator, K * C, config.init).reshape(K, C, d)
        if eps_over is not None:
            eps = torch.as_tensor(eps_over).to(device=dev, dtype=dt)
        else:  # hot rungs tolerate bigger steps: ε / √β to start
            eps = torch.full((K,), config.step_size, dtype=dt, device=dev) / torch.sqrt(betas)

        q1s, accs, pair_accs = [], [], []
        for t in range(n_warmup + n_samples):
            p = torch.randn((K, C, d), generator=generator, device=dev, dtype=dt)
            log_u = torch.log1p(-torch.rand((K, C), generator=generator, device=dev, dtype=dt))
            u_swap = 1.0 - torch.rand((K, C), generator=generator, device=dev, dtype=dt)
            q, eps, _, ap, pair_acc = pt_step(staged, config, betas, q, eps, t, t < n_warmup,
                                              p, log_u, u_swap, discrete, chain_group)
            if t >= n_warmup:
                q1s.append(q[-1])
                accs.append(cross_mean(torch.mean(ap, dim=1), chain_group))
                pair_accs.append(pair_acc)
        return (q, eps, torch.stack(q1s) if q1s else q.new_zeros((0, C, d)),
                torch.stack(accs) if accs else q.new_zeros((0, K)),
                torch.stack(pair_accs) if pair_accs else q.new_zeros((0, K, C)))

    return drive


def pt_chain(
    seed: int,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 1000,
    config: PTConfig = PTConfig(),
    *,
    n_chains: int = 8,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    discrete: Optional[Dict[str, Any]] = None,
    resume: Optional[Any] = None,
    device="cuda",
) -> PTResult:
    """Replica-exchange HMC; returns the β = 1 samples.

    Each rung's HMC transition is π_β-invariant and the swap move keeps
    detailed balance for Π_k π_{β_k}, so the β = 1 marginal is the exact
    posterior whatever the ladder: a poor ladder costs mixing only.

    ``resume``: a previous ``PTResult`` (or any object with
    ``final_positions`` (K, n_chains, d) and ``step_size`` (K,), such as
    ``interop.pt_state_from_numpy`` of a JAX result): sampling continues
    from the ladder's state with the warmed per-rung step sizes (warmup
    skipped, adaptation frozen). ``seed`` seeds one ``torch.Generator`` on
    the staged model's device; ``device`` is used only when ``staged`` is
    not given."""
    if staged is None:
        staged = stage(model_fn, *model_args, device=device)
    if staged.dim == 0:
        raise ValueError("model has no continuous latent sites; use MH")
    K = config.n_temps
    overrides = {}
    if resume is not None:
        n_warmup = 0
        q_resume = torch.as_tensor(resume.final_positions)
        if tuple(q_resume.shape) != (K, n_chains, staged.dim):
            raise ValueError(
                f"resume ladder positions {tuple(q_resume.shape)} do not match "
                f"(K={K}, n_chains={n_chains}, d={staged.dim})"
            )
        eps_resume = torch.as_tensor(resume.step_size)
        if tuple(eps_resume.shape) != (K,):
            raise ValueError(
                f"resume step sizes {tuple(eps_resume.shape)} do not match (K={K},)"
            )
        overrides = dict(q_over=q_resume, eps_over=eps_resume)
    drive = make_pt_drive(staged, config, n_chains, n_samples, n_warmup, discrete=discrete)
    generator = torch.Generator(device=staged.device).manual_seed(int(seed))
    return pt_result(staged, config, *drive(generator, int(seed), **overrides))


def pt_result(staged: StagedModel, config: PTConfig, q_f, eps_f, q1s, accs, pair_accs
              ) -> PTResult:
    """The ``PTResult`` of a drive's outputs."""
    K = config.n_temps
    positions = q1s.movedim(0, 1)  # (C, n_samples, d)
    # the last rung is never a pair's left index: drop it before the mean
    swap_rate = torch.nanmean(pair_accs[:, :-1, :].movedim(1, 0).reshape(K - 1, -1), dim=1) \
        if K > 1 else pair_accs.new_zeros((0,))
    return PTResult(
        samples=constrain_positions(staged, positions),
        positions=positions,
        betas=geometric_ladder(K, config.beta_min, device=staged.device),
        swap_rate=swap_rate,
        accept_prob=torch.mean(accs, dim=0),
        step_size=eps_f,
        final_positions=q_f,
    )
