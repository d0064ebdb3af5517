"""HMC-within-Gibbs for mixed continuous + discrete models.

The port of ``fugue_tpu/inference/gibbs.py``: ``GibbsResult``,
``make_gibbs_drive`` and ``gibbs_chain`` with its ``resume=`` mode. One sweep is

1. an HMC transition on the unconstrained continuous block, conditioned on
   each chain's current discrete values (they enter the potential as
   per-chain data: one batched model run per force evaluation);
2. a systematic scan of single-site MH updates over every discrete site
   (the MH engine's support-detected proposals), conditioned on the new
   continuous values: one batched model run per site.

Warmup adapts one step size for all chains by dual averaging on the
cross-chain mean acceptance. ``gibbs_sweep`` holds the arithmetic and
takes its noise as arguments (momenta, the HMC accept log-uniform, and per
discrete site its proposal draws and accept log-uniform), so the tests can
hand it the JAX sweep's own draws; the drive draws them from one
``torch.Generator`` on the model's device. For enumerable discrete
structure, exact marginalization (``marginalize``) is exact and faster;
Gibbs covers unbounded counts and large cardinalities.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
from torch.func import grad_and_value, vmap

from .. import settings
from ..runtime.staging import StagedModel, stage
from .hmc import (
    DualAveragingState,
    HMCConfig,
    dual_averaging_update,
    find_reasonable_epsilon,
    hmc_transition,
    prior_positions,
)
from .mh import draw_discrete_noise, make_site_proposal


@dataclass
class GibbsResult:
    samples: Dict[str, Any]  # all sites: (n_chains, n_samples, *shape)
    accept_prob_hmc: Any  # (n_samples,) cross-chain mean per sweep
    accept_rate_discrete: Any  # mean fraction of discrete sites moved
    step_size: float
    # the full inter-sweep state: pass the result as ``resume=``
    final_positions: Any = None  # (n_chains, d) unconstrained
    final_discrete: Optional[Dict[str, Any]] = None  # addr -> (n_chains, ...)


def _members(mask, like):
    return mask.reshape(-1, *([1] * (like.dim() - 1)))


def gibbs_sweep(staged: StagedModel, z, disc, eps, n_leapfrog: int, p, log_u,
                disc_noise: Dict[str, Any], disc_log_u: Dict[str, Any],
                max_delta_energy: float = 1000.0):
    """One sweep for a batch of C chains, given its noise.

    ``z`` (C, d) positions, ``disc`` address → (C, *shape) discrete values,
    ``p`` (C, d) momenta, ``log_u`` (C,) the HMC accept log-uniforms;
    ``disc_noise`` per discrete site its proposal draws (the MH engine's
    ``draw_discrete_noise`` layout) and ``disc_log_u`` its (C,) accept
    log-uniforms. Returns ``(z, disc, hmc accept prob (C,), fraction of
    discrete sites accepted (C,))``."""
    d = staged.dim
    inv_mass = torch.ones((d,), dtype=z.dtype, device=z.device)
    force = vmap(grad_and_value(lambda zz, dd: staged.potential(zz, dd)))
    z_new, info = hmc_transition(None, z, p, log_u, eps, n_leapfrog, inv_mass,
                                 max_delta_energy, force_fn=lambda q: force(q, disc))

    log_joint = vmap(staged.log_joint_unconstrained)
    lj = log_joint(z_new, disc)
    n_acc = torch.zeros_like(lj)
    for s in staged.discrete_sites:
        cur = disc[s.address]
        prop = dict(disc)
        prop[s.address] = make_site_proposal(s.support)(cur, disc_noise[s.address])
        lj_prop = log_joint(z_new, prop)
        accept = disc_log_u[s.address] < (lj_prop - lj)  # the proposals are symmetric
        disc = {a: torch.where(_members(accept, v), prop[a], v) for a, v in disc.items()}
        lj = torch.where(accept, lj_prop, lj)
        n_acc = n_acc + accept.to(n_acc.dtype)
    return z_new, disc, info.accept_prob, n_acc / max(len(staged.discrete_sites), 1)


def make_gibbs_drive(staged: StagedModel, config: HMCConfig, n_chains: int,
                     n_samples: int, n_warmup: int, *, discrete_scale: float = 1.0):
    """Build ``drive(generator, state_over=None, eps_over=None) → (cont,
    disc, aps, dacc, eps, (z_f, disc_f))``: ``cont`` and ``disc`` are
    address → (n_samples, C, *shape), ``aps`` and ``dacc`` (n_samples, C).
    ``state_over`` = (positions, discrete values) and ``eps_over`` resume a
    run (warmup is then 0)."""
    d = staged.dim
    if d == 0:
        raise ValueError("no continuous sites; use adaptive_mcmc_chain")
    disc_sites = staged.discrete_sites
    L = config.n_leapfrog

    def drive(generator: torch.Generator, state_over=None, eps_over=None):
        dt, dev = settings.real_dtype(), staged.device
        if state_over is not None:
            zs, discs = state_over
            zs = torch.as_tensor(zs).to(device=dev, dtype=dt)
            discs = {a: torch.as_tensor(v).to(dev) for a, v in discs.items()}
        else:
            seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=dev))
            zs, latents = prior_positions(staged, seed, n_chains)
            discs = {s.address: latents[s.address] for s in disc_sites}
        scales = torch.full((len(staged.sites),), float(discrete_scale), dtype=dt, device=dev)
        ones = torch.ones((d,), dtype=dt, device=dev)

        def sweep(z, disc, eps):
            p = torch.randn(z.shape, generator=generator, device=dev, dtype=dt)
            log_u = torch.log1p(-torch.rand((n_chains,), generator=generator, device=dev,
                                            dtype=dt))
            noise = draw_discrete_noise(staged, scales, generator, n_chains)
            dlog_u = {s.address: torch.log1p(-torch.rand((n_chains,), generator=generator,
                                                         device=dev, dtype=dt))
                      for s in disc_sites}
            return gibbs_sweep(staged, z, disc, eps, L, p, log_u, noise, dlog_u,
                               config.max_delta_energy)

        if eps_over is not None:
            eps0 = torch.as_tensor(eps_over, dtype=dt, device=dev).reshape(())
        elif config.step_size is not None:
            eps0 = torch.tensor(config.step_size, dtype=dt, device=dev)
        else:
            d0 = {a: v[0] for a, v in discs.items()}
            p0 = torch.randn((d,), generator=generator, device=dev, dtype=dt)
            eps0 = find_reasonable_epsilon(lambda zz: staged.potential(zz, d0), zs[0], p0, ones)
        da = DualAveragingState.init(eps0)
        for _ in range(n_warmup):
            zs, discs, ap, _ = sweep(zs, discs, torch.exp(da.log_eps))
            da = dual_averaging_update(da, torch.mean(ap), config.target_accept)
        eps_f = torch.exp(da.log_eps_bar) if n_warmup > 0 else eps0

        cont = {s.address: [] for s in staged.continuous_sites}
        disc_out = {s.address: [] for s in disc_sites}
        aps, daccs = [], []
        to_latents = vmap(lambda z: staged.constrain(z)[0])
        for _ in range(n_samples):
            zs, discs, ap, dacc = sweep(zs, discs, eps_f)
            for a, v in to_latents(zs).items():
                cont[a].append(v)
            for a, v in discs.items():
                disc_out[a].append(v)
            aps.append(ap)
            daccs.append(dacc)
        cont = {a: torch.stack(v) for a, v in cont.items()}
        disc_out = {a: torch.stack(v) for a, v in disc_out.items()}
        return cont, disc_out, torch.stack(aps), torch.stack(daccs), eps_f, (zs, discs)

    return drive


def gibbs_chain(
    seed: int,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 500,
    config: HMCConfig = HMCConfig(n_leapfrog=16),
    *,
    n_chains: int = 1,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    discrete_scale: float = 1.0,
    resume: Optional[Any] = None,
    device="cuda",
) -> GibbsResult:
    """Alternating HMC (continuous block) and single-site MH (discrete
    sites) over ``n_chains`` chains at once.

    ``seed`` seeds one ``torch.Generator`` on the staged model's device
    for every draw. ``resume``: a previous ``GibbsResult`` (or any object
    with ``final_positions`` (n_chains, d), ``final_discrete`` and
    ``step_size``, such as ``interop.gibbs_state_from_numpy`` of a JAX
    result): sampling continues from the full sweep state with the warmed
    step size (warmup skipped, adaptation frozen). ``device`` is used only
    when ``staged`` is not given."""
    if staged is None:
        staged = stage(model_fn, *model_args, device=device)
    overrides = {}
    if resume is not None:
        n_warmup = 0
        q_resume = torch.as_tensor(resume.final_positions)
        if tuple(q_resume.shape) != (n_chains, staged.dim):
            raise ValueError(
                f"resume positions {tuple(q_resume.shape)} do not match "
                f"(n_chains={n_chains}, d={staged.dim})"
            )
        disc_resume = dict(resume.final_discrete or {})
        want = {s.address for s in staged.discrete_sites}
        if set(disc_resume) != want:
            raise ValueError(
                f"resume discrete sites {sorted(disc_resume)} do not match "
                f"the model's {sorted(want)}"
            )
        overrides = dict(state_over=(q_resume, disc_resume), eps_over=resume.step_size)
    drive = make_gibbs_drive(staged, config, n_chains, n_samples, n_warmup,
                             discrete_scale=discrete_scale)
    generator = torch.Generator(device=staged.device).manual_seed(int(seed))
    cont, disc, aps, dacc, eps_f, (z_f, disc_f) = drive(generator, **overrides)
    samples = {a: v.movedim(0, 1) for a, v in {**cont, **disc}.items()}
    return GibbsResult(
        samples=samples,
        accept_prob_hmc=torch.mean(aps, dim=-1),
        accept_rate_discrete=torch.mean(dacc),
        step_size=float(eps_f),
        final_positions=z_f,
        final_discrete=disc_f,
    )

