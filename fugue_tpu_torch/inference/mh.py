"""Single-site Metropolis-Hastings, batched over particles.

The port of the part of ``fugue_tpu/inference/mh.py`` that SMC's
rejuvenation calls: ``MHState``, ``_reflect_into``, ``_packed_meta`` and
``mh_step``, for continuous sites.

One step moves every particle (or chain) of a batch at once:

1. draw a target site index per particle;
2. propose for every coordinate of the flat constrained layout
   elementwise (Gaussian walk, log-space walk for positive supports,
   reflection walk inside bounded intervals) and keep only the drawn site's
   coordinates;
3. score all proposals in ONE batched replay of the target density, and
   accept or reject with the log-space walk's exact Hastings term;
4. update the per-site diminishing-adaptation scales (unless frozen).

``mh_step`` draws the noise (site index, ε, accept log-uniform) from a
``torch.Generator``; ``mh_step_from_noise`` holds the arithmetic and takes
that noise as arguments, so the tests can hand it the JAX step's own draws.
The discrete proposals and ``adaptive_mcmc_chain`` wait for a later
slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.func import vmap

from ..runtime.staging import StagedModel
from .mcmc_utils import AdaptationState, adapt_update

TARGET_ACCEPT = 0.44  # classic single-site target (Roberts-Rosenthal)


@dataclass
class MHState:
    """Batched sampler state: latents (B, *site_shape) per address, log
    density (B,), and an adaptation state shared by the batch (n_sites,) or
    per member (B, n_sites)."""

    latents: Dict[str, Any]
    log_joint: Any
    adapt: AdaptationState


def _reflect_into(y, lo, hi):
    """Fold y into [lo, hi] by reflection."""
    width = hi - lo
    t = torch.remainder(y - lo, 2 * width)
    return lo + torch.minimum(t, 2 * width - t)


def _packed_meta(staged: StagedModel):
    """Static per-coordinate proposal metadata over the continuous flat
    layout: owning-site index, kind masks, interval bounds (numpy, computed
    once per staged model)."""
    meta = getattr(staged, "_mh_packed_meta", None)
    if meta is not None:
        return meta
    dim = staged.constrained_dim
    site_of = np.zeros(dim, np.int64)
    is_pos = np.zeros(dim, bool)
    is_int = np.zeros(dim, bool)
    lo = np.zeros(dim, np.float64)
    hi = np.ones(dim, np.float64)
    for s in staged.continuous_sites:
        a, b = staged._offsets[s.address]
        site_of[a:b] = staged.site_index[s.address]
        kind = s.support.kind
        if kind == "positive":
            is_pos[a:b] = True
        elif kind == "unit":
            is_int[a:b] = True
        elif kind == "interval" and s.support.low is not None and s.support.high is not None:
            is_int[a:b] = True
            shape = s.shape if s.shape else ()
            lo[a:b] = np.ravel(np.broadcast_to(np.asarray(s.support.low, np.float64), shape))
            hi[a:b] = np.ravel(np.broadcast_to(np.asarray(s.support.high, np.float64), shape))
    meta = (site_of, is_pos, is_int, lo, hi)
    staged._mh_packed_meta = meta
    return meta


def _meta_tensors(staged: StagedModel, dtype):
    """``_packed_meta`` as tensors on the staged model's device, cached per
    dtype so a step copies nothing from the host."""
    cache = staged.__dict__.setdefault("_mh_meta_tensors", {})
    if dtype not in cache:
        site_of, is_pos, is_int, lo, hi = _packed_meta(staged)
        dev = staged.device
        cache[dtype] = (
            torch.as_tensor(site_of, device=dev),
            torch.as_tensor(is_pos, device=dev),
            torch.as_tensor(is_int, device=dev),
            torch.as_tensor(lo, dtype=dtype, device=dev),
            torch.as_tensor(hi, dtype=dtype, device=dev),
            torch.as_tensor(np.where(is_int, hi - lo, 1.0), dtype=dtype, device=dev),
        )
    return cache[dtype]


def mh_step_from_noise(
    staged: StagedModel,
    state: MHState,
    site_idx,
    eps,
    log_u,
    adapt: bool,
    target_accept: float = TARGET_ACCEPT,
    log_density_fn: Optional[Callable] = None,
):
    """One single-site MH transition for a batch of B members, given its
    noise: ``site_idx`` (B,) sites to move, ``eps`` (B, constrained_dim)
    standard normals, ``log_u`` (B,) accept log-uniforms.

    ``log_density_fn`` maps batched latents to the (B,) target (SMC's
    tempered π_β); the default is the full joint, one batched replay.
    Returns ``(MHState, accepted)``."""
    target = log_density_fn if log_density_fn is not None else vmap(staged.log_joint)
    n_sites = len(staged.sites)
    scales = state.adapt.scale()

    proposed: Dict[str, Any] = dict(state.latents)
    z = staged.flatten_constrained(state.latents)  # (B, D)
    dt = z.dtype
    site_of, is_pos, is_int, lo, hi, width = _meta_tensors(staged, dt)
    s_coord = scales[..., site_of]  # per-coordinate scale: (D,) or (B, D)
    cand = z + s_coord * width * eps  # Gaussian walk
    z_safe = torch.where(is_pos, z, torch.ones_like(z))
    cand_pos = z_safe * torch.exp(s_coord * eps)  # log-space walk
    cand_ref = _reflect_into(cand, lo, hi)  # reflection walk inside intervals
    cand = torch.where(is_pos, cand_pos, torch.where(is_int, cand_ref, cand))
    sel = site_of == site_idx[:, None]
    z_new = torch.where(sel, cand, z)
    # exact Hastings term of the log-space walk: ln x' - ln x
    corr = torch.where(
        sel & is_pos,
        torch.log(torch.where(is_pos, cand_pos, torch.ones_like(cand_pos))) - torch.log(z_safe),
        torch.zeros_like(z),
    )
    hastings = torch.sum(corr, dim=-1)
    proposed.update(staged.unflatten_constrained(z_new))

    new_lj = target(proposed)
    log_alpha = new_lj - state.log_joint + hastings
    accept = log_u < log_alpha

    def keep(new, old):
        return torch.where(accept.reshape(-1, *([1] * (new.dim() - 1))), new, old)

    latents = {a: keep(proposed[a], state.latents[a]) for a in state.latents}
    log_joint = torch.where(accept, new_lj, state.log_joint)
    one_hot = torch.nn.functional.one_hot(site_idx, n_sites).to(scales.dtype)
    new_adapt = adapt_update(state.adapt, one_hot, accept, target=target_accept,
                             frozen=not adapt)
    return MHState(latents=latents, log_joint=log_joint, adapt=new_adapt), accept


def mh_step(
    staged: StagedModel,
    state: MHState,
    generator: torch.Generator,
    adapt: bool,
    target_accept: float = TARGET_ACCEPT,
    log_density_fn: Optional[Callable] = None,
):
    """One single-site MH transition for the batch in ``state``, its noise
    drawn from ``generator`` (see ``mh_step_from_noise``)."""
    b = state.log_joint.shape[0]
    dt, dev = state.log_joint.dtype, state.log_joint.device
    site_idx = torch.randint(0, len(staged.sites), (b,), generator=generator, device=dev)
    eps = torch.randn((b, staged.constrained_dim), generator=generator, device=dev, dtype=dt)
    log_u = torch.log1p(-torch.rand((b,), generator=generator, device=dev, dtype=dt))
    return mh_step_from_noise(staged, state, site_idx, eps, log_u, adapt, target_accept,
                              log_density_fn)
