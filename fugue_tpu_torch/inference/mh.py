"""Single-site Metropolis-Hastings, batched over particles.

The port of ``fugue_tpu/inference/mh.py``'s single-device path:
``MHState``, ``init_mh_state``, ``_reflect_into``, ``_packed_meta``, the
discrete proposals (``_propose_flip``, ``_propose_discrete_walk``,
``_propose_categorical``, ``make_site_proposal``), ``mh_step`` (which SMC's
rejuvenation also calls), ``MHResult`` and the adaptive driver
``adaptive_mcmc_chain``.

One step moves every particle (or chain) of a batch at once:

1. draw a target site index per particle, over all sites;
2. propose for every coordinate of the flat constrained layout
   elementwise (Gaussian walk, log-space walk for positive supports,
   reflection walk inside bounded intervals), and for every discrete site
   by its support (a flip for booleans, a reflected integer walk for
   counts and ranges, a uniform redraw for categories); keep only the drawn
   site's proposal;
3. score all proposals in ONE batched replay of the target density, and
   accept or reject with the log-space walk's exact Hastings term (the
   discrete proposals are symmetric);
4. update the per-site diminishing-adaptation scales (unless frozen).

``mh_step`` draws the noise (site index, ε, accept log-uniform, and per
discrete site its walk or category draws) from a ``torch.Generator``;
``mh_step_from_noise`` holds the arithmetic and takes that noise as
arguments, so the tests can hand it the JAX step's own draws.

``adaptive_mcmc_chain`` runs C chains as one batch, each with its own
per-site scales: the initial state is ONE batched prior run that also
scores the draws (``init_mh_state``), and every transition is one batched
replay, so a run makes exactly 1 + n_warmup + n_samples batched model runs.
Warmup transitions adapt the scales; sampling transitions leave them
frozen. With ``mesh=`` the chains split over the ranks, and two ranks give
the draws of one: every rank draws the noise of the GLOBAL batch from the
same generator (and makes the global initial state) and keeps its block of
rows, then runs the model on its chains only. MH adapts per chain, so no
collective runs until the results are gathered at the end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.func import vmap

from .. import settings
from ..core.distributions import Support
from ..core.rng import site_seed
from ..parallel.mesh import ShardLayout
from ..runtime.staging import StagedModel, stage
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


def init_mh_state(staged: StagedModel, seed: int, n_chains: int, initial_scale=0.5) -> MHState:
    """``n_chains`` prior draws with their log joints, from ONE batched
    model run, and per-chain adaptation state (n_chains, n_sites).
    ``initial_scale``: a float, or an ``{address: scale}`` dict of per-site
    scales (unlisted sites use 0.5). The proposal tables are copied to
    the device here, so that no transition copies from the host."""
    latents, log_joint = staged.sample_prior_batch_scored(seed, n_chains)
    dt, dev = settings.real_dtype(), staged.device
    if staged.constrained_dim > 0:
        _meta_tensors(staged, dt)
    if isinstance(initial_scale, dict):
        scales = torch.tensor([float(initial_scale.get(s.address, 0.5)) for s in staged.sites],
                              dtype=dt, device=dev)
        log_scale = torch.log(scales).expand(n_chains, -1).clone()
        adapt = AdaptationState(log_scale=log_scale, t=torch.zeros_like(log_scale))
    else:
        adapt = AdaptationState.init(len(staged.sites), initial_scale, (n_chains,), dtype=dt,
                                     device=dev)
    return MHState(latents=latents, log_joint=log_joint, adapt=adapt)


def _reflect_into(y, lo, hi):
    """Fold y into [lo, hi] by reflection."""
    width = hi - lo
    t = torch.remainder(y - lo, 2 * width)
    return lo + torch.minimum(t, 2 * width - t)


def _propose_flip(x):
    """Deterministic flip (symmetric)."""
    return torch.logical_not(x)


def _propose_discrete_walk(x, mag, sign, lo, hi):
    """Integer random walk by ``sign * mag`` (mag >= 1, sign ±1), reflected
    about lo − 1/2 (and hi + 1/2 when bounded): symmetric by reflection."""
    y = x + (sign * mag).to(x.dtype)
    if lo is not None:
        y = torch.where(y < lo, 2 * lo - 1 - y, y)
    if hi is not None:
        y = torch.where(y > hi, 2 * hi + 1 - y, y)
    if lo is not None:
        y = torch.clamp(y, min=lo)  # extreme overshoot guard
    if hi is not None:
        y = torch.clamp(y, max=hi)
    return y


def _propose_categorical(x, category):
    """Uniform redraw over the categories (symmetric): ``category`` is the
    drawn index."""
    return category.to(x.dtype)


def _walk_bounds(support: Support):
    lo = support.low if support.low is not None else (0 if support.kind == "count" else None)
    return lo, support.high


def make_site_proposal(support: Support) -> Callable:
    """The proposal of a discrete support, as ``(x, noise) → x'``: ``noise``
    is None for a flip, ``(mag, sign)`` for a walk, the category for a
    categorical. Continuous sites propose in the packed flat layout of
    ``mh_step_from_noise`` instead."""
    kind = support.kind
    if kind == "boolean":
        return lambda x, noise: _propose_flip(x)
    if kind == "categorical":
        return lambda x, noise: _propose_categorical(x, noise)
    if kind in ("count", "int_range"):
        lo, hi = _walk_bounds(support)
        return lambda x, noise: _propose_discrete_walk(x, noise[0], noise[1], lo, hi)
    raise ValueError(f"{kind!r} is a continuous support: it proposes in the packed layout")


def draw_discrete_noise(staged: StagedModel, scales, generator: torch.Generator, b: int,
                        rows: Optional[slice] = None):
    """The discrete sites' draws for one step of ``b`` members: per walk
    site (mag, sign) with mag uniform on 1..max(round(scale), 1) and sign
    ±1 with probability 1/2; per categorical site a uniform category; a
    flip draws nothing. ``rows``: keep those members of the ``b`` drawn
    (``scales`` are then theirs)."""
    dev = generator.device
    keep = (lambda x: x) if rows is None else (lambda x: x[rows])
    out: Dict[str, Any] = {}
    for s in staged.discrete_sites:
        shape = (b,) + s.shape
        if s.support.kind == "boolean":
            out[s.address] = None
        elif s.support.kind == "categorical":
            out[s.address] = keep(torch.randint(0, s.support.size, shape, generator=generator,
                                                device=dev))
        else:
            scale = scales[..., staged.site_index[s.address]]
            width = torch.clamp(torch.round(scale), min=1.0)
            width = width.reshape(width.shape + (1,) * (len(shape) - width.dim()))
            u = keep(torch.rand(shape, generator=generator, device=dev, dtype=scales.dtype))
            mag = torch.minimum(1.0 + torch.floor(u * width), width).to(torch.int64)
            sign = keep(torch.where(torch.rand(shape, generator=generator, device=dev) < 0.5,
                                    1, -1))
            out[s.address] = (mag, sign)
    return out


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
    discrete_noise: Optional[Dict[str, Any]] = None,
):
    """One single-site MH transition for a batch of B members, given its
    noise: ``site_idx`` (B,) sites to move, ``eps`` (B, constrained_dim)
    standard normals, ``log_u`` (B,) accept log-uniforms, and
    ``discrete_noise`` the discrete sites' draws (``draw_discrete_noise``;
    needed only when the model has discrete sites).

    ``log_density_fn`` maps batched latents to the (B,) target (SMC's
    tempered π_β); the default is the full joint, one batched replay.
    Returns ``(MHState, accepted)``."""
    target = log_density_fn if log_density_fn is not None else vmap(staged.log_joint)
    n_sites = len(staged.sites)
    scales = state.adapt.scale()

    proposed: Dict[str, Any] = dict(state.latents)
    hastings = torch.zeros_like(state.log_joint)
    if staged.constrained_dim > 0:
        z = staged.flatten_constrained(state.latents)  # (B, D)
        site_of, is_pos, is_int, lo, hi, width = _meta_tensors(staged, z.dtype)
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

    def members(mask, like):
        return mask.reshape(-1, *([1] * (like.dim() - 1)))

    for s in staged.discrete_sites:
        cur = state.latents[s.address]
        cand = make_site_proposal(s.support)(cur, discrete_noise[s.address])
        sel = site_idx == staged.site_index[s.address]
        proposed[s.address] = torch.where(members(sel, cur), cand, cur)

    new_lj = target(proposed)
    log_alpha = new_lj - state.log_joint + hastings
    accept = log_u < log_alpha

    latents = {a: torch.where(members(accept, proposed[a]), proposed[a], state.latents[a])
               for a in state.latents}
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
    *,
    rows: Optional[slice] = None,
    n_total: Optional[int] = None,
):
    """One single-site MH transition for the batch in ``state``, its noise
    drawn from ``generator`` (see ``mh_step_from_noise``). ``rows`` and
    ``n_total``: ``state`` holds those rows of a batch of ``n_total``; the
    noise of the whole batch is drawn and theirs kept (a rank's block)."""
    b = state.log_joint.shape[0] if n_total is None else n_total
    dt, dev = state.log_joint.dtype, state.log_joint.device
    keep = (lambda x: x) if rows is None else (lambda x: x[rows])
    site_idx = keep(torch.randint(0, len(staged.sites), (b,), generator=generator, device=dev))
    eps = keep(torch.randn((b, staged.constrained_dim), generator=generator, device=dev,
                           dtype=dt))
    log_u = keep(torch.log1p(-torch.rand((b,), generator=generator, device=dev, dtype=dt)))
    disc = draw_discrete_noise(staged, state.adapt.scale(), generator, b, rows)
    return mh_step_from_noise(staged, state, site_idx, eps, log_u, adapt, target_accept,
                              log_density_fn, disc)


@dataclass
class MHResult:
    """Posterior samples and trajectory metadata."""

    samples: Dict[str, Any]  # addr -> (n_chains, n_samples, *site_shape)
    log_joint: Any  # (n_chains, n_samples)
    accept_rate: Any  # (n_chains,)
    final_state: MHState


def adaptive_mcmc_chain(
    seed: int,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 0,
    *,
    n_chains: int = 1,
    model_args: tuple = (),
    initial_scale=0.5,
    target_accept: float = TARGET_ACCEPT,
    staged: Optional[StagedModel] = None,
    device="cuda",
    mesh=None,
) -> MHResult:
    """Adaptive single-site random-scan MH over ``n_chains`` chains at once.

    Warmup transitions adapt each chain's per-site proposal scales; the
    sampling transitions leave them frozen. A run makes exactly
    1 + n_warmup + n_samples batched model runs: the scored prior draw,
    then one replay per transition. ``seed`` seeds the prior draw and one
    ``torch.Generator`` on the staged model's device, which draws every
    proposal and accept uniform. ``device`` is used only when ``staged`` is
    not given.

    ``mesh``: a ``DeviceMesh``; every rank calls this with the same
    arguments, holds its block of the chains (the mesh's chain axes), and
    returns the global result, bitwise the one-rank run's (see the module
    docstring). The initial state is drawn for every chain on every rank,
    in one batched model run; each transition runs the rank's chains."""
    if staged is None:
        staged = stage(model_fn, *model_args, device=device)
    shard = ShardLayout() if mesh is None else ShardLayout.of(mesh)
    c = shard.split(n_chains)
    rows = shard.rows(c)  # every row on one device
    generator = torch.Generator(device=staged.device).manual_seed(int(seed))
    state = _rows_of(init_mh_state(staged, site_seed(seed, "mh/init"), n_chains, initial_scale),
                     rows)
    for _ in range(n_warmup):
        state, _ = mh_step(staged, state, generator, True, target_accept,
                           rows=rows, n_total=n_chains)
    samples = {a: torch.empty((n_samples,) + tuple(v.shape), dtype=v.dtype, device=v.device)
               for a, v in state.latents.items()}
    log_joint = torch.empty((n_samples, c), dtype=state.log_joint.dtype, device=staged.device)
    accepted = torch.zeros((c,), dtype=state.log_joint.dtype, device=staged.device)
    for i in range(n_samples):
        state, acc = mh_step(staged, state, generator, False, target_accept,
                             rows=rows, n_total=n_chains)
        for a, v in state.latents.items():
            samples[a][i] = v
        log_joint[i] = state.log_joint
        accepted += acc
    # the global result: one gather per tensor (none on one device)
    samples = {a: shard.gather(v, 1) for a, v in samples.items()}
    log_joint, accepted = shard.gather(log_joint, 1), shard.gather(accepted)
    state = MHState(latents={a: shard.gather(v) for a, v in state.latents.items()},
                    log_joint=shard.gather(state.log_joint),
                    adapt=AdaptationState(log_scale=shard.gather(state.adapt.log_scale),
                                          t=shard.gather(state.adapt.t)))
    return MHResult(
        samples={a: v.movedim(0, 1) for a, v in samples.items()},
        log_joint=log_joint.movedim(0, 1),
        accept_rate=accepted / n_samples,
        final_state=state,
    )


def _rows_of(state: MHState, rows: slice) -> MHState:
    return MHState(latents={a: v[rows] for a, v in state.latents.items()},
                   log_joint=state.log_joint[rows],
                   adapt=AdaptationState(log_scale=state.adapt.log_scale[rows],
                                         t=state.adapt.t[rows]))
