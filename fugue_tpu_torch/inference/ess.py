"""Elliptical slice sampling: tuning-free inference for Gaussian priors.

The port of ``fugue_tpu/inference/ess.py``: ``_PriorAudit``,
``ESSConfig``, ``ESSResult``, ``make_ess_transition`` and ``ess_chain``
(Murray, Adams & MacKay, AISTATS 2010). For targets p(f) ∝ N(f; μ, Σ)·L(f)
the transition draws ν from the prior, then slice-samples an angle θ on
the ellipse through (f, ν),

    f' = μ + (f − μ)·cos θ + (ν − μ)·sin θ,

shrinking the bracket toward θ = 0 until log L(f') clears the slice level.
No step size, mass or trajectory length: nothing adapts.

All chains shrink in lock-step: each round evaluates the likelihood of
every chain in one batched model run (``log_likelihood + log_factors``;
the prior is exact by the ellipse's geometry), updates the chains still
shrinking under a mask, and reads one flag to the host (are any left?).
``ESSResult.host_reads`` counts those reads. A bracket exhausted after
``max_shrink`` rounds keeps the current state, the θ → 0 limit, which is
exact. Each transition's noise (the prior draw ν, the slice level, the
first angle and one uniform per shrink round) is an ``ESSNoise``, so the
tests can hand the transition the JAX package's own draws.

The contract is audited once at staging time (a replay that records each
site's prior, then one with shifted values): every continuous latent's
prior must be ``Normal`` or ``MultivariateNormal`` with parameters that
do not depend on other latents. Discrete sites are held fixed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.func import vmap

from .. import settings
from ..core.distributions import MultivariateNormal, Normal
from ..core.rng import fold_seed
from ..errors import ErrorCode, StagingError
from ..runtime.handler import Handler, run
from ..runtime.staging import StagedModel, stage
from ..runtime.trace import Trace

_TWO_PI = 2.0 * math.pi


class _PriorAudit(Handler):
    """Replay with pinned values while recording each site's prior
    distribution instance (the trace stores values, not distributions)."""

    def __init__(self, values: Dict[str, Any]):
        self.values = values
        self.dists: Dict[str, Any] = {}

    def on_sample(self, addr, dist, sample_shape):
        self.dists[str(addr)] = dist
        return self.values[str(addr)]

    def on_observe(self, addr, dist, value):
        return value

    def on_factor(self, log_weight):
        pass

    def finish(self) -> Trace:
        return Trace()


def _numpy(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, np.float64)


def _gaussian_prior_means(staged: StagedModel):
    """Audit every continuous latent prior (Normal or MultivariateNormal
    with latent-independent parameters) and return the flat prior-mean
    vector in the constrained flat layout. Raises ``StagingError``
    otherwise."""
    base = staged._discovery_trace.latents()
    audit = _PriorAudit(staged.merge_discrete(base))
    run(audit, staged.model_fn, *staged.args, **staged.kwargs)

    # every continuous prior must be Gaussian, checked before the
    # dependence probe: a shifted replay through a non-Gaussian model can
    # trip unrelated validation errors first
    for s in staged.continuous_sites:
        d1 = audit.dists[s.address]
        if not isinstance(d1, (Normal, MultivariateNormal)):
            raise StagingError(
                ErrorCode.NOT_STAGEABLE,
                f"elliptical slice sampling requires Normal/MultivariateNormal "
                f"priors; site {s.address!r} has {type(d1).__name__} — "
                "use HMC/NUTS/ChEES for general priors",
                {"site": s.address},
            )

    # the dependence probe: shift every continuous latent and re-audit; a
    # downstream validator may reject the shifted values, so retry with a
    # tiny shift before giving up
    audit2 = None
    for shift in (1.0, 1e-3):
        shifted = dict(staged.merge_discrete(base))
        for s in staged.continuous_sites:
            shifted[s.address] = torch.as_tensor(shifted[s.address]) + shift
        try:
            audit2 = _PriorAudit(shifted)
            run(audit2, staged.model_fn, *staged.args, **staged.kwargs)
            break
        except Exception:
            audit2 = None
    if audit2 is None:
        raise StagingError(
            ErrorCode.NOT_STAGEABLE,
            "could not verify that Gaussian prior parameters are "
            "independent of other latents (shifted replays failed "
            "validation); elliptical slice sampling needs that audit",
            {},
        )

    dt = settings.real_dtype()
    means = []
    for s in staged.continuous_sites:
        d1, d2 = audit.dists[s.address], audit2.dists[s.address]
        if isinstance(d1, Normal):
            p1, p2 = (d1.loc, d1.scale), (d2.loc, d2.scale)
        else:
            p1, p2 = (d1.loc, d1.scale_tril), (d2.loc, d2.scale_tril)
        if not all(np.allclose(_numpy(a), _numpy(b)) for a, b in zip(p1, p2)):
            raise StagingError(
                ErrorCode.NOT_STAGEABLE,
                f"prior parameters of site {s.address!r} depend on other "
                "latent sites (centered hierarchy); rewrite in non-centered "
                "form (theta_raw ~ N(0,1), scale applied outside the prior) "
                "for elliptical slice sampling",
                {"site": s.address},
            )
        loc = torch.as_tensor(d1.loc).to(device=staged.device, dtype=dt)
        means.append(torch.broadcast_to(loc, s.shape).reshape(-1))
    if not means:
        raise StagingError(
            ErrorCode.NOT_STAGEABLE,
            "model has no continuous latent sites; use MH",
            {},
        )
    return torch.cat(means)


@dataclass(frozen=True)
class ESSConfig:
    max_shrink: int = 30  # bracket-shrink bound; θ→0 degrades to f (exact)


@dataclass
class ESSResult:
    samples: Dict[str, Any]  # addr -> (n_chains, n_samples, ...)
    log_lik: Any  # (n_chains, n_samples) — non-prior accumulators at samples
    mean_shrink_iters: float  # likelihood evals per transition (cost metric)
    final_flat: Any  # (n_chains, d) constrained flat positions
    host_reads: int = 0  # one per lock-step shrink round


@dataclass
class ESSNoise:
    """One transition's draws for C chains."""

    nu: Any  # (C, D) prior draws in the constrained flat layout
    log_u: Any  # (C,) log-uniforms of the slice level
    theta0: Any  # (C,) first angles, uniform on [0, 2π)
    shrink: Any  # (max_shrink, C) uniforms on [0, 1), one per shrink round


def _batched_loglik(staged: StagedModel, discrete):
    """(C, D) constrained flat positions → (C,) non-prior accumulators
    (log_likelihood + log_factors), in one batched model run."""

    def loglik(flat):
        lat = staged.unflatten_constrained(flat)
        parts = staged.log_density_parts(staged.merge_discrete(lat, discrete))
        return parts.log_likelihood + parts.log_factors

    return vmap(loglik)


def make_ess_transition(staged: StagedModel, mu, config: ESSConfig,
                        discrete: Optional[Dict[str, Any]] = None):
    """``transition(f, ll_f, noise) → (f', ll', evaluations (C,), host
    reads)`` for a batch of C chains in the constrained flat layout (every
    site is real by the Gaussian-prior contract); ``ll_f`` is the current
    log-likelihood (C,)."""

    batched_loglik = _batched_loglik(staged, discrete)

    def transition(f, ll_f, noise: ESSNoise):
        log_y = ll_f + noise.log_u
        theta = noise.theta0
        lo, hi = theta - _TWO_PI, theta
        done = torch.zeros_like(ll_f, dtype=torch.bool)
        f_acc, ll_acc = f, ll_f
        iters = torch.zeros_like(ll_f, dtype=torch.int32)
        reads = 0
        for it in range(config.max_shrink):
            if it > 0:
                reads += 1
                if not bool(torch.any(~done)):
                    break
            active = ~done
            fp = mu + (f - mu) * torch.cos(theta)[:, None] + (noise.nu - mu) * torch.sin(theta)[:, None]
            ll_p = batched_loglik(fp)
            ok = active & (ll_p > log_y)
            f_acc = torch.where(ok[:, None], fp, f_acc)
            ll_acc = torch.where(ok, ll_p, ll_acc)
            # shrink toward 0 on reject (Murray et al. fig. 2)
            rej = active & ~ok
            neg = theta < 0
            lo = torch.where(rej & neg, theta, lo)
            hi = torch.where(rej & ~neg, theta, hi)
            theta = torch.where(rej, lo + (hi - lo) * noise.shrink[it], theta)
            iters = iters + active.to(iters.dtype)
            done = done | ok
        return f_acc, ll_acc, iters, reads

    return transition


def draw_ess_noise(staged: StagedModel, generator: torch.Generator, seed: int, n: int,
                   config: ESSConfig) -> ESSNoise:
    """One transition's draws: ν from ONE batched prior run seeded with
    ``seed``, the rest from ``generator``."""
    dt, dev = settings.real_dtype(), staged.device
    nu = staged.flatten_constrained(staged.sample_prior_batch(seed, n)).to(dt)

    def uniform(shape):
        return torch.rand(shape, generator=generator, device=dev, dtype=dt)

    return ESSNoise(nu=nu, log_u=torch.log1p(-uniform((n,))), theta0=_TWO_PI * uniform((n,)),
                    shrink=uniform((config.max_shrink, n)))


def ess_chain(
    seed: int,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 200,
    config: ESSConfig = ESSConfig(),
    *,
    n_chains: int = 64,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    discrete: Optional[Dict[str, Any]] = None,
    device="cuda",
) -> ESSResult:
    """Elliptical slice sampling over the Gaussian-prior latents, all
    chains as one batch.

    ``n_warmup`` is plain burn-in (nothing adapts). The audit (Gaussian
    priors with latent-independent parameters) runs first and raises
    ``StagingError`` on a violation. ``seed`` seeds one ``torch.Generator``
    on the staged model's device and the per-transition prior draws;
    ``device`` is used only when ``staged`` is not given."""
    if staged is None:
        staged = stage(model_fn, *model_args, device=device)
    dt = settings.real_dtype()
    mu = _gaussian_prior_means(staged)
    transition = make_ess_transition(staged, mu, config, discrete)
    generator = torch.Generator(device=staged.device).manual_seed(int(seed))

    f = staged.flatten_constrained(staged.sample_prior_batch(fold_seed(seed, 31), n_chains)).to(dt)
    ll = _batched_loglik(staged, discrete)(f)
    fs, lls, iters, reads = [], [], [], 0
    for t in range(n_warmup + n_samples):
        noise = draw_ess_noise(staged, generator, fold_seed(seed, 32, t), n_chains, config)
        f, ll, it, r = transition(f, ll, noise)
        reads += r
        iters.append(it)
        if t >= n_warmup:
            fs.append(f)
            lls.append(ll)
    positions = torch.stack(fs, dim=1) if fs else f.new_zeros((n_chains, 0, f.shape[-1]))
    return ESSResult(
        samples=staged.unflatten_constrained(positions),
        log_lik=torch.stack(lls, dim=1) if lls else ll.new_zeros((n_chains, 0)),
        mean_shrink_iters=float(torch.mean(torch.stack(iters).to(dt))) if iters else 0.0,
        final_flat=f,
        host_reads=reads + 1,  # and the mean of the evaluation counts
    )
