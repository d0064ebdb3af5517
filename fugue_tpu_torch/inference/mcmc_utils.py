"""MCMC estimation utilities: autocovariance, ESS, R-hat and adaptation.

The port of ``autocovariance``, ``_geyer_tau``, ``ess``, ``ess_multichain``,
``r_hat``, ``split_r_hat``, ``AdaptationState`` and ``adapt_update`` from
``fugue_tpu/inference/mcmc_utils.py``. Every estimator is batched over
leading dimensions; autocovariances for all lags come from one ``torch.fft``
transform. Rank-normalized R-hat and Geweke wait for a later slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from .. import settings

MAX_LAG = 2048  # reference lag cap


def _float(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.float32)


def autocovariance(x, max_lag: Optional[int] = None):
    """Biased (1/n) autocovariance of ``x`` along the last dim, all lags at
    once via FFT. Shape (..., n) → (..., L+1)."""
    x = _float(x)
    n = x.shape[-1]
    if max_lag is None:
        max_lag = min(n - 1, MAX_LAG)
    xc = x - torch.mean(x, dim=-1, keepdim=True)
    # next power of two >= 2n for linear (non-circular) autocorrelation
    m = 2 ** math.ceil(math.log2(max(2 * n, 2)))
    f = torch.fft.rfft(xc, n=m, dim=-1)
    acov = torch.fft.irfft(f * torch.conj(f), n=m, dim=-1)[..., : max_lag + 1]
    return acov / n


def _geyer_tau(rho):
    """Integrated autocorrelation time from normalized autocorrelations via
    Geyer's initial positive + monotone sequence.

    ``rho``: (..., L+1) with rho[..., 0] == 1. Returns (...,) tau > 0.
    """
    n_pairs = rho.shape[-1] // 2
    pair = rho[..., 0 : 2 * n_pairs : 2] + rho[..., 1 : 2 * n_pairs : 2]
    # the first non-positive pair truncates the sum (initial positive seq)
    keep = torch.cumprod((pair > 0).to(pair.dtype), dim=-1) > 0
    pair_mono = torch.cummin(pair, dim=-1).values
    contrib = torch.where(keep, pair_mono, torch.zeros_like(pair_mono))
    tau = -1.0 + 2.0 * torch.sum(contrib, dim=-1)
    return torch.clamp(tau, min=1e-12)


def ess(x, max_lag: Optional[int] = None):
    """Single-chain effective sample size along the last dim: n / tau with
    Geyer truncation. Batched over leading dims."""
    x = _float(x)
    n = x.shape[-1]
    acov = autocovariance(x, max_lag)
    var0 = acov[..., :1]
    rho = torch.where(var0 > 0, acov / torch.where(var0 > 0, var0, torch.ones_like(var0)),
                      torch.zeros_like(acov))
    out = n / _geyer_tau(rho)
    out = torch.where(var0[..., 0] > 0, out, torch.zeros_like(out))
    return torch.clamp(out, max=float(n))


def ess_multichain(chains, max_lag: Optional[int] = None):
    """Vehtari multi-chain ESS: per-chain autocovariances normalized by the
    pooled W+B variance estimate. ``chains``: (..., m, n) → (...,)."""
    x = _float(chains)
    m, n = x.shape[-2], x.shape[-1]
    chain_means = torch.mean(x, dim=-1)
    w = torch.mean(torch.var(x, dim=-1, correction=1), dim=-1)  # within
    b = n * torch.var(chain_means, dim=-1, correction=1) if m > 1 else torch.zeros_like(w)
    var_plus = (n - 1) / n * w + b / n
    mean_acov = torch.mean(autocovariance(x, max_lag), dim=-2)
    vp = var_plus[..., None]
    rho = 1.0 - (w[..., None] - mean_acov) / torch.where(vp > 0, vp, torch.ones_like(vp))
    rho = torch.cat([torch.ones_like(rho[..., :1]), rho[..., 1:]], dim=-1)
    total = m * n
    out = total / _geyer_tau(rho)
    out = torch.where(var_plus > 0, out, torch.zeros_like(out))
    return torch.clamp(out, max=float(total))


def r_hat(chains):
    """Classic Gelman-Rubin potential scale reduction. (..., m, n) → (...,)."""
    x = _float(chains)
    n = x.shape[-1]
    chain_means = torch.mean(x, dim=-1)
    w = torch.mean(torch.var(x, dim=-1, correction=1), dim=-1)
    b = n * torch.var(chain_means, dim=-1, correction=1)
    var_plus = (n - 1) / n * w + b / n
    return torch.sqrt(var_plus / torch.where(w > 0, w, torch.ones_like(w)))


def split_r_hat(chains):
    """Split-R-hat: halve each chain, then Gelman-Rubin over 2m half-chains."""
    x = torch.as_tensor(chains)
    n = x.shape[-1]
    half = n // 2
    split = torch.cat([x[..., :half], x[..., n - half : n]], dim=-2)
    return r_hat(split)


# ---------------------------------------------------------------------------
# Diminishing adaptation
# ---------------------------------------------------------------------------


@dataclass
class AdaptationState:
    """Per-site proposal-scale adaptation state: one slot per site, or per
    (chain, site) when batched. Log-scales move toward a target acceptance
    rate with a Robbins-Monro decayed step (diminishing adaptation)."""

    log_scale: Any
    t: Any  # adaptation step count (per slot)

    @staticmethod
    def init(n_sites: int, initial_scale: float = 1.0, batch_shape=(), *,
             dtype=None, device=None) -> "AdaptationState":
        shape = tuple(batch_shape) + (n_sites,)
        dtype = dtype or settings.real_dtype()
        return AdaptationState(
            log_scale=torch.full(shape, math.log(initial_scale), dtype=dtype, device=device),
            t=torch.zeros(shape, dtype=dtype, device=device),
        )

    def scale(self):
        return torch.exp(self.log_scale)


def adapt_update(
    state: AdaptationState,
    site_mask,
    accepted,
    target: float = 0.44,
    decay: float = 0.6,
    max_log_step: float = 1.0,
    frozen: bool = False,
) -> AdaptationState:
    """One diminishing-adaptation update.

    ``site_mask``: one-hot (or boolean) over sites selecting the slot(s) that
    moved; ``accepted``: the acceptance outcome, per chain or shared.
    log-scale += step * (acc - target) with step = min(max_log_step,
    t^-decay). ``frozen=True`` is the post-warmup no-op.
    """
    if frozen:
        return state
    ls = state.log_scale
    mask = torch.as_tensor(site_mask, dtype=ls.dtype, device=ls.device)
    acc = torch.as_tensor(accepted, dtype=ls.dtype, device=ls.device)
    if acc.dim() == mask.dim() - 1:
        acc = acc[..., None]  # per-chain acceptance -> broadcast over sites
    t_new = state.t + mask
    step = torch.clamp(torch.pow(torch.clamp(t_new, min=1.0), -decay), max=max_log_step)
    return AdaptationState(log_scale=ls + mask * step * (acc - target), t=t_new)
