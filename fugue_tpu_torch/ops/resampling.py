"""Particle resampling.

The port of ``fugue_tpu/ops/resampling.py``: weight normalisation, the
effective sample size, and the systematic, stratified and multinomial
ancestor draws. Each draw takes an explicit ``torch.Generator`` and returns
int64 ancestor indices, so a caller gathers any particle dict with one
index per tensor.

On a 1-D weight vector every log-sum-exp here goes through
``ops.kernels.plogsumexp``, and ``systematic_resample`` goes through
``ops.kernels.psystematic_resample``: on a CUDA tensor those are the CUDA
kernels, on a CPU tensor their plain versions. Batched (..., N) weights
take ``core.numerics.log_sum_exp`` and the plain inverse-CDF path.
"""

from __future__ import annotations

import torch

from ..core.numerics import log_sum_exp
from . import kernels as K


def _lse(log_weights):
    if log_weights.dim() == 1:
        return K.plogsumexp(log_weights)
    return log_sum_exp(log_weights, dim=-1)


def normalize_log_weights(log_weights):
    """log-weights → (normalized weights, log of the normalizer)."""
    lse = _lse(log_weights)
    return torch.exp(log_weights - lse[..., None]), lse


def effective_sample_size(log_weights):
    """ESS = 1 / Σ normalized_w² = exp(2·lse(lw) − lse(2·lw))."""
    return torch.exp(2.0 * _lse(log_weights) - _lse(2.0 * log_weights))


def _indices_from_uniforms(weights, us):
    """Invert the weight CDF at sorted uniforms ``us`` (n,)."""
    cdf = torch.cumsum(weights, dim=-1)
    cdf = cdf / cdf[..., -1:]  # guard tiny normalization drift
    us = us.expand(*cdf.shape[:-1], us.shape[-1]).contiguous()
    return torch.clamp(torch.searchsorted(cdf, us, side="left"), 0, weights.shape[-1] - 1)


def systematic_resample(generator: torch.Generator, log_weights, n: int = None):
    """Systematic resampling: one uniform, a stratified comb. A 1-D vector
    resampled to its own size takes ``psystematic_resample``."""
    N = log_weights.shape[-1]
    n = n or N
    if log_weights.dim() == 1 and n == N:
        return K.psystematic_resample(generator, log_weights)
    w, _ = normalize_log_weights(log_weights)
    u0 = torch.rand((), generator=generator, device=w.device, dtype=w.dtype)
    us = (torch.arange(n, dtype=w.dtype, device=w.device) + u0) / n
    return _indices_from_uniforms(w, us)


def stratified_resample(generator: torch.Generator, log_weights, n: int = None):
    """Stratified resampling: an independent uniform per stratum."""
    n = n or log_weights.shape[-1]
    w, _ = normalize_log_weights(log_weights)
    u = torch.rand((n,), generator=generator, device=w.device, dtype=w.dtype)
    us = (torch.arange(n, dtype=w.dtype, device=w.device) + u) / n
    return _indices_from_uniforms(w, us)


def multinomial_resample(generator: torch.Generator, log_weights, n: int = None):
    """Multinomial resampling: n independent categorical draws."""
    N = log_weights.shape[-1]
    n = n or N
    w, _ = normalize_log_weights(log_weights)
    idx = torch.multinomial(w.reshape(-1, N), n, replacement=True, generator=generator)
    return idx.reshape(*log_weights.shape[:-1], n)


RESAMPLERS = {
    "systematic": systematic_resample,
    "stratified": stratified_resample,
    "multinomial": multinomial_resample,
}
