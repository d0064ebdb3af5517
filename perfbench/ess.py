"""The benchmark's effective sample size, in NumPy float64: a frozen copy
of the port's ``inference.mcmc_utils.ess_multichain`` (Vehtari et al.'s
pooled multi-chain estimator: per-chain autocovariances by FFT, normalised
by the pooled W + B variance, Geyer's initial positive and monotone
sequence), so that the yardstick does not move when the program does."""

from __future__ import annotations

import math

import numpy as np

MAX_LAG = 2048


def autocovariance(x: np.ndarray, max_lag: int | None = None) -> np.ndarray:
    """Biased (1/n) autocovariance along the last axis: (..., n) → (..., L+1)."""
    n = x.shape[-1]
    if max_lag is None:
        max_lag = min(n - 1, MAX_LAG)
    xc = x - x.mean(axis=-1, keepdims=True)
    m = 2 ** math.ceil(math.log2(max(2 * n, 2)))
    f = np.fft.rfft(xc, n=m, axis=-1)
    acov = np.fft.irfft(f * np.conj(f), n=m, axis=-1)[..., : max_lag + 1]
    return acov / n


def geyer_tau(rho: np.ndarray) -> np.ndarray:
    """Integrated autocorrelation time from normalised autocorrelations
    (rho[..., 0] == 1): pairs summed until the first non-positive pair,
    made monotone. (..., L+1) → (...,)."""
    n_pairs = rho.shape[-1] // 2
    pair = rho[..., 0: 2 * n_pairs: 2] + rho[..., 1: 2 * n_pairs: 2]
    keep = np.cumprod(pair > 0, axis=-1) > 0
    mono = np.minimum.accumulate(pair, axis=-1)
    tau = -1.0 + 2.0 * np.sum(np.where(keep, mono, 0.0), axis=-1)
    return np.maximum(tau, 1e-12)


def ess_multichain(chains) -> np.ndarray:
    """Pooled ESS of (..., m chains, n draws) → (...,), capped at m·n."""
    x = np.asarray(chains, dtype=np.float64)
    m, n = x.shape[-2], x.shape[-1]
    w = np.mean(np.var(x, axis=-1, ddof=1), axis=-1)
    b = n * np.var(x.mean(axis=-1), axis=-1, ddof=1) if m > 1 else np.zeros_like(w)
    var_plus = (n - 1) / n * w + b / n
    mean_acov = np.mean(autocovariance(x), axis=-2)
    vp = var_plus[..., None]
    rho = 1.0 - (w[..., None] - mean_acov) / np.where(vp > 0, vp, 1.0)
    rho[..., 0] = 1.0
    out = (m * n) / geyer_tau(rho)
    out = np.where(var_plus > 0, out, 0.0)
    return np.minimum(out, float(m * n))
