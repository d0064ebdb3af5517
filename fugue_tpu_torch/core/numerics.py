"""Stable log-space numerics on tensors.

The port of ``fugue_tpu/core/numerics.py``: ``log_sum_exp`` and its
weighted form, ``normalize_log_probs``, ``log1p_exp``, ``safe_log``,
``logit``, ``log_expm1``, ``softplus`` and its inverse, ``log_gamma``,
``log_beta`` and ``compensated_sum``. Everything accepts batched inputs and
a ``dim`` argument where it reduces, and runs under ``torch.func``
transforms.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

log_gamma = torch.lgamma


def log_sum_exp(x: torch.Tensor, dim: int = -1, keepdim: bool = False):
    """log(sum(exp(x))) with the max-shift trick; -inf-safe.

    All -inf inputs return -inf rather than nan; +inf returns +inf.
    """
    m = torch.amax(x, dim=dim, keepdim=True)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.zeros_like(m))
    out = m_safe + torch.log(torch.sum(torch.exp(x - m_safe), dim=dim, keepdim=True))
    out = torch.where(finite, out, m)
    if not keepdim:
        out = out.squeeze(dim)
    return out


def weighted_log_sum_exp(x, log_w, dim: int = -1, keepdim: bool = False):
    """log(sum(w_i * exp(x_i))) given log-weights."""
    return log_sum_exp(x + log_w, dim=dim, keepdim=keepdim)


def normalize_log_probs(log_p, dim: int = -1):
    """Log-probabilities → probabilities summing to 1; all -inf → zeros."""
    lse = log_sum_exp(log_p, dim=dim, keepdim=True)
    finite = torch.isfinite(lse)
    p = torch.exp(log_p - torch.where(finite, lse, torch.zeros_like(lse)))
    return torch.where(finite, p, torch.zeros_like(p))


def log1p_exp(x: torch.Tensor):
    """log(1 + exp(x)), stable for large |x|."""
    pos = x > 0
    return torch.where(
        pos,
        x + torch.log1p(torch.exp(-torch.where(pos, x, torch.zeros_like(x)))),
        torch.log1p(torch.exp(torch.where(pos, torch.zeros_like(x), x))),
    )


def safe_log(x, floor: float = 0.0):
    """log(x) where x > floor, -inf elsewhere (never nan)."""
    ok = x > floor
    return torch.where(ok, torch.log(torch.where(ok, x, torch.ones_like(x))), -torch.inf)


def logit(p):
    return torch.log(p) - torch.log1p(-p)


def log_expm1(x):
    """log(exp(x) - 1), stable for small and large x (softplus inverse)."""
    big = x > 20.0
    return torch.where(big, x, torch.log(torch.expm1(torch.where(big, torch.ones_like(x), x))))


def softplus(x):
    return F.softplus(x)


def inv_softplus(y):
    """Inverse of softplus; y must be positive."""
    return log_expm1(y)


def _algdiv(a, b):
    """log Γ(b) − log Γ(a + b) for b >= 8 and a <= b: the series of
    cdflib's ``algdiv``, as the JAX package's ``betaln`` evaluates it."""
    c0, c1, c2 = 0.833333333333333e-01, -0.277777777760991e-02, 0.793650666825390e-03
    c3, c4, c5 = -0.595202931351870e-03, 0.837308034031215e-03, -0.165322962780713e-02
    h = a / b
    x = h / (1 + h)
    d = b + (a - 0.5)
    x2 = x * x
    s3 = 1.0 + (x + x2)
    s5 = 1.0 + (x + x2 * s3)
    s7 = 1.0 + (x + x2 * s5)
    s9 = 1.0 + (x + x2 * s7)
    s11 = 1.0 + (x + x2 * s9)
    t = (1.0 / b) ** 2
    w = ((((c5 * s11 * t + c4 * s9) * t + c3 * s7) * t + c2 * s5) * t + c1 * s3) * t + c0
    w = w * (x / b)
    u = d * torch.log1p(a / b)
    v = a * (torch.log(b) - 1.0)
    return torch.where(u <= v, (w - v) - u, (w - u) - v)


def log_beta(a, b):
    """log B(a, b) for tensors, as the JAX package's ``betaln``: the plain
    lgamma sum below b = 8, the ``algdiv`` series above, which keeps the
    digits the sum cancels for large arguments."""
    a, b = torch.minimum(a, b), torch.maximum(a, b)
    small_b = torch.lgamma(a) + (torch.lgamma(b) - torch.lgamma(a + b))
    large_b = torch.lgamma(a) + _algdiv(a, b)
    return torch.where(b < 8, small_b, large_b)


def compensated_sum(x: torch.Tensor):
    """Full-array sum with near-float64 accuracy for float32 input.

    The JAX package sums 4096-element blocks and runs a Neumaier scan over
    the partials, because a TPU has no fast float64. The card has float64
    arithmetic, so the whole reduction accumulates in float64 and rounds
    once to the input dtype: the error is half an ulp of the result, with
    no sequential loop. Gradients flow (d/dx_i = 1 exactly).
    """
    return torch.sum(x.reshape(-1), dtype=torch.float64).to(x.dtype)
