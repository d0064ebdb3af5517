"""Stable log-space numerics on tensors.

The port of ``log_sum_exp``, ``log1p_exp`` and ``compensated_sum`` from
``fugue_tpu/core/numerics.py``. Everything accepts batched inputs and an
``dim`` argument, and runs under ``torch.func`` transforms.
"""

from __future__ import annotations

import torch


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


def log1p_exp(x: torch.Tensor):
    """log(1 + exp(x)), stable for large |x|."""
    pos = x > 0
    return torch.where(
        pos,
        x + torch.log1p(torch.exp(-torch.where(pos, x, torch.zeros_like(x)))),
        torch.log1p(torch.exp(torch.where(pos, torch.zeros_like(x), x))),
    )


def compensated_sum(x: torch.Tensor):
    """Full-array sum with near-float64 accuracy for float32 input.

    The JAX package sums 4096-element blocks and runs a Neumaier scan over
    the partials, because a TPU has no fast float64. The card has float64
    arithmetic, so the whole reduction accumulates in float64 and rounds
    once to the input dtype: the error is half an ulp of the result, with
    no sequential loop. Gradients flow (d/dx_i = 1 exactly).
    """
    return torch.sum(x.reshape(-1), dtype=torch.float64).to(x.dtype)
