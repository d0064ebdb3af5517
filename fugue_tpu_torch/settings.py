"""Global dtype / precision policy.

The port of ``fugue_tpu/settings.py``. The card runs float32 by default;
float64 comes under a flag (``enable_x64(True)``), which the CPU parity
tests use, or by input dtype: a distribution with a float64 tensor parameter
samples and scores in float64 whatever the flag.

These are functions, not constants, so that flipping the flag in a test
fixture is respected.
"""

from __future__ import annotations

import os

import torch

_X64 = False


def enable_x64(on: bool) -> None:
    """Turn float64 on or off (off is the default)."""
    global _X64
    _X64 = bool(on)


def x64_enabled() -> bool:
    return _X64


def real_dtype() -> torch.dtype:
    return torch.float64 if x64_enabled() else torch.float32


# Accumulation policy for large observation plates: per-site log-prob sums
# of >= COMPENSATED_SUM_THRESHOLD elements go through
# core.numerics.compensated_sum. Below it a plain reduction is exact enough.
# Override with FUGUE_TPU_COMPENSATED_SUM=<n> (0 disables), the variable the
# JAX package reads, so one setting governs both.
COMPENSATED_SUM_THRESHOLD = 1 << 16


def compensated_sum_threshold() -> int:
    v = os.environ.get("FUGUE_TPU_COMPENSATED_SUM")
    if v is None or v == "":
        return COMPENSATED_SUM_THRESHOLD
    n = int(v)
    return n if n > 0 else (1 << 62)
