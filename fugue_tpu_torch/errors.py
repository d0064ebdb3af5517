"""Typed error taxonomy for the PyTorch port.

The port of ``fugue_tpu/errors.py``: the same codes, categories and error
classes, so a caller catches the same types from either package. Structural
errors (invalid parameters, address conflicts, staging) are raised on the
host while a model runs eagerly. Inside a ``torch.func`` transform, where the
HMC drive evaluates every potential, parameters are not validated: invalid
regions give ``-inf`` / ``nan`` log-weights instead, as under ``jit`` in the
JAX package, and no check forces a device-to-host copy.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional

import numpy as np
import torch


class ErrorCode(enum.IntEnum):
    """Stable numeric error codes (same values as ``fugue_tpu.errors``)."""

    # 1xx — invalid distribution parameters
    INVALID_MEAN = 100
    INVALID_VARIANCE = 101
    INVALID_PROBABILITY = 102
    INVALID_RANGE = 103
    INVALID_SHAPE = 104
    INVALID_RATE = 105
    INVALID_COUNT = 106
    # 3xx — model-structure errors
    ADDRESS_CONFLICT = 301
    UNEXPECTED_MODEL_STRUCTURE = 302
    # 5xx — trace access errors
    TRACE_ADDRESS_NOT_FOUND = 500
    # 6xx — type errors
    TYPE_MISMATCH = 600
    # 7xx — staging errors
    NOT_STAGEABLE = 700
    INVALID_SHARDING = 701


class ErrorCategory(enum.Enum):
    """Coarse grouping of error codes."""

    VALIDATION = "validation"
    MODEL_STRUCTURE = "model_structure"
    TRACE_ACCESS = "trace_access"
    TYPE = "type"
    STAGING = "staging"

    @staticmethod
    def of(code: ErrorCode) -> "ErrorCategory":
        n = int(code)
        if n < 300:
            return ErrorCategory.VALIDATION
        if n < 500:
            return ErrorCategory.MODEL_STRUCTURE
        if n < 600:
            return ErrorCategory.TRACE_ACCESS
        if n < 700:
            return ErrorCategory.TYPE
        return ErrorCategory.STAGING


@dataclass
class ErrorContext:
    """Key-value context attached to an error."""

    items: dict = field(default_factory=dict)

    def render(self) -> str:
        return ", ".join(f"{k}={v!r}" for k, v in self.items.items())


class FugueError(Exception):
    """Base error with a stable code + category + context."""

    def __init__(
        self,
        code: ErrorCode,
        message: str,
        context: Optional[Mapping[str, Any]] = None,
    ):
        self.code = code
        self.category = ErrorCategory.of(code)
        self.context = ErrorContext(dict(context or {}))
        super().__init__(self._render(message))

    def _render(self, message: str) -> str:
        ctx = self.context.render()
        tail = f" [{ctx}]" if ctx else ""
        return f"[{self.code.name}({int(self.code)})] {message}{tail}"


class ValidationError(FugueError):
    """Invalid distribution parameter (1xx codes)."""


class ModelStructureError(FugueError):
    """Address conflicts / unexpected structure (3xx codes)."""


class TraceAccessError(FugueError):
    """Missing address in a trace (5xx codes)."""


class TypeMismatchError(FugueError):
    """Wrong value type requested from a trace (600)."""


class StagingError(FugueError):
    """Model cannot be staged into a fixed site table (7xx codes)."""


def address_conflict(addr: str) -> ModelStructureError:
    """Duplicate sample address within one execution."""
    return ModelStructureError(
        ErrorCode.ADDRESS_CONFLICT,
        f"duplicate address {addr!r}: each sample/observe site must have a "
        "unique address within one model execution",
        {"address": addr},
    )


def unexpected_structure(msg: str, **ctx: Any) -> ModelStructureError:
    return ModelStructureError(ErrorCode.UNEXPECTED_MODEL_STRUCTURE, msg, ctx)


def trace_address_not_found(addr: str) -> TraceAccessError:
    return TraceAccessError(
        ErrorCode.TRACE_ADDRESS_NOT_FOUND,
        f"address {addr!r} not present in trace",
        {"address": addr},
    )


# ---------------------------------------------------------------------------
# Parameter validation helpers. They run eagerly on concrete parameters at
# distribution construction. A value is concrete unless a torch.func
# transform is active or the value is a functorch-wrapped tensor: the HMC
# drive evaluates potentials under vmap(grad), and validating there would
# both break vmap and stall the card on every leapfrog step.
# ---------------------------------------------------------------------------


def _in_transform() -> bool:
    return torch._C._functorch.maybe_current_level() is not None


def _is_concrete(x: Any) -> bool:
    """True if ``x`` is a value we can validate eagerly."""
    if isinstance(x, (bool, int, float)):
        return True
    if isinstance(x, torch.Tensor):
        return not (
            _in_transform() or torch._C._functorch.is_functorch_wrapped_tensor(x)
        )
    if isinstance(x, (np.ndarray, np.generic)):
        return True
    if isinstance(x, (list, tuple)):
        return np.asarray(x).dtype != object
    return False


def _as_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def check_finite(name: str, value: Any, code: ErrorCode) -> None:
    if _is_concrete(value) and not np.all(np.isfinite(_as_numpy(value))):
        raise ValidationError(code, f"{name} must be finite", {name: value})


def check_positive(name: str, value: Any, code: ErrorCode) -> None:
    if not _is_concrete(value):
        return
    v = _as_numpy(value)
    if not np.all(np.isfinite(v)) or not np.all(v > 0):
        raise ValidationError(
            code, f"{name} must be positive and finite", {name: value}
        )
