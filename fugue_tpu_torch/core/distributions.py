"""Distributions as ``(sample, log_prob)`` pairs on tensors.

The port of ``Support``, ``Distribution``, ``Normal`` and ``LogNormal`` from
``fugue_tpu/core/distributions.py``; the other classes there wait for later
slices.

- ``sample(generator, sample_shape)`` draws with an explicit
  ``torch.Generator``, on the generator's device.
- ``log_prob(x)`` is a vectorized log-space formula valid for batched ``x``.
  Python-number parameters stay Python numbers, so scoring allocates no
  constant tensors; invalid support regions give ``-inf``.
- Parameters are validated eagerly when they are concrete (see
  ``errors._is_concrete``) and raise the JAX package's error codes.
- Samples take the dtype of a floating tensor parameter if there is one
  (float64 by input dtype), else ``settings.real_dtype()``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import settings
from ..errors import ErrorCode, check_finite, check_positive

_LOG_2PI = math.log(2.0 * math.pi)


# ---------------------------------------------------------------------------
# Supports
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Support:
    """Declared support of a distribution; ``kind`` picks the transform."""

    kind: str  # real | positive | unit | interval | boolean | count |
    #            int_range | categorical | simplex
    low: Optional[float] = None
    high: Optional[float] = None
    size: Optional[int] = None  # number of categories for categorical

    @property
    def is_continuous(self) -> bool:
        return self.kind in ("real", "positive", "unit", "interval", "simplex")

    @property
    def is_discrete(self) -> bool:
        return not self.is_continuous


REAL = Support("real")
POSITIVE = Support("positive")


# ---------------------------------------------------------------------------
# Helpers: Python numbers stay Python numbers
# ---------------------------------------------------------------------------


def _param(x):
    """A parameter as a tensor or a Python float (numpy → CPU tensor)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (np.ndarray, np.generic, list, tuple)):
        return torch.as_tensor(np.asarray(x, dtype=np.float64))
    return float(x)


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else math.log(x)


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else ()


# ---------------------------------------------------------------------------
# Base class
# ---------------------------------------------------------------------------


class Distribution:
    """Base distribution interface; scalar event shape."""

    support: Support = REAL

    def _params(self):
        return ()

    @property
    def dtype(self) -> torch.dtype:
        for p in self._params():
            if isinstance(p, torch.Tensor) and p.is_floating_point():
                return p.dtype
        return settings.real_dtype()

    def _batch_shape(self) -> Tuple[int, ...]:
        return tuple(torch.broadcast_shapes(*[_shape(p) for p in self._params()]))

    def _full_shape(self, sample_shape) -> Tuple[int, ...]:
        return tuple(sample_shape) + self._batch_shape()

    def sample(self, generator: torch.Generator, sample_shape=()):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def unconstraining_transform(self):
        """The bijector z ∈ R ↔ x ∈ support used by gradient-based kernels."""
        from .transforms import transform_for_support

        return transform_for_support(self.support)

    def __repr__(self):
        params = ", ".join(f"{v}" for v in self._params())
        return f"{type(self).__name__}({params})"


def _standard_normal(dist: Distribution, generator, sample_shape):
    return torch.randn(
        dist._full_shape(sample_shape),
        generator=generator,
        device=generator.device,
        dtype=dist.dtype,
    )


# ---------------------------------------------------------------------------
# Continuous distributions
# ---------------------------------------------------------------------------


class Normal(Distribution):
    """Normal(mean, std)."""

    support = REAL

    def __init__(self, loc, scale):
        check_finite("mean", loc, ErrorCode.INVALID_MEAN)
        check_positive("std", scale, ErrorCode.INVALID_VARIANCE)
        self.loc = _param(loc)
        self.scale = _param(scale)

    def _params(self):
        return (self.loc, self.scale)

    def sample(self, generator, sample_shape=()):
        return self.loc + self.scale * _standard_normal(self, generator, sample_shape)

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -0.5 * z * z - _log(self.scale) - 0.5 * _LOG_2PI


class LogNormal(Distribution):
    """LogNormal(mu, sigma) of the underlying normal."""

    support = POSITIVE

    def __init__(self, loc, scale):
        check_finite("mu", loc, ErrorCode.INVALID_MEAN)
        check_positive("sigma", scale, ErrorCode.INVALID_VARIANCE)
        self.loc = _param(loc)
        self.scale = _param(scale)

    def _params(self):
        return (self.loc, self.scale)

    def sample(self, generator, sample_shape=()):
        return torch.exp(
            self.loc + self.scale * _standard_normal(self, generator, sample_shape)
        )

    def log_prob(self, value):
        x = torch.as_tensor(value)
        positive = x > 0
        lx = torch.log(torch.where(positive, x, torch.ones_like(x)))
        z = (lx - self.loc) / self.scale
        lp = -lx - _log(self.scale) - 0.5 * _LOG_2PI - 0.5 * z * z
        return torch.where(positive, lp, torch.full_like(lp, -math.inf))
