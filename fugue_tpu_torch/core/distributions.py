"""Distributions as ``(sample, log_prob)`` pairs on tensors.

The port of ``fugue_tpu/core/distributions.py``: the supports, the base
class and all 24 distributions, with the JAX package's parameter
validation, error codes and value dtypes (bool for the Bernoulli pair,
``settings.int_dtype()`` for categories, ``settings.counting_dtype()`` for
the drawn counts, a real dtype for the rest).

- ``sample(generator, sample_shape)`` draws with an explicit
  ``torch.Generator``, on the generator's device. Every sampler draws
  through ``randn``, ``rand`` or ``torch._standard_gamma``, ``poisson`` and
  ``binomial``, which take the generator under
  ``vmap(..., randomness="different")``, so ``StagedModel.sample_prior_batch``
  draws a whole particle batch in one model run. In-place samplers such as
  ``Tensor.exponential_`` do not, so Exponential, Weibull, Laplace, Cauchy
  and Geometric draw a uniform and invert their CDF.
- ``log_prob(x)`` is a vectorized log-space formula valid for batched
  ``x``. Python-number parameters stay Python numbers where a formula
  allows it, so scoring allocates few constant tensors; invalid support
  regions give ``-inf``. Out-of-support values are replaced by a safe
  in-support value before any log (the double-``where`` pattern), so no NaN
  reaches a gradient from the branch ``torch.where`` did not select.
- Parameters are validated eagerly when they are concrete (see
  ``errors._is_concrete``) and raise the JAX package's error codes.
- Real values take the dtype of a floating tensor parameter if there is one
  (float64 by input dtype), else ``settings.real_dtype()``.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import settings
from ..errors import (
    ErrorCode,
    ValidationError,
    _as_numpy,
    _is_concrete,
    _is_python_static,
    check_count,
    check_finite,
    check_positive,
    check_probability,
)
from .numerics import log_beta

_LOG_2PI = math.log(2.0 * math.pi)


# ---------------------------------------------------------------------------
# Supports
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Support:
    """Declared support of a distribution; ``kind`` picks the transform and
    the MH proposal."""

    kind: str  # real | positive | unit | interval | boolean | count |
    #            int_range | categorical | simplex | ordered
    low: Optional[float] = None
    high: Optional[float] = None
    size: Optional[int] = None  # categories (categorical), components (simplex, ordered)

    @property
    def is_continuous(self) -> bool:
        return self.kind in ("real", "positive", "unit", "interval", "simplex", "ordered")

    @property
    def is_discrete(self) -> bool:
        return not self.is_continuous


REAL = Support("real")
POSITIVE = Support("positive")
UNIT = Support("unit")
BOOLEAN = Support("boolean")
COUNT = Support("count")


def interval(low: float, high: float) -> Support:
    return Support("interval", low=low, high=high)


def int_range(low: int, high: int) -> Support:
    return Support("int_range", low=low, high=high)


def categorical_support(k: int) -> Support:
    return Support("categorical", low=0, high=k - 1, size=k)


def simplex_support(k: int) -> Support:
    """Interior of the (k-1)-simplex: x_i > 0, Σx_i = 1 (k components)."""
    return Support("simplex", low=0.0, high=1.0, size=k)


def ordered_support(k: int) -> Support:
    """Strictly increasing vectors of R^k: x_1 < x_2 < ... < x_k."""
    return Support("ordered", size=k)


# ---------------------------------------------------------------------------
# Helpers: Python numbers stay Python numbers
# ---------------------------------------------------------------------------


def _param(x):
    """A parameter as a tensor or a Python float (numpy → CPU tensor; an
    integer or bool tensor → the real dtype)."""
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() else x.to(settings.real_dtype())
    if isinstance(x, (np.ndarray, np.generic, list, tuple)):
        return torch.as_tensor(np.asarray(x, dtype=np.float64))
    return float(x)


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else math.log(x)


def _lgamma(x):
    return torch.lgamma(x) if isinstance(x, torch.Tensor) else math.lgamma(x)


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else tuple(np.shape(x))


def _tensor(x, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """``x`` as a tensor: a Python number becomes a 0-dim tensor on
    ``like``'s device, of ``dtype`` or ``like``'s (a fill, no
    host-to-device copy)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.full((), x, dtype=dtype or like.dtype, device=like.device)


@functools.lru_cache(maxsize=256)
def _log_beta_scalar(a: float, b: float) -> float:
    t = torch.tensor([a, b], dtype=torch.float64)
    return float(log_beta(t[0], t[1]))


def _log_beta(a, b):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        like = a if isinstance(a, torch.Tensor) else b
        a, b = torch.broadcast_tensors(_tensor(a, like), _tensor(b, like))
        return log_beta(a, b)
    return _log_beta_scalar(a, b)


# ---------------------------------------------------------------------------
# Base class
# ---------------------------------------------------------------------------


class Distribution:
    """Base distribution interface; scalar event shape unless a subclass
    says otherwise (Dirichlet, MultivariateNormal).

    A parameter given as a numpy array (or list) is a CPU tensor when the
    distribution is built; ``sample`` and ``log_prob`` first move such
    tensors to the device of the generator or the value
    (``_follow``), so a model written with numpy data runs on the card."""

    support: Support = REAL

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for name in ("sample", "log_prob"):
            fn = cls.__dict__.get(name)
            if fn is not None and not getattr(fn, "_follows", False):
                setattr(cls, name, _following(fn, name))

    def _follow(self, device) -> None:
        """Move every tensor attribute that lies on the CPU to ``device``,
        an accelerator (once: the moved tensor replaces it)."""
        for k, v in vars(self).items():
            if isinstance(v, torch.Tensor) and v.device.type == "cpu":
                setattr(self, k, v.to(device))

    def _params(self):
        return ()

    @property
    def real_dtype(self) -> torch.dtype:
        """The dtype of real values: a floating tensor parameter's, else
        ``settings.real_dtype()``."""
        for p in self._params():
            if isinstance(p, torch.Tensor) and p.is_floating_point():
                return p.dtype
        return settings.real_dtype()

    @property
    def dtype(self) -> torch.dtype:
        """The dtype of a drawn value."""
        if self.support.kind == "boolean":
            return torch.bool
        if self.support.is_discrete:
            return settings.int_dtype()
        return self.real_dtype

    def _real(self, value) -> torch.Tensor:
        """A value as a real tensor: floating tensors keep their dtype,
        integer and bool values take ``real_dtype``."""
        v = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
        return v if v.is_floating_point() else v.to(self.real_dtype)

    def _batch_shape(self) -> Tuple[int, ...]:
        return np.broadcast_shapes(*[_shape(p) for p in self._params()])

    def _full_shape(self, sample_shape) -> Tuple[int, ...]:
        return tuple(sample_shape) + self._batch_shape()

    def _full(self, x, shape, generator) -> torch.Tensor:
        """A parameter broadcast to ``shape`` as a real tensor on the
        generator's device."""
        if isinstance(x, torch.Tensor):
            return x.to(self.real_dtype).expand(shape)
        return torch.full(shape, x, dtype=self.real_dtype, device=generator.device)

    def _uniform(self, generator, shape) -> torch.Tensor:
        return torch.rand(shape, generator=generator, device=generator.device,
                          dtype=self.real_dtype)

    def _normal(self, generator, shape) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=generator.device,
                           dtype=self.real_dtype)

    def _gamma(self, concentration, generator, shape) -> torch.Tensor:
        """Standard Gamma(concentration) draws of ``shape``."""
        return torch._standard_gamma(self._full(concentration, shape, generator),
                                     generator=generator)

    def sample(self, generator: torch.Generator, sample_shape=()):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def unconstraining_transform(self):
        """The bijector z ∈ R^k ↔ x ∈ support used by gradient-based
        kernels, built from this runtime instance (the static
        support-keyed transform unless a subclass overrides it)."""
        from .transforms import transform_for_support

        return transform_for_support(self.support)

    def __repr__(self):
        params = ", ".join(f"{v}" for v in self._params())
        return f"{type(self).__name__}({params})"


def _following(fn, name):
    """``fn`` (a ``sample`` or ``log_prob``) preceded by ``_follow`` to the
    generator's device, or to the value's when it is a tensor."""

    @functools.wraps(fn)
    def wrapped(self, first, *args, **kwargs):
        device = getattr(first, "device", None)
        if isinstance(first, (torch.Tensor, torch.Generator)) and device.type != "cpu":
            self._follow(device)
        return fn(self, first, *args, **kwargs)

    wrapped._follows = True
    return wrapped


def _where_inside(inside, lp):
    return torch.where(inside, lp, -math.inf)


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

    @staticmethod
    def standard() -> "Normal":
        return Normal(0.0, 1.0)

    def _params(self):
        return (self.loc, self.scale)

    def sample(self, generator, sample_shape=()):
        return self.loc + self.scale * self._normal(generator, self._full_shape(sample_shape))

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -0.5 * z * z - _log(self.scale) - 0.5 * _LOG_2PI


class Uniform(Distribution):
    """Uniform(low, high) on [low, high). Its transform is the
    ``AffineSigmoid`` of its own (possibly runtime, possibly per-element)
    bounds, so dependent bounds such as ``Uniform(0, a)`` are exact."""

    def __init__(self, low, high):
        check_finite("low", low, ErrorCode.INVALID_RANGE)
        check_finite("high", high, ErrorCode.INVALID_RANGE)
        if _is_concrete(low) and _is_concrete(high):
            if not np.all(_as_numpy(low) < _as_numpy(high)):
                raise ValidationError(ErrorCode.INVALID_RANGE, "low must be < high",
                                      {"low": low, "high": high})
        # only Python and numpy bounds are static: a tensor bound may come
        # from an earlier site's draw during discovery
        if _is_python_static(low) and _is_python_static(high):
            self.support = interval(float(np.min(np.asarray(low))), float(np.max(np.asarray(high))))
        else:
            self.support = interval(None, None)
        self.low = _param(low)
        self.high = _param(high)

    @staticmethod
    def unit() -> "Uniform":
        return Uniform(0.0, 1.0)

    def unconstraining_transform(self):
        from .transforms import AffineSigmoid

        return AffineSigmoid(self.low, self.high)

    def _params(self):
        return (self.low, self.high)

    def sample(self, generator, sample_shape=()):
        u = self._uniform(generator, self._full_shape(sample_shape))
        return self.low + (self.high - self.low) * u

    def log_prob(self, value):
        x = self._real(value)
        inside = (x >= self.low) & (x < self.high)
        return _where_inside(inside, torch.zeros_like(x) - _log(self.high - self.low))


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
        z = self._normal(generator, self._full_shape(sample_shape))
        return torch.exp(self.loc + self.scale * z)

    def log_prob(self, value):
        x = torch.as_tensor(value)
        positive = x > 0
        lx = torch.log(torch.where(positive, x, torch.ones_like(x)))
        z = (lx - self.loc) / self.scale
        lp = -lx - _log(self.scale) - 0.5 * _LOG_2PI - 0.5 * z * z
        return _where_inside(positive, lp)


class Exponential(Distribution):
    """Exponential(rate)."""

    support = POSITIVE

    def __init__(self, rate):
        check_positive("rate", rate, ErrorCode.INVALID_RATE)
        self.rate = _param(rate)

    def _params(self):
        return (self.rate,)

    def sample(self, generator, sample_shape=()):
        u = self._uniform(generator, self._full_shape(sample_shape))
        return -torch.log1p(-u) / self.rate

    def log_prob(self, value):
        x = self._real(value)
        return _where_inside(x >= 0, _log(self.rate) - self.rate * x)


class Beta(Distribution):
    """Beta(alpha, beta)."""

    support = UNIT

    def __init__(self, concentration1, concentration0):
        check_positive("alpha", concentration1, ErrorCode.INVALID_SHAPE)
        check_positive("beta", concentration0, ErrorCode.INVALID_SHAPE)
        self.concentration1 = _param(concentration1)  # alpha
        self.concentration0 = _param(concentration0)  # beta

    @staticmethod
    def uniform_prior() -> "Beta":
        return Beta(1.0, 1.0)

    def _params(self):
        return (self.concentration1, self.concentration0)

    def sample(self, generator, sample_shape=()):
        shape = self._full_shape(sample_shape)
        g1 = self._gamma(self.concentration1, generator, shape)
        g0 = self._gamma(self.concentration0, generator, shape)
        return g1 / (g1 + g0)

    def log_prob(self, value):
        a, b = self.concentration1, self.concentration0
        x = self._real(value)
        inside = (x > 0) & (x < 1)
        sx = torch.where(inside, x, 0.5)
        lp = (a - 1) * torch.log(sx) + (b - 1) * torch.log1p(-sx) - _log_beta(a, b)
        return _where_inside(inside, lp)


class Gamma(Distribution):
    """Gamma(shape, rate)."""

    support = POSITIVE

    def __init__(self, concentration, rate):
        check_positive("shape", concentration, ErrorCode.INVALID_SHAPE)
        check_positive("rate", rate, ErrorCode.INVALID_RATE)
        self.concentration = _param(concentration)
        self.rate = _param(rate)

    def _params(self):
        return (self.concentration, self.rate)

    def sample(self, generator, sample_shape=()):
        shape = self._full_shape(sample_shape)
        return self._gamma(self.concentration, generator, shape) / self.rate

    def log_prob(self, value):
        a, b = self.concentration, self.rate
        x = self._real(value)
        sx = torch.where(x > 0, x, 1.0)
        lp = a * _log(b) - _lgamma(a) + (a - 1) * torch.log(sx) - b * sx
        return _where_inside(x > 0, lp)


class StudentT(Distribution):
    """StudentT(df, loc, scale)."""

    support = REAL

    def __init__(self, df, loc=0.0, scale=1.0):
        check_positive("df", df, ErrorCode.INVALID_SHAPE)
        check_finite("loc", loc, ErrorCode.INVALID_MEAN)
        check_positive("scale", scale, ErrorCode.INVALID_VARIANCE)
        self.df = _param(df)
        self.loc = _param(loc)
        self.scale = _param(scale)

    def _params(self):
        return (self.df, self.loc, self.scale)

    def sample(self, generator, sample_shape=()):
        shape = self._full_shape(sample_shape)
        z = self._normal(generator, shape)
        chi2 = 2.0 * self._gamma(self.df / 2, generator, shape)
        return self.loc + self.scale * z * torch.rsqrt(chi2 / self.df)

    def log_prob(self, value):
        v, loc, scale = self.df, self.loc, self.scale
        z = (self._real(value) - loc) / scale
        return (
            _lgamma((v + 1) / 2)
            - _lgamma(v / 2)
            - 0.5 * _log(v * math.pi)
            - _log(scale)
            - (v + 1) / 2 * torch.log1p(z * z / v)
        )


class Cauchy(Distribution):
    """Cauchy(loc, scale)."""

    support = REAL

    def __init__(self, loc, scale):
        check_finite("loc", loc, ErrorCode.INVALID_MEAN)
        check_positive("scale", scale, ErrorCode.INVALID_VARIANCE)
        self.loc = _param(loc)
        self.scale = _param(scale)

    def _params(self):
        return (self.loc, self.scale)

    def sample(self, generator, sample_shape=()):
        u = self._uniform(generator, self._full_shape(sample_shape))
        return self.loc + self.scale * torch.tan(math.pi * (u - 0.5))

    def log_prob(self, value):
        z = (self._real(value) - self.loc) / self.scale
        return -math.log(math.pi) - _log(self.scale) - torch.log1p(z * z)


class Laplace(Distribution):
    """Laplace(loc, scale)."""

    support = REAL

    def __init__(self, loc, scale):
        check_finite("loc", loc, ErrorCode.INVALID_MEAN)
        check_positive("scale", scale, ErrorCode.INVALID_VARIANCE)
        self.loc = _param(loc)
        self.scale = _param(scale)

    def _params(self):
        return (self.loc, self.scale)

    def sample(self, generator, sample_shape=()):
        v = self._uniform(generator, self._full_shape(sample_shape)) - 0.5
        # 2|v| < 1, so the log stays finite at the draw v = -1/2
        tail = torch.log1p(-torch.clamp(2.0 * v.abs(), max=1.0 - torch.finfo(v.dtype).eps))
        return self.loc - self.scale * torch.sign(v) * tail

    def log_prob(self, value):
        z = torch.abs(self._real(value) - self.loc) / self.scale
        return -_log(2 * self.scale) - z


class Weibull(Distribution):
    """Weibull(shape k, scale lambda)."""

    support = POSITIVE

    def __init__(self, concentration, scale):
        check_positive("shape", concentration, ErrorCode.INVALID_SHAPE)
        check_positive("scale", scale, ErrorCode.INVALID_VARIANCE)
        self.concentration = _param(concentration)  # k
        self.scale = _param(scale)  # lambda

    def _params(self):
        return (self.concentration, self.scale)

    def sample(self, generator, sample_shape=()):
        u = self._uniform(generator, self._full_shape(sample_shape))
        return self.scale * (-torch.log1p(-u)) ** (1.0 / self.concentration)

    def log_prob(self, value):
        k, lam = self.concentration, self.scale
        x = self._real(value)
        sx = torch.where(x > 0, x, 1.0)
        z = sx / lam
        lp = _log(k) - _log(lam) + (k - 1) * torch.log(z) - z**k
        return _where_inside(x > 0, lp)


class ChiSquared(Distribution):
    """ChiSquared(df)."""

    support = POSITIVE

    def __init__(self, df):
        check_positive("df", df, ErrorCode.INVALID_SHAPE)
        self.df = _param(df)

    def _params(self):
        return (self.df,)

    def sample(self, generator, sample_shape=()):
        return 2.0 * self._gamma(self.df / 2, generator, self._full_shape(sample_shape))

    def log_prob(self, value):
        x = self._real(value)
        sx = torch.where(x > 0, x, 1.0)
        half_k = self.df / 2
        lp = (half_k - 1) * torch.log(sx) - sx / 2 - half_k * math.log(2.0) - _lgamma(half_k)
        return _where_inside(x > 0, lp)


class InverseGamma(Distribution):
    """InverseGamma(shape, scale)."""

    support = POSITIVE

    def __init__(self, concentration, scale):
        check_positive("shape", concentration, ErrorCode.INVALID_SHAPE)
        check_positive("scale", scale, ErrorCode.INVALID_RATE)
        self.concentration = _param(concentration)
        self.scale = _param(scale)

    def _params(self):
        return (self.concentration, self.scale)

    def sample(self, generator, sample_shape=()):
        return self.scale / self._gamma(self.concentration, generator,
                                        self._full_shape(sample_shape))

    def log_prob(self, value):
        a, b = self.concentration, self.scale
        x = self._real(value)
        sx = torch.where(x > 0, x, 1.0)
        lp = a * _log(b) - _lgamma(a) - (a + 1) * torch.log(sx) - b / sx
        return _where_inside(x > 0, lp)


class HalfNormal(Distribution):
    """HalfNormal(scale): |N(0, scale²)| on [0, ∞)."""

    support = POSITIVE

    def __init__(self, scale):
        check_positive("scale", scale, ErrorCode.INVALID_VARIANCE)
        self.scale = _param(scale)

    def _params(self):
        return (self.scale,)

    def sample(self, generator, sample_shape=()):
        return torch.abs(self.scale * self._normal(generator, self._full_shape(sample_shape)))

    def log_prob(self, value):
        x = self._real(value)
        z = x / self.scale
        lp = 0.5 * math.log(2.0 / math.pi) - _log(self.scale) - 0.5 * z * z
        return _where_inside(x >= 0, lp)


class HalfCauchy(Distribution):
    """HalfCauchy(scale): |Cauchy(0, scale)| on [0, ∞)."""

    support = POSITIVE

    def __init__(self, scale):
        check_positive("scale", scale, ErrorCode.INVALID_VARIANCE)
        self.scale = _param(scale)

    def _params(self):
        return (self.scale,)

    def sample(self, generator, sample_shape=()):
        u = self._uniform(generator, self._full_shape(sample_shape))
        # inverse CDF of the half-Cauchy, u kept inside (1e-7, 1 - 1e-7)
        return self.scale * torch.tan(0.5 * math.pi * torch.clamp(u, 1e-7, 1.0 - 1e-7))

    def log_prob(self, value):
        x = self._real(value)
        lp = math.log(2.0 / math.pi) - _log(self.scale) - torch.log1p((x / self.scale) ** 2)
        return _where_inside(x >= 0, lp)


# ---------------------------------------------------------------------------
# Discrete distributions
# ---------------------------------------------------------------------------


def _bool(value) -> torch.Tensor:
    v = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
    return v.to(torch.bool)


class Bernoulli(Distribution):
    """Bernoulli(p) → bool."""

    support = BOOLEAN

    def __init__(self, probs):
        check_probability("p", probs)
        self.probs = _param(probs)

    def _params(self):
        return (self.probs,)

    def sample(self, generator, sample_shape=()):
        return self._uniform(generator, self._full_shape(sample_shape)) < self.probs

    def log_prob(self, value):
        v = _bool(value)
        p = _tensor(self.probs, v, self.real_dtype)
        # stable at p = 0 and 1: the selected branch is exact, the other is
        # masked before the log
        lp_true = torch.log(torch.where(p > 0, p, 1.0))
        lp_false = torch.log1p(-torch.where(p < 1, p, 0.0))
        return torch.where(v, torch.where(p > 0, lp_true, -math.inf),
                           torch.where(p < 1, lp_false, -math.inf))


class BernoulliLogits(Distribution):
    """Bernoulli on the log-odds scale → bool: log p = -softplus(∓logits),
    which never saturates where log(sigmoid(x)) underflows."""

    support = BOOLEAN

    def __init__(self, logits):
        check_finite("logits", logits, ErrorCode.INVALID_MEAN)
        self.logits = _param(logits)

    def _params(self):
        return (self.logits,)

    def sample(self, generator, sample_shape=()):
        u = self._uniform(generator, self._full_shape(sample_shape))
        return u < torch.sigmoid(_tensor(self.logits, u))

    def log_prob(self, value):
        v = _bool(value)
        z = _tensor(self.logits, v, self.real_dtype)
        return torch.where(v, -F.softplus(-z), -F.softplus(z))


class Categorical(Distribution):
    """Categorical(probs= | logits=) → index in [0, k). Sampling is the
    Gumbel-max draw over the log-probabilities."""

    def __init__(self, probs=None, logits=None):
        if (probs is None) == (logits is None):
            raise ValidationError(ErrorCode.INVALID_PROBABILITY,
                                  "exactly one of probs/logits must be given")
        if probs is not None:
            check_probability("probs", probs)
            if _is_concrete(probs):
                arr = _as_numpy(probs)
                if arr.ndim < 1 or arr.shape[-1] < 1:
                    raise ValidationError(ErrorCode.INVALID_PROBABILITY, "probs must be non-empty")
                if not np.allclose(arr.sum(axis=-1), 1.0, atol=1e-5):
                    raise ValidationError(ErrorCode.INVALID_PROBABILITY, "probs must sum to 1",
                                          {"sum": arr.sum(axis=-1)})
            self.probs = _param(probs)
            self._logits = None
        else:
            self.probs = None
            self._logits = _param(logits)
        self.support = categorical_support(int(_shape(self._params()[0])[-1]))

    @staticmethod
    def uniform(k: int) -> "Categorical":
        """Equal probabilities over k categories; the table is made on the
        device of the first generator or value it meets."""
        return Categorical(probs=torch.full((k,), 1.0 / k, dtype=settings.real_dtype()))

    @property
    def logits(self):
        if self._logits is not None:
            return self._logits
        return torch.log(torch.where(self.probs > 0, self.probs, 1e-38))

    def _params(self):
        return (self.probs if self.probs is not None else self._logits,)

    def _batch_shape(self):
        return _shape(self._params()[0])[:-1]

    def sample(self, generator, sample_shape=()):
        k = self.support.size
        u = self._uniform(generator, self._full_shape(sample_shape) + (k,))
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(self.logits + gumbel, dim=-1).to(settings.int_dtype())

    def log_prob(self, value):
        norm = torch.log_softmax(self.logits, dim=-1)
        v = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
        k = norm.shape[-1]
        inside = (v >= 0) & (v < k)
        sv = torch.clamp(v, 0, k - 1).long()
        lp = torch.take_along_dim(norm.expand(tuple(sv.shape) + (k,)), sv[..., None], dim=-1)[..., 0]
        return _where_inside(inside, lp)


class Binomial(Distribution):
    """Binomial(n, p) → count."""

    def __init__(self, total_count, probs):
        check_count("n", total_count)
        check_probability("p", probs)
        if _is_concrete(total_count):
            self.support = int_range(0, int(np.max(_as_numpy(total_count))))
        else:
            self.support = COUNT
        self.total_count = _param(total_count)
        self.probs = _param(probs)

    def _params(self):
        return (self.total_count, self.probs)

    def sample(self, generator, sample_shape=()):
        shape = self._full_shape(sample_shape)
        draw = torch.binomial(self._full(self.total_count, shape, generator),
                              self._full(self.probs, shape, generator), generator=generator)
        return draw.to(settings.counting_dtype())

    def log_prob(self, value):
        k = self._real(value)
        n = self.total_count
        p = _tensor(self.probs, k)
        inside = (k >= 0) & (k <= n)
        # minimum/maximum, not clamp: they split a tie's gradient as jnp.clip does
        sk = torch.minimum(torch.maximum(k, torch.zeros_like(k)), _tensor(n, k))
        log_p = torch.log(torch.where(p > 0, p, 1.0))
        log_q = torch.log1p(-torch.where(p < 1, p, 0.0))
        lp = (
            _lgamma(n + 1)
            - torch.lgamma(sk + 1)
            - torch.lgamma(n - sk + 1)
            + torch.where(sk > 0, sk * log_p, 0.0)
            + torch.where(n - sk > 0, (n - sk) * log_q, 0.0)
        )
        # p = 0 with k > 0, or p = 1 with k < n, is impossible
        lp = torch.where((p <= 0) & (sk > 0), -math.inf, lp)
        lp = torch.where((p >= 1) & (sk < n), -math.inf, lp)
        return _where_inside(inside, lp)


class Poisson(Distribution):
    """Poisson(rate) → count."""

    support = COUNT

    def __init__(self, rate):
        check_positive("rate", rate, ErrorCode.INVALID_RATE)
        self.rate = _param(rate)

    def _params(self):
        return (self.rate,)

    def sample(self, generator, sample_shape=()):
        rate = self._full(self.rate, self._full_shape(sample_shape), generator)
        return torch.poisson(rate, generator=generator).to(settings.counting_dtype())

    def log_prob(self, value):
        k = self._real(value)
        inside = k >= 0
        sk = torch.where(inside, k, 0.0)
        lp = sk * _log(self.rate) - self.rate - torch.lgamma(sk + 1)
        return _where_inside(inside, lp)


class Geometric(Distribution):
    """Geometric(p) → number of FAILURES before the first success, on
    {0, 1, 2, …} (scipy's ``geom`` counts trials and starts at 1). Sampling
    is one inverse-CDF transform: k = ⌊log(1 − U) / log(1 − p)⌋."""

    support = COUNT

    def __init__(self, probs):
        check_probability("probs", probs)
        if _is_concrete(probs) and len(_shape(probs)) == 0 and float(_as_numpy(probs)) <= 0.0:
            raise ValidationError(ErrorCode.INVALID_PROBABILITY,
                                  "probs must be > 0 (p=0 never terminates)", {"probs": probs})
        self.probs = _param(probs)

    def _params(self):
        return (self.probs,)

    def sample(self, generator, sample_shape=()):
        u = self._uniform(generator, self._full_shape(sample_shape))
        p = _tensor(self.probs, u)
        # p clamped into (0, 1) for the transform; p = 1 gives 0 below
        k = torch.floor(torch.log1p(-u) / torch.log1p(-torch.clamp(p, 1e-12, 1.0 - 1e-12)))
        return torch.where(p >= 1.0, 0.0, k).to(settings.counting_dtype())

    def log_prob(self, value):
        k = self._real(value)
        p = _tensor(self.probs, k)
        inside = k >= 0
        sk = torch.where(inside, k, 0.0)
        # at the valid edge p = 1, k = 0 the tail would be 0 * (-inf)
        tail = torch.where(sk == 0, 0.0, sk * torch.log1p(-p))
        return _where_inside(inside, tail + torch.log(p))


class NegativeBinomial(Distribution):
    """NegativeBinomial(total_count, probs) → number of FAILURES before the
    ``total_count``-th success, on {0, 1, 2, …} (scipy's ``nbinom(n, p)``;
    mean r(1−p)/p). Sampling is the Gamma-Poisson mixture."""

    support = COUNT

    def __init__(self, total_count, probs):
        check_positive("total_count", total_count, ErrorCode.INVALID_COUNT)
        check_probability("probs", probs)
        self.total_count = _param(total_count)
        self.probs = _param(probs)

    def _params(self):
        return (self.total_count, self.probs)

    def sample(self, generator, sample_shape=()):
        shape = self._full_shape(sample_shape)
        p = self.probs
        lam = self._gamma(self.total_count, generator, shape) * (1.0 - p) / p
        return torch.poisson(lam, generator=generator).to(settings.counting_dtype())

    def log_prob(self, value):
        r = self.total_count
        k = self._real(value)
        p = _tensor(self.probs, k)
        inside = k >= 0
        sk = torch.where(inside, k, 0.0)
        lp = (
            torch.lgamma(sk + r)
            - _lgamma(r)
            - torch.lgamma(sk + 1.0)
            + r * torch.log(p)
            + sk * torch.log1p(-p)
        )
        return _where_inside(inside, lp)


class DiscreteUniform(Distribution):
    """DiscreteUniform(low, high), both inclusive → int."""

    def __init__(self, low, high):
        if _is_concrete(low) and _is_concrete(high):
            lo, hi = _as_numpy(low), _as_numpy(high)
            if not np.all(lo <= hi):
                raise ValidationError(ErrorCode.INVALID_RANGE, "low must be <= high",
                                      {"low": low, "high": high})
            self.support = int_range(int(np.min(lo)), int(np.max(hi)))
        else:
            self.support = int_range(None, None)
        self.low = _param(low)
        self.high = _param(high)

    def _params(self):
        return (self.low, self.high)

    def sample(self, generator, sample_shape=()):
        u = self._uniform(generator, self._full_shape(sample_shape))
        width = self.high - self.low
        k = torch.minimum(torch.floor(u * (width + 1.0)), _tensor(width, u))
        return (self.low + k).to(settings.counting_dtype())

    def log_prob(self, value):
        v = self._real(value)
        inside = (v >= self.low) & (v <= self.high)
        return _where_inside(inside, torch.zeros_like(v) - _log(self.high - self.low + 1.0))


# ---------------------------------------------------------------------------
# Multivariate distributions
# ---------------------------------------------------------------------------


class Dirichlet(Distribution):
    """Dirichlet(concentration) → point on the (k-1)-simplex, event shape
    ``(k,)`` over the last axis of ``concentration``; its transform is
    ``StickBreaking``, which has k − 1 free coordinates."""

    def __init__(self, concentration):
        check_positive("concentration", concentration, ErrorCode.INVALID_SHAPE)
        shape = _shape(concentration)
        if len(shape) < 1 or shape[-1] < 2:
            raise ValidationError(ErrorCode.INVALID_SHAPE,
                                  "concentration must have a trailing event axis of size >= 2",
                                  {"shape": shape})
        self.concentration = _param(concentration)
        self.support = simplex_support(int(shape[-1]))

    def _params(self):
        return (self.concentration,)

    def unconstraining_transform(self):
        from .transforms import StickBreaking

        return StickBreaking(self.support.size)

    def _batch_shape(self):
        return _shape(self.concentration)[:-1]

    @property
    def event_size(self) -> int:
        return self.support.size

    def sample(self, generator, sample_shape=()):
        shape = self._full_shape(sample_shape) + (self.event_size,)
        g = self._gamma(self.concentration, generator, shape)
        return g / torch.sum(g, dim=-1, keepdim=True)

    def log_prob(self, value):
        a = self.concentration
        x = self._real(value)
        inside = torch.all(x > 0.0, dim=-1) & (torch.abs(torch.sum(x, dim=-1) - 1.0) < 1e-4)
        xs = torch.where(x > 0.0, x, 1.0)  # keeps the log finite off the support
        lp = (
            torch.sum((a - 1.0) * torch.log(xs), dim=-1)
            + torch.lgamma(torch.sum(a, dim=-1))
            - torch.sum(torch.lgamma(a), dim=-1)
        )
        return _where_inside(inside, lp)


class MultivariateNormal(Distribution):
    """MultivariateNormal(loc, covariance= | scale_tril=) → R^d vector,
    event shape ``(d,)``. Sampling is ``loc + L eps``; ``log_prob`` is a
    triangular solve. Both batch over leading dimensions."""

    def __init__(self, loc, covariance=None, scale_tril=None):
        if (covariance is None) == (scale_tril is None):
            raise ValidationError(ErrorCode.INVALID_VARIANCE,
                                  "exactly one of covariance/scale_tril must be given")
        check_finite("loc", loc, ErrorCode.INVALID_MEAN)
        d = _shape(loc)[-1] if len(_shape(loc)) >= 1 else None
        if covariance is not None:
            if _is_concrete(covariance):
                arr = _as_numpy(covariance)
                if arr.ndim < 2 or arr.shape[-1] != arr.shape[-2]:
                    raise ValidationError(ErrorCode.INVALID_VARIANCE, "covariance must be square",
                                          {"shape": arr.shape})
                if not np.allclose(arr, np.swapaxes(arr, -1, -2), atol=1e-6):
                    raise ValidationError(ErrorCode.INVALID_VARIANCE,
                                          "covariance must be symmetric")
                try:
                    np.linalg.cholesky(arr)
                except np.linalg.LinAlgError:
                    raise ValidationError(ErrorCode.INVALID_VARIANCE,
                                          "covariance must be positive definite")
            self._scale_tril = torch.linalg.cholesky(self._as_real(covariance))
        else:
            if _is_concrete(scale_tril):
                arr = _as_numpy(scale_tril)
                if arr.ndim < 2 or arr.shape[-1] != arr.shape[-2]:
                    raise ValidationError(ErrorCode.INVALID_VARIANCE, "scale_tril must be square",
                                          {"shape": arr.shape})
                if np.any(np.diagonal(arr, axis1=-2, axis2=-1) <= 0):
                    raise ValidationError(ErrorCode.INVALID_VARIANCE,
                                          "scale_tril must have positive diagonal")
            self._scale_tril = self._as_real(scale_tril)
        self.loc = _param(loc)
        self.event_size = int(d if d is not None else self._scale_tril.shape[-1])
        self.support = REAL

    @staticmethod
    def _as_real(x) -> torch.Tensor:
        p = _param(x)
        return p if isinstance(p, torch.Tensor) else torch.tensor(p, dtype=settings.real_dtype())

    @property
    def scale_tril(self):
        return self._scale_tril

    def _params(self):
        return (self.loc, self._scale_tril)

    def _batch_shape(self):
        return np.broadcast_shapes(_shape(self.loc)[:-1], tuple(self._scale_tril.shape[:-2]))

    def sample(self, generator, sample_shape=()):
        eps = self._normal(generator, self._full_shape(sample_shape) + (self.event_size,))
        return self.loc + torch.einsum("...ij,...j->...i", self._scale_tril, eps)

    def log_prob(self, value):
        L = self._scale_tril
        diff = self._real(value) - self.loc
        y = torch.linalg.solve_triangular(L, diff[..., None], upper=False)[..., 0]
        half_logdet = torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
        return -0.5 * torch.sum(y * y, dim=-1) - half_logdet - 0.5 * self.event_size * _LOG_2PI


class Ordered(Distribution):
    """Ordered(base, k): ``k`` iid draws of a scalar distribution on the
    real line, sorted; event shape ``(k,)``, support the increasing vectors
    of R^k. The density on that region is k!·Π_j p(x_j), the density of
    the order statistics, so the model stays normalised (Stan's
    ``ordered[k] x; x ~ base`` without its dropped constant). Its transform
    is ``transforms.Ordered``: x_1 = z_1, x_j = x_{j-1} + exp(z_j)."""

    def __init__(self, base: Distribution, k: int):
        if not isinstance(base, Distribution) or base.support.kind != "real":
            raise ValidationError(ErrorCode.INVALID_SHAPE,
                                  "Ordered takes a distribution on the real line",
                                  {"base": repr(base)})
        if tuple(base._batch_shape()) != ():
            raise ValidationError(ErrorCode.INVALID_SHAPE,
                                  "Ordered takes a base with scalar parameters",
                                  {"batch_shape": tuple(base._batch_shape())})
        if int(k) < 2:
            raise ValidationError(ErrorCode.INVALID_SHAPE, "Ordered needs k >= 2", {"k": k})
        self.base = base
        self.support = ordered_support(int(k))
        self._log_k_factorial = math.lgamma(int(k) + 1.0)

    def _params(self):
        return self.base._params()

    def unconstraining_transform(self):
        from .transforms import Ordered as OrderedTransform

        return OrderedTransform(self.support.size)

    def _batch_shape(self):
        return ()

    @property
    def event_size(self) -> int:
        return self.support.size

    def sample(self, generator, sample_shape=()):
        x = self.base.sample(generator, tuple(sample_shape) + (self.event_size,))
        return torch.sort(x, dim=-1).values

    def log_prob(self, value):
        x = self._real(value)
        inside = torch.all(x[..., 1:] > x[..., :-1], dim=-1)
        lp = self._log_k_factorial + torch.sum(self.base.log_prob(x), dim=-1)
        return _where_inside(inside, lp)


MULTIVARIATE_DISTRIBUTIONS = [Dirichlet, MultivariateNormal]

# beyond-parity univariate extensions (not in the 17-way registry below)
EXTRA_DISTRIBUTIONS = [
    HalfNormal, HalfCauchy, Geometric, NegativeBinomial, BernoulliLogits,
]

ALL_DISTRIBUTIONS = [
    Normal,
    Uniform,
    LogNormal,
    Exponential,
    Bernoulli,
    Categorical,
    Beta,
    Gamma,
    Binomial,
    Poisson,
    StudentT,
    Cauchy,
    Laplace,
    Weibull,
    ChiSquared,
    InverseGamma,
    DiscreteUniform,
]
