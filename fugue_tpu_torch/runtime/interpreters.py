"""The handler zoo.

The port of ``fugue_tpu/runtime/interpreters.py``: the prior, values,
constrain and unconstrain handlers the staged engines run on; replay from
a trace or a value dict (``ReplayHandler``, ``PartialValuesHandler``);
predictive execution (``PredictiveHandler``); scoring against a fixed trace,
strict, safe (mismatches poison the weight with -inf and warn) and
reconciling (fresh addresses are birthed, vanished ones reported); and the
``score_given_trace*`` functions. Structural decisions (address present?
kind matches? duplicate?) happen in Python while the model runs,
identically inside and outside ``torch.func`` transforms; only values are
tensors. A fresh draw at a site uses a generator seeded from (run seed,
address) on the handler's device, so it does not depend on site order
(``core/rng.py``). Site fusion, which the JAX package keeps off by default,
is not ported.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Set

import torch

from .. import settings
from ..core.numerics import compensated_sum
from ..core.rng import site_generator
from ..errors import (
    address_conflict,
    trace_address_not_found,
    type_mismatch,
    unexpected_structure,
)
from .handler import Handler, run
from .trace import Choice, Trace


def _accum_sum(log_prob):
    """Per-site log-prob reduction under the plate accumulation policy:
    a plain sum below ``settings.compensated_sum_threshold()`` elements,
    ``compensated_sum`` at or above it."""
    if not isinstance(log_prob, torch.Tensor):
        return log_prob
    if log_prob.dim() and log_prob.numel() >= settings.compensated_sum_threshold():
        return compensated_sum(log_prob)
    return torch.sum(log_prob)


class _RecordingHandler(Handler):
    """Shared bookkeeping: accumulator trace + duplicate detection."""

    def __init__(self):
        self.trace = Trace()
        self._seen: Set[str] = set()

    def _check_duplicate(self, addr: str) -> None:
        if addr in self._seen:
            raise address_conflict(addr)
        self._seen.add(addr)

    def _score_site(self, addr, dist, value, observed):
        lp = _accum_sum(dist.log_prob(value))
        self.trace.insert_choice(
            addr, Choice(value=value, log_prob=lp, support=dist.support, is_observed=observed)
        )
        if observed:
            self.trace.log_likelihood = self.trace.log_likelihood + lp
        else:
            self.trace.log_prior = self.trace.log_prior + lp
        return value

    def on_observe(self, addr, dist, value):
        self._check_duplicate(addr)
        return self._score_site(addr, dist, value, True)

    def on_factor(self, log_weight):
        self.trace.log_factors = self.trace.log_factors + _accum_sum(log_weight)

    def finish(self) -> Trace:
        return self.trace


class _DrawingHandler(_RecordingHandler):
    """A recording handler that draws fresh values from the run seed."""

    def __init__(self, seed: int, device):
        super().__init__()
        self.seed = int(seed)
        self.device = torch.device(device)

    def _draw(self, addr, dist, sample_shape):
        return dist.sample(site_generator(self.seed, addr, self.device), sample_shape)


class PriorHandler(_DrawingHandler):
    """Sample fresh from the prior on ``device``, score, record."""

    def on_sample(self, addr, dist, sample_shape):
        self._check_duplicate(addr)
        return self._score_site(addr, dist, self._draw(addr, dist, sample_shape), False)


class ValuesHandler(_RecordingHandler):
    """Replay from a plain ``{address: value}`` dict; missing addresses
    raise (staged models have a fixed site set)."""

    def __init__(self, values: Dict[str, Any]):
        super().__init__()
        self.values = values

    def on_sample(self, addr, dist, sample_shape):
        self._check_duplicate(addr)
        if addr not in self.values:
            raise trace_address_not_found(addr)
        return self._score_site(addr, dist, self.values[addr], False)


class ConstrainHandler(_RecordingHandler):
    """Replay with continuous latents given in UNCONSTRAINED space and the
    other (discrete) latents as values.

    Each continuous site's z maps through the transform built from the
    runtime distribution, so bounds that depend on earlier sites use their
    current values; the summed log|J| accumulates on ``self.logdet`` and
    the trace records constrained values."""

    def __init__(self, z_values: Dict[str, Any], other_values: Dict[str, Any]):
        super().__init__()
        self.z_values = z_values
        self.other_values = other_values
        self.logdet = 0.0

    def on_sample(self, addr, dist, sample_shape):
        self._check_duplicate(addr)
        if addr in self.z_values:
            t = dist.unconstraining_transform()
            z = self.z_values[addr]
            value = t.forward(z)
            self.logdet = self.logdet + torch.sum(t.log_det_jacobian(z))
        elif addr in self.other_values:
            value = self.other_values[addr]
        else:
            raise trace_address_not_found(addr)
        return self._score_site(addr, dist, value, False)


class UnconstrainHandler(ValuesHandler):
    """Replay with CONSTRAINED latents, collecting each continuous site's
    inverse image under the runtime transform (the exact inverse of
    ``ConstrainHandler``), its value cast to the real dtype first."""

    def __init__(self, values: Dict[str, Any]):
        super().__init__(values)
        self.z_out: Dict[str, Any] = {}

    def on_sample(self, addr, dist, sample_shape):
        value = super().on_sample(addr, dist, sample_shape)
        if dist.support.is_continuous:
            x = torch.as_tensor(value).to(settings.real_dtype())
            self.z_out[addr] = dist.unconstraining_transform().inverse(x)
        return value


def _dist_kind(dist) -> str:
    """The trace kind a draw of ``dist`` has: bool, int or real."""
    if dist.support.kind == "boolean":
        return "bool"
    if dist.support.is_discrete:
        return "int"
    return "real"


class ReplayHandler(_DrawingHandler):
    """Reuse values from a base trace where present, else sample fresh;
    re-score everything under the current model. A base value of another
    kind raises ``TypeMismatchError``."""

    def __init__(self, seed: int, base: Trace, device="cuda"):
        super().__init__(seed, device)
        self.base = base

    def _base_value(self, addr, dist):
        c = self.base.get_choice(addr)
        if c is None:
            return None
        if c.kind != _dist_kind(dist):
            raise type_mismatch(addr, _dist_kind(dist), c.kind)
        return c.value

    def on_sample(self, addr, dist, sample_shape):
        self._check_duplicate(addr)
        value = self._base_value(addr, dist)
        if value is None:
            value = self._draw(addr, dist, sample_shape)
        return self._score_site(addr, dist, value, False)


class PartialValuesHandler(_DrawingHandler):
    """Replay from a plain value dict where present, sample fresh otherwise:
    ABC-SMC pins its parameter sites this way while the simulator's noise
    sites are redrawn."""

    def __init__(self, seed: int, values: Dict[str, Any], device="cuda"):
        super().__init__(seed, device)
        self.values = values

    def on_sample(self, addr, dist, sample_shape):
        self._check_duplicate(addr)
        if addr in self.values:
            value = self.values[addr]
        else:
            value = self._draw(addr, dist, sample_shape)
        return self._score_site(addr, dist, value, False)


class PredictiveHandler(PartialValuesHandler):
    """Predictive execution: latent sites replay from a value dict (fresh
    where absent); ``observe`` sites draw a fresh value from the observation
    distribution instead of scoring the data, with the data's leading
    shape beyond the distribution's batch shape. The recorded choice is the
    predictive draw."""

    def on_observe(self, addr, dist, value):
        self._check_duplicate(addr)
        batch = dist._batch_shape()
        vshape = tuple(torch.as_tensor(value).shape)
        lead = vshape[: len(vshape) - len(batch)] if len(batch) else vshape
        return self._score_site(addr, dist, self._draw(addr, dist, lead), True)


class ScoreGivenTrace(_RecordingHandler):
    """Score a model against a fixed trace: no sampling, every latent must
    be in the base trace with the model's kind, and the fresh log-probs are
    recorded."""

    def __init__(self, base: Trace):
        super().__init__()
        self.base = base

    def on_sample(self, addr, dist, sample_shape):
        self._check_duplicate(addr)
        c = self.base.get_choice(addr)
        if c is None:
            raise trace_address_not_found(addr)
        if c.kind != _dist_kind(dist):
            raise type_mismatch(addr, _dist_kind(dist), c.kind)
        return self._score_site(addr, dist, c.value, False)


class SafeScoreGivenTrace(_RecordingHandler):
    """``ScoreGivenTrace`` that turns a missing address or a kind mismatch
    into a warning and a -inf weight (once, in ``log_factors``) instead of
    raising. A placeholder prior draw, from seed 0 on ``device``, keeps the
    model running past the mismatch."""

    def __init__(self, base: Trace, warn: bool = True, device="cuda"):
        super().__init__()
        self.base = base
        self.warn = warn
        self.device = torch.device(device)
        self._poisoned = False

    def _poison(self, msg: str):
        if self.warn:
            warnings.warn(f"SafeScoreGivenTrace: {msg}; trace weight set to -inf")
        if not self._poisoned:
            self.trace.log_factors = self.trace.log_factors + (-torch.inf)
            self._poisoned = True

    def on_sample(self, addr, dist, sample_shape):
        self._check_duplicate(addr)
        c = self.base.get_choice(addr)
        if c is None or c.kind != _dist_kind(dist):
            self._poison(f"missing address {addr!r}" if c is None
                         else f"type mismatch at {addr!r}")
            value = dist.sample(site_generator(0, addr, self.device), sample_shape)
        else:
            value = c.value
        return self._score_site(addr, dist, value, False)


class SafeReplayHandler(ReplayHandler):
    """``ReplayHandler`` that samples fresh, with a warning, where the base
    value's kind differs from the model's."""

    def _base_value(self, addr, dist):
        c = self.base.get_choice(addr)
        if c is None:
            return None
        if c.kind != _dist_kind(dist):
            warnings.warn(
                f"SafeReplayHandler: type mismatch at {addr!r} "
                f"(trace has {c.kind}, model wants {_dist_kind(dist)}); resampling"
            )
            return None
        return c.value


class StrictScoreGivenTrace(ScoreGivenTrace):
    """``ScoreGivenTrace`` that requires the exact structure: an address the
    trace lacks, or a trace latent the model does not visit, raises
    ``ModelStructureError`` (UNEXPECTED_MODEL_STRUCTURE)."""

    def on_sample(self, addr, dist, sample_shape):
        if self.base.get_choice(addr) is None:
            raise unexpected_structure(
                f"model sampled fresh address {addr!r} not present in trace",
                address=addr,
            )
        return super().on_sample(addr, dist, sample_shape)

    def finish(self) -> Trace:
        visited = set(self.trace.choices.keys())
        base_latents = {a for a, c in self.base.choices.items() if not c.is_observed}
        vanished = base_latents - visited
        if vanished:
            raise unexpected_structure("model did not visit all trace addresses",
                                       vanished=sorted(vanished))
        return self.trace


@dataclass
class ReconcileReport:
    """Addresses birthed from the prior and trace latents left unvisited."""

    birthed: List[str] = field(default_factory=list)
    vanished: List[str] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.birthed and not self.vanished


class ReconcilingScoreGivenTrace(_DrawingHandler):
    """Score against a trace of another structure: addresses the trace
    lacks (or holds with another kind) are birthed from the prior, trace
    latents the model does not visit are reported as vanished."""

    def __init__(self, seed: int, base: Trace, device="cuda"):
        super().__init__(seed, device)
        self.base = base
        self.report = ReconcileReport()

    def on_sample(self, addr, dist, sample_shape):
        self._check_duplicate(addr)
        c = self.base.get_choice(addr)
        if c is not None and c.kind == _dist_kind(dist):
            value = c.value
        else:
            value = self._draw(addr, dist, sample_shape)
            self.report.birthed.append(addr)
        return self._score_site(addr, dist, value, False)

    def finish(self) -> Trace:
        visited = set(self.trace.choices.keys())
        for a, c in self.base.choices.items():
            if not c.is_observed and a not in visited:
                self.report.vanished.append(a)
        return self.trace


def score_given_trace(model, base: Trace, *args, **kwargs):
    """Run ``model`` under ``ScoreGivenTrace(base)`` → (result, trace)."""
    return run(ScoreGivenTrace(base), model, *args, **kwargs)


def score_given_trace_safe(model, base: Trace, *args, device="cuda", **kwargs):
    """Run ``model`` under ``SafeScoreGivenTrace(base)``, its placeholder
    draws on ``device`` → (result, trace)."""
    return run(SafeScoreGivenTrace(base, device=device), model, *args, **kwargs)


def score_given_trace_strict(model, base: Trace, *args, **kwargs):
    """Run ``model`` under ``StrictScoreGivenTrace(base)`` → (result, trace)."""
    return run(StrictScoreGivenTrace(base), model, *args, **kwargs)


def score_given_trace_reconciled(seed: int, model, base: Trace, *args, device="cuda", **kwargs):
    """Run ``model`` under ``ReconcilingScoreGivenTrace`` → (result, trace,
    report)."""
    handler = ReconcilingScoreGivenTrace(seed, base, device)
    result, trace = run(handler, model, *args, **kwargs)
    return result, trace, handler.report
