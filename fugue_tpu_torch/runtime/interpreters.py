"""The handlers the HMC path needs.

The port of ``_accum_sum``, ``_RecordingHandler``, ``PriorHandler``,
``ValuesHandler``, ``ConstrainHandler`` and ``UnconstrainHandler`` from
``fugue_tpu/runtime/interpreters.py``. Structural decisions (address
present? duplicate?) happen in Python while the model runs, identically
inside and outside ``torch.func`` transforms; only values are tensors.
Prior draws at a site use a generator seeded from (run seed, address), so
they do not depend on site order (``core/rng.py``). The replay, score, safe,
strict and reconciling handlers wait for a later slice, as does site fusion,
which the JAX package keeps off by default.
"""

from __future__ import annotations

from typing import Any, Dict, Set

import torch

from .. import settings
from ..core.numerics import compensated_sum
from ..core.rng import site_generator
from ..errors import address_conflict, trace_address_not_found
from .handler import Handler
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


class PriorHandler(_RecordingHandler):
    """Sample fresh from the prior on ``device``, score, record."""

    def __init__(self, seed: int, device):
        super().__init__()
        self.seed = int(seed)
        self.device = torch.device(device)

    def on_sample(self, addr, dist, sample_shape):
        self._check_duplicate(addr)
        value = dist.sample(site_generator(self.seed, addr, self.device), sample_shape)
        return self._score_site(addr, dist, value, False)


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
    """Replay with continuous latents given in UNCONSTRAINED space.

    Each site's z maps through the transform built from the runtime
    distribution; the summed log|J| accumulates on ``self.logdet`` and the
    trace records constrained values."""

    def __init__(self, z_values: Dict[str, Any]):
        super().__init__()
        self.z_values = z_values
        self.logdet = 0.0

    def on_sample(self, addr, dist, sample_shape):
        self._check_duplicate(addr)
        if addr not in self.z_values:
            raise trace_address_not_found(addr)
        t = dist.unconstraining_transform()
        z = self.z_values[addr]
        value = t.forward(z)
        self.logdet = self.logdet + torch.sum(t.log_det_jacobian(z))
        return self._score_site(addr, dist, value, False)


class UnconstrainHandler(ValuesHandler):
    """Replay with CONSTRAINED latents, collecting each continuous site's
    inverse image under the runtime transform (the exact inverse of
    ``ConstrainHandler``)."""

    def __init__(self, values: Dict[str, Any]):
        super().__init__(values)
        self.z_out: Dict[str, Any] = {}

    def on_sample(self, addr, dist, sample_shape):
        value = super().on_sample(addr, dist, sample_shape)
        if dist.support.is_continuous:
            self.z_out[addr] = dist.unconstraining_transform().inverse(value)
        return value
