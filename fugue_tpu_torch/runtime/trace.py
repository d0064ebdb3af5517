"""Execution traces.

The port of ``fugue_tpu/runtime/trace.py``: choices hold tensors (batched
under ``vmap``), and the three log-weight accumulators keep the reference
split ``log_prior + log_likelihood + log_factors = total_log_weight``.
Insertion order is preserved; staging orders sites by address. The typed
getters wait for the handlers that read them back.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from ..core.distributions import Support

KIND_REAL = "real"
KIND_BOOL = "bool"
KIND_INT = "int"


def kind_of(value) -> str:
    dt = torch.as_tensor(value).dtype
    if dt == torch.bool:
        return KIND_BOOL
    if not (dt.is_floating_point or dt.is_complex):
        return KIND_INT
    return KIND_REAL


@dataclass
class Choice:
    """One recorded random choice."""

    value: Any
    log_prob: Any  # summed log-prob
    support: Support = None
    is_observed: bool = False

    @property
    def kind(self) -> str:
        return kind_of(self.value)


@dataclass
class Trace:
    """A complete execution record with the three accumulators."""

    choices: Dict[str, Choice] = field(default_factory=dict)
    log_prior: Any = 0.0
    log_likelihood: Any = 0.0
    log_factors: Any = 0.0

    def total_log_weight(self):
        return self.log_prior + self.log_likelihood + self.log_factors

    def insert_choice(self, addr: str, choice: Choice) -> None:
        """Record a choice; duplicate detection is the handler's job."""
        self.choices[str(addr)] = choice

    def latents(self) -> Dict[str, Any]:
        return {a: c.value for a, c in self.choices.items() if not c.is_observed}

