"""Execution traces.

The port of ``fugue_tpu/runtime/trace.py``: choices hold tensors (batched
under ``vmap``), and the three log-weight accumulators keep the reference
split ``log_prior + log_likelihood + log_factors = total_log_weight``.
Insertion order is preserved; staging orders sites by address. The typed
getters return ``None`` for a missing address or another kind; their
``*_result`` forms raise ``TraceAccessError`` or ``TypeMismatchError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Optional

import torch

from ..core.distributions import Support
from ..errors import trace_address_not_found, type_mismatch

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

    def __contains__(self, addr) -> bool:
        return str(addr) in self.choices

    def __len__(self) -> int:
        return len(self.choices)

    def addresses(self) -> Iterator[str]:
        return iter(self.choices.keys())

    def sorted_addresses(self):
        return sorted(self.choices.keys())

    def get_choice(self, addr) -> Optional[Choice]:
        return self.choices.get(str(addr))

    def _get_kind(self, addr, kind: str):
        c = self.choices.get(str(addr))
        if c is None or c.kind != kind:
            return None
        return c.value

    def get_real(self, addr):
        return self._get_kind(addr, KIND_REAL)

    def get_bool(self, addr):
        return self._get_kind(addr, KIND_BOOL)

    def get_int(self, addr):
        return self._get_kind(addr, KIND_INT)

    get_f64 = get_real  # the reference's name

    def _get_kind_result(self, addr, kind: str):
        c = self.choices.get(str(addr))
        if c is None:
            raise trace_address_not_found(str(addr))
        if c.kind != kind:
            raise type_mismatch(str(addr), kind, c.kind)
        return c.value

    def get_real_result(self, addr):
        return self._get_kind_result(addr, KIND_REAL)

    def get_bool_result(self, addr):
        return self._get_kind_result(addr, KIND_BOOL)

    def get_int_result(self, addr):
        return self._get_kind_result(addr, KIND_INT)

    def values(self) -> Dict[str, Any]:
        """Plain address → value dict, latent and observed."""
        return {a: c.value for a, c in self.choices.items()}

    def latents(self) -> Dict[str, Any]:
        return {a: c.value for a, c in self.choices.items() if not c.is_observed}

    def copy(self) -> "Trace":
        return Trace(dict(self.choices), self.log_prior, self.log_likelihood, self.log_factors)

