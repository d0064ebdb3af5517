"""Handler protocol + the universal interpreter ``run``.

The port of ``fugue_tpu/runtime/handler.py``: one
``on_sample(addr, dist, sample_shape)`` hook covers all value kinds, and
``run`` executes a model under a handler and returns ``(result, trace)``.
"""

from __future__ import annotations

from typing import Any, Tuple

from ..core.model import _HandlerScope
from .trace import Trace


class Handler:
    """Effect interpreter interface."""

    def on_sample(self, addr: str, dist, sample_shape) -> Any:
        raise NotImplementedError

    def on_observe(self, addr: str, dist, value) -> Any:
        raise NotImplementedError

    def on_factor(self, log_weight) -> None:
        raise NotImplementedError

    def finish(self) -> Trace:
        raise NotImplementedError


def run(handler: Handler, model, *args, **kwargs) -> Tuple[Any, Trace]:
    """Execute ``model(*args, **kwargs)`` under ``handler`` →
    ``(result, trace)``."""
    with _HandlerScope(handler):
        result = model(*args, **kwargs)
    trace = handler.finish()
    return result, trace
