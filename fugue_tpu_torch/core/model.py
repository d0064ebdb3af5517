"""The model language: effects interpreted by an ambient handler stack.

The port of ``sample``, ``observe``, ``factor``, ``guard`` and the handler
scope from ``fugue_tpu/core/model.py``. A model is ordinary Python code that
calls these effect functions; the innermost handler on the stack decides
what they mean. Under ``torch.func.vmap`` the model runs once for a whole
batch of chains, with batched tensors flowing through the same code.
``masked``, ``cond``, ``plate`` and the ``Model`` combinators wait for a
later slice.
"""

from __future__ import annotations

import math
from typing import Any, List, Tuple

import numpy as np
import torch

from .distributions import Distribution
from ..errors import unexpected_structure

# ---------------------------------------------------------------------------
# Ambient handler stack
# ---------------------------------------------------------------------------

_HANDLER_STACK: List[Any] = []


def _current_handler():
    if not _HANDLER_STACK:
        raise unexpected_structure(
            "effect used outside of a handler; run models via "
            "fugue_tpu_torch.run(handler, model_fn, ...) or an inference engine"
        )
    return _HANDLER_STACK[-1]


class _HandlerScope:
    def __init__(self, handler):
        self.handler = handler

    def __enter__(self):
        _HANDLER_STACK.append(self.handler)
        return self.handler

    def __exit__(self, *exc):
        _HANDLER_STACK.pop()
        return False


# ---------------------------------------------------------------------------
# Effects
# ---------------------------------------------------------------------------


def sample(address, dist: Distribution, sample_shape: Tuple[int, ...] = ()):
    """Draw a latent value at ``address`` from ``dist``; the handler decides
    what "draw" means (fresh prior draw, replay, ...)."""
    return _current_handler().on_sample(str(address), dist, tuple(sample_shape))


def observe(address, dist: Distribution, value):
    """Condition on ``value`` observed from ``dist``; its summed log_prob
    accumulates into log_likelihood."""
    return _current_handler().on_observe(str(address), dist, value)


def factor(log_weight):
    """Add an arbitrary log-weight term to log_factors."""
    _current_handler().on_factor(log_weight)


def guard(condition):
    """Hard constraint: ``factor(-inf)`` when violated. ``condition`` may be
    a (batched) boolean tensor; violations fold in as ``-inf`` through
    ``torch.where``, so no value is read back to the host."""
    if not isinstance(condition, torch.Tensor):
        factor(0.0 if np.all(condition) else -math.inf)
        return
    factor(torch.where(torch.all(condition), 0.0, -math.inf))
