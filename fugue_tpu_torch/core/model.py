"""The model language: effects interpreted by an ambient handler stack.

The port of ``fugue_tpu/core/model.py``: the effects ``sample``,
``observe``, ``factor`` and ``guard``, the handler scope, the
bounded-branch regions ``masked`` and ``cond``, the scalar-loop ``plate``,
and the monadic ``Model`` wrapper with its combinators. A model is ordinary
Python code that calls the effect functions; the innermost handler on the
stack decides what they mean. Under ``torch.func.vmap`` the model runs once
for a whole batch of chains, with batched tensors flowing through the same
code, and a branch on a batched value is a ``masked`` region or a ``cond``,
never a Python ``if``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import settings
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
# Branch masks (bounded-branch conditionals; see ``masked`` / ``cond``)
# ---------------------------------------------------------------------------

_MASK_STACK: List[Any] = []


def _as_condition(condition):
    """A condition as a bool tensor, or a Python bool when it is a Python or
    numpy scalar (so a constant mask costs no device op)."""
    if isinstance(condition, torch.Tensor):
        return condition.to(torch.bool)
    arr = np.asarray(condition, dtype=bool)
    return bool(arr) if arr.ndim == 0 else torch.as_tensor(arr)


def _and(a, b):
    if not isinstance(a, torch.Tensor):
        return b if a else False
    if not isinstance(b, torch.Tensor):
        return a if b else False
    return torch.logical_and(a, b)


def _active_mask():
    """AND of all enclosing ``masked`` regions, or None outside any."""
    if not _MASK_STACK:
        return None
    m = _MASK_STACK[0]
    for x in _MASK_STACK[1:]:
        m = _and(m, x)
    return m


def _apply_mask(mask, lw):
    """``lw`` where ``mask`` holds, 0 elsewhere (a masked -inf gives 0)."""
    if isinstance(mask, torch.Tensor):
        if not isinstance(lw, torch.Tensor):
            lw = torch.full((), float(lw), dtype=settings.real_dtype(), device=mask.device)
        return torch.where(mask, lw, torch.zeros_like(lw))
    if mask:
        return lw
    return torch.zeros_like(lw) if isinstance(lw, torch.Tensor) else 0.0


class _MaskedDistribution:
    """Duck-typed wrapper: the same sampling, log_prob zeroed where
    inactive. Applied only to observe sites inside ``masked`` regions;
    latent sites keep their prior density (the pseudo-prior convention), so
    the extended-space joint stays proper and inactive coordinates follow
    their prior instead of an improper flat direction."""

    __slots__ = ("dist", "mask")

    def __init__(self, dist, mask):
        self.dist = dist
        self.mask = mask

    @property
    def support(self):
        return self.dist.support

    def sample(self, generator, sample_shape=()):
        return self.dist.sample(generator, sample_shape)

    def log_prob(self, value):
        return _apply_mask(self.mask, self.dist.log_prob(value))

    def __repr__(self):
        return f"Masked({self.dist!r})"


class masked:
    """Context manager: observe and factor effects inside contribute their
    log-weight only where ``condition`` is True.

    The static-shape form of a data-dependent branch: the region's sites
    always run (a fixed site table), but the inactive branch's likelihood
    and factor terms are zeroed. Latent sites inside keep their prior term,
    which leaves the posterior marginals of the active branch exact. Nested
    regions AND together."""

    def __init__(self, condition):
        self.condition = _as_condition(condition)

    def __enter__(self):
        _MASK_STACK.append(self.condition)
        return self.condition

    def __exit__(self, *exc):
        _MASK_STACK.pop()
        return False


def cond(pred, true_fn: Callable[[], Any], false_fn: Optional[Callable[[], Any]] = None):
    """Bounded-branch conditional over a (possibly batched) predicate.

    Runs BOTH branches (a static site table), masks each branch's observe
    and factor terms by the predicate, and selects the return value leaf by
    leaf with ``torch.where`` over ``torch.utils._pytree``. Branches must
    use distinct addresses; ``false_fn`` may be omitted for a one-armed
    conditional."""
    pred = _as_condition(pred)
    with masked(pred):
        tv = true_fn()
    if false_fn is None:
        return tv
    not_pred = torch.logical_not(pred) if isinstance(pred, torch.Tensor) else not pred
    with masked(not_pred):
        fv = false_fn()
    if tv is None and fv is None:
        return None
    if not isinstance(pred, torch.Tensor):
        return tv if pred else fv
    return pytree.tree_map(lambda a, b: torch.where(pred, a, b), tv, fv)


# ---------------------------------------------------------------------------
# Effects
# ---------------------------------------------------------------------------


def sample(address, dist: Distribution, sample_shape: Tuple[int, ...] = ()):
    """Draw a latent value at ``address`` from ``dist``; the handler decides
    what "draw" means (fresh prior draw, replay, ...). Inside a ``masked``
    region the prior term is NOT masked (pseudo-prior convention)."""
    return _current_handler().on_sample(str(address), dist, tuple(sample_shape))


def observe(address, dist: Distribution, value):
    """Condition on ``value`` observed from ``dist``; its summed log_prob
    accumulates into log_likelihood, zeroed where an enclosing ``masked``
    region is inactive."""
    mask = _active_mask()
    if mask is not None:
        dist = _MaskedDistribution(dist, mask)
    return _current_handler().on_observe(str(address), dist, value)


def factor(log_weight):
    """Add an arbitrary log-weight term to log_factors, zeroed where an
    enclosing ``masked`` region is inactive (a masked -inf gives 0)."""
    mask = _active_mask()
    if mask is not None:
        log_weight = _apply_mask(mask, log_weight)
    _current_handler().on_factor(log_weight)


def guard(condition):
    """Hard constraint: ``factor(-inf)`` when violated. ``condition`` may be
    a (batched) boolean tensor; violations fold in as ``-inf`` through
    ``torch.where``, so no value is read back to the host."""
    if not isinstance(condition, torch.Tensor):
        factor(0.0 if np.all(condition) else -math.inf)
        return
    factor(torch.where(torch.all(condition), 0.0, -math.inf))


def plate(name: str, size: int, body: Callable[[int], Any]) -> List[Any]:
    """Scalar-loop plate: ``body(i)`` for each i < ``size``; the body makes
    its own addresses (``addr(name, i)``). A large plate is better one
    vectorized site: ``sample(name, dist, sample_shape=(size,))``."""
    return [body(i) for i in range(size)]


# ---------------------------------------------------------------------------
# Monadic Model wrapper
# ---------------------------------------------------------------------------


class Model:
    """A first-class probabilistic computation: a zero-argument thunk whose
    body performs effects, run under a handler. ``sequence_vec`` is a
    Python loop, so a long sequence uses no stack depth."""

    __slots__ = ("_thunk",)

    def __init__(self, thunk: Callable[[], Any]):
        self._thunk = thunk

    def __call__(self):
        return self._thunk()

    @staticmethod
    def pure(value) -> "Model":
        return Model(lambda: value)

    @staticmethod
    def sample(address, dist: Distribution, sample_shape=()) -> "Model":
        return Model(lambda: sample(address, dist, sample_shape))

    @staticmethod
    def observe(address, dist: Distribution, value) -> "Model":
        return Model(lambda: observe(address, dist, value))

    @staticmethod
    def factor(log_weight) -> "Model":
        return Model(lambda: factor(log_weight))

    @staticmethod
    def guard(condition) -> "Model":
        return Model(lambda: guard(condition))

    def bind(self, f: Callable[[Any], "Model"]) -> "Model":
        """Monadic bind."""
        return Model(lambda: f(self._thunk())())

    and_then = bind

    def map(self, f: Callable[[Any], Any]) -> "Model":
        return Model(lambda: f(self._thunk()))

    def zip(self, other: "Model") -> "Model":
        """Pair two models run in order."""
        return Model(lambda: (self._thunk(), other._thunk()))

    @staticmethod
    def sequence_vec(models: Sequence["Model"]) -> "Model":
        """Run models in order and collect their results."""
        ms = list(models)
        return Model(lambda: [m() for m in ms])

    @staticmethod
    def traverse_vec(items: Sequence[Any], f: Callable[[Any], "Model"]) -> "Model":
        """Map each item to a model, then sequence them."""
        xs = list(items)
        return Model(lambda: [f(x)() for x in xs])


pure = Model.pure
sequence_vec = Model.sequence_vec
traverse_vec = Model.traverse_vec
