"""Posterior and prior predictive sampling.

The port of ``fugue_tpu/inference/predictive.py``: one model definition, a
``PredictiveHandler`` that redraws ``observe`` sites, and the whole
flattened batch of posterior draws replayed in ONE model run under
``torch.func.vmap`` (a different draw per row), never one run per draw.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch.func import vmap

from ..runtime.handler import run
from ..runtime.interpreters import PredictiveHandler


def predictive(
    seed: int,
    model_fn: Callable,
    posterior: Optional[Dict[str, Any]] = None,
    *,
    model_args: tuple = (),
    batch_ndim: int = 2,
    return_sites: Optional[Sequence[str]] = None,
    device="cuda",
) -> Dict[str, Any]:
    """Predictive draws from replaying posterior draws through the model.

    ``posterior`` maps addresses to latent draws with ``batch_ndim`` leading
    batch dims (2 for (chains, draws), 1 for a flat draw dim, 0 for one
    draw); ``None`` or ``{}`` gives the prior predictive. Returns an
    ``{address: tensor}`` dict with the posterior's leading batch dims:
    fresh draws at every ``observe`` site and at every latent site absent
    from ``posterior``, or the ``return_sites`` only. Fresh draws come from
    generators on ``device`` seeded from ``seed``."""
    posterior = dict(posterior or {})
    device = torch.device(device)

    def one(values):
        _, tr = run(PredictiveHandler(seed, values, device), model_fn, *model_args)
        out = {}
        for a, c in tr.choices.items():
            if return_sites is not None:
                if a in return_sites:
                    out[a] = c.value
            elif c.is_observed or a not in values:
                out[a] = c.value
        return out

    if batch_ndim == 0:
        return one(posterior)

    # flatten the batch dims, one batched run, restore the batch shape
    batch_shape = None
    flat = {}
    for a, v in posterior.items():
        v = torch.as_tensor(v, device=device)
        bs = tuple(v.shape[:batch_ndim])
        if batch_shape is None:
            batch_shape = bs
        elif bs != batch_shape:
            raise ValueError(
                f"posterior batch shapes disagree: {a} has {bs}, expected {batch_shape}"
            )
        flat[a] = v.reshape((-1,) + tuple(v.shape[batch_ndim:]))
    if batch_shape is None:
        raise ValueError(
            "posterior is empty with batch_ndim > 0; pass batch_ndim=0 "
            "for a single prior-predictive draw or provide posterior draws"
        )
    outs = vmap(one, randomness="different")(flat)
    return {a: v.reshape(batch_shape + tuple(v.shape[1:])) for a, v in outs.items()}


def posterior_predictive(seed: int, model_fn, posterior, **kwargs):
    """``predictive`` with a required posterior."""
    return predictive(seed, model_fn, posterior, **kwargs)
