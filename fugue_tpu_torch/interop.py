"""Carry chain state and data over from numpy arrays.

The counterpart of a model's weights here is chain state and data. The JAX
package's ``HMCResult`` holds ``final_positions`` (C, d), ``step_size`` and
``inv_mass`` (d,) in the same address-sorted flat unconstrained layout as
this package's ``StagedModel``, so a state warmed up there continues here
(``hmc_transition``, or ``hmc_chain(init_position=state.positions)``) once
it is converted with ``np.asarray`` and ``hmc_state_from_numpy``.

Likewise the JAX ``SMCResult.state`` of a ladder stopped at
``max_stages`` (particles, log-weights, log-likelihoods, β, log Z, the
adaptation arrays, the stage counter) becomes this package's ``SMCState``
through ``smc_state_from_numpy``, and ``adaptive_smc(resume=...)`` finishes
the ladder here. The JAX key does not carry over: the caller seeds the
generator that draws the rest of the run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from .inference.mcmc_utils import AdaptationState
from .inference.smc import SMCState


@dataclass
class HMCState:
    positions: torch.Tensor  # (C, d) unconstrained
    step_size: torch.Tensor  # 0-dim
    inv_mass: torch.Tensor  # (d,) diagonal


def tensor_from_numpy(array, *, device="cuda", dtype=None) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor on
    ``device``; ``dtype`` None keeps the array's dtype."""
    t = torch.from_numpy(np.array(array, order="C"))  # a copy: writable, contiguous
    return t.to(device=device, dtype=dtype)


def hmc_state_from_numpy(positions, step_size, inv_mass, *, device="cuda",
                         dtype=torch.float32) -> HMCState:
    """A warmed HMC state from numpy arrays, checked for matching shapes."""
    q = tensor_from_numpy(positions, device=device, dtype=dtype)
    im = tensor_from_numpy(inv_mass, device=device, dtype=dtype)
    if q.dim() != 2 or im.shape != (q.shape[1],):
        raise ValueError(
            f"positions {tuple(q.shape)} must be (C, d) and inv_mass "
            f"{tuple(im.shape)} must be (d,): only a diagonal mass carries over"
        )
    eps = tensor_from_numpy(np.asarray(step_size, dtype=np.float64).reshape(()),
                            device=device, dtype=dtype)
    return HMCState(positions=q, step_size=eps, inv_mass=im)


def smc_state_from_numpy(particles: Dict[str, np.ndarray], log_weights, log_likelihoods,
                         beta, log_evidence, adapt_log_scale, adapt_t, stage: int, *,
                         generator: torch.Generator, device="cuda",
                         dtype=torch.float32) -> SMCState:
    """An SMC ladder's carry from numpy arrays: particles (N, *site_shape)
    per address, log-weights and log-likelihoods (N,), scalar β and log Z,
    the (n_sites,) adaptation arrays and the stage counter. ``generator``
    (on ``device``, seeded by the caller) draws the rest of the run."""
    lw = tensor_from_numpy(log_weights, device=device, dtype=dtype)
    ll = tensor_from_numpy(log_likelihoods, device=device, dtype=dtype)
    lat = {str(a): tensor_from_numpy(v, device=device, dtype=dtype) for a, v in particles.items()}
    n = lw.shape[0] if lw.dim() == 1 else -1
    if n < 0 or ll.shape != lw.shape or any(v.dim() < 1 or v.shape[0] != n for v in lat.values()):
        raise ValueError(
            f"log_weights {tuple(lw.shape)}, log_likelihoods {tuple(ll.shape)} and every "
            "particle tensor must share one leading particle dimension"
        )
    ls = tensor_from_numpy(adapt_log_scale, device=device, dtype=dtype)
    t = tensor_from_numpy(adapt_t, device=device, dtype=dtype)
    if ls.dim() != 1 or t.shape != ls.shape:
        raise ValueError(f"adaptation arrays {tuple(ls.shape)}, {tuple(t.shape)} must be (n_sites,)")

    def scalar(x):
        return tensor_from_numpy(np.asarray(x, dtype=np.float64).reshape(()), device=device,
                                 dtype=dtype)

    return SMCState(particles=lat, log_weights=lw, log_likelihoods=ll, beta=scalar(beta),
                    log_evidence=scalar(log_evidence),
                    adapt=AdaptationState(log_scale=ls, t=t),
                    generator_state=generator.get_state(), stage=int(stage))
