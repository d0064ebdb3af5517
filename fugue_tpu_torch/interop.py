"""Carry chain state and data over from numpy arrays.

The counterpart of a model's weights here is chain state and data. The JAX
package's ``HMCResult`` holds ``final_positions`` (C, d), ``step_size`` and
``inv_mass`` (d,) in the same address-sorted flat unconstrained layout as
this package's ``StagedModel``, so a state warmed up there continues here
(``hmc_transition``, or ``hmc_chain(init_position=state.positions)``) once
it is converted with ``np.asarray`` and ``hmc_state_from_numpy``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class HMCState:
    positions: torch.Tensor  # (C, d) unconstrained
    step_size: torch.Tensor  # 0-dim
    inv_mass: torch.Tensor  # (d,) diagonal


def tensor_from_numpy(array, *, device="cpu", dtype=None) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor on
    ``device``; ``dtype`` None keeps the array's dtype."""
    t = torch.from_numpy(np.array(array, order="C"))  # a copy: writable, contiguous
    return t.to(device=device, dtype=dtype)


def hmc_state_from_numpy(positions, step_size, inv_mass, *, device="cpu",
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
