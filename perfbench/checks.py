"""The numbers that decide ``correct``, computed from what the timed path
produced and the plain reference (``reference/<config>.py``).

Density, at one visited state per chain (a draw of the window picked by
the seed), the program's batched value-and-gradient at the timed batch
size against the reference's in float64:

- ``u_gap``: the widest |U_program - U_reference|, in nats;
- ``g_gap``: the widest |grad_program - grad_reference| over the larger of
  that state's |grad_reference| and the median state's.

The drive's output:

- ``draw_gap``: the widest gap between the program's constrained draw and
  the reference's constraining map of its unconstrained draw, over
  max(1, |reference|);
- ``mean_z``: the widest |window mean - posterior mean| of an
  unconstrained coordinate, in standard errors sqrt(posterior variance /
  ESS + the reference mean's own error variance), the ESS of the window's
  draws (``ess.ess_multichain``) and the posterior's moments from the
  reference;
- ``stuck_share``: the share of chains whose draws never changed in the
  window.

The control puts the reference, computed in bfloat16, in the program's
place for the density and draw numbers (``control_numbers``).
"""

from __future__ import annotations

import numpy as np
import torch

from .ess import ess_multichain


def pick_draws(seed_rng: np.random.Generator, n_chains: int, n_draws: int) -> np.ndarray:
    """One draw index per chain."""
    return seed_rng.integers(0, n_draws, size=n_chains)


def _np(x) -> np.ndarray:
    return torch.as_tensor(x).detach().to("cpu", torch.float64).numpy()


def density_numbers(ref, data, states, u_prog, g_prog, dtype=torch.float64) -> dict:
    """u_gap and g_gap of (u_prog (S,), g_prog (S, d)) at ``states`` against
    the reference in float64; with ``dtype`` the reference computed in that
    precision stands in for the program."""
    u64, g64 = ref.potential_and_grad(data, states, torch.float64)
    u64, g64 = _np(u64), _np(g64)
    if u_prog is None:
        u_prog, g_prog = ref.potential_and_grad(data, states, dtype)
    u_prog, g_prog = _np(u_prog), _np(g_prog)
    gn = np.linalg.norm(g64, axis=1)
    denom = np.maximum(gn, np.median(gn))
    return {"u_gap": float(np.max(np.abs(u_prog - u64))),
            "g_gap": float(np.max(np.linalg.norm(g_prog - g64, axis=1) / denom))}


def draw_gap(ref, states, constrained_prog, dtype=torch.float64) -> float:
    c64 = _np(ref.constrain(states, torch.float64))
    if constrained_prog is None:
        constrained_prog = ref.constrain(states, dtype)
    c = _np(constrained_prog)
    return float(np.max(np.abs(c - c64) / np.maximum(1.0, np.abs(c64))))


def chain_numbers(positions: np.ndarray, mean: np.ndarray, var: np.ndarray,
                  err=0.0) -> dict:
    """mean_z and stuck_share of the window's (C, n, d) unconstrained draws
    against the posterior's (mean, variance, the mean's error variance)."""
    x = np.moveaxis(np.asarray(positions, np.float64), -1, 0)  # (d, C, n)
    ess = np.maximum(ess_multichain(x), 1.0)
    z = (x.mean(axis=(1, 2)) - mean) / np.sqrt(var / ess + err)
    stuck = np.all(positions == positions[:, :1], axis=(1, 2))
    return {"mean_z": float(np.max(np.abs(z))), "stuck_share": float(np.mean(stuck))}


def control_numbers(ref, data, states, dtype=torch.bfloat16) -> dict:
    """The density and draw numbers of the reference computed in ``dtype``
    put in the program's place, at the same states."""
    out = density_numbers(ref, data, states, None, None, dtype)
    out["draw_gap"] = draw_gap(ref, states, None, dtype)
    return out


def flat_constrained(samples: dict, n_chains: int, n_draws: int) -> torch.Tensor:
    """A drive's constrained samples {site: (C, n, *shape)} as (C, n, k), in
    site order."""
    return torch.cat([v.reshape(n_chains, n_draws, -1) for v in samples.values()], dim=-1)


def min_ess(draws: np.ndarray) -> float:
    """The smallest ESS over the scalar components of (C, n, k) draws."""
    return float(np.min(ess_multichain(np.moveaxis(np.asarray(draws, np.float64), -1, 0))))
