"""Carry chain state and data over from numpy arrays.

The counterpart of a model's weights here is chain state and data. The JAX
package's ``HMCResult`` and ``NUTSResult`` hold ``final_positions`` (C, d),
``step_size`` and ``inv_mass`` ((d,) diagonal or (d, d) dense) in the same
address-sorted flat unconstrained layout as this package's ``StagedModel``,
so a state warmed up there continues here once it is converted with
``np.asarray`` and ``hmc_state_from_numpy``: ``hmc_chain(resume=state)`` or
``nuts_chain(resume=state)`` samples on with its step size and mass.

A JAX ``ChEESResult`` adds the learned ``trajectory_length``:
``chees_state_from_numpy`` makes the state ``chees_chain(resume=...)``
reads (the JAX result itself also works there, its arrays converted with
``np.asarray``). A JAX ``MHState`` batch (latents with a leading chain
dimension, log joints, per-chain adaptation arrays) becomes this package's
``MHState`` through ``mh_state_from_numpy``, so the port's ``mh_step``
moves the same chains.

Likewise the JAX ``SMCResult.state`` of a ladder stopped at
``max_stages`` (particles, log-weights, log-likelihoods, β, log Z, the
adaptation arrays, the stage counter) becomes this package's ``SMCState``
through ``smc_state_from_numpy``, and ``adaptive_smc(resume=...)`` finishes
the ladder here. The JAX key does not carry over: the caller seeds the
generator that draws the rest of the run.

A JAX ``VIResult.params`` (``{address: {loc, raw_scale | raw_a, raw_b}}``,
``{loc, raw_scale}`` or ``{loc, raw_tril}``) or its numpy leaves become
this package's flat-backed params through ``vi_params_from_numpy``, and
``optimize_meanfield_vi(resume=...)`` or ``optimize_fullrank_vi(resume=...)``
continues from them (the JAX ``VIResult`` itself also works there).

A JAX ``GibbsResult``'s sweep state (``final_positions`` (C, d),
``final_discrete`` and ``step_size``) becomes a ``GibbsState`` through
``gibbs_state_from_numpy`` for ``gibbs_chain(resume=...)``, and a JAX
``PTResult``'s ladder (``final_positions`` (K, C, d) and the per-rung
``step_size`` (K,)) a ``PTState`` through ``pt_state_from_numpy`` for
``pt_chain(resume=...)``. A JAX ``MAPResult.z`` is a warm start as it is:
``tensor_from_numpy(res.z)`` goes to any engine's ``init_position=``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from .inference.mcmc_utils import AdaptationState
from .inference.mh import MHState
from .inference.smc import SMCState


@dataclass
class HMCState:
    positions: torch.Tensor  # (C, d) unconstrained
    step_size: torch.Tensor  # 0-dim
    inv_mass: torch.Tensor  # (d,) diagonal or (d, d) dense

    @property
    def final_positions(self) -> torch.Tensor:
        """The positions under the name ``resume=`` reads."""
        return self.positions


def tensor_from_numpy(array, *, device="cuda", dtype=None) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor on
    ``device``; ``dtype`` None keeps the array's dtype."""
    t = torch.from_numpy(np.array(array, order="C"))  # a copy: writable, contiguous
    return t.to(device=device, dtype=dtype)


def hmc_state_from_numpy(positions, step_size, inv_mass, *, device="cuda",
                         dtype=torch.float32) -> HMCState:
    """A warmed HMC or NUTS state from numpy arrays, checked for matching
    shapes: positions (C, d), inv_mass (d,) or (d, d)."""
    q = tensor_from_numpy(positions, device=device, dtype=dtype)
    im = tensor_from_numpy(inv_mass, device=device, dtype=dtype)
    if q.dim() != 2 or tuple(im.shape) not in ((q.shape[1],), (q.shape[1], q.shape[1])):
        raise ValueError(
            f"positions {tuple(q.shape)} must be (C, d) and inv_mass "
            f"{tuple(im.shape)} must be (d,) or (d, d)"
        )
    eps = tensor_from_numpy(np.asarray(step_size, dtype=np.float64).reshape(()),
                            device=device, dtype=dtype)
    return HMCState(positions=q, step_size=eps, inv_mass=im)


@dataclass
class ChEESState(HMCState):
    trajectory_length: torch.Tensor  # 0-dim: the learned T


def chees_state_from_numpy(positions, step_size, trajectory_length, inv_mass, *,
                           device="cuda", dtype=torch.float32) -> ChEESState:
    """A warmed ChEES state from numpy arrays: ``hmc_state_from_numpy``'s
    checks, a diagonal (d,) mass and a scalar trajectory length."""
    st = hmc_state_from_numpy(positions, step_size, inv_mass, device=device, dtype=dtype)
    if st.inv_mass.dim() != 1:
        raise ValueError(f"a ChEES mass is diagonal (d,), got {tuple(st.inv_mass.shape)}")
    T = tensor_from_numpy(np.asarray(trajectory_length, dtype=np.float64).reshape(()),
                          device=device, dtype=dtype)
    return ChEESState(positions=st.positions, step_size=st.step_size, inv_mass=st.inv_mass,
                      trajectory_length=T)


def mh_state_from_numpy(latents: Dict[str, np.ndarray], log_joint, adapt_log_scale, adapt_t,
                        *, device="cuda", dtype=torch.float32) -> MHState:
    """A batch of MH chains from numpy arrays: latents (C, *site_shape) per
    address (real values in ``dtype``, bool and integer values as they
    are), log joints (C,), and the (C, n_sites) or shared (n_sites,)
    adaptation arrays."""
    lj = tensor_from_numpy(log_joint, device=device, dtype=dtype)
    c = lj.shape[0] if lj.dim() == 1 else -1
    lat = {}
    for a, v in latents.items():
        v = np.asarray(v)
        lat[str(a)] = tensor_from_numpy(v, device=device,
                                        dtype=dtype if v.dtype.kind == "f" else None)
    if c < 0 or any(v.dim() < 1 or v.shape[0] != c for v in lat.values()):
        raise ValueError(
            f"log_joint {tuple(lj.shape)} and every latent must share one leading chain dimension")
    ls = tensor_from_numpy(adapt_log_scale, device=device, dtype=dtype)
    t = tensor_from_numpy(adapt_t, device=device, dtype=dtype)
    if t.shape != ls.shape or ls.dim() not in (1, 2) or (ls.dim() == 2 and ls.shape[0] != c):
        raise ValueError(f"adaptation arrays {tuple(ls.shape)}, {tuple(t.shape)} must be "
                         f"(n_sites,) or (C={c}, n_sites)")
    return MHState(latents=lat, log_joint=lj, adapt=AdaptationState(log_scale=ls, t=t))


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


def vi_params_from_numpy(params, *, device="cuda", dtype=torch.float32):
    """VI parameters from numpy arrays (or anything ``np.asarray`` takes),
    one or two levels deep, as views of ONE flat tensor on ``device``: the
    same nesting, each leaf's shape kept."""
    leaves = []
    for key in sorted(params):
        v = params[key]
        if isinstance(v, dict):
            leaves += [((str(key), str(name)), np.asarray(v[name])) for name in sorted(v)]
        else:
            leaves.append(((str(key),), np.asarray(v)))
    for path, a in leaves:
        if a.dtype.kind not in "fiu":
            raise ValueError(f"VI parameter {'/'.join(path)} has dtype {a.dtype}, not a real array")
    flat = tensor_from_numpy(np.concatenate([a.reshape(-1).astype(np.float64) for _, a in leaves])
                             if leaves else np.zeros(0), device=device, dtype=dtype)
    out: dict = {}
    off = 0
    for path, a in leaves:
        view = flat[off:off + a.size].view(a.shape)
        off += a.size
        if len(path) == 1:
            out[path[0]] = view
        else:
            out.setdefault(path[0], {})[path[1]] = view
    return out


@dataclass
class GibbsState:
    final_positions: torch.Tensor  # (C, d) unconstrained
    final_discrete: Dict[str, torch.Tensor]  # address -> (C, *site_shape)
    step_size: torch.Tensor  # 0-dim


def gibbs_state_from_numpy(positions, discrete: Dict[str, np.ndarray], step_size, *,
                           device="cuda", dtype=torch.float32) -> GibbsState:
    """A Gibbs sweep state from numpy arrays: positions (C, d), discrete
    values (C, *site_shape) per address (kept in their integer or bool
    dtype) and the scalar step size."""
    q = tensor_from_numpy(positions, device=device, dtype=dtype)
    disc = {str(a): tensor_from_numpy(v, device=device) for a, v in discrete.items()}
    if q.dim() != 2 or any(v.dim() < 1 or v.shape[0] != q.shape[0] for v in disc.values()):
        raise ValueError(f"positions {tuple(q.shape)} must be (C, d) and every discrete "
                         "array must lead with the same C")
    eps = tensor_from_numpy(np.asarray(step_size, dtype=np.float64).reshape(()),
                            device=device, dtype=dtype)
    return GibbsState(final_positions=q, final_discrete=disc, step_size=eps)


@dataclass
class PTState:
    final_positions: torch.Tensor  # (K, C, d) unconstrained, the whole ladder
    step_size: torch.Tensor  # (K,) per rung


def pt_state_from_numpy(positions, step_size, *, device="cuda",
                        dtype=torch.float32) -> PTState:
    """A tempering ladder from numpy arrays: positions (K, C, d) and the
    per-rung step sizes (K,)."""
    q = tensor_from_numpy(positions, device=device, dtype=dtype)
    eps = tensor_from_numpy(step_size, device=device, dtype=dtype)
    if q.dim() != 3 or tuple(eps.shape) != (q.shape[0],):
        raise ValueError(f"positions {tuple(q.shape)} must be (K, C, d) and step sizes "
                         f"{tuple(eps.shape)} (K,)")
    return PTState(final_positions=q, step_size=eps)
