"""Staging: one discovery run → functions of flat tensors.

The port of ``Site``, ``StagedModel`` and ``stage`` from
``fugue_tpu/runtime/staging.py``. A model runs once under a
``PriorHandler`` to discover its site table (address-sorted sites with
supports and shapes); from then on the sampler sees a pure function of a
flat unconstrained position ``z``:

- ``potential(z)`` → ``-(log p + log|J|)`` for ONE chain's ``z`` of shape
  (d,). The HMC drive evaluates it for a whole batch of chains at once as
  ``torch.func.vmap(torch.func.grad_and_value(potential))``, so the Python
  model runs once per batch, never once per chain;
- ``log_density_parts`` keeps the reference's three-accumulator split;
- ``sample_prior_batch(seed, n)`` draws n particles in ONE model run under
  ``vmap(..., randomness="different")``, for SMC's stage 0;
- ``flatten_constrained`` / ``unflatten_constrained`` map latents to the flat
  CONSTRAINED layout that single-site MH proposes in, with any leading
  batch dimensions.

The model must have static structure: its set of addresses may not depend
on sampled values. There is no ``jit`` here, so nothing is cached per
engine configuration; the state a staged model carries is its site table
and its ``device``. Discrete sites wait for the distributions that make
them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import torch

from torch.func import vmap

from .. import settings
from ..core.distributions import Support
from ..errors import ErrorCode, StagingError
from .handler import run
from .interpreters import (
    ConstrainHandler,
    PriorHandler,
    UnconstrainHandler,
    ValuesHandler,
)


@dataclass(frozen=True)
class Site:
    """Static metadata for one latent site."""

    address: str
    support: Support
    shape: Tuple[int, ...]
    kind: str  # real | bool | int
    size: int  # number of scalar elements

    @property
    def is_continuous(self) -> bool:
        return self.support.is_continuous


@dataclass
class LogDensityParts:
    """The three reference accumulators."""

    log_prior: Any
    log_likelihood: Any
    log_factors: Any

    def total(self):
        return self.log_prior + self.log_likelihood + self.log_factors


class StagedModel:
    """A model over a fixed site table, with the device its tensors live on."""

    def __init__(self, model_fn: Callable, args: tuple = (), kwargs: dict = None,
                 *, device="cuda", discovery_seed: int = 0):
        self.model_fn = model_fn
        self.args = args
        self.kwargs = kwargs or {}
        self.device = torch.device(device)
        self._discover(discovery_seed)

    def _run(self, handler):
        return run(handler, self.model_fn, *self.args, **self.kwargs)

    # -- discovery ----------------------------------------------------------

    def _discover(self, seed: int) -> None:
        _, trace = self._run(PriorHandler(seed, self.device))
        sites: List[Site] = []
        for a in sorted(trace.choices.keys()):
            c = trace.choices[a]
            if c.is_observed:
                continue
            shape = tuple(torch.as_tensor(c.value).shape)
            sites.append(Site(a, c.support, shape, c.kind, math.prod(shape)))
        for s in sites:
            if not s.is_continuous:
                raise StagingError(
                    ErrorCode.NOT_STAGEABLE,
                    f"site {s.address!r} is discrete; the PyTorch port stages "
                    "continuous sites only",
                    {"address": s.address},
                )
        self.sites: List[Site] = sites
        self.site_index: Dict[str, int] = {s.address: i for i, s in enumerate(sites)}
        self.continuous_sites: List[Site] = list(sites)
        self.discrete_sites: List[Site] = []  # no discrete distribution yet
        self.observed_addresses = sorted(
            a for a, c in trace.choices.items() if c.is_observed
        )
        # flat constrained layout over continuous sites, address-sorted
        self._offsets: Dict[str, Tuple[int, int]] = {}
        off = 0
        for s in self.continuous_sites:
            self._offsets[s.address] = (off, off + s.size)
            off += s.size
        self.constrained_dim = off
        # flat unconstrained layout (z); the transforms ported so far keep
        # each site's shape, so it matches the constrained one
        self._z_offsets: Dict[str, Tuple[int, int]] = dict(self._offsets)
        self.dim = off

    # -- density ------------------------------------------------------------

    def sample_prior(self, seed: int) -> Dict[str, Any]:
        """Fresh prior draw of every latent, as an address → tensor dict."""
        _, trace = self._run(PriorHandler(seed, self.device))
        return trace.latents()

    def sample_prior_batch(self, seed: int, n: int) -> Dict[str, Any]:
        """``n`` independent prior draws in ONE model run: each latent gets
        a leading (n,) dimension. Every site's generator draws its n values
        at once (``vmap`` with ``randomness="different"``), so the batch is
        a function of ``seed`` and ``n`` alone."""
        def one(_):
            return self.sample_prior(seed)

        return vmap(one, randomness="different")(torch.zeros(n, device=self.device))

    def log_density_parts(self, latents: Dict[str, Any]) -> LogDensityParts:
        """Replay with the given latent values; score everything."""
        _, trace = self._run(ValuesHandler(latents))
        return LogDensityParts(trace.log_prior, trace.log_likelihood, trace.log_factors)

    def log_joint(self, latents: Dict[str, Any]):
        return self.log_density_parts(latents).total()

    # -- flat constrained layout (single-site MH proposes here) ------------

    def flatten_constrained(self, latents: Dict[str, Any]):
        """Latents → (..., constrained_dim) in ``settings.real_dtype()``;
        leading dimensions beyond each site's shape are kept."""
        dt = settings.real_dtype()
        parts = []
        for s in self.continuous_sites:
            v = torch.as_tensor(latents[s.address]).to(dt)
            parts.append(v.reshape(*v.shape[: v.dim() - len(s.shape)], s.size))
        if not parts:
            return torch.zeros((0,), dtype=dt, device=self.device)
        return torch.cat(parts, dim=-1)

    def unflatten_constrained(self, vec) -> Dict[str, Any]:
        out = {}
        for s in self.continuous_sites:
            lo, hi = self._offsets[s.address]
            out[s.address] = vec[..., lo:hi].reshape(*vec.shape[:-1], *s.shape)
        return out

    # -- flat unconstrained parameterization --------------------------------

    def _split_z(self, z) -> Dict[str, Any]:
        return {
            s.address: z[self._z_offsets[s.address][0]:
                         self._z_offsets[s.address][1]].reshape(s.shape)
            for s in self.sites
        }

    def _constrain_run(self, z):
        """One model replay in unconstrained space → (trace, Σ log|J|)."""
        h = ConstrainHandler(self._split_z(z))
        _, trace = self._run(h)
        return trace, h.logdet

    def constrain(self, z) -> Tuple[Dict[str, Any], Any]:
        """Unconstrained flat vector z → (constrained latent dict, Σ log|J|)."""
        trace, logdet = self._constrain_run(z)
        lat = trace.latents()
        return {s.address: lat[s.address] for s in self.sites}, logdet

    def unconstrain(self, latents: Dict[str, Any]):
        """Constrained latent dict → flat unconstrained vector z."""
        h = UnconstrainHandler(dict(latents))
        self._run(h)
        parts = [h.z_out[s.address].reshape(-1) for s in self.sites]
        if not parts:
            return torch.zeros((0,), dtype=settings.real_dtype(), device=self.device)
        return torch.cat(parts)

    def log_density_parts_unconstrained(self, z) -> Tuple[LogDensityParts, Any]:
        """(density parts, Σ log|J|) in ONE model replay."""
        trace, logdet = self._constrain_run(z)
        parts = LogDensityParts(trace.log_prior, trace.log_likelihood, trace.log_factors)
        return parts, logdet

    def log_joint_unconstrained(self, z):
        """log p(x(z)) + log|J(z)| — the target for HMC."""
        parts, logdet = self.log_density_parts_unconstrained(z)
        return parts.total() + logdet

    def potential(self, z):
        """U(z) = -(log p + log|J|) for one chain's z of shape (d,)."""
        return -self.log_joint_unconstrained(z)

    def initial_position(self, seed: int):
        """Prior draw mapped to the unconstrained space."""
        return self.unconstrain(self.sample_prior(seed))

    def flat_to_dict(self, z) -> Dict[str, Any]:
        cont, _ = self.constrain(z)
        return cont

    def site(self, address: str) -> Site:
        i = self.site_index.get(str(address))
        if i is None:
            raise StagingError(
                ErrorCode.NOT_STAGEABLE,
                f"unknown site {address!r}",
                {"known": [s.address for s in self.sites]},
            )
        return self.sites[i]


def stage(model_fn: Callable, *args, device="cuda", discovery_seed: int = 0,
          **kwargs) -> StagedModel:
    """Stage a model function whose tensors live on ``device``."""
    return StagedModel(model_fn, args, kwargs, device=device,
                       discovery_seed=discovery_seed)
