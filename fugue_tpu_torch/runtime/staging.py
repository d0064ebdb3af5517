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
  ``vmap(..., randomness="different")``, for SMC's stage 0, and
  ``sample_prior_batch_scored`` scores them in the same run, for MH's
  initial state;
- ``simulate`` and ``replay_partial`` run the model as a simulator (fresh
  draws, or some latents pinned and the rest drawn) and return its value
  with the trace; ``simulate_batch`` and ``replay_partial_batch`` do the
  same for a batch in ONE model run, for ABC and predictive;
- ``flatten_constrained`` / ``unflatten_constrained`` map latents to the flat
  CONSTRAINED layout that single-site MH proposes in, with any leading
  batch dimensions.

Discrete sites (bool and integer values) are part of the site table and of
every latent dict, but not of ``z``: the unconstrained functions take their
values as ``discrete=`` and default to the discovery run's values, so HMC
and NUTS hold them fixed while single-site MH proposes them.

The model must have static structure: its set of addresses may not depend
on sampled values. There is no ``jit`` here, so nothing is cached per
engine configuration; the state a staged model carries is its site table,
its discovery trace and its ``device``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from torch.func import vmap

from .. import settings
from ..core.distributions import Support
from ..errors import ErrorCode, StagingError
from .handler import run
from .interpreters import (
    ConstrainHandler,
    PartialValuesHandler,
    PriorHandler,
    UnconstrainHandler,
    ValuesHandler,
)
from .trace import Choice, Trace


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

    @property
    def z_shape(self) -> Tuple[int, ...]:
        """Shape of the site's UNCONSTRAINED parameterization: ``shape``,
        except for simplex sites, whose stick-breaking transform maps k
        components to k − 1 free coordinates."""
        if self.support.kind == "simplex":
            return tuple(self.shape[:-1]) + (self.support.size - 1,)
        return tuple(self.shape)

    @property
    def z_size(self) -> int:
        return math.prod(self.z_shape)


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
        self.sites: List[Site] = sites
        self.site_index: Dict[str, int] = {s.address: i for i, s in enumerate(sites)}
        self.continuous_sites: List[Site] = [s for s in sites if s.is_continuous]
        self.discrete_sites: List[Site] = [s for s in sites if not s.is_continuous]
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
        # flat unconstrained layout (z); sizes differ for simplex sites
        self._z_offsets: Dict[str, Tuple[int, int]] = {}
        zoff = 0
        for s in self.continuous_sites:
            self._z_offsets[s.address] = (zoff, zoff + s.z_size)
            zoff += s.z_size
        self.dim = zoff
        self._discovery_trace = trace

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
        return self.sample_prior_batch_scored(seed, n)[0]

    def sample_prior_batch_scored(self, seed: int, n: int):
        """``sample_prior_batch`` with each draw's log joint (n,), scored in
        the same model run (the prior run scores every site):
        (latents, log_joint)."""
        dt = settings.real_dtype()

        def one(_):
            _, trace = self._run(PriorHandler(seed, self.device))
            total = torch.as_tensor(trace.total_log_weight(), dtype=dt, device=self.device)
            return trace.latents(), total

        return vmap(one, randomness="different")(torch.zeros(n, device=self.device))

    def log_density_parts(self, latents: Dict[str, Any]) -> LogDensityParts:
        """Replay with the given latent values; score everything."""
        _, trace = self._run(ValuesHandler(latents))
        return LogDensityParts(trace.log_prior, trace.log_likelihood, trace.log_factors)

    def log_joint(self, latents: Dict[str, Any]):
        return self.log_density_parts(latents).total()

    def prior_trace(self, seed: int):
        """The whole trace of one prior run."""
        return self._run(PriorHandler(seed, self.device))[1]

    def replay(self, latents: Dict[str, Any]):
        """Replay with the given latents → (model return value, trace)."""
        return self._run(ValuesHandler(latents))

    def replay_trace(self, latents: Dict[str, Any]):
        """The trace of a replay with the given latents: values and the
        three density accumulators."""
        return self._run(ValuesHandler(latents))[1]

    # -- simulation (ABC, predictive) ---------------------------------------

    def simulate(self, seed: int):
        """Fresh prior run → (model return value, latent dict): the
        likelihood-free simulator."""
        result, trace = self._run(PriorHandler(seed, self.device))
        return result, trace.latents()

    def replay_partial(self, seed: int, values: Dict[str, Any]):
        """Replay with the latents in ``values`` pinned and the others (a
        simulator's noise sites) drawn fresh → (model return value, trace)."""
        return self._run(PartialValuesHandler(seed, values, self.device))

    def _batched(self, handler, n: int, values=None, randomness: str = "different"):
        """One model run under ``vmap`` over n rows → (results, batched
        Trace): every value, log-prob and accumulator gains a
        leading (n,) dim, and the entries of ``values`` pin row by row. The
        supports and observed flags, which do not depend on the row, come
        from the one run."""
        dt = settings.real_dtype()
        meta = {}

        def as_real(x):  # a Python number becomes a tensor made on the device
            if isinstance(x, torch.Tensor):
                return x.to(dt)
            return torch.full((), float(x), dtype=dt, device=self.device)

        def one(vals):
            result, trace = self._run(handler(vals))
            meta.update({a: (c.support, c.is_observed) for a, c in trace.choices.items()})
            return (result,
                    {a: c.value for a, c in trace.choices.items()},
                    {a: as_real(c.log_prob) for a, c in trace.choices.items()},
                    as_real(trace.log_prior), as_real(trace.log_likelihood),
                    as_real(trace.log_factors))

        if values:
            out = vmap(one, randomness=randomness)(values)
        else:
            out = vmap(lambda _: one({}), randomness=randomness)(
                torch.zeros(n, device=self.device))
        result, value, log_prob, lp, ll, lf = out
        choices = {a: Choice(value[a], log_prob[a], *meta[a]) for a in value}
        return result, Trace(choices, lp, ll, lf)

    def simulate_batch(self, seed: int, n: int):
        """``n`` fresh prior runs in ONE model run (``vmap``, a different
        draw per row) → (model return values, latent dict), each with a
        leading (n,) dim."""
        result, trace = self._batched(lambda _: PriorHandler(seed, self.device), n)
        return result, trace.latents()

    def replay_partial_batch(self, seed: int, values: Dict[str, Any], *,
                             randomness: str = "different"):
        """``replay_partial`` for a batch in ONE model run: each entry of
        ``values`` has a leading (n,) dim and pins row by row, the other
        latents are drawn fresh, a different draw per row (``randomness=
        "same"``: one draw shared by every row) → (model return values,
        batched Trace)."""
        if not values:
            raise ValueError("replay_partial_batch needs at least one pinned site; "
                             "simulate_batch draws every site")
        return self._batched(lambda v: PartialValuesHandler(seed, v, self.device), 0,
                             values, randomness)

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
                         self._z_offsets[s.address][1]].reshape(s.z_shape)
            for s in self.continuous_sites
        }

    def merge_discrete(self, cont: Dict[str, Any],
                       discrete: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """``cont`` with the discrete sites' values added: from ``discrete``
        where given, else the discovery run's."""
        merged = dict(cont)
        if discrete:
            merged.update(discrete)
        for s in self.discrete_sites:
            merged.setdefault(s.address, self._discovery_trace.choices[s.address].value)
        return merged

    def _constrain_run(self, z, discrete: Optional[Dict[str, Any]] = None):
        """One model replay in unconstrained space → (trace, Σ log|J|).
        Transforms are rebuilt from each site's runtime distribution, so
        dependent bounds use their current values."""
        h = ConstrainHandler(self._split_z(z), self.merge_discrete({}, discrete))
        _, trace = self._run(h)
        return trace, h.logdet

    def constrain(self, z, discrete: Optional[Dict[str, Any]] = None
                  ) -> Tuple[Dict[str, Any], Any]:
        """Unconstrained flat vector z → (constrained continuous latents,
        Σ log|J|)."""
        trace, logdet = self._constrain_run(z, discrete)
        lat = trace.latents()
        return {s.address: lat[s.address] for s in self.continuous_sites}, logdet

    def unconstrain(self, latents: Dict[str, Any],
                    discrete: Optional[Dict[str, Any]] = None):
        """Constrained latent dict → flat unconstrained vector z (the exact
        inverse of ``constrain``, dependent bounds included)."""
        h = UnconstrainHandler(self.merge_discrete(dict(latents), discrete))
        self._run(h)
        parts = [h.z_out[s.address].reshape(-1) for s in self.continuous_sites]
        if not parts:
            return torch.zeros((0,), dtype=settings.real_dtype(), device=self.device)
        return torch.cat(parts)

    def log_density_parts_unconstrained(self, z, discrete: Optional[Dict[str, Any]] = None
                                        ) -> Tuple[LogDensityParts, Any]:
        """(density parts, Σ log|J|) in ONE model replay."""
        trace, logdet = self._constrain_run(z, discrete)
        parts = LogDensityParts(trace.log_prior, trace.log_likelihood, trace.log_factors)
        return parts, logdet

    def log_joint_unconstrained(self, z, discrete: Optional[Dict[str, Any]] = None):
        """log p(x(z), discrete) + log|J(z)|: the target for HMC and NUTS."""
        parts, logdet = self.log_density_parts_unconstrained(z, discrete)
        return parts.total() + logdet

    def potential(self, z, discrete: Optional[Dict[str, Any]] = None):
        """U(z) = -(log p + log|J|) for one chain's z of shape (d,)."""
        return -self.log_joint_unconstrained(z, discrete)

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
