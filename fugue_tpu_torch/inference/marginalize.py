"""Exact marginalization of enumerable discrete latents.

The port of ``fugue_tpu/inference/marginalize.py``: ``MarginalizedModel``
and ``marginalize``. For a model with discrete latents of finite domain
(Bernoulli switches, categories, bounded integer ranges),

    log p(x, theta) = logsumexp_k  log p(x, theta, d = a_k)

over the cartesian product a_1..a_K of every discrete element's domain.
The marginal joint is smooth in the continuous latents, so every
continuous engine (``hmc_chain``, ``nuts_chain``, ``adaptive_mcmc_chain``,
``optimize_meanfield_vi``, ``map_estimate``) runs on it unchanged through
``staged=``; ``discrete_posterior`` and ``infer_discrete`` recover the
discrete posterior exactly afterwards.

The K per-assignment replays are ONE ``vmap`` over a static (K, ...)
assignment table on the model's device, so under the engines' chain
``vmap`` a batched gradient is one model run over chains x states.
Non-enumerable sites (Poisson, Geometric counts) raise a typed error: use
``gibbs_chain`` for those.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap

from ..core.numerics import log_sum_exp
from ..errors import ErrorCode, StagingError
from ..runtime.staging import Site, StagedModel, stage

_DEFAULT_MAX_STATES = 4096


def _site_domain(site: Site) -> Optional[np.ndarray]:
    """Finite per-element domain of a discrete site, or None if unbounded."""
    s = site.support
    if s.kind == "boolean":
        return np.array([False, True])
    if s.kind in ("categorical", "int_range"):
        if s.low is None or s.high is None:
            return None
        return np.arange(int(s.low), int(s.high) + 1)
    return None  # count etc.: unbounded


class MarginalizedModel:
    """A staged model with every discrete latent summed out exactly.

    It has the continuous-engine surface of ``StagedModel`` (``dim``,
    ``potential``, ``log_joint_unconstrained``, ``log_joint``,
    ``constrain``, ``unconstrain``, ``initial_position``,
    ``sample_prior_batch``, ...) where every density is the exact
    discrete marginal. ``sites``, ``site_index`` and ``discrete_sites``
    report only continuous sites, so engines treat the model as fully
    continuous. Other attributes delegate to the wrapped ``StagedModel``.
    """

    def __init__(self, staged: StagedModel, *, max_states: int = _DEFAULT_MAX_STATES):
        self._inner = staged
        self._marg_sites: List[Site] = list(staged.discrete_sites)
        if not self._marg_sites:
            raise StagingError(
                ErrorCode.NOT_STAGEABLE,
                "model has no discrete latent sites to marginalize",
                {"sites": [s.address for s in staged.sites]},
            )
        elems: List[Tuple[Site, np.ndarray]] = []
        for s in self._marg_sites:
            dom = _site_domain(s)
            if dom is None:
                raise StagingError(
                    ErrorCode.NOT_STAGEABLE,
                    f"discrete site {s.address!r} has unbounded support "
                    f"{s.support.kind!r} — not enumerable; use gibbs_chain "
                    "(inference/gibbs.py) for unbounded counts",
                    {"site": s.address, "support": s.support.kind},
                )
            for _ in range(s.size):
                elems.append((s, dom))
        n_states = 1
        for _, dom in elems:
            n_states *= len(dom)
            if n_states > max_states:
                raise StagingError(
                    ErrorCode.NOT_STAGEABLE,
                    f"enumeration needs {n_states}+ joint states "
                    f"(> max_states={max_states}); marginalize fewer sites "
                    "or raise max_states",
                    {"n_elements": len(elems)},
                )
        self.n_states = n_states

        # static assignment table: address -> (K, *shape) values, the
        # row-major cartesian product (element e cycles with the period of
        # the elements after it)
        idx = np.arange(n_states)
        period = n_states
        cols: List[np.ndarray] = []
        for _, dom in elems:
            period //= len(dom)
            cols.append(dom[(idx // period) % len(dom)])
        self._assignments: Dict[str, Any] = {}
        ci = 0
        for s in self._marg_sites:
            ref = torch.as_tensor(staged._discovery_trace.choices[s.address].value)
            vals = np.stack(cols[ci:ci + s.size], axis=-1)
            ci += s.size
            self._assignments[s.address] = torch.as_tensor(
                vals.reshape((n_states,) + s.shape)).to(device=staged.device, dtype=ref.dtype)
        self.site_index = {s.address: i for i, s in enumerate(self.sites)}
        # MH's packed-proposal metadata is built per site table: never the
        # inner model's, which counts the summed-out sites
        self._mh_packed_meta = None

    # -- discrete-free site table -------------------------------------------

    @property
    def sites(self):
        return self._inner.continuous_sites

    @property
    def continuous_sites(self):
        return self._inner.continuous_sites

    @property
    def discrete_sites(self):
        return []

    @property
    def marginalized_sites(self) -> List[Site]:
        return self._marg_sites

    def site(self, address: str) -> Site:
        return self._inner.site(address)

    def _continuous(self, latents: Dict[str, Any]) -> Dict[str, Any]:
        return {s.address: latents[s.address] for s in self._inner.continuous_sites}

    def sample_prior(self, seed: int) -> Dict[str, Any]:
        return self._continuous(self._inner.sample_prior(seed))

    def sample_prior_batch(self, seed: int, n: int) -> Dict[str, Any]:
        return self._continuous(self._inner.sample_prior_batch(seed, n))

    def sample_prior_batch_scored(self, seed: int, n: int):
        """n continuous prior draws and their MARGINAL log joints (n,)."""
        lat = self.sample_prior_batch(seed, n)
        return lat, vmap(self.log_joint)(lat)

    # -- marginal densities --------------------------------------------------

    def _per_state_log_joint_z(self, z):
        """(K,) log p(x, theta(z), d=a_k) + log|J| for every assignment."""
        return vmap(lambda disc: self._inner.log_joint_unconstrained(z, disc))(
            self._assignments)

    def _per_state_log_joint(self, latents: Dict[str, Any]):
        cont = self._continuous(latents)
        return vmap(lambda disc: self._inner.log_joint({**cont, **disc}))(self._assignments)

    def log_joint_unconstrained(self, z, discrete: Optional[Dict[str, Any]] = None):
        if discrete:
            raise StagingError(
                ErrorCode.NOT_STAGEABLE,
                "marginalized model takes no discrete values — they are "
                "summed out",
                {"given": sorted(discrete)},
            )
        return log_sum_exp(self._per_state_log_joint_z(z))

    def potential(self, z, discrete: Optional[Dict[str, Any]] = None):
        return -self.log_joint_unconstrained(z, discrete)

    def log_joint(self, latents: Dict[str, Any]):
        return log_sum_exp(self._per_state_log_joint(latents))

    def log_density_parts(self, latents):
        raise StagingError(
            ErrorCode.NOT_STAGEABLE,
            "prior/likelihood/factor accumulators do not decompose under "
            "discrete marginalization (only the total joint is defined); "
            "for tempered SMC write the logsumexp as an explicit factor() "
            "in the model instead",
            {},
        )

    def log_density_parts_unconstrained(self, z, discrete=None):
        self.log_density_parts(None)

    def initial_position(self, seed: int):
        return self._inner.unconstrain(self.sample_prior(seed))

    # -- discrete-posterior recovery ----------------------------------------

    def _state_log_weights(self, latents: Dict[str, Any]):
        lj = self._per_state_log_joint(latents)
        return lj - log_sum_exp(lj)

    def discrete_posterior(self, latents: Dict[str, Any]) -> Dict[str, Any]:
        """Exact conditional p(d | theta, x) for ONE continuous draw: per
        marginalized site, the per-element category probabilities of shape
        ``(*site.shape, |domain|)`` (boolean sites: [P(False), P(True)])."""
        w = torch.exp(self._state_log_weights(latents))
        out: Dict[str, Any] = {}
        for s in self._marg_sites:
            vals = self._assignments[s.address]  # (K, *shape)
            dom = torch.as_tensor(_site_domain(s)).to(device=vals.device, dtype=vals.dtype)
            onehot = (vals[..., None] == dom).to(w.dtype)
            out[s.address] = torch.tensordot(w, onehot, dims=([0], [0]))
        return out

    def infer_discrete(self, seed: int, samples: Dict[str, Any]) -> Dict[str, Any]:
        """One draw of the discrete sites from their exact conditionals per
        continuous posterior draw, all draws in one batched model run.

        ``samples``: address → tensor with any leading batch dims (the
        engines' ``(n_chains, n_samples, *shape)``). Returns address →
        values with the same leading dims for every marginalized site. The
        draw is a Gumbel-max over the K states' log-weights, from a
        ``torch.Generator`` seeded with ``seed``."""
        cont_sites = self._inner.continuous_sites
        first = torch.as_tensor(samples[cont_sites[0].address])
        batch = tuple(first.shape[: first.dim() - len(cont_sites[0].shape)])
        n = int(np.prod(batch)) if batch else 1
        flat = {s.address: torch.as_tensor(samples[s.address]).reshape((n,) + s.shape)
                for s in cont_sites}
        logw = vmap(self._state_log_weights)(flat)  # (n, K)
        g = torch.Generator(device=logw.device).manual_seed(int(seed))
        u = torch.rand(logw.shape, generator=g, device=logw.device, dtype=logw.dtype)
        u = torch.clamp(u, min=torch.finfo(logw.dtype).tiny)
        ki = torch.argmax(logw - torch.log(-torch.log(u)), dim=-1)
        return {a: v[ki].reshape(batch + tuple(v.shape[1:]))
                for a, v in self._assignments.items()}

    def __getattr__(self, name):
        # everything structural (dim, constrain, unconstrain, device,
        # model_fn, ...) comes from the wrapped staged model
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)


def marginalize(
    model_fn: Optional[Callable] = None,
    *model_args,
    staged: Optional[StagedModel] = None,
    max_states: int = _DEFAULT_MAX_STATES,
    device="cuda",
    **model_kwargs,
) -> MarginalizedModel:
    """Stage ``model_fn`` on ``device`` and sum out its enumerable discrete
    latents (``device`` is used only when ``staged`` is not given).

    >>> marg = marginalize(gmm_model)
    >>> res = hmc_chain(0, staged=marg, n_chains=1024)     # smooth target
    >>> zs = marg.infer_discrete(1, res.samples)           # exact p(d|theta,x)
    """
    if staged is None:
        staged = stage(model_fn, *model_args, device=device, **model_kwargs)
    return MarginalizedModel(staged, max_states=max_states)
