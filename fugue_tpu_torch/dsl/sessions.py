"""Incremental sampler sessions and visualization utilities.

The port of ``fugue_tpu/dsl/sessions.py``: ``MhSession`` (incremental
multi-chain adaptive MH with a capped history and an optional pinned
proposal scale), ``ParticleFilter`` (a 1-D bootstrap filter on a Gaussian
random walk), the one-shot ``smc_run`` and the 2-D ``log_joint_grid``
heatmap. ``HmcSession`` (``inference/hmc.py``) provides the recorded
trajectories and is re-exported here.

Each session holds its state on the staged model's device and draws from a
``torch.Generator`` there. ``MhSession`` keeps its history and acceptance
count on the device and reads back once per ``step(n)`` call;
``ParticleFilter.observe`` reads back once per observation.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import vmap

from .. import settings
from ..core.rng import fold_seed
from ..inference.hmc import HmcSession  # noqa: F401  (re-export)
from ..inference.mh import MHState, init_mh_state, mh_step
from ..inference.smc import SMCConfig, adaptive_smc
from ..ops.kernels import systematic_resample_from_u0
from ..utils import profiling
from ..ops.resampling import effective_sample_size, normalize_log_weights
from ..runtime.staging import StagedModel, stage
from .compiler import as_data


class MhSession:
    """Incremental adaptive MH over ``n_chains`` chains, moved as one batch.

    ``seed`` seeds the chains' prior draw and a ``torch.Generator`` on the
    staged model's device that draws every transition. The last
    ``history_cap`` states stay on the device; ``step(n)`` reads the latest
    values and the acceptance count back in one transfer."""

    def __init__(
        self,
        seed: int,
        model_fn: Optional[Callable] = None,
        *,
        n_chains: int = 4,
        history_cap: int = 4096,
        pinned_scale: Optional[float] = None,
        staged: Optional[StagedModel] = None,
        model_args: tuple = (),
        device="cuda",
    ):
        self.staged = staged if staged is not None else stage(model_fn, *model_args,
                                                               device=device)
        self.n_chains = n_chains
        self.history_cap = history_cap
        self.pinned = pinned_scale is not None
        dev = self.staged.device
        self._state = init_mh_state(self.staged, fold_seed(seed, 0), n_chains,
                                    pinned_scale if self.pinned else 0.5)
        self._generator = torch.Generator(device=dev).manual_seed(fold_seed(seed, 1))
        self._history: List[Dict[str, torch.Tensor]] = []  # device tensors, oldest first
        self._accepts = torch.zeros((), dtype=torch.int64, device=dev)
        self._accepts_read = 0  # the host's copy, as of the last step() call
        self._steps = 0

    @property
    def carry(self) -> Dict[str, Any]:
        """What the next transition depends on: the batched ``MHState`` and
        the generator. Save it with ``runtime.checkpoint.save_checkpoint``
        and assign a restored one to continue bitwise."""
        return {"state": self._state, "generator": self._generator}

    @carry.setter
    def carry(self, value: Dict[str, Any]) -> None:
        state, generator = value["state"], value["generator"]
        if not isinstance(state, MHState) or not isinstance(generator, torch.Generator):
            raise TypeError("carry needs an MHState 'state' and a torch.Generator 'generator'")
        self._state, self._generator = state, generator

    def step(self, n: int = 1) -> Dict[str, np.ndarray]:
        """Advance all chains n transitions; returns the latest values
        (address → (n_chains, ...) array)."""
        for _ in range(n):
            self._state, accepted = mh_step(self.staged, self._state, self._generator,
                                            not self.pinned)
            self._accepts += accepted.sum()
            self._steps += self.n_chains
            self._history.append(dict(self._state.latents))
            if len(self._history) > self.history_cap:
                self._history.pop(0)
        latest = self._history[-1]
        # one device-to-host transfer: every latest value, then the count
        # (float64 holds the float32, bool and integer values exactly)
        profiling.host_read("mh_session.step")
        packed = torch.cat([v.reshape(-1).to(torch.float64) for v in latest.values()]
                           + [self._accepts.reshape(1).to(torch.float64)]).cpu().numpy()
        self._accepts_read = int(packed[-1])
        out, off = {}, 0
        for a, v in latest.items():
            out[a] = packed[off:off + v.numel()].reshape(tuple(v.shape)).astype(
                str(v.dtype).removeprefix("torch."))
            off += v.numel()
        return out

    @property
    def history(self) -> List[Dict[str, np.ndarray]]:
        """The capped history, oldest first, read back from the device."""
        if not self._history:
            return []
        profiling.host_read("mh_session.history", len(self._history[0]))
        stacked = {a: torch.stack([h[a] for h in self._history]).cpu().numpy()
                   for a in self._history[0]}
        return [{a: v[i] for a, v in stacked.items()} for i in range(len(self._history))]

    @property
    def accept_rate(self) -> float:
        return self._accepts_read / max(self._steps, 1)

    def chain_values(self, address: str) -> np.ndarray:
        """(n_steps, n_chains) history for one site."""
        profiling.host_read("mh_session.chain_values")
        return torch.stack([h[str(address)] for h in self._history]).cpu().numpy()


def pf_step(particles, log_w, y: float, noise, u0, process_sd: float, obs_sd: float):
    """One predict-update-resample step of the bootstrap filter, given its
    draws: ``noise`` (N,) standard normals for the random walk and ``u0``
    (0-dim) the systematic comb's offset. Like the JAX filter it always
    resamples and keeps the result where the ESS fell below N/2, with no
    branch on the host. Returns (particles, log-weights, mean, var, ess).

    The ESS is two ``plogsumexp`` calls, the resample one
    ``systematic_resample_from_u0`` call and the normalisation one more
    ``plogsumexp``: on a CUDA tensor, the port's kernels."""
    n = particles.shape[0]
    prop = particles + process_sd * noise
    lw = log_w + (-0.5 * ((y - prop) / obs_sd) ** 2 - math.log(obs_sd)
                  - 0.5 * math.log(2 * math.pi))
    ess = effective_sample_size(lw)
    resampled = prop[systematic_resample_from_u0(lw, u0)]
    do_res = ess < 0.5 * n
    particles_new = torch.where(do_res, resampled, prop)
    lw_new = torch.where(do_res, torch.zeros_like(lw), lw)
    w, _ = normalize_log_weights(lw_new)
    mean = torch.sum(w * particles_new)
    var = torch.sum(w * (particles_new - mean) ** 2)
    return particles_new, lw_new, mean, var, ess


class ParticleFilter:
    """1-D bootstrap particle filter on a Gaussian random-walk state-space
    model: x_t = x_{t-1} + N(0, q²); y_t ~ N(x_t, r²), q = ``process_sd``,
    r = ``obs_sd``.

    ``seed`` seeds a ``torch.Generator`` on ``device`` for the initial
    particles and every step's draws. Each ``observe`` runs ``pf_step`` on
    the particle vector and reads (mean, var, ess) back once."""

    def __init__(self, seed: int, n_particles: int = 512, process_sd: float = 0.3,
                 obs_sd: float = 0.5, init_sd: float = 1.0, *, device="cuda"):
        self.n = n_particles
        self.process_sd = process_sd
        self.obs_sd = obs_sd
        dt, dev = settings.real_dtype(), torch.device(device)
        self._generator = torch.Generator(device=dev).manual_seed(int(seed))
        self.particles = init_sd * torch.randn(n_particles, generator=self._generator,
                                               device=dev, dtype=dt)
        self.log_weights = torch.zeros((n_particles,), dtype=dt, device=dev)
        self.estimates: List[Dict[str, float]] = []

    def observe(self, y: float) -> Dict[str, float]:
        p = self.particles
        noise = torch.randn(p.shape, generator=self._generator, device=p.device, dtype=p.dtype)
        u0 = torch.rand((), generator=self._generator, device=p.device, dtype=p.dtype)
        self.particles, self.log_weights, mean, var, ess = pf_step(
            p, self.log_weights, float(y), noise, u0, self.process_sd, self.obs_sd)
        profiling.host_read("particle_filter.observe")
        m, v, e = torch.stack([mean, var, ess]).tolist()  # the one host read
        est = {"mean": m, "var": v, "ess": e}
        self.estimates.append(est)
        return est


def smc_run(
    seed: int,
    model_fn: Optional[Callable] = None,
    n_particles: int = 512,
    config: SMCConfig = SMCConfig(),
    *,
    device="cuda",
    **kw,
) -> Dict[str, Any]:
    """One-shot ``adaptive_smc`` returning a JSON-able summary. ``device``
    is used only when ``staged`` is not given."""
    res = adaptive_smc(seed, n_particles, model_fn, config, device=device, **kw)
    out: Dict[str, Any] = {
        "log_evidence": res.log_evidence,
        "n_stages": res.n_stages,
        "ess": res.ess,
        "posterior_means": {},
        "posterior_vars": {},
    }
    profiling.host_read("smc_run.posterior", 2 * len(res.particles))
    for a in res.particles:
        out["posterior_means"][a] = res.posterior_mean(a).cpu().numpy().tolist()
        out["posterior_vars"][a] = res.posterior_var(a).cpu().numpy().tolist()
    return out


def _value(v, device):
    """A pinned latent value as a tensor on ``device`` (``as_data``'s
    dtypes for numbers and arrays)."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return as_data(np.asarray(v), device)


def log_joint_grid(
    model_fn: Optional[Callable],
    x_address: str,
    y_address: str,
    x_range,
    y_range,
    resolution: int = 64,
    *,
    staged: Optional[StagedModel] = None,
    fixed: Optional[Dict[str, Any]] = None,
    model_args: tuple = (),
    device="cuda",
) -> Dict[str, Any]:
    """2-D log-joint heatmap with two scalar sites swept and the rest pinned:
    at the prior draw of seed 0, overridden by ``fixed``. The resolution²
    evaluations are one ``torch.func.vmap`` of ``staged.log_joint`` (one
    batched model run). ``device`` is used only when ``staged`` is not
    given."""
    if staged is None:
        staged = stage(model_fn, *model_args, device=device)
    dt, dev = settings.real_dtype(), staged.device
    base = dict(staged.sample_prior(0))
    if fixed:
        base.update({str(a): _value(v, dev) for a, v in fixed.items()})
    xs = torch.linspace(x_range[0], x_range[1], resolution, dtype=dt, device=dev)
    ys = torch.linspace(y_range[0], y_range[1], resolution, dtype=dt, device=dev)

    def at(xv, yv):
        latents = dict(base)
        latents[str(x_address)] = xv
        latents[str(y_address)] = yv
        return staged.log_joint(latents)

    z = vmap(lambda yv: vmap(lambda xv: at(xv, yv))(xs))(ys)
    profiling.host_read("log_joint_grid", 3)
    return {
        "x": xs.cpu().numpy(),
        "y": ys.cpu().numpy(),
        "log_joint": z.cpu().numpy(),  # (resolution_y, resolution_x)
    }
