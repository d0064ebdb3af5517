"""Hamiltonian Monte Carlo over staged models, batched over chains.

The port of the single-device HMC path of ``fugue_tpu/inference/hmc.py``:
``HMCConfig``, dual averaging, Welford diagonal and dense mass, the mass
algebra, ``leapfrog`` and ``leapfrog_recorded``, ``hmc_transition``,
``find_reasonable_epsilon``, ``make_hmc_drive``, ``hmc_chain`` (fresh,
``init_position`` and ``resume`` modes) and ``HmcSession``.

How it is expressed in PyTorch:

- Positions are a (C, d) tensor. Forces for all chains come from ONE call
  of ``batched_force(potential)`` = ``vmap(grad_and_value(potential))``,
  which runs the per-chain Python model once for the whole batch and gives
  the potential with the gradient, so a transition costs exactly L+1
  batched evaluations. Each call is a ``potential`` span and each drive
  step an ``hmc.transition`` span (``utils.profiling``, recorded while a
  profiler session runs); every read back to the host names its site
  (``profiling.host_read``).
- Noise is drawn outside the deterministic step: ``hmc_transition`` takes
  the momenta ``p`` and the log-uniforms ``log_u`` as arguments, and the
  drive draws them from an explicit ``torch.Generator`` on the device.
- On a CUDA device ``make_hmc_drive`` replays that step, the staged
  potential's L+1 gradients with the leapfrogs and the accept test, as one
  CUDA graph per staged model and shape (``TransitionGraphs``; counts
  ``hmc.graph_replay``, ``hmc.graph_capture``, ``hmc.graph_fallback``).
  A replay opens no ``potential`` span; the cache's ``replayed`` counts
  the gradients and kernel launches its replays ran.
- The leapfrog loop and the per-transition adaptation read nothing back to
  the host: step sizes, acceptance statistics and moments stay on the
  device, and host-side counters (dual-averaging step, Welford count) are
  Python floats. ``find_reasonable_epsilon`` is a host loop that runs once
  per run.
- Non-finite energies are masked (divergent, always rejected), which keeps
  float32 runs on the card from propagating a huge-but-finite proposal.
- ``inv_mass`` is a (d,) vector (diagonal) or a (d, d) covariance Σ
  (dense). On batched (C, d) momenta the dense velocity is ``p @ Σ`` (Σ is
  symmetric), and momenta are drawn through the Cholesky factor of Σ.

``make_hmc_drive(chain_group=...)`` is the sharded drive: every rank runs
it on its slice of the chains, and the adaptation's statistics (the
acceptance mean, the initial step size's consensus, the Welford moments at
the midpoint) reduce over the process group, so every rank adapts the same
kernel (``parallel/``).
"""

from __future__ import annotations

import collections
import contextlib
import math
import threading
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch.func import grad_and_value, vmap

from .. import settings
from ..ops import kernels
from ..parallel.mesh import cross_mean, cross_sum
from ..runtime.staging import StagedModel, stage
from ..utils import profiling


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HMCConfig:
    step_size: Optional[float] = None  # None → reasonable-epsilon search
    n_leapfrog: int = 32
    target_accept: float = 0.8
    adapt_step_size: bool = True
    adapt_mass: bool = True
    max_delta_energy: float = 1000.0  # divergence threshold
    # per-transition step-size jitter eps·U(1-jitter, 1): breaks the periodic
    # resonance of fixed-length trajectories on near-Gaussian targets
    jitter: float = 0.2
    # "uniform": z0 ~ U(-2, 2)^d in unconstrained space; "prior":
    # unconstrained prior draw
    init: str = "uniform"
    # "diag": diagonal mass from cross-chain variances; "dense": full
    # covariance mass (Cholesky-based kinetic energy)
    mass: str = "diag"

    def __post_init__(self):
        if self.mass not in ("diag", "dense"):
            raise ValueError(f"unknown mass {self.mass!r}; use 'diag' or 'dense'")


# ---------------------------------------------------------------------------
# Dual averaging (Hoffman & Gelman Alg 5)
# ---------------------------------------------------------------------------


@dataclass
class DualAveragingState:
    log_eps: Any  # 0-dim tensors on the device
    log_eps_bar: Any
    h_bar: Any
    mu: Any
    t: Any  # adaptation step counter: a host float, or 0-dim on the device (fractional)

    @staticmethod
    def init(eps0: torch.Tensor) -> "DualAveragingState":
        return DualAveragingState(
            log_eps=torch.log(eps0),
            log_eps_bar=torch.zeros_like(eps0),
            h_bar=torch.zeros_like(eps0),
            mu=torch.log(10.0 * eps0),
            t=0.0,
        )


def dual_averaging_update(
    state: DualAveragingState,
    accept_prob,
    target: float = 0.8,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> DualAveragingState:
    """One Nesterov dual-averaging step; ``accept_prob`` is the cross-chain
    mean acceptance statistic."""
    m = state.t + 1.0
    eta_h = 1.0 / (m + t0)
    h_bar = (1.0 - eta_h) * state.h_bar + eta_h * (target - accept_prob)
    log_eps = state.mu - math.sqrt(m) / gamma * h_bar
    eta = m ** (-kappa)
    log_eps_bar = eta * log_eps + (1.0 - eta) * state.log_eps_bar
    return DualAveragingState(
        log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar, mu=state.mu, t=m
    )


# ---------------------------------------------------------------------------
# Welford moments for mass adaptation
# ---------------------------------------------------------------------------


@dataclass
class WelfordState:
    count: Any  # a host float (batch sizes known there), or 0-dim on the device (masked)
    mean: Any  # (d,)
    m2: Any  # (d,) elementwise squares, or (d, d) outer products (dense)

    @staticmethod
    def init(dim: int, dense: bool = False, *, dtype, device,
             chains: Optional[int] = None) -> "WelfordState":
        """Moments pooled over chains, or with ``chains`` one set per chain
        (a leading (chains,) dim)."""
        lead = () if chains is None else (chains,)
        return WelfordState(
            count=0.0,
            mean=torch.zeros(lead + (dim,), dtype=dtype, device=device),
            m2=torch.zeros(lead + ((dim, dim) if dense else (dim,)), dtype=dtype,
                           device=device),
        )


def welford_push_batch(state: WelfordState, batch) -> WelfordState:
    """Fold a (n_chains, d) batch of positions into the moments (Chan
    parallel update); per-chain moments take a (chains, 1, d) batch."""
    n_b = float(batch.shape[-2])
    mean_b = torch.mean(batch, dim=-2)
    centered = batch - mean_b.unsqueeze(-2)
    n_new = state.count + n_b
    delta = mean_b - state.mean
    mean_new = state.mean + delta * (n_b / n_new)
    w = state.count * n_b / n_new
    if state.m2.dim() > state.mean.dim():
        m2_new = (state.m2 + centered.mT @ centered
                  + w * (delta.unsqueeze(-1) * delta.unsqueeze(-2)))
    else:
        m2_new = state.m2 + torch.sum(centered**2, dim=-2) + w * delta**2
    return WelfordState(count=n_new, mean=mean_new, m2=m2_new)


def welford_push_masked(state: WelfordState, batch, mask) -> WelfordState:
    """``welford_push_batch`` of the (C, d) rows of ``batch`` where the (C,)
    ``mask`` is True: the asynchronous NUTS drive pushes the chains that
    finished a transition in an iteration. The count becomes a 0-dim
    tensor on the device (no host read); an all-false mask leaves the
    state as it was."""
    w = mask.to(state.mean.dtype)
    n_b = torch.sum(w)
    mean_b = torch.sum(batch * w[:, None], dim=0) / torch.clamp(n_b, min=1.0)
    centered = (batch - mean_b) * w[:, None]
    n_new = state.count + n_b
    delta = mean_b - state.mean
    safe_new = torch.clamp(n_new, min=1.0)
    mean_new = state.mean + delta * (n_b / safe_new)
    wgt = state.count * n_b / safe_new
    if state.m2.dim() == 2:
        m2_new = state.m2 + centered.T @ centered + wgt * torch.outer(delta, delta)
    else:
        m2_new = state.m2 + torch.sum(centered**2, dim=0) + wgt * delta**2
    empty = n_b == 0
    return WelfordState(count=torch.where(empty, state.count, n_new),
                        mean=torch.where(empty, state.mean, mean_new),
                        m2=torch.where(empty, state.m2, m2_new))


def _at_least(x, lo: float):
    """max(x, lo) for a host float, or on the device for a tensor."""
    return torch.clamp(x, min=lo) if isinstance(x, torch.Tensor) else max(x, lo)


def welford_merge_across(state: WelfordState, group) -> WelfordState:
    """Merge the ranks' Welford moments over a process group (the Chan
    parallel combine as sums): every rank gets the moments of all chains.
    A host count (every rank pushed the same batches) is the local count
    times the group size; a device count (``welford_push_masked``) is summed
    with the means, in the same all-reduce."""
    if group is None:
        return state
    if isinstance(state.count, torch.Tensor):
        packed = cross_sum(torch.cat([state.count.reshape(1), state.count * state.mean]), group)
        total, mean_g = packed[0], packed[1:] / torch.clamp(packed[0], min=1.0)
    else:
        total = state.count * torch.distributed.get_world_size(group)
        mean_g = cross_sum(state.count * state.mean, group) / max(total, 1.0)
    delta = state.mean - mean_g
    if state.m2.dim() > state.mean.dim():
        corr = state.count * (delta.unsqueeze(-1) * delta.unsqueeze(-2))
    else:
        corr = state.count * delta**2
    return WelfordState(count=total, mean=mean_g, m2=cross_sum(state.m2 + corr, group))


def welford_variance(state: WelfordState, regularize: bool = True):
    var = state.m2 / _at_least(state.count - 1.0, 1.0)
    if regularize:  # Stan-style shrinkage toward unit for small counts
        n = state.count
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return torch.clamp(var, min=1e-10)


def welford_covariance(state: WelfordState, regularize: bool = True):
    """Dense covariance estimate with Stan-style shrinkage toward a scaled
    identity (keeps the mass matrix positive definite at small counts)."""
    cov = state.m2 / _at_least(state.count - 1.0, 1.0)
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    if regularize:
        n = state.count
        cov = (n / (n + 5.0)) * cov + 1e-3 * (5.0 / (n + 5.0)) * eye
    return cov + 1e-8 * eye


# ---------------------------------------------------------------------------
# Mass algebra: ``inv_mass`` is a (d,) vector (diagonal) or a (d, d)
# covariance estimate Σ (dense), shared by the chains, or (C, d, d), one Σ
# per chain of (C, d) momenta. Velocity = Σp, kinetic = ½ pᵀΣp, momentum
# ~ N(0, Σ⁻¹) drawn through the Cholesky factor of Σ.
# ---------------------------------------------------------------------------


def mass_velocity(inv_mass, p):
    """Σp for momenta ``p`` of shape (..., d), or (C, d) with one Σ per chain."""
    if inv_mass.dim() == 1:
        return inv_mass * p
    if inv_mass.dim() == 3:
        return (p.unsqueeze(-2) @ inv_mass).squeeze(-2)
    return p @ inv_mass  # (Σp)ᵀ = pᵀΣ: Σ is symmetric


def mass_kinetic(inv_mass, p):
    """½ pᵀ M⁻¹ p over the last dim."""
    return 0.5 * torch.sum(p * mass_velocity(inv_mass, p), dim=-1)


@dataclass
class MassFactor:
    """What a momentum draw needs of a mass, computed once per mass:
    sqrt(inv_mass) (diagonal), or the Cholesky factor L of Σ = L Lᵀ with
    ``ok`` (``cholesky_ex`` found Σ positive definite; (C,) for one Σ per
    chain)."""

    root: Any  # (d,) sqrt of the diagonal, or L: (d, d) or (C, d, d)
    ok: Any = None  # None (diagonal), or 0-dim / (C,) bool


def mass_factor(inv_mass) -> MassFactor:
    if inv_mass.dim() == 1:
        return MassFactor(torch.sqrt(inv_mass))
    chol, info = torch.linalg.cholesky_ex(inv_mass)
    return MassFactor(chol, info == 0)


def momentum_from_factor(factor: MassFactor, z):
    """Standard normal draws ``z`` (..., d) → momenta p ~ N(0, M):
    z / sqrt(inv_mass) for a diagonal mass; for a dense Σ = L Lᵀ, p = L⁻ᵀ z,
    the solution of p L = z row by row. A Σ that is not positive definite
    gives NaN momenta, as the JAX package's Cholesky does, so the
    transition is divergent and rejected; ``cholesky_ex``'s error code
    selects them on the device, with no host read."""
    if factor.ok is None:
        return z / factor.root
    chol = factor.root
    if chol.dim() == 3:  # one Σ per chain of (C, d) draws
        p = torch.linalg.solve_triangular(chol, z.unsqueeze(-2), upper=False, left=False)
        return torch.where(factor.ok[:, None], p.squeeze(-2), torch.nan)
    d = chol.shape[0]
    p = torch.linalg.solve_triangular(chol, z.reshape(-1, d), upper=False, left=False)
    return torch.where(factor.ok, p, torch.nan).reshape(z.shape)


def momentum_from_normal(inv_mass, z):
    """``momentum_from_factor`` with the mass factored on this call; a drive
    that draws momenta every iteration factors once (``mass_factor``)."""
    return momentum_from_factor(mass_factor(inv_mass), z)


def mass_draw_momentum(generator: torch.Generator, inv_mass, shape):
    """p ~ N(0, M) of ``shape`` (..., d)."""
    z = torch.randn(shape, generator=generator, device=inv_mass.device,
                    dtype=inv_mass.dtype)
    return momentum_from_normal(inv_mass, z)


def identity_mass(d: int, dense: bool, *, dtype, device, chains: Optional[int] = None):
    """The unit mass: eye(d) (dense) or ones(d) (diagonal); with ``chains``,
    one eye(d) per chain."""
    if chains is not None:
        return torch.eye(d, dtype=dtype, device=device).expand(chains, d, d).clone()
    if dense:
        return torch.eye(d, dtype=dtype, device=device)
    return torch.ones((d,), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Leapfrog and one transition, batched over chains
# ---------------------------------------------------------------------------


def batched_force(potential_fn: Callable) -> Callable:
    """(C, d) positions → (∇U (C, d), U (C,)) in one batched model run, a
    ``potential`` span."""
    force = vmap(grad_and_value(potential_fn))

    def potential_span(q):
        with profiling.span("potential"):
            return force(q)

    return potential_span


def _per_chain(eps):
    """A (C,) step size broadcast against (C, d); a scalar stays as it is."""
    if isinstance(eps, torch.Tensor) and eps.dim() == 1:
        return eps[:, None]
    return eps


def leapfrog(force_fn, q, p, eps, n_steps: int, inv_mass, g=None):
    """``n_steps`` >= 1 leapfrog steps with force reuse: ``n_steps`` force
    evaluations after the initial one (skipped when ``g`` is given).

    ``force_fn`` maps (C, d) → (grad, potential). Returns
    ``(q, p, grad, potential)`` at the end of the trajectory."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    e = _per_chain(eps)
    if g is None:
        g, _ = force_fn(q)
    for _ in range(n_steps):
        p_half = p - 0.5 * e * g
        q = q + e * mass_velocity(inv_mass, p_half)
        g, u = force_fn(q)
        p = p_half - 0.5 * e * g
    return q, p, g, u


def leapfrog_recorded(force_fn, q, p, eps, n_steps: int, inv_mass, g=None):
    """``leapfrog`` that also records the trajectory: returns ``(q, p, qs,
    hs)`` with the positions ``qs`` (n_steps, C, d) and Hamiltonians ``hs``
    (n_steps, C) after each step. The potential of each H comes with its
    gradient from the same batched evaluation."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    e = _per_chain(eps)
    if g is None:
        g, _ = force_fn(q)
    qs, hs = [], []
    for _ in range(n_steps):
        p_half = p - 0.5 * e * g
        q = q + e * mass_velocity(inv_mass, p_half)
        g, u = force_fn(q)
        p = p_half - 0.5 * e * g
        qs.append(q)
        hs.append(u + mass_kinetic(inv_mass, p))
    return q, p, torch.stack(qs), torch.stack(hs)


@dataclass
class HmcStepInfo:
    """Per-transition metadata, each (C,)."""

    accept_prob: Any
    accepted: Any
    divergent: Any
    energy: Any
    potential: Any  # U at the returned positions


def hmc_transition(
    potential_fn: Callable,
    q,
    p,
    log_u,
    eps,
    n_leapfrog: int,
    inv_mass,
    max_delta_energy: float = 1000.0,
    force_fn: Optional[Callable] = None,
):
    """One HMC proposal + MH correction for a batch of chains.

    ``q``, ``p``: (C, d) positions and momenta; ``log_u``: (C,) log-uniforms
    for the accept test; ``eps``: (C,) step sizes (after jitter) or a
    scalar. Divergences (non-finite energy or |ΔH| > threshold) are always
    rejected. ``force_fn`` ((C, d) → (∇U, U)) replaces
    ``batched_force(potential_fn)`` where each chain's potential takes
    arguments of its own (Gibbs's discrete values, tempering's β). Returns
    ``(q_out, HmcStepInfo)``.
    """
    if force_fn is None:
        force_fn = batched_force(potential_fn)
    g0, u0 = force_fn(q)
    h0 = u0 + mass_kinetic(inv_mass, p)
    q_new, p_new, _, u1 = leapfrog(force_fn, q, p, eps, n_leapfrog, inv_mass, g0)
    h1 = u1 + mass_kinetic(inv_mass, p_new)
    delta = h0 - h1
    finite = torch.isfinite(delta) & torch.isfinite(u1)
    divergent = (~finite) | (-delta > max_delta_energy)
    accept_prob = torch.where(
        divergent,
        torch.zeros_like(delta),
        torch.clamp(torch.exp(torch.clamp(delta, max=50.0)), max=1.0),
    )
    accepted = (~divergent) & (log_u < delta)
    q_out = torch.where(accepted[:, None], q_new, q)
    info = HmcStepInfo(
        accept_prob=accept_prob,
        accepted=accepted,
        divergent=divergent,
        energy=torch.where(accepted, h1, h0),
        potential=torch.where(accepted, u1, u0),
    )
    return q_out, info


# ---------------------------------------------------------------------------
# One transition as a CUDA graph
# ---------------------------------------------------------------------------

# Captured transitions kept per staged model; the least recently used goes.
GRAPHS_PER_MODEL = 4


def graph_engages(q, force_fn, discrete) -> bool:
    """Whether ``make_hmc_drive`` replays its transitions from a CUDA graph:
    the positions are on a CUDA device and the force is the staged
    potential's own. A ``force_fn`` or an explicit ``discrete`` may close
    over tensors of one call (Gibbs's values, tempering's β, SBC's data),
    whose addresses a replay in a later call would read stale."""
    return q.is_cuda and force_fn is None and discrete is None


def graph_key(q, eps, inv_mass, n_leapfrog: int, max_delta_energy: float) -> tuple:
    """What a captured transition is specific to, all of it seen in the
    drive's inputs: device, dtype, (n_chains, d), L, the shapes of ε and of
    the mass (diagonal, dense, per chain), and the divergence threshold."""
    return (q.device, q.dtype, tuple(q.shape), int(n_leapfrog), tuple(eps.shape),
            tuple(inv_mass.shape), float(max_delta_energy))


class _Captured(NamedTuple):
    graph: Any  # torch.cuda.CUDAGraph
    inputs: tuple  # (q, p, log_u, eps, inv_mass), copied into before each replay
    outputs: tuple  # (q_out, HmcStepInfo), rewritten by each replay
    counts: collections.Counter  # what the capture counted (``CaptureCounts``)


class GraphCache:
    """A staged model's captured graphs by key, at most
    ``GRAPHS_PER_MODEL``, the least recently used evicted first. A capture
    that raises sets ``failed``, and the model's drives stay eager from then
    on. One drive at a time holds ``lock`` (``claimed``). ``replayed``
    counts what the replays ran, which no Python code counts on a replay:
    the potential's batched runs (``gradients``) and the kernel launches
    (``kernels.LAUNCHES``'s keys), each replay adding what its capture
    counted (``tally``)."""

    def __init__(self):
        self.entries = collections.OrderedDict()
        self.failed = False
        self.lock = threading.Lock()
        self.replayed = collections.Counter()

    def get(self, key):
        entry = self.entries.get(key)
        if entry is not None:
            self.entries.move_to_end(key)
        return entry

    def put(self, key, entry) -> None:
        self.entries[key] = entry
        self.entries.move_to_end(key)
        while len(self.entries) > GRAPHS_PER_MODEL:
            self.entries.popitem(last=False)

    def tally(self, counts, times: int = 1) -> None:
        for name, n in counts.items():
            self.replayed[name] += times * n


class CaptureCounts:
    """The potential's batched runs (``gradients``: ``potential`` is
    ``potential_fn`` counting its calls) and the kernel launches
    (``kernels.LAUNCHES``) made in each capture through ``record``, one
    Counter of the non-zero counts per capture in ``each``."""

    def __init__(self, potential_fn: Callable):
        self.runs = 0
        self.each = []

        def potential(z):
            self.runs += 1
            return potential_fn(z)

        self.potential = potential

    def _now(self) -> collections.Counter:
        return collections.Counter(gradients=self.runs, **kernels.LAUNCHES)

    def record(self, record: Callable, fn: Callable):
        """``record(fn)``, with what it counted appended to ``each``."""
        before = self._now()
        out = record(fn)
        self.each.append(self._now() - before)
        return out


class TransitionGraphs(GraphCache):
    """A staged model's captured ``hmc_transition`` (its own batched force)
    by ``graph_key``, in a ``GraphCache``.

    A replay runs what the capture recorded: the potential has to be a
    function of z and of the tensors the model holds, whose contents (not
    whose Python objects) may change between calls."""

    def transition(self, potential_fn, q, p, log_u, eps, n_leapfrog: int, inv_mass,
                   max_delta_energy: float):
        """``hmc_transition(potential_fn, ...)``, replayed from the graph of
        these inputs' key; the first call for a key runs eagerly, then
        captures. A replay's outputs are the graph's own tensors, which the
        next replay rewrites."""
        args = (q, p, log_u, eps, inv_mass)
        key = graph_key(q, eps, inv_mass, n_leapfrog, max_delta_energy)
        entry = self.get(key)
        if entry is None:
            return self._first(key, potential_fn, args, n_leapfrog, max_delta_energy)
        for buf, x in zip(entry.inputs, args):
            buf.copy_(x)
        entry.graph.replay()
        self.tally(entry.counts)
        profiling.count("hmc.graph_replay")
        return entry.outputs

    def _first(self, key, potential_fn, args, n_leapfrog, max_delta_energy):
        """The eager transition, on a side stream (the warm-up that capture
        wants), then the capture of the same call on static inputs."""

        def run(potential, q, p, log_u, eps, inv_mass):
            return hmc_transition(potential, q, p, log_u, eps, n_leapfrog, inv_mass,
                                  max_delta_energy)

        dev = args[0].device
        (q_out, info), side = on_side_stream(lambda: run(potential_fn, *args), dev)
        for t in (q_out, *vars(info).values()):
            t.record_stream(torch.cuda.current_stream(dev))
        inputs = tuple(torch.empty(x.shape, dtype=x.dtype, device=dev) for x in args)
        counts = CaptureCounts(potential_fn)
        try:
            graph, outputs = counts.record(cuda_recorder(side),
                                           lambda: run(counts.potential, *inputs))
        except RuntimeError:  # e.g. a host read or a pageable upload in the potential
            self.failed = True
            profiling.count("hmc.graph_fallback")
        else:
            self.put(key, _Captured(graph, inputs, outputs, counts.each[0]))
            profiling.count("hmc.graph_capture")
        return q_out, info


def on_side_stream(fn, device):
    """``fn()`` on a new side stream, after the current stream's work and
    joined back into it: (its output, the side stream). The warm-up run
    that capture wants, off the default stream; the caller records the
    output's tensors on the current stream."""
    current, side = torch.cuda.current_stream(device), torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = fn()
    current.wait_stream(side)
    return out, side


def cuda_recorder(stream):
    """``record(fn) → (graph, fn())``: ``fn`` captured on ``stream`` into a
    new CUDA graph; an operation that capture refuses raises in this
    thread."""

    def record(fn):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                graph.capture_end()
        return graph, out

    return record


def transition_graphs(staged: StagedModel) -> TransitionGraphs:
    """The staged model's ``TransitionGraphs``, made on first use."""
    return staged.__dict__.setdefault("hmc_transition_graphs", TransitionGraphs())


@contextlib.contextmanager
def claimed(graphs: Optional[GraphCache]):
    """``graphs`` for the block, or None where there are none, a capture
    failed, or another drive holds them (that drive's replays would rewrite
    the outputs this one reads)."""
    if graphs is None or graphs.failed or not graphs.lock.acquire(blocking=False):
        yield None
        return
    try:
        yield graphs
    finally:
        graphs.lock.release()


# ---------------------------------------------------------------------------
# Reasonable epsilon (Hoffman & Gelman Alg 4)
# ---------------------------------------------------------------------------


def find_reasonable_epsilon(potential_fn, q, p, inv_mass, max_iters: int = 60,
                            n_steps: int = 1):
    """Double/halve eps until the acceptance of an ``n_steps`` trajectory
    from one chain's ``q`` (d,) with momentum ``p`` (d,) crosses 0.5.
    ``n_steps=1`` is Hoffman-Gelman Alg 4 (used with dual averaging); a
    session without adaptation passes its real trajectory length.

    A host loop (the JAX package's ``while_loop``): it reads one acceptance
    per iteration back from the device, once per run. Returns a 0-dim
    tensor on ``q``'s device."""
    force_fn = batched_force(potential_fn)
    q1, p1 = q[None], p[None]
    g0, u0 = force_fn(q1)
    profiling.host_read("find_reasonable_epsilon.h0")
    h0 = float(u0[0] + mass_kinetic(inv_mass, p1)[0])

    def log_accept(eps):
        qe, pe, _, ue = leapfrog(force_fn, q1, p1, eps, n_steps, inv_mass, g0)
        profiling.host_read("find_reasonable_epsilon.h")
        la = h0 - float(ue[0] + mass_kinetic(inv_mass, pe)[0])
        return la if math.isfinite(la) else -math.inf

    log_half = math.log(0.5)
    eps = 1.0
    la = log_accept(eps)
    direction = 1 if la > log_half else -1
    it = 0
    while (
        ((la > log_half) if direction > 0 else (la < log_half))
        and it < max_iters and 1e-10 < eps < 1e7
    ):
        eps *= 2.0 if direction > 0 else 0.5
        la = log_accept(eps)
        it += 1
    # doubling exits one step PAST the crossing; step back to the stable side
    if direction > 0:
        eps *= 0.5
    eps = min(max(eps, 1e-8), 1e6)
    return torch.tensor(eps, dtype=q.dtype, device=q.device)


def find_reasonable_epsilon_per_chain(force_fn, q, p, inv_mass, max_iters: int = 60):
    """``find_reasonable_epsilon`` for every chain of ``q`` (C, d) at once,
    each chain under its own potential (``force_fn``) and mass: each doubles
    or halves its own ε until its one-step acceptance crosses 0.5, in
    lock-step (one host read per round). Returns (C,) step sizes."""
    g0, u0 = force_fn(q)
    h0 = u0 + mass_kinetic(inv_mass, p)

    def log_accept(eps):
        _, p1, _, u1 = leapfrog(force_fn, q, p, eps, 1, inv_mass, g0)
        la = h0 - (u1 + mass_kinetic(inv_mass, p1))
        return torch.where(torch.isfinite(la), la, -math.inf)

    log_half = math.log(0.5)
    eps = torch.ones_like(u0)
    la = log_accept(eps)
    up = la > log_half
    for _ in range(max_iters):
        moving = torch.where(up, la > log_half, la < log_half) & (eps > 1e-10) & (eps < 1e7)
        profiling.host_read("find_reasonable_epsilon_per_chain.any_moving")
        if not bool(torch.any(moving)):
            break
        eps = torch.where(moving, torch.where(up, 2.0 * eps, 0.5 * eps), eps)
        la = torch.where(moving, log_accept(eps), la)
    # doubling exits one step past the crossing: step back
    eps = torch.where(up, 0.5 * eps, eps)
    return torch.clamp(eps, 1e-8, 1e6)


# ---------------------------------------------------------------------------
# Initial positions
# ---------------------------------------------------------------------------


def initial_positions(staged: StagedModel, generator: torch.Generator,
                      n_chains: int, init: str):
    """Batch of unconstrained starting positions on ``staged.device``."""
    dt = settings.real_dtype()
    if init == "uniform":
        u = torch.rand((n_chains, staged.dim), generator=generator,
                       device=staged.device, dtype=dt)
        return 4.0 * u - 2.0
    if init != "prior":
        raise ValueError(f"unknown init {init!r}; use 'uniform' or 'prior'")
    # one prior run per chain, once per run: draws need per-chain seeds
    profiling.host_read("initial_positions.seeds")
    seeds = torch.randint(0, 2**62, (n_chains,), generator=generator,
                          device=staged.device).tolist()
    return torch.stack([staged.initial_position(s) for s in seeds]).to(dt)


def prior_positions(staged: StagedModel, seed: int, n: int):
    """``n`` prior draws in ONE batched model run, mapped to the
    unconstrained space in one more: ((n, d) positions, the latents, each
    with a leading (n,) dim)."""
    latents = staged.sample_prior_batch(seed, n)
    z = vmap(lambda lat: staged.unconstrain(lat))(latents)
    return z.to(settings.real_dtype()), latents


def _warm_start_batch(staged, generator, n_chains, init_position, init_jitter):
    """(d,) point → jittered (n_chains, d) batch; (n_chains, d) → as-is."""
    dt = settings.real_dtype()
    q = torch.as_tensor(init_position).to(device=staged.device, dtype=dt)
    if q.dim() == 1:
        if q.shape[0] != staged.dim:
            raise ValueError(f"init_position dim {q.shape[0]} != {staged.dim}")
        noise = torch.randn((n_chains, staged.dim), generator=generator,
                            device=staged.device, dtype=dt)
        return q[None, :] + init_jitter * noise
    if tuple(q.shape) != (n_chains, staged.dim):
        raise ValueError(
            f"init_position {tuple(q.shape)} != (n_chains={n_chains}, d={staged.dim})"
        )
    return q


def constrain_positions(staged: StagedModel, positions):
    """(chains, samples, d) unconstrained → per-site constrained tensors of
    shape (chains, samples, *site_shape), in batched model runs of
    ``chains`` draws each: the drive's own batch, so memory stays what the
    drive needed. (The replay computes the whole model, likelihood
    included: one run over 256 × 256 draws of the d = 1024, N = 100,000
    logistic model would hold 256 · 256 · 100,000 float32 logits, 26 GB.
    The JAX package's compiled replay drops that unused work.)"""
    c, s, d = positions.shape
    out = vmap(lambda z: staged.constrain(z)[0], chunk_size=c)(positions.reshape(c * s, d))
    return {a: v.reshape(c, s, *v.shape[1:]) for a, v in out.items()}


# ---------------------------------------------------------------------------
# The warmup + sampling drive
# ---------------------------------------------------------------------------


def rescue_stuck(q, ema, generator: torch.Generator):
    """Warmup-only cross-chain rescue: a chain whose acceptance EMA
    collapsed (below 0.1) copies the position of a donor chain drawn with
    probability ∝ its EMA."""
    n_chains = q.shape[0]
    donors = torch.multinomial(ema + 1e-6, n_chains, replacement=True, generator=generator)
    return torch.where((ema < 0.1)[:, None], q[donors], q)


def initial_step_size(config, potential, q0, generator, inv_mass, eps_over=None,
                      chain_group=None):
    """The run's first step size: ``eps_over`` (a resumed run's), else the
    configured one, else the reasonable-epsilon search from chain 0. With a
    ``chain_group`` each rank searches from its own chain 0 and the ranks
    agree on exp(mean log ε₀)."""
    dt, dev = q0.dtype, q0.device
    if eps_over is not None:
        return torch.as_tensor(eps_over, dtype=dt, device=dev).reshape(())
    if config.step_size is not None:
        return torch.tensor(config.step_size, dtype=dt, device=dev)
    p = mass_draw_momentum(generator, inv_mass, (q0.shape[1],))
    return eps_consensus(find_reasonable_epsilon(potential, q0[0], p, inv_mass), chain_group)


def eps_consensus(eps0, chain_group):
    """The ranks' common initial step size exp(mean log ε₀); ``eps0``
    itself without a group."""
    if chain_group is None:
        return eps0
    return torch.exp(cross_mean(torch.log(eps0), chain_group))


def make_hmc_drive(
    staged: StagedModel,
    config: HMCConfig,
    n_chains: int,
    n_samples: int,
    n_warmup: int,
    *,
    discrete: Optional[Dict[str, Any]] = None,
    force_fn: Optional[Callable] = None,
    per_chain: bool = False,
    chain_group=None,
):
    """Build ``drive(q0, generator, eps_over=None, inv_mass_over=None) →
    (q_f, qs, ljs, aps, divs, eps, inv_mass)``; discrete sites are held at
    ``discrete`` (default: their discovery values). ``force_fn`` ((C, d) →
    (∇U, U)) replaces the staged potential's batched force where each chain
    has a potential of its own.

    ``per_chain``: every chain adapts on its own, as a one-chain run would
    (SBC runs its datasets so): its own reasonable-ε search, dual averaging
    on its own acceptance and its own Welford mass, kept as one (d, d)
    matrix per chain (diagonal unless ``config.mass`` is dense); ``eps`` is
    then (C,) and ``inv_mass`` (C, d, d). A one-chain run's rescue copies
    the chain onto itself, so there is none.

    Warmup: two windows of dual averaging on the cross-chain mean
    acceptance; at the midpoint the mass becomes the regularized Welford
    variance (diagonal) or covariance (dense) of the first window and the
    step size restarts from its averaged value. After each window, chains
    whose acceptance EMA collapsed copy a donor chain (``rescue_stuck``).
    Sampling then runs at the averaged step size. ``qs`` is (n_samples, C,
    d); ``ljs``, ``aps`` and ``divs`` are (n_samples, C). ``eps_over`` and
    ``inv_mass_over`` replace the initial step size and mass (resume).

    Where ``graph_engages`` (CUDA positions, the staged potential's own
    force), a transition after the noise is a replay of one CUDA graph,
    captured once per staged model and ``graph_key`` and kept on the model
    (``transition_graphs``) for later drives and calls: the same kernels on
    the same inputs. The noise, the adaptation and the rescue stay eager.
    """
    d = staged.dim
    L = config.n_leapfrog
    dense = config.mass == "dense"

    def potential(z):
        return staged.potential(z, discrete)

    force = force_fn if force_fn is not None else batched_force(potential)
    if per_chain and chain_group is not None:
        raise ValueError("per_chain adaptation has no cross-rank statistics")
    chains = n_chains if per_chain else None

    def drive(q0, generator: torch.Generator, eps_over=None, inv_mass_over=None):
        engages = graph_engages(q0, force_fn, discrete)
        with claimed(transition_graphs(staged) if engages else None) as graphs:
            return run(q0, generator, graphs, eps_over, inv_mass_over)

    def run(q0, generator, graphs, eps_over, inv_mass_over):
        dt, dev = q0.dtype, q0.device
        if inv_mass_over is None:
            im0 = identity_mass(d, dense, dtype=dt, device=dev, chains=chains)
        else:
            im0 = torch.as_tensor(inv_mass_over, dtype=dt, device=dev)
        if not per_chain:
            eps0 = initial_step_size(config, potential, q0, generator, im0, eps_over,
                                     chain_group)
        elif eps_over is not None or config.step_size is not None:
            eps = config.step_size if eps_over is None else eps_over
            eps0 = torch.as_tensor(eps, dtype=dt, device=dev).expand(n_chains).clone()
        else:
            p = mass_draw_momentum(generator, im0, q0.shape)
            eps0 = find_reasonable_epsilon_per_chain(force, q0, p, im0)

        def uniform(shape):
            return torch.rand(shape, generator=generator, device=dev, dtype=dt)

        def step(q, eps, inv_mass):
            p = mass_draw_momentum(generator, inv_mass, q.shape)
            log_u = torch.log1p(-uniform((n_chains,)))  # log U, U in (0, 1]
            if config.jitter > 0:
                eps = eps * (1.0 - config.jitter * uniform((n_chains,)))
            if graphs is not None and not graphs.failed:
                return graphs.transition(potential, q, p, log_u, eps, L, inv_mass,
                                         config.max_delta_energy)
            return hmc_transition(potential, q, p, log_u, eps, L, inv_mass,
                                  config.max_delta_energy, force_fn=force)

        def warm_window(q, da, inv_mass, n_steps):
            welford = WelfordState.init(d, dense, dtype=dt, device=dev, chains=chains)
            ema = torch.full((n_chains,), 0.5, dtype=dt, device=dev)
            for _ in range(n_steps):
                with profiling.span("hmc.transition"):
                    if config.adapt_step_size:
                        eps = torch.exp(da.log_eps)
                    else:
                        eps = torch.exp(da.mu - math.log(10.0))
                    q, info = step(q, eps, inv_mass)
                    if per_chain:
                        da = dual_averaging_update(da, info.accept_prob, config.target_accept)
                        welford = welford_push_batch(welford, q.unsqueeze(-2))
                    else:
                        da = dual_averaging_update(
                            da, cross_mean(torch.mean(info.accept_prob), chain_group),
                            config.target_accept)
                        welford = welford_push_batch(welford, q)
                    ema = 0.9 * ema + 0.1 * info.accept_prob
            if per_chain:
                return q, da, welford
            return rescue_stuck(q, ema, generator), da, welford

        q, da, inv_mass = q0, DualAveragingState.init(eps0), im0
        if n_warmup > 0:
            n_half = n_warmup // 2
            q, da, welford = warm_window(q, da, inv_mass, max(n_half, 1))
            if config.adapt_mass:
                welford = welford_merge_across(welford, chain_group)
                if dense:
                    inv_mass = welford_covariance(welford)
                elif per_chain:
                    inv_mass = torch.diag_embed(welford_variance(welford))
                else:
                    inv_mass = welford_variance(welford)
                da = DualAveragingState.init(torch.exp(da.log_eps_bar))
            q, da, _ = warm_window(q, da, inv_mass, max(n_warmup - n_half, 1))
        # adaptation off -> the configured eps (da.log_eps moves regardless)
        if config.adapt_step_size and n_warmup > 0:
            eps_final = torch.exp(da.log_eps_bar)
        else:
            eps_final = eps0

        qs = torch.empty((n_samples, n_chains, d), dtype=dt, device=dev)
        ljs = torch.empty((n_samples, n_chains), dtype=dt, device=dev)
        aps = torch.empty((n_samples, n_chains), dtype=dt, device=dev)
        divs = torch.empty((n_samples, n_chains), dtype=torch.bool, device=dev)
        for i in range(n_samples):
            with profiling.span("hmc.transition"):
                q, info = step(q, eps_final, inv_mass)
                qs[i] = q
                ljs[i] = -info.potential
                aps[i] = info.accept_prob
                divs[i] = info.divergent
        if graphs is not None:
            q = q.clone()  # the graph's output, which the next replay rewrites
        return q, qs, ljs, aps, divs, eps_final, inv_mass

    return drive


@dataclass
class HMCResult:
    samples: Dict[str, Any]  # constrained, addr -> (n_chains, n_samples, ...)
    positions: Any  # unconstrained (n_chains, n_samples, d)
    log_joint: Any  # (n_chains, n_samples) — log p + log|J| at samples
    accept_prob: Any  # (n_samples,) cross-chain mean per step
    divergences: Any  # (n_chains, n_samples) bool
    step_size: float
    inv_mass: Any
    final_positions: Any


def start_positions(staged: StagedModel, generator, n_chains, init, resume,
                    init_position, init_jitter):
    """The (n_chains, d) positions ``hmc_chain`` and ``nuts_chain`` start
    from: a resumed run's final positions, a warm start, or fresh ``init``
    positions. ``resume`` and ``init_position`` exclude each other."""
    if resume is not None and init_position is not None:
        raise ValueError(
            "pass either resume= or init_position=, not both — resume "
            "continues from its own final positions and would silently "
            "ignore the warm start"
        )
    if resume is not None:
        q = torch.as_tensor(resume.final_positions).to(
            device=staged.device, dtype=settings.real_dtype())
        if tuple(q.shape) != (n_chains, staged.dim):
            raise ValueError(
                f"resume positions {tuple(q.shape)} do not match "
                f"(n_chains={n_chains}, d={staged.dim})"
            )
        return q
    if init_position is not None:
        return _warm_start_batch(staged, generator, n_chains, init_position, init_jitter)
    return initial_positions(staged, generator, n_chains, init)


def hmc_chain(
    seed: int,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 1000,
    config: HMCConfig = HMCConfig(),
    *,
    n_chains: int = 1,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    device="cuda",
    discrete: Optional[Dict[str, Any]] = None,
    resume: Optional[Any] = None,
    init_position: Optional[Any] = None,
    init_jitter: float = 0.05,
) -> HMCResult:
    """Run HMC with cross-chain warmup adaptation.

    ``seed`` seeds one ``torch.Generator`` on the staged model's device,
    which draws every initial position, momentum, jitter and accept
    uniform. ``device`` is used only when ``staged`` is not given.

    ``resume``: a previous ``HMCResult`` (or any object with
    ``final_positions``, ``step_size`` and ``inv_mass``, such as
    ``interop.hmc_state_from_numpy`` of a JAX result): sampling continues
    from its final state with its step size and mass; warmup is skipped and
    adaptation frozen.

    ``init_position``: warm-start unconstrained position(s) — a ``(d,)``
    point broadcast to all chains with per-chain Gaussian jitter of scale
    ``init_jitter``, or an explicit ``(n_chains, d)`` batch used as-is.
    Warmup still runs.

    Discrete sites are held fixed at their discovery values or at
    ``discrete``; compose with MH sweeps for mixed models.
    """
    if staged is None:
        staged = stage(model_fn, *model_args, device=device)
    if staged.dim == 0:
        raise ValueError("model has no continuous latent sites")
    generator = torch.Generator(device=staged.device).manual_seed(int(seed))
    q0 = start_positions(staged, generator, n_chains, config.init, resume,
                         init_position, init_jitter)
    overrides = {}
    if resume is not None:
        config = replace(config, step_size=None, adapt_step_size=False, adapt_mass=False)
        n_warmup = 0
        overrides = dict(eps_over=resume.step_size, inv_mass_over=resume.inv_mass)
    drive = make_hmc_drive(staged, config, n_chains, n_samples, n_warmup, discrete=discrete)
    q_f, qs, ljs, aps, divs, eps_final, inv_mass_f = drive(q0, generator, **overrides)

    positions = qs.movedim(0, 1)  # (n_chains, n_samples, d)
    profiling.host_read("hmc_chain.step_size")
    return HMCResult(
        samples=constrain_positions(staged, positions),
        positions=positions,
        log_joint=ljs.movedim(0, 1),
        accept_prob=torch.mean(aps, dim=-1),
        divergences=divs.movedim(0, 1),
        step_size=float(eps_final),
        inv_mass=inv_mass_f,
        final_positions=q_f,
    )


# ---------------------------------------------------------------------------
# Incremental session
# ---------------------------------------------------------------------------


def draw_seed(generator: torch.Generator) -> int:
    """One int seed from ``generator`` (a host read)."""
    profiling.host_read("draw_seed")
    return int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device))


class HmcSession:
    """Stateful incremental HMC for one chain: step-by-step transitions with
    live control (step size, trajectory length), trajectory recording and
    state inspection.

    Holds (position, step_size, inv_mass) and a ``torch.Generator`` seeded
    by ``seed``; the position is a (d,) tensor on the staged model's
    device. Each call reads its results back to the host."""

    def __init__(
        self,
        seed: int,
        model_fn: Optional[Callable] = None,
        config: HMCConfig = HMCConfig(),
        *,
        staged: Optional[StagedModel] = None,
        model_args: tuple = (),
        device="cuda",
    ):
        self.staged = staged if staged is not None else stage(model_fn, *model_args,
                                                               device=device)
        if self.staged.dim == 0:
            raise ValueError("model has no continuous latent sites")
        self.config = config
        dt, dev = settings.real_dtype(), self.staged.device
        self._generator = torch.Generator(device=dev).manual_seed(int(seed))
        self._q = self.staged.initial_position(draw_seed(self._generator)).to(dt)
        self.inv_mass = torch.ones((self.staged.dim,), dtype=dt, device=dev)
        if config.step_size is not None:
            self.step_size = float(config.step_size)
        else:
            # search along the session's real trajectory length: no dual
            # averaging runs afterwards, so the one-step estimate can be
            # unstable at L steps
            p = mass_draw_momentum(self._generator, self.inv_mass, (self.staged.dim,))
            profiling.host_read("hmc_session.step_size")
            self.step_size = float(find_reasonable_epsilon(
                self.staged.potential, self._q, p, self.inv_mass,
                n_steps=config.n_leapfrog))
        self.n_leapfrog = config.n_leapfrog

    def _noise(self):
        """(momenta (1, d), accept log-uniform (1,)) for the next transition."""
        p = mass_draw_momentum(self._generator, self.inv_mass, (1, self.staged.dim))
        u = torch.rand((1,), generator=self._generator, device=self._q.device,
                       dtype=self._q.dtype)
        return p, torch.log1p(-u)

    def warmup(self, n_steps: int = 100) -> None:
        """Adapt the step size in place with dual averaging (the session
        analog of ``hmc_chain``'s warmup)."""
        da = DualAveragingState.init(torch.tensor(self.step_size, dtype=torch.float64))
        for _ in range(n_steps):
            info = self.step()
            profiling.host_read("hmc_session.warmup.accept_prob")
            da = dual_averaging_update(da, info.accept_prob.double().cpu(),
                                       self.config.target_accept)
            self.step_size = float(torch.exp(da.log_eps))
        self.step_size = float(torch.exp(da.log_eps_bar))

    def set_step_size(self, eps: float) -> None:
        self.step_size = float(eps)

    def set_n_leapfrog(self, n: int) -> None:
        self.n_leapfrog = int(n)

    @property
    def position(self):
        return self._q

    def current_trace(self):
        """Constrained values + density parts at the current position."""
        cont, _ = self.staged.constrain(self._q)
        return self.staged.replay_trace(self.staged.merge_discrete(cont))

    def step(self) -> HmcStepInfo:
        """One transition; the returned fields are 0-dim tensors."""
        p, log_u = self._noise()
        q_new, info = hmc_transition(self.staged.potential, self._q[None], p, log_u,
                                     self.step_size, self.n_leapfrog, self.inv_mass,
                                     self.config.max_delta_energy)
        self._q = q_new[0]
        return HmcStepInfo(**{k: v[0] for k, v in vars(info).items()})

    def step_recorded(self):
        """One transition returning the full trajectory (positions and
        Hamiltonians per leapfrog step) for animation and diagnostics."""
        p, log_u = self._noise()
        q, im, eps = self._q[None], self.inv_mass, self.step_size
        force_fn = batched_force(self.staged.potential)
        g0, u0 = force_fn(q)
        h0 = u0 + mass_kinetic(im, p)
        q_new, p_new, qs, hs = leapfrog_recorded(force_fn, q, p, eps, self.n_leapfrog, im, g0)
        delta = h0 - hs[-1]
        divergent = (~torch.isfinite(delta)) | (-delta > self.config.max_delta_energy)
        accepted = (~divergent) & (log_u < delta)
        ap = torch.where(divergent, torch.zeros_like(delta),
                         torch.clamp(torch.exp(torch.clamp(delta, max=50.0)), max=1.0))
        self._q = torch.where(accepted[:, None], q_new, q)[0]
        profiling.host_read("hmc_session.step_recorded", 6)
        return {
            "accepted": bool(accepted[0]),
            "divergent": bool(divergent[0]),
            "accept_prob": float(ap[0]),
            "trajectory": qs[:, 0].cpu().numpy(),
            "hamiltonians": hs[:, 0].cpu().numpy(),
            "initial_energy": float(h0[0]),
        }
