"""ChEES-HMC: one trajectory length for all chains, learned from the batch.

The port of ``fugue_tpu/inference/chees.py``: ``ChEESConfig``,
``ChEESResult`` with ``criterion_advice``, ``preconditioned_anisotropy``,
``halton_sequence``, the Adam rule on log T, ``chees_gradient`` and
``oja_update`` (the SNAPER projection) with their float32 hardening,
``chees_transition``, ``make_chees_drive``, ``chees_chain`` and
``CheesSession``.

Every chain takes the same number of leapfrog steps in a transition,
L = clip(ceil(h·T/ε), 1, max_leapfrog), with h the shared base-2 Halton
jitter, T the learned trajectory length and ε the dual-averaged step size.
T moves by Adam ascent on the ChEES criterion (or its SNAPER projection
onto the batch's leading principal direction), whose gradient is a
cross-chain mean over the (C, d) batch.

How it is expressed in PyTorch:

- The leapfrog loop is a Python loop, so L is a host int: each transition
  reads τ = h·T/ε back from the device once, and that is its only host
  read (``ChEESResult.host_syncs`` counts them). The adaptation state (ε,
  log T, Adam's moments and step counter, the Welford moments and the
  principal direction) stays on the device. While a profiler session
  runs, each transition is a ``chees.transition`` span (the parent of its
  ``potential`` spans) and each host read names its site
  (``utils.profiling``).
- A transition is L + 1 batched value-and-grad runs (``batched_force``):
  U at both ends comes with its gradient, and the sampling phase's log
  joint is −U of the kept point, with no further run.
- The draws come in as arguments: ``chees_transition`` takes the standard
  normals of the momenta and the accept log-uniforms, and the drive takes
  them from a draws object (``GeneratorDraws`` by default), the seam
  through which a test replays the JAX key schedule.
- The transition after its momenta is HMC's (``hmc.leapfrog_transition``:
  the head, L leapfrog steps, the accept test). On a CUDA device the drive
  and ``CheesSession.step`` replay it from the model's ``ChEESGraphs``, an
  ``hmc.TransitionGraphs`` whose block is one leapfrog step replayed L
  times, so one capture per shape (``hmc.graph_key``) serves every L. ε
  and the mass are device tensors copied into the graphs' inputs, so
  sessions of one model with their own ε and mass share the captures.
  Counts ``chees.graph_replay``, ``chees.graph_capture``,
  ``chees.graph_fallback``; a replay opens no ``potential`` span.

``make_chees_drive(chain_group=...)`` is the sharded drive: the
criterion's cross-chain means (``cmean``), the acceptance mean, the ε₀
consensus and the Welford merge reduce over the process group, so ε and T,
and with them every transition's L, are the same on every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import settings
from ..parallel.mesh import cross_mean
from ..runtime.staging import StagedModel, stage
from ..utils import profiling
from .hmc import (
    DualAveragingState,
    TransitionGraphs,
    WelfordState,
    batched_force,
    claim_graphs,
    constrain_positions,
    draw_seed,
    dual_averaging_update,
    find_reasonable_epsilon,
    leapfrog_transition,
    mass_velocity,
    momentum_from_normal,
    start_positions,
    eps_consensus,
    welford_merge_across,
    welford_push_batch,
    welford_variance,
)


@dataclass(frozen=True)
class ChEESConfig:
    step_size: Optional[float] = None  # None → reasonable-epsilon search
    target_accept: float = 0.651  # optimal for jittered fixed-L HMC
    adapt_rate: float = 0.025  # Adam learning rate on log T
    # "chees": the criterion over the full state (Hoffman, Radul & Sountsov
    # 2021), best on small-d, weakly informed targets; "snaper": the same
    # update on the squared projection onto the batch's leading principal
    # direction (Sountsov & Hoffman 2022), for large-d data-informed targets
    # where the full-state criterion goes flat. ``ChEESResult.criterion_advice``
    # tells them apart from a run's samples.
    criterion: str = "chees"
    principal_decay: float = 0.9  # EMA decay of the principal direction ("snaper")
    # cap on T after mass adaptation, in preconditioned periods 2π: the
    # criterion has spurious maxima at period multiples
    max_trajectory_periods: float = 1.0
    max_leapfrog: int = 1024  # hard cap on steps per trajectory
    adapt_step_size: bool = True
    adapt_mass: bool = True
    max_delta_energy: float = 1000.0
    init: str = "uniform"  # see HMCConfig.init


def _numpy(x) -> np.ndarray:
    """A tensor, a numpy array or a JAX array as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float64)


def preconditioned_anisotropy(positions, inv_mass):
    """(leading_sd, median_sd) of the sample covariance in the
    mass-preconditioned space x = q / sqrt(inv_mass): a perfectly
    preconditioned target is isotropic there. Host numpy."""
    S = np.sqrt(np.maximum(_numpy(inv_mass), 1e-30))
    P = _numpy(positions)
    X = P.reshape(-1, P.shape[-1]) / S
    X = X - X.mean(axis=0)
    C = X.T @ X / max(len(X) - 1, 1)
    evals = np.maximum(np.linalg.eigvalsh(C), 0.0)
    return float(np.sqrt(evals[-1])), float(np.sqrt(np.median(evals)))


@dataclass
class ChEESResult:
    samples: Dict[str, Any]  # constrained, addr -> (n_chains, n_samples, ...)
    positions: Any  # (n_chains, n_samples, d)
    log_joint: Any  # (n_chains, n_samples)
    accept_prob: Any  # (n_samples,) cross-chain mean per step
    divergences: Any  # (n_chains, n_samples)
    step_size: float
    trajectory_length: float  # adapted T (the pre-jitter maximum)
    # the learned T sits at the max_trajectory_periods cap
    trajectory_cap_reached: bool
    mean_leapfrog: float  # mean steps per sampling transition
    # exact leapfrog count over warmup and sampling, summed over chains; add
    # one batched evaluation per transition for the trajectory's start
    n_leapfrogs: int
    inv_mass: Any
    final_positions: Any
    criterion: str = "chees"
    host_syncs: int = 0  # τ reads: one per transition

    def criterion_advice(self, ratio_threshold: float = 1.8) -> dict:
        """Whether to rerun with ``criterion="snaper"``: the full-state
        criterion dephases on targets with residual anisotropy after
        diagonal-mass preconditioning, so this measures the leading against
        the median singular value of the mass-scaled sample covariance.
        Returns ``{"recommendation": "snaper" | None, "leading_sd",
        "median_sd", "ratio", "reason"}``.

        Non-finite positions or mass give no verdict: recommendation None
        and an "undetermined" reason. (The JAX package reads such a run as
        healthy.)"""
        if not (np.isfinite(_numpy(self.positions)).all()
                and np.isfinite(_numpy(self.inv_mass)).all()):
            return {
                "recommendation": None,
                "leading_sd": math.nan,
                "median_sd": math.nan,
                "ratio": math.nan,
                "reason": "undetermined: non-finite samples (or mass); the "
                          "anisotropy cannot be measured from this run",
            }
        leading, median = preconditioned_anisotropy(self.positions, self.inv_mass)
        ratio = leading / max(median, 1e-30)
        recommendation = None
        if self.criterion != "chees":
            reason = (
                f"criterion='snaper' already in use (anisotropy {ratio:.2f}x); "
                "on near-isotropic small-d targets plain 'chees' mixes better "
                "per gradient"
            )
        elif ratio >= ratio_threshold:
            recommendation = "snaper"
            reason = (
                f"residual anisotropy {ratio:.2f}x after diagonal-mass "
                "preconditioning: the full-state ChEES criterion dephases on "
                "such targets (learned T drifts off its optimum); rerun with "
                "ChEESConfig(criterion='snaper'), which projects onto the "
                "leading principal direction"
            )
        else:
            reason = (
                f"residual anisotropy {ratio:.2f}x < {ratio_threshold}: the "
                "diagonal mass preconditions this target well; the full-state "
                "criterion fits it"
            )
        return {"recommendation": recommendation, "leading_sd": leading,
                "median_sd": median, "ratio": ratio, "reason": reason}


def _halton_point(i: int) -> float:
    """The base-2 Halton (van der Corput) point h_{i+1} in (0, 1)."""
    f, r, idx = 0.5, 0.0, i + 1
    while idx > 0:
        r += f * (idx & 1)
        idx >>= 1
        f *= 0.5
    return r


def halton_sequence(n: int) -> np.ndarray:
    """Base-2 Halton points h_1..h_n in (0, 1): the shared per-transition
    trajectory jitter, alternating coarse and fine lengths."""
    return np.array([_halton_point(i) for i in range(n)], np.float64)


# ---------------------------------------------------------------------------
# Adam on log T, the ChEES gradient and the SNAPER direction
# ---------------------------------------------------------------------------


@dataclass
class AdamState:
    m: Any  # 0-dim tensors in the run's dtype, the step counter too
    v: Any
    t: Any

    @staticmethod
    def init(dtype=None, device=None) -> "AdamState":
        z = torch.zeros((), dtype=dtype or settings.real_dtype(), device=device)
        return AdamState(m=z, v=z, t=z)


def _adam_step(state: AdamState, grad, lr, b1=0.9, b2=0.999, eps=1e-8):
    t = state.t + 1.0
    m = b1 * state.m + (1 - b1) * grad
    v = b2 * state.v + (1 - b2) * grad * grad
    mhat = m / (1 - b1**t)
    vhat = v / (1 - b2**t)
    return AdamState(m=m, v=v, t=t), lr * mhat / (torch.sqrt(vhat) + eps)


def chain_mean(group=None):
    """``cmean(x, dim=None)``: the mean over the chains of every rank in
    ``group`` (the local mean, then the ranks' mean: the shards are equal)."""
    def cmean(x, dim=None):
        m = torch.mean(x) if dim is None else torch.mean(x, dim=dim)
        return cross_mean(m, group)

    return cmean


def chees_gradient(Q, Q_prop, V_end, accept_prob, h, proj=None, cmean=None):
    """Surrogate d ChEES / d T from the (C, d) batch: the acceptance-weighted
    cross-chain mean of h·(‖q̃'‖² − ‖q̃‖²)·⟨q̃', v'⟩, q̃ centred on the
    weighted batch mean. ``proj`` (d,) applies it to the projection q̃·proj
    instead (SNAPER).

    Hardened for float32: rows whose proposal or end velocity is not finite
    are replaced BEFORE any arithmetic (inf·0 is NaN) and weigh nothing,
    non-finite contributions count 0, and the result is clipped to ±1e6, so
    one overflowed transition cannot set Adam's second moment to inf.
    ``cmean`` (``chain_mean``) takes the means over the chains of every
    rank."""
    cmean = cmean or chain_mean()
    finite = torch.all(torch.isfinite(Q_prop), dim=1) & torch.all(torch.isfinite(V_end), dim=1)
    Qp_safe = torch.where(finite[:, None], Q_prop, 0.0)
    V_safe = torch.where(finite[:, None], V_end, 0.0)
    w = torch.where(finite, accept_prob, 0.0)
    mw = torch.clamp(cmean(w), min=1e-10)
    q_bar = cmean(Q * w[:, None], dim=0) / mw
    qp_bar = cmean(Qp_safe * w[:, None], dim=0) / mw
    Qc = Q - q_bar[None, :]
    Qp = Qp_safe - qp_bar[None, :]
    if proj is None:
        dsq = torch.sum(Qp * Qp, dim=1) - torch.sum(Qc * Qc, dim=1)
        inner = torch.sum(Qp * V_safe, dim=1)
    else:
        pq = Qc @ proj
        pqp = Qp @ proj
        pv = V_safe @ proj
        dsq = pqp * pqp - pq * pq
        inner = pqp * pv
    g = h * dsq * inner
    g = torch.where(torch.isfinite(g), g, 0.0)
    grad = cmean(w * g) / mw
    grad = torch.where(torch.isfinite(grad), grad, 0.0)
    return torch.clamp(grad, -1e6, 1e6)


def _pre_scale(inv_mass):
    # preconditioned coordinates x = q / S, S = sqrt(inv_mass)
    return torch.sqrt(torch.clamp(inv_mass, min=1e-30))


def oja_update(Q_out, u, z, inv_mass, decay, cmean=None):
    """One Oja/EMA power-iteration step toward the leading principal
    direction of the preconditioned batch (SNAPER's projection). Rows that
    are not finite are masked before any arithmetic; a batch with no finite
    row keeps the previous direction. ``cmean`` as in ``chees_gradient``."""
    cmean = cmean or chain_mean()
    S = _pre_scale(inv_mass)
    finite_q = torch.all(torch.isfinite(Q_out), dim=1)
    Qs = torch.where(finite_q[:, None], Q_out, 0.0)
    nf = torch.clamp(cmean(finite_q.to(Q_out.dtype)), min=1e-10)
    q_m = cmean(Qs, dim=0) / nf
    Xc = torch.where(finite_q[:, None], (Qs - q_m[None, :]) / S, 0.0)
    y = Xc @ u
    cov_u = cmean(y[:, None] * Xc, dim=0) / nf
    cov_u = torch.where(torch.isfinite(cov_u), cov_u, 0.0)
    z_new = decay * z + (1.0 - decay) * cov_u
    nrm = torch.linalg.norm(z_new)
    u_new = torch.where(nrm > 1e-20, z_new / torch.clamp(nrm, min=1e-30), u)
    return u_new, z_new


# ---------------------------------------------------------------------------
# One transition, batched over chains
# ---------------------------------------------------------------------------


def _trajectory_steps(eps, T, h, max_leapfrog: int) -> int:
    """L = clip(ceil(τ), 1, max_leapfrog) for τ = h·T/ε (1 for a τ that is
    not finite); τ is read back to the host when it is a tensor."""
    tau = h * T / eps
    if isinstance(tau, torch.Tensor):  # the transition's one host read
        profiling.host_read("chees.tau")
    tau = float(tau)
    return min(max(math.ceil(tau), 1), max_leapfrog) if math.isfinite(tau) else 1


def chees_transition(potential_fn: Callable, Q, z, log_u, eps, T, h, inv_mass,
                     max_leapfrog: int, max_delta_energy: float = 1000.0, *,
                     n_leapfrog: Optional[int] = None, graphs: Optional["ChEESGraphs"] = None):
    """One jittered fixed-length transition for the (C, d) batch ``Q``.

    ``z`` (C, d) standard normals become the momenta (``momentum_from_normal``),
    ``log_u`` (C,) are the accept log-uniforms; ``eps``, ``T`` and ``h`` are
    0-dim tensors or floats. τ = h·T/ε is read back to the host once (not
    at all when all three are floats), and every chain takes L =
    clip(ceil(τ), 1, max_leapfrog) leapfrog steps (L = 1 for a τ that is
    not finite) of ``hmc.leapfrog_transition``. ``n_leapfrog``: L, where the
    caller has it on the host already (τ is then not computed). ``graphs``:
    replay the transition from these captures (``ChEESGraphs``; ``eps`` a
    tensor).

    Returns ``(Q_out, Q_prop, P_end, accept_prob, accepted, divergent, L,
    U_out)``: L a host int, U_out the potential at ``Q_out``."""
    with profiling.span("chees.transition"):
        L = n_leapfrog if n_leapfrog is not None else _trajectory_steps(eps, T, h, max_leapfrog)
        P = momentum_from_normal(inv_mass, z)
        if graphs is not None and not graphs.failed:
            Q_out, info, Q_prop, P_end = graphs.transition(potential_fn, Q, P, log_u, eps, L,
                                                           inv_mass, max_delta_energy)
            Q_out = Q_out.clone()  # the graphs' own, which the next replay rewrites
        else:
            Q_out, info, Q_prop, P_end = leapfrog_transition(
                batched_force(potential_fn), Q, P, log_u, eps, L, inv_mass, max_delta_energy)
        return (Q_out, Q_prop, P_end, info.accept_prob, info.accepted, info.divergent, L,
                info.potential)


class ChEESGraphs(TransitionGraphs):
    """The ChEES transition's ``TransitionGraphs``: a block of one leapfrog
    step, replayed L times, so one capture per shape serves every L."""

    prefix = "chees"
    steps = 1


class GeneratorDraws:
    """The drive's random inputs, from one ``torch.Generator``: the
    step-size search's standard normals, then per transition the momenta's
    standard normals and the accept log-uniforms log(1 − U), U in [0, 1).
    The drive asks for them in run order; a test hands it another object
    with these two methods."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def search_normal(self, d, dtype):
        return torch.randn((d,), generator=self.generator, device=self.generator.device,
                           dtype=dtype)

    def transition(self, n_chains, d, dtype):
        dev = self.generator.device
        z = torch.randn((n_chains, d), generator=self.generator, device=dev, dtype=dtype)
        u = torch.rand((n_chains,), generator=self.generator, device=dev, dtype=dtype)
        return z, torch.log1p(-u)


# ---------------------------------------------------------------------------
# The warmup + sampling drive
# ---------------------------------------------------------------------------


def make_chees_drive(
    staged: StagedModel,
    config: ChEESConfig,
    n_chains: int,
    n_samples: int,
    n_warmup: int,
    *,
    discrete: Optional[Dict[str, Any]] = None,
    chain_group=None,
):
    """Build ``drive(q0, draws, eps_over=None, T_over=None,
    inv_mass_over=None) → (q_f, qs, ljs, aps, divs, eps, T, mean_L,
    inv_mass, counts)``: ``qs`` (n_samples, C, d), ``ljs`` and ``divs``
    (n_samples, C), ``aps`` (n_samples,) cross-chain means, ``counts`` the
    host ints ``leapfrogs`` (per chain) and ``host_syncs``. The overrides
    replace the initial step size, T and mass (resume).

    Warmup, the JAX package's schedule: a first half at unit mass with no
    cap on log T but max_leapfrog·ε (skipped when n_warmup // 2 == 0);
    then, with ``adapt_mass``, the Welford variance of the first half
    becomes the mass, dual averaging restarts from its averaged ε, and
    under SNAPER the principal direction is remapped into the new
    preconditioned space; a second half with log T capped at
    log(2π·max_trajectory_periods). T is Polyak-averaged with weight
    t^−0.75; sampling runs at the averaged ε and T, the final T clamped to
    the post-mass cap. No chain rescue. ``chain_group``: the sharded drive
    over this rank's ``n_chains``; ``aps`` are then means over every
    rank's chains.

    Where ``hmc.graph_engages`` (CUDA positions, no ``discrete``), each
    transition after its noise replays the model's ``ChEESGraphs``: the
    same kernels on the same inputs. The noise, τ's read and the
    adaptation stay eager."""
    if config.criterion not in ("chees", "snaper"):
        raise ValueError(
            f"unknown ChEES criterion {config.criterion!r} (expected 'chees' or 'snaper')"
        )
    snaper = config.criterion == "snaper"
    d = staged.dim
    cmean = chain_mean(chain_group)
    halton = halton_sequence(max(n_warmup + n_samples, 1))

    def potential(z):
        return staged.potential(z, discrete)

    def drive(q0, draws, eps_over=None, T_over=None, inv_mass_over=None):
        with claim_graphs(staged, ChEESGraphs, q0, discrete=discrete) as graphs:
            return run(q0, draws, graphs, eps_over, T_over, inv_mass_over)

    def run(q0, draws, graphs, eps_over, T_over, inv_mass_over):
        dt, dev = q0.dtype, q0.device
        hs = torch.as_tensor(halton, dtype=dt).tolist()  # the jitter in the run's dtype
        unit = torch.ones((d,), dtype=dt, device=dev)
        if eps_over is not None:
            eps0 = _tensor(eps_over, dt, dev).reshape(())
        elif config.step_size is not None:
            eps0 = torch.tensor(config.step_size, dtype=dt, device=dev)
        else:
            p = momentum_from_normal(unit, draws.search_normal(d, dt))
            eps0 = eps_consensus(find_reasonable_epsilon(potential, q0[0], p, unit),
                                 chain_group)
        inv_mass = unit if inv_mass_over is None else _tensor(inv_mass_over, dt, dev)
        logT = torch.log(_tensor(T_over, dt, dev).reshape(())) if T_over is not None \
            else torch.log(eps0)
        counts = {"leapfrogs": 0, "host_syncs": 0}

        def transition(q, eps, T, h):
            z, log_u = draws.transition(n_chains, d, dt)
            out = chees_transition(potential, q, z, log_u, eps, T, h, inv_mass,
                                   config.max_leapfrog, config.max_delta_energy,
                                   graphs=graphs)
            counts["leapfrogs"] += out[6]
            counts["host_syncs"] += 1
            return out

        q, da, logT_bar, adam = q0, DualAveragingState.init(eps0), logT, AdamState.init(dt, dev)
        u = z_pc = torch.full((d,), 1.0 / math.sqrt(d), dtype=dt, device=dev)
        inf_cap = torch.tensor(math.inf, dtype=dt, device=dev)
        post_mass_cap = torch.log(torch.tensor(
            2.0 * math.pi * config.max_trajectory_periods, dtype=dt, device=dev))

        def warm_window(n_steps, offset, log_t_cap):
            nonlocal q, da, logT, logT_bar, adam, u, z_pc
            welford = WelfordState.init(d, dtype=dt, device=dev)
            for i in range(n_steps):
                h = hs[offset + i]
                eps = torch.exp(da.log_eps) if config.adapt_step_size else eps0
                q_out, q_prop, p_end, ap, _, _, _, _ = transition(q, eps, torch.exp(logT), h)
                da = dual_averaging_update(da, cmean(ap), config.target_accept)
                # the criterion compares the proposal with the pre-transition state
                proj = u / _pre_scale(inv_mass) if snaper else None
                g = chees_gradient(q, q_prop, mass_velocity(inv_mass, p_end), ap, h, proj=proj,
                                   cmean=cmean)
                adam, step = _adam_step(adam, -g * torch.exp(logT), config.adapt_rate)  # ascent
                hi = torch.minimum(torch.log(config.max_leapfrog * eps), log_t_cap)
                logT = torch.minimum(torch.maximum(logT - step, torch.log(eps) - 1.0), hi)
                eta = torch.pow(adam.t, -0.75)
                logT_bar = eta * logT + (1.0 - eta) * logT_bar
                welford = welford_push_batch(welford, q_out)
                if snaper:
                    u, z_pc = oja_update(q_out, u, z_pc, inv_mass, config.principal_decay,
                                         cmean=cmean)
                q = q_out
            return welford

        n_half = n_warmup // 2
        if n_half > 0:
            welford = warm_window(n_half, 0, inf_cap)
            if config.adapt_mass:
                inv_mass = welford_variance(welford_merge_across(welford, chain_group))
                da = DualAveragingState.init(torch.exp(da.log_eps_bar))
                if snaper:
                    # first-half S was 1, so the q-space direction is u: map
                    # it into the new preconditioned space, restart the EMA
                    u = u / _pre_scale(inv_mass)
                    u = u / torch.clamp(torch.linalg.norm(u), min=1e-30)
                    z_pc = u
        if n_warmup - n_half > 0:
            warm_window(n_warmup - n_half, n_half,
                        post_mass_cap if config.adapt_mass else inf_cap)

        # adaptation off -> the configured eps (da.log_eps moves regardless)
        eps_f = torch.exp(da.log_eps_bar) if (config.adapt_step_size and n_warmup > 0) else eps0
        logT_f = logT_bar if n_warmup > 0 else logT
        if config.adapt_mass and n_warmup > 0:
            # the Polyak average can carry first-half (uncapped) lengths
            logT_f = torch.minimum(logT_f, post_mass_cap)
        T_f = torch.exp(logT_f)

        qs = torch.empty((n_samples, n_chains, d), dtype=dt, device=dev)
        ljs = torch.empty((n_samples, n_chains), dtype=dt, device=dev)
        aps = torch.empty((n_samples,), dtype=dt, device=dev)
        divs = torch.empty((n_samples, n_chains), dtype=torch.bool, device=dev)
        sampling_leaps = 0
        for i in range(n_samples):
            q, _, _, ap, _, div, L, u_out = transition(q, eps_f, T_f, hs[n_warmup + i])
            qs[i], ljs[i], aps[i], divs[i] = q, -u_out, cmean(ap), div
            sampling_leaps += L
        mean_L = sampling_leaps / n_samples if n_samples else math.nan
        return q, qs, ljs, aps, divs, eps_f, T_f, mean_L, inv_mass, counts

    return drive


def _tensor(x, dtype, device):
    """A tensor, a number, a numpy or a JAX array as a tensor."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def chees_chain(
    seed: int,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 1000,
    config: ChEESConfig = ChEESConfig(),
    *,
    n_chains: int = 64,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    device="cuda",
    discrete: Optional[Dict[str, Any]] = None,
    resume: Optional[Any] = None,
    init_position: Optional[Any] = None,
    init_jitter: float = 0.05,
) -> ChEESResult:
    """Run ChEES-HMC over ``n_chains`` chains (the ChEES gradient is a
    cross-chain mean: use at least about 8).

    ``seed`` seeds one ``torch.Generator`` on the staged model's device,
    which draws the initial positions, the step-size search's momentum and
    every transition's momenta and accept uniforms. ``device`` is used only
    when ``staged`` is not given.

    ``resume``: a previous ``ChEESResult``, or any object with
    ``final_positions``, ``step_size``, ``trajectory_length`` and
    ``inv_mass`` (tensors, numpy or JAX arrays: a JAX ``ChEESResult``
    works as it is): sampling continues from its final state with its
    warmed kernel; warmup is skipped and adaptation frozen.

    ``init_position``: a (d,) warm start broadcast to every chain with
    Gaussian jitter of scale ``init_jitter``, or an (n_chains, d) batch used
    as it is. Discrete sites are held at ``discrete`` (default: their
    discovery values)."""
    if staged is None:
        staged = stage(model_fn, *model_args, device=device)
    if staged.dim == 0:
        raise ValueError("model has no continuous latent sites; use MH")
    overrides = {}
    if resume is not None:
        config = replace(config, step_size=None, adapt_step_size=False, adapt_mass=False)
        n_warmup = 0
        overrides = dict(eps_over=resume.step_size, T_over=resume.trajectory_length,
                         inv_mass_over=resume.inv_mass)
    drive = make_chees_drive(staged, config, n_chains, n_samples, n_warmup, discrete=discrete)
    generator = torch.Generator(device=staged.device).manual_seed(int(seed))
    q0 = start_positions(staged, generator, n_chains, config.init, resume, init_position,
                         init_jitter)
    q_f, qs, ljs, aps, divs, eps_f, T_f, mean_L, inv_mass_f, counts = drive(
        q0, GeneratorDraws(generator), **overrides)
    positions = qs.movedim(0, 1)  # (chains, samples, d)
    profiling.host_read("chees_chain.trajectory_length")
    profiling.host_read("chees_chain.step_size")
    T_float = float(T_f)
    t_cap = 2.0 * math.pi * config.max_trajectory_periods
    return ChEESResult(
        samples=constrain_positions(staged, positions),
        positions=positions,
        log_joint=ljs.movedim(0, 1),
        accept_prob=aps,
        divergences=divs.movedim(0, 1),
        step_size=float(eps_f),
        trajectory_length=T_float,
        trajectory_cap_reached=bool(config.adapt_mass and n_warmup > 0
                                    and T_float >= t_cap * (1.0 - 1e-5)),
        mean_leapfrog=mean_L,
        n_leapfrogs=counts["leapfrogs"] * n_chains,
        inv_mass=inv_mass_f,
        final_positions=q_f,
        criterion=config.criterion,
        host_syncs=counts["host_syncs"],
    )


class CheesSession:
    """Stateful incremental ChEES-HMC over a chain batch. Construction runs
    the whole warmup (step size, trajectory length, mass) through
    ``chees_chain``; each ``step()`` then moves every chain one jittered
    transition with the frozen kernel and returns the batch. On a CUDA
    device the step replays the model's ``ChEESGraphs``, which the
    model's other sessions share.

    ``seed`` seeds a ``torch.Generator`` on the staged model's device, which
    seeds the warmup run and draws every later transition."""

    def __init__(
        self,
        seed: int,
        model_fn: Optional[Callable] = None,
        config: ChEESConfig = ChEESConfig(),
        *,
        n_chains: int = 64,
        n_warmup: int = 300,
        staged: Optional[StagedModel] = None,
        model_args: tuple = (),
        device="cuda",
    ):
        self.staged = staged if staged is not None else stage(model_fn, *model_args,
                                                               device=device)
        if self.staged.dim == 0:
            raise ValueError("model has no continuous latent sites")
        self.config = config
        self.n_chains = n_chains
        self._generator = torch.Generator(device=self.staged.device).manual_seed(int(seed))
        warm = chees_chain(draw_seed(self._generator), n_samples=1, n_warmup=n_warmup,
                           config=config, n_chains=n_chains, staged=self.staged)
        self.step_size = warm.step_size
        self.trajectory_length = warm.trajectory_length
        self.inv_mass = warm.inv_mass
        self._Q = warm.final_positions
        # ε as the transition's kernels read it, made once: no upload per step
        self._eps = torch.tensor(self.step_size, dtype=self._Q.dtype, device=self._Q.device)
        self._draws = GeneratorDraws(self._generator)
        self._t = 0

    @property
    def positions(self):
        return self._Q

    def step(self):
        """One jittered transition for the whole batch: the batch positions
        (unconstrained, numpy), the cross-chain mean acceptance, the
        divergence count and the leapfrog count."""
        dt = self._Q.dtype
        h = float(torch.tensor(_halton_point(self._t % (1 << 16)), dtype=dt))
        self._t += 1
        z, log_u = self._draws.transition(self.n_chains, self.staged.dim, dt)
        L = _trajectory_steps(self.step_size, self.trajectory_length, h,
                              self.config.max_leapfrog)  # host floats: no read
        # the claim holds the graphs' outputs until they are read
        with claim_graphs(self.staged, ChEESGraphs, self._Q) as graphs:
            Q, _, _, ap, _, div, L, _ = chees_transition(
                self.staged.potential, self._Q, z, log_u, self._eps,
                self.trajectory_length, h, self.inv_mass, self.config.max_leapfrog,
                self.config.max_delta_energy, n_leapfrog=L, graphs=graphs)
            self._Q = Q
            profiling.host_read("chees_session.positions")
            positions = Q.cpu().numpy()
            profiling.host_read("chees_session.accept_mean")
            accept_mean = float(torch.mean(ap))
            profiling.host_read("chees_session.divergences")
            divergences = int(torch.sum(div))
        return {"positions": positions, "accept_mean": accept_mean,
                "divergences": divergences, "n_leapfrog": L}
