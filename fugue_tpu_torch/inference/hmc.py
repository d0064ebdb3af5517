"""Hamiltonian Monte Carlo over staged models, batched over chains.

The port of the single-device HMC path of ``fugue_tpu/inference/hmc.py``:
``HMCConfig``, dual averaging, Welford diagonal mass, ``leapfrog``,
``hmc_transition``, ``find_reasonable_epsilon``, ``make_hmc_drive`` and
``hmc_chain`` (fresh and ``init_position`` modes).

How it is expressed in PyTorch:

- Positions are a (C, d) tensor. Forces for all chains come from ONE call
  of ``batched_force(potential)`` = ``vmap(grad_and_value(potential))``,
  which runs the per-chain Python model once for the whole batch and gives
  the potential with the gradient, so a transition costs exactly L+1
  batched evaluations.
- Noise is drawn outside the deterministic step: ``hmc_transition`` takes
  the momenta ``p`` and the log-uniforms ``log_u`` as arguments, and the
  drive draws them from an explicit ``torch.Generator`` on the device.
- The leapfrog loop and the per-transition adaptation read nothing back to
  the host: step sizes, acceptance statistics and moments stay on the
  device, and host-side counters (dual-averaging step, Welford count) are
  Python floats. ``find_reasonable_epsilon`` is a host loop that runs once
  per run.
- Non-finite energies are masked (divergent, always rejected), which keeps
  float32 runs on the card from propagating a huge-but-finite proposal.

Dense mass (``HMCConfig.mass``), ``HmcSession``, ``leapfrog_recorded``,
``resume`` and the sharded (``chain_axis``) drive wait for later slices.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
from torch.func import grad_and_value, vmap

from .. import settings
from ..runtime.staging import StagedModel, stage


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


# ---------------------------------------------------------------------------
# Dual averaging (Hoffman & Gelman Alg 5)
# ---------------------------------------------------------------------------


@dataclass
class DualAveragingState:
    log_eps: Any  # 0-dim tensors on the device
    log_eps_bar: Any
    h_bar: Any
    mu: Any
    t: float  # adaptation step counter, kept on the host

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
# Welford moments for diagonal mass adaptation
# ---------------------------------------------------------------------------


@dataclass
class WelfordState:
    count: float  # kept on the host: batch sizes are known there
    mean: Any  # (d,)
    m2: Any  # (d,)

    @staticmethod
    def init(dim: int, *, dtype, device) -> "WelfordState":
        return WelfordState(
            count=0.0,
            mean=torch.zeros((dim,), dtype=dtype, device=device),
            m2=torch.zeros((dim,), dtype=dtype, device=device),
        )


def welford_push_batch(state: WelfordState, batch) -> WelfordState:
    """Fold a (n_chains, d) batch of positions into the moments (Chan
    parallel update)."""
    n_b = float(batch.shape[0])
    mean_b = torch.mean(batch, dim=0)
    n_new = state.count + n_b
    delta = mean_b - state.mean
    mean_new = state.mean + delta * (n_b / n_new)
    w = state.count * n_b / n_new
    m2_new = state.m2 + torch.sum((batch - mean_b) ** 2, dim=0) + w * delta**2
    return WelfordState(count=n_new, mean=mean_new, m2=m2_new)


def welford_variance(state: WelfordState, regularize: bool = True):
    var = state.m2 / max(state.count - 1.0, 1.0)
    if regularize:  # Stan-style shrinkage toward unit for small counts
        n = state.count
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return torch.clamp(var, min=1e-10)


# ---------------------------------------------------------------------------
# Diagonal mass algebra: ``inv_mass`` is a (d,) vector
# ---------------------------------------------------------------------------


def mass_velocity(inv_mass, p):
    return inv_mass * p


def mass_kinetic(inv_mass, p):
    """½ pᵀ M⁻¹ p over the last dim."""
    return 0.5 * torch.sum(p * mass_velocity(inv_mass, p), dim=-1)


def mass_draw_momentum(generator: torch.Generator, inv_mass, shape):
    """p ~ N(0, M) for M⁻¹ = diag(inv_mass)."""
    z = torch.randn(shape, generator=generator, device=inv_mass.device,
                    dtype=inv_mass.dtype)
    return z / torch.sqrt(inv_mass)


# ---------------------------------------------------------------------------
# Leapfrog and one transition, batched over chains
# ---------------------------------------------------------------------------


def batched_force(potential_fn: Callable) -> Callable:
    """(C, d) positions → (∇U (C, d), U (C,)) in one batched model run."""
    return vmap(grad_and_value(potential_fn))


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
):
    """One HMC proposal + MH correction for a batch of chains.

    ``q``, ``p``: (C, d) positions and momenta; ``log_u``: (C,) log-uniforms
    for the accept test; ``eps``: (C,) step sizes (after jitter) or a
    scalar. Divergences (non-finite energy or |ΔH| > threshold) are always
    rejected. Returns ``(q_out, HmcStepInfo)``.
    """
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
# Reasonable epsilon (Hoffman & Gelman Alg 4)
# ---------------------------------------------------------------------------


def find_reasonable_epsilon(potential_fn, q, p, inv_mass, max_iters: int = 60):
    """Double/halve eps until the acceptance of a one-step trajectory from
    one chain's ``q`` (d,) with momentum ``p`` (d,) crosses 0.5.

    A host loop (the JAX package's ``while_loop``): it reads one acceptance
    per iteration back from the device, once per run. Returns a 0-dim
    tensor on ``q``'s device."""
    force_fn = batched_force(potential_fn)
    q1, p1 = q[None], p[None]
    g0, u0 = force_fn(q1)
    h0 = float(u0[0] + mass_kinetic(inv_mass, p1)[0])

    def log_accept(eps):
        qe, pe, _, ue = leapfrog(force_fn, q1, p1, eps, 1, inv_mass, g0)
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
    seeds = torch.randint(0, 2**62, (n_chains,), generator=generator,
                          device=staged.device).tolist()
    return torch.stack([staged.initial_position(s) for s in seeds]).to(dt)


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
    shape (chains, samples, *site_shape), in one batched model run."""
    c, s, d = positions.shape
    out = vmap(lambda z: staged.constrain(z)[0])(positions.reshape(c * s, d))
    return {a: v.reshape(c, s, *v.shape[1:]) for a, v in out.items()}


# ---------------------------------------------------------------------------
# The warmup + sampling drive
# ---------------------------------------------------------------------------


def make_hmc_drive(
    staged: StagedModel,
    config: HMCConfig,
    n_chains: int,
    n_samples: int,
    n_warmup: int,
):
    """Build ``drive(q0, generator) → (q_f, qs, ljs, aps, divs, eps, inv_mass)``.

    Warmup: two windows of dual averaging on the cross-chain mean
    acceptance; at the midpoint the diagonal mass becomes the regularized
    Welford variance of the first window and the step size restarts from
    its averaged value. After each window, chains whose acceptance EMA
    collapsed copy a donor chain (``rescue_stuck``). Sampling then runs at
    the averaged step size. ``qs`` is (n_samples, C, d); ``ljs``, ``aps``
    and ``divs`` are (n_samples, C).
    """
    d = staged.dim
    potential = staged.potential
    L = config.n_leapfrog

    def drive(q0, generator: torch.Generator):
        dt, dev = q0.dtype, q0.device
        im0 = torch.ones((d,), dtype=dt, device=dev)
        if config.step_size is not None:
            eps0 = torch.tensor(config.step_size, dtype=dt, device=dev)
        else:
            p = mass_draw_momentum(generator, im0, (d,))
            eps0 = find_reasonable_epsilon(potential, q0[0], p, im0)

        def uniform(shape):
            return torch.rand(shape, generator=generator, device=dev, dtype=dt)

        def step(q, eps, inv_mass):
            p = mass_draw_momentum(generator, inv_mass, q.shape)
            log_u = torch.log1p(-uniform((n_chains,)))  # log U, U in (0, 1]
            if config.jitter > 0:
                eps = eps * (1.0 - config.jitter * uniform((n_chains,)))
            return hmc_transition(potential, q, p, log_u, eps, L, inv_mass,
                                  config.max_delta_energy)

        def warm_window(q, da, inv_mass, n_steps):
            welford = WelfordState.init(d, dtype=dt, device=dev)
            ema = torch.full((n_chains,), 0.5, dtype=dt, device=dev)
            for _ in range(n_steps):
                if config.adapt_step_size:
                    eps = torch.exp(da.log_eps)
                else:
                    eps = torch.exp(da.mu - math.log(10.0))
                q, info = step(q, eps, inv_mass)
                da = dual_averaging_update(da, torch.mean(info.accept_prob),
                                           config.target_accept)
                welford = welford_push_batch(welford, q)
                ema = 0.9 * ema + 0.1 * info.accept_prob
            return rescue_stuck(q, ema), da, welford

        def rescue_stuck(q, ema):
            """Warmup-only cross-chain rescue: a chain whose acceptance EMA
            collapsed copies the position of a donor chain drawn with
            probability ∝ its EMA."""
            donors = torch.multinomial(ema + 1e-6, n_chains, replacement=True,
                                       generator=generator)
            return torch.where((ema < 0.1)[:, None], q[donors], q)

        q, da, inv_mass = q0, DualAveragingState.init(eps0), im0
        if n_warmup > 0:
            n_half = n_warmup // 2
            q, da, welford = warm_window(q, da, inv_mass, max(n_half, 1))
            if config.adapt_mass:
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
            q, info = step(q, eps_final, inv_mass)
            qs[i] = q
            ljs[i] = -info.potential
            aps[i] = info.accept_prob
            divs[i] = info.divergent
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
    init_position: Optional[Any] = None,
    init_jitter: float = 0.05,
) -> HMCResult:
    """Run HMC with cross-chain warmup adaptation.

    ``seed`` seeds one ``torch.Generator`` on the staged model's device,
    which draws every initial position, momentum, jitter and accept
    uniform. ``device`` is used only when ``staged`` is not given.

    ``init_position``: warm-start unconstrained position(s) — a ``(d,)``
    point broadcast to all chains with per-chain Gaussian jitter of scale
    ``init_jitter``, or an explicit ``(n_chains, d)`` batch used as-is.
    Warmup still runs.
    """
    if staged is None:
        staged = stage(model_fn, *model_args, device=device)
    if staged.dim == 0:
        raise ValueError("model has no continuous latent sites")
    generator = torch.Generator(device=staged.device).manual_seed(int(seed))
    if init_position is None:
        q0 = initial_positions(staged, generator, n_chains, config.init)
    else:
        q0 = _warm_start_batch(staged, generator, n_chains, init_position, init_jitter)
    drive = make_hmc_drive(staged, config, n_chains, n_samples, n_warmup)
    q_f, qs, ljs, aps, divs, eps_final, inv_mass_f = drive(q0, generator)

    positions = qs.movedim(0, 1)  # (n_chains, n_samples, d)
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
