"""No-U-Turn Sampler, batched over chains.

The port of the plain ``"while"`` tree build of ``fugue_tpu/inference/nuts.py``:
``NUTSConfig``, the checkpoint bit helpers and ``_uturn``, ``nuts_transition``,
the synchronous ``make_nuts_drive``, ``NUTSResult``, ``nuts_chain`` and
``NutsSession``. Multinomial NUTS with progressive sampling biased toward the
fresh subtree, the generalized U-turn criterion, and the iterative tree build:
one leapfrog per leaf, a checkpoint stack of (momentum, running momentum sum)
at slot popcount(n) for even leaf n, and at odd leaf n the U-turn checks of
the t nested subtrees it completes (t = trailing one-bits of n), whose starts
sit at slots popcount(n) - t .. popcount(n) - 1.

How it is expressed in PyTorch, for C chains at once:

- All chains start the tree together, and a chain that has not stopped
  completes doubling j exactly at leaf 2^j - 1. So the leaf index ``n``, the
  depth, the checkpoint slot and the trailing-ones range are Python ints,
  the same for every running chain; per chain there is only an ``active``
  mask beside the (C, d) walker, boundary and candidate tensors and the
  (C, max_depth + 1, d) checkpoint stacks.
- Every leaf is one batched value-and-grad (``batched_force``), for every
  chain: a chain that has stopped is frozen by the ``active`` mask on every
  update, as a vmapped ``while_loop`` freezes it, and its evaluations are
  wasted but harmless. The trajectory root costs one more evaluation.
- The loop ends when no chain is active: one host read of ``active.any()``
  per leaf, which runs exactly the leaves of a vmapped ``while_loop`` (the
  batch maximum). The leaf's own body reads nothing back to the host.
- The noise comes in as arguments (``NutsNoise``). ``draw_nuts_noise``
  draws the per-leaf uniforms of a whole transition as one (2^max_depth - 1,
  C, 3) block: one RNG launch instead of one per leaf, 3 MB at C = 1024 in
  float32. Log-uniforms are log(1 - U) with U in [0, 1), never log(0).
- The drive keeps each chain's exact leapfrog count in int32 and sums it on
  the host in int64 (``NUTSResult.n_leapfrogs``), and counts the lock-step
  leaves and the host reads it ran.

``make_nuts_drive(chain_group=...)`` is the sharded drive: only the
adaptation reduces over the process group (the acceptance mean, the ε₀
consensus, the midpoint's Welford merge); the tree build stays on the
rank, whose host loop runs its own number of leaves and calls no
collective.

Not ported: the ``"async"``, ``"chunked"`` and ``"scan"`` loop modes, the
``ring``/``lockstep`` sampling loops of the async drive, and its
fractional dual averaging and masked Welford pushes.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional

import torch

from .. import settings
from ..parallel.mesh import cross_mean
from ..runtime.staging import StagedModel, stage
from .hmc import (
    DualAveragingState,
    WelfordState,
    _per_chain,
    batched_force,
    constrain_positions,
    draw_seed,
    dual_averaging_update,
    find_reasonable_epsilon,
    identity_mass,
    initial_step_size,
    mass_draw_momentum,
    mass_kinetic,
    mass_velocity,
    rescue_stuck,
    start_positions,
    welford_covariance,
    welford_merge_across,
    welford_push_batch,
    welford_variance,
)


@dataclass(frozen=True)
class NUTSConfig:
    step_size: Optional[float] = None
    max_depth: int = 8
    target_accept: float = 0.8
    adapt_step_size: bool = True
    adapt_mass: bool = True
    max_delta_energy: float = 1000.0
    init: str = "uniform"  # see HMCConfig.init
    mass: str = "diag"  # see HMCConfig.mass
    # tree build: only the plain "while" build is ported (None means it)
    loop: Optional[str] = None

    def __post_init__(self):
        if self.loop not in (None, "while"):
            raise ValueError(
                f"loop {self.loop!r} is not ported; the PyTorch port builds "
                "trees with the plain 'while' loop (None or 'while')"
            )
        if self.mass not in ("diag", "dense"):
            raise ValueError(f"unknown mass {self.mass!r}; use 'diag' or 'dense'")


# ---------------------------------------------------------------------------
# Checkpoint bit helpers (host ints) and the U-turn criterion
# ---------------------------------------------------------------------------


def _popcount(n: int) -> int:
    return bin(n).count("1")


def _count_trailing_zeros(x: int) -> int:
    """Trailing zero bits of a 32-bit word (32 for 0)."""
    x &= 0xFFFFFFFF
    return 32 if x == 0 else (x & -x).bit_length() - 1


def _trailing_ones(n: int) -> int:
    return _count_trailing_zeros(~n)


def _uturn(r_sum, r_left, r_right, inv_mass):
    """Generalized U-turn over the last dim: either end moving back toward
    the other. (..., d) → (...,) bool."""
    v_left = mass_velocity(inv_mass, r_left)
    v_right = mass_velocity(inv_mass, r_right)
    return (torch.sum(r_sum * v_left, dim=-1) < 0) | (torch.sum(r_sum * v_right, dim=-1) < 0)


# ---------------------------------------------------------------------------
# One transition, batched over chains
# ---------------------------------------------------------------------------


@dataclass
class NutsNoise:
    """The random inputs of one transition for C chains; leaf k of the
    lock-step build reads row k of the (L, C) tensors, L = 2^max_depth - 1."""

    r0: Any  # (C, d) root momenta
    go_right0: Any  # (C,) bool: direction of the first doubling
    log_u_sel: Any  # (L, C) log-uniforms: progressive sampling in a subtree
    log_u_bias: Any  # (L, C) log-uniforms: the biased swap into the tree
    go_right: Any  # (L, C) bool: direction of the doubling after a completion


def draw_nuts_noise(generator: torch.Generator, inv_mass, n_chains: int,
                    max_depth: int) -> NutsNoise:
    """Every draw of one transition: momenta, the first direction, and one
    (L, C, 3) block of uniforms U in [0, 1) for the leaves."""
    d, dt, dev = inv_mass.shape[0], inv_mass.dtype, inv_mass.device
    r0 = mass_draw_momentum(generator, inv_mass, (n_chains, d))
    u0 = torch.rand((n_chains,), generator=generator, device=dev, dtype=dt)
    u = torch.rand(((1 << max_depth) - 1, n_chains, 3), generator=generator,
                   device=dev, dtype=dt)
    return NutsNoise(r0=r0, go_right0=u0 < 0.5, log_u_sel=torch.log1p(-u[..., 0]),
                     log_u_bias=torch.log1p(-u[..., 1]), go_right=u[..., 2] < 0.5)


def _where(mask, a, b):
    """torch.where with a (C,) mask against (C, ...) tensors."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim())), a, b)


def nuts_transition(
    potential_fn: Callable,
    q,
    noise: NutsNoise,
    eps,
    inv_mass,
    max_depth: int = 8,
    max_delta_energy: float = 1000.0,
    record: bool = False,
):
    """One NUTS transition for a batch of chains ``q`` (C, d).

    ``eps`` is a scalar or (C,) step size; ``noise`` holds every draw. One
    batched value-and-grad at the root, then one per lock-step leaf until
    every chain has stopped (U-turn, sub-U-turn or divergence) or the tree
    reaches ``max_depth``.

    Returns ``(q_new, info)``: per chain the acceptance statistic (mean
    Metropolis probability over the chain's leaves, divergent or NaN leaves
    counting 0), tree depth (completed doublings), divergence flag and
    leapfrog count; and as Python ints ``leaves`` (the lock-step leaves
    run, the batch maximum) and ``host_syncs`` (host reads). ``record``
    adds the leaf-ordered ``trajectory`` (2^max_depth, C, d) and
    ``hamiltonians`` (2^max_depth, C), NaN past each chain's last leaf, and
    the ``initial_energy`` (C,).
    """
    c, d = q.shape
    dt, dev = q.dtype, q.device
    force_fn = batched_force(potential_fn)
    e = _per_chain(eps)
    neg_inf = torch.tensor(-torch.inf, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    r0 = noise.r0
    g0, u0 = force_fn(q)
    h0 = u0 + mass_kinetic(inv_mass, r0)
    direction = torch.where(noise.go_right0, 1.0, -1.0).to(dt)

    z, r, g = q, r0, g0  # walker
    z_l, r_l, g_l = q, r0, g0  # whole-tree boundaries
    z_r, r_r, g_r = q, r0, g0
    z_cand, log_w_tree, r_sum_tree = q, torch.zeros((c,), dtype=dt, device=dev), r0
    z_cand_sub = q  # current-subtree accumulators
    log_w_sub = torch.full((c,), -torch.inf, dtype=dt, device=dev)
    r_sum_sub = torch.zeros_like(q)
    rc = torch.zeros((c, max_depth + 1, d), dtype=dt, device=dev)  # first-leaf momenta
    sc = torch.zeros_like(rc)  # r_sum before each first leaf
    sum_accept = torch.zeros((c,), dtype=dt, device=dev)
    n_leaves = torch.zeros((c,), dtype=dt, device=dev)
    depth_c = torch.zeros((c,), dtype=torch.int32, device=dev)
    diverging = torch.zeros((c,), dtype=torch.bool, device=dev)
    active = torch.ones((c,), dtype=torch.bool, device=dev)
    if record:
        traj = torch.full((1 << max_depth, c, d), torch.nan, dtype=dt, device=dev)
        traj_h = torch.full((1 << max_depth, c), torch.nan, dtype=dt, device=dev)

    depth, n, k, syncs = 0, 0, 0, 0  # shared by every running chain
    while depth < max_depth:
        # one leapfrog step of every walker
        eps_s = direction[:, None] * e
        r_half = r - 0.5 * eps_s * g
        z_new = z + eps_s * mass_velocity(inv_mass, r_half)
        g_new, u_new = force_fn(z_new)
        r_new = r_half - 0.5 * eps_s * g_new
        v_new = mass_velocity(inv_mass, r_new)
        h_new = u_new + 0.5 * torch.sum(r_new * v_new, dim=-1)
        delta = h0 - h_new
        leaf_div = (~torch.isfinite(delta)) | (-delta > max_delta_energy)
        log_w_leaf = torch.where(leaf_div, neg_inf, delta)
        if record:
            traj[k] = _where(active, z_new, traj[k])
            traj_h[k] = torch.where(active, h_new, traj_h[k])

        # checkpoint push at even leaves: this leaf starts nested subtrees
        if n % 2 == 0:
            slot = _popcount(n)
            rc[:, slot] = _where(active, r_new, rc[:, slot])
            sc[:, slot] = _where(active, r_sum_sub, sc[:, slot])
        r_sum_sub = _where(active, r_sum_sub + r_new, r_sum_sub)

        # progressive multinomial candidate within the subtree
        log_w_sub_new = torch.logaddexp(log_w_sub, log_w_leaf)
        take = active & (noise.log_u_sel[k] < log_w_leaf - log_w_sub_new)
        z_cand_sub = _where(take, z_new, z_cand_sub)
        log_w_sub = torch.where(active, log_w_sub_new, log_w_sub)

        leaf_accept = torch.where(
            leaf_div, zero, torch.clamp(torch.exp(torch.clamp(delta, max=50.0)), max=1.0))
        sum_accept = sum_accept + torch.where(
            active & torch.isfinite(leaf_accept), leaf_accept, zero)
        n_leaves = n_leaves + active.to(dt)
        diverging = diverging | (active & leaf_div)

        fail = leaf_div
        if n % 2 == 1:  # sub-U-turns of the t nested subtrees this leaf completes
            pc = _popcount(n)
            lo = pc - _trailing_ones(n)
            sub_sums = r_sum_sub[:, None, :] - sc[:, lo:pc]
            v_starts = mass_velocity(inv_mass, rc[:, lo:pc])
            bad = (torch.sum(sub_sums * v_starts, dim=-1) < 0) | (
                torch.sum(sub_sums * v_new[:, None, :], dim=-1) < 0)
            fail = fail | torch.any(bad, dim=-1)

        if n + 1 == (1 << depth):
            # the doubling completes: extend the boundary the walker grew,
            # bias-swap the candidate, merge the accumulators
            complete = active & ~fail
            going_right = direction > 0
            upd_l, upd_r = complete & ~going_right, complete & going_right
            z_l, r_l, g_l = (_where(upd_l, a, b) for a, b in
                             ((z_new, z_l), (r_new, r_l), (g_new, g_l)))
            z_r, r_r, g_r = (_where(upd_r, a, b) for a, b in
                             ((z_new, z_r), (r_new, r_r), (g_new, g_r)))
            accept_new = noise.log_u_bias[k] < log_w_sub - log_w_tree
            z_cand = _where(complete & accept_new, z_cand_sub, z_cand)
            log_w_tree = torch.where(complete, torch.logaddexp(log_w_tree, log_w_sub),
                                     log_w_tree)
            r_sum_tree = _where(complete, r_sum_tree + r_sum_sub, r_sum_tree)
            tree_turn = complete & _uturn(r_sum_tree, r_l, r_r, inv_mass)
            depth_c = depth_c + complete.to(torch.int32)

            # start the next subtree: a fresh direction, the walker jumps to
            # the boundary on that side
            start_next = complete & ~tree_turn
            direction = torch.where(start_next, torch.where(noise.go_right[k], 1.0, -1.0).to(dt),
                                    direction)
            next_right = direction > 0
            z_b, r_b, g_b = (_where(next_right, a, b) for a, b in
                             ((z_r, z_l), (r_r, r_l), (g_r, g_l)))
            z, r, g = (_where(start_next, a, _where(active, b, old)) for a, b, old in
                       ((z_b, z_new, z), (r_b, r_new, r), (g_b, g_new, g)))
            z_cand_sub = _where(start_next, z, z_cand_sub)
            log_w_sub = torch.where(start_next, neg_inf, log_w_sub)
            r_sum_sub = _where(start_next, torch.zeros_like(r_sum_sub), r_sum_sub)
            fail = fail | tree_turn
            depth, n = depth + 1, 0
        else:
            z, r, g = (_where(active, a, b) for a, b in ((z_new, z), (r_new, r), (g_new, g)))
            n += 1
        active = active & ~fail
        k += 1
        if depth < max_depth:
            syncs += 1
            if not bool(active.any()):
                break

    # every chain runs leaf 0, so n_leaves >= 1
    info = dict(accept_prob=sum_accept / n_leaves, depth=depth_c, diverging=diverging,
                n_leapfrog=n_leaves, leaves=k, host_syncs=syncs)
    if record:
        info.update(trajectory=traj, hamiltonians=traj_h, initial_energy=h0)
    return z_cand, info


# ---------------------------------------------------------------------------
# The warmup + sampling drive
# ---------------------------------------------------------------------------


@dataclass
class NUTSResult:
    samples: Dict[str, Any]
    positions: Any
    accept_prob: Any
    divergences: Any
    tree_depths: Any
    step_size: float
    inv_mass: Any
    final_positions: Any
    # exact total leapfrog (gradient-evaluation) count over warmup and
    # sampling, summed across chains: per-chain int32 counts on the device,
    # summed on the host in int64. Add one evaluation per transition (the
    # trajectory root) for the full model-evaluation count.
    n_leapfrogs: int = 0
    # lock-step leaves run (the batch maximum of each transition, summed over
    # transitions) and host reads made by the tree builds
    lockstep_leaves: int = 0
    host_syncs: int = 0


def make_nuts_drive(
    staged: StagedModel,
    config: NUTSConfig,
    n_chains: int,
    n_samples: int,
    n_warmup: int,
    *,
    discrete: Optional[Dict[str, Any]] = None,
    chain_group=None,
):
    """Build ``drive(q0, generator, eps_over=None, inv_mass_over=None) →
    (q_f, qs, aps, divs, depths, eps, inv_mass, n_leaps, counts)``; discrete
    sites are held at ``discrete`` (default: their discovery values).

    The same schedule as ``hmc.make_hmc_drive``: two warmup windows of dual
    averaging on the cross-chain mean of the trajectory-averaged acceptance
    statistic, the Welford mass (diagonal or dense) taken at the midpoint
    with the step size restarted from its average, ``rescue_stuck`` after
    each window, then sampling at the averaged step size. ``qs`` is
    (n_samples, C, d); ``aps``, ``divs`` and ``depths`` are (n_samples, C);
    ``n_leaps`` is each chain's int32 leapfrog count; ``counts`` holds the
    host ints ``leaves`` and ``host_syncs``. ``chain_group``: the sharded
    drive over this rank's ``n_chains`` (see ``hmc.make_hmc_drive``).
    """
    d = staged.dim
    dense = config.mass == "dense"

    def potential(z):
        return staged.potential(z, discrete)

    def drive(q0, generator: torch.Generator, eps_over=None, inv_mass_over=None):
        dt, dev = q0.dtype, q0.device
        if inv_mass_over is None:
            im0 = identity_mass(d, dense, dtype=dt, device=dev)
        else:
            im0 = torch.as_tensor(inv_mass_over, dtype=dt, device=dev)
        eps0 = initial_step_size(config, potential, q0, generator, im0, eps_over,
                                 chain_group)
        n_leaps = torch.zeros((n_chains,), dtype=torch.int32, device=dev)
        counts = {"leaves": 0, "host_syncs": 0}

        def step(q, eps, inv_mass):
            nonlocal n_leaps
            noise = draw_nuts_noise(generator, inv_mass, n_chains, config.max_depth)
            q, info = nuts_transition(potential, q, noise, eps, inv_mass, config.max_depth,
                                      config.max_delta_energy)
            n_leaps = n_leaps + info["n_leapfrog"].to(torch.int32)
            counts["leaves"] += info["leaves"]
            counts["host_syncs"] += info["host_syncs"]
            return q, info

        def warm_window(q, da, inv_mass, n_steps):
            welford = WelfordState.init(d, dense, dtype=dt, device=dev)
            ema = torch.full((n_chains,), 0.5, dtype=dt, device=dev)
            for _ in range(n_steps):
                eps = torch.exp(da.log_eps) if config.adapt_step_size else eps0
                q, info = step(q, eps, inv_mass)
                da = dual_averaging_update(
                    da, cross_mean(torch.mean(info["accept_prob"]), chain_group),
                    config.target_accept)
                welford = welford_push_batch(welford, q)
                ema = 0.9 * ema + 0.1 * info["accept_prob"]
            return rescue_stuck(q, ema, generator), da, welford

        q, da, inv_mass = q0, DualAveragingState.init(eps0), im0
        if n_warmup > 0:
            n_half = n_warmup // 2
            q, da, welford = warm_window(q, da, inv_mass, max(n_half, 1))
            if config.adapt_mass:
                welford = welford_merge_across(welford, chain_group)
                inv_mass = welford_covariance(welford) if dense else welford_variance(welford)
                da = DualAveragingState.init(torch.exp(da.log_eps_bar))
            q, da, _ = warm_window(q, da, inv_mass, max(n_warmup - n_half, 1))
        # adaptation off -> the configured eps (da.log_eps moves regardless)
        if config.adapt_step_size and n_warmup > 0:
            eps_final = torch.exp(da.log_eps_bar)
        else:
            eps_final = eps0

        qs = torch.empty((n_samples, n_chains, d), dtype=dt, device=dev)
        aps = torch.empty((n_samples, n_chains), dtype=dt, device=dev)
        divs = torch.empty((n_samples, n_chains), dtype=torch.bool, device=dev)
        depths = torch.empty((n_samples, n_chains), dtype=torch.int32, device=dev)
        for i in range(n_samples):
            q, info = step(q, eps_final, inv_mass)
            qs[i] = q
            aps[i] = info["accept_prob"]
            divs[i] = info["diverging"]
            depths[i] = info["depth"]
        return q, qs, aps, divs, depths, eps_final, inv_mass, n_leaps, counts

    return drive


def nuts_chain(
    seed: int,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 1000,
    config: NUTSConfig = NUTSConfig(),
    *,
    n_chains: int = 1,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    device="cuda",
    discrete: Optional[Dict[str, Any]] = None,
    resume: Optional[Any] = None,
    init_position: Optional[Any] = None,
    init_jitter: float = 0.05,
) -> NUTSResult:
    """NUTS with the same cross-chain warmup schedule as ``hmc_chain``.

    ``seed`` seeds one ``torch.Generator`` on the staged model's device,
    which draws every initial position, momentum and uniform.

    ``resume``: a previous ``NUTSResult`` (or any object with
    ``final_positions``, ``step_size`` and ``inv_mass``, such as
    ``interop.hmc_state_from_numpy`` of a JAX result): sampling continues
    from its final state with its step size and mass; warmup is skipped and
    adaptation frozen.

    ``init_position``: warm-start unconstrained position(s), a ``(d,)``
    point broadcast with per-chain jitter or an explicit ``(n_chains, d)``
    batch (see ``hmc_chain``).

    Discrete sites are held fixed at their discovery values or at
    ``discrete``.
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
    drive = make_nuts_drive(staged, config, n_chains, n_samples, n_warmup, discrete=discrete)
    q_f, qs, aps, divs, depths, eps_final, inv_mass_f, n_leaps, counts = drive(
        q0, generator, **overrides)
    positions = qs.movedim(0, 1)
    return NUTSResult(
        samples=constrain_positions(staged, positions),
        positions=positions,
        accept_prob=torch.mean(aps, dim=-1),
        divergences=divs.movedim(0, 1),
        tree_depths=depths.movedim(0, 1),
        step_size=float(eps_final),
        inv_mass=inv_mass_f,
        final_positions=q_f,
        n_leapfrogs=int(n_leaps.to(torch.int64).sum()),
        lockstep_leaves=counts["leaves"],
        host_syncs=counts["host_syncs"],
    )


# ---------------------------------------------------------------------------
# Incremental session
# ---------------------------------------------------------------------------


class NutsSession:
    """Stateful incremental NUTS for one chain, the dynamic-trajectory
    sibling of ``HmcSession``: holds (position, step_size, inv_mass) and a
    ``torch.Generator`` seeded by ``seed``. ``step()`` runs one transition;
    ``step_recorded()`` also returns the leaf-ordered trajectory and the
    Hamiltonian of each leaf."""

    def __init__(
        self,
        seed: int,
        model_fn: Optional[Callable] = None,
        config: NUTSConfig = NUTSConfig(),
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
            p = mass_draw_momentum(self._generator, self.inv_mass, (self.staged.dim,))
            self.step_size = float(find_reasonable_epsilon(
                self.staged.potential, self._q, p, self.inv_mass))
        self.max_depth = config.max_depth

    def _noise(self) -> NutsNoise:
        return draw_nuts_noise(self._generator, self.inv_mass, 1, self.max_depth)

    def set_step_size(self, eps: float) -> None:
        self.step_size = float(eps)

    @property
    def position(self):
        return self._q

    def warmup(self, n_steps: int = 100) -> None:
        """Dual-averaging step-size adaptation in place (``HmcSession.warmup``
        discipline)."""
        da = DualAveragingState.init(torch.tensor(self.step_size, dtype=torch.float64))
        for _ in range(n_steps):
            info = self.step()
            da = dual_averaging_update(da, torch.tensor(info["accept_prob"], dtype=torch.float64),
                                       self.config.target_accept)
            self.step_size = float(torch.exp(da.log_eps))
        self.step_size = float(torch.exp(da.log_eps_bar))

    def _advance(self, record: bool):
        q_new, info = nuts_transition(
            self.staged.potential, self._q[None], self._noise(), self.step_size,
            self.inv_mass, self.max_depth, self.config.max_delta_energy, record=record)
        self._q = q_new[0]
        out = {
            "accept_prob": float(info["accept_prob"][0]),
            "depth": int(info["depth"][0]),
            "diverging": bool(info["diverging"][0]),
            "n_leapfrog": int(info["n_leapfrog"][0]),
            "position": self._q.cpu().numpy(),
        }
        if record:
            n = out["n_leapfrog"]
            out["trajectory"] = info["trajectory"][:n, 0].cpu().numpy()
            out["hamiltonians"] = info["hamiltonians"][:n, 0].cpu().numpy()
            out["initial_energy"] = float(info["initial_energy"][0])
        return out

    def step(self):
        return self._advance(False)

    def step_recorded(self):
        """One transition returning the leaf-ordered trajectory (positions
        and Hamiltonians per leapfrog leaf, in integration order)."""
        return self._advance(True)
