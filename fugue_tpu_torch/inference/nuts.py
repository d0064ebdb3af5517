"""No-U-Turn Sampler, batched over chains.

The port of ``fugue_tpu/inference/nuts.py``: ``NUTSConfig``, the checkpoint
bit helpers and ``_uturn``, ``nuts_transition``, the asynchronous drive
(``make_nuts_drive_async``, the default, with ``_da_fractional_update``),
the lock-step ``"while"`` drive, ``NUTSResult``, ``nuts_chain`` and
``NutsSession``. Multinomial NUTS with progressive sampling biased toward the
fresh subtree, the generalized U-turn criterion, and the iterative tree build:
one leapfrog per leaf, a checkpoint stack of (momentum, running momentum sum)
at slot popcount(n) for even leaf n, and at odd leaf n the U-turn checks of
the t nested subtrees it completes (t = trailing one-bits of n), whose starts
sit at slots popcount(n) - t .. popcount(n) - 1.

The default drive (``loop=None`` or ``"async"``) runs transitions × tree
building as one host loop of iterations. Each iteration is one batched
value-and-grad of every chain (``batched_force``) and plain tensor
bookkeeping over (C,) leaf indices, depths and directions, with popcount and
trailing ones from lookup tables. A chain whose tree stops takes its draw and
starts its next transition in the same iteration, from the candidate's
carried potential and gradient, so each chain pays for its own trees and no
root evaluation is needed. The per-chain state is stacked into a few
tensors (``_V``, ``_S``, the checkpoint stacks), so the restart and the
phase mask are one ``torch.where`` each. Adaptation is fed by the chains
that finished each iteration: dual averaging on a fractional clock, a masked
Welford push (``hmc.welford_push_masked``), their EMAs. Sampling writes each
finished transition to the chain's next row with ``index_put_`` (the JAX
package's ring recorder, and its backpressure, exist only to avoid a TPU
scatter). A phase reads the chains still running to the host once per
``CHUNK`` = 16 iterations and at no other time. The draws come from a
``GeneratorDraws`` (one block per chunk) or any object with its methods.

The lock-step build (``loop="while"``, and ``sampling_loop="lockstep"``
after the async warmup), for C chains at once:

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

Both drives keep each chain's exact leapfrog count in int32 and sum it on
the host in int64 (``NUTSResult.n_leapfrogs``), and count the batched leaf
evaluations and the host reads they ran. While a profiler session runs,
each iteration of the async drive is a ``nuts.iteration`` span (the parent
of its ``potential`` span) and each host read names its site
(``utils.profiling``).

``make_nuts_drive(chain_group=...)`` is the sharded drive: only the
adaptation reduces over the process group (the ε₀ consensus, the midpoint's
Welford merge, and per warmup iteration of the async drive one all-reduce
of the finished count, acceptance sum and running chains; per transition
of the lock-step drive the acceptance mean); the trees stay on the rank.

Not ported: the ``"chunked"`` and ``"scan"`` loop modes, which work around
the TPU compiler, and the async sampling phase's ring recorder, which
works around the TPU's variable-row scatter.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional

import torch

from .. import settings
from ..parallel.mesh import cross_mean, cross_sum
from ..runtime.staging import StagedModel, stage
from ..utils import profiling
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
    mass_factor,
    mass_kinetic,
    mass_velocity,
    momentum_from_factor,
    rescue_stuck,
    start_positions,
    welford_covariance,
    welford_merge_across,
    welford_push_batch,
    welford_push_masked,
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
    # the drive: None or "async" (each chain runs its own transitions, one
    # leaf per iteration: make_nuts_drive_async), or "while" (one lock-step
    # tree build per transition, every chain waiting for the deepest)
    loop: Optional[str] = None
    # the async drive's sampling phase: None or "ring" (asynchronous, each
    # chain's draws written to its own rows), or "lockstep" (one lock-step
    # tree build per transition after the asynchronous warmup)
    sampling_loop: Optional[str] = None

    def __post_init__(self):
        if self.loop not in (None, "async", "while"):
            raise ValueError(
                f"loop {self.loop!r} is not ported ('scan' and 'chunked' work around "
                "the TPU compiler); use None or 'async', or 'while'"
            )
        if self.sampling_loop not in (None, "ring", "lockstep"):
            raise ValueError(f"unknown sampling_loop {self.sampling_loop!r}; "
                             "use None or 'ring', or 'lockstep'")
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
            profiling.host_read("nuts.lockstep.any_active")
            if not bool(active.any()):
                break

    # every chain runs leaf 0, so n_leaves >= 1
    info = dict(accept_prob=sum_accept / n_leaves, depth=depth_c, diverging=diverging,
                n_leapfrog=n_leaves, leaves=k, host_syncs=syncs)
    if record:
        info.update(trajectory=traj, hamiltonians=traj_h, initial_energy=h0)
    return z_cand, info


# ---------------------------------------------------------------------------
# The asynchronous drive: each chain runs its own transitions
# ---------------------------------------------------------------------------


CHUNK = 16  # iterations between two host reads of the chains still running


def _da_fractional_update(state: DualAveragingState, accept_mean, dc, target: float = 0.8,
                          gamma: float = 0.05, t0: float = 10.0,
                          kappa: float = 0.75) -> DualAveragingState:
    """Dual averaging on a continuous transition clock: an iteration of the
    asynchronous drive advances the clock by ``dc``, the transitions that
    finished over the chains (a 0-dim tensor in [0, 1]), and the weights
    scale with it. dc == 1 is ``dual_averaging_update``; dc == 0 leaves the
    state as it was. The clock ``t`` becomes a device tensor."""
    m = state.t + dc
    eta_h = dc / (m + t0)
    h_bar = (1.0 - eta_h) * state.h_bar + eta_h * (target - accept_mean)
    log_eps = state.mu - torch.sqrt(m) / gamma * h_bar
    eta = torch.clamp(dc * torch.pow(torch.clamp(m, min=1e-6), -kappa), 0.0, 1.0)
    log_eps_bar = eta * log_eps + (1.0 - eta) * state.log_eps_bar
    moved = dc > 0
    return DualAveragingState(
        log_eps=torch.where(moved, log_eps, state.log_eps),
        log_eps_bar=torch.where(moved, log_eps_bar, state.log_eps_bar),
        h_bar=torch.where(moved, h_bar, state.h_bar), mu=state.mu,
        t=torch.where(moved, m, state.t))


class GeneratorDraws:
    """The asynchronous drive's random inputs, from one ``torch.Generator``.

    Per phase (``which``: 0 and 1 the warmup windows, 2 sampling) the drive
    asks ``start`` for every chain's first tree, then per iteration ``leaf(i,
    active)`` before the leapfrog and ``restart(i, completed)`` for the
    trees that start after it, and after each warmup window ``donors`` for
    the rescue. Per chunk of ``CHUNK`` iterations one (CHUNK, C, 4) block
    of uniforms U in [0, 1) (selection, bias, the next doubling's
    direction, a new tree's first direction) and one (CHUNK, C, d) block of
    normals (a new tree's momenta) are drawn, whatever the masks, with no
    host read; log-uniforms are log(1 - U). A test hands the drive another
    object with these methods."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def _draw(self, fn, shape):
        return fn(shape, generator=self.generator, device=self._like.device,
                  dtype=self._like.dtype)

    def start(self, which: int, q):
        """(C, d) normals and (C,) directions (True: right) of every chain's
        first tree in phase ``which``; ``q`` is the (C, d) positions."""
        self._like = q
        return self._draw(torch.randn, q.shape), self._draw(torch.rand, q.shape[:1]) < 0.5

    def leaf(self, i: int, active):
        """(log_u_sel, log_u_bias, go_right), each (C,), of the phase's
        iteration ``i``."""
        j = i % CHUNK
        if j == 0:
            u = self._draw(torch.rand, (CHUNK, active.shape[0], 4))
            self._logs, self._right = torch.log1p(-u[..., :2]), u[..., 2:] < 0.5
            self._normals = self._draw(torch.randn, (CHUNK,) + tuple(self._like.shape))
        return self._logs[j, :, 0], self._logs[j, :, 1], self._right[j, :, 0]

    def restart(self, i: int, completed):
        """(C, d) normals and (C,) first directions of the trees that start
        after iteration ``i``."""
        j = i % CHUNK
        return self._normals[j], self._right[j, :, 1]

    def donors(self, ema, which: int):
        """Each chain's rescue donor, drawn with probability ∝ its EMA."""
        return torch.multinomial(ema + 1e-6, ema.shape[0], replacement=True,
                                 generator=self.generator)


def _draws_for(source):
    return GeneratorDraws(source) if isinstance(source, torch.Generator) else source


# The per-chain state of the asynchronous drive, stacked so that each masked
# update is one torch.where: (C, len(_V), d) vectors, (C, len(_S)) scalars
# (the depth, the leaf index and the divergence flag as exact small floats)
# and the (C, 2, max_depth + 1, d) checkpoint stacks (first-leaf momenta,
# running sums before them). "q", "g_q", "u_q": the chain's last draw.
_V = ("z", "r", "g", "z_l", "r_l", "g_l", "z_r", "r_r", "g_r", "z_cand", "g_cand",
      "z_cand_sub", "g_cand_sub", "r_sum_tree", "r_sum_sub", "q", "g_q")
_S = ("log_w_tree", "log_w_sub", "sum_accept", "n_leaves", "h0", "eps", "direction",
      "u_cand", "u_cand_sub", "u_q", "depth", "n", "diverging")
V_ = {k: i for i, k in enumerate(_V)}
S_ = {k: i for i, k in enumerate(_S)}
# a new tree's _V from (q, r0, g, 0)
_FRESH = (0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 2, 0, 2, 1, 3, 0, 2)


@dataclass
class _Trees:
    V: Any
    S: Any
    CK: Any


def _slot_tables(max_depth: int):
    """Per leaf index n < 2^max_depth, over the max_depth + 1 checkpoint
    slots: the slot an even leaf pushes to (popcount(n)), and the slots an
    odd leaf checks (popcount(n) - trailing_ones(n) .. popcount(n) - 1)."""
    push, check = [], []
    for n in range(1 << max_depth):
        pc, low = _popcount(n), _popcount(n) - _trailing_ones(n)
        push.append([n % 2 == 0 and k == pc for k in range(max_depth + 1)])
        check.append([n % 2 == 1 and low <= k < pc for k in range(max_depth + 1)])
    return push, check


class _AsyncBuild:
    """One iteration of every chain's tree build: the JAX package's
    ``leaf_step`` and ``advance_chain`` over (C,) tensors of leaf index,
    depth and direction; the checkpoint slots of a leaf index (popcount
    and trailing ones) from lookup tables of 2^max_depth rows."""

    def __init__(self, force_fn, max_depth: int, max_delta_energy: float, dt, dev):
        self.force_fn, self.max_depth, self.max_de = force_fn, max_depth, max_delta_energy
        push, check = _slot_tables(max_depth)
        self.push = torch.tensor(push, device=dev)
        self.check = torch.tensor(check, device=dev)
        self.size = torch.tensor([float(1 << j) for j in range(max_depth + 1)], dtype=dt,
                                 device=dev)
        self.fresh = torch.tensor(_FRESH, device=dev)
        self.neg_inf = torch.tensor(-torch.inf, dtype=dt, device=dev)
        self.right, self.left = (torch.tensor(x, dtype=dt, device=dev) for x in (1.0, -1.0))
        # a new tree's scalars but for h0, eps, direction and the potentials
        base = torch.zeros(len(_S), dtype=dt, device=dev)
        base[S_["log_w_sub"]] = -torch.inf
        self.base = base
        self.fresh_cols = torch.tensor([S_[k] for k in ("h0", "eps", "direction", "u_cand",
                                                        "u_cand_sub", "u_q")], device=dev)

    def _fresh(self, q, u, g, normals, go_right, eps, factor, inv_mass):
        """(V, S) of new trees at (q, U(q), ∇U(q)), their momenta from the
        normals through the phase's mass factor."""
        r0 = momentum_from_factor(factor, normals)
        V = torch.stack([q, r0, g, torch.zeros_like(q)], dim=1)[:, self.fresh]
        cols = torch.stack([u + mass_kinetic(inv_mass, r0), eps.expand(u.shape),
                            torch.where(go_right, self.right, self.left), u, u, u], dim=1)
        S = self.base.expand(u.shape[0], -1).index_copy(1, self.fresh_cols, cols)
        return V, S

    def start(self, q, u, g, normals, go_right, eps, factor, inv_mass) -> _Trees:
        """Every chain's first tree."""
        c, d = q.shape
        V, S = self._fresh(q, u, g, normals, go_right, eps, factor, inv_mass)
        return _Trees(V, S, torch.zeros((c, 2, self.max_depth + 1, d), dtype=q.dtype,
                                        device=q.device))

    def iterate(self, trees: _Trees, active, leaf_draws, restart, eps, factor, inv_mass):
        """One leapfrog of every chain (one batched model run), then a new
        tree at step size ``eps`` for each active chain whose transition
        ended; ``restart(completed)`` gives the new trees' draws. Chains
        not ``active`` keep their state. Returns (trees, completed, and per
        chain the acceptance statistic, depth and divergence flag of the
        transition as it stood)."""
        V, S, CK = trees.V, trees.S, trees.CK
        c, _, d = V.shape
        log_sel, log_bias, right_next = leaf_draws
        direction, depth, n = S[:, S_["direction"]], S[:, S_["depth"]], S[:, S_["n"]]

        eps_s = (direction * S[:, S_["eps"]])[:, None]
        half = 0.5 * eps_s
        r_half = V[:, V_["r"]] - half * V[:, V_["g"]]
        z_new = V[:, V_["z"]] + eps_s * mass_velocity(inv_mass, r_half)
        g_new, u_new = self.force_fn(z_new)
        r_new = r_half - half * g_new
        v_new = mass_velocity(inv_mass, r_new)
        delta = S[:, S_["h0"]] - (u_new + 0.5 * torch.sum(r_new * v_new, dim=-1))
        # divergent: NaN, +-inf, or an energy error past the cap
        leaf_div = ~((delta >= -self.max_de) & (delta < torch.inf))
        log_w_leaf = torch.where(leaf_div, self.neg_inf, delta)

        # checkpoint push at even leaves: slot popcount(n) takes the leaf's
        # momentum and the subtree's running sum before it
        ni = n.long()
        r_sum_sub = V[:, V_["r_sum_sub"]]
        CK = torch.where(self.push[ni][:, None, :, None],
                         torch.stack([r_new, r_sum_sub], dim=1)[:, :, None, :], CK)
        r_sum_sub = r_sum_sub + r_new

        # progressive multinomial candidate within the subtree, with its
        # potential and gradient
        log_w_sub = torch.logaddexp(S[:, S_["log_w_sub"]], log_w_leaf)
        take = log_sel < log_w_leaf - log_w_sub
        cand_sub = _where(take, torch.stack([z_new, g_new], dim=1),
                          V[:, V_["z_cand_sub"]:V_["g_cand_sub"] + 1])
        u_cand_sub = torch.where(take, u_new, S[:, S_["u_cand_sub"]])
        # finite: a leaf that is not divergent has a finite delta
        leaf_accept = torch.where(
            leaf_div, 0.0, torch.clamp(torch.exp(torch.clamp(delta, max=50.0)), max=1.0))
        sum_accept = S[:, S_["sum_accept"]] + leaf_accept
        n_leaves = S[:, S_["n_leaves"]] + 1.0

        # sub-U-turns of the subtrees an odd leaf completes, at slots
        # popcount(n) - trailing_ones(n) .. popcount(n) - 1
        sub_sums = r_sum_sub[:, None, :] - CK[:, 1]
        bad = (torch.sum(sub_sums * mass_velocity(inv_mass, CK[:, 0]), dim=-1) < 0) | (
            torch.sum(sub_sums * v_new[:, None, :], dim=-1) < 0)
        fail = torch.any(self.check[ni] & bad, dim=-1) | leaf_div
        n_new = n + 1.0
        complete = (n_new == self.size[depth.long()]) & ~fail

        # the doubling completes: extend the boundary the walker grew,
        # bias-swap the candidate, merge the accumulators
        going_right = direction > 0
        upd = torch.stack([complete & ~going_right, complete & going_right], dim=1)
        zrg_new = torch.stack([z_new, r_new, g_new], dim=1)
        bounds = torch.where(upd[:, :, None, None], zrg_new[:, None],
                             V[:, V_["z_l"]:V_["g_r"] + 1].reshape(c, 2, 3, d))
        take_tree = complete & (log_bias < log_w_sub - S[:, S_["log_w_tree"]])
        cand = _where(take_tree, cand_sub, V[:, V_["z_cand"]:V_["g_cand"] + 1])
        u_cand = torch.where(take_tree, u_cand_sub, S[:, S_["u_cand"]])
        log_w_tree = torch.where(complete, torch.logaddexp(S[:, S_["log_w_tree"]], log_w_sub),
                                 S[:, S_["log_w_tree"]])
        r_sum_tree = _where(complete, V[:, V_["r_sum_tree"]] + r_sum_sub,
                            V[:, V_["r_sum_tree"]])
        tree_turn = complete & _uturn(r_sum_tree, bounds[:, 0, 1], bounds[:, 1, 1], inv_mass)
        depth = depth + complete

        # the next subtree: a fresh direction, the walker jumps to the
        # boundary on that side
        start_next = complete & ~tree_turn
        direction = torch.where(start_next, torch.where(right_next, self.right, self.left),
                                direction)
        walker = _where(start_next, _where(direction > 0, bounds[:, 1], bounds[:, 0]), zrg_new)
        cand_sub = torch.cat(
            [_where(start_next, walker[:, :1], cand_sub[:, :1]), cand_sub[:, 1:]], dim=1)
        log_w_sub = torch.where(start_next, self.neg_inf, log_w_sub)
        r_sum_sub = _where(start_next, torch.zeros_like(r_sum_sub), r_sum_sub)
        n_new = torch.where(start_next, 0.0, n_new)
        diverging = torch.where(leaf_div, 1.0, S[:, S_["diverging"]])

        # the transition ends: the candidate is the chain's draw, and its
        # next tree starts there
        completed = active & (fail | tree_turn | (depth >= self.max_depth))
        accept_stat = sum_accept / n_leaves
        qg = _where(completed, cand, V[:, V_["q"]:V_["g_q"] + 1])
        u_q = torch.where(completed, u_cand, S[:, S_["u_q"]])
        V1 = torch.cat([walker, bounds.reshape(c, 6, d), cand, cand_sub, r_sum_tree[:, None],
                        r_sum_sub[:, None], qg], dim=1)
        S1 = torch.stack([log_w_tree, log_w_sub, sum_accept, n_leaves, S[:, S_["h0"]],
                          S[:, S_["eps"]], direction, u_cand, u_cand_sub, u_q, depth, n_new,
                          diverging], dim=1)
        normals, go_right = restart(completed)
        V_f, S_f = self._fresh(qg[:, 0], u_q, qg[:, 1], normals, go_right, eps, factor, inv_mass)
        V = _where(completed, V_f, _where(active, V1, V))
        S = _where(completed, S_f, _where(active, S1, S))
        CK = _where(active, CK, trees.CK)
        return _Trees(V, S, CK), completed, accept_stat, depth, diverging


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
    # summed on the host in int64; the async drive counts active chains'
    # leapfrogs only. Add one evaluation per transition (the trajectory
    # root; the async drive's restarts carry it over) for bench_nuts's count.
    n_leapfrogs: int = 0
    # batched leaf evaluations the drive ran (each one batched model run):
    # the lock-step leaves (each transition's batch maximum, summed), or the
    # async drive's iterations; warmup_leaves: those of warmup; host_syncs:
    # host reads of the tree builds or of the async loop
    lockstep_leaves: int = 0
    host_syncs: int = 0
    warmup_leaves: int = 0


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
    ``config.loop`` picks the build: None or "async" is
    ``make_nuts_drive_async``; "while", described here, runs one lock-step
    ``nuts_transition`` of every chain per transition.

    The same schedule as ``hmc.make_hmc_drive``: two warmup windows of dual
    averaging on the cross-chain mean of the trajectory-averaged acceptance
    statistic, the Welford mass (diagonal or dense) taken at the midpoint
    with the step size restarted from its average, ``rescue_stuck`` after
    each window, then sampling at the averaged step size. ``qs`` is
    (n_samples, C, d); ``aps``, ``divs`` and ``depths`` are (n_samples, C);
    ``n_leaps`` is each chain's int32 leapfrog count; ``counts`` holds the
    host ints ``leaves``, ``warmup_leaves`` and ``host_syncs``. ``chain_group``: the sharded
    drive over this rank's ``n_chains`` (see ``hmc.make_hmc_drive``).
    """
    if config.loop in (None, "async"):
        return make_nuts_drive_async(staged, config, n_chains, n_samples, n_warmup,
                                     discrete=discrete, chain_group=chain_group)
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
        counts = {"leaves": 0, "warmup_leaves": 0, "host_syncs": 0}

        def step(q, eps, inv_mass):
            nonlocal n_leaps
            q, info, n_leaps = _lockstep_step(potential, config, q, generator, eps, inv_mass,
                                              n_leaps, counts)
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
        counts["warmup_leaves"] = counts["leaves"]
        # adaptation off -> the configured eps (da.log_eps moves regardless)
        if config.adapt_step_size and n_warmup > 0:
            eps_final = torch.exp(da.log_eps_bar)
        else:
            eps_final = eps0
        q, qs, aps, divs, depths, n_leaps = _sample_lockstep(
            potential, config, q, generator, eps_final, inv_mass, n_samples, n_leaps, counts)
        return q, qs, aps, divs, depths, eps_final, inv_mass, n_leaps, counts

    return drive


def _lockstep_step(potential, config, q, generator, eps, inv_mass, n_leaps, counts):
    """One lock-step ``nuts_transition`` of every chain from the generator's
    draws: (q, info, n_leaps), its leaves and host reads added to ``counts``."""
    noise = draw_nuts_noise(generator, inv_mass, q.shape[0], config.max_depth)
    q, info = nuts_transition(potential, q, noise, eps, inv_mass, config.max_depth,
                              config.max_delta_energy)
    counts["leaves"] += info["leaves"]
    counts["host_syncs"] += info["host_syncs"]
    return q, info, n_leaps + info["n_leapfrog"].to(torch.int32)


def _sample_lockstep(potential, config, q, generator, eps, inv_mass, n_samples, n_leaps,
                     counts):
    """``n_samples`` lock-step transitions: (q, qs, aps, divs, depths, n_leaps)."""
    c, d = q.shape
    qs = torch.empty((n_samples, c, d), dtype=q.dtype, device=q.device)
    aps = torch.empty((n_samples, c), dtype=q.dtype, device=q.device)
    divs = torch.empty((n_samples, c), dtype=torch.bool, device=q.device)
    depths = torch.empty((n_samples, c), dtype=torch.int32, device=q.device)
    for i in range(n_samples):
        q, info, n_leaps = _lockstep_step(potential, config, q, generator, eps, inv_mass,
                                          n_leaps, counts)
        qs[i] = q
        aps[i] = info["accept_prob"]
        divs[i] = info["diverging"]
        depths[i] = info["depth"]
    return q, qs, aps, divs, depths, n_leaps


def _rescue(q, ema, donors):
    """Warmup-only cross-chain rescue: a chain whose acceptance EMA fell
    below 0.1 copies its donor's position."""
    return torch.where((ema < 0.1)[:, None], q[donors], q)


def make_nuts_drive_async(
    staged: StagedModel,
    config: NUTSConfig,
    n_chains: int,
    n_samples: int,
    n_warmup: int,
    *,
    discrete: Optional[Dict[str, Any]] = None,
    chain_group=None,
):
    """The asynchronous drive, the default: ``drive(q0, draws, eps_over=None,
    inv_mass_over=None)`` with the lock-step drive's results (``draws``: a
    ``GeneratorDraws``, or a ``torch.Generator`` to wrap in one).

    Transitions × tree building are one host loop of iterations; each
    iteration advances every chain by one leapfrog (one batched model run),
    and a chain whose tree stops takes its candidate as its draw and starts
    its next transition in the same iteration, from the candidate's carried
    potential and gradient. Each chain pays for its own trees. Warmup: two
    windows as in ``make_nuts_drive``, with dual averaging on the fractional
    clock of the chains that finished each iteration
    (``_da_fractional_update``), their acceptance mean, a masked Welford
    push and their EMAs; the rescue after each window, the mass at the
    midpoint with dual averaging restarted from its average. Sampling runs
    at the averaged step size and writes each finished transition to row
    ``t[c]`` of chain c (``index_put_``, the row clamped, the old value kept
    where the chain did not finish). Each phase reads the chains still
    running to the host once per ``CHUNK`` iterations, and never else; the
    iterations after the last chain finished are run and counted.

    ``chain_group``: each warmup iteration's finished count, acceptance sum
    and running chains are one ``cross_sum``, so every rank runs the same
    iterations and adapts the same ε; the midpoint merges the Welford
    moments. Sampling calls no collective."""
    d = staged.dim
    dense = config.mass == "dense"

    def potential(z):
        return staged.potential(z, discrete)

    force_fn = batched_force(potential)

    def drive(q0, source, eps_over=None, inv_mass_over=None):
        draws = _draws_for(source)
        dt, dev = q0.dtype, q0.device
        build = _AsyncBuild(force_fn, config.max_depth, config.max_delta_energy, dt, dev)
        if inv_mass_over is None:
            im0 = identity_mass(d, dense, dtype=dt, device=dev)
        else:
            im0 = torch.as_tensor(inv_mass_over, dtype=dt, device=dev)
        eps0 = initial_step_size(config, potential, q0, getattr(draws, "generator", None), im0,
                                 eps_over, chain_group)
        n_leaps = torch.zeros((n_chains,), dtype=torch.int32, device=dev)
        counts = {"leaves": 0, "warmup_leaves": 0, "host_syncs": 0}

        def start(q, which, eps, factor, inv_mass):
            g, u = force_fn(q)
            normals, go_right = draws.start(which, q)
            return build.start(q, u, g, normals, go_right, eps, factor, inv_mass)

        def run_phase(q, da, inv_mass, n_phase, which, total):
            """One warmup window of ``n_phase`` transitions per chain: (the
            chains' last draws, their acceptance EMAs, da, the Welford
            moments of the window's draws)."""
            ema = torch.full((n_chains,), 0.5, dtype=dt, device=dev)
            welford = WelfordState.init(d, dense, dtype=dt, device=dev)
            if n_phase == 0:
                return q, ema, da, welford
            factor = mass_factor(inv_mass)
            eps_start = torch.exp(da.log_eps)
            trees = start(q, which, eps_start, factor, inv_mass)
            t = torch.zeros((n_chains,), dtype=torch.int32, device=dev)
            i = 0
            while True:
                for _ in range(CHUNK):
                    with profiling.span("nuts.iteration"):
                        eps = torch.exp(da.log_eps) if config.adapt_step_size else eps_start
                        active = t < n_phase
                        trees, completed, accept, _, _ = build.iterate(
                            trees, active, draws.leaf(i, active),
                            lambda done: draws.restart(i, done), eps, factor, inv_mass)
                        t = t + completed
                        done = completed.to(dt)
                        # finished chains, their acceptance sum, chains still running
                        sums = cross_sum(torch.stack(
                            [done, accept * done, (t < n_phase).to(dt)], dim=1).sum(dim=0),
                            chain_group)
                        da = _da_fractional_update(da, sums[1] / torch.clamp(sums[0], min=1.0),
                                                   sums[0] / total, config.target_accept)
                        q = trees.V[:, V_["q"]]
                        welford = welford_push_masked(welford, q, completed)
                        ema = torch.where(completed, 0.9 * ema + 0.1 * accept, ema)
                        n_leaps.add_(active)
                        i += 1
                counts["host_syncs"] += 1
                profiling.host_read("nuts.warmup.any_running")
                if not bool(sums[2] > 0):
                    break
            counts["leaves"] += i
            counts["warmup_leaves"] += i
            return q, ema, da, welford

        def run_sampling(q, eps, inv_mass):
            """(final positions, the (n_samples, C, d + 3) rows of draws,
            acceptance statistics, divergence flags and depths)."""
            rec = torch.zeros((n_samples, n_chains, d + 3), dtype=dt, device=dev)
            if n_samples == 0:
                return q, rec
            factor = mass_factor(inv_mass)
            trees = start(q, 2, eps, factor, inv_mass)
            t = torch.zeros((n_chains,), dtype=torch.int64, device=dev)
            cols = torch.arange(n_chains, device=dev)
            i = 0
            while True:
                for _ in range(CHUNK):
                    with profiling.span("nuts.iteration"):
                        active = t < n_samples
                        trees, completed, accept, depth, diverging = build.iterate(
                            trees, active, draws.leaf(i, active),
                            lambda done: draws.restart(i, done), eps, factor, inv_mass)
                        rows = torch.clamp(t, max=n_samples - 1)
                        new = torch.cat([trees.V[:, V_["q"]],
                                         torch.stack([accept, diverging, depth], dim=1)], dim=1)
                        rec.index_put_((rows, cols), _where(completed, new, rec[rows, cols]))
                        t = t + completed
                        n_leaps.add_(active)
                        i += 1
                counts["host_syncs"] += 1
                profiling.host_read("nuts.sampling.any_running")
                if not bool(torch.any(t < n_samples)):
                    break
            counts["leaves"] += i
            return trees.V[:, V_["q"]], rec

        q, da, inv_mass = q0, DualAveragingState.init(eps0), im0
        if n_warmup > 0:
            total = cross_sum(torch.tensor(float(n_chains), dtype=dt, device=dev), chain_group)
            n_half = n_warmup // 2
            q, ema, da, welford = run_phase(q, da, inv_mass, n_half, 0, total)
            q = _rescue(q, ema, draws.donors(ema, 0))
            if config.adapt_mass:
                welford = welford_merge_across(welford, chain_group)
                inv_mass = welford_covariance(welford) if dense else welford_variance(welford)
                da = DualAveragingState.init(torch.exp(da.log_eps_bar))
            if not config.adapt_step_size:
                da = DualAveragingState.init(eps0)
            q, ema, da, _ = run_phase(q, da, inv_mass, n_warmup - n_half, 1, total)
            q = _rescue(q, ema, draws.donors(ema, 1))
        # adaptation off -> the configured eps (da.log_eps moves regardless)
        if config.adapt_step_size and n_warmup > 0:
            eps_final = torch.exp(da.log_eps_bar)
        else:
            eps_final = eps0

        if config.sampling_loop == "lockstep":
            q_f, qs, aps, divs, depths, n_leaps = _sample_lockstep(
                potential, config, q, draws.generator, eps_final, inv_mass, n_samples, n_leaps,
                counts)
        else:
            q_f, rec = run_sampling(q, eps_final, inv_mass)
            qs, aps = rec[..., :d], rec[..., d]
            divs, depths = rec[..., d + 1] > 0, rec[..., d + 2].to(torch.int32)
        return q_f, qs, aps, divs, depths, eps_final, inv_mass, n_leaps, counts

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
    profiling.host_read("nuts_chain.step_size")
    profiling.host_read("nuts_chain.n_leapfrogs")
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
        warmup_leaves=counts["warmup_leaves"],
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
            profiling.host_read("nuts_session.step_size")
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
        profiling.host_read("nuts_session.step", 8 if record else 5)
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
