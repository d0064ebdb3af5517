"""MAP estimation and the Laplace approximation.

The port of ``fugue_tpu/inference/map_laplace.py``: ``MAPConfig``,
``MAPResult``, ``map_estimate``, ``LaplaceResult`` and
``laplace_approximation``. The objective is the staged model's
``log_joint_unconstrained`` (log p + the transforms' log-Jacobians: the
density whose curvature the Laplace approximation needs).

All restarts run as ONE batch: every objective evaluation is one
``vmap(grad_and_value)`` over the (R, d) restart positions, one batched
model run. Restart 0 starts at the staged discovery point, the others at
prior draws.

- Adam is optax's rule (the one ``vi.py`` ports), with a constant rate: the
  iterates equal the JAX package's.
- L-BFGS keeps optax's preconditioner (memory 10, the identity scaled by
  sᵀy / yᵀy, and by min(1, 1/‖g‖) at the first step) but not its zoom line
  search: the restarts step together by backtracking from a unit step until
  each satisfies Armijo's condition. Each backtracking round reads one flag
  to the host (``MAPResult.host_syncs`` counts them), so the two packages'
  iterates differ while their endpoints agree.

The Laplace curvature is ``torch.func.hessian`` (forward over reverse) of
the same density. Forward mode cannot run through a product whose backward
is custom (``ops.linalg``'s split-bf16 products), as ``jax.hessian`` cannot
run through the JAX package's custom VJPs: such a model raises there.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.func import grad_and_value, hessian, vmap

from .. import settings
from ..core.rng import fold_seed
from ..errors import ErrorCode, ModelStructureError, ValidationError
from ..runtime.staging import StagedModel, stage
from .vi import _Adam

_LBFGS_MEMORY = 10
_ARMIJO_C1 = 1e-4
_MAX_BACKTRACKS = 30
_ROUNDING = 16.0  # the objective's rounding, in ulps of its value


@dataclass(frozen=True)
class MAPConfig:
    """Optimizer configuration."""

    n_iterations: int = 500
    learning_rate: float = 0.1
    optimizer: str = "adam"  # "adam" | "lbfgs"
    n_restarts: int = 4  # batched restarts (the first at the discovery point)
    grad_tol: float = 1e-4  # converged iff ||grad|| < grad_tol at the end


@dataclass
class MAPResult:
    latents: Dict[str, Any]  # constrained MAP point (best restart)
    z: Any  # unconstrained flat MAP position
    log_joint: float  # log p + log|J| at z (the optimized objective)
    converged: bool  # ||grad|| < grad_tol for the best restart
    grad_norm: float
    history: np.ndarray  # (n_restarts, n_iterations) objective trace
    staged: StagedModel
    discrete: Optional[Dict[str, Any]]
    host_syncs: int = 0  # device-to-host reads of the run (L-BFGS's line search)

    def trace(self):
        """The full replay trace at the MAP point."""
        merged = self.staged.merge_discrete(self.latents, self.discrete)
        return self.staged.replay_trace(merged)


def _check_continuous(staged: StagedModel, discrete) -> None:
    if staged.discrete_sites and discrete is None:
        raise ModelStructureError(
            ErrorCode.UNEXPECTED_MODEL_STRUCTURE,
            "MAP/Laplace optimizes continuous latents only; this model has "
            "discrete sites. Pass discrete={addr: value} to pin them "
            "(or marginalize them out of the model).",
            context={"discrete_sites": [s.address for s in staged.discrete_sites]},
        )
    if not staged.continuous_sites:
        raise ModelStructureError(
            ErrorCode.UNEXPECTED_MODEL_STRUCTURE,
            "model has no continuous latent sites to optimize",
        )


def _start_positions(staged: StagedModel, seed: int, n_restarts: int):
    """(R, d): the discovery point, then prior draws."""
    dt = settings.real_dtype()
    z0 = staged.unconstrain(staged._discovery_trace.latents()).to(dt)
    rest = [staged.initial_position(fold_seed(seed, 17, i)).to(dt)
            for i in range(n_restarts - 1)]
    return torch.stack([z0] + rest)


def _adam(fn, z, config: MAPConfig):
    """optax.adam(learning_rate) on every restart: (z, history (n, R))."""
    opt = _Adam(lambda t: config.learning_rate)
    hist = []
    for _ in range(config.n_iterations):
        g, v = fn(z)
        hist.append(-v)
        z = opt.step(z, g)
    return z, hist, 0


def _two_loop(g, s_mem, y_mem, rho_mem, gamma):
    """The L-BFGS product H g over the stored pairs, newest first, for each
    restart: g (R, d), each pair (R, d) with rho (R,)."""
    q = g
    alphas = []
    for s, y, rho in reversed(list(zip(s_mem, y_mem, rho_mem))):
        a = rho * torch.sum(s * q, dim=-1)
        q = q - a[:, None] * y
        alphas.append(a)
    r = gamma[:, None] * q
    for (s, y, rho), a in zip(zip(s_mem, y_mem, rho_mem), reversed(alphas)):
        b = rho * torch.sum(y * r, dim=-1)
        r = r + (a - b)[:, None] * s
    return r


def _lbfgs(fn, z, config: MAPConfig):
    """Batched L-BFGS with a backtracking Armijo line search, in lock-step
    over the restarts: (z, history, host syncs)."""
    g, v = fn(z)
    s_mem, y_mem, rho_mem = [], [], []
    hist, syncs = [], 0
    for _ in range(config.n_iterations):
        hist.append(-v)
        if s_mem:
            s, y = s_mem[-1], y_mem[-1]
            sy, yy = torch.sum(s * y, dim=-1), torch.sum(y * y, dim=-1)
            gamma = torch.where(yy > 0, sy / torch.where(yy > 0, yy, 1.0), 1.0)
        else:  # the first step: a capped reciprocal of the gradient norm
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(g, dim=-1), max=1.0)
        d = -_two_loop(g, s_mem, y_mem, rho_mem, gamma)
        slope = torch.sum(g * d, dim=-1)
        # not a descent direction (or non-finite): restart from the gradient
        bad = ~(slope < 0)
        d = torch.where(bad[:, None], -gamma[:, None] * g, d)
        slope = torch.where(bad, -gamma * torch.sum(g * g, dim=-1), slope)
        t = torch.ones_like(v)
        done = torch.zeros_like(v, dtype=torch.bool)
        # the objective's own rounding: a step within it counts as no increase
        tol = _ROUNDING * torch.finfo(v.dtype).eps * torch.clamp(torch.abs(v), min=1.0)
        z_new, g_new, v_new = z, g, v
        for _ in range(_MAX_BACKTRACKS):
            zt = z + t[:, None] * d
            gt, vt = fn(zt)
            ok = (~done) & torch.isfinite(vt) & (vt <= v + _ARMIJO_C1 * t * slope + tol)
            z_new = torch.where(ok[:, None], zt, z_new)
            g_new = torch.where(ok[:, None], gt, g_new)
            v_new = torch.where(ok, vt, v_new)
            done = done | ok
            syncs += 1
            if bool(done.all()):
                break
            t = torch.where(done, t, 0.5 * t)
        s, y = z_new - z, g_new - g
        sy = torch.sum(s * y, dim=-1)
        # keep a pair only where it carries positive curvature
        keep = sy > 1e-10 * torch.linalg.vector_norm(s, dim=-1) * torch.linalg.vector_norm(y, dim=-1)
        rho = torch.where(keep, 1.0 / torch.where(keep, sy, 1.0), 0.0)
        s_mem.append(torch.where(keep[:, None], s, 0.0))
        y_mem.append(torch.where(keep[:, None], y, 0.0))
        rho_mem.append(rho)
        if len(s_mem) > _LBFGS_MEMORY:
            s_mem.pop(0), y_mem.pop(0), rho_mem.pop(0)
        z, g, v = z_new, g_new, v_new
    return z, hist, syncs


def map_estimate(
    seed: int,
    model_fn: Optional[Callable] = None,
    config: MAPConfig = MAPConfig(),
    *,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    discrete: Optional[Dict[str, Any]] = None,
    device="cuda",
) -> MAPResult:
    """Maximum-a-posteriori point estimate of all continuous latents.

    Runs ``config.n_restarts`` optimizations as one batch (restart 0 at the
    staged discovery point, the rest at prior draws seeded from ``seed``)
    and returns the best endpoint. ``device`` is used only when ``staged``
    is not given."""
    if staged is None:
        staged = stage(model_fn, *model_args, device=device)
    _check_continuous(staged, discrete)
    if config.optimizer not in ("adam", "lbfgs"):
        raise ValidationError(
            ErrorCode.INVALID_RANGE,
            f"unknown optimizer {config.optimizer!r} (adam|lbfgs)",
        )

    def neg_lj(z):
        return -staged.log_joint_unconstrained(z, discrete)

    fn = vmap(grad_and_value(neg_lj))
    z0 = _start_positions(staged, seed, config.n_restarts)
    run = _lbfgs if config.optimizer == "lbfgs" else _adam
    zs, hist, syncs = run(fn, z0, config)
    g, v = fn(zs)
    ljs, gnorms = (-v).cpu(), torch.linalg.vector_norm(g, dim=-1).cpu()
    best = int(torch.argmax(ljs))
    z = zs[best]
    latents, _ = staged.constrain(z, discrete)
    history = (torch.stack(hist, dim=1).cpu().numpy() if hist
               else np.zeros((config.n_restarts, 0)))
    return MAPResult(
        latents=latents,
        z=z,
        log_joint=float(ljs[best]),
        converged=bool(gnorms[best] < config.grad_tol),
        grad_norm=float(gnorms[best]),
        history=history,
        staged=staged,
        discrete=discrete,
        host_syncs=syncs + 3,  # the line search, then the objective, the norms, the history
    )


@dataclass
class LaplaceResult:
    map_result: MAPResult
    mean: Any  # unconstrained MAP position
    cov: Any  # (d, d) inverse negative Hessian
    chol: Any  # Cholesky factor of cov
    log_evidence: float  # Laplace marginal-likelihood estimate

    def sample_unconstrained(self, seed: int, n: int = 1):
        g = torch.Generator(device=self.mean.device).manual_seed(int(seed))
        eps = torch.randn((n, self.mean.shape[0]), generator=g, device=self.mean.device,
                          dtype=self.mean.dtype)
        return self.mean[None, :] + eps @ self.chol.T

    def sample(self, seed: int, n: int = 1) -> Dict[str, Any]:
        """n Gaussian posterior draws mapped back to the constrained space
        (address → (n, *site_shape)), in one batched model run."""
        zs = self.sample_unconstrained(seed, n)
        staged = self.map_result.staged
        return vmap(lambda z: staged.constrain(z, self.map_result.discrete)[0])(zs)

    def sd(self, address: str):
        """Marginal posterior sd of a site in the UNCONSTRAINED space."""
        staged = self.map_result.staged
        lo, hi = staged._z_offsets[str(address)]
        return torch.sqrt(torch.diagonal(self.cov)[lo:hi]).reshape(
            staged.site(address).z_shape)


def laplace_approximation(map_result: MAPResult, jitter: float = 0.0) -> LaplaceResult:
    """Gaussian posterior approximation at the MAP point.

    The curvature is ``torch.func.hessian`` of the staged unconstrained
    log-density, exact second derivatives; ``jitter`` adds a ridge to −H
    before inversion. A model whose density runs through a product with a
    custom backward only (``matmul_bf16x2``, ``matmul_bf16x2_fastgrad``)
    has no forward mode and raises here, as in the JAX package."""
    staged = map_result.staged
    disc = map_result.discrete

    def lj(z):
        return staged.log_joint_unconstrained(z, disc)

    z = map_result.z
    h = hessian(lj)(z)
    d = z.shape[0]
    neg_h = -h + jitter * torch.eye(d, dtype=h.dtype, device=h.device)
    sign, logdet = torch.linalg.slogdet(neg_h)
    cov = torch.linalg.inv(neg_h)
    chol, info = torch.linalg.cholesky_ex(cov)
    chol = torch.where(info == 0, chol, torch.nan)
    if not bool(sign > 0) or not bool(torch.all(torch.isfinite(chol))):
        raise ValidationError(
            ErrorCode.INVALID_SHAPE,
            "negative Hessian at the MAP point is not positive definite — "
            "not a local maximum (or a flat direction); increase "
            "n_iterations, try optimizer='lbfgs', or pass jitter>0.",
            context={"sign": float(sign)},
        )
    log_z = lj(z) + 0.5 * d * math.log(2.0 * math.pi) - 0.5 * logdet
    return LaplaceResult(
        map_result=map_result,
        mean=z,
        cov=cov,
        chol=chol,
        log_evidence=float(log_z),
    )
