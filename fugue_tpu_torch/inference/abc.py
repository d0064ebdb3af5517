"""Approximate Bayesian Computation: rejection and importance-weighted ABC-SMC.

The port of ``fugue_tpu/inference/abc.py``: the Euclidean, Manhattan and
weighted summary-statistic distances, rejection with a bounded attempt
budget, Beaumont/Toni ABC-SMC (a weight-proportional base draw, a Gaussian
perturbation of bandwidth sqrt(2 · weighted variance), prior-support
rejection, weights π(θ) / Σ_j w̄_j K(θ | θ_j)), its equal-weight form with a
terminal systematic resample, and ABC on a scalar summary.

The simulator is the staged model's run: a batch of candidates is ONE model
run under ``torch.func.vmap`` (``StagedModel.simulate_batch``, or
``replay_partial_batch`` with the parameter sites pinned and the noise
sites redrawn). Acceptance is decided on the device, and the accepted rows
move to the front with a stable sort of the 0/1 mask, which keeps the first
accepted rows in index order as XLA's ``top_k`` does in the JAX package.
Each dispatch (``inner_batches`` sub-batches) reads only its accept counts
to the host, in one transfer; the accepted rows stay on the device, and the
host counts the attempts.

On the card the 1-D normalisations of the SMC log-weights are the
``logsumexp`` kernel (``ops.resampling.normalize_log_weights``) and
``abc_smc``'s terminal resample is the ``systematic_resample`` kernel. The
(batch, N) log-kernel matrix of the weights is reduced row by row with
``core.numerics.log_sum_exp``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import vmap

from .. import settings
from ..core.numerics import log_sum_exp
from ..core.rng import fold_seed
from ..errors import ErrorCode, FugueError
from ..ops.resampling import _indices_from_uniforms, normalize_log_weights, systematic_resample
from ..runtime.staging import StagedModel, stage


class ABCError(FugueError):
    """Attempt budget exhausted, empty population or discrete parameters."""


def _stage_exhausted(stage_idx: int, accepted: int, needed: int, attempts: int):
    return ABCError(
        ErrorCode.UNEXPECTED_MODEL_STRUCTURE,
        f"ABC stage {stage_idx} exhausted its attempt budget",
        {"accepted": accepted, "needed": needed, "attempts": attempts},
    )


def _as_real(x):
    dt = settings.real_dtype()
    return x.to(dt) if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=dt)


# ---------------------------------------------------------------------------
# Distances
# ---------------------------------------------------------------------------


def euclidean_distance(a, b):
    return torch.sqrt(torch.sum((a - b) ** 2))


def manhattan_distance(a, b):
    return torch.sum(torch.abs(a - b))


@dataclass
class SummaryStatsDistance:
    """Weighted Euclidean distance over user summary statistics."""

    summary: Callable[[Any], Any]
    weights: Optional[Any] = None

    def __call__(self, a, b):
        sa = torch.atleast_1d(_as_real(self.summary(a)))
        sb = torch.atleast_1d(_as_real(self.summary(b)))
        w = (torch.ones_like(sa) if self.weights is None
             else torch.as_tensor(np.asarray(self.weights), dtype=sa.dtype, device=sa.device))
        return torch.sqrt(torch.sum(w * (sa - sb) ** 2))


def _distances(distance, data, observed):
    """``distance(row, observed)`` for every row of a batch of simulations."""
    return vmap(distance, in_dims=(0, None))(data, observed)


def _observed(observed, device):
    if isinstance(observed, torch.Tensor):
        return observed.to(device)
    arr = np.asarray(observed)
    t = torch.as_tensor(arr, device=device)
    return t.to(settings.real_dtype()) if arr.dtype.kind == "f" else t


# ---------------------------------------------------------------------------
# Compaction and the one host read per dispatch
# ---------------------------------------------------------------------------


def compact_accepted(ok, cap: int):
    """The first ``cap`` row indices of a stable descending sort of the
    accept mask: the accepted rows in index order, then the rejected ones in
    index order (``lax.top_k``'s order on a 0/1 mask)."""
    return torch.sort(ok.to(torch.uint8), descending=True, stable=True).indices[:cap]


def _counts(counts):
    """Host ints of a list of 0-dim count tensors: the dispatch's one read."""
    return torch.stack(counts).tolist()


# ---------------------------------------------------------------------------
# Rejection
# ---------------------------------------------------------------------------


@dataclass
class ABCResult:
    particles: Dict[str, Any]  # address → (n, *site_shape)
    distances: Any
    log_weights: Any  # uniform for rejection; importance weights for SMC
    n_attempts: int

    def posterior_mean(self, address: str):
        w, _ = normalize_log_weights(self.log_weights)
        vals = _as_real(self.particles[str(address)])
        w = w.reshape(w.shape + (1,) * (vals.dim() - 1))
        return torch.sum(w * vals, dim=0)


def abc_rejection(
    seed: int,
    model_fn: Optional[Callable] = None,
    observed=None,
    distance: Callable = euclidean_distance,
    epsilon: float = 1.0,
    n_samples: int = 100,
    *,
    max_attempts: int = 100_000,
    batch_size: int = 1024,
    inner_batches: int = 1,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    device="cuda",
) -> ABCResult:
    """Likelihood-free rejection sampling with a bounded attempt budget. The
    model's RETURN VALUE is the simulated dataset; a candidate is accepted
    when ``distance(simulated, observed) <= epsilon``.

    Each dispatch simulates ``inner_batches`` sub-batches of ``batch_size``
    candidates (one batched model run each), keeps each sub-batch's first
    ``min(n_samples, batch_size)`` accepted rows on the device and reads
    the accept counts to the host at once. Attempts count ``inner_batches * batch_size`` per
    dispatch; a dispatch starting at ``max_attempts`` raises ``ABCError``."""
    if staged is None:
        staged = stage(model_fn, *model_args, device=device)
    observed = _observed(observed, staged.device)
    cap = min(n_samples, batch_size)
    K = max(1, int(inner_batches))

    def sub_batch(s):
        data, latents = staged.simulate_batch(s, batch_size)
        d = _distances(distance, data, observed)
        ok = d <= epsilon
        take = compact_accepted(ok, cap)
        n_ok = torch.clamp(torch.sum(ok), max=cap)
        return n_ok, d[take], {a: v[take] for a, v in latents.items()}

    collected: List[Dict[str, Any]] = []
    dists: List[Any] = []
    n_acc = attempts = i = 0
    while n_acc < n_samples:
        if attempts >= max_attempts:
            raise _stage_exhausted(0, n_acc, n_samples, attempts)
        subs = [sub_batch(fold_seed(seed, i, k)) for k in range(K)]
        i += 1
        attempts += K * batch_size
        for n_ok, (_, d, top) in zip(_counts([sb[0] for sb in subs]), subs):
            n_take = min(n_ok, cap, n_samples - n_acc)
            if n_take <= 0:
                continue
            collected.append({a: v[:n_take] for a, v in top.items()})
            dists.append(d[:n_take])
            n_acc += n_take

    return ABCResult(
        particles={a: torch.cat([c[a] for c in collected]) for a in collected[0]},
        distances=torch.cat(dists),
        log_weights=torch.zeros(n_samples, dtype=settings.real_dtype(), device=staged.device),
        n_attempts=attempts,
    )


# ---------------------------------------------------------------------------
# Importance-weighted ABC-SMC
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ABCSMCConfig:
    epsilons: Tuple[float, ...] = (2.0, 1.0, 0.5)
    n_particles: int = 256
    max_attempts_per_stage: int = 100_000
    batch_size: int = 1024


def kernel_bandwidth(thetas, wbar):
    """sqrt(2 · weighted variance) per dimension, the variance floored at
    1e-12: thetas (N, d), normalized weights wbar (N,)."""
    mean = torch.sum(wbar[:, None] * thetas, dim=0)
    var = torch.sum(wbar[:, None] * (thetas - mean) ** 2, dim=0)
    return torch.sqrt(2.0 * torch.clamp(var, min=1e-12))


def proposal_log_weights(theta, lp, thetas, log_wbar, bw):
    """Importance log-weights lp − log Σ_j w̄_j K(θ | θ_j) of candidates θ
    (B, d) with prior log-densities lp (B,), against the population thetas
    (N, d), its normalized log-weights (N,) and the Gaussian kernel's
    bandwidth bw (d,): the (B, N) log-kernel matrix reduced row by row."""
    d_dim = theta.shape[-1]
    z = (theta[:, None, :] - thetas[None, :, :]) / bw
    log_k = (-0.5 * torch.sum(z * z, dim=-1) - torch.sum(torch.log(bw))
             - 0.5 * d_dim * math.log(2 * math.pi))
    return lp - log_sum_exp(log_wbar + log_k, dim=-1)


def abc_smc_weighted(
    seed: int,
    model_fn: Optional[Callable] = None,
    observed=None,
    distance: Callable = euclidean_distance,
    config: ABCSMCConfig = ABCSMCConfig(),
    *,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    param_addresses: Optional[Sequence[str]] = None,
    device="cuda",
) -> ABCResult:
    """Importance-weighted ABC-SMC. Stage 0: rejection at epsilons[0],
    uniform weights. Stage t: draw a base particle with probability ∝ its
    weight, perturb it with a Gaussian kernel of bandwidth sqrt(2 ·
    weighted variance) per dimension, reject outside the prior's support,
    accept if the distance is at most epsilon_t, and weight it π(θ) /
    Σ_j w̄_j K(θ | θ_j).

    ``param_addresses`` names the parameter sites θ (perturbed and
    weighted); the other latent sites are simulator noise, redrawn for
    every candidate. Default: every continuous latent. Discrete parameters
    raise ``ABCError``."""
    if staged is None:
        staged = stage(model_fn, *model_args, device=device)
    dev = staged.device
    dt = settings.real_dtype()
    observed = _observed(observed, dev)
    N = config.n_particles
    if param_addresses is None:
        param_sites = list(staged.continuous_sites)
        if staged.discrete_sites:
            raise ABCError(
                ErrorCode.NOT_STAGEABLE,
                "ABC-SMC perturbation requires continuous parameter sites; "
                "pass param_addresses to exclude discrete latents",
                {"discrete": [s.address for s in staged.discrete_sites]},
            )
    else:
        param_sites = [staged.site(a) for a in param_addresses]
        for s in param_sites:
            if not s.is_continuous:
                raise ABCError(ErrorCode.NOT_STAGEABLE, f"parameter site {s.address!r} is discrete",
                               {"support": s.support.kind})
    if N <= 0:
        raise ABCError(ErrorCode.UNEXPECTED_MODEL_STRUCTURE, "empty initial population")

    offsets, off = {}, 0
    for s in param_sites:
        offsets[s.address] = (off, off + s.size)
        off += s.size
    d_dim = off

    def flatten_params(latents):
        return torch.cat([latents[s.address].to(dt).reshape(-1, s.size) for s in param_sites],
                         dim=1)

    def unflatten_params(vec):
        return {s.address: vec[:, offsets[s.address][0]:offsets[s.address][1]].reshape(
            (vec.shape[0],) + tuple(s.shape)) for s in param_sites}

    r0 = abc_rejection(fold_seed(seed, 0), observed=observed, distance=distance,
                       epsilon=config.epsilons[0], n_samples=N,
                       max_attempts=config.max_attempts_per_stage,
                       batch_size=config.batch_size, staged=staged)
    thetas = flatten_params(r0.particles)  # (N, d)
    log_w = torch.zeros(N, dtype=dt, device=dev)
    attempts_total = r0.n_attempts
    B = config.batch_size
    cap = min(N, B)

    def propose(s, log_wbar, wbar, bw, eps_t):
        """One batch of perturbed candidates, simulated, scored and
        compacted: (cap thetas, cap log-weights, accepted count)."""
        g = torch.Generator(device=dev).manual_seed(s)
        u = torch.rand(B, generator=g, device=dev, dtype=dt)
        base = _indices_from_uniforms(wbar, u)
        theta = thetas[base] + bw * torch.randn((B, d_dim), generator=g, device=dev, dtype=dt)
        data, trace = staged.replay_partial_batch(fold_seed(s, 1), unflatten_params(theta))
        lp = sum(trace.choices[p.address].log_prob for p in param_sites)
        dist = _distances(distance, data, observed)
        lw = proposal_log_weights(theta, lp, thetas, log_wbar, bw)
        ok = torch.isfinite(lp) & (dist <= eps_t)
        take = compact_accepted(ok, cap)
        return theta[take], lw[take], torch.clamp(torch.sum(ok), max=cap)

    for t, eps in enumerate(config.epsilons[1:], start=1):
        wbar, lse = normalize_log_weights(log_w)
        bw = kernel_bandwidth(thetas, wbar)
        log_wbar = log_w - lse
        new_thetas: List[Any] = []
        new_logw: List[Any] = []
        n_acc = attempts = i = 0
        while n_acc < N:
            if attempts >= config.max_attempts_per_stage:
                raise _stage_exhausted(t, n_acc, N, attempts)
            th_top, lw_top, n_ok = propose(fold_seed(seed, t, i), log_wbar, wbar, bw, eps)
            i += 1
            attempts += B
            n_take = min(_counts([n_ok])[0], cap, N - n_acc)
            if n_take:
                new_thetas.append(th_top[:n_take])
                new_logw.append(lw_top[:n_take])
                n_acc += n_take
        thetas = torch.cat(new_thetas)
        log_w = torch.cat(new_logw)
        attempts_total += attempts

    # every particle's final distance from ONE shared noise draw, as the JAX
    # package replays all particles with one key
    data, _ = staged.replay_partial_batch(fold_seed(seed, 777), unflatten_params(thetas),
                                          randomness="same")
    _, lse = normalize_log_weights(log_w)
    return ABCResult(particles=unflatten_params(thetas),
                     distances=_distances(distance, data, observed),
                     log_weights=log_w - lse, n_attempts=attempts_total)


def abc_smc(
    seed: int,
    model_fn: Optional[Callable] = None,
    observed=None,
    distance: Callable = euclidean_distance,
    config: ABCSMCConfig = ABCSMCConfig(),
    *,
    device="cuda",
    **kw,
) -> ABCResult:
    """Equal-weight ABC-SMC: the importance-weighted run, then a systematic
    resample of its particles (uniform log-weights)."""
    res = abc_smc_weighted(seed, model_fn, observed, distance, config, device=device, **kw)
    lw = res.log_weights
    g = torch.Generator(device=lw.device).manual_seed(fold_seed(seed, 999))
    idx = systematic_resample(g, lw)
    return ABCResult(particles={a: v[idx] for a, v in res.particles.items()},
                     distances=res.distances[idx], log_weights=torch.zeros_like(lw),
                     n_attempts=res.n_attempts)


def abc_scalar_summary(
    seed: int,
    model_fn: Optional[Callable] = None,
    observed_summary: float = 0.0,
    summary: Callable = torch.mean,
    epsilon: float = 0.5,
    n_samples: int = 100,
    *,
    device="cuda",
    **kw,
) -> ABCResult:
    """ABC rejection on a scalar summary statistic: |summary(sim) − observed|."""
    def dist(a, b):
        return torch.abs(_as_real(summary(a)) - b)

    return abc_rejection(seed, model_fn, observed=_as_real(observed_summary), distance=dist,
                         epsilon=epsilon, n_samples=n_samples, device=device, **kw)
