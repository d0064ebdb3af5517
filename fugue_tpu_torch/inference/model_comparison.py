"""Predictive model comparison: pointwise log-likelihood, WAIC, PSIS-LOO.

The port of ``fugue_tpu/inference/model_comparison.py``:
``pointwise_log_likelihood``, ``ELPDResult``, ``waic``, ``psis_smooth``,
``psis_loo`` and ``compare``. WAIC (Watanabe 2010, in the
Vehtari–Gelman–Gabry 2017 form) and Pareto-smoothed importance-sampling
LOO (Vehtari et al. 2017).

The (draws × observations) log-likelihood matrix comes from ONE batched
replay of the model over all posterior draws, under a handler that keeps
each observe site's elementwise log-probs instead of their sum; it stays
on the model's device. WAIC's reductions run in float64 on the matrix's
device; the generalized-Pareto tail fit (Zhang & Stephens 2009) and LOO
run on the host in numpy, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.func import vmap

from ..runtime.handler import run
from ..runtime.interpreters import ValuesHandler
from ..runtime.staging import StagedModel, stage


class _PointwiseHandler(ValuesHandler):
    """ValuesHandler that keeps every observe site's elementwise log-probs
    (no summing) in ``self.pointwise``."""

    def __init__(self, values):
        super().__init__(values)
        self.pointwise: Dict[str, Any] = {}

    def on_observe(self, addr, dist, value):
        self.pointwise[addr] = torch.atleast_1d(dist.log_prob(value))
        return super().on_observe(addr, dist, value)


def pointwise_log_likelihood(
    samples: Dict[str, Any],
    model_fn: Optional[Callable] = None,
    *,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    n_batch_axes: int = 2,
    device="cuda",
) -> Any:
    """(S, n_obs) matrix of per-observation log-likelihoods, in one batched
    model run on the staged model's device.

    ``samples`` maps latent address → tensor with ``n_batch_axes`` leading
    batch axes (2 for engine results: chains × draws; 1 for a flat draw
    list). The observation axes of every observe site are flattened and
    concatenated in address order: one column per scalar observation.
    ``device`` is used only when ``staged`` is not given."""
    if staged is None:
        staged = stage(model_fn, *model_args, device=device)
    latent_addrs = {s.address for s in staged.sites}
    sub = {k: torch.as_tensor(v).to(staged.device) for k, v in samples.items()
           if k in latent_addrs}
    for _ in range(n_batch_axes - 1):
        sub = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in sub.items()}

    def one(values):
        h = _PointwiseHandler(staged.merge_discrete(values, None))
        run(h, staged.model_fn, *staged.args, **staged.kwargs)
        return torch.cat([h.pointwise[a].reshape(-1) for a in sorted(h.pointwise)])

    return vmap(one)(sub)


@dataclass
class ELPDResult:
    """Expected log pointwise predictive density estimate."""

    elpd: float  # sum over observations
    se: float  # MC standard error over observations
    p_eff: float  # effective number of parameters
    pointwise: np.ndarray  # (n_obs,) per-observation elpd contributions
    pareto_k: Optional[np.ndarray] = None  # PSIS-LOO only, (n_obs,)
    method: str = ""

    def __repr__(self):
        tail = ""
        if self.pareto_k is not None:
            bad = int((self.pareto_k > 0.7).sum())
            tail = f", max k̂={self.pareto_k.max():.2f} ({bad} obs > 0.7)"
        return (
            f"<{self.method}: elpd={self.elpd:.2f} ± {self.se:.2f}, "
            f"p_eff={self.p_eff:.2f}{tail}>"
        )


def _logmeanexp(a, dim=0):
    return torch.logsumexp(a, dim=dim) - np.log(a.shape[dim])


def waic(log_lik) -> ELPDResult:
    """WAIC from an (S, n_obs) pointwise log-likelihood matrix
    (Vehtari–Gelman–Gabry 2017, eqs. 10-12), in float64."""
    ll = torch.as_tensor(log_lik).to(torch.float64)
    lppd_i = _logmeanexp(ll, dim=0)
    p_i = torch.var(ll, dim=0, correction=1)
    elpd_i = (lppd_i - p_i).cpu().numpy()
    n = elpd_i.shape[0]
    return ELPDResult(
        elpd=float(elpd_i.sum()),
        se=float(np.sqrt(n * elpd_i.var(ddof=1))) if n > 1 else 0.0,
        p_eff=float(p_i.sum()),
        pointwise=elpd_i,
        method="waic",
    )


def _gpd_fit(x: np.ndarray):
    """Generalized-Pareto shape/scale fit (Zhang & Stephens 2009 posterior
    mean over a profile grid) for sorted exceedances x > 0."""
    n = x.shape[0]
    m = 30 + int(np.sqrt(n))
    # Zhang & Stephens' prior scale: 1/(3 * first-quartile exceedance)
    prior_bs = (
        1.0 / (3.0 * x[int(n / 4 + 0.5) - 1]) if n >= 4 else 1.0 / (3.0 * x[-1])
    )
    js = np.arange(1, m + 1)
    bs = 1.0 / x[-1] + (1.0 - np.sqrt(m / (js - 0.5))) * prior_bs
    # profile likelihood over the grid; ξ = mean(log1p(-b x)) (heavy tails:
    # b < 0, ξ > 0; Zhang and Stephens' "k" is −ξ)
    ks = np.mean(np.log1p(-bs[:, None] * x[None, :]), axis=1)
    ls = n * (np.log(-bs / ks) - ks - 1.0)
    w = np.exp(ls - ls.max())
    w = w / w.sum()
    b = float(np.sum(bs * w))
    k = float(np.mean(np.log1p(-b * x)))
    sigma = -k / b
    # weakly-informative shrinkage toward k = 0.5 (the PSIS paper, app. C)
    k = k * n / (n + 10.0) + 0.5 * 10.0 / (n + 10.0)
    return k, sigma


def psis_smooth(log_ratios: np.ndarray):
    """Pareto-smooth one observation's (S,) importance log-ratios.
    Returns (smoothed log-weights, k̂)."""
    lr = np.asarray(log_ratios, np.float64)
    S = lr.shape[0]
    lr = lr - lr.max()
    m_tail = min(int(np.ceil(min(0.2 * S, 3.0 * np.sqrt(S)))), S - 1)
    if m_tail < 5:
        return lr, -np.inf  # too few draws to fit a tail
    order = np.argsort(lr)
    tail_idx = order[-m_tail:]
    cutoff = np.exp(lr[order[-m_tail - 1]])
    exceed = np.exp(lr[tail_idx]) - cutoff
    exceed = np.sort(exceed)
    if exceed[-1] <= 0:
        return lr, -np.inf
    k, sigma = _gpd_fit(np.maximum(exceed, 1e-12))
    if np.isfinite(k):
        # the tail becomes the GPD's expected order statistics (its inverse
        # CDF at a centred uniform grid), capped at the observed maximum
        p = (np.arange(1, m_tail + 1) - 0.5) / m_tail
        if abs(k) < 1e-12:
            q = -np.log1p(-p) * sigma
        else:
            q = sigma * np.expm1(-k * np.log1p(-p)) / k  # sigma*((1-p)^-k - 1)/k
        smoothed = np.log(cutoff + q)
        smoothed = np.minimum(smoothed, lr.max())
        lr = lr.copy()
        lr[tail_idx] = smoothed
    return lr, k


def psis_loo(log_lik) -> ELPDResult:
    """Pareto-smoothed importance-sampling leave-one-out elpd (Vehtari,
    Gelman & Gabry 2017) from an (S, n_obs) matrix. ``pareto_k`` > 0.7
    flags observations whose LOO estimate is unreliable."""
    ll_t = torch.as_tensor(log_lik).to(torch.float64)
    ll = ll_t.cpu().numpy()
    S, n = ll.shape
    elpd_i = np.empty(n)
    ks = np.empty(n)
    lppd_all = _logmeanexp(ll_t, dim=0).cpu().numpy()
    for i in range(n):
        lw, k = psis_smooth(-ll[:, i])
        lw = lw - np.logaddexp.reduce(lw)
        elpd_i[i] = np.logaddexp.reduce(lw + ll[:, i])
        ks[i] = k
    p_eff = float(lppd_all.sum() - elpd_i.sum())
    return ELPDResult(
        elpd=float(elpd_i.sum()),
        se=float(np.sqrt(n * elpd_i.var(ddof=1))) if n > 1 else 0.0,
        p_eff=p_eff,
        pointwise=elpd_i,
        pareto_k=ks,
        method="psis-loo",
    )


def compare(results: Dict[str, ELPDResult]) -> str:
    """Ranked comparison table: best model first, elpd differences and
    their pairwise standard errors against the best."""
    items = sorted(results.items(), key=lambda kv: -kv[1].elpd)
    best = items[0][1]
    lines = [f"{'model':<20} {'elpd':>10} {'se':>8} {'d_elpd':>10} {'d_se':>8}"]
    for name, r in items:
        d = r.elpd - best.elpd
        dp = r.pointwise - best.pointwise
        d_se = float(np.sqrt(dp.shape[0] * dp.var(ddof=1))) if r is not best else 0.0
        lines.append(
            f"{name:<20} {r.elpd:>10.2f} {r.se:>8.2f} {d:>10.2f} {d_se:>8.2f}"
        )
    return "\n".join(lines)
