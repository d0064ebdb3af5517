"""Dynamic (open-universe) adaptive MH for structure-varying models.

The port of ``fugue_tpu/inference/mh_dynamic.py``: ``DynamicMHResult``
and ``adaptive_mcmc_chain_dynamic``. A model whose set of addresses
depends on sampled values cannot be staged, so this engine runs eagerly
on the handler runtime: one model run per transition, on the model's
device, driven from the host. It is host-driven by nature: the structure
of the next run depends on a value read back from the last one.

The reference's scheme:

- the proposal moves ONE existing site (the support's kernel, with its
  Hastings term);
- addresses that appear in the proposed run are BIRTHED from the prior
  (``ReconcilingScoreGivenTrace``): their prior density cancels against
  the birth proposal;
- addresses that vanish die by dropping: their prior density cancels
  against the reverse birth;
- what remains is the site-count term ln|sites_cur| − ln|sites_prop| of
  the uniform site choice.

Every draw (the site, its proposal noise, the accept uniform) comes from
one CPU ``torch.Generator``; a birth draws from the reconciling handler's
generator on the model's device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np
import torch

from ..core.rng import fold_seed
from ..runtime.handler import run
from ..runtime.interpreters import PriorHandler, ReconcilingScoreGivenTrace
from ..runtime.trace import Choice, Trace
from .mh import _reflect_into, make_site_proposal


@dataclass
class DynamicMHResult:
    traces: List[Trace]
    accept_rate: float
    birth_count: int
    death_count: int

    def values(self, address: str) -> np.ndarray:
        out = []
        for t in self.traces:
            c = t.get_choice(address)
            if c is not None:
                out.append(torch.as_tensor(c.value).detach().cpu().numpy())
        return np.asarray(out)

    def presence(self, address: str) -> np.ndarray:
        return np.asarray([address in t for t in self.traces])


def propose_site(generator: torch.Generator, support, x, scale: float):
    """The support's single-site proposal for value ``x`` → (candidate,
    Hastings log-correction): a Gaussian walk (real), a log-space walk
    with ln x' − ln x (positive), a reflection walk (bounded intervals), a
    flip, a reflected integer walk of width max(round(scale), 1), or a
    uniform category. The noise comes from ``generator`` (on the CPU) and
    moves to ``x``'s device."""
    x = torch.as_tensor(x)
    kind = support.kind
    if kind in ("boolean", "categorical", "count", "int_range"):
        if kind == "boolean":
            noise = None
        elif kind == "categorical":
            noise = torch.randint(0, support.size, x.shape, generator=generator).to(x.device)
        else:
            width = max(round(scale), 1)
            mag = torch.randint(1, width + 1, x.shape, generator=generator)
            sign = torch.where(torch.rand(x.shape, generator=generator) < 0.5, 1, -1)
            noise = (mag.to(x.device), sign.to(x.device))
        return make_site_proposal(support)(x, noise), 0.0
    eps = torch.randn(x.shape, generator=generator, dtype=torch.float64).to(
        device=x.device, dtype=x.dtype)
    if kind == "positive":
        x_new = x * torch.exp(scale * eps)
        return x_new, float(torch.sum(torch.log(x_new) - torch.log(x)))
    if kind == "unit" or (kind == "interval" and support.low is not None):
        lo, hi = (0.0, 1.0) if kind == "unit" else (support.low, support.high)
        return _reflect_into(x + scale * (hi - lo) * eps, lo, hi), 0.0
    return x + scale * eps, 0.0


def log_acceptance(prop_lw: float, current_lw: float, corr: float, n_cur: int, n_prop: int,
                   birthed_lp: float, vanished_lp: float) -> float:
    """The RJMCMC log acceptance ratio: the joint ratio with the kernel's
    Hastings term and the site-count term; the birthed sites' prior terms
    (``birthed_lp``, their summed log-probs in the proposal) and the
    vanished sites' (``vanished_lp``, in the current trace) cancel against
    the birth and death proposals."""
    return (prop_lw - current_lw + corr + math.log(n_cur) - math.log(n_prop)
            - birthed_lp + vanished_lp)


def adaptive_mcmc_chain_dynamic(
    seed: int,
    model_fn: Callable,
    n_samples: int,
    n_warmup: int = 0,
    *,
    model_args: tuple = (),
    initial_scale: float = 0.5,
    target_accept: float = 0.44,
    thin: int = 1,
    device="cuda",
) -> DynamicMHResult:
    """Single-site random-scan MH over traces with RJMCMC reconciliation,
    the model running on ``device``."""
    generator = torch.Generator().manual_seed(int(seed))
    _, current = run(PriorHandler(fold_seed(seed, 0), device), model_fn, *model_args)
    current_lw = float(current.total_log_weight())

    # per-address diminishing adaptation (a host dict)
    log_scales: Dict[str, float] = {}
    counts: Dict[str, int] = {}

    def scale_of(addr: str) -> float:
        return math.exp(log_scales.get(addr, math.log(initial_scale)))

    def adapt(addr: str, accepted: bool):
        c = counts.get(addr, 0) + 1
        counts[addr] = c
        step = min(1.0, c ** -0.6)
        log_scales[addr] = log_scales.get(addr, math.log(initial_scale)) + (
            step * ((1.0 if accepted else 0.0) - target_accept)
        )

    traces: List[Trace] = []
    n_accept = births = deaths = 0
    total = n_warmup + n_samples
    latent_addrs = [a for a, c in current.choices.items() if not c.is_observed]

    for it in range(total):
        n_cur = len(latent_addrs)
        addr = latent_addrs[int(torch.randint(0, n_cur, (), generator=generator))]
        choice = current.choices[addr]
        cand, corr = propose_site(generator, choice.support, choice.value, scale_of(addr))

        # the proposed base: the current latents with the picked site replaced
        base = current.copy()
        base.choices = dict(current.choices)
        base.choices[addr] = Choice(value=cand, log_prob=choice.log_prob,
                                    support=choice.support, is_observed=False)
        handler = ReconcilingScoreGivenTrace(fold_seed(seed, 1, it), base, device)
        _, prop_trace = run(handler, model_fn, *model_args)
        report = handler.report

        prop_lw = float(prop_trace.total_log_weight())
        prop_latents = [a for a, c in prop_trace.choices.items() if not c.is_observed]
        log_alpha = log_acceptance(
            prop_lw, current_lw, corr, n_cur, len(prop_latents),
            sum(float(prop_trace.choices[a].log_prob) for a in report.birthed),
            sum(float(current.choices[a].log_prob) for a in report.vanished))
        u = float(torch.rand((), generator=generator, dtype=torch.float64))
        accepted = math.log(max(u, 1e-300)) < log_alpha
        if accepted:
            current, current_lw, latent_addrs = prop_trace, prop_lw, prop_latents
            n_accept += 1
            births += len(report.birthed)
            deaths += len(report.vanished)
        if it < n_warmup:
            adapt(addr, accepted)
        if it >= n_warmup and (it - n_warmup) % thin == 0:
            traces.append(current)

    return DynamicMHResult(
        traces=traces,
        accept_rate=n_accept / max(total, 1),
        birth_count=births,
        death_count=deaths,
    )
