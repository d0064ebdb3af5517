"""Convergence diagnostics over batched sample tensors.

The port of ``summarize_samples`` and ``print_diagnostics`` from
``fugue_tpu/inference/diagnostics.py``: per-parameter mean, sd, quantiles,
split-R-hat and multi-chain ESS, with the reference's verdict thresholds.
Samples may live on any device; the summaries are computed in float64 on
the CPU. The trace-list extractors wait for a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence

import torch

from .mcmc_utils import ess_multichain, split_r_hat

RHAT_EXCELLENT = 1.01
RHAT_GOOD = 1.1

DEFAULT_QUANTILES = (0.025, 0.25, 0.5, 0.75, 0.975)


@dataclass
class ParameterSummary:
    """Per-parameter summary."""

    name: str
    mean: float
    sd: float
    quantiles: Dict[float, float]
    r_hat: float
    ess: float
    n_chains: int
    n_samples: int

    @property
    def converged(self) -> bool:
        return self.r_hat < RHAT_GOOD

    @property
    def verdict(self) -> str:
        if self.r_hat < RHAT_EXCELLENT:
            return "excellent"
        if self.r_hat < RHAT_GOOD:
            return "good"
        return "poor"


def summarize_samples(
    samples: Dict[str, Any],
    quantiles: Sequence[float] = DEFAULT_QUANTILES,
) -> List[ParameterSummary]:
    """Summaries for each scalar component of each site.

    ``samples``: address → (n_chains, n_samples, *site_shape). Array sites
    expand into indexed pseudo-parameters ``addr[i]``.
    """
    out: List[ParameterSummary] = []
    for name in sorted(samples.keys()):
        arr = torch.as_tensor(samples[name]).detach().to("cpu", torch.float64)
        if arr.dim() < 2:
            raise ValueError(f"site {name!r}: expected (n_chains, n_samples, ...) array")
        m, n = arr.shape[0], arr.shape[1]
        comp = arr.reshape(m, n, -1).movedim(-1, 0)  # (k, m, n)
        rh = split_r_hat(comp)
        es = ess_multichain(comp)
        q = torch.tensor(quantiles, dtype=torch.float64)
        for j in range(comp.shape[0]):
            xs = comp[j].reshape(-1)
            qv = torch.quantile(xs, q)
            out.append(
                ParameterSummary(
                    name=name if comp.shape[0] == 1 else f"{name}[{j}]",
                    mean=float(xs.mean()),
                    sd=float(xs.std(correction=1)),
                    quantiles={qq: float(v) for qq, v in zip(quantiles, qv)},
                    r_hat=float(rh[j]),
                    ess=float(es[j]),
                    n_chains=m,
                    n_samples=n,
                )
            )
    return out


def print_diagnostics(
    samples: Dict[str, Any],
    quantiles: Sequence[float] = DEFAULT_QUANTILES,
    file=None,
) -> List[ParameterSummary]:
    """Formatted diagnostics table + convergence verdict."""
    summaries = summarize_samples(samples, quantiles)
    header = (
        f"{'parameter':<20} {'mean':>10} {'sd':>10} "
        + " ".join(f"q{int(q*100):>02}".rjust(9) for q in quantiles)
        + f" {'R-hat':>8} {'ESS':>9}"
    )
    lines = [header, "-" * len(header)]
    worst = 0.0
    for s in summaries:
        worst = max(worst, s.r_hat)
        lines.append(
            f"{s.name:<20} {s.mean:>10.4f} {s.sd:>10.4f} "
            + " ".join(f"{s.quantiles[q]:>9.4f}" for q in quantiles)
            + f" {s.r_hat:>8.4f} {s.ess:>9.1f}"
        )
    if worst < RHAT_EXCELLENT:
        verdict = f"convergence: EXCELLENT (max R-hat {worst:.4f} < {RHAT_EXCELLENT})"
    elif worst < RHAT_GOOD:
        verdict = f"convergence: GOOD (max R-hat {worst:.4f} < {RHAT_GOOD})"
    else:
        verdict = f"convergence: POOR (max R-hat {worst:.4f} >= {RHAT_GOOD})"
    lines.append(verdict)
    print("\n".join(lines), file=file)
    return summaries
