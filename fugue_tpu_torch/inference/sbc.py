"""Simulation-based calibration (Talts et al. 2018).

The port of ``fugue_tpu/inference/sbc.py``: ``SBCResult`` and ``sbc``.
For each synthetic dataset m: draw θ_m from the prior and y_m from
p(y | θ_m), run HMC on y_m, and record the rank of θ_m among L thinned
posterior draws. A sampler that targets the right posterior gives ranks
uniform on {0..L}; a χ² test per coordinate catches bias and over- or
under-dispersion.

How the datasets run: as ONE batch of chains, chain m on dataset m. The
model takes its observed data as one dict argument keyed by observed
address, and each chain's dataset enters the batched potential as a
per-chain argument (the model runs once per batched force evaluation).
Each dataset keeps the adaptation of its own one-chain HMC run, as in the
JAX package: ``make_hmc_drive(per_chain=True)`` gives every chain its own
reasonable-ε search, dual averaging on its own acceptance, its own
two-window Welford mass (diagonal or dense) and its own jitter.
The prior-predictive draws are one batched model run.

Ranks are taken on the UNCONSTRAINED flat coordinates (the transforms are
coordinate-wise monotone, so ranks are invariant); models with simplex
sites are rejected.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from .. import settings
from ..core.rng import fold_seed
from ..errors import ErrorCode, StagingError
from ..runtime.handler import run
from ..runtime.interpreters import PredictiveHandler
from ..runtime.staging import StagedModel, stage
from .hmc import HMCConfig, initial_positions, make_hmc_drive


@dataclass
class SBCResult:
    """Rank statistics and the per-coordinate χ² uniformity report."""

    ranks: np.ndarray  # (n_datasets, d) ints in [0, L]
    n_posterior: int  # L
    coords: List[str]  # flat-coordinate labels (address[index])
    chi2: np.ndarray  # (d,) χ² statistics over n_bins equal bins
    p_values: np.ndarray  # (d,)
    n_bins: int
    passed: bool  # Bonferroni-corrected min p-value above alpha

    def report(self) -> str:
        lines = [
            f"SBC: {self.ranks.shape[0]} datasets x {self.n_posterior} "
            f"posterior draws, {self.n_bins} bins "
            f"({'PASS' if self.passed else 'FAIL'})"
        ]
        for j, name in enumerate(self.coords):
            lines.append(
                f"  {name:<24} chi2={self.chi2[j]:8.2f}  "
                f"p={self.p_values[j]:.4f}"
            )
        return "\n".join(lines)


def _with_data(staged: StagedModel, data) -> StagedModel:
    """The staged model with its one data argument replaced (a shallow
    copy: the site table is shared)."""
    s = copy.copy(staged)
    s.args = (data,)
    return s


def sbc(
    seed: int,
    model_fn: Callable,
    data_template: Dict[str, Any],
    *,
    n_datasets: int = 128,
    n_posterior: int = 127,
    n_warmup: int = 300,
    thin: int = 4,
    config: Optional[HMCConfig] = None,
    n_bins: Optional[int] = None,
    alpha: float = 0.01,
    inference_model_fn: Optional[Callable] = None,
    device="cuda",
) -> SBCResult:
    """Simulation-based calibration of the HMC pipeline on ``model_fn``,
    every dataset's chain in one batch on ``device``.

    ``data_template``: ``{observed_address: template}``, the model's single
    data argument; shapes fix the dataset layout, the values are replaced
    by prior-predictive draws per dataset.

    ``inference_model_fn``: run the sampler under another model than the
    generator (default: the same). A deliberately wrong prior is the
    harness's own negative control: its ranks fail the χ² test."""
    if config is None:
        config = HMCConfig(n_leapfrog=16)
    dt = settings.real_dtype()
    data_template = {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in data_template.items()}
    data_template = {k: v.to(dt) if v.is_floating_point() else v for k, v in data_template.items()}
    staged = stage(model_fn, data_template, device=device)
    staged_inf = (staged if inference_model_fn is None
                  else stage(inference_model_fn, data_template, device=device))
    if [s_.address for s_ in staged_inf.continuous_sites] != [
            s_.address for s_ in staged.continuous_sites]:
        raise StagingError(
            ErrorCode.NOT_STAGEABLE,
            "generator and inference models must share the latent site set",
        )
    d = staged.dim
    if d == 0:
        raise StagingError(ErrorCode.NOT_STAGEABLE, "model has no continuous latent sites")
    if staged.discrete_sites:
        raise StagingError(
            ErrorCode.NOT_STAGEABLE,
            "SBC ranks discrete sites are not supported; marginalize first",
            {"discrete": [s.address for s in staged.discrete_sites]},
        )
    for s in staged.continuous_sites:
        if s.support.kind in ("simplex", "ordered"):
            raise StagingError(
                ErrorCode.NOT_STAGEABLE,
                f"{s.support.kind} sites break coordinate-wise rank invariance",
                {"site": s.address},
            )
    missing = set(staged.observed_addresses) - set(data_template)
    if missing:
        raise StagingError(
            ErrorCode.NOT_STAGEABLE,
            "data_template must carry every observed address",
            {"missing": sorted(missing)},
        )

    # (θ_m, y_m) ~ the prior predictive, every dataset in one model run
    def draw(_):
        _, tr = run(PredictiveHandler(fold_seed(seed, 41), {}, device), staged.model_fn,
                    *staged.args, **staged.kwargs)
        return ({s.address: tr.choices[s.address].value for s in staged.continuous_sites},
                {a: tr.choices[a].value.to(data_template[a].dtype) for a in data_template})

    latents, data = vmap(draw, randomness="different")(
        torch.zeros(n_datasets, device=staged.device))
    z_true = vmap(staged_inf.unconstrain)(latents).to(dt)

    grad_u = vmap(grad_and_value(lambda z, dm: _with_data(staged_inf, dm).potential(z)))

    def force(q):
        return grad_u(q, data)

    generator = torch.Generator(device=staged.device).manual_seed(int(seed))
    q0 = initial_positions(staged_inf, generator, n_datasets, config.init)
    drive = make_hmc_drive(staged_inf, config, n_datasets, n_posterior * thin, n_warmup,
                           force_fn=force, per_chain=True)
    _, qs, _, _, _, _, _ = drive(q0, generator)
    z_post = qs[thin - 1::thin]  # (n_posterior, n_datasets, d), thinned
    ranks = torch.sum((z_post < z_true[None]).to(torch.int64), dim=0).cpu().numpy()

    # χ² uniformity over equal-width bins of {0..L}
    L = n_posterior
    if n_bins is None:
        n_bins = max(4, min(20, (L + 1) // 8))
    edges = np.linspace(0, L + 1, n_bins + 1)
    expected = n_datasets / n_bins
    chi2 = np.zeros(d)
    for j in range(d):
        counts, _ = np.histogram(ranks[:, j], bins=edges)
        chi2[j] = float(((counts - expected) ** 2 / expected).sum())
    # the χ² survival function: the regularized upper incomplete gamma
    p_values = torch.special.gammaincc(
        torch.tensor((n_bins - 1) / 2.0, dtype=torch.float64),
        torch.as_tensor(chi2 / 2.0, dtype=torch.float64)).numpy()
    passed = bool(p_values.min() > alpha / d)  # Bonferroni

    coords = []
    for s in staged.continuous_sites:
        if s.z_size == 1:
            coords.append(s.address)
        else:
            coords.extend(f"{s.address}[{i}]" for i in range(s.z_size))
    return SBCResult(
        ranks=ranks,
        n_posterior=L,
        coords=coords,
        chi2=chi2,
        p_values=p_values,
        n_bins=n_bins,
        passed=passed,
    )
