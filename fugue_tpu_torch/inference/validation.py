"""Analytic-posterior validation harness.

The port of ``fugue_tpu/inference/validation.py``: the two-sample KS test,
``ValidationResult``, the conjugate Normal-Normal and Beta-Bernoulli
harnesses with their configs, and the sampler adapters (hmc, mh, smc).
A harness runs an engine on a model with a closed-form posterior and
scores the draws' mean and variance within 2 Monte-Carlo standard errors
from the multi-chain ESS, plus a ≥ 10% sampling-efficiency floor: the
reference's verdict, kept exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from .. import settings
from .mcmc_utils import ess_multichain


def ks_two_sample(a, b):
    """Two-sample Kolmogorov-Smirnov statistic and asymptotic p-value."""
    a = np.sort(np.asarray(a, dtype=np.float64).ravel())
    b = np.sort(np.asarray(b, dtype=np.float64).ravel())
    n, m = len(a), len(b)
    both = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, both, side="right") / n
    cdf_b = np.searchsorted(b, both, side="right") / m
    d = float(np.max(np.abs(cdf_a - cdf_b)))
    en = np.sqrt(n * m / (n + m))
    lam = (en + 0.12 + 0.11 / en) * d
    # the asymptotic Kolmogorov survival function
    j = np.arange(1, 101)
    p = 2.0 * np.sum((-1.0) ** (j - 1) * np.exp(-2.0 * (lam * j) ** 2))
    return d, float(np.clip(p, 0.0, 1.0))


@dataclass
class ValidationResult:
    passed: bool
    checks: Dict[str, bool]
    observed_mean: float
    observed_var: float
    expected_mean: float
    expected_var: float
    ess: float
    n_draws: int
    details: str = ""

    def report(self) -> str:
        lines = [
            f"validation: {'PASS' if self.passed else 'FAIL'}",
            f"  mean: {self.observed_mean:.4f} vs {self.expected_mean:.4f}",
            f"  var:  {self.observed_var:.4f} vs {self.expected_var:.4f}",
            f"  ess:  {self.ess:.1f} / {self.n_draws} draws",
        ]
        for name, ok in self.checks.items():
            lines.append(f"  [{'x' if ok else ' '}] {name}")
        if self.details:
            lines.append(f"  {self.details}")
        return "\n".join(lines)


def _validate_moments(
    draws,
    expected_mean: float,
    expected_var: float,
    min_efficiency: float = 0.10,
) -> ValidationResult:
    """Score mean and variance within 2 MC standard errors from the
    multi-chain ESS, and the efficiency floor."""
    draws = np.asarray(draws, dtype=np.float64)
    if draws.ndim == 1:
        draws = draws[None, :]
    n_total = draws.size
    e = float(ess_multichain(torch.as_tensor(draws)))
    e = max(e, 1.0)
    mean = float(draws.mean())
    var = float(draws.var(ddof=1))
    se_mean = np.sqrt(expected_var / e)
    # SE of a sample variance ~ var * sqrt(2/(e-1))
    se_var = expected_var * np.sqrt(2.0 / max(e - 1.0, 1.0))
    checks = {
        "mean within 2 MC SE": abs(mean - expected_mean) <= 2.0 * se_mean,
        "variance within 2 MC SE (x2 slack)": abs(var - expected_var)
        <= 4.0 * se_var,
        f"efficiency >= {min_efficiency:.0%}": e >= min_efficiency * n_total,
    }
    return ValidationResult(
        passed=all(checks.values()),
        checks=checks,
        observed_mean=mean,
        observed_var=var,
        expected_mean=expected_mean,
        expected_var=expected_var,
        ess=e,
        n_draws=n_total,
    )


@dataclass(frozen=True)
class ConjugateNormalConfig:
    prior_mean: float = 0.0
    prior_sd: float = 2.0
    obs_sd: float = 1.0
    observations: tuple = (1.2, 0.8, 1.5, 0.9, 1.1)
    n_samples: int = 1500
    n_warmup: int = 500
    n_chains: int = 8
    min_efficiency: float = 0.10


@dataclass(frozen=True)
class ConjugateBetaBernoulliConfig:
    prior_alpha: float = 2.0
    prior_beta: float = 2.0
    successes: int = 13
    failures: int = 7
    n_samples: int = 1500
    n_warmup: int = 500
    n_chains: int = 8
    min_efficiency: float = 0.10


def validate_conjugate_normal(
    seed: int,
    sampler: str = "hmc",
    config: ConjugateNormalConfig = ConjugateNormalConfig(),
    *,
    device="cuda",
) -> ValidationResult:
    """Normal-Normal round trip on ``device``."""
    import fugue_tpu_torch as ftt

    dt = settings.real_dtype()
    ys = torch.tensor(config.observations, dtype=dt, device=device)
    tau0 = 1.0 / config.prior_sd**2
    tau_l = len(config.observations) / config.obs_sd**2
    tau = tau0 + tau_l
    post_mean = (tau0 * config.prior_mean + sum(config.observations) / config.obs_sd**2) / tau
    post_var = 1.0 / tau

    def model():
        mu = ftt.sample("mu", ftt.Normal(config.prior_mean, config.prior_sd))
        ftt.observe("ys", ftt.Normal(mu, config.obs_sd), ys)
        return mu

    draws = _run_sampler(seed, model, "mu", sampler, config, device)
    return _validate_moments(draws, post_mean, post_var, config.min_efficiency)


def validate_beta_bernoulli(
    seed: int,
    sampler: str = "hmc",
    config: ConjugateBetaBernoulliConfig = ConjugateBetaBernoulliConfig(),
    *,
    device="cuda",
) -> ValidationResult:
    """Beta-Bernoulli round trip on ``device``."""
    import fugue_tpu_torch as ftt

    a = config.prior_alpha + config.successes
    b = config.prior_beta + config.failures
    post_mean = a / (a + b)
    post_var = a * b / ((a + b) ** 2 * (a + b + 1))
    obs = torch.tensor([True] * config.successes + [False] * config.failures, device=device)

    def model():
        p = ftt.sample("p", ftt.Beta(config.prior_alpha, config.prior_beta))
        ftt.observe("obs", ftt.Bernoulli(p), obs)
        return p

    draws = _run_sampler(seed, model, "p", sampler, config, device)
    return _validate_moments(draws, post_mean, post_var, config.min_efficiency)


def _run_sampler(seed: int, model, address: str, sampler: str, config, device) -> np.ndarray:
    """(chains, draws) of ``address`` under the named engine."""
    if sampler == "hmc":
        from .hmc import hmc_chain

        res = hmc_chain(seed, model, n_samples=config.n_samples, n_warmup=config.n_warmup,
                        n_chains=config.n_chains, device=device)
        return res.samples[address].cpu().numpy()
    if sampler == "mh":
        from .mh import adaptive_mcmc_chain

        res = adaptive_mcmc_chain(seed, model, n_samples=config.n_samples,
                                  n_warmup=config.n_warmup, n_chains=config.n_chains,
                                  device=device)
        return res.samples[address].cpu().numpy()
    if sampler == "smc":
        from ..core.rng import fold_seed
        from ..ops.resampling import systematic_resample
        from .smc import adaptive_smc

        res = adaptive_smc(seed, config.n_samples * config.n_chains, model, device=device)
        g = torch.Generator(device=res.log_weights.device).manual_seed(fold_seed(seed, 1))
        idx = systematic_resample(g, res.log_weights)
        return res.particles[address][idx].cpu().numpy()[None, :]
    raise ValueError(f"unknown sampler {sampler!r}")
