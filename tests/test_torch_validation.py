"""The PyTorch port's validation harness against fugue_tpu, on the CPU.

``ks_two_sample`` and the moment scoring (``_validate_moments``: the
multi-chain ESS, the 2-MC-SE checks and the efficiency floor) agree with
the JAX package's on the same numpy draws (1e-10, the same verdicts).
The two conjugate harnesses run through the hmc, mh and smc adapters, and
each mean and variance lies within 5 Monte-Carlo standard errors of the
closed form, computed from the result's own fields.
"""

import math

import numpy as np
import pytest
import torch

from fugue_tpu.inference import validation as jv
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference import validation as tv


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def test_ks_two_sample_matches_jax():
    rng = np.random.default_rng(0)
    cases = [(rng.normal(size=300), rng.normal(size=200)),
             (rng.normal(size=300), rng.normal(0.3, 1.0, size=500)),
             (rng.uniform(size=50), rng.uniform(size=50) ** 2)]
    for a, b in cases:
        assert tv.ks_two_sample(a, b) == pytest.approx(jv.ks_two_sample(a, b), rel=1e-10)


def test_moment_scoring_matches_jax():
    rng = np.random.default_rng(1)
    ar = np.zeros((4, 500))
    for t in range(1, 500):
        ar[:, t] = 0.8 * ar[:, t - 1] + rng.normal(size=4)
    for draws, m, v in ((ar, 0.0, 1.0 / (1 - 0.64)), (rng.normal(2.0, 0.5, 800), 2.0, 0.25),
                        (rng.normal(size=(2, 100)) * 3, 1.0, 1.0)):
        j = jv._validate_moments(draws, m, v)
        t = tv._validate_moments(draws, m, v)
        assert t.checks == j.checks and t.passed == j.passed
        for field in ("observed_mean", "observed_var", "ess"):
            assert getattr(t, field) == pytest.approx(getattr(j, field), rel=1e-10)
        assert t.n_draws == j.n_draws
        assert t.report() == j.report()


def _within_5se(r):
    """The result's mean and variance within 5 Monte-Carlo standard errors
    of the closed form (the harness's own 2-SE checks fail by chance)."""
    se_mean = math.sqrt(r.expected_var / r.ess)
    se_var = r.expected_var * math.sqrt(2.0 / max(r.ess - 1.0, 1.0))
    return (abs(r.observed_mean - r.expected_mean) < 5 * se_mean
            and abs(r.observed_var - r.expected_var) < 5 * se_var)


@pytest.mark.parametrize("sampler", ["hmc", "mh", "smc"])
def test_conjugate_harnesses_through_each_adapter(sampler):
    n = dict(n_samples=100, n_warmup=60, n_chains=8) if sampler == "hmc" \
        else dict(n_samples=250, n_warmup=100, n_chains=8)
    rn = tv.validate_conjugate_normal(0, sampler, tv.ConjugateNormalConfig(**n), device="cpu")
    rb = tv.validate_beta_bernoulli(1, sampler, tv.ConjugateBetaBernoulliConfig(**n),
                                    device="cpu")
    tau = 1 / 4 + 5
    assert rn.expected_mean == pytest.approx((5.5) / tau)
    assert rb.expected_mean == pytest.approx(15 / 24)
    for r in (rn, rb):
        assert _within_5se(r), r.report()
        assert r.n_draws == n["n_samples"] * n["n_chains"]
        assert set(r.checks) == {"mean within 2 MC SE", "variance within 2 MC SE (x2 slack)",
                                 "efficiency >= 10%"}
    with pytest.raises(ValueError):
        tv.validate_conjugate_normal(0, "nuts", device="cpu")
    assert isinstance(torch.tensor(rn.ess).item(), float)
