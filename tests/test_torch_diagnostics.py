"""Parity of the PyTorch port's convergence diagnostics with fugue_tpu.

split-R-hat, R-hat, single-chain ESS, multi-chain ESS and the summary table
on a fixed (4, 500) array of autocorrelated draws made with numpy, in
float64. Tolerance 1e-8 relative: the FFT autocovariances of torch and
XLA round differently, and Geyer's truncation sums a few hundred lags.
"""

import io

import numpy as np
import pytest
import torch

from fugue_tpu.inference import diagnostics as jdiag
from fugue_tpu.inference import mcmc_utils as jm
from fugue_tpu_torch.inference import diagnostics as tdiag
from fugue_tpu_torch.inference import mcmc_utils as tm

TOL = dict(rtol=1e-8, atol=1e-10)


def _chains(m=4, n=500, seed=0, phi=0.6):
    """AR(1) chains with per-chain offsets: autocorrelated and slightly
    unmixed, so every estimator's truncation and between-chain term count."""
    rng = np.random.default_rng(seed)
    x = np.empty((m, n))
    x[:, 0] = rng.normal(size=m)
    for t in range(1, n):
        x[:, t] = phi * x[:, t - 1] + rng.normal(size=m)
    return x + rng.normal(0.0, 0.2, (m, 1))


FIXED = _chains()


@pytest.mark.parametrize("name", ["split_r_hat", "r_hat", "ess", "ess_multichain"])
def test_estimators_match_jax(name):
    got = getattr(tm, name)(torch.as_tensor(FIXED)).numpy()
    want = np.asarray(getattr(jm, name)(FIXED))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("max_lag", [None, 10])
def test_autocovariance_matches_jax(max_lag):
    got = tm.autocovariance(torch.as_tensor(FIXED), max_lag).numpy()
    want = np.asarray(jm.autocovariance(FIXED, max_lag))
    np.testing.assert_allclose(got, want, **TOL)


def test_batched_over_parameters():
    x = np.stack([_chains(seed=s, phi=p) for s, p in ((1, 0.0), (2, 0.9), (3, -0.5))])
    for name in ("split_r_hat", "ess_multichain"):
        got = getattr(tm, name)(torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(jm, name)(x)), **TOL)


def test_constant_chains_give_zero_ess():
    x = torch.ones((4, 100), dtype=torch.float64)
    assert tm.ess_multichain(x).item() == 0.0
    assert float(np.asarray(jm.ess_multichain(np.ones((4, 100))))) == 0.0


def test_summaries_match_jax():
    samples = {"b": FIXED, "a": np.stack([FIXED, 2.0 * FIXED], axis=-1)}
    got = tdiag.summarize_samples({k: torch.as_tensor(v) for k, v in samples.items()})
    want = jdiag.summarize_samples(samples)
    assert [s.name for s in got] == [s.name for s in want] == ["a[0]", "a[1]", "b"]
    for g, w in zip(got, want):
        for f in ("mean", "sd", "r_hat", "ess"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f), **TOL)
        for q in tdiag.DEFAULT_QUANTILES:
            np.testing.assert_allclose(g.quantiles[q], w.quantiles[q], **TOL)
        assert (g.n_chains, g.n_samples, g.verdict) == (w.n_chains, w.n_samples, w.verdict)


def test_print_diagnostics_table():
    buf_t, buf_j = io.StringIO(), io.StringIO()
    tdiag.print_diagnostics({"x": torch.as_tensor(FIXED)}, file=buf_t)
    jdiag.print_diagnostics({"x": FIXED}, file=buf_j)
    assert buf_t.getvalue() == buf_j.getvalue()
    with pytest.raises(ValueError):
        tdiag.summarize_samples({"x": torch.zeros(5)})
