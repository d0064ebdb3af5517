"""Parity of the PyTorch port's convergence diagnostics with fugue_tpu.

split-R-hat, R-hat, rank-normalized split-R-hat, Geweke, single-chain ESS,
multi-chain ESS and the summary table on a fixed (4, 500) array of
autocorrelated draws made with numpy (and Cauchy chains), in float64; the
trace-list extractors on traces built the same way in both packages. Tolerance 1e-8 relative: the FFT autocovariances of torch and
XLA round differently, and Geyer's truncation sums a few hundred lags.
"""

import io

import jax.numpy as jnp
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


def _heavy(seed=4):
    """Cauchy chains, one with twice the scale: bulk and tail disagree."""
    x = np.random.default_rng(seed).standard_cauchy((4, 400))
    x[1] *= 2.0
    return x


@pytest.mark.parametrize("name", ["fixed", "batched", "heavy_tailed", "with_ties"])
def test_rank_normalized_split_r_hat_matches_jax(name):
    if name == "fixed":
        x = FIXED
    elif name == "batched":
        x = np.stack([_chains(seed=s, phi=p) for s, p in ((1, 0.0), (2, 0.9), (3, -0.5))])
    elif name == "heavy_tailed":
        x = _heavy()
    else:
        x = np.round(FIXED, 1)  # many equal draws: ranks break ties in order
    got = tm.rank_normalized_split_r_hat(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.rank_normalized_split_r_hat(x)), **TOL)
    np.testing.assert_allclose(tm._rank_normalize(torch.as_tensor(x)).numpy(),
                               np.asarray(jm._rank_normalize(x)), **TOL)


@pytest.mark.parametrize("first, last", [(0.1, 0.5), (0.2, 0.3), (0.001, 0.001)])
def test_geweke_matches_jax(first, last):
    x = np.concatenate([FIXED, FIXED[:, ::-1]], axis=0)
    got = tm.geweke(torch.as_tensor(x), first, last).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.geweke(x, first, last)), **TOL)
    np.testing.assert_allclose(tm._spectral_var(torch.as_tensor(x)).numpy(),
                               np.asarray(jm._spectral_var(jnp.asarray(x))), **TOL)


def test_geweke_flags_a_drifting_chain():
    drift = FIXED[0] + np.linspace(0.0, 5.0, FIXED.shape[1])
    z = tm.geweke(torch.as_tensor(np.stack([FIXED[0], drift]))).numpy()
    assert abs(z[0]) < 2.0 < abs(z[1])
    assert tm.geweke(torch.ones(50)).item() == 0.0


def _traces(pkg, kind):
    """Three traces with real, bool and int choices at a few addresses."""
    tensor = (lambda v: torch.tensor(v)) if kind == "torch" else (lambda v: jnp.asarray(v))
    out = []
    for i in range(3):
        t = pkg.Trace()
        t.insert_choice("x", pkg.Choice(value=tensor(0.5 * i), log_prob=tensor(-1.0)))
        t.insert_choice("flag", pkg.Choice(value=tensor(i % 2 == 0), log_prob=tensor(-0.7)))
        if i != 1:
            t.insert_choice("k", pkg.Choice(value=tensor(3 * i), log_prob=tensor(-2.0)))
        out.append(t)
    return out


def test_extractors_match_jax():
    from fugue_tpu.runtime import trace as jtrace
    from fugue_tpu_torch.runtime import trace as ttrace

    tt, jt = _traces(ttrace, "torch"), _traces(jtrace, "jax")
    for fn, addr in (("extract_real", "x"), ("extract_bool", "flag"), ("extract_int", "k"),
                     ("extract_real", "flag"), ("extract_int", "missing")):
        got = getattr(tdiag, fn)(tt, addr)
        want = getattr(jdiag, fn)(jt, addr)
        assert got.dtype == want.dtype and got.tolist() == want.tolist(), (fn, addr)
    assert tdiag.extract_int(tt, "k").tolist() == [0, 6]


@pytest.mark.parametrize("n", [1, 2, 3, 10, 101])
def test_quantile_matches_numpy(n):
    """``mcmc_utils.quantile`` (from torch.sort) is numpy's default linear
    quantile: scalar and listed q, batched rows, ties."""
    rng = np.random.default_rng(n)
    x = np.concatenate([rng.normal(size=(3, n)), np.round(rng.normal(size=(2, n)), 1)])
    qs = [0.0, 0.025, 0.25, 0.5, 0.5 + 1e-9, 0.75, 0.975, 1.0]
    got = tm.quantile(torch.as_tensor(x), qs).numpy()
    np.testing.assert_allclose(got, np.moveaxis(np.quantile(x, qs, axis=-1), 0, -1), rtol=1e-14, atol=1e-15)
    for q in (0.5, 0.9):
        np.testing.assert_allclose(tm.quantile(torch.as_tensor(x), q).numpy(),
                                   np.quantile(x, q, axis=-1), rtol=1e-14, atol=1e-15)


# 1024 chains x 16,385 draws: just over 2^24 pooled draws, where
# torch.quantile refuses its input
BIG = (1024, 16385)


def test_rank_normalized_split_r_hat_beyond_2_24_draws():
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(BIG))
    assert x.numel() > 1 << 24
    r = tm.rank_normalized_split_r_hat(x).item()
    assert abs(r - 1.0) < 1e-3  # independent draws of one distribution
    assert tm.quantile(x.reshape(-1), 0.5).item() == float(np.median(x.numpy()))


def test_summaries_beyond_2_24_draws():
    x = np.random.default_rng(8).standard_normal(BIG)
    (s,) = tdiag.summarize_samples({"x": torch.as_tensor(x)})
    want = np.quantile(x, tdiag.DEFAULT_QUANTILES)
    np.testing.assert_allclose([s.quantiles[q] for q in tdiag.DEFAULT_QUANTILES], want,
                               rtol=1e-14, atol=1e-15)
    assert (s.n_chains, s.n_samples) == BIG
