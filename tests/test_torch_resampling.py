"""The port's resampling module and its two kernels' plain versions, on the CPU.

On the CPU ``plogsumexp`` and ``psystematic_resample`` run their plain
PyTorch versions; these are held against fugue_tpu's Pallas kernels run as
tests/test_pallas_kernels.py runs them (Pallas forced on, TPU interpret
mode) and against its XLA paths, in float64, on the same numpy inputs:

- log-sum-exp: relative 1e-12 (all -inf: exactly -inf);
- systematic resampling: exact equality with ``systematic_resample_xla``
  for the same u0 and weights; against the Pallas kernel (whose prefix is a
  float carry) a deviation of at most 1 on fewer than 0.1% of slots;
- the other resamplers: unbiased offspring counts, as tests/test_smc.py;
- normalisation and ESS: 1e-12.

The CUDA kernels themselves run only on a card (tests/test_torch_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fugue_tpu.ops import pallas_kernels as pk
from fugue_tpu.ops import resampling as jrs
from fugue_tpu_torch import settings
from fugue_tpu_torch.ops import kernels as K
from fugue_tpu_torch.ops import resampling as trs

TOL = dict(rtol=1e-12, atol=1e-12)
N = 3 * 8192 + 17


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


@pytest.fixture
def pallas_interpret():
    from jax.experimental.pallas import tpu as pltpu

    pk.enable_pallas(True)
    try:
        with pltpu.force_tpu_interpret_mode():
            yield
    finally:
        pk.enable_pallas(None)


def _lse_input(kind, n=N):
    if kind == "normal_x10":
        return np.random.default_rng(0).normal(size=n) * 10
    x = np.full(n, -np.inf)
    if kind == "one_finite":
        x[5] = 3.0
    return x


@pytest.mark.parametrize("kind", ["normal_x10", "all_neg_inf", "one_finite"])
def test_plogsumexp_plain_matches_pallas_interpret(pallas_interpret, kind):
    x = _lse_input(kind)
    want = float(pk.plogsumexp(jnp.asarray(x)))
    got = K.plogsumexp(torch.as_tensor(x))
    assert got.dim() == 0 and got.dtype == torch.float64
    if np.isfinite(want):
        assert got.item() == pytest.approx(want, rel=1e-12)
    else:
        assert got.item() == want == -np.inf


def test_logsumexp_special_values():
    x = torch.zeros(10, dtype=torch.float64)
    x[3] = float("inf")
    assert K.plogsumexp(x).item() == float("inf")
    x[4] = float("nan")
    assert np.isnan(K.plogsumexp(x).item())
    assert K.plogsumexp(torch.zeros(2, 3, dtype=torch.float64)).item() == pytest.approx(np.log(6))


@pytest.mark.parametrize("n", [4, N, 1 << 14])
@pytest.mark.parametrize("u0", [0.0, 0.3, 1.0 - 2.0**-40])
def test_systematic_plain_equals_jax_xla(n, u0):
    logits = np.random.default_rng(n).normal(size=n) * 4.0
    w = np.exp(logits - logits.max())
    w /= w.sum()
    want = np.asarray(pk.systematic_resample_xla(jnp.float64(u0), jnp.asarray(w)))
    got = K.systematic_resample_ref(torch.tensor(u0, dtype=torch.float64), torch.as_tensor(w))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [1, 2])
def test_systematic_plain_vs_pallas_kernel(pallas_interpret, monkeypatch, seed):
    monkeypatch.setenv("FUGUE_TPU_PALLAS_RESAMPLE", "1")
    n = 2 * pk._BLOCK
    logits = np.random.default_rng(seed).normal(size=n) * 2.0
    lw = logits - float(pk.logsumexp_xla(jnp.asarray(logits)))
    key = jax.random.PRNGKey(seed)
    want = np.asarray(pk.psystematic_resample(key, jnp.asarray(lw)))
    u0 = float(jax.random.uniform(key, (), jnp.float64))
    got = K.systematic_resample_from_u0(torch.as_tensor(lw), torch.tensor(u0, dtype=torch.float64))
    dev = np.abs(got.numpy() - want.astype(np.int64))
    assert dev.max() <= 1 and (dev > 0).mean() < 1e-3


def test_psystematic_resample_draws_one_uniform():
    lw = torch.as_tensor(np.random.default_rng(3).normal(size=1000))
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    got = K.psystematic_resample(g1, lw)
    u0 = torch.rand((), generator=g2, dtype=torch.float64)
    assert torch.equal(got, K.systematic_resample_from_u0(lw, u0))
    assert torch.equal(g1.get_state(), g2.get_state())
    assert bool((got[1:] >= got[:-1]).all())


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        K.plogsumexp(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        K.plogsumexp(torch.zeros(0))
    with pytest.raises(ValueError):
        K.psystematic_resample(torch.Generator(), torch.zeros(2, 3))
    with pytest.raises(ValueError):
        K.psystematic_resample(torch.Generator(), torch.zeros(8)[::2])
    with pytest.raises(TypeError):
        K.psystematic_resample(torch.Generator(), torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        K.plogsumexp(torch.zeros(4, device="meta"))


@pytest.mark.parametrize("name", ["systematic", "stratified", "multinomial"])
def test_resampler_unbiased_counts(name):
    w = torch.tensor([0.1, 0.2, 0.3, 0.4], dtype=torch.float64)
    g = torch.Generator().manual_seed(0)
    counts = np.zeros(4)
    for _ in range(200):
        idx = trs.RESAMPLERS[name](g, torch.log(w))
        assert idx.dtype == torch.int64 and idx.shape == (4,)
        counts += np.bincount(idx.numpy(), minlength=4)
    np.testing.assert_allclose(counts / counts.sum(), w.numpy(), atol=0.02)


def test_resamplers_batched_and_resized():
    g = torch.Generator().manual_seed(1)
    lw = torch.log(torch.tensor([[0.25] * 4, [0.0, 0.0, 0.5, 0.5]], dtype=torch.float64))
    for name in trs.RESAMPLERS:
        idx = trs.RESAMPLERS[name](g, lw, 6)
        assert idx.shape == (2, 6)
        assert bool((idx[1] >= 2).all())
    sys_idx = trs.systematic_resample(g, lw[0], 8)
    np.testing.assert_array_equal(np.bincount(sys_idx.numpy(), minlength=4), [2, 2, 2, 2])


def test_systematic_low_variance():
    idx = trs.systematic_resample(torch.Generator().manual_seed(1),
                                  torch.log(torch.full((4,), 0.25, dtype=torch.float64)))
    np.testing.assert_array_equal(np.bincount(idx.numpy(), minlength=4), [1, 1, 1, 1])


@pytest.mark.parametrize("shape", [(64,), (3, 50)])
def test_normalize_and_ess_match_jax(shape):
    lw = np.random.default_rng(4).normal(size=shape) * 3.0
    jw, jlse = jrs.normalize_log_weights(jnp.asarray(lw))
    tw, tlse = trs.normalize_log_weights(torch.as_tensor(lw))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)
    np.testing.assert_allclose(trs.effective_sample_size(torch.as_tensor(lw)).numpy(),
                               np.asarray(jrs.effective_sample_size(jnp.asarray(lw))), **TOL)


def test_ess_bounds():
    assert trs.effective_sample_size(torch.zeros(64, dtype=torch.float64)).item() == pytest.approx(64.0)
    degenerate = torch.log(torch.tensor([1.0] + [1e-30] * 63, dtype=torch.float64))
    assert trs.effective_sample_size(degenerate).item() == pytest.approx(1.0, abs=1e-6)
