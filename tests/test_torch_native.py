"""The PyTorch port's C++ host backend (``fugue_tpu_torch/utils/native.py``).

Two implementations derived separately must agree: the direct O(n·lag)
compensated-sum estimators of ``fugue_tpu_torch/csrc/fugue_host.cpp``
against the port's ``inference/mcmc_utils`` and ``inference/diagnostics``
(the tolerances of ``tests/test_native.py``), and against the JAX
package's native backend where that is available. The port's copy of the
source is the JAX package's, byte for byte.
"""

import pathlib

import numpy as np
import pytest
import torch

from fugue_tpu_torch.inference import diagnostics
from fugue_tpu_torch.inference import mcmc_utils as mu
from fugue_tpu_torch.utils import native

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _built():
    if not native.available():
        pytest.skip("no C++ toolchain")


def ar1(rng, phi, n):
    x = np.empty(n)
    innov = rng.normal(size=n)
    x[0] = innov[0]
    for i in range(1, n):
        x[i] = phi * x[i - 1] + innov[i]
    return x


def test_source_is_the_jax_packages():
    ours = (REPO / "fugue_tpu_torch" / "csrc" / "fugue_host.cpp").read_bytes()
    assert ours == (REPO / "csrc" / "fugue_host.cpp").read_bytes()
    assert native.library_path().parent == REPO / "fugue_tpu_torch" / "_build"
    assert native.library_path().is_file()


@pytest.mark.parametrize("phi", [0.0, 0.5, 0.9])
def test_ess_cross_validates(phi):
    x = ar1(np.random.default_rng(0), phi, 8000)
    assert native.ess(x) == pytest.approx(mu.ess(torch.as_tensor(x)).item(), rel=0.02)


def test_ess_batch():
    rng = np.random.default_rng(1)
    xs = np.stack([ar1(rng, 0.0, 4000), ar1(rng, 0.8, 4000)])
    np.testing.assert_allclose(native.ess_batch(xs), mu.ess(torch.as_tensor(xs)).numpy(),
                               rtol=0.02)


def test_multichain_ess_cross_validates():
    rng = np.random.default_rng(2)
    chains = np.stack([ar1(rng, 0.6, 3000) for _ in range(4)])
    assert native.ess_multichain(chains) == pytest.approx(
        mu.ess_multichain(torch.as_tensor(chains)).item(), rel=0.02)


def test_r_hat_cross_validates():
    rng = np.random.default_rng(3)
    good = rng.normal(size=(4, 2000))
    bad = good + np.array([0.0, 0.0, 0.0, 2.0])[:, None]
    for x in (good, bad):
        t = torch.as_tensor(x)
        assert native.split_r_hat(x) == pytest.approx(mu.split_r_hat(t).item(), rel=1e-6)
        assert native.r_hat(x) == pytest.approx(mu.r_hat(t).item(), rel=1e-6)
    assert native.split_r_hat(bad) > 1.1


def test_quantiles_match_the_port_and_numpy():
    x = np.random.default_rng(4).normal(size=10001)
    qs = [0.025, 0.25, 0.5, 0.75, 0.975]
    got = native.quantiles(x, qs)
    np.testing.assert_allclose(got, mu.quantile(torch.as_tensor(x), qs).numpy(), rtol=1e-10)
    np.testing.assert_allclose(got, np.quantile(x, qs), rtol=1e-10)
    summary = diagnostics.summarize_samples({"x": torch.as_tensor(x[:10000]).reshape(4, 2500)},
                                            quantiles=qs)[0]
    np.testing.assert_allclose([summary.quantiles[q] for q in qs],
                               native.quantiles(x[:10000], qs), rtol=1e-10)
    assert summary.r_hat == pytest.approx(native.split_r_hat(x[:10000].reshape(4, 2500)),
                                          rel=1e-6)


def test_matches_the_jax_native_backend():
    from fugue_tpu.utils import native as jax_native

    if not jax_native.available():
        pytest.skip("the JAX package's native backend did not build")
    rng = np.random.default_rng(5)
    chains = np.stack([ar1(rng, 0.7, 2000) for _ in range(4)])
    qs = [0.1, 0.5, 0.9]
    for name, args in (("ess", (chains[0],)), ("ess_batch", (chains,)),
                       ("ess_multichain", (chains,)), ("r_hat", (chains,)),
                       ("split_r_hat", (chains,)), ("quantiles", (chains[1], qs))):
        np.testing.assert_allclose(getattr(native, name)(*args),
                                   getattr(jax_native, name)(*args), rtol=1e-12)


def test_errors_without_a_library(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    for fn, args in ((native.ess, ([1.0, 2.0],)), (native.ess_batch, (np.ones((2, 3)),)),
                     (native.ess_multichain, (np.ones((2, 3)),)),
                     (native.r_hat, (np.ones((2, 3)),)),
                     (native.split_r_hat, (np.ones((2, 4)),)),
                     (native.quantiles, ([1.0, 2.0], [0.5]))):
        with pytest.raises(RuntimeError, match="native backend unavailable"):
            fn(*args)
