"""The PyTorch port's HMC and SMC paths on a CUDA device.

Every test here is marked ``gpu`` and skips without a card. The file imports
no JAX, so it runs on a machine with a card and no JAX, past the suite's
conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

The HMC tests compare a CUDA run with the same computation on the CPU in
float64, where the two differ only in summation order (tolerance 1e-10).
The SMC kernels are held against their plain versions on the card:
logsumexp to 1e-12 relative in float64 and within the plain float32
version's error of float64 in float32; systematic resampling in float64 to
a deviation of at most 1 on fewer than 0.1% of slots, sorted, in range and
the same run to run.
"""

import math

import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

import fugue_tpu_torch as ftt
from chip_smoke import capture, conjugate_evidence_model, eight_schools_model, plate_model
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference import hmc
from fugue_tpu_torch.ops import kernels as K

TOL = dict(rtol=1e-10, atol=1e-10)

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _cuda_x64():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def _plate(device, n=(1 << 16) + 5):
    y = torch.as_tensor(np.random.default_rng(0).normal(1.5, 2.0, n), device=device)
    return ftt.stage(plate_model(y), device=device)


def _eight_schools(device):
    return ftt.stage(eight_schools_model(device, torch.float64), device=device)


def _inputs(dim, n=32, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.normal([1.5, 0.7] + [0.0] * (dim - 2), 0.05, (n, dim))
    p = rng.normal(0.0, 1.0, (n, dim))
    log_u = np.log(rng.uniform(size=n))
    return q, p, log_u


@pytest.mark.parametrize("make, eps", [(_plate, 0.002), (_eight_schools, 0.2)])
def test_transition_on_cuda_equals_cpu(make, eps):
    out = {}
    for dev in ("cpu", "cuda"):
        staged = make(dev)
        q, p, log_u = (torch.as_tensor(a, device=dev) for a in _inputs(staged.dim))
        im = torch.ones(staged.dim, dtype=torch.float64, device=dev)
        out[dev] = hmc.hmc_transition(staged.potential, q, p, log_u, eps, 8, im)
    qc, ic = out["cpu"]
    qg, ig = out["cuda"]
    np.testing.assert_allclose(qg.cpu().numpy(), qc.numpy(), **TOL)
    np.testing.assert_allclose(ig.accept_prob.cpu().numpy(), ic.accept_prob.numpy(), **TOL)
    assert torch.equal(ig.accepted.cpu(), ic.accepted)


def test_potential_path_never_syncs_with_the_host():
    """A whole transition on the plate model (kernel included) runs with
    CUDA sync debugging set to raise on any device-to-host synchronisation."""
    staged = _plate("cuda")
    q, p, log_u = (torch.as_tensor(a, device="cuda") for a in _inputs(staged.dim))
    im = torch.ones(staged.dim, dtype=torch.float64, device="cuda")
    eps = torch.full((32,), 0.002, dtype=torch.float64, device="cuda")
    hmc.hmc_transition(staged.potential, q, p, log_u, eps, 4, im)  # load the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hmc.hmc_transition(staged.potential, q, p, log_u, eps, 4, im)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_one_launch_per_batched_gradient():
    staged = _plate("cuda")
    q = torch.as_tensor(_inputs(staged.dim)[0], device="cuda")
    before = dict(K.LAUNCHES)
    g, u = vmap(grad_and_value(staged.potential))(q)
    torch.cuda.synchronize()
    assert K.LAUNCHES["nll"] == before["nll"] + 1
    assert g.shape == (32, 2) and bool(torch.isfinite(u).all())


def test_second_derivative_raises_on_cuda():
    y = torch.as_tensor(np.random.default_rng(0).normal(1.5, 2.0, 4096), device="cuda")
    mu = torch.full((3,), 1.4, dtype=torch.float64, device="cuda", requires_grad=True)
    sigma = torch.full((3,), 2.0, dtype=torch.float64, device="cuda")
    (g,) = torch.autograd.grad(ftt.pnormal_loglik_sum(y, mu, sigma).sum(), mu, create_graph=True)
    with pytest.raises(NotImplementedError):
        torch.autograd.grad(g.sum(), mu)


def test_wrapper_raises_instead_of_falling_back():
    y = torch.zeros(100, device="cuda")
    with pytest.raises(TypeError):  # dtype mismatch: no silent plain path
        K.pnormal_loglik_sum(y, torch.zeros((), dtype=torch.float64, device="cuda"), 1.0)
    with pytest.raises(ValueError):  # mixed devices
        K.pnormal_loglik_sum(y, torch.zeros(()), torch.ones(()))
    with pytest.raises(TypeError):
        K._check_launch(y.half(), y[:1].half(), y[:1].half())


def test_short_chain_on_cuda():
    staged = _eight_schools("cuda")
    res = ftt.hmc_chain(0, n_samples=60, n_warmup=60, n_chains=64, staged=staged,
                        config=ftt.HMCConfig(n_leapfrog=8, target_accept=0.9))
    mu = res.samples["mu"]
    assert mu.is_cuda and mu.shape == (64, 60) and bool(torch.isfinite(mu).all())
    assert res.final_positions.is_cuda and 0.0 < res.step_size < 10.0


@pytest.mark.parametrize("n", [1, 1000, 131072, 3 * 8192 + 17])
def test_logsumexp_kernel_matches_plain(n):
    g = torch.Generator(device="cuda").manual_seed(n)
    x64 = 10.0 * torch.randn(n, generator=g, device="cuda", dtype=torch.float64)
    k, p = K.plogsumexp(x64), K.logsumexp_ref(x64)
    assert k.dtype == torch.float64 and abs(k.item() - p.item()) <= 1e-12 * abs(p.item())
    x = x64.float()
    k32, p32, r = K.plogsumexp(x), K.logsumexp_ref(x), K.logsumexp_ref(x.double())
    tol = max(abs(p32.item() - r.item()), torch.finfo(torch.float32).eps * abs(r.item()))
    assert abs(k32.double().item() - r.item()) <= tol
    assert torch.equal(K.plogsumexp(x), k32)


def test_logsumexp_kernel_special_values():
    x = torch.full((5000,), -math.inf, device="cuda")
    assert K.plogsumexp(x).item() == -math.inf
    x[4321] = 2.5
    assert K.plogsumexp(x).item() == 2.5
    x[17] = math.inf
    assert K.plogsumexp(x).item() == math.inf
    x[18] = math.nan
    assert math.isnan(K.plogsumexp(x).item())


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 131072 + 5])
@pytest.mark.parametrize("u0", [0.0, 0.5, 1.0 - 2.0**-52])
def test_resample_kernel_matches_plain(n, u0):
    g = torch.Generator(device="cuda").manual_seed(n)
    lw = 3.0 * torch.randn(n, generator=g, device="cuda", dtype=torch.float64)
    u = torch.tensor(u0, dtype=torch.float64, device="cuda")
    got = K.systematic_resample_from_u0(lw, u)
    plain = K.systematic_resample_ref(u, torch.exp(lw - K.logsumexp_ref(lw)))
    dev = (got - plain).abs()
    assert got.dtype == torch.int64 and got.shape == (n,)
    assert dev.max().item() <= 1 and (dev > 0).float().mean().item() < 1e-3
    assert bool((got[1:] >= got[:-1]).all()) and 0 <= got.min() and got.max() < n
    assert torch.equal(K.systematic_resample_from_u0(lw, u), got)


def test_resample_wrapper_raises_instead_of_falling_back():
    g = torch.Generator(device="cuda")
    with pytest.raises(TypeError):
        K.psystematic_resample(g, torch.zeros(8, dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError):
        K.psystematic_resample(g, torch.zeros(2, 8, device="cuda"))
    with pytest.raises(ValueError):
        K.psystematic_resample(g, torch.zeros(16, device="cuda")[::2])
    with pytest.raises(TypeError):  # u0 in another dtype than the weights
        K.systematic_resample_from_u0(torch.zeros(8, device="cuda"),
                                      torch.zeros((), dtype=torch.float64, device="cuda"))


def test_short_smc_run_goes_through_both_kernels():
    staged = ftt.stage(conjugate_evidence_model("cuda", torch.float64), device="cuda")
    before = dict(K.LAUNCHES)
    res = ftt.adaptive_smc(0, 2048, staged=staged, config=ftt.SMCConfig(rejuvenation_steps=2))
    torch.cuda.synchronize()
    s = res.n_stages
    assert res.converged and res.particles["mu"].is_cuda
    assert K.LAUNCHES["resample"] - before["resample"] == s - 1
    # the resample takes its own lse: 4 per stage and 3 at the end
    assert K.LAUNCHES["lse"] - before["lse"] == 4 * s + 3


def test_smc_kernels_from_views_graphs_and_without_weight():
    """Both SMC kernels from an unaligned x[1:] view, bitwise the same from
    a CUDA-graph replay as eagerly; no finite weight or a NaN weight gives
    the identity."""
    g = torch.Generator(device="cuda").manual_seed(4)
    for dtype in (torch.float32, torch.float64):
        x = (3.0 * torch.randn(131072 + 1, generator=g, device="cuda", dtype=dtype))[1:]
        u0 = torch.tensor(0.25, dtype=dtype, device="cuda")
        r = K.logsumexp_ref(x.double()).item()
        assert abs(K.plogsumexp(x).double().item() - r) <= 1e-6 * abs(r)
        for fn in (lambda: K.plogsumexp(x), lambda: K.systematic_resample_from_u0(x, u0)):
            want = fn()
            graph, out = capture(fn)
            for _ in range(2):
                graph.replay()
                torch.cuda.synchronize()
                assert torch.equal(out, want)
        ident = torch.arange(x.numel(), device="cuda")
        none = torch.full_like(x, -math.inf)
        assert torch.equal(K.systematic_resample_from_u0(none, u0), ident)
        x[9] = math.nan
        assert torch.equal(K.systematic_resample_from_u0(x, u0), ident)
