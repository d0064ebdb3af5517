"""The PyTorch port's HMC, NUTS, SMC, ChEES and MH paths on a CUDA device.

Every test here is marked ``gpu`` and skips without a card. The file imports
no JAX, so it runs on a machine with a card and no JAX, past the suite's
conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

The HMC tests compare a CUDA run with the same computation on the CPU in
float64, where the two differ only in summation order (tolerance 1e-10).
Every distribution's sampler draws on a CUDA generator inside
``sample_prior_batch`` (``vmap(randomness="different")``), held to its
mean within 6 standard errors, and its ``log_prob`` and gradient on CUDA
equal the CPU's in float64 (1e-12). The SMC kernels are held against their
plain versions on the card:
logsumexp to 1e-12 relative in float64 and within the plain float32
version's error of float64 in float32; systematic resampling in float64 to
a deviation of at most 1 on fewer than 0.1% of slots, sorted, in range and
the same run to run. A ChEES run and an adaptive MH run on the card equal
the same runs on the CPU from the same draws, and one ChEES transition
makes exactly one host sync (its τ read). Mean-field VI on the plate
equals its CPU run from the same draws, with one plate-kernel call per
iteration and one host sync per run; predictive is one model run on the
card; ABC-SMC's weight normalisations and terminal resample launch the
SMC kernels as the code says, with one host sync per proposal dispatch.
The split-bf16 products return float32 on the card (the ``out_dtype``
GEMM route) within 1e-3 relative of a float64 product of the same bf16
data, equal to their CPU versions, and a batched gradient over C chains
makes three GEMMs whatever C is. ``Categorical.uniform`` and numpy
parameters sample and score inside a model run on the card. The JSON-RPC
service runs on the card by default (its MH session reads back once per
``mh.step`` request, its SMC and particle filter launch the SMC kernels),
and a DSL index past the end of an array clamps on the card as on the CPU.
A traced ``hmc_chain`` call records one program ``potential`` span per
batched gradient, on the profiler's clock (``utils.profiling``).
Dense-mass HMC (bench.py's scale_densemass model at d = 8) takes the same
transition and the same short chain on the card as on the CPU from the same
draws, and the 128-group plate's model (at 8 groups) gives the CPU's
batched gradient on the card in float64, with no host sync.
``hmc_chain``'s transitions replayed from the drive's CUDA graph equal the
eager drive's bitwise in float32 with a diagonal mass; with a dense mass
cuBLAS takes another GEMM under capture, and a replayed transition is held
to the eager one to 1e-6; a resumed call replays without capturing;
explicit discrete values, or a potential that reads the host, keep the
drive eager.
"""

import math

import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

import fugue_tpu_torch as ftt
from chip_smoke import (_host_syncs, capture, conjugate_evidence_model, densemass_data,
                        densemass_model, eight_schools_model, group_plate_data,
                        group_plate_model, hierarchical_model, mixed_discrete_exact,
                        mixed_discrete_model, plate_model)
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference import chees, hmc, mh, nuts, vi
from fugue_tpu_torch.inference import mcmc_utils as mu_
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


def test_short_nuts_chain_on_cuda():
    """A short NUTS run on the plate model: the kernel is called once per
    batched model run, the draws stay on the card, and one NUTS transition
    equals the same transition on the CPU."""
    model_runs = [0]
    n = (1 << 16) + 5
    y = torch.as_tensor(np.random.default_rng(0).normal(1.5, 2.0, n), device="cuda")
    staged = ftt.stage(plate_model(y, model_runs), device="cuda")
    model_runs[0], before = 0, K.LAUNCHES["nll"]  # after the discovery run
    res = ftt.nuts_chain(0, staged=staged, n_samples=20, n_warmup=30, n_chains=16,
                         config=ftt.NUTSConfig(max_depth=6),
                         init_position=torch.stack([y.mean(), y.std().log()]))
    torch.cuda.synchronize()
    assert K.LAUNCHES["nll"] - before == model_runs[0] > 0
    mu = res.samples["mu"]
    assert mu.is_cuda and mu.shape == (16, 20) and bool(torch.isfinite(mu).all())
    assert res.n_leapfrogs > 0 and res.lockstep_leaves >= res.n_leapfrogs / 16
    assert res.host_syncs <= res.lockstep_leaves
    out = {}
    for dev in ("cpu", "cuda"):
        st = _plate(dev)
        g = torch.Generator().manual_seed(1)
        q = torch.as_tensor(_inputs(st.dim)[0], device=dev)
        im = torch.ones(st.dim, dtype=torch.float64)
        noise = nuts.draw_nuts_noise(g, im, q.shape[0], 6)
        noise = nuts.NutsNoise(**{k: v.to(dev) for k, v in vars(noise).items()})
        out[dev] = nuts.nuts_transition(st.potential, q, noise, 0.002, im.to(dev), 6)
    np.testing.assert_allclose(out["cuda"][0].cpu().numpy(), out["cpu"][0].numpy(), **TOL)
    for k in ("depth", "n_leapfrog", "diverging"):
        assert torch.equal(out["cuda"][1][k].cpu(), out["cpu"][1][k]), k


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


# (constructor, parameters, mean) of one case per distribution
SAMPLERS = {
    "Normal": (ftt.Normal, (1.5, 2.0), 1.5),
    "Uniform": (ftt.Uniform, (-2.0, 3.0), 0.5),
    "LogNormal": (ftt.LogNormal, (0.5, 0.75), math.exp(0.5 + 0.75**2 / 2)),
    "Exponential": (ftt.Exponential, (2.5,), 0.4),
    "Beta": (ftt.Beta, (2.0, 5.0), 2.0 / 7.0),
    "Gamma": (ftt.Gamma, (3.0, 2.0), 1.5),
    "StudentT": (ftt.StudentT, (5.0, 1.0, 2.0), 1.0),
    "Cauchy": (ftt.Cauchy, (0.5, 1.5), None),
    "Laplace": (ftt.Laplace, (-1.0, 2.0), -1.0),
    "Weibull": (ftt.Weibull, (1.8, 2.2), 2.2 * math.gamma(1 + 1 / 1.8)),
    "ChiSquared": (ftt.ChiSquared, (4.0,), 4.0),
    "InverseGamma": (ftt.InverseGamma, (3.0, 2.0), 1.0),
    "HalfNormal": (ftt.HalfNormal, (1.7,), 1.7 * math.sqrt(2 / math.pi)),
    "HalfCauchy": (ftt.HalfCauchy, (0.8,), None),
    "Bernoulli": (ftt.Bernoulli, (0.3,), 0.3),
    "BernoulliLogits": (ftt.BernoulliLogits, (-0.8,), 1 / (1 + math.exp(0.8))),
    "Categorical": (lambda p: ftt.Categorical(probs=torch.tensor(p, device="cuda")),
                    ([0.1, 0.2, 0.3, 0.4],), 2.0),
    "Binomial": (ftt.Binomial, (20, 0.35), 7.0),
    "Poisson": (ftt.Poisson, (4.5,), 4.5),
    "Geometric": (ftt.Geometric, (0.35,), 0.65 / 0.35),
    "NegativeBinomial": (ftt.NegativeBinomial, (6.0, 0.4), 6 * 0.6 / 0.4),
    "DiscreteUniform": (ftt.DiscreteUniform, (-3, 6), 1.5),
    "Dirichlet": (lambda c: ftt.Dirichlet(torch.tensor(c, device="cuda")), ([1.0, 2.0, 3.0],),
                  1.0 / 6.0),
    "MultivariateNormal": (lambda loc, cov: ftt.MultivariateNormal(
        torch.tensor(loc, device="cuda"), torch.tensor(cov, device="cuda")),
        ([0.5, -1.0], [[1.0, 0.6], [0.6, 2.0]]), 0.5),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_under_vmap_on_a_cuda_generator(name):
    ctor, args, mean = SAMPLERS[name]
    n = 20000

    def model():
        ftt.sample("x", ctor(*args))

    x = ftt.stage(model, device="cuda").sample_prior_batch(7, n)["x"]
    assert x.is_cuda and x.shape[0] == n
    assert x.dtype == ctor(*args).dtype
    first = x.reshape(n, -1)[:, 0].double()
    assert bool(torch.isfinite(first).all()) and len(torch.unique(first[:100])) > 1
    if mean is not None:
        sd = first.std().item()
        assert abs(first.mean().item() - mean) < 6 * sd / math.sqrt(n), (first.mean(), mean)


def _grid(name, n=32):
    """Per-element float64 parameters and values, on the CPU."""
    r = np.random.default_rng(len(name))
    pos = lambda: np.exp(r.normal(0.0, 0.5, n))  # noqa: E731
    if name == "Categorical":
        return [r.dirichlet(np.ones(4), n)], r.integers(-1, 5, n).astype(np.float64)
    if name == "Dirichlet":
        return [np.exp(r.normal(0, 0.5, (n, 3)))], r.dirichlet(np.ones(3), n)
    if name == "MultivariateNormal":
        a = np.tril(r.normal(0, 0.4, (n, 2, 2)), -1) + np.eye(2) * 1.3
        return [r.normal(0, 1, (n, 2)), a @ np.swapaxes(a, -1, -2)], r.normal(0, 1.5, (n, 2))
    k = {"Uniform": 2, "StudentT": 3, "Binomial": 2, "NegativeBinomial": 2,
         "DiscreteUniform": 2}.get(name, len(SAMPLERS[name][1]))
    params = [pos() for _ in range(k)]
    if name in ("Bernoulli", "Geometric"):
        params = [r.uniform(0.05, 0.95, n)]
    if name in ("Binomial", "NegativeBinomial"):
        params[1] = r.uniform(0.05, 0.95, n)
    if name in ("Binomial", "DiscreteUniform"):
        params[0] = r.integers(0, 6, n).astype(np.float64)
    if name == "DiscreteUniform":
        params[1] = params[0] + r.integers(0, 4, n)
    if name in ("Normal", "Cauchy", "Laplace", "BernoulliLogits"):
        params[0] = r.normal(0, 1.5, n)
    if name in ("Bernoulli", "BernoulliLogits"):
        return params, r.uniform(size=n) < 0.5
    if name in ("Binomial", "Poisson", "Geometric", "NegativeBinomial", "DiscreteUniform"):
        return params, r.integers(-1, 8, n).astype(np.float64)
    return params, r.normal(1.0, 1.5, n)


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_log_prob_on_cuda_equals_cpu_in_float64(name):
    params, values = _grid(name)
    cls = getattr(ftt, name)
    kw = {"Categorical": lambda p: cls(probs=p),
          "MultivariateNormal": lambda loc, c: cls(loc, covariance=c)}.get(name, cls)
    out = {}
    for dev in ("cpu", "cuda"):
        ps = [torch.as_tensor(p, device=dev) for p in params]
        v = torch.as_tensor(values, device=dev)

        def lp(*a):
            return kw(*a[:-1]).log_prob(a[-1])

        vals = vmap(lp)(*ps, v)
        grads = vmap(torch.func.grad(lp, argnums=tuple(range(len(ps)))))(*ps, v)
        out[dev] = [vals] + list(grads)
    for c, g in zip(out["cpu"], out["cuda"]):
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=1e-12, atol=1e-12)


def test_mh_step_on_cuda_equals_cpu_for_the_same_draws():
    """One batched MH step on the mixed-discrete model, with a count and a
    categorical site added, from the same particles and the same draws
    (made on the CPU): the CUDA step equals the CPU step."""
    def model(device):
        base = mixed_discrete_model(device, torch.float64)

        def m():
            base()
            ftt.sample("n", ftt.Poisson(3.0))
            ftt.sample("c", ftt.Categorical(probs=torch.tensor([0.2, 0.5, 0.3], device=device)))

        return m

    b = 256
    g = torch.Generator().manual_seed(3)
    cpu = ftt.stage(model("cpu"), device="cpu")
    lat = cpu.sample_prior_batch(5, b)
    adapt = mu_.AdaptationState(torch.log(torch.tensor([0.5, 2.6, 0.5, 0.7], dtype=torch.float64)),
                                torch.zeros(4, dtype=torch.float64))
    idx = torch.randint(0, 4, (b,), generator=g)
    eps = torch.randn((b, cpu.constrained_dim), generator=g, dtype=torch.float64)
    log_u = torch.log(torch.rand((b,), generator=g, dtype=torch.float64))
    disc = mh.draw_discrete_noise(cpu, adapt.scale(), g, b)
    out = {}
    for dev in ("cpu", "cuda"):
        st = cpu if dev == "cpu" else ftt.stage(model("cuda"), device="cuda")
        to = lambda t: t.to(dev)  # noqa: E731
        lat_d = {a: to(v) for a, v in lat.items()}
        state = mh.MHState(lat_d, vmap(st.log_joint)(lat_d),
                           mu_.AdaptationState(to(adapt.log_scale), to(adapt.t)))
        noise = {a: (None if v is None else tuple(map(to, v)) if isinstance(v, tuple) else to(v))
                 for a, v in disc.items()}
        out[dev] = mh.mh_step_from_noise(st, state, to(idx), to(eps), to(log_u), True,
                                         discrete_noise=noise)
    (sc, ac), (sg, ag) = out["cpu"], out["cuda"]
    assert torch.equal(ag.cpu(), ac) and 0 < int(ac.sum()) < b
    for a in lat:
        assert torch.equal(sg.latents[a].cpu(), sc.latents[a]) or np.allclose(
            sg.latents[a].cpu().numpy(), sc.latents[a].numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(sg.log_joint.cpu().numpy(), sc.log_joint.numpy(), **TOL)


def test_smc_on_the_mixed_discrete_model_on_cuda():
    staged = ftt.stage(mixed_discrete_model("cuda", torch.float64), device="cuda")
    before = dict(K.LAUNCHES)
    res = ftt.adaptive_smc(2, 32768, staged=staged, config=ftt.SMCConfig(rejuvenation_steps=5))
    torch.cuda.synchronize()
    s = res.n_stages
    log_z, p_heads = mixed_discrete_exact()
    assert res.converged and s >= 2 and res.particles["heads"].dtype == torch.bool
    assert K.LAUNCHES["resample"] - before["resample"] == s - 1
    assert K.LAUNCHES["lse"] - before["lse"] == 4 * s + 3
    assert abs(res.posterior_mean("heads").item() - p_heads) < 0.02
    assert abs(res.log_evidence - log_z) < 0.1


# torch's random functions that the port calls with an explicit generator
_RANDOM = ("rand", "randn", "randint", "bernoulli", "poisson", "binomial", "multinomial",
           "_standard_gamma")


def _cpu_draws(monkeypatch):
    """Make every draw on a CUDA generator come from a CPU generator with the
    same seed, moved to the card: a CUDA run then takes the draws of the
    same run on the CPU."""
    mirrors = {}

    def mirror(g):
        if g not in mirrors:
            mirrors[g] = torch.Generator().manual_seed(g.initial_seed())
        return mirrors[g]

    def wrap(fn):
        def draw(*args, generator=None, **kw):
            if generator is None or generator.device.type != "cuda":
                return fn(*args, generator=generator, **kw)
            dev = kw.pop("device", None) or generator.device
            args = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
            if any(isinstance(a, torch.Tensor) for a in args):
                return fn(*args, generator=mirror(generator), **kw).to(dev)
            return fn(*args, generator=mirror(generator), device="cpu", **kw).to(dev)

        return draw

    for name in _RANDOM:
        monkeypatch.setattr(torch, name, wrap(getattr(torch, name)))


def test_smc_on_the_mixed_discrete_model_on_cuda_equals_cpu(monkeypatch):
    """The same adaptive_smc run on the CPU and on the card, with the same
    draws: the same ladder, and the same particles but where the resample
    kernel's float64 rounding moves an ancestor by one (kernel tests: under
    0.1% of slots), so the posterior and log Z agree far inside their
    Monte-Carlo error."""
    n, cfg = 32768, ftt.SMCConfig(rejuvenation_steps=5)
    res = {dev: None for dev in ("cpu", "cuda")}
    res["cpu"] = ftt.adaptive_smc(4, n, staged=ftt.stage(mixed_discrete_model("cpu", torch.float64),
                                                         device="cpu"), config=cfg)
    _cpu_draws(monkeypatch)
    before = dict(K.LAUNCHES)
    res["cuda"] = ftt.adaptive_smc(4, n, staged=ftt.stage(mixed_discrete_model("cuda", torch.float64),
                                                          device="cuda"), config=cfg)
    c, g = res["cpu"], res["cuda"]
    s = g.n_stages
    assert s == c.n_stages and s >= 2 and g.particles["heads"].is_cuda
    assert K.LAUNCHES["resample"] - before["resample"] == s - 1
    same = torch.isclose(g.particles["mu"].cpu(), c.particles["mu"], rtol=1e-9, atol=1e-12)
    same &= torch.eq(g.particles["heads"].cpu(), c.particles["heads"])
    assert same.double().mean().item() > 0.99
    assert abs(g.posterior_mean("heads").item() - c.posterior_mean("heads").item()) < 2e-3
    assert abs(g.log_evidence - c.log_evidence) < 1e-3


def test_chees_chain_on_cuda_equals_cpu(monkeypatch):
    """chees_chain on eight-schools, the same draws on both devices: the
    same leapfrog counts, step size, T and positions (float64, where the
    devices differ in summation order only; 1e-9)."""
    kw = dict(n_samples=20, n_warmup=20, n_chains=64, config=ftt.ChEESConfig(target_accept=0.8))
    cpu = ftt.chees_chain(3, staged=_eight_schools("cpu"), **kw)
    _cpu_draws(monkeypatch)
    gpu = ftt.chees_chain(3, staged=_eight_schools("cuda"), **kw)
    assert gpu.positions.is_cuda and gpu.final_positions.is_cuda
    assert gpu.n_leapfrogs == cpu.n_leapfrogs and gpu.host_syncs == cpu.host_syncs == 40
    assert gpu.step_size == pytest.approx(cpu.step_size, rel=1e-9)
    assert gpu.trajectory_length == pytest.approx(cpu.trajectory_length, rel=1e-9)
    np.testing.assert_allclose(gpu.positions.cpu().numpy(), cpu.positions.numpy(),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(gpu.inv_mass.cpu().numpy(), cpu.inv_mass.numpy(), rtol=1e-9)


def test_adaptive_mcmc_chain_on_cuda_equals_cpu(monkeypatch):
    """adaptive_mcmc_chain on the 20-site model, the same draws on both
    devices: the same samples, log joints and scales (float64, 1e-10), and
    1 + n_warmup + n_samples batched model runs on the card."""
    runs = [0]
    base = hierarchical_model("cuda", torch.float64)

    def counted():
        runs[0] += 1
        return base()

    kw = dict(n_samples=15, n_warmup=15, n_chains=512)
    cpu = ftt.adaptive_mcmc_chain(4, staged=ftt.stage(hierarchical_model("cpu", torch.float64),
                                                      device="cpu"), **kw)
    _cpu_draws(monkeypatch)
    staged = ftt.stage(counted, device="cuda")
    runs[0] = 0
    gpu = ftt.adaptive_mcmc_chain(4, staged=staged, **kw)
    assert runs[0] == 1 + 15 + 15
    for a in cpu.samples:
        np.testing.assert_allclose(gpu.samples[a].cpu().numpy(), cpu.samples[a].numpy(), **TOL)
    np.testing.assert_allclose(gpu.log_joint.cpu().numpy(), cpu.log_joint.numpy(), **TOL)
    np.testing.assert_allclose(gpu.final_state.adapt.log_scale.cpu().numpy(),
                               cpu.final_state.adapt.log_scale.numpy(), **TOL)
    assert torch.equal(gpu.accept_rate.cpu(), cpu.accept_rate)


def test_one_chees_transition_makes_one_host_sync():
    """chees_transition reads tau back once; the rest (L + 1 batched
    value-and-grads on the plate kernel, the accept test) stays on the card."""
    staged = _plate("cuda")
    q = torch.as_tensor(_inputs(staged.dim)[0], device="cuda")
    z = torch.randn(q.shape, dtype=torch.float64, device="cuda")
    log_u = torch.full((32,), -0.5, dtype=torch.float64, device="cuda")
    eps, T = (torch.tensor(x, dtype=torch.float64, device="cuda") for x in (0.002, 0.007))
    im = torch.ones(staged.dim, dtype=torch.float64, device="cuda")
    before = dict(K.LAUNCHES)
    out = chees.chees_transition(staged.potential, q, z, log_u, eps, T, 0.75, im, 1024)
    assert out[6] == 3 and K.LAUNCHES["nll"] - before["nll"] == 4
    assert _host_syncs(lambda: chees.chees_transition(staged.potential, q, z, log_u, eps, T,
                                                      0.75, im, 1024)) == 1


class _CpuDraws(vi.GeneratorDraws):
    """VI draws from a CPU generator, moved to the card: the same numbers
    for a CUDA run and a CPU run."""

    def __init__(self, seed, device):
        super().__init__(torch.Generator().manual_seed(seed))
        self.device = device

    def _randn(self, shape, dtype):
        return super()._randn(shape, dtype).to(self.device)

    def gammas(self, a, b):
        g1, g2 = super().gammas(a.cpu(), b.cpu())
        return g1.to(self.device), g2.to(self.device)


def test_vi_on_the_plate_on_cuda_equals_cpu():
    """Mean-field VI on the plate, the same draws on both devices: the same
    parameters and ELBO history (float64, 1e-10); on the card one kernel call
    per iteration and one host sync (the history) per run."""
    cfg = vi.VIConfig(n_iterations=40, n_samples=16, check_every=20, plateau_window=10**9)
    cpu = vi.optimize_meanfield_vi(0, staged=_plate("cpu"), config=cfg, draws=_CpuDraws(3, "cpu"))
    staged = _plate("cuda")
    before = K.LAUNCHES["nll"]
    gpu = vi.optimize_meanfield_vi(0, staged=staged, config=cfg, draws=_CpuDraws(3, "cuda"))
    assert K.LAUNCHES["nll"] - before == 40
    np.testing.assert_allclose(gpu.elbo_history, cpu.elbo_history, **TOL)
    for a in ("mu", "sigma"):
        for k in ("loc", "raw_scale"):
            np.testing.assert_allclose(gpu.params[a][k].cpu().numpy(), cpu.params[a][k].numpy(),
                                       **TOL)
    assert _host_syncs(lambda: vi.optimize_meanfield_vi(0, staged=staged, config=cfg)) == 1


def test_predictive_on_cuda_is_one_model_run():
    runs = [0]
    base = hierarchical_model("cuda", torch.float64)

    def counted():
        runs[0] += 1
        return base()

    staged = ftt.stage(counted, device="cuda")
    res = vi.optimize_meanfield_vi(1, staged=staged, config=vi.VIConfig(n_iterations=50,
                                                                         n_samples=16))
    draws = res.posterior_sample(2, 512)
    assert all(v.is_cuda and v.shape == (512,) for v in draws.values())
    runs[0] = 0
    pred = ftt.predictive(3, counted, draws, batch_ndim=1)
    assert runs[0] == 1 and pred["y#0"].shape == (512, 5) and pred["y#0"].is_cuda


def test_abc_smc_on_cuda_launches_the_smc_kernels():
    def sim():
        mu = ftt.sample("mu_p", ftt.Normal(0.0, 2.0))
        return ftt.sample("xs", ftt.Normal(mu, 1.0), sample_shape=(16,))

    obs_np = 1.0 + np.random.default_rng(77).standard_normal(16)
    obs = torch.as_tensor(obs_np, device="cuda")
    post_m, post_sd = 16 * obs_np.mean() / 16.25, 1.0 / math.sqrt(16.25)
    staged = ftt.stage(sim, device="cuda")
    cfg = ftt.ABCSMCConfig(n_particles=512, epsilons=(0.5, 0.2, 0.1), batch_size=8192,
                           max_attempts_per_stage=1 << 20)

    def dist(a, b):
        return torch.abs(torch.mean(a) - torch.mean(b))

    before = dict(K.LAUNCHES)
    res = ftt.abc_smc(5, staged=staged, observed=obs, distance=dist, config=cfg,
                      param_addresses=("mu_p",))
    assert K.LAUNCHES["lse"] - before["lse"] == 3
    assert K.LAUNCHES["resample"] - before["resample"] == 1
    x = res.particles["mu_p"].cpu().numpy()
    assert x.shape == (512,) and abs(x.mean() - post_m) < 5 * post_sd * math.sqrt(2 / 512)
    rej = dict(staged=staged, observed=obs, distance=dist, epsilon=0.05, n_samples=256,
               batch_size=1 << 14, inner_batches=4)
    r = ftt.abc_rejection(6, **rej)
    dispatches = r.n_attempts // (4 << 14)
    # one read (the accept counts) per dispatch; the rows stay on the card
    assert _host_syncs(lambda: ftt.abc_rejection(6, **rej)) == dispatches


@pytest.mark.parametrize("c", [1, 8, 256])
def test_split_products_on_the_card(c):
    from fugue_tpu_torch.ops import linalg

    rng = np.random.default_rng(c)
    n, d = 4096, 128
    x = torch.as_tensor(rng.normal(size=(n, d)) / math.sqrt(d)).to(torch.bfloat16)
    y = torch.as_tensor(rng.integers(0, 2, n), dtype=torch.float32)
    ws = torch.as_tensor(rng.normal(size=(c, d)), dtype=torch.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        xd, yd, wd = x.to(dev), y.to(dev), ws.to(dev)

        def potential(w):
            logits = linalg.matmul_bf16x2_fastgrad(xd, w)
            assert logits.dtype == torch.float32
            return -torch.sum(yd * logits - torch.nn.functional.softplus(logits))

        before = dict(linalg.GEMMS)
        g, v = vmap(grad_and_value(potential))(wd)
        made = {k: linalg.GEMMS[k] - before[k] for k in before}
        assert made == ({"cuda": 0, "cpu": 3} if dev == "cpu" else {"cuda": 3, "cpu": 0})
        out[dev] = (g.cpu().double(), v.cpu().double())
    exact = x.double() @ ws.double().T  # (n, c)
    card = linalg.matmul_bf16x2(x.cuda(), ws[0].cuda())
    assert card.dtype == torch.float32
    rel = (card.cpu().double() - exact[:, 0]).abs().max() / exact[:, 0].abs().max()
    assert rel < 1e-3
    for a, b in zip(out["cpu"], out["cuda"]):
        torch.testing.assert_close(b, a, rtol=1e-3, atol=1e-3)


def test_categorical_uniform_and_numpy_parameters_in_a_model_on_the_card():
    def model():
        k = ftt.sample("k", ftt.Categorical.uniform(3))
        w = ftt.sample("w", ftt.Normal(np.array([0.0, 1.0, -1.0]), np.array([1.0, 2.0, 0.5])))
        ftt.observe("y", ftt.Normal(w[k], 1.0), 0.5)

    staged = ftt.stage(model, device="cuda")
    lat = staged.sample_prior_batch(4, 4096)
    assert lat["k"].device.type == "cuda" and lat["w"].device.type == "cuda"
    freq = torch.bincount(lat["k"].long(), minlength=3).double() / 4096
    assert bool((freq - 1 / 3).abs().max() < 6 * math.sqrt(2 / 9 / 4096))
    lj = vmap(staged.log_joint)(lat)
    assert lj.device.type == "cuda" and bool(torch.isfinite(lj).all())
    cpu = ftt.stage(model, device="cpu")
    want = vmap(cpu.log_joint)({a: v.cpu() for a, v in lat.items()})
    torch.testing.assert_close(lj.cpu(), want, rtol=1e-12, atol=1e-12)
    res = ftt.adaptive_mcmc_chain(0, staged=staged, n_samples=10, n_warmup=10, n_chains=64)
    assert res.samples["k"].device.type == "cuda"


def test_service_runs_on_the_card():
    """FugueService() defaults to the card: the compiled model's data, the
    MH session, the particle filter and SMC live there, the SMC kernels
    launch, and mh.step reads back once whatever n is."""
    from fugue_tpu_torch.serve import FugueService

    svc = FugueService()

    def call(method, **params):
        out = svc.handle({"method": method, "params": params})
        assert "error" not in out, out
        return out["result"]

    mid = call("compile", source='let p <- sample("p", beta(2.0, 2.0));'
               'for i in 0..6 { observe(("y", i), bernoulli(p), flips[i]); } return p;',
               data={"flips": [1, 1, 0, 1, 1, 0]})["model_id"]
    assert svc._models[mid][2].device.type == "cuda"
    sid = call("mh.new", model_id=mid, n_chains=256)["session_id"]
    assert svc._sessions[sid].carry["state"].log_joint.is_cuda
    reads = [_host_syncs(lambda n=n: call("mh.step", session_id=sid, n=n)) for n in (1, 20)]
    assert reads == [1, 1]  # the first request included
    before = dict(K.LAUNCHES)
    call("smc.run", model_id=mid, n_particles=4096)
    pf = call("pf.new", n_particles=4096)["session_id"]
    est = call("pf.observe", session_id=pf, y=0.3)
    assert K.LAUNCHES["lse"] > before["lse"] + 3 and K.LAUNCHES["resample"] > before["resample"]
    assert math.isfinite(est["mean"]) and est["ess"] > 0
    assert svc.handle({"method": "vi.run", "params": {
        "model_id": mid, "posterior_draws": 0}})["error"]["code"] == -32602


def test_dsl_index_is_clamped_on_the_card():
    """A sampled category past the end of the indexed array clamps on the
    card (no device-side assert) and equals the CPU in float64."""
    from fugue_tpu_torch.dsl.compiler import compile_model

    src = ('let z <- sample("z", categorical(probs)); let mu <- sample("mu", normal(0.0, 1.0));'
           'observe("y", normal(mu + centers[z] - centers[-1.0], 1.0), 0.5); return z')
    data = {"probs": [0.25, 0.25, 0.25, 0.25], "centers": [-2.0, 0.5, 3.0]}
    z = torch.tensor([0, 1, 2, 3, 3, 0])
    mu = torch.linspace(-1.0, 1.0, 6, dtype=torch.float64)
    out = {}
    for dev in ("cpu", "cuda"):
        cm = compile_model(src)
        staged = ftt.stage(cm.build(data, device=dev), device=dev)
        out[dev] = vmap(staged.log_joint)({"z": z.to(dev), "mu": mu.to(dev)}).cpu()
        assert cm.take_warnings() == []
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out["cuda"]).all())
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-12, atol=1e-12)


def test_device_trace_is_primed_and_holds_the_block(tmp_path):
    """utils.profiling.device_trace on the card: the trace keeps at least
    one priming kernel (no warning) and every kernel of the block, here the
    two of one logsumexp launch."""
    import json
    import warnings

    from fugue_tpu_torch.utils.profiling import PRIMING_KERNELS, device_trace, is_priming_kernel

    x = torch.randn(1 << 20, device="cuda")
    K.plogsumexp(x)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        with device_trace(str(tmp_path)):
            K.plogsumexp(x)
    (path,) = tmp_path.glob("trace_*.json")
    kernels = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
               if e.get("cat") == "kernel"]
    primed = sum(is_priming_kernel(n) for n in kernels)
    assert 1 <= primed <= PRIMING_KERNELS
    assert sorted(n.split("<")[0].split("::")[-1] for n in kernels
                  if not is_priming_kernel(n)) == ["lse_finish", "lse_partial"]


def test_device_trace_places_program_spans_on_its_time_base(tmp_path):
    """A program span around an exp and a sum in a ``device_trace`` on the
    card: in the written trace their kernels' launches lie inside the span,
    on the launching thread."""
    import json

    from fugue_tpu_torch.utils import profiling

    x = torch.randn(1 << 20, device="cuda")
    torch.exp(x).sum()
    with profiling.device_trace(str(tmp_path)):
        with profiling.span("potential"):
            torch.exp(x).sum()
    (path,) = tmp_path.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    (span,) = [e for e in events if e.get("cat") == "program"]
    inside = [e for e in events if e.get("cat") == "cuda_runtime"
              and "LaunchKernel" in e.get("name", "")
              and span["ts"] <= e["ts"] <= span["ts"] + span["dur"]]
    assert len(inside) >= 2 and all(e["tid"] == span["tid"] for e in inside)


def test_traced_hmc_call_records_one_potential_span_per_gradient(monkeypatch):
    """A resumed hmc_chain call on the eager path under torch.profiler on the
    card: one program ``potential`` span per ``record_function`` range
    around the same batched gradient, each span inside its range on the
    profiler's clock, and every kernel of the call that launched inside a
    range launched inside a span; its one named host read. (A transition
    replayed from the drive's CUDA graph opens no span: the graph is
    switched off here.)"""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from fugue_tpu_torch.utils import profiling
    from fugue_tpu_torch.utils.profiling import prime_session

    monkeypatch.setattr(hmc, "graph_engages", lambda q, force_fn, discrete: False)
    staged = ftt.stage(eight_schools_model("cuda"), device="cuda")
    cfg = ftt.HMCConfig(n_leapfrog=8)
    first = ftt.hmc_chain(1, staged=staged, n_chains=64, n_samples=1, n_warmup=10, config=cfg)
    real = hmc.batched_force

    def ranged(potential_fn):
        force = real(potential_fn)

        def call(q):
            with record_function("pb.potential"):
                return force(q)

        return call

    monkeypatch.setattr(hmc, "batched_force", ranged)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prime_session()
        t0 = time.time_ns()
        ftt.hmc_chain(2, staged=staged, n_chains=64, n_samples=2, n_warmup=0, config=cfg,
                      resume=first)
        torch.cuda.synchronize()
        t1 = time.time_ns()
    events = list(prof.profiler.kineto_results.events())
    ranges = sorted((e.start_ns(), e.end_ns()) for e in events
                    if e.name() == "pb.potential" and e.device_type() == DeviceType.CPU)
    recs = profiling.records(t0, t1)
    spans = sorted((r.start, r.end) for r in recs
                   if isinstance(r, profiling.Span) and r.name == "potential")
    assert len(spans) == len(ranges) == 2 * (8 + 1)
    for (s0, s1), (r0, r1) in zip(spans, ranges):
        assert r0 <= s0 <= s1 <= r1
    launches = [e.start_ns() for e in events if e.device_type() == DeviceType.CPU
                and "cudaLaunchKernel" in e.name()]
    inside = [t for t in launches if any(r0 <= t <= r1 for r0, r1 in ranges)]
    assert len(inside) >= len(ranges)
    assert all(any(s0 <= t <= s1 for s0, s1 in spans) for t in inside)
    reads = [r for r in recs if isinstance(r, profiling.Count) and r.name == "host_read"]
    assert [r.attrs["site"] for r in reads] == ["hmc_chain.step_size"]


def test_dense_mass_hmc_on_cuda_equals_cpu(monkeypatch):
    """scale_densemass's model at d = 8, its data made on the CPU and moved:
    one dense-mass transition from the same standard-normal draws equals the
    CPU's (1e-10), and a short dense-mass hmc_chain with the same draws
    gives the same positions, step size and adapted Sigma (1e-9)."""
    x, y, _, tril = densemass_data(8, 64, device="cpu", dtype=torch.float64)
    staged = {dev: ftt.stage(densemass_model(x.to(dev), y.to(dev), tril.to(dev)), device=dev)
              for dev in ("cpu", "cuda")}
    rng = np.random.default_rng(3)
    a = rng.normal(size=(8, 8))
    sigma = a @ a.T / 8 + 0.5 * np.eye(8)
    q, z, log_u = rng.normal(0.0, 0.1, (16, 8)), rng.normal(size=(16, 8)), np.log(rng.uniform(size=16))
    out = {}
    for dev in ("cpu", "cuda"):
        im = torch.as_tensor(sigma, device=dev)
        p = hmc.momentum_from_normal(im, torch.as_tensor(z, device=dev))
        out[dev] = hmc.hmc_transition(staged[dev].potential, torch.as_tensor(q, device=dev), p,
                                      torch.as_tensor(log_u, device=dev), 0.1, 8, im)
    (qc, ic), (qg, ig) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(qg.cpu().numpy(), qc.numpy(), **TOL)
    np.testing.assert_allclose(ig.accept_prob.cpu().numpy(), ic.accept_prob.numpy(), **TOL)
    assert torch.equal(ig.accepted.cpu(), ic.accepted)

    kw = dict(n_samples=10, n_warmup=20, n_chains=16,
              config=ftt.HMCConfig(n_leapfrog=8, mass="dense", target_accept=0.85))
    cpu = ftt.hmc_chain(5, staged=staged["cpu"], **kw)
    _cpu_draws(monkeypatch)
    gpu = ftt.hmc_chain(5, staged=staged["cuda"], **kw)
    assert gpu.positions.is_cuda and gpu.inv_mass.shape == (8, 8)
    assert gpu.step_size == pytest.approx(cpu.step_size, rel=1e-9)
    np.testing.assert_allclose(gpu.positions.cpu().numpy(), cpu.positions.numpy(),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(gpu.inv_mass.cpu().numpy(), cpu.inv_mass.numpy(), rtol=1e-9)


def test_group_plate_gradient_on_cuda_equals_cpu():
    """scale_plate's model at 8 groups x 8,192 rows (2^16 per chain: the
    float64 compensated sum's path): the batched gradient and potential on
    the card equal the CPU's in float64 (1e-10), with no host sync."""
    y = group_plate_data(8, 8192, device="cpu", dtype=torch.float64)
    q = np.random.default_rng(4).normal(0.0, 0.5, (16, 9))
    out = {}
    for dev in ("cpu", "cuda"):
        staged = ftt.stage(group_plate_model(y.to(dev)), device=dev)
        force = vmap(grad_and_value(staged.potential))
        qd = torch.as_tensor(q, device=dev)
        out[dev] = force(qd)
    assert _host_syncs(lambda: force(qd)) == 0
    for got, want in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)


def _graph_counts(fn):
    """(fn(), the ``hmc.graph_*`` counts it made), recorded under a profiler
    session."""
    import collections
    import time

    from torch.profiler import ProfilerActivity, profile

    from fugue_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
        torch.cuda.synchronize()
    counts = collections.Counter()
    for r in profiling.records(t0, time.time_ns()):
        if isinstance(r, profiling.Count) and r.name.startswith("hmc.graph_"):
            counts[r.name] += r.n
    return out, dict(counts)


def _fresh_and_resumed(model, cfg, **kw):
    """A fresh hmc_chain call (64 chains, 10 warmup, 10 samples) and one
    resumed call (10 samples) on a newly staged model: ((results), (the
    calls' graph counts))."""
    staged = ftt.stage(model, device="cuda")
    first, c1 = _graph_counts(lambda: ftt.hmc_chain(1, staged=staged, n_chains=64, n_samples=10,
                                                    n_warmup=10, config=cfg, **kw))
    second, c2 = _graph_counts(lambda: ftt.hmc_chain(2, staged=staged, n_chains=64,
                                                     n_samples=10, n_warmup=0, config=cfg,
                                                     resume=first, **kw))
    return (first, second), (c1, c2)


def _assert_same_chains(got, want):
    for g, w in zip(got, want):
        for field in ("positions", "final_positions", "log_joint", "accept_prob",
                      "divergences", "inv_mass"):
            assert torch.equal(getattr(g, field), getattr(w, field)), field
        assert g.step_size == w.step_size


def test_hmc_chain_replays_its_captured_transition_as_the_eager_drive_runs(monkeypatch):
    """Eight-schools in float32 (the benchmark's precision), L = 8, diagonal
    mass: with the graph, the fresh call captures once (its first transition
    runs eagerly) and replays the other 19 transitions, the resumed call
    replays all 10 and captures nothing; positions, accept probabilities,
    divergences, step size and mass equal the eager drive's bitwise."""
    settings.enable_x64(False)
    cfg = ftt.HMCConfig(n_leapfrog=8)
    graph, counts = _fresh_and_resumed(eight_schools_model("cuda"), cfg)
    assert counts == ({"hmc.graph_capture": 1, "hmc.graph_replay": 19},
                      {"hmc.graph_replay": 10})
    monkeypatch.setattr(hmc, "graph_engages", lambda q, force_fn, discrete: False)
    eager, eager_counts = _fresh_and_resumed(eight_schools_model("cuda"), cfg)
    assert eager_counts == ({}, {})
    _assert_same_chains(graph, eager)


def test_dense_mass_hmc_chain_replays_its_captured_transition():
    """Dense mass, float32: the calls capture and replay as with a diagonal
    mass. Under capture cuBLAS takes another float32 GEMM for the dense
    velocity p @ Sigma (a split-K SIMT kernel for the eager path's xmma
    one), so one replayed transition is held to the eager transition from
    the same inputs: the same accept decisions, positions to 1e-6, energies
    to 1e-6 relative, accept probabilities to twice that error of the
    largest energy."""
    settings.enable_x64(False)
    cfg = ftt.HMCConfig(n_leapfrog=8, mass="dense")
    (first, second), counts = _fresh_and_resumed(eight_schools_model("cuda"), cfg)
    assert counts == ({"hmc.graph_capture": 1, "hmc.graph_replay": 19},
                      {"hmc.graph_replay": 10})
    assert second.inv_mass.shape == (10, 10) and bool(torch.isfinite(second.positions).all())

    staged = ftt.stage(eight_schools_model("cuda"), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(10, 10, generator=g, device="cuda")
    sigma = a @ a.T / 10 + 0.5 * torch.eye(10, device="cuda")
    q = 0.5 * torch.randn(64, 10, generator=g, device="cuda")
    p = hmc.momentum_from_normal(sigma, torch.randn(64, 10, generator=g, device="cuda"))
    log_u = torch.log(torch.rand(64, generator=g, device="cuda"))
    eps = torch.full((64,), 0.1, device="cuda")
    args = (staged.potential, q, p, log_u, eps, 8, sigma, 1000.0)
    graphs = hmc.TransitionGraphs()
    graphs.transition(*args)  # eager, then the capture
    qg, ig, _, _ = graphs.transition(*args)
    qe, ie = hmc.hmc_transition(*args)
    assert torch.equal(ig.accepted, ie.accepted) and torch.equal(ig.divergent, ie.divergent)
    torch.testing.assert_close(qg, qe, rtol=0.0, atol=1e-6)
    for field in ("energy", "potential"):
        torch.testing.assert_close(getattr(ig, field), getattr(ie, field), rtol=1e-6, atol=0.0)
    h_max = float(ie.energy.abs().max())
    torch.testing.assert_close(ig.accept_prob, ie.accept_prob, rtol=0.0, atol=2e-6 * h_max)


def test_hmc_chain_with_explicit_discrete_values_stays_eager():
    """An explicit ``discrete`` may close over a call's own tensors, so the
    drive does not capture it."""
    settings.enable_x64(False)
    model = mixed_discrete_model("cuda")
    heads = {"heads": torch.tensor(True, device="cuda")}
    (res, _), counts = _fresh_and_resumed(model, ftt.HMCConfig(n_leapfrog=8), discrete=heads)
    assert counts == ({}, {}) and res.positions.is_cuda


def test_a_potential_that_reads_the_host_falls_back_to_the_eager_drive(monkeypatch):
    """A model whose potential reads a device value back to the host cannot
    be captured: the first call counts one fallback and runs eagerly, later
    calls on the model do not try again, and the chains equal the eager
    drive's."""
    settings.enable_x64(False)
    y = torch.tensor([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0], device="cuda")
    sigma = torch.tensor([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0], device="cuda")

    def reads_the_host():
        mu = ftt.sample("mu", ftt.Normal(0.0, float(sigma.max()) / 3.6))
        tau = ftt.sample("tau", ftt.LogNormal(0.5, 1.0))
        theta_raw = ftt.sample("theta_raw", ftt.Normal(0.0, 1.0), sample_shape=(8,))
        ftt.observe("y", ftt.Normal(mu + tau * theta_raw, sigma), y)

    cfg = ftt.HMCConfig(n_leapfrog=8)
    fell_back, counts = _fresh_and_resumed(reads_the_host, cfg)
    assert counts == ({"hmc.graph_fallback": 1}, {})
    monkeypatch.setattr(hmc, "graph_engages", lambda q, force_fn, discrete: False)
    eager, _ = _fresh_and_resumed(reads_the_host, cfg)
    _assert_same_chains(fell_back, eager)


def test_gmm_mixture_cell_at_its_size_is_correct_and_traced():
    """The benchmark's ``gmm_mixture.smc`` cell at its size (131,072
    particles, N = 1,000, float32, two whole runs in the window) through the
    harness, traced: ``correct``, and every per-layer metric of the cell
    read, the SMC kernels' roofline shares below 100%."""
    from perfbench import harness

    settings.enable_x64(False)
    run = harness.new_run("gmm_mixture.smc", 2**33 + 11, 1.0, True,
                          overrides={"reference_draws": 1 << 20})
    out = harness.run_cell(run)
    assert out["correct"], out["checks"]
    names = [m["name"] for m in harness.benchmark()["per_layer"]
             if harness.applies(m, "gmm_mixture.smc")]
    assert len(names) == 8 and set(names) <= set(out["metrics"])
    for name in ("smc.logsumexp_roofline", "smc.resample_roofline"):
        assert 0.0 < out["metrics"][name]["value"] < 100.0
    assert out["metrics"]["smc.host_reads_per_stage"]["value"] == 1.0
