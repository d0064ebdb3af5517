"""The PyTorch port's MAP and Laplace engines against fugue_tpu, on the CPU.

JAX in x64 and torch in float64, the same numpy data in both. Adam's
iterates from the JAX run's own start equal the JAX history (1e-10). The
two L-BFGS runs (optax's zoom line search; the port's backtracking one)
end at the same point (1e-6 on z) with the same log joint. At the same z
the Laplace covariance and log evidence agree to 1e-8, and on the ridge
regression of ``examples/map_laplace.py`` they equal the closed form. The
error paths raise the same codes: a non-PD Hessian, discrete sites, an
unknown optimizer; and the curvature cannot run through the split-bf16
products in either package.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from fugue_tpu.errors import FugueError as JaxFugueError
from fugue_tpu_torch import settings
from fugue_tpu_torch.errors import FugueError
from fugue_tpu_torch.inference import map_laplace as tml
from fugue_tpu_torch.ops import linalg as tla


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


RNG = np.random.default_rng(42)
X = RNG.normal(size=50)
Y = 1.5 * X + 0.5 + RNG.normal(size=50) * 0.4
TAU, SIGMA = 10.0, 0.4


def jax_ridge():
    a = ft.sample("a", ft.Normal(0.0, TAU))
    b = ft.sample("b", ft.Normal(0.0, TAU))
    ft.observe("y", ft.Normal(a * jnp.asarray(X) + b, SIGMA), jnp.asarray(Y))


def torch_ridge():
    a = ftt.sample("a", ftt.Normal(0.0, TAU))
    b = ftt.sample("b", ftt.Normal(0.0, TAU))
    ftt.observe("y", ftt.Normal(a * torch.tensor(X) + b, SIGMA), torch.tensor(Y))


def jax_scaled():
    a = ft.sample("a", ft.Normal(0.0, TAU))
    b = ft.sample("b", ft.Normal(0.0, TAU))
    s = ft.sample("s", ft.LogNormal(0.0, 1.0))
    ft.observe("y", ft.Normal(a * jnp.asarray(X) + b, s), jnp.asarray(Y))


def torch_scaled():
    a = ftt.sample("a", ftt.Normal(0.0, TAU))
    b = ftt.sample("b", ftt.Normal(0.0, TAU))
    s = ftt.sample("s", ftt.LogNormal(0.0, 1.0))
    ftt.observe("y", ftt.Normal(a * torch.tensor(X) + b, s), torch.tensor(Y))


def _ridge_exact():
    A = np.stack([X, np.ones_like(X)], axis=1)
    prec = A.T @ A / SIGMA**2 + np.eye(2) / TAU**2
    return np.linalg.solve(prec, A.T @ Y / SIGMA**2), np.linalg.inv(prec)


def test_adam_iterates_match_jax():
    cfg = ft.MAPConfig(optimizer="adam", n_iterations=80, n_restarts=1, learning_rate=0.05)
    jr = ft.map_estimate(jax.random.PRNGKey(0), jax_scaled, cfg)
    js = jr.staged
    z0 = np.asarray(js.unconstrain(js._discovery_trace.latents()))
    ts = ftt.stage(torch_scaled, device="cpu")
    fn = vmap(grad_and_value(lambda z: -ts.log_joint_unconstrained(z)))
    z, hist, _ = tml._adam(fn, torch.tensor(z0)[None], tml.MAPConfig(
        optimizer="adam", n_iterations=80, n_restarts=1, learning_rate=0.05))
    np.testing.assert_allclose(torch.stack(hist, 1).numpy(), np.asarray(jr.history),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(z[0].numpy(), np.asarray(jr.z), rtol=1e-10, atol=1e-10)


def test_lbfgs_endpoint_matches_jax():
    cfg = dict(optimizer="lbfgs", n_iterations=200, n_restarts=3)
    jr = ft.map_estimate(jax.random.PRNGKey(1), jax_scaled, ft.MAPConfig(**cfg))
    tr = ftt.map_estimate(1, torch_scaled, ftt.MAPConfig(**cfg), device="cpu")
    np.testing.assert_allclose(tr.z.numpy(), np.asarray(jr.z), rtol=1e-6, atol=1e-6)
    assert tr.log_joint == pytest.approx(jr.log_joint, rel=1e-10)
    assert tr.converged and jr.converged
    assert tr.history.shape == (3, 200)
    # about one objective evaluation (one host read) per iteration once it
    # has converged
    assert tr.host_syncs < 3 * 200
    assert set(tr.latents) == {"a", "b", "s"}
    trace = tr.trace()
    assert float(trace.log_likelihood) == pytest.approx(float(jr.trace().log_likelihood),
                                                        rel=1e-8)


def test_laplace_at_the_same_point_matches_jax():
    jr = ft.map_estimate(jax.random.PRNGKey(1), jax_scaled,
                         ft.MAPConfig(optimizer="lbfgs", n_iterations=200))
    jl = ft.laplace_approximation(jr, jitter=1e-3)
    ts = ftt.stage(torch_scaled, device="cpu")
    z = torch.tensor(np.asarray(jr.z))
    tr = tml.MAPResult(latents=ts.constrain(z)[0], z=z, log_joint=0.0, converged=True,
                       grad_norm=0.0, history=np.zeros((1, 0)), staged=ts, discrete=None)
    tl = ftt.laplace_approximation(tr, jitter=1e-3)
    np.testing.assert_allclose(tl.cov.numpy(), np.asarray(jl.cov), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(tl.chol.numpy(), np.asarray(jl.chol), rtol=1e-8, atol=1e-12)
    assert tl.log_evidence == pytest.approx(jl.log_evidence, rel=1e-8)
    for site in ("a", "s"):
        np.testing.assert_allclose(tl.sd(site).numpy(), np.asarray(jl.sd(site)), rtol=1e-8)


def test_ridge_regression_against_the_closed_form():
    mean, cov = _ridge_exact()
    for opt, n in (("lbfgs", 200), ("adam", 3000)):
        r = ftt.map_estimate(0, torch_ridge, ftt.MAPConfig(optimizer=opt, n_iterations=n),
                             device="cpu")
        np.testing.assert_allclose([r.latents["a"].item(), r.latents["b"].item()], mean,
                                   atol=1e-6)
    la = ftt.laplace_approximation(r)
    assert la.sd("a").item() == pytest.approx(math.sqrt(cov[0, 0]), abs=1e-8)
    draws = la.sample(3, 4000)
    assert draws["a"].shape == (4000,)
    assert abs(draws["a"].mean().item() - mean[0]) < 5 * math.sqrt(cov[0, 0] / 4000)


def test_laplace_evidence_prefers_the_true_model():
    y2 = 0.8 * X**2 - 0.2 * X + np.random.default_rng(7).normal(size=50) * 0.4
    xt, yt = torch.tensor(X), torch.tensor(y2)

    def linear():
        a = ftt.sample("a", ftt.Normal(0.0, 2.0))
        b = ftt.sample("b", ftt.Normal(0.0, 2.0))
        ftt.observe("y", ftt.Normal(a * xt + b, SIGMA), yt)

    def quadratic():
        a = ftt.sample("a", ftt.Normal(0.0, 2.0))
        b = ftt.sample("b", ftt.Normal(0.0, 2.0))
        c = ftt.sample("c", ftt.Normal(0.0, 2.0))
        ftt.observe("y", ftt.Normal(c * xt**2 + a * xt + b, SIGMA), yt)

    cfg = ftt.MAPConfig(optimizer="lbfgs")
    lin = ftt.laplace_approximation(ftt.map_estimate(1, linear, cfg, device="cpu"))
    quad = ftt.laplace_approximation(ftt.map_estimate(1, quadratic, cfg, device="cpu"))
    assert quad.log_evidence > lin.log_evidence + 10
    # a Gaussian linear model's evidence is exact under Laplace
    A = np.stack([X, np.ones_like(X)], axis=1)
    cov_y = SIGMA**2 * np.eye(50) + 4.0 * A @ A.T
    _, logdet = np.linalg.slogdet(cov_y)
    exact = -0.5 * (y2 @ np.linalg.solve(cov_y, y2) + logdet + 50 * math.log(2 * math.pi))
    assert lin.log_evidence == pytest.approx(exact, abs=1e-8)


def _error(fn):
    try:
        fn()
    except (FugueError, JaxFugueError) as e:
        return type(e).__name__, e.code.name
    raise AssertionError("no error")


def test_error_paths_raise_the_same_codes():
    def jbowl():
        x = ft.sample("x", ft.Normal(0.0, 1.0))
        ft.factor(x * x)

    def tbowl():
        x = ftt.sample("x", ftt.Normal(0.0, 1.0))
        ftt.factor(x * x)

    ts = ftt.stage(tbowl, device="cpu")
    jr = ft.map_estimate(jax.random.PRNGKey(0), jbowl, ft.MAPConfig(n_iterations=2))
    jr.z = jnp.zeros(1)
    tr = tml.MAPResult(latents={}, z=torch.zeros(1, dtype=torch.float64), log_joint=0.0,
                       converged=False, grad_norm=0.0, history=np.zeros((1, 0)), staged=ts,
                       discrete=None)
    assert _error(lambda: ftt.laplace_approximation(tr)) == _error(
        lambda: ft.laplace_approximation(jr))

    def jdisc():
        ft.sample("k", ft.Bernoulli(0.5))
        ft.sample("x", ft.Normal(0.0, 1.0))

    def tdisc():
        ftt.sample("k", ftt.Bernoulli(0.5))
        ftt.sample("x", ftt.Normal(0.0, 1.0))

    assert _error(lambda: ftt.map_estimate(0, tdisc, device="cpu")) == _error(
        lambda: ft.map_estimate(jax.random.PRNGKey(0), jdisc))
    bad = dict(optimizer="sgd")
    assert _error(lambda: ftt.map_estimate(0, torch_ridge, ftt.MAPConfig(**bad), device="cpu")) \
        == _error(lambda: ft.map_estimate(jax.random.PRNGKey(0), jax_ridge, ft.MAPConfig(**bad)))


def test_curvature_cannot_run_through_the_split_products():
    """Neither package's Hessian runs through a custom backward: the
    Laplace approximation of a model written with matmul_bf16x2_fastgrad
    raises in both (the docstring's contract)."""
    from fugue_tpu.ops import matmul_bf16x2_fastgrad as jmm

    xb = np.asarray(jnp.asarray(RNG.normal(size=(20, 3)), jnp.bfloat16), np.float64)
    yb = RNG.integers(0, 2, 20)

    def jglm():
        w = ft.sample("w", ft.Normal(jnp.zeros(3), 1.0))
        ft.observe("y", ft.BernoulliLogits(jmm(jnp.asarray(xb, jnp.bfloat16), w)),
                   jnp.asarray(yb, bool))

    def tglm():
        w = ftt.sample("w", ftt.Normal(torch.zeros(3, dtype=torch.float64), 1.0))
        ftt.observe("y", ftt.BernoulliLogits(
            tla.matmul_bf16x2_fastgrad(torch.tensor(xb).to(torch.bfloat16), w)),
            torch.tensor(yb, dtype=torch.bool))

    cfg = dict(optimizer="lbfgs", n_iterations=30, n_restarts=1)
    tr = ftt.map_estimate(0, tglm, ftt.MAPConfig(**cfg), device="cpu")
    assert np.isfinite(tr.log_joint)
    with pytest.raises(RuntimeError):
        ftt.laplace_approximation(tr)
    jr = ft.map_estimate(jax.random.PRNGKey(0), jglm, ft.MAPConfig(**cfg))
    with pytest.raises(TypeError):
        ft.laplace_approximation(jr)


def test_a_jax_map_point_warm_starts_the_port():
    """A JAX ``MAPResult.z`` goes to the port's ``init_position=`` through
    ``interop.tensor_from_numpy``: the chains start around it."""
    from fugue_tpu_torch import interop

    jr = ft.map_estimate(jax.random.PRNGKey(0), jax_ridge,
                         ft.MAPConfig(optimizer="lbfgs", n_iterations=100))
    z = interop.tensor_from_numpy(np.asarray(jr.z), device="cpu", dtype=torch.float64)
    res = ftt.hmc_chain(0, torch_ridge, n_samples=5, n_warmup=5, n_chains=4, init_position=z,
                        init_jitter=1e-3, device="cpu", config=ftt.HMCConfig(n_leapfrog=4))
    mean, cov = _ridge_exact()
    assert abs(res.samples["a"].mean().item() - mean[0]) < 10 * math.sqrt(cov[0, 0])
