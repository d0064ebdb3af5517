"""The yardstick: the ESS copy on chains of known autocorrelation, the
operation and byte counts from shapes, the covtype generator, and the
plain references against the served models on the CPU."""

import math

import numpy as np
import pytest
import torch

from perfbench import checks, ess
from perfbench.configs import covtype_logistic as ct
from perfbench.configs import eight_schools_nc as es
from perfbench.reference import covtype_logistic as rct
from perfbench.reference import eight_schools_nc as res


@pytest.mark.parametrize("rho", [0.0, 0.5, 0.9])
def test_ess_of_ar1_chains(rho):
    """AR(1) chains x_t = rho x_{t-1} + e_t have ESS m·n·(1 - rho)/(1 + rho)."""
    rng = np.random.default_rng(7)
    m, n = 64, 4000
    x = np.empty((m, n))
    x[:, 0] = rng.normal(size=m) / math.sqrt(1 - rho * rho)
    e = rng.normal(size=(m, n))
    for t in range(1, n):
        x[:, t] = rho * x[:, t - 1] + e[:, t]
    want = m * n * (1 - rho) / (1 + rho)
    assert abs(ess.ess_multichain(x) / want - 1.0) < 0.1


def test_ess_batches_and_caps():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 8, 100))
    out = ess.ess_multichain(x)
    assert out.shape == (3,) and np.all(out <= 800)
    assert ess.ess_multichain(np.ones((4, 50))) == 0.0


def test_flop_and_byte_counts_from_shapes():
    n, d, c = ct.ROWS, ct.FEATURES, 128
    f = ct.flops_per_grad(c)
    # the math's two products, 2·N·D·C each; the split-bf16 build is not counted
    assert f["bf16"] == 4.0 * n * d * c and f["fp32"] == 8.0 * n * c + 4.0 * d * c
    p = ct.product_cost(c)
    assert p["flops"] == f["bf16"]
    assert p["bytes"] == 2 * (2 * n * d) + 4 * n * c + 2 * n * c + 8 * d * c
    # the products are bound by bytes: 574 MB at 3.35 TB/s, 171 µs
    assert abs(p["bytes"] / 3.35e12 - 171.4e-6) < 0.5e-6
    assert p["flops"] / 989e12 < p["bytes"] / 3.35e12
    assert ct.product_cost(64, rows=1000)["bytes"] == 4000 * d + 6000 * 64 + 8 * d * 64
    assert es.flops_per_grad(1024) == {"bf16": 0.0, "fp32": 152.0 * 1024}


def test_covtype_generator_layout_and_determinism():
    rows = 20000
    x, y, w = ct.make_data(11, "cpu", rows)
    assert x.shape == (rows, 55) and x.dtype == torch.bfloat16 and y.shape == (rows,)
    assert y.dtype == torch.bool and w.shape == (55,) and float(w[-1]) == 0.0
    xf = x.float()
    assert torch.all(xf[:, -1] == 1.0)
    assert float(xf[:, :54].mean(0).abs().max()) < 0.01
    assert float((xf[:, :54].std(0) - 1).abs().max()) < 0.01
    # each one-hot block takes two values per column, one of them per row
    for lo, hi in ((10, 14), (14, 54)):
        assert all(len(torch.unique(xf[:, k])) == 2 for k in range(lo, hi))
        top = (xf[:, lo:hi] > 0).sum(1)
        assert torch.all(top == 1)
    # the wilderness shares and the soil types' skew
    wild = (xf[:, 10:14] > 0).float().mean(0)
    assert torch.allclose(wild, torch.tensor([0.449, 0.052, 0.436, 0.063]), atol=0.01)
    soil = (xf[:, 14:54] > 0).float().mean(0)
    assert float(soil[0]) > 5 * float(soil[-1])
    assert 0.3 < float(y.float().mean()) < 0.7
    x2, y2, _ = ct.make_data(11, "cpu", rows)
    x3, _, _ = ct.make_data(12, "cpu", rows)
    assert torch.equal(x, x2) and torch.equal(y, y2) and not torch.equal(x, x3)


def _program_force(problem, q):
    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.inference.hmc import batched_force

    staged = ftt.stage(problem.model_fn, device="cpu")
    g, u = batched_force(staged.potential)(q)
    return staged, u.double(), g.double()


def test_eight_schools_reference_matches_the_served_model():
    problem = es.build(0, "cpu")
    q = torch.randn(64, 10, generator=torch.Generator().manual_seed(1))
    staged, u, g = _program_force(problem, q)
    assert [s.address for s in staged.sites] == ["mu", "tau", "theta_raw"]
    nums = checks.density_numbers(res, problem.data, q.double(), u, g)
    assert nums["u_gap"] < 1e-4 and nums["g_gap"] < 1e-5
    cons = staged.constrain(q[0])[0]
    flat = torch.cat([v.reshape(-1) for v in cons.values()]).double()
    assert torch.allclose(flat, res.constrain(q[:1])[0], rtol=1e-6)


def test_dsl_model_has_the_reference_coordinates():
    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.dsl.compiler import compile_model
    from fugue_tpu_torch.inference.hmc import batched_force

    model_fn = compile_model(es.DSL).build(es.DSL_DATA, device="cpu")
    staged = ftt.stage(model_fn, device="cpu")
    assert staged.dim == 10 and staged.sites[0].address == "mu"
    q = torch.randn(32, 10, generator=torch.Generator().manual_seed(2))
    g, u = batched_force(staged.potential)(q)
    nums = checks.density_numbers(res, es.DSL_DATA, q.double(), u.double(), g.double())
    assert nums["u_gap"] < 1e-4 and nums["g_gap"] < 1e-5


def test_covtype_reference_matches_the_served_model():
    problem = ct.build(3, "cpu", rows=4000)
    q = 0.1 * torch.randn(16, 55, generator=torch.Generator().manual_seed(3))
    _, u, g = _program_force(problem, q)
    nums = checks.density_numbers(rct, problem.data, q.double(), u, g)
    assert nums["u_gap"] < 1e-2 and nums["g_gap"] < 1e-2
    blocked = rct.potential_and_grad(problem.data, q.double(), block=1000)
    whole = rct.potential_and_grad(problem.data, q.double(), block=10**6)
    assert torch.allclose(blocked[0], whole[0]) and torch.allclose(blocked[1], whole[1])


def test_eight_schools_posterior_moments():
    mean, var, err = res.posterior(es.DSL_DATA)
    # posteriordb's reference: mu 4.4 (sd 3.3), tau's log near 0.8
    assert abs(mean[0] - 4.4) < 0.1 and abs(math.sqrt(var[0]) - 3.3) < 0.1
    assert 0.5 < mean[1] < 1.1 and np.all(var > 0) and np.all(err == 0)


def test_covtype_importance_sampled_moments():
    """The importance-sampled moments agree with the Laplace ones to within
    a share of a posterior sd and report their own error."""
    problem = ct.build(0, "cpu", rows=60000)
    m, cov = rct.laplace(problem.data)
    sd = np.sqrt(np.diag(cov.numpy()))
    mean, var, err = rct.posterior(problem.data, draws=1 << 14)
    assert np.all(np.abs(mean - m.numpy()) / sd < 0.5)
    assert np.all(np.abs(np.sqrt(var) / sd - 1.0) < 0.1)
    assert np.all(err > 0) and np.all(np.sqrt(err) / sd < 0.1)


def test_chain_numbers_see_stuck_and_shifted_chains():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(32, 200, 3))
    ok = checks.chain_numbers(x, np.zeros(3), np.ones(3))
    assert ok["stuck_share"] == 0.0 and ok["mean_z"] < 5
    frozen = np.repeat(x[:, :1], 200, axis=1)
    assert checks.chain_numbers(frozen, np.zeros(3), np.ones(3))["stuck_share"] == 1.0
    assert checks.chain_numbers(x + 0.5, np.zeros(3), np.ones(3))["mean_z"] > 20
