"""bench.py's four scale rows in the PyTorch port against fugue_tpu, on the CPU.

The rows are NUTS and ChEES-SNAPER on the d = 1024 logistic targets, dense-mass
HMC at d = 256 and the 128-group plate; ``chip_smoke.py`` runs them on the
card at full width (phases scale_nuts, scale_chees, scale_densemass,
scale_plate). Here they run at small width, with chip_smoke's own builders on
the torch side and the bench models (``tests/torch_parity_models.py``) on the
JAX side, from the same numpy data:

- the potentials and their gradients at 8 random points: 1e-10 where both
  packages take plain float64 products (the dense and plate models), 1e-6
  relative for the bf16 products (``tests/test_torch_linalg.py``'s
  tolerance);
- the constrain replay in batches of the chain count, equal to JAX's;
- the correlated design against its recipe, and the two closed-form
  posteriors against a direct float64 computation (1e-10);
- a short dense-mass ``hmc_chain`` and a short group-plate chain in each
  package, held by the smoke's own gate functions against the closed form
  (5 Monte-Carlo standard errors);
- the smoke's gate functions on exact posterior draws (they pass) and on
  draws made wrong on purpose (they fail), so a bug in a gate shows here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import fugue_tpu_torch as ftt
import torch_parity_models as models
from fugue_tpu.inference import hmc as jhmc
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference.hmc import batched_force

EXACT = dict(rtol=1e-10, atol=1e-10)
BF16_PRODUCTS = dict(rtol=1e-6, atol=1e-6)  # tests/test_torch_linalg.py's REL


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def _same_potential(pair, dim, tol, scale=0.3, seed=0):
    """Value and gradient of both packages' potentials at 8 points."""
    js, ts = pair
    assert js.dim == ts.dim == dim
    z = np.random.default_rng(seed).normal(0.0, scale, (8, dim))
    jv, jg = jax.vmap(jax.value_and_grad(js.potential))(jnp.asarray(z))
    tg, tv = batched_force(ts.potential)(torch.as_tensor(z))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **tol)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **tol)


def _logistic_numpy(kind, d=16, n=512):
    make = cs.logistic_data if kind == "iid" else cs.correlated_logistic_data
    x, y, w_true = make(d, n, seed=3, device="cpu")
    return x.float().numpy().astype(np.float64), y.numpy(), w_true


@pytest.mark.parametrize("kind", ["iid", "correlated"])
def test_logistic_potential_matches_jax(kind):
    x, y, _ = _logistic_numpy(kind)
    _same_potential(models.logistic_pair(x, y), 16, BF16_PRODUCTS)


def test_constrain_positions_runs_chain_sized_batches():
    """The draws go through the constrain replay in batches of n_chains (the
    drive's own batch): one model run per sample index, never one over all
    chains x samples (256 x 256 draws of the d = 1024 row would hold 26 GB
    of float32 logits).
    The values equal the JAX package's constrain_positions."""
    from fugue_tpu_torch.inference.hmc import constrain_positions

    x, y, _ = _logistic_numpy("iid")
    js, _ = models.logistic_pair(x, y)
    counted, runs = cs._counted(cs.logistic_model(torch.as_tensor(x).to(torch.bfloat16),
                                                  torch.as_tensor(y)))
    ts = ftt.stage(counted, device="cpu")
    pos = np.random.default_rng(5).normal(0.0, 0.3, (4, 6, 16))
    runs[0] = 0
    got = constrain_positions(ts, torch.as_tensor(pos))["w"]
    assert runs[0] == 6 and got.shape == (4, 6, 16)
    want = jhmc.constrain_positions(js, jnp.asarray(pos))["w"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)


def test_correlated_design_follows_its_recipe():
    """X = bf16(Z A) with A = Q diag(s) Q^T: the builder's design against the
    same draws replayed in float64, within a bf16 rounding of the product;
    A's spectrum is s."""
    d, n = 16, 512
    x, _, _ = cs.correlated_logistic_data(d, n, seed=3, device="cpu")
    g = torch.Generator().manual_seed(3)
    z = (torch.randn((n, d), generator=g) / np.sqrt(d)).to(torch.bfloat16).double()
    q, _ = torch.linalg.qr(torch.randn((d, d), generator=g))
    s = torch.exp(torch.linspace(np.log(0.2), np.log(3.0), d))
    a = (q * s) @ q.T
    np.testing.assert_allclose(torch.linalg.eigvalsh(a.double()).numpy(), s.double().numpy(),
                               rtol=1e-5)
    want = z @ a.to(torch.bfloat16).double()
    assert x.dtype == torch.bfloat16
    assert (x.double() - want).abs().max().item() <= 2.0**-8 * want.abs().max().item()


def _densemass_numpy(d=8, n=64):
    x, y, w_true, tril = cs.densemass_data(d, n, device="cpu", dtype=torch.float64)
    return x.numpy(), y.numpy(), tril.numpy()


def test_densemass_potential_matches_jax():
    x, y, tril = _densemass_numpy()
    _same_potential(models.densemass_pair(x, y, tril), 8, EXACT)


def test_densemass_posterior_is_the_closed_form():
    x, y, tril = _densemass_numpy()
    mean, cov = cs.densemass_posterior(*(torch.as_tensor(a) for a in (x, y, tril)))
    lam = np.linalg.inv(tril @ tril.T) + x.T @ x
    np.testing.assert_allclose(cov.numpy(), np.linalg.inv(lam), **EXACT)
    np.testing.assert_allclose(mean.numpy(), np.linalg.solve(lam, x.T @ y), **EXACT)


def _group_plate_numpy(groups=4, rows=32):
    return cs.group_plate_data(groups, rows, device="cpu", dtype=torch.float64).numpy()


def test_group_plate_potential_matches_jax():
    _same_potential(models.group_plate_pair(_group_plate_numpy()), 5, EXACT, scale=1.0)


def test_group_plate_posterior_is_exact():
    """The closed form against the joint Gaussian of (mu, theta) solved
    directly: precision of mu 2 (prior, theta's mean), of theta_g 1 + n."""
    y = _group_plate_numpy()
    g, n = y.shape
    prec = np.zeros((g + 1, g + 1))
    prec[0, 0] = 1.0 + g
    prec[0, 1:] = prec[1:, 0] = -1.0
    prec[1:, 1:] = (1.0 + n) * np.eye(g)
    b = np.concatenate([[0.0], y.sum(axis=1)])
    cov = np.linalg.inv(prec)
    mean, sd = cs.group_plate_posterior(torch.as_tensor(y))
    np.testing.assert_allclose(mean.numpy(), cov @ b, **EXACT)
    np.testing.assert_allclose(sd.numpy(), np.sqrt(np.diag(cov)), **EXACT)


DENSE_CHAIN = dict(n_samples=300, n_warmup=200, n_chains=16)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_dense_mass_chain_against_the_closed_form(package):
    """A short dense-mass hmc_chain (L = 16, target 0.85) on the d = 8 row,
    held by scale_densemass's gates: every coordinate within 5 MC-SE, every
    sd ratio within 5 of its standard errors, max split-R-hat < 1.01."""
    x, y, tril = _densemass_numpy()
    js, ts = models.densemass_pair(x, y, tril)
    mean, cov = cs.densemass_posterior(*(torch.as_tensor(a) for a in (x, y, tril)))
    if package == "jax":
        cfg = jhmc.HMCConfig(n_leapfrog=16, mass="dense", target_accept=0.85)
        res = jhmc.hmc_chain(jax.random.PRNGKey(22), staged=js, config=cfg, **DENSE_CHAIN)
        draws, divs = (torch.tensor(np.asarray(a)) for a in (res.samples["w"], res.divergences))
    else:
        cfg = ftt.HMCConfig(n_leapfrog=16, mass="dense", target_accept=0.85)
        res = ftt.hmc_chain(22, staged=ts, config=cfg, **DENSE_CHAIN)
        draws, divs = res.samples["w"], res.divergences
    assert draws.shape == (16, 300, 8) and res.inv_mass.shape == (8, 8)
    cs.check_densemass(cs.densemass_stats(draws, divs, mean, cov), f"{package} dense")


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_group_plate_chain_against_the_closed_form(package):
    """A short group-plate chain (4 groups x 32 rows, L = 16, jitter 0.5,
    bench.py's warm start) held by scale_plate's gates: mu and every theta
    within 5 MC-SE of the exact posterior, max split-R-hat < 1.01."""
    y = _group_plate_numpy()
    n = y.shape[1]
    js, ts = models.group_plate_pair(y)
    mean, sd = cs.group_plate_posterior(torch.as_tensor(y))
    z0 = np.concatenate([[0.0], y.mean(axis=1) * n / (n + 1.0)])
    kw = dict(n_samples=300, n_warmup=150, n_chains=16, init_jitter=0.01)
    if package == "jax":
        res = jhmc.hmc_chain(jax.random.PRNGKey(23), staged=js, init_position=jnp.asarray(z0),
                             config=jhmc.HMCConfig(n_leapfrog=16, jitter=0.5), **kw)
        mu, theta, divs = (torch.tensor(np.asarray(a)) for a in
                           (res.samples["mu"], res.samples["theta"], res.divergences))
    else:
        res = ftt.hmc_chain(23, staged=ts, init_position=torch.as_tensor(z0),
                            config=ftt.HMCConfig(n_leapfrog=16, jitter=0.5), **kw)
        mu, theta, divs = res.samples["mu"], res.samples["theta"], res.divergences
    assert theta.shape == (16, 300, 4)
    cs.check_group_plate(cs.group_plate_stats(mu, theta, divs, mean, sd), f"{package} group plate")


# The gates on exact draws and on draws made wrong on purpose.


def _exact_draws(mean, sd, c=16, s=400, seed=0):
    """iid draws of independent N(mean_k, sd_k) coordinates, (C, S, k)."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(mean.numpy() + sd.numpy() * rng.normal(size=(c, s, mean.shape[0])))


def _trending(draws, k, chains=2):
    """``draws`` with coordinate k of the first chains sorted in time: the
    same values, so the same mean and sd, but each of those chains drifts
    from low to high, which split-R-hat exists to catch."""
    out = draws.clone()
    out[:chains, :, k] = torch.sort(out[:chains, :, k], dim=1).values
    return out


def _no_divergences(draws):
    return torch.zeros(draws.shape[:2], dtype=torch.bool)


def test_densemass_gates_pass_exact_draws_and_fail_wrong_ones():
    x, y, tril = _densemass_numpy()
    mean, cov = cs.densemass_posterior(*(torch.as_tensor(a) for a in (x, y, tril)))
    sd = torch.diagonal(cov).sqrt()
    draws = _exact_draws(mean, sd)
    row = cs.densemass_stats(draws, _no_divergences(draws), mean, cov)
    cs.check_densemass(row, "exact")
    assert row["max_abs_mean_z"] < 5 and row["split_rhat_max"] < 1.01
    assert 0.9 < row["sd_ratio_min"] <= row["sd_ratio_max"] < 1.1
    shifted = draws.clone()
    shifted[..., 3] += 0.1 * sd[3]  # 10 MC-SE at 6,400 draws
    with pytest.raises(cs.SmokeFailure, match="MC-SE"):
        cs.check_densemass(cs.densemass_stats(shifted, _no_divergences(draws), mean, cov),
                           "shifted")
    wide = mean + 1.3 * (draws - mean)
    with pytest.raises(cs.SmokeFailure, match="sd ratio"):
        cs.check_densemass(cs.densemass_stats(wide, _no_divergences(draws), mean, cov),
                           "too wide")
    with pytest.raises(cs.SmokeFailure, match="R-hat"):
        cs.check_densemass(cs.densemass_stats(_trending(draws, 5), _no_divergences(draws), mean,
                                              cov), "trending")


def test_group_plate_gates_pass_exact_draws_and_fail_wrong_ones():
    y = _group_plate_numpy()
    mean, sd = cs.group_plate_posterior(torch.as_tensor(y))
    draws = _exact_draws(mean, sd)
    divs = _no_divergences(draws)
    row = cs.group_plate_stats(draws[..., 0], draws[..., 1:], divs, mean, sd)
    cs.check_group_plate(row, "exact")
    assert abs(row["mu_z"]) < 5 and row["max_abs_group_z"] < 5
    assert row["max_split_rhat_groups"] < 1.01 and row["divergence_rate"] == 0.0
    # bench.py's approximate centre ybar n / (n + 1) leaves out E[mu | Y] / (n + 1)
    n = y.shape[1]
    approx = torch.as_tensor(y.mean(axis=1) * n / (n + 1.0))
    assert (approx - mean[1:]).abs().max().item() > 0.0
    shifted = draws.clone()
    shifted[..., 2] += 0.1 * sd[2]
    with pytest.raises(cs.SmokeFailure, match="group"):
        cs.check_group_plate(cs.group_plate_stats(shifted[..., 0], shifted[..., 1:], divs, mean,
                                                  sd), "shifted")
    trending = _trending(draws, 4)
    with pytest.raises(cs.SmokeFailure, match="R-hat"):
        cs.check_group_plate(cs.group_plate_stats(trending[..., 0], trending[..., 1:], divs, mean,
                                                  sd), "trending")


def test_logistic_gates_pass_posterior_draws_and_fail_wrong_ones():
    """The logistic rows' gates at D = 1024 on draws from N(m, sd) with the
    truth one more posterior draw: mean error E|Z| = 0.798 passes; a biased
    mean, trending chains or divergences fail."""
    rng = np.random.default_rng(1)
    d = 1024
    m, sd = rng.normal(size=d), np.exp(rng.normal(-1.0, 0.2, d))
    w_true = torch.as_tensor(m + sd * rng.normal(size=d))
    sd_t = torch.as_tensor(sd)
    draws = _exact_draws(torch.as_tensor(m), sd_t, c=16, s=256, seed=2)
    divs = _no_divergences(draws)
    stats = cs.logistic_stats(draws, divs, w_true, sd_t)
    cs.check_logistic_stats(stats, "exact")
    assert stats["ess_min"] <= 16 * 256
    with pytest.raises(cs.SmokeFailure, match="outside"):
        cs.check_logistic_stats(cs.logistic_stats(draws + sd_t, divs, w_true, sd_t), "biased")
    with pytest.raises(cs.SmokeFailure, match="R-hat"):
        cs.check_logistic_stats(cs.logistic_stats(_trending(draws, 32), divs, w_true, sd_t),
                                "trending")
    divs[:, :8] = True  # 3%
    with pytest.raises(cs.SmokeFailure, match="divergence"):
        cs.check_logistic_stats(cs.logistic_stats(draws, divs, w_true, sd_t), "divergent")
