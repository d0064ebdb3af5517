"""The ordered support of the port's model language: the ``Ordered``
transform (Stan's ``ordered``: x_1 = z_1, x_j = x_{j-1} + exp(z_j)) and the
``Ordered`` distribution (k iid draws of a real base, sorted, density
k!·Π p(x_j)), through staging, prior batches and the drives."""

import math

import numpy as np
import pytest
import torch

import fugue_tpu_torch as ftt
from fugue_tpu_torch import settings
from fugue_tpu_torch.core import transforms
from fugue_tpu_torch.core.distributions import ordered_support
from fugue_tpu_torch.errors import ValidationError


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def _z(shape, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).normal(0.0, 1.5, shape))


@pytest.mark.parametrize("k", [2, 3, 5])
def test_transform_round_trip_and_increasing(k):
    t = transforms.transform_for_support(ordered_support(k))
    assert isinstance(t, transforms.Ordered) and t.unconstrained_shape((4, k)) == (4, k)
    z = _z((64, k))
    x = t.forward(z)
    assert torch.all(x[:, 1:] > x[:, :-1])
    assert x[:, 0].equal(z[:, 0])
    torch.testing.assert_close(t.inverse(x), z, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("k", [2, 4])
def test_transform_log_det_is_the_jacobians(k):
    t = transforms.Ordered(k)
    for z in _z((8, k), seed=k):
        jac = torch.autograd.functional.jacobian(t.forward, z)
        _, logdet = torch.linalg.slogdet(jac)
        torch.testing.assert_close(t.log_det_jacobian(z), logdet, rtol=1e-12, atol=1e-12)


def test_transform_refuses_another_event_size():
    with pytest.raises(ValueError):
        transforms.Ordered(3).unconstrained_shape((2,))


def test_density_integrates_to_one_for_k_two():
    """2·N(x1)·N(x2) over x1 < x2 (log 2! included), by the trapezoid rule
    in the transform's coordinates, where the integrand, the density
    times |J|, is smooth; 0 outside the ordered region."""
    d = ftt.Ordered(ftt.Normal(0.5, 2.0), 2)
    t = d.unconstraining_transform()
    g1 = torch.linspace(-14.0, 15.0, 1201, dtype=torch.float64)
    g2 = torch.linspace(-30.0, 4.0, 1201, dtype=torch.float64)
    z = torch.stack(torch.meshgrid(g1, g2, indexing="ij"), dim=-1)
    dens = torch.exp(d.log_prob(t.forward(z)) + t.log_det_jacobian(z))
    total = torch.trapezoid(torch.trapezoid(dens, g2, dim=1), g1)
    assert float(total) == pytest.approx(1.0, abs=1e-9)
    x = torch.tensor([[1.0, 1.0], [2.0, -3.0]], dtype=torch.float64)
    assert torch.all(d.log_prob(x) == -math.inf)


def test_log_prob_is_log_k_factorial_plus_the_bases():
    base = ftt.Normal(-1.0, 0.7)
    x = torch.tensor([[-2.0, -0.5, 0.25], [0.1, 0.2, 3.0]], dtype=torch.float64)
    want = math.lgamma(4.0) + torch.sum(base.log_prob(x), dim=-1)
    torch.testing.assert_close(ftt.Ordered(base, 3).log_prob(x), want, rtol=1e-14, atol=1e-14)
    assert float(ftt.Ordered(base, 3).log_prob(x.flip(-1))[0]) == -math.inf


def test_validation():
    with pytest.raises(ValidationError):
        ftt.Ordered(ftt.HalfNormal(1.0), 2)
    with pytest.raises(ValidationError):
        ftt.Ordered(ftt.Normal(torch.zeros(3, dtype=torch.float64), 1.0), 2)
    with pytest.raises(ValidationError):
        ftt.Ordered(ftt.Normal(0.0, 1.0), 1)


def _model():
    mu = ftt.sample("mu", ftt.Ordered(ftt.Normal(0.0, 2.0), 3))
    s = ftt.sample("s", ftt.HalfNormal(1.0))
    ftt.observe("y", ftt.Normal(mu[1], s), torch.tensor([0.3, -0.2], dtype=torch.float64))
    return mu


def test_prior_batch_draws_sorted_order_statistics():
    staged = ftt.stage(_model, device="cpu")
    site = staged.site("mu")
    assert site.support.kind == "ordered" and site.shape == (3,) and site.z_shape == (3,)
    assert staged.dim == 4
    mu = staged.sample_prior_batch(7, 20_000)["mu"]
    assert mu.shape == (20_000, 3) and torch.all(mu[:, 1:] > mu[:, :-1])
    # the order statistics of 3 iid N(0, 2²): means ∓2·0.846284, 0
    e = 2.0 * 0.8462843753216345
    np.testing.assert_allclose(mu.mean(0).numpy(), [-e, 0.0, e], atol=0.05)


def test_staged_potential_has_the_transforms_jacobian():
    staged = ftt.stage(_model, device="cpu")
    z = _z((4,), seed=3)
    cont, logdet = staged.constrain(z)
    x = cont["mu"]
    assert torch.all(x[1:] > x[:-1])
    torch.testing.assert_close(staged.unconstrain(cont), z, rtol=1e-12, atol=1e-12)
    want = -(ftt.Ordered(ftt.Normal(0.0, 2.0), 3).log_prob(x)
             + ftt.HalfNormal(1.0).log_prob(cont["s"])
             + torch.sum(ftt.Normal(x[1], cont["s"]).log_prob(
                 torch.tensor([0.3, -0.2], dtype=torch.float64)))
             + z[1] + z[2] + z[3])
    torch.testing.assert_close(staged.potential(z), want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(logdet, z[1] + z[2] + z[3], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("rejuvenation", ["mh", "hmc"])
def test_smc_keeps_ordered_sites_ordered(rejuvenation):
    cfg = ftt.SMCConfig(rejuvenation=rejuvenation, rejuvenation_steps=2, hmc_leapfrog=4)
    res = ftt.adaptive_smc(3, 512, _model, cfg, device="cpu")
    mu = res.particles["mu"]
    assert res.converged and torch.all(mu[:, 1:] > mu[:, :-1])


def test_sbc_refuses_ordered_sites():
    from fugue_tpu_torch.errors import StagingError

    def model(data):
        mu = ftt.sample("mu", ftt.Ordered(ftt.Normal(0.0, 2.0), 2))
        ftt.observe("y", ftt.Normal(mu[1], 1.0), data["y"])

    with pytest.raises(StagingError, match="ordered"):
        ftt.sbc(0, model, {"y": torch.zeros(2, dtype=torch.float64)}, n_datasets=2,
                device="cpu")
