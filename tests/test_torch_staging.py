"""Parity of the PyTorch port's staging with fugue_tpu, on the CPU.

The same site table, dimension and flat unconstrained layout, and the
potential with its gradient at 16 random z, on eight-schools, the 20-site
hierarchical model (bench.py) and the Gaussian-plate model at
N = 2*8192 + 100. Both packages run in float64. Tolerance 1e-10 relative
(1e-10 absolute floor): the densities are the same formulas summed in a
different order, and the plate sums 16,484 terms.
"""

import jax
import numpy as np
import pytest
import torch

import fugue_tpu_torch as ftt
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference.hmc import batched_force

import torch_parity_models as models

TOL = dict(rtol=1e-10, atol=1e-10)
PAIRS = {
    "eight_schools": models.eight_schools_pair,
    "hierarchical": models.hierarchical_pair,
    "plate": lambda: models.plate_pair(2 * 8192 + 100),
}


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def _z(dim, n=16, seed=0):
    return np.random.default_rng(seed).normal(0.0, 0.7, (n, dim))


@pytest.mark.parametrize("name", list(PAIRS))
def test_site_table_and_layout_match(name):
    js, ts = PAIRS[name]()
    assert [s.address for s in ts.sites] == [s.address for s in js.sites]
    assert [s.shape for s in ts.sites] == [s.shape for s in js.sites]
    assert [s.support.kind for s in ts.sites] == [s.support.kind for s in js.sites]
    assert [s.kind for s in ts.sites] == [s.kind for s in js.sites]
    assert ts.dim == js.dim
    assert ts._z_offsets == js._z_offsets
    assert ts.observed_addresses == js.observed_addresses


@pytest.mark.parametrize("name", list(PAIRS))
def test_potential_and_gradient_match(name):
    js, ts = PAIRS[name]()
    z = _z(js.dim)
    jv, jg = jax.vmap(jax.value_and_grad(js.potential))(z)
    tg, tv = batched_force(ts.potential)(torch.as_tensor(z))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("name", list(PAIRS))
def test_constrain_and_density_parts_match(name):
    js, ts = PAIRS[name]()
    z = _z(js.dim, n=1, seed=1)[0]
    zt = torch.as_tensor(z)
    jc, jld = js.constrain(z)
    tc, tld = ts.constrain(zt)
    assert sorted(tc) == sorted(jc)
    for a in jc:
        np.testing.assert_allclose(tc[a].numpy(), np.asarray(jc[a]), **TOL)
    np.testing.assert_allclose(float(tld), float(jld), **TOL)
    jp, _ = js.log_density_parts_unconstrained(z)
    tp, _ = ts.log_density_parts_unconstrained(zt)
    for part in ("log_prior", "log_likelihood", "log_factors"):
        np.testing.assert_allclose(float(getattr(tp, part)), float(getattr(jp, part)), **TOL)
    latents = {a: torch.as_tensor(np.array(v)) for a, v in jc.items()}
    np.testing.assert_allclose(
        float(ts.log_joint(latents)), float(js.log_joint(jc)), **TOL
    )
    assert ts.flat_to_dict(zt).keys() == tc.keys()


@pytest.mark.parametrize("name", list(PAIRS))
def test_unconstrain_round_trips(name):
    _, ts = PAIRS[name]()
    for z in _z(ts.dim, n=4, seed=2):
        zt = torch.as_tensor(z)
        back = ts.unconstrain(ts.constrain(zt)[0])
        np.testing.assert_allclose(back.numpy(), z, **TOL)


def test_initial_position_is_a_prior_draw():
    _, ts = models.eight_schools_pair()
    z0 = ts.initial_position(3)
    assert z0.shape == (ts.dim,) and z0.dtype == torch.float64
    assert torch.equal(z0, ts.initial_position(3))
    assert not torch.equal(z0, ts.initial_position(4))
    prior = ts.sample_prior(3)
    assert torch.allclose(ts.constrain(z0)[0]["tau"], prior["tau"])


def test_discovery_runs_once_outside_any_transform(monkeypatch):
    """The site table is discovered once, eagerly; potentials evaluated
    under vmap(grad) for a batch of chains never rediscover."""
    levels = []
    real = ftt.StagedModel._discover

    def counting(self, seed):
        levels.append(torch._C._functorch.maybe_current_level())
        return real(self, seed)

    monkeypatch.setattr(ftt.StagedModel, "_discover", counting)
    ts = ftt.stage(models.torch_eight_schools(), device="cpu")
    batched_force(ts.potential)(torch.as_tensor(_z(ts.dim)))
    assert levels == [None]


def test_structure_errors():
    def dup():
        ftt.sample("x", ftt.Normal(0.0, 1.0))
        ftt.sample("x", ftt.Normal(0.0, 1.0))

    with pytest.raises(ftt.ModelStructureError):
        ftt.stage(dup, device="cpu")
    _, ts = models.eight_schools_pair()
    with pytest.raises(ftt.TraceAccessError):
        ts.log_density_parts({"mu": torch.tensor(0.0)})
    with pytest.raises(ftt.StagingError):
        ts.site("nope")
    assert ts.site("tau").support.kind == "positive"
