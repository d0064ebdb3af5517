"""The PyTorch port's HMC-within-Gibbs against fugue_tpu, on the CPU.

One sweep of the JAX drive (``make_gibbs_drive`` from a given state and
step size, one sample, no warmup), with its own key schedule replayed to
draw the momenta, accept uniforms and every discrete proposal (a flip, a
Poisson walk and a categorical redraw), equals the port's ``gibbs_sweep``
fed those draws (float64, 1e-10). The whole engine recovers the mixed
model of ``examples/discrete_models.py`` (P(heads | y) and E[mu | y] in
closed form) within Monte-Carlo error, and a JAX result resumes in the
port through ``interop.gibbs_state_from_numpy``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from chip_smoke import mixed_discrete_exact, mixed_discrete_model
from fugue_tpu.inference.gibbs import make_gibbs_drive as jax_drive
from fugue_tpu_torch import interop, settings
from fugue_tpu_torch.inference import gibbs as tg

EXACT = dict(rtol=1e-10, atol=1e-10)
Y = np.array([1.1, 0.9])
PROBS = np.array([0.2, 0.3, 0.5])


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def jax_model():
    heads = ft.sample("heads", ft.Bernoulli(0.5))
    k = ft.sample("k", ft.Poisson(3.0))
    c = ft.sample("c", ft.Categorical(jnp.asarray(PROBS)))
    mu = ft.sample("mu", ft.Normal(jnp.where(heads, 1.0, -1.0) + 0.1 * k + 0.2 * c, 1.0))
    ft.observe("y", ft.Normal(mu, 0.5), jnp.asarray(Y))


def torch_model():
    heads = ftt.sample("heads", ftt.Bernoulli(0.5))
    k = ftt.sample("k", ftt.Poisson(3.0))
    c = ftt.sample("c", ftt.Categorical(torch.tensor(PROBS)))
    shift = torch.where(heads, 1.0, -1.0).to(torch.float64) + 0.1 * k.to(torch.float64) \
        + 0.2 * c.to(torch.float64)
    mu = ftt.sample("mu", ftt.Normal(shift, 1.0))
    ftt.observe("y", ftt.Normal(mu, 0.5), torch.tensor(Y))


def _jax_noise(key, staged, disc, scale, d):
    """The draws JAX's sweep takes from ``key`` for one chain."""
    k_hmc, k_disc = jax.random.split(key)
    k_mom, k_acc = jax.random.split(k_hmc)
    p = jax.random.normal(k_mom, (d,), jnp.float64)
    log_u = jnp.log(jax.random.uniform(k_acc, (), jnp.float64, 1e-38, 1.0))
    noise, dlog_u = {}, {}
    for j, s in enumerate(staged.discrete_sites):
        _, k_prop, k_a = jax.random.split(jax.random.fold_in(k_disc, j), 3)
        x = disc[s.address]
        if s.support.kind == "boolean":
            noise[s.address] = None
        elif s.support.kind == "categorical":
            noise[s.address] = jax.random.randint(k_prop, jnp.shape(x), 0, s.support.size)
        else:
            k1, k2 = jax.random.split(k_prop)
            width = int(max(round(scale), 1))
            mag = jax.random.randint(k1, jnp.shape(x), 1, jnp.int32(1) + width)
            sign = jnp.where(jax.random.bernoulli(k2, 0.5, jnp.shape(x)), 1, -1)
            noise[s.address] = (mag, sign)
        dlog_u[s.address] = jnp.log(jax.random.uniform(k_a, (), jnp.float64, 1e-38, 1.0))
    return p, log_u, noise, dlog_u


def _stack(items):
    if items[0] is None:
        return None
    if isinstance(items[0], tuple):
        return tuple(torch.tensor(np.stack([np.asarray(it[i]) for it in items]))
                     for i in range(len(items[0])))
    return torch.tensor(np.stack([np.asarray(it) for it in items]))


@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_one_sweep_matches_the_jax_drive(scale):
    C, eps, L = 6, 0.3, 5
    js = ft.stage(jax_model)
    ts = ftt.stage(torch_model, device="cpu")
    assert [s.address for s in ts.discrete_sites] == ["c", "heads", "k"]
    rng = np.random.default_rng(1)
    z0 = rng.normal(size=(C, 1))
    d0 = {"c": rng.integers(0, 3, C), "heads": rng.integers(0, 2, C).astype(bool),
          "k": rng.integers(0, 6, C)}
    jd0 = {"c": jnp.asarray(d0["c"], jnp.int64), "heads": jnp.asarray(d0["heads"]),
           "k": jnp.asarray(d0["k"], jnp.int64)}
    drive = jax_drive(js, ft.HMCConfig(n_leapfrog=L, step_size=eps), C, 1, 0,
                      discrete_scale=scale)
    k_run = jax.random.PRNGKey(7)
    _, _, aps, dacc, _, (jz, jdisc) = drive(jax.random.PRNGKey(0), jax.random.PRNGKey(1),
                                            k_run, state_over=(jnp.asarray(z0), jd0),
                                            eps_over=eps)
    key = jax.random.split(jax.random.fold_in(k_run, 1), 1)[0]
    keys = jax.random.split(key, C)
    draws = [_jax_noise(keys[c], js, {a: v[c] for a, v in jd0.items()}, scale, 1)
             for c in range(C)]
    p = _stack([d[0] for d in draws])
    log_u = _stack([d[1] for d in draws])
    noise = {a: _stack([d[2][a] for d in draws]) for a in d0}
    dlog_u = {a: _stack([d[3][a] for d in draws]) for a in d0}
    tdisc = {a: torch.tensor(np.asarray(v)) for a, v in jd0.items()}
    z, disc, ap, acc = tg.gibbs_sweep(ts, torch.tensor(z0), tdisc, eps, L, p, log_u,
                                      noise, dlog_u)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **EXACT)
    for a in d0:
        np.testing.assert_array_equal(disc[a].numpy(), np.asarray(jdisc[a]))
    np.testing.assert_allclose(ap.numpy(), np.asarray(aps)[0], **EXACT)
    np.testing.assert_allclose(acc.numpy(), np.asarray(dacc)[0], **EXACT)


def test_mixed_model_against_the_closed_form():
    res = ftt.gibbs_chain(3, mixed_discrete_model("cpu", torch.float64), n_samples=400,
                          n_warmup=200, n_chains=32, device="cpu")
    _, p_heads = mixed_discrete_exact()
    # given heads, mu | y ~ N((m + 8 ybar) / 9, 1/9): ybar = 1.0, m = +-1
    mean_mu = p_heads * (1.0 + 8.0) / 9.0 + (1.0 - p_heads) * (-1.0 + 8.0) / 9.0
    heads = res.samples["heads"].double()
    mu = res.samples["mu"]
    assert heads.shape == mu.shape == (32, 400)
    for x, want in ((heads, p_heads), (mu, mean_mu)):
        e = ftt.ess_multichain(x).item()
        se = x.std().item() / math.sqrt(max(e, 1.0))
        assert abs(x.mean().item() - want) < 5 * se, (x.mean().item(), want, se)
    assert 0.3 < res.accept_prob_hmc.mean().item() <= 1.0
    assert 0.0 < res.accept_rate_discrete.item() < 1.0


def test_a_jax_result_resumes_in_the_port():
    jres = ft.gibbs_chain(jax.random.PRNGKey(0), jax_model, n_samples=5, n_warmup=20,
                          n_chains=4)
    state = interop.gibbs_state_from_numpy(
        np.asarray(jres.final_positions),
        {a: np.asarray(v) for a, v in jres.final_discrete.items()}, jres.step_size,
        device="cpu", dtype=torch.float64)
    res = ftt.gibbs_chain(1, torch_model, n_samples=6, n_chains=4, resume=state, device="cpu")
    assert res.step_size == pytest.approx(jres.step_size)
    assert res.samples["mu"].shape == (4, 6) and res.samples["k"].shape == (4, 6)
    assert res.samples["k"].dtype == torch.int64
    with pytest.raises(ValueError):
        ftt.gibbs_chain(1, torch_model, n_samples=2, n_chains=3, resume=state, device="cpu")
