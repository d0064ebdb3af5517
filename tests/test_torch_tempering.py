"""The PyTorch port's parallel tempering against fugue_tpu, on the CPU.

One transition of the JAX drive (``make_pt_drive`` from a given ladder,
one step, in sampling and in warmup), with its key schedule replayed to
draw every replica's momenta and accept uniform and the swap uniforms,
equals the port's ``pt_step`` fed those draws (float64, 1e-10): the
positions after the swap, the swap acceptances, the rungs' acceptance and
the Robbins–Monro step sizes. The ladders agree; the whole engine
recovers the bimodal target of ``examples/parallel_tempering.py`` within
Monte-Carlo error; a JAX ladder resumes in the port.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from fugue_tpu.inference.tempering import make_pt_drive as jax_drive
from fugue_tpu_torch import interop, settings
from fugue_tpu_torch.inference import tempering as tpt

EXACT = dict(rtol=1e-10, atol=1e-10)


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def jax_bimodal():
    x = ft.sample("x", ft.Normal(0.0, 10.0))
    mix = jnp.logaddexp(jnp.log(0.3) + ft.Normal(-4.0, 0.4).log_prob(x),
                        jnp.log(0.7) + ft.Normal(4.0, 0.4).log_prob(x))
    ft.factor(mix - ft.Normal(0.0, 10.0).log_prob(x))


def torch_bimodal():
    x = ftt.sample("x", ftt.Normal(0.0, 10.0))
    mix = torch.logaddexp(math.log(0.3) + ftt.Normal(-4.0, 0.4).log_prob(x),
                          math.log(0.7) + ftt.Normal(4.0, 0.4).log_prob(x))
    ftt.factor(mix - ftt.Normal(0.0, 10.0).log_prob(x))


def jax_pair():
    a = ft.sample("a", ft.Normal(0.0, 2.0))
    s = ft.sample("s", ft.LogNormal(0.0, 0.5))
    ft.observe("y", ft.Normal(a, s), jnp.asarray([0.3, -1.2, 2.0]))


def torch_pair():
    a = ftt.sample("a", ftt.Normal(0.0, 2.0))
    s = ftt.sample("s", ftt.LogNormal(0.0, 0.5))
    ftt.observe("y", ftt.Normal(a, s), torch.tensor([0.3, -1.2, 2.0], dtype=torch.float64))


def test_ladder_matches_jax():
    for k, b in ((8, 0.02), (5, 0.1), (1, 0.5)):
        np.testing.assert_allclose(tpt.geometric_ladder(k, b, device="cpu").numpy(),
                                   np.asarray(ft.geometric_ladder(k, b)), **EXACT)


@pytest.mark.parametrize("warmup", [False, True], ids=["sampling", "warmup"])
def test_one_transition_matches_the_jax_drive(warmup):
    K, C, L = 5, 6, 4
    cfg = ft.PTConfig(n_temps=K, beta_min=0.05, n_leapfrog=L)
    js = ft.stage(jax_pair)
    ts = ftt.stage(torch_pair, device="cpu")
    rng = np.random.default_rng(2)
    q0 = rng.normal(size=(K, C, 2)) * 0.7
    eps0 = np.linspace(0.5, 0.2, K)
    drive = jax_drive(js, cfg, C, 0 if warmup else 1, 1 if warmup else 0)
    key = jax.random.PRNGKey(9)
    q_f, eps_f, _, accs, pair_accs = drive(key, q_over=jnp.asarray(q0),
                                           eps_over=jnp.asarray(eps0))
    _, k_run = jax.random.split(jax.random.fold_in(key, 23))
    k_hmc, k_swap = jax.random.split(jax.random.split(k_run, 1)[0])
    keys = jax.random.split(k_hmc, K * C)

    def noise(k):
        k_mom, k_acc = jax.random.split(k)
        return (jax.random.normal(k_mom, (2,), jnp.float64),
                jnp.log(jax.random.uniform(k_acc, (), jnp.float64, 1e-38, 1.0)))

    p, log_u = jax.vmap(noise)(keys)
    u = jax.random.uniform(k_swap, (K, C), jnp.float64, 1e-38, 1.0)
    betas = tpt.geometric_ladder(K, 0.05, device="cpu")
    q, eps, _, ap, pair_acc = tpt.pt_step(
        ts, tpt.PTConfig(n_temps=K, beta_min=0.05, n_leapfrog=L), betas, torch.tensor(q0),
        torch.tensor(eps0), 0, warmup, torch.tensor(np.asarray(p)).reshape(K, C, 2),
        torch.tensor(np.asarray(log_u)).reshape(K, C), torch.tensor(np.asarray(u)))
    np.testing.assert_allclose(q.numpy(), np.asarray(q_f), **EXACT)
    np.testing.assert_allclose(eps.numpy(), np.asarray(eps_f), **EXACT)
    if not warmup:
        np.testing.assert_allclose(ap.mean(1).numpy(), np.asarray(accs)[0], **EXACT)
        np.testing.assert_allclose(pair_acc.numpy(), np.asarray(pair_accs)[0], **EXACT)


def test_swap_acceptance_is_the_exchange_ratio():
    betas = torch.tensor([0.25, 0.5, 1.0], dtype=torch.float64)
    q = torch.arange(6, dtype=torch.float64).reshape(3, 2, 1)
    ll = torch.tensor([[-1.0, -5.0], [-2.0, -1.0], [-3.0, -0.5]], dtype=torch.float64)
    u = torch.full((3, 2), 0.5, dtype=torch.float64)
    _, _, acc = tpt.swap_phase(q, ll, betas, 0, u)
    # pair (0, 1): log a = (0.25 - 0.5) * (ll1 - ll0) = (-0.25)(-1, 4) → (0.25, -1)
    assert acc[0].tolist() == [1.0, 0.0]
    assert torch.isnan(acc[1]).all() and torch.isnan(acc[2]).all()
    q_sw, ll_sw, acc = tpt.swap_phase(q, ll, betas, 1, torch.full((3, 2), 0.99,
                                                                 dtype=torch.float64))
    # pair (1, 2): log a = (0.5 - 1)(ll2 - ll1) = (0.5, -0.25); log 0.99 < 0.5 only
    assert acc[1].tolist() == [1.0, 0.0]
    assert q_sw[2, 0, 0].item() == q[1, 0, 0].item() and q_sw[1, 0, 0].item() == q[2, 0, 0].item()
    assert ll_sw[2, 1].item() == ll[2, 1].item()


def test_bimodal_target_within_monte_carlo_error():
    res = ftt.pt_chain(0, torch_bimodal, n_samples=300, n_warmup=200, n_chains=16,
                       config=ftt.PTConfig(n_temps=8, beta_min=0.02, n_leapfrog=12),
                       device="cpu")
    x = res.samples["x"]
    right = (x > 0).double()
    for v, want in ((right, 0.7), (x, 1.6)):
        e = ftt.ess_multichain(v).item()
        se = v.std().item() / math.sqrt(max(e, 1.0))
        assert abs(v.mean().item() - want) < 5 * se, (v.mean().item(), want, se)
    assert res.swap_rate.shape == (7,) and bool((res.swap_rate > 0.05).all())
    assert res.final_positions.shape == (8, 16, 1) and res.step_size.shape == (8,)


def test_a_jax_ladder_resumes_in_the_port():
    cfg = dict(n_temps=4, beta_min=0.1, n_leapfrog=6)
    jres = ft.pt_chain(jax.random.PRNGKey(0), jax_pair, n_samples=3, n_warmup=10,
                       n_chains=5, config=ft.PTConfig(**cfg))
    state = interop.pt_state_from_numpy(np.asarray(jres.final_positions),
                                        np.asarray(jres.step_size), device="cpu",
                                        dtype=torch.float64)
    res = ftt.pt_chain(1, torch_pair, n_samples=4, n_chains=5, config=ftt.PTConfig(**cfg),
                       resume=state, device="cpu")
    np.testing.assert_allclose(res.step_size.numpy(), np.asarray(jres.step_size), **EXACT)
    assert res.samples["s"].shape == (5, 4) and bool((res.samples["s"] > 0).all())
    with pytest.raises(ValueError):
        ftt.pt_chain(1, torch_pair, n_samples=1, n_chains=4, config=ftt.PTConfig(**cfg),
                     resume=state, device="cpu")
