"""The PyTorch port's trans-dimensional MH against fugue_tpu, on the CPU.

The acceptance terms of a birth and of a death move on the model of
``examples/transdimensional.py`` (the joint ratio, the site-count term and
the cancelled prior of the birthed or vanished site), computed by the
port from its own traces, equal the JAX package's formula on the JAX
package's traces of the same values (1e-10). The whole chain recovers
P(b present | y) within 5 Monte-Carlo standard errors of the analytic
value (from the indicator's ESS), and the support proposals keep their
bounds and exact Hastings terms.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from fugue_tpu.runtime.handler import run as jrun
from fugue_tpu.runtime.interpreters import ReconcilingScoreGivenTrace as JRecon
from fugue_tpu_torch import settings
from fugue_tpu_torch.core.distributions import Support
from fugue_tpu_torch.inference import mh_dynamic as tmd
from fugue_tpu_torch.runtime.handler import run as trun
from fugue_tpu_torch.runtime.interpreters import ReconcilingScoreGivenTrace as TRecon
from fugue_tpu_torch.runtime.trace import Choice, Trace

Y_OBS = 2.4


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def jax_model():
    use_b = ft.sample("use_b", ft.Bernoulli(0.3))
    a = ft.sample("a", ft.Normal(0.0, 1.0))
    mean = a + ft.sample("b", ft.Normal(0.0, 1.0)) if bool(np.asarray(use_b)) else a
    ft.observe("y", ft.Normal(mean, 0.5), jnp.asarray(Y_OBS))


def torch_model():
    use_b = ftt.sample("use_b", ftt.Bernoulli(0.3))
    a = ftt.sample("a", ftt.Normal(0.0, 1.0))
    mean = a + ftt.sample("b", ftt.Normal(0.0, 1.0)) if bool(use_b) else a
    ftt.observe("y", ftt.Normal(mean, 0.5), torch.tensor(Y_OBS, dtype=torch.float64))


def _torch_trace(values):
    t = Trace()
    for addr, v in values.items():
        kind = "boolean" if v.dtype == torch.bool else "real"
        t.insert_choice(addr, Choice(value=v, log_prob=0.0, support=Support(kind),
                                     is_observed=False))
    return t


def _jax_trace(values):
    from fugue_tpu.runtime.trace import Choice as JChoice, Trace as JTrace
    from fugue_tpu.core.distributions import Support as JSupport

    t = JTrace()
    for addr, v in values.items():
        kind = "boolean" if v.dtype == jnp.bool_ else "real"
        t.choices[addr] = JChoice(value=v, log_prob=0.0, support=JSupport(kind),
                                  is_observed=False)
    return t


@pytest.mark.parametrize("move", ["birth", "death"])
def test_acceptance_terms_match_jax(move):
    a = 0.3
    if move == "birth":
        cur = {"use_b": torch.tensor(False), "a": torch.tensor(a, dtype=torch.float64)}
        prop = {"use_b": torch.tensor(True), "a": cur["a"]}
    else:
        cur = {"use_b": torch.tensor(True), "a": torch.tensor(a, dtype=torch.float64),
               "b": torch.tensor(1.1, dtype=torch.float64)}
        prop = {"use_b": torch.tensor(False), "a": cur["a"], "b": cur["b"]}
    # the proposal's base is the current trace with one site moved (the
    # engine's); score the current state, then the proposal the current state, then the proposal, both through the port
    h0 = TRecon(0, _torch_trace(cur), "cpu")
    _, tcur = trun(h0, torch_model)
    h1 = TRecon(5, _torch_trace(prop), "cpu")
    _, tprop = trun(h1, torch_model)
    n_cur = sum(not c.is_observed for c in tcur.choices.values())
    n_prop = sum(not c.is_observed for c in tprop.choices.values())
    got = tmd.log_acceptance(
        float(tprop.total_log_weight()), float(tcur.total_log_weight()), 0.0, n_cur, n_prop,
        sum(float(tprop.choices[x].log_prob) for x in h1.report.birthed),
        sum(float(tcur.choices[x].log_prob) for x in h1.report.vanished))

    # the JAX package's traces of the same values (a birth replays the
    # port's birthed b, so both score one point)
    jvals = lambda d: {k: jnp.asarray(v.numpy()) for k, v in d.items()}
    jprop_vals = dict(jvals(prop))
    if move == "birth":
        jprop_vals["b"] = jnp.asarray(tprop.choices["b"].value.numpy())
    _, jcur = jrun(JRecon(jax.random.PRNGKey(0), _jax_trace(jvals(cur))), jax_model)
    _, jprop = jrun(JRecon(jax.random.PRNGKey(1), _jax_trace(jprop_vals)), jax_model)
    birthed_lp = float(jprop.choices["b"].log_prob) if move == "birth" else 0.0
    vanished_lp = float(jcur.choices["b"].log_prob) if move == "death" else 0.0
    want = (float(jprop.total_log_weight()) - float(jcur.total_log_weight())
            + math.log(n_cur) - math.log(n_prop) - birthed_lp + vanished_lp)
    assert got == pytest.approx(want, rel=1e-10, abs=1e-10)
    assert (h1.report.birthed, h1.report.vanished) == \
        ((["b"], []) if move == "birth" else ([], ["b"]))


def test_structure_posterior_against_the_analytic_value():
    res = ftt.adaptive_mcmc_chain_dynamic(0, torch_model, n_samples=6000, n_warmup=1000,
                                          device="cpu")
    z0 = st.norm(0, np.sqrt(1.25)).pdf(Y_OBS)
    z1 = st.norm(0, np.sqrt(2.25)).pdf(Y_OBS)
    exact = 0.3 * z1 / (0.3 * z1 + 0.7 * z0)
    present = torch.tensor(res.presence("b"), dtype=torch.float64)
    e = ftt.ess(present).item()
    se = math.sqrt(exact * (1 - exact) / max(e, 1.0))
    assert abs(present.mean().item() - exact) < 5 * se, (present.mean().item(), exact, se, e)
    assert res.birth_count > 10 and abs(res.birth_count - res.death_count) <= 1
    assert 0.05 < res.accept_rate < 0.95
    assert len(res.traces) == 6000
    assert res.values("b").shape == (int(present.sum().item()),)


def test_support_proposals():
    g = torch.Generator().manual_seed(0)
    x = torch.tensor([0.5, 2.0], dtype=torch.float64)
    cand, corr = tmd.propose_site(g, Support("positive"), x, 0.7)
    assert bool((cand > 0).all())
    assert corr == pytest.approx(float(torch.sum(torch.log(cand) - torch.log(x))), rel=1e-12)
    for _ in range(20):
        c, h = tmd.propose_site(g, Support("interval", low=-1.0, high=2.0), x.clamp(max=1.9), 3.0)
        assert bool(((c >= -1.0) & (c <= 2.0)).all()) and h == 0.0
        k, _ = tmd.propose_site(g, Support("int_range", low=0, high=3), torch.tensor([0, 3]), 2.6)
        assert bool(((k >= 0) & (k <= 3)).all()) and k.dtype == torch.int64
        cat, _ = tmd.propose_site(g, Support("categorical", size=4), torch.tensor(1), 1.0)
        assert 0 <= int(cat) < 4
    flip, h = tmd.propose_site(g, Support("boolean"), torch.tensor(True), 1.0)
    assert not bool(flip) and h == 0.0
