"""Parity of the PyTorch port's handlers and ``Trace`` with fugue_tpu, on the CPU.

One model with real, positive, bool and integer sites and an observation is
written for each package, and a base trace is made in each from the same
values. Every handler and ``score_given_trace*`` function runs it in both
packages: the values, per-site log-probs and the three accumulators agree
to 1e-12 in float64. A site that a handler draws fresh draws from each
package's own generator, so its value is checked for shape and kind and
its log-prob against the port's own distribution; the other sites are
compared. Errors (types, codes, messages), warnings, the safe handlers'
-inf poisoning and ``ReconcileReport`` match. ``simulate`` and
``replay_partial``, single and batched, give the pinned and fresh
structure of the JAX package's.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from fugue_tpu.runtime.interpreters import PartialValuesHandler as JPartial
from fugue_tpu_torch import settings
from fugue_tpu_torch.runtime.interpreters import PartialValuesHandler as TPartial

EXACT = dict(rtol=1e-12, atol=1e-12)
Y = np.array([0.4, 1.9, -0.3, 1.1])
VALUES = {"mu": 0.7, "s": 1.3, "b": True, "k": 2}


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def jmodel():
    mu = ft.sample("mu", ft.Normal(0.0, 2.0))
    s = ft.sample("s", ft.LogNormal(0.0, 0.5))
    b = ft.sample("b", ft.Bernoulli(0.3))
    k = ft.sample("k", ft.Poisson(3.0))
    ft.observe("y", ft.Normal(mu + 0.1 * k, s), jnp.asarray(Y))
    return jnp.where(b, mu, -mu)


def tmodel():
    mu = ftt.sample("mu", ftt.Normal(0.0, 2.0))
    s = ftt.sample("s", ftt.LogNormal(0.0, 0.5))
    b = ftt.sample("b", ftt.Bernoulli(0.3))
    k = ftt.sample("k", ftt.Poisson(3.0))
    ftt.observe("y", ftt.Normal(mu + 0.1 * k.to(mu.dtype), s), torch.as_tensor(Y))
    return torch.where(b, mu, -mu)


def _jvals(values):
    return {a: jnp.asarray(v) for a, v in values.items()}


def _tvals(values):
    out = {}
    for a, v in values.items():
        arr = np.asarray(v)
        out[a] = torch.as_tensor(arr) if arr.dtype.kind != "i" else torch.as_tensor(arr, dtype=torch.int64)
    return out


def _base(values=VALUES):
    """(JAX base trace, port base trace) from the same values."""
    _, jt = ft.run(ft.ValuesHandler(_jvals(values)), jmodel)
    _, tt = ftt.run(ftt.ValuesHandler(_tvals(values)), tmodel)
    return jt, tt


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _assert_traces_equal(jt, tt):
    assert list(jt.choices) == list(tt.choices)
    for a, jc in jt.choices.items():
        tc = tt.choices[a]
        assert (jc.kind, jc.is_observed, jc.support.kind) == (tc.kind, tc.is_observed,
                                                              tc.support.kind), a
        np.testing.assert_allclose(_np(tc.value), np.asarray(jc.value), **EXACT)
        np.testing.assert_allclose(_np(tc.log_prob), np.asarray(jc.log_prob), **EXACT)
    for acc in ("log_prior", "log_likelihood", "log_factors"):
        np.testing.assert_allclose(_np(getattr(tt, acc)), np.asarray(getattr(jt, acc)), **EXACT)


def _assert_fresh(tt, addr, dist):
    """A fresh draw at ``addr``: its shape, kind and log-prob under the
    port's own distribution."""
    c = tt.choices[addr]
    assert c.value.shape == ()
    np.testing.assert_allclose(_np(c.log_prob), _np(dist.log_prob(c.value)), **EXACT)


def _same_error(jfn, tfn):
    with pytest.raises(Exception) as je:
        jfn()
    with pytest.raises(Exception) as te:
        tfn()
    assert type(te.value).__name__ == type(je.value).__name__
    assert te.value.code == je.value.code
    assert str(te.value) == str(je.value)
    return te.value


# ---------------------------------------------------------------------------
# Trace
# ---------------------------------------------------------------------------


def test_trace_surface_matches_jax():
    jt, tt = _base()
    assert ("mu" in tt, "zz" in tt, len(tt)) == ("mu" in jt, "zz" in jt, len(jt)) == (True, False, 5)
    assert list(tt.addresses()) == list(jt.addresses())
    assert tt.sorted_addresses() == jt.sorted_addresses() == ["b", "k", "mu", "s", "y"]
    assert tt.get_choice("zz") is None and tt.get_choice("mu").kind == "real"
    assert tt.get_f64("mu") is tt.get_real("mu")
    assert tt.get_bool("mu") is None and bool(tt.get_bool("b"))
    assert int(tt.get_int_result("k")) == 2 and float(tt.get_real_result("s")) == 1.3
    assert bool(tt.get_bool_result("b"))
    assert set(tt.values()) == set(jt.values()) and set(tt.latents()) == set(jt.latents())
    for getter in ("get_real_result", "get_bool_result", "get_int_result"):
        for addr in ("zz", "mu" if getter != "get_real_result" else "b"):
            _same_error(lambda: getattr(jt, getter)(addr), lambda: getattr(tt, getter)(addr))
    cp = tt.copy()
    cp.insert_choice("extra", tt.choices["mu"])
    assert "extra" in cp and "extra" not in tt and cp.log_prior is tt.log_prior


# ---------------------------------------------------------------------------
# Scoring handlers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["score_given_trace", "score_given_trace_strict"])
def test_score_given_trace_matches_jax(name):
    jt, tt = _base()
    jr, jtr = getattr(ft, name)(jmodel, jt)
    tr_, ttr = getattr(ftt, name)(tmodel, tt)
    _assert_traces_equal(jtr, ttr)
    np.testing.assert_allclose(_np(tr_), np.asarray(jr), **EXACT)


def test_score_given_trace_safe_on_a_clean_trace_matches_jax():
    jt, tt = _base()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, jtr = ft.score_given_trace_safe(jmodel, jt)
        _, ttr = ftt.score_given_trace_safe(tmodel, tt, device="cpu")
    _assert_traces_equal(jtr, ttr)


def test_reconciled_on_a_clean_trace_matches_jax():
    jt, tt = _base()
    _, jtr, jrep = ft.score_given_trace_reconciled(jax.random.PRNGKey(0), jmodel, jt)
    _, ttr, trep = ftt.score_given_trace_reconciled(0, tmodel, tt, device="cpu")
    _assert_traces_equal(jtr, ttr)
    assert trep.clean and jrep.clean


@pytest.mark.parametrize("case", ["missing", "kind"])
def test_score_given_trace_errors_match_jax(case):
    values = dict(VALUES)
    if case == "missing":
        del values["s"]
        jt, tt = _base_partial(values)
    else:
        jt, tt = _base()
        jt.choices["b"] = ft.Choice(jnp.asarray(0.5), 0.0, jt.choices["b"].support)
        tt.choices["b"] = ftt.Choice(torch.tensor(0.5, dtype=torch.float64), 0.0,
                                     tt.choices["b"].support)
    err = _same_error(lambda: ft.score_given_trace(jmodel, jt),
                      lambda: ftt.score_given_trace(tmodel, tt))
    assert type(err).__name__ == ("TraceAccessError" if case == "missing" else "TypeMismatchError")
    if case == "kind":
        _same_error(lambda: ft.run(ft.ReplayHandler(jax.random.PRNGKey(0), jt), jmodel),
                    lambda: ftt.run(ftt.ReplayHandler(0, tt, device="cpu"), tmodel))


def _base_partial(values):
    """Base traces holding only ``values`` (a partial replay of the model)."""
    _, jt = ft.run(JPartial(jax.random.PRNGKey(0), _jvals(values)), jmodel)
    _, tt = ftt.run(TPartial(0, _tvals(values), device="cpu"), tmodel)
    missing = set(VALUES) - set(values)
    for a in missing:
        del jt.choices[a]
        del tt.choices[a]
    return jt, tt


def test_duplicate_address_matches_jax():
    def jdup():
        ft.sample("a", ft.Normal(0.0, 1.0))
        ft.sample("a", ft.Normal(0.0, 1.0))

    def tdup():
        ftt.sample("a", ftt.Normal(0.0, 1.0))
        ftt.sample("a", ftt.Normal(0.0, 1.0))

    base = {"a": 0.3}
    _, jt = ft.run(JPartial(jax.random.PRNGKey(0), _jvals(base)), lambda: ft.sample("a", ft.Normal(0.0, 1.0)))
    _, tt = ftt.run(TPartial(0, _tvals(base), device="cpu"), lambda: ftt.sample("a", ftt.Normal(0.0, 1.0)))
    err = _same_error(lambda: ft.score_given_trace(jdup, jt), lambda: ftt.score_given_trace(tdup, tt))
    assert type(err).__name__ == "ModelStructureError" and int(err.code) == 301
    _same_error(lambda: ft.run(ft.ReplayHandler(jax.random.PRNGKey(0), jt), jdup),
                lambda: ftt.run(ftt.ReplayHandler(0, tt, device="cpu"), tdup))


def test_strict_fresh_and_vanished_errors_match_jax():
    values = dict(VALUES)
    del values["k"]
    jt, tt = _base_partial(values)
    err = _same_error(lambda: ft.score_given_trace_strict(jmodel, jt),
                      lambda: ftt.score_given_trace_strict(tmodel, tt))
    assert err.context.items == {"address": "k"}
    jt, tt = _base()
    jt.choices["gone"] = jt.choices["mu"]
    tt.choices["gone"] = tt.choices["mu"]
    err = _same_error(lambda: ft.score_given_trace_strict(jmodel, jt),
                      lambda: ftt.score_given_trace_strict(tmodel, tt))
    assert err.context.items == {"vanished": ["gone"]} and int(err.code) == 302


@pytest.mark.parametrize("case", ["missing", "kind", "both"])
def test_safe_score_poisons_and_warns_like_jax(case):
    values = dict(VALUES)
    if case in ("missing", "both"):
        del values["s"]
    jt, tt = _base_partial(values)
    if case in ("kind", "both"):
        jt.choices["b"] = ft.Choice(jnp.asarray(0.5), 0.0, jt.choices["b"].support)
        tt.choices["b"] = ftt.Choice(torch.tensor(0.5, dtype=torch.float64), 0.0,
                                     tt.choices["b"].support)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        _, jtr = ft.score_given_trace_safe(jmodel, jt)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        _, ttr = ftt.score_given_trace_safe(tmodel, tt, device="cpu")
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert len(tw) == (2 if case == "both" else 1)
    assert float(ttr.log_factors) == float(jtr.log_factors) == -np.inf
    assert float(ttr.total_log_weight()) == -np.inf
    fresh = {"missing": ["s"], "kind": ["b"], "both": ["s", "b"]}[case]
    for a in set(VALUES) - set(fresh):
        np.testing.assert_allclose(_np(ttr.choices[a].value), np.asarray(jtr.choices[a].value),
                                   **EXACT)
    quiet = ftt.SafeScoreGivenTrace(tt, warn=False, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, qtr = ftt.run(quiet, tmodel)
    assert float(qtr.log_factors) == -np.inf


def test_safe_replay_resamples_a_kind_mismatch_like_jax():
    jt, tt = _base()
    jt.choices["k"] = ft.Choice(jnp.asarray(2.5), 0.0, jt.choices["k"].support)
    tt.choices["k"] = ftt.Choice(torch.tensor(2.5, dtype=torch.float64), 0.0,
                                 tt.choices["k"].support)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        _, jtr = ft.run(ft.SafeReplayHandler(jax.random.PRNGKey(0), jt), jmodel)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        _, ttr = ftt.run(ftt.SafeReplayHandler(0, tt, device="cpu"), tmodel)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw] and len(tw) == 1
    assert ttr.choices["k"].kind == "int" == jtr.choices["k"].kind
    _assert_fresh(ttr, "k", ftt.Poisson(3.0))
    for a in ("mu", "s", "b"):
        np.testing.assert_allclose(_np(ttr.choices[a].log_prob),
                                   np.asarray(jtr.choices[a].log_prob), **EXACT)


def test_replay_and_partial_values_draw_what_is_missing():
    values = dict(VALUES)
    del values["mu"]
    jt, tt = _base_partial(values)
    for jh, th in ((ft.ReplayHandler(jax.random.PRNGKey(3), jt), ftt.ReplayHandler(3, tt, device="cpu")),
                   (JPartial(jax.random.PRNGKey(3), _jvals(values)),
                    TPartial(3, _tvals(values), device="cpu"))):
        _, jtr = ft.run(jh, jmodel)
        _, ttr = ftt.run(th, tmodel)
        assert list(ttr.choices) == list(jtr.choices)
        _assert_fresh(ttr, "mu", ftt.Normal(0.0, 2.0))
        for a in ("s", "b", "k"):
            np.testing.assert_allclose(_np(ttr.choices[a].log_prob),
                                       np.asarray(jtr.choices[a].log_prob), **EXACT)
        # the likelihood is scored at the port's own draw of mu
        mu = ttr.choices["mu"].value
        want = ftt.Normal(mu + 0.2, torch.tensor(1.3, dtype=torch.float64)).log_prob(
            torch.as_tensor(Y)).sum()
        np.testing.assert_allclose(_np(ttr.log_likelihood), _np(want), **EXACT)
    # with every site given, replay equals scoring
    jt, tt = _base()
    _, jtr = ft.run(ft.ReplayHandler(jax.random.PRNGKey(3), jt), jmodel)
    _, ttr = ftt.run(ftt.ReplayHandler(3, tt, device="cpu"), tmodel)
    _assert_traces_equal(jtr, ttr)


def test_reconciling_births_and_vanishings_match_jax():
    values = dict(VALUES)
    del values["s"]
    jt, tt = _base_partial(values)
    jt.choices["b"] = ft.Choice(jnp.asarray(0.5), 0.0, jt.choices["b"].support)
    tt.choices["b"] = ftt.Choice(torch.tensor(0.5, dtype=torch.float64), 0.0, tt.choices["b"].support)
    for base in (jt, tt):
        base.choices["old"] = base.choices["mu"]
    _, jtr, jrep = ft.score_given_trace_reconciled(jax.random.PRNGKey(1), jmodel, jt)
    _, ttr, trep = ftt.score_given_trace_reconciled(1, tmodel, tt, device="cpu")
    assert (trep.birthed, trep.vanished) == (jrep.birthed, jrep.vanished) == (["s", "b"], ["old"])
    assert not trep.clean
    for a in ("mu", "k"):
        np.testing.assert_allclose(_np(ttr.choices[a].log_prob),
                                   np.asarray(jtr.choices[a].log_prob), **EXACT)
    _assert_fresh(ttr, "s", ftt.LogNormal(0.0, 0.5))


def test_predictive_handler_redraws_observations():
    values = {"mu": 0.7, "s": 1.3, "b": True, "k": 2}
    _, jtr = ft.run(ft.PredictiveHandler(jax.random.PRNGKey(2), _jvals(values)), jmodel)
    _, ttr = ftt.run(ftt.PredictiveHandler(2, _tvals(values), device="cpu"), tmodel)
    assert list(ttr.choices) == list(jtr.choices)
    for a in values:
        np.testing.assert_allclose(_np(ttr.choices[a].log_prob),
                                   np.asarray(jtr.choices[a].log_prob), **EXACT)
    y = ttr.choices["y"]
    assert y.is_observed and y.value.shape == jtr.choices["y"].value.shape == (4,)
    assert not np.allclose(_np(y.value), Y)
    dist = ftt.Normal(torch.tensor(0.7 + 0.2, dtype=torch.float64), torch.tensor(1.3, dtype=torch.float64))
    np.testing.assert_allclose(_np(ttr.log_likelihood), _np(dist.log_prob(y.value).sum()), **EXACT)


def test_predictive_handler_lead_shape_matches_jax():
    """An observation whose data has more dims than the distribution's batch
    shape draws the data's leading dims."""
    def jm():
        m = ft.sample("m", ft.Normal(jnp.zeros(3), 1.0))
        ft.observe("o", ft.Normal(m, 1.0), jnp.zeros((5, 3)))

    def tm():
        m = ftt.sample("m", ftt.Normal(torch.zeros(3, dtype=torch.float64), 1.0))
        ftt.observe("o", ftt.Normal(m, 1.0), torch.zeros((5, 3), dtype=torch.float64))

    _, jtr = ft.run(ft.PredictiveHandler(jax.random.PRNGKey(0), {}), jm)
    _, ttr = ftt.run(ftt.PredictiveHandler(0, {}, device="cpu"), tm)
    assert ttr.choices["o"].value.shape == jtr.choices["o"].value.shape == (5, 3)


# ---------------------------------------------------------------------------
# Staged simulation
# ---------------------------------------------------------------------------


def _sim_pair():
    def jsim():
        mu = ft.sample("mu_p", ft.Normal(0.0, 2.0))
        return ft.sample("xs", ft.Normal(mu, 1.0), sample_shape=(6,))

    def tsim():
        mu = ftt.sample("mu_p", ftt.Normal(0.0, 2.0))
        return ftt.sample("xs", ftt.Normal(mu, 1.0), sample_shape=(6,))

    return ft.stage(jsim), ftt.stage(tsim, device="cpu")


def test_simulate_and_replay_partial_structure_matches_jax():
    js, ts = _sim_pair()
    jd, jl = js.simulate(jax.random.PRNGKey(0))
    td, tl = ts.simulate(0)
    assert set(tl) == set(jl) and td.shape == jd.shape == (6,)
    np.testing.assert_array_equal(_np(td), _np(tl["xs"]))
    jd, jtr = js.replay_partial(jax.random.PRNGKey(1), {"mu_p": jnp.asarray(0.4)})
    td, ttr = ts.replay_partial(1, {"mu_p": torch.tensor(0.4, dtype=torch.float64)})
    assert list(ttr.choices) == list(jtr.choices)
    np.testing.assert_allclose(_np(ttr.choices["mu_p"].log_prob),
                               np.asarray(jtr.choices["mu_p"].log_prob), **EXACT)
    xs = ttr.choices["xs"].value
    np.testing.assert_array_equal(_np(td), _np(xs))
    np.testing.assert_allclose(_np(ttr.choices["xs"].log_prob),
                               _np(ftt.Normal(torch.tensor(0.4, dtype=torch.float64), 1.0).log_prob(xs).sum()),
                               **EXACT)


def test_batched_simulate_is_one_model_run_of_the_single_runs():
    runs = [0]

    def tsim():
        runs[0] += 1
        mu = ftt.sample("mu_p", ftt.Normal(0.0, 2.0))
        return ftt.sample("xs", ftt.Normal(mu, 1.0), sample_shape=(6,))

    ts = ftt.stage(tsim, device="cpu")
    runs[0] = 0
    data, lat = ts.simulate_batch(5, 400)
    assert runs[0] == 1
    assert data.shape == (400, 6) and lat["mu_p"].shape == (400,) and lat["xs"].shape == (400, 6)
    np.testing.assert_array_equal(_np(data), _np(lat["xs"]))
    assert len(set(_np(lat["mu_p"]).tolist())) == 400  # a different draw per row
    m = _np(lat["mu_p"])
    assert abs(m.mean()) < 6 * 2.0 / 20 and abs(m.std() - 2.0) < 0.3
    thetas = torch.linspace(-1.0, 1.0, 7, dtype=torch.float64)
    runs[0] = 0
    data, tr = ts.replay_partial_batch(9, {"mu_p": thetas})
    assert runs[0] == 1 and data.shape == (7, 6)
    np.testing.assert_array_equal(_np(tr.choices["mu_p"].value), _np(thetas))
    np.testing.assert_allclose(_np(tr.choices["mu_p"].log_prob),
                               _np(ftt.Normal(0.0, 2.0).log_prob(thetas)), **EXACT)
    lp_xs = ftt.Normal(thetas[:, None], 1.0).log_prob(data).sum(-1)
    np.testing.assert_allclose(_np(tr.choices["xs"].log_prob), _np(lp_xs), **EXACT)
    np.testing.assert_allclose(_np(tr.log_prior), _np(lp_xs + ftt.Normal(0.0, 2.0).log_prob(thetas)),
                               **EXACT)
    noise = _np(data - thetas[:, None])
    assert len(set(noise[:, 0].tolist())) == 7
    # one shared draw: every row's noise equals the single replay's
    data, _ = ts.replay_partial_batch(9, {"mu_p": thetas}, randomness="same")
    single, _ = ts.replay_partial(9, {"mu_p": thetas[0]})
    np.testing.assert_allclose(_np(data - thetas[:, None]),
                               np.broadcast_to(_np(single - thetas[0]), (7, 6)), **EXACT)
    with pytest.raises(ValueError, match="at least one pinned site"):
        ts.replay_partial_batch(0, {})
