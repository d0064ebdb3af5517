"""The DSL compiler of the PyTorch port against the JAX package's, on the CPU.

Each program compiles in both packages from the same source and data and
stages; the site tables (address, support, shape) and observed addresses
must be equal, and the log joint at the JAX prior draws, the potential and
its gradient at the same unconstrained points (discrete sites pinned to the
same values) and the model's return value agree to 1e-10 in float64. Also:
the same ``DSLError`` for bad sources, the soft-error degrade, clamped
indices and the concrete-index error under ``vmap``.

Intended divergence (ROADMAP §C): a soft runtime error is warned once per
message until ``take_warnings()`` drains it. The JAX package warns once per
eager run (its jit cache replays without Python); the port replays the
model in Python on every batched evaluation, so it keeps one copy.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from fugue_tpu.dsl import compiler as jc
from fugue_tpu_torch import settings
from fugue_tpu_torch.dsl import compiler as tc

TOL = dict(rtol=1e-10, atol=1e-10)

COIN = """
let p <- sample("p", beta(2.0, 3.0));
for i in 0..n {
    observe(("y", i), bernoulli(p), ys[i]);
}
return p
"""

EIGHT_SCHOOLS = """
let mu <- sample("mu", normal(0.0, 5.0));
let tau <- sample("tau", lognormal(0.5, 1.0));
for j in 0..8 {
    let theta_raw <- sample(("theta_raw", j), normal(0.0, 1.0));
    observe(("y", j), normal(mu + tau * theta_raw, sigma[j]), y[j]);
}
return mu
"""

EXPRESSIONS = """
let mu <- sample("mu", normal(0.0, 2.0));
let shifted = mu * 2.0 + 1.0;
observe("y", normal(shifted, exp(0.0)), data[0]);
factor(-0.5);
return shifted
"""

BUILTINS = """
let mu <- sample("mu", normal(0.0, 2.0));
let s <- sample("s", lognormal(0.0, 0.5));
let a = log(s) + sqrt(s) + abs(mu) + pow(s, 2.0);
let b = min(mu, 1.0) + max(mu, -1.0) + logaddexp(mu, 0.0) + (mu > 0.0) * 0.5;
let c = sum(xs) / len(xs) + mean(xs) - xs[-1.0];
factor(-0.1 * a * a + b * 0.01 + c * 0.001);
for i in 0..len(xs) {
    observe(("x", i), normal(mu % 3.0 + s, s), xs[i]);
}
return a + b + c
"""

EXTRAS = """
let tau <- sample("tau", halfcauchy(2.0));
let h <- sample("h", halfnormal(1.5));
let r <- sample("r", gamma(2.0, 1.0));
let u <- sample("u", uniform(-1.0, 2.0));
observe("y", normal(0.0, tau), data[0]);
observe("e", exponential(r), data[1]);
observe("st", studentt(3.0, u, h), data[2]);
observe("ca", cauchy(u, tau), data[3]);
observe("la", laplace(u, h), data[4]);
observe("we", weibull(r, h), data[1]);
observe("cs", chisquared(r), data[1]);
observe("ig", inversegamma(r, h), data[1]);
observe("g", geometric(0.3), counts[0]);
observe("nb", negativebinomial(3.0, 0.4), counts[1]);
observe("bi", binomial(10.0, 0.3), counts[2]);
observe("po", poisson(r), counts[2]);
observe("du", discreteuniform(0.0, 5.0), counts[1]);
observe("w", bernoulli_logits(h * 2.0 - 1.0), flags[0]);
return tau
"""

CATEGORICAL = """
let z <- sample("z", categorical(probs));
let mu <- sample("mu", normal(0.0, 1.0));
observe("y", normal(mu + centers[z], 1.0), 0.5);
return z
"""

INT_MEAN = """
let lam <- sample("lam", gamma(2.0, 1.0));
let m = mean(counts);
for i in 0..len(counts) {
    observe(("c", i), poisson(lam * m), counts[i]);
}
return m
"""

PROGRAMS = {
    "coin": (COIN, {"n": 19, "ys": [1] * 12 + [0] * 7}),
    "eight_schools": (EIGHT_SCHOOLS, {
        "y": [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0],
        "sigma": [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]}),
    "expressions": (EXPRESSIONS, {"data": [3.0]}),
    "builtins": (BUILTINS, {"xs": [0.3, -1.2, 2.5, 0.8]}),
    "extras": (EXTRAS, {"data": [1.2, 0.7, -0.4, 2.2, 0.1], "counts": [3, 2, 4],
                        "flags": [1]}),
    "categorical": (CATEGORICAL, {"probs": [0.2, 0.5, 0.3], "centers": [-2.0, 0.0, 3.0]}),
    "int_mean": (INT_MEAN, {"counts": [3, 0, 5, 2, 4]}),
}


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def both(src, data):
    """(JAX compiled, JAX staged, port compiled, port staged)."""
    jcm, tcm = jc.compile_model(src), tc.compile_model(src)
    return (jcm, ft.stage(jcm.build(data)), tcm,
            ftt.stage(tcm.build(data, device="cpu"), device="cpu"))


def to_torch(latents):
    return {a: torch.as_tensor(np.array(v)) for a, v in latents.items()}


def site_table(staged):
    return [(s.address, s.support.kind, s.support.low, s.support.high, s.support.size,
             tuple(s.shape)) for s in staged.sites]


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_matches_jax(name):
    src, data = PROGRAMS[name]
    jcm, js, tcm, ts = both(src, data)
    assert site_table(ts) == site_table(js)
    assert ts.observed_addresses == js.observed_addresses
    assert ts.dim == js.dim
    rng = np.random.default_rng(7)
    discrete = [s.address for s in js.sites if not s.is_continuous]
    for k in range(3):
        lat = {a: np.asarray(v) for a, v in js.sample_prior(jax.random.PRNGKey(k)).items()}
        np.testing.assert_allclose(float(ts.log_joint(to_torch(lat))),
                                   float(js.log_joint(lat)), **TOL)
        j_ret, _ = js.replay(lat)
        t_ret, _ = ts.replay(to_torch(lat))
        np.testing.assert_allclose(np.asarray(t_ret, np.float64),
                                   np.asarray(j_ret, np.float64), **TOL)
        disc = {a: lat[a] for a in discrete}
        z = rng.normal(size=js.dim)
        jv, jg = jax.value_and_grad(lambda q: js.potential(q, disc))(jnp.asarray(z))
        tz, tdisc = torch.as_tensor(z), to_torch(disc)
        np.testing.assert_allclose(float(ts.potential(tz, tdisc)), float(jv), **TOL)
        np.testing.assert_allclose(grad(lambda q: ts.potential(q, tdisc))(tz).numpy(),
                                   np.asarray(jg), **TOL)
    assert tcm.take_warnings() == jcm.take_warnings() == []


def test_data_placement_and_dtypes():
    """Float data in the real dtype, int data in the int dtype, bool data as
    bool, numbers as they are; ``mean`` of int data is real."""
    data = {"f": [1.0, 2.0], "i": [1, 2], "b": [True, False], "n": 3}

    def returned(expr):
        cm = tc.compile_model(f'let p <- sample("p", beta(2.0, 2.0)); return {expr}')
        return ftt.run(ftt.PriorHandler(0, "cpu"), cm.build(data, device="cpu"))[0]

    assert returned("f").dtype == torch.float64 and returned("i").dtype == torch.int64
    assert returned("b").dtype == torch.bool and returned("n") == 3
    assert returned("mean(i)").dtype == torch.float64 and float(returned("mean(i)")) == 1.5
    settings.enable_x64(False)
    assert returned("f").dtype == torch.float32 and returned("i").dtype == torch.int32
    assert returned("exp(0.0)").dtype == torch.float32


@pytest.mark.parametrize("src", [
    "let x <- sample(42, normal(0,1));",
    'let x <- sample("x", nosuchdist(1.0));',
    "observe(",
    "let = 3;",
    'let x <- sample("x", normal(0.0, 1.0)) $',
    'observe(("y", 1), normal(0.0, 1.0) 2.0)',
])
def test_parse_errors_match_jax(src):
    with pytest.raises(jc.DSLError) as je:
        jc.compile_model(src)
    with pytest.raises(tc.DSLError) as te:
        tc.compile_model(src)
    assert str(te.value) == str(je.value)
    assert te.value.code.name == je.value.code.name


def test_soft_runtime_error_degrades_and_warns_once():
    """Unbound identifier at run time → factor(-inf) and a warning, kept
    once until drained (the JAX package keeps one per run)."""
    src = 'let mu <- sample("mu", normal(0.0, 1.0));'
    jcm, tcm = jc.compile_model(src), tc.compile_model(src)
    jcm.stmts.append(jc.Factor(jc.Var("missing")))
    tcm.stmts.append(tc.Factor(tc.Var("missing")))
    jm, tm = jcm.build({}), tcm.build({}, device="cpu")
    for k in range(3):
        _, jt = ft.run(ft.PriorHandler(jax.random.PRNGKey(k)), jm)
        _, tt = ftt.run(ftt.PriorHandler(k, "cpu"), tm)
        assert float(jt.total_log_weight()) == float(tt.total_log_weight()) == -math.inf
    jw, tw = jcm.take_warnings(), tcm.take_warnings()
    assert len(jw) == 3 and len(set(jw)) == 1  # the reference: one per run
    assert tw == jw[:1] and "missing" in tw[0]
    assert tcm.take_warnings() == []
    ftt.run(ftt.PriorHandler(9, "cpu"), tm)
    assert tcm.take_warnings() == tw  # warned again after the drain


def test_index_is_clamped_as_in_jax():
    """Out-of-range and negative indices, literal and sampled (a categorical
    site over 4 categories indexing 3 centers), clamp as JAX clamps them."""
    src = """
let z <- sample("z", categorical(probs));
let mu <- sample("mu", normal(0.0, 1.0));
observe("y", normal(mu + centers[z] + centers[7.0] - centers[-1.0] + centers[-9.0], 1.0), 0.5);
return z
"""
    data = {"probs": [0.25, 0.25, 0.25, 0.25], "centers": [-2.0, 0.5, 3.0]}
    jcm, js, tcm, ts = both(src, data)
    z = np.array([0, 1, 2, 3, 3, 0])
    mu = np.linspace(-1.0, 1.0, z.size)
    jl = jax.vmap(js.log_joint)({"z": jnp.asarray(z), "mu": jnp.asarray(mu)})
    tl = vmap(ts.log_joint)({"z": torch.as_tensor(z), "mu": torch.as_tensor(mu)})
    assert np.isfinite(np.asarray(jl)).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tcm.take_warnings() == jcm.take_warnings() == []


def test_concrete_index_error_under_vmap():
    """A sampled value as an address index: concrete in the discovery run,
    batched under vmap, where both packages degrade to -inf with the same
    warning."""
    src = """
let k <- sample("k", categorical(probs));
observe(("y", k), normal(0.0, 1.0), 0.5);
return k
"""
    jcm, js, tcm, ts = both(src, {"probs": [0.5, 0.5]})
    assert len(ts.observed_addresses) == len(js.observed_addresses) == 1
    k = np.array([0, 1, 1])
    jl = jax.vmap(js.log_joint)({"k": jnp.asarray(k)})
    tl = vmap(ts.log_joint)({"k": torch.as_tensor(k)})
    assert np.all(np.asarray(jl) == -np.inf) and torch.all(tl == -math.inf)
    jw, tw = jcm.take_warnings(), tcm.take_warnings()
    assert tw == jw[:1]
    assert tw == ["runtime error: [NOT_STAGEABLE(700)] address index must be a "
                  "concrete integer"]
