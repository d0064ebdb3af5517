"""The PyTorch port's 24 distributions against fugue_tpu's, on the CPU.

- ``log_prob`` and its gradient in the value (continuous) and in every
  parameter, batched with ``vmap`` over a grid that includes points outside
  the support, equal to JAX within 1e-12 (relative or absolute) in float64;
  -inf exactly where JAX has it. The same with Python-number parameters,
  which take the port's scalar branches.
- The same support and the same ``ErrorCode`` for invalid parameters.
- Sampling: each sampler draws its 5,000 values inside
  ``StagedModel.sample_prior_batch`` (one model run under
  ``vmap(randomness="different")``), held to scipy by a KS test
  (continuous) or a chi-square test (discrete) at alpha = 0.001, as
  ``tests/test_distributions_gof.py`` holds the JAX package; and outside
  ``vmap`` by its mean within 5 standard errors.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch
from torch.func import grad, vmap

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from fugue_tpu_torch import settings

TOL = dict(rtol=1e-12, atol=1e-12)
N = 5000
ALPHA = 1e-3


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def _pos(r, n, s=0.7):
    return np.exp(r.normal(0.0, s, n))


def _ints(r, lo, hi, n):
    return r.integers(lo, hi + 1, n).astype(np.float64)


def _spec(name, n=48):
    """(constructor name, per-element parameter arrays, values, value kind).
    Kind "real" values are differentiated; "int" and "bool" are not."""
    r = np.random.default_rng(sum(map(ord, name)))
    if name == "Normal":
        return name, [r.normal(0, 2, n), _pos(r, n)], r.normal(0, 3, n), "real"
    if name == "Uniform":
        lo = r.normal(0, 1, n)
        return name, [lo, lo + _pos(r, n)], r.uniform(-2.5, 3.5, n), "real"
    if name == "LogNormal":
        return name, [r.normal(0, 1, n), _pos(r, n)], r.normal(1, 1.5, n), "real"
    if name == "Exponential":
        return name, [_pos(r, n)], r.normal(1, 1.5, n), "real"
    if name == "Beta":
        return name, [_pos(r, n), _pos(r, n)], r.uniform(-0.2, 1.2, n), "real"
    if name == "Gamma":
        return name, [_pos(r, n), _pos(r, n)], r.normal(1.5, 1.5, n), "real"
    if name == "StudentT":
        return name, [_pos(r, n) * 3, r.normal(0, 1, n), _pos(r, n)], r.normal(0, 3, n), "real"
    if name in ("Cauchy", "Laplace"):
        return name, [r.normal(0, 1, n), _pos(r, n)], r.normal(0, 3, n), "real"
    if name in ("Weibull", "InverseGamma"):
        return name, [_pos(r, n), _pos(r, n)], r.normal(1.5, 1.5, n), "real"
    if name == "ChiSquared":
        return name, [_pos(r, n) * 3], r.normal(2, 2, n), "real"
    if name in ("HalfNormal", "HalfCauchy"):
        return name, [_pos(r, n)], r.normal(1, 1.5, n), "real"
    if name == "Bernoulli":
        p = r.uniform(0, 1, n)
        p[:3] = [0.0, 1.0, 0.5]
        return name, [p], r.uniform(size=n) < 0.5, "bool"
    if name == "BernoulliLogits":
        return name, [r.normal(0, 3, n)], r.uniform(size=n) < 0.5, "bool"
    if name in ("Categorical", "Categorical_logits"):
        probs = r.dirichlet(np.ones(4), n)
        param = probs if name == "Categorical" else np.log(probs) + r.normal(0, 1, (n, 1))
        return name, [param], _ints(r, -1, 4, n), "int"
    if name == "Binomial":
        p = r.uniform(0, 1, n)
        p[:2] = [0.0, 1.0]
        return name, [_ints(r, 0, 10, n), p], _ints(r, -1, 12, n), "int"
    if name == "Poisson":
        return name, [_pos(r, n) * 3], _ints(r, -1, 10, n), "int"
    if name == "Geometric":
        return name, [r.uniform(0.05, 0.95, n)], _ints(r, -1, 8, n), "int"
    if name == "NegativeBinomial":
        return name, [_pos(r, n) * 2, r.uniform(0.05, 0.95, n)], _ints(r, -1, 12, n), "int"
    if name == "DiscreteUniform":
        lo = _ints(r, -3, 3, n)
        return name, [lo, lo + _ints(r, 0, 5, n)], _ints(r, -5, 9, n), "int"
    if name == "Dirichlet":
        conc = _pos(r, (n, 3))
        x = r.dirichlet(np.ones(3), n)
        x[:4] = [[-0.1, 0.6, 0.5], [0.2, 0.2, 0.2], [0.0, 0.5, 0.5], [1.0, 0.0, 0.0]]
        return name, [conc], x, "real"
    if name in ("MultivariateNormal", "MultivariateNormal_cov"):
        a = r.normal(0, 0.5, (n, 3, 3))
        tril = np.tril(a, -1) + np.eye(3)[None] * _pos(r, (n, 1, 1), 0.3)
        param = tril if name == "MultivariateNormal" else tril @ np.swapaxes(tril, -1, -2)
        return name, [r.normal(0, 1, (n, 3)), param], r.normal(0, 2, (n, 3)), "real"
    raise KeyError(name)


def _ctor(pkg, name):
    if name == "Categorical":
        return lambda p: pkg.Categorical(probs=p)
    if name == "Categorical_logits":
        return lambda p: pkg.Categorical(logits=p)
    if name == "MultivariateNormal":
        return lambda loc, l: pkg.MultivariateNormal(loc, scale_tril=l)
    if name == "MultivariateNormal_cov":
        return lambda loc, c: pkg.MultivariateNormal(loc, covariance=c)
    return getattr(pkg, name)


ALL_NAMES = [c.__name__ for c in ft.core.distributions.ALL_DISTRIBUTIONS
             + ft.core.distributions.EXTRA_DISTRIBUTIONS
             + ft.core.distributions.MULTIVARIATE_DISTRIBUTIONS]
GRID_NAMES = ALL_NAMES + ["Categorical_logits", "MultivariateNormal_cov"]


def test_every_jax_distribution_has_a_port_counterpart():
    assert len(ALL_NAMES) == 24
    for name in ALL_NAMES:
        assert getattr(ftt, name).__name__ == name
    assert [c.__name__ for c in ftt.ALL_DISTRIBUTIONS] == \
        [c.__name__ for c in ft.ALL_DISTRIBUTIONS]
    assert [c.__name__ for c in ftt.EXTRA_DISTRIBUTIONS] == \
        [c.__name__ for c in ft.EXTRA_DISTRIBUTIONS]


def _jax_value(v, kind):
    return jnp.asarray(v, bool) if kind == "bool" else jnp.asarray(v)


def _torch_value(v, kind):
    return torch.as_tensor(v, dtype=torch.bool) if kind == "bool" else torch.as_tensor(v)


@pytest.mark.parametrize("name", GRID_NAMES)
def test_log_prob_and_gradient_match_jax(name):
    _, params, values, kind = _spec(name)
    jd, td = _ctor(ft, name), _ctor(ftt, name)
    n_p = len(params)
    argnums = tuple(range(n_p + (kind == "real")))

    def jlp(*a):
        return jd(*a[:-1]).log_prob(a[-1])

    def tlp(*a):
        return td(*a[:-1]).log_prob(a[-1])

    jargs = [jnp.asarray(p) for p in params] + [_jax_value(values, kind)]
    targs = [torch.as_tensor(p) for p in params] + [_torch_value(values, kind)]
    want = np.asarray(jax.vmap(jlp)(*jargs))
    got = vmap(tlp)(*targs)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.array_equal(np.isneginf(got.numpy()), np.isneginf(want))
    assert np.isneginf(want).any() or name in ("Normal", "StudentT", "Cauchy", "Laplace",
                                               "BernoulliLogits", "MultivariateNormal",
                                               "MultivariateNormal_cov")
    jg = jax.vmap(jax.grad(jlp, argnums=argnums))(*jargs)
    tg = vmap(grad(tlp, argnums=argnums))(*targs)
    for i, (a, b) in enumerate(zip(tg, jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"argument {i}", **TOL)


# one element of each grid with Python-number parameters: the port keeps
# them as floats (math.lgamma, the cached log-beta), JAX as weak scalars
SCALAR_NAMES = [n for n in ALL_NAMES if n not in ("Categorical", "Dirichlet",
                                                  "MultivariateNormal")]


@pytest.mark.parametrize("name", SCALAR_NAMES)
def test_python_number_parameters_match_jax(name):
    _, params, values, kind = _spec(name)
    for i in range(6):
        args = [float(p[i]) for p in params]
        if name in ("Binomial", "DiscreteUniform"):
            args = [int(a) if j == 0 or name == "DiscreteUniform" else a
                    for j, a in enumerate(args)]
        want = np.asarray(getattr(ft, name)(*args).log_prob(_jax_value(values, kind)))
        got = getattr(ftt, name)(*args).log_prob(_torch_value(values, kind))
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def _support(s):
    return (s.kind, s.low, s.high, s.size)


SUPPORT_CASES = {
    "Normal": (0.0, 1.0), "Uniform": (-1.0, 2.5), "LogNormal": (0.0, 1.0),
    "Exponential": (2.0,), "Bernoulli": (0.3,), "Categorical": (None, [0.2, 0.3, 0.5]),
    "Beta": (2.0, 3.0), "Gamma": (2.0, 1.0), "Binomial": (7, 0.4), "Poisson": (3.0,),
    "StudentT": (4.0,), "Cauchy": (0.0, 1.0), "Laplace": (0.0, 1.0), "Weibull": (1.5, 1.0),
    "ChiSquared": (3.0,), "InverseGamma": (2.0, 1.0), "DiscreteUniform": (-2, 5),
    "HalfNormal": (1.0,), "HalfCauchy": (1.0,), "Geometric": (0.3,),
    "NegativeBinomial": (3.0, 0.4), "BernoulliLogits": (0.2,), "Dirichlet": ([1.0, 2.0, 3.0],),
    "MultivariateNormal": ([0.0, 0.0], [[1.0, 0.3], [0.3, 2.0]]),
}


@pytest.mark.parametrize("name", ALL_NAMES)
def test_support_and_dtype_match_jax(name):
    args = [np.asarray(a) if isinstance(a, list) else a for a in SUPPORT_CASES[name]]
    jd, td = getattr(ft, name)(*args), getattr(ftt, name)(*args)
    assert _support(td.support) == _support(jd.support)
    want = {jnp.dtype(bool): torch.bool, jnp.dtype(jnp.int64): torch.int64,
            jnp.dtype(jnp.float64): torch.float64}[jnp.dtype(jd.dtype)]
    assert td.dtype == want
    draw = td.sample(torch.Generator().manual_seed(0), (3,))
    assert draw.dtype == want and draw.shape == tuple(
        np.shape(jd.sample(jax.random.PRNGKey(0), (3,))))


def _bad(pkg):
    """Invalid constructions: each raises the same code in both packages."""
    return {
        "normal_nan_mean": lambda: pkg.Normal(np.nan, 1.0),
        "normal_zero_sd": lambda: pkg.Normal(0.0, 0.0),
        "uniform_reversed": lambda: pkg.Uniform(2.0, 1.0),
        "uniform_inf": lambda: pkg.Uniform(0.0, np.inf),
        "lognormal_sd": lambda: pkg.LogNormal(0.0, -1.0),
        "exponential_rate": lambda: pkg.Exponential(0.0),
        "beta_alpha": lambda: pkg.Beta(-1.0, 1.0),
        "beta_beta": lambda: pkg.Beta(1.0, 0.0),
        "gamma_shape": lambda: pkg.Gamma(-1.0, 1.0),
        "gamma_rate": lambda: pkg.Gamma(1.0, 0.0),
        "studentt_df": lambda: pkg.StudentT(0.0),
        "studentt_scale": lambda: pkg.StudentT(3.0, 0.0, -2.0),
        "cauchy_loc": lambda: pkg.Cauchy(np.inf, 1.0),
        "laplace_scale": lambda: pkg.Laplace(0.0, 0.0),
        "weibull_shape": lambda: pkg.Weibull(0.0, 1.0),
        "chisq_df": lambda: pkg.ChiSquared(-1.0),
        "invgamma_scale": lambda: pkg.InverseGamma(1.0, -1.0),
        "halfnormal_scale": lambda: pkg.HalfNormal(0.0),
        "halfcauchy_scale": lambda: pkg.HalfCauchy(-1.0),
        "bernoulli_p": lambda: pkg.Bernoulli(1.5),
        "bernoulli_logits": lambda: pkg.BernoulliLogits(np.inf),
        "categorical_sum": lambda: pkg.Categorical(probs=np.array([0.5, 0.6])),
        "categorical_neither": lambda: pkg.Categorical(),
        "categorical_both": lambda: pkg.Categorical(probs=np.array([0.5, 0.5]),
                                                    logits=np.zeros(2)),
        "categorical_negative": lambda: pkg.Categorical(probs=np.array([-0.5, 1.5])),
        "binomial_n": lambda: pkg.Binomial(-3, 0.5),
        "binomial_fraction": lambda: pkg.Binomial(2.5, 0.5),
        "binomial_p": lambda: pkg.Binomial(3, 1.2),
        "poisson_rate": lambda: pkg.Poisson(-1.0),
        "geometric_zero": lambda: pkg.Geometric(0.0),
        "negbinomial_count": lambda: pkg.NegativeBinomial(0.0, 0.5),
        "negbinomial_p": lambda: pkg.NegativeBinomial(2.0, -0.1),
        "discrete_uniform": lambda: pkg.DiscreteUniform(5, 2),
        "dirichlet_size": lambda: pkg.Dirichlet(np.array([1.0])),
        "dirichlet_negative": lambda: pkg.Dirichlet(np.array([1.0, -1.0])),
        "mvn_neither": lambda: pkg.MultivariateNormal(np.zeros(2)),
        "mvn_asymmetric": lambda: pkg.MultivariateNormal(np.zeros(2), np.array([[1.0, 0.5], [0.0, 1.0]])),
        "mvn_not_pd": lambda: pkg.MultivariateNormal(np.zeros(2), np.array([[1.0, 2.0], [2.0, 1.0]])),
        "mvn_tril_diag": lambda: pkg.MultivariateNormal(np.zeros(2),
                                                        scale_tril=np.array([[1.0, 0.0], [0.5, 0.0]])),
        "mvn_not_square": lambda: pkg.MultivariateNormal(np.zeros(2), np.array([[1.0, 0.0]])),
    }


@pytest.mark.parametrize("case", sorted(_bad(ft)))
def test_invalid_parameters_raise_the_jax_code(case):
    with pytest.raises(ft.FugueError) as je:
        _bad(ft)[case]()
    with pytest.raises(ftt.ValidationError) as te:
        _bad(ftt)[case]()
    assert int(te.value.code) == int(je.value.code)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

CONTINUOUS = {
    "Normal": ((1.5, 2.0), st.norm(1.5, 2.0)),
    "Uniform": ((-2.0, 3.0), st.uniform(-2.0, 5.0)),
    "LogNormal": ((0.5, 0.75), st.lognorm(0.75, scale=np.exp(0.5))),
    "Exponential": ((2.5,), st.expon(scale=1 / 2.5)),
    "Beta": ((2.0, 5.0), st.beta(2.0, 5.0)),
    "Gamma": ((3.0, 2.0), st.gamma(3.0, scale=1 / 2.0)),
    "StudentT": ((5.0, 1.0, 2.0), st.t(5.0, loc=1.0, scale=2.0)),
    "Cauchy": ((0.5, 1.5), st.cauchy(0.5, 1.5)),
    "Laplace": ((-1.0, 2.0), st.laplace(-1.0, 2.0)),
    "Weibull": ((1.8, 2.2), st.weibull_min(1.8, scale=2.2)),
    "ChiSquared": ((4.0,), st.chi2(4.0)),
    "InverseGamma": ((3.0, 2.0), st.invgamma(3.0, scale=2.0)),
    "HalfNormal": ((1.7,), st.halfnorm(scale=1.7)),
    "HalfCauchy": ((0.8,), st.halfcauchy(scale=0.8)),
}
DISCRETE = {
    "Bernoulli": ((0.3,), st.bernoulli(0.3)),
    "BernoulliLogits": ((-0.8,), st.bernoulli(1 / (1 + math.exp(0.8)))),
    "Categorical": (([0.1, 0.2, 0.3, 0.4],), st.rv_discrete(values=([0, 1, 2, 3],
                                                                     [0.1, 0.2, 0.3, 0.4]))),
    "Binomial": ((20, 0.35), st.binom(20, 0.35)),
    "Poisson": ((4.5,), st.poisson(4.5)),
    "DiscreteUniform": ((-3, 6), st.randint(-3, 7)),
    "Geometric": ((0.35,), st.nbinom(1, 0.35)),
    "NegativeBinomial": ((6.0, 0.4), st.nbinom(6, 0.4)),
}


def _make(name, args):
    if name == "Categorical":
        return ftt.Categorical(probs=torch.tensor(args[0], dtype=torch.float64))
    return getattr(ftt, name)(*args)


def _prior_batch(name, args, n=N, seed=11):
    """n draws of one site in ONE batched model run."""
    def model():
        ftt.sample("x", _make(name, args))

    return ftt.stage(model, device="cpu").sample_prior_batch(seed, n)["x"]


def _chi2_pvalue(xs, ref):
    lo, hi = int(xs.min()), int(xs.max())
    support = np.arange(lo, hi + 1)
    expected = ref.pmf(support) * xs.size
    obs = np.array([(xs == k).sum() for k in support], dtype=float)
    keep = expected >= 5
    o, e = obs[keep], expected[keep]
    o_tail, e_tail = obs[~keep].sum(), expected[~keep].sum() + max(0.0, xs.size - expected.sum())
    if e_tail > 0.5:
        o, e = np.append(o, o_tail), np.append(e, e_tail)
    e = e * (o.sum() / e.sum())
    return 1 - st.chi2.cdf(((o - e) ** 2 / e).sum(), len(o) - 1)


@pytest.mark.parametrize("name", sorted(CONTINUOUS) + sorted(DISCRETE))
def test_sampler_in_prior_batch_fits_scipy(name):
    args, ref = {**CONTINUOUS, **DISCRETE}[name]
    xs = _prior_batch(name, args)
    assert xs.shape == (N,) and xs.dtype == _make(name, args).dtype
    if name in CONTINUOUS:
        p = st.kstest(xs.numpy(), ref.cdf).pvalue
    else:
        p = _chi2_pvalue(xs.numpy().astype(np.int64), ref)
    assert p > ALPHA, f"{name}: p = {p:.2e}"
    assert len(torch.unique(_prior_batch(name, args, n=64, seed=12))) > 1


@pytest.mark.parametrize("name", sorted(n for n in {**CONTINUOUS, **DISCRETE}
                                        if n not in ("Cauchy", "HalfCauchy")))
def test_sample_mean_within_5_sigma(name):
    args, ref = {**CONTINUOUS, **DISCRETE}[name]
    g = torch.Generator().manual_seed(ftt.address_seed(name) % (1 << 62))
    xs = _make(name, args).sample(g, (N,)).double().numpy()
    mean, var = (float(m) for m in ref.stats(moments="mv"))
    assert abs(xs.mean() - mean) < 5 * math.sqrt(var / N), (xs.mean(), mean)


def test_multivariate_samplers_in_prior_batch():
    conc = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    cov = torch.tensor([[1.0, 0.6], [0.6, 2.0]], dtype=torch.float64)
    loc = torch.tensor([0.5, -1.0], dtype=torch.float64)

    def model():
        ftt.sample("d", ftt.Dirichlet(conc))
        ftt.sample("m", ftt.MultivariateNormal(loc, covariance=cov))

    lat = ftt.stage(model, device="cpu").sample_prior_batch(3, 20000)
    d, m = lat["d"].numpy(), lat["m"].numpy()
    assert d.shape == (20000, 3) and m.shape == (20000, 2)
    np.testing.assert_allclose(d.sum(-1), 1.0, atol=1e-12)
    a0 = conc.sum().item()
    mean_d = conc.numpy() / a0
    sd_d = np.sqrt(mean_d * (1 - mean_d) / (a0 + 1))
    assert np.all(np.abs(d.mean(0) - mean_d) < 5 * sd_d / math.sqrt(20000))
    assert np.all(np.abs(m.mean(0) - loc.numpy()) < 5 * np.sqrt(np.diag(cov.numpy()) / 20000))
    np.testing.assert_allclose(np.cov(m.T), cov.numpy(), atol=0.06)


def test_infallible_shortcuts():
    x = torch.tensor(0.3, dtype=torch.float64)
    assert ftt.Normal.standard().log_prob(torch.tensor(0.0)).item() == pytest.approx(
        -0.5 * math.log(2 * math.pi))
    assert ftt.Uniform.unit().log_prob(x).item() == 0.0
    assert ftt.Beta.uniform_prior().log_prob(x).item() == pytest.approx(0.0, abs=1e-15)
    assert ftt.Categorical.uniform(4).log_prob(torch.tensor(2)).item() == pytest.approx(
        math.log(0.25))
