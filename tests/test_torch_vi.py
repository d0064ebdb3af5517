"""Parity of the PyTorch port's variational inference with fugue_tpu, on the CPU.

Float64 throughout. Each family's ``init``, ``log_prob``, ``entropy`` and
``clamp``, and each guide's ``log_q``, entropy, Cholesky factor and
covariance, agree with the JAX package's at the same parameters to 1e-12;
Adam and SGD updates agree with ``optax`` on the same gradients to 1e-12.
The whole drives replay the JAX key schedule through the draws seam
(``JaxDraws``: ``fold_in(key, chunk)`` → ``split(·, check_every)`` →
``split(·, n_samples)`` → ``fold_in(·, group)``, and ``fold_in(·, 17)`` for
the Beta sites' gammas) and match the JAX drive's parameters and ELBO
history to 1e-10: mean-field with Normal and LogNormal sites, the
unconstrained guide (a ``Uniform(0, a)`` site), full-rank, the plateau stop,
the one-chunk case, ``resume=`` from a JAX ``VIResult`` and the 2^12-row
plate through the kernel's plain version. A drive with Beta sites matches to
the gamma gradient's tolerance (see ``BETA_DRIVE``). The conjugate
recoveries of ``tests/test_vi.py`` hold within Monte-Carlo error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from fugue_tpu.inference import vi as jvi
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference import vi as tvi
from fugue_tpu_torch.interop import vi_params_from_numpy

import torch_parity_models as models

EXACT = dict(rtol=1e-12, atol=1e-12)
DRIVE = dict(rtol=1e-10, atol=1e-10)
# torch._standard_gamma_grad and JAX's random_gamma_grad differ by up to
# about 3e-4 relative; over a 40-iteration Adam drive that moves the Beta
# parameters by at most a few 1e-5 (measured: 2e-6)
BETA_DRIVE = dict(rtol=1e-4, atol=1e-4)
YS = np.array([1.2, 0.8, 1.5, 0.9, 1.1])


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_params(tp, jp, tol):
    """Nested param dicts equal leaf by leaf."""
    assert set(tp) == set(jp)
    for k, v in jp.items():
        if isinstance(v, dict):
            _assert_params(tp[k], v, tol)
        else:
            np.testing.assert_allclose(_np(tp[k]), np.asarray(v), **tol)


class JaxDraws:
    """The JAX drive's draws, handed to the port's drive."""

    def __init__(self, key, check_every):
        self.key, self.ce, self.j = key, check_every, 0

    def _kks(self, n):
        c, i = divmod(self.j, self.ce)
        self.j += 1
        k = jax.random.split(jax.random.fold_in(self.key, c), self.ce)[i]
        return jax.random.split(k, n)

    def meanfield(self, n, totals, dtype):
        self.kks = self._kks(n)
        out = {}
        for gi, kind in enumerate(("lognormal", "normal")):
            if kind in totals:
                eps = jax.vmap(lambda kk: jax.random.normal(
                    jax.random.fold_in(kk, gi), (totals[kind],), jnp.float64))(self.kks)
                out[kind] = _t(eps)
        return out

    def gammas(self, a, b):
        def one(kk, aa, bb):
            ka, kb = jax.random.split(jax.random.fold_in(kk, 17))
            return (jax.random.gamma(ka, aa, dtype=jnp.float64),
                    jax.random.gamma(kb, bb, dtype=jnp.float64))

        g1, g2 = jax.vmap(one)(self.kks, jnp.asarray(_np(a)), jnp.asarray(_np(b)))
        return _t(g1), _t(g2)

    def normal(self, n, d, dtype):
        kks = self._kks(n)
        return _t(jax.vmap(lambda kk: jax.random.normal(kk, (d,), jnp.float64))(kks))


def _pair(build):
    """Stage ``build(ft)`` and ``build(ftt)``: the same model in both."""
    return ft.stage(lambda: build(ft, jnp)), ftt.stage(lambda: build(ftt, torch), device="cpu")


def normal_lognormal(p, xp):
    mu = p.sample("mu", p.Normal(0.0, 2.0))
    s = p.sample("s", p.LogNormal(0.0, 0.5))
    w = p.sample("w", p.Normal(xp.zeros(3, dtype=xp.float64), 1.0))
    p.observe("ys", p.Normal(mu + xp.sum(w), s), xp.asarray(YS))


def dependent_bound(p, xp):
    a = p.sample("a", p.LogNormal(0.0, 0.5))
    x = p.sample("x", p.Uniform(0.0, a))
    p.observe("o", p.Normal(x, 0.5), xp.asarray(np.array([0.3, 0.6])))


def beta_sites(p, xp):
    q = p.sample("q", p.Beta(2.0, 3.0))
    u = p.sample("u", p.Uniform(-1.0, 2.0))
    m = p.sample("m", p.Normal(0.0, 1.0))
    p.observe("obs", p.Bernoulli(q), xp.asarray([True] * 12 + [False] * 7))
    p.observe("o", p.Normal(u + m, 1.0), xp.asarray(np.array([0.5, 1.0])))


def normal_model(p, xp):
    mu = p.sample("mu", p.Normal(0.0, 2.0))
    p.observe("ys", p.Normal(mu, 1.0), xp.asarray(YS))


# ---------------------------------------------------------------------------
# Families and guides at the same parameters
# ---------------------------------------------------------------------------


FAMILIES = {
    "normal": (jvi.NormalFamily(), tvi.NormalFamily()),
    "lognormal": (jvi.LogNormalFamily(), tvi.LogNormalFamily()),
    "beta": (jvi.BetaFamily(), tvi.BetaFamily()),
    "interval_beta": (jvi._IntervalBetaFamily(-1.0, 2.0), tvi._IntervalBetaFamily(-1.0, 2.0)),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_matches_jax(name):
    jf, tf = FAMILIES[name]
    rng = np.random.default_rng(0)
    jp, tp = jf.init((3,)), tf.init((3,), device="cpu")
    _assert_params(tp, jp, EXACT)
    names = sorted(jp)
    raw = {k: rng.normal(0.0, 1.5, 3) for k in names}
    x = {"normal": rng.normal(size=3), "lognormal": rng.lognormal(size=3),
         "beta": rng.uniform(0.05, 0.95, 3), "interval_beta": rng.uniform(-0.9, 1.9, 3)}[name]
    jpr = {k: jnp.asarray(v) for k, v in raw.items()}
    tpr = {k: _t(v) for k, v in raw.items()}
    np.testing.assert_allclose(_np(tf.log_prob(tpr, _t(x))), np.asarray(jf.log_prob(jpr, jnp.asarray(x))),
                               **EXACT)
    np.testing.assert_allclose(_np(tf.entropy(tpr)), np.asarray(jf.entropy(jpr)), **EXACT)
    wild = {k: jnp.asarray([-1e7, 0.3, 1e7]) for k in names}
    _assert_params(tf.clamp({k: _t(v) for k, v in wild.items()}), jf.clamp(wild), EXACT)
    g = torch.Generator().manual_seed(0)
    draw = tf.sample(g, tpr, (500, 3))
    assert draw.shape == (500, 3) and bool(torch.isfinite(draw).all())


def test_meanfield_guide_matches_jax():
    js, ts = _pair(beta_sites)
    jg, tg = jvi.MeanFieldGuide(js), tvi.MeanFieldGuide(ts)
    _assert_params(tg.init_params(), jg.init_params(), EXACT)
    rng = np.random.default_rng(1)
    params = {a: {k: rng.normal(0.0, 0.7, np.shape(v)) for k, v in d.items()}
              for a, d in jg.init_params().items()}
    jpar = jax.tree.map(jnp.asarray, params)
    tpar = vi_params_from_numpy(params, device="cpu", dtype=torch.float64)
    lat = {"q": 0.4, "u": 0.2, "m": -0.7}
    np.testing.assert_allclose(
        _np(tg.log_q(tpar, {a: _t(v) for a, v in lat.items()})),
        np.asarray(jg.log_q(jpar, {a: jnp.asarray(v) for a, v in lat.items()})), **EXACT)
    np.testing.assert_allclose(_np(tg.entropy(tpar)), np.asarray(jg.entropy(jpar)), **EXACT)
    _assert_params(tg.clamp(tpar), jg.clamp(jpar), EXACT)
    # one flat tensor backs every parameter, grouped by family kind
    theta = tg.flatten(tpar)
    assert theta.shape == (6,)
    assert tg.unflatten(theta)["q"]["raw_a"].data_ptr() == theta.data_ptr() + 8 * 2


def test_gaussian_guides_match_jax():
    js, ts = _pair(normal_lognormal)
    rng = np.random.default_rng(2)
    jf, tf = jvi.FullRankGuide(js), tvi.FullRankGuide(ts)
    _assert_params(tf.init_params(), jf.init_params(), EXACT)
    params = {"loc": rng.normal(size=5), "raw_tril": rng.normal(0.0, 0.5, 15)}
    jpar = jax.tree.map(jnp.asarray, params)
    tpar = vi_params_from_numpy(params, device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(_np(tf._chol(tpar)), np.asarray(jf._chol(jpar)), **EXACT)
    np.testing.assert_allclose(_np(tf.covariance(tpar)), np.asarray(jf.covariance(jpar)), **EXACT)
    np.testing.assert_allclose(_np(tf.entropy(tpar)), np.asarray(jf.entropy(jpar)), **EXACT)
    _assert_params(tf.clamp({"loc": _t([2e6] * 5), "raw_tril": _t([-2e3] * 15)}),
                   jf.clamp({"loc": jnp.full(5, 2e6), "raw_tril": jnp.full(15, -2e3)}), EXACT)
    ju, tu = jvi.UnconstrainedMeanFieldGuide(js), tvi.UnconstrainedMeanFieldGuide(ts)
    _assert_params(tu.init_params(), ju.init_params(), EXACT)
    params = {"loc": rng.normal(size=5), "raw_scale": rng.normal(size=5)}
    np.testing.assert_allclose(_np(tu.entropy({k: _t(v) for k, v in params.items()})),
                               np.asarray(ju.entropy(jax.tree.map(jnp.asarray, params))), **EXACT)


def test_discrete_latent_raises_guide_error():
    def jm():
        ft.sample("z", ft.Bernoulli(0.5))

    def tm():
        ftt.sample("z", ftt.Bernoulli(0.5))

    ts = ftt.stage(tm, device="cpu")
    for cls in (tvi.MeanFieldGuide, tvi.FullRankGuide, tvi.UnconstrainedMeanFieldGuide):
        with pytest.raises(tvi.GuideError) as te:
            cls(ts)
        assert int(te.value.code) == 700
    with pytest.raises(jvi.GuideError) as je:
        jvi.MeanFieldGuide(ft.stage(jm))
    with pytest.raises(tvi.GuideError) as te:
        tvi.optimize_meanfield_vi(0, staged=ts, config=tvi.VIConfig(n_iterations=2))
    assert te.value.context.items == je.value.context.items == {"discrete": ["z"]}


# ---------------------------------------------------------------------------
# Optimizers against optax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt", ["adam", "sgd_decay", "sgd_constant"])
def test_updates_match_optax(opt):
    cfg = tvi.VIConfig(n_iterations=40, learning_rate=0.07, decay=0.6 if opt == "sgd_decay" else 0.0,
                       optimizer="adam" if opt == "adam" else "sgd")
    t0 = max(cfg.n_iterations / 10.0, 1.0)
    if opt == "adam":
        tx = optax.adam(lambda t: cfg.learning_rate * jnp.power(1.0 + t / t0, -0.6))
    elif opt == "sgd_decay":
        tx = optax.sgd(lambda t: cfg.learning_rate * jnp.power(t + 1.0, -cfg.decay))
    else:
        tx = optax.sgd(cfg.learning_rate)
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=7)
    jp, state = jnp.asarray(p0), None
    state = tx.init(jp)
    tp = _t(p0)
    step = tvi._optimizer(cfg)
    for _ in range(5):
        g = rng.normal(size=7) * rng.lognormal(size=7)
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        tp = step.step(tp, _t(g))
        np.testing.assert_allclose(_np(tp), np.asarray(jp), **EXACT)


# ---------------------------------------------------------------------------
# Whole drives with the JAX draws
# ---------------------------------------------------------------------------


def _drive_pair(build, config, kind="meanfield", seed=0, staged=None, resume=None):
    js, ts = staged or _pair(build)
    key = jax.random.PRNGKey(seed)
    jfn = jvi.optimize_meanfield_vi if kind == "meanfield" else jvi.optimize_fullrank_vi
    tfn = tvi.optimize_meanfield_vi if kind == "meanfield" else tvi.optimize_fullrank_vi
    jr = jfn(key, staged=js, config=config, resume=None if resume is None else resume[0])
    tr = tfn(0, staged=ts, config=config, draws=JaxDraws(key, config.check_every),
             resume=None if resume is None else resume[1])
    return jr, tr


def _assert_drive(jr, tr, tol=DRIVE):
    assert (tr.n_iterations_run, tr.converged) == (jr.n_iterations_run, jr.converged)
    _assert_params(tr.params, jr.params, tol)
    np.testing.assert_allclose(tr.elbo_history, np.asarray(jr.elbo_history), **tol)


@pytest.mark.parametrize("build,kind,guide", [
    (normal_lognormal, "meanfield", "MeanFieldGuide"),
    (dependent_bound, "meanfield", "UnconstrainedMeanFieldGuide"),
    (normal_lognormal, "fullrank", "FullRankGuide"),
], ids=["meanfield", "unconstrained", "fullrank"])
def test_drive_matches_jax(build, kind, guide):
    cfg = tvi.VIConfig(n_iterations=45, n_samples=4, check_every=15, plateau_window=10**9)
    jr, tr = _drive_pair(build, cfg, kind)
    assert type(tr.guide).__name__ == type(jr.guide).__name__ == guide
    _assert_drive(jr, tr)
    assert len(tr.elbo_history) == 45


def test_beta_drive_matches_jax_to_the_gamma_gradient():
    cfg = tvi.VIConfig(n_iterations=40, n_samples=4, check_every=20, plateau_window=10**9)
    jr, tr = _drive_pair(beta_sites, cfg)
    _assert_drive(jr, tr, BETA_DRIVE)
    # the step taken (not just the state): parameters moved from the init
    assert float(tr.params["q"]["raw_a"]) > 0.5


@pytest.mark.parametrize("optimizer,decay", [("sgd", 0.6), ("sgd", 0.0)])
def test_sgd_drive_matches_jax(optimizer, decay):
    cfg = tvi.VIConfig(n_iterations=30, n_samples=4, check_every=10, plateau_window=10**9,
                       optimizer=optimizer, decay=decay, learning_rate=0.01)
    _assert_drive(*_drive_pair(normal_lognormal, cfg))


def test_plateau_stop_at_the_same_chunk_as_jax():
    cfg = tvi.VIConfig(n_iterations=400, n_samples=8, learning_rate=0.1, plateau_window=10,
                       plateau_tol=2e-2, check_every=10)
    jr, tr = _drive_pair(normal_model, cfg)
    assert jr.converged and jr.n_iterations_run < 400
    _assert_drive(jr, tr)


def test_one_chunk_when_iterations_are_below_check_every():
    cfg = tvi.VIConfig(n_iterations=7, n_samples=4, check_every=12, plateau_window=3)
    jr, tr = _drive_pair(normal_model, cfg)
    assert tr.n_iterations_run == jr.n_iterations_run == 12
    _assert_drive(jr, tr)


@pytest.mark.parametrize("kind", ["meanfield", "fullrank"])
def test_resume_from_a_jax_result(kind):
    cfg = tvi.VIConfig(n_iterations=20, n_samples=4, check_every=10, plateau_window=10**9)
    pair = _pair(normal_lognormal)
    jfn = jvi.optimize_meanfield_vi if kind == "meanfield" else jvi.optimize_fullrank_vi
    j1 = jfn(jax.random.PRNGKey(5), staged=pair[0], config=cfg)
    leaves = jax.tree.map(np.asarray, j1.params)
    for resume in (j1, vi_params_from_numpy(leaves, device="cpu", dtype=torch.float64)):
        jr, tr = _drive_pair(None, cfg, kind, seed=6, staged=pair, resume=(j1, resume))
        _assert_drive(jr, tr)


def test_plate_drive_gradient_through_the_plain_kernel():
    js, ts = models.plate_pair(1 << 12)
    cfg = tvi.VIConfig(n_iterations=30, n_samples=8, check_every=15, plateau_window=10**9)
    jr, tr = _drive_pair(None, cfg, staged=(js, ts))
    _assert_drive(jr, tr)
    # and one gradient of the loss at the same params, directly
    guide = tr.guide
    theta = guide.flatten(jr.params).requires_grad_(True)
    draws = JaxDraws(jax.random.PRNGKey(8), 1)
    lat = guide._sample_flat(theta, draws, 8)
    loss = -(torch.mean(torch.func.vmap(ts.log_joint)(lat)) + guide._entropy_flat(theta))
    (g,) = torch.autograd.grad(loss, theta)

    jg = jvi.MeanFieldGuide(js)
    k = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(8), 0), 1)[0]
    jgrad = jax.grad(lambda p: -jvi.elbo_analytic_entropy(k, jg, p, 8))(jr.params)
    np.testing.assert_allclose(_np(g), _np(guide.flatten(jax.tree.map(np.asarray, jgrad))), **DRIVE)


# ---------------------------------------------------------------------------
# Whole runs within Monte-Carlo error
# ---------------------------------------------------------------------------


def test_normal_posterior_recovery_and_estimate_elbo():
    ts = ftt.stage(lambda: normal_model(ftt, torch), device="cpu")
    res = tvi.optimize_meanfield_vi(0, staged=ts, config=tvi.VIConfig(
        n_iterations=1500, n_samples=32, learning_rate=0.05))
    tau = 0.25 + 5.0
    loc = float(res.params["mu"]["loc"])
    scale = float(tvi._softplus(res.params["mu"]["raw_scale"]))
    assert loc == pytest.approx(YS.sum() / tau, abs=0.05)
    assert scale == pytest.approx(1 / np.sqrt(tau), rel=0.2)
    assert res.final_elbo() > -20
    e0 = tvi.estimate_elbo(6, staged=ts, n_samples=256)
    je0 = jvi.estimate_elbo(jax.random.PRNGKey(6), n_samples=256,
                            staged=ft.stage(lambda: normal_model(ft, jnp)))
    assert np.isfinite(e0) and res.final_elbo() > e0
    assert e0 == pytest.approx(je0, rel=0.1)


def test_elbo_at_the_posterior_is_the_log_evidence():
    import scipy.stats as st

    ts = ftt.stage(lambda: normal_model(ftt, torch), device="cpu")
    guide = tvi.MeanFieldGuide(ts)
    tau = 0.25 + 5.0
    params = {"mu": {"loc": _t(YS.sum() / tau), "raw_scale": _t(np.log(np.expm1(1 / np.sqrt(tau))))}}
    exact = st.multivariate_normal(np.zeros(5), np.eye(5) + 4.0).logpdf(YS)
    assert float(tvi.elbo(8, guide, params, 8192)) == pytest.approx(exact, abs=0.02)
    assert float(tvi.elbo_analytic_entropy(8, guide, params, 8192)) == pytest.approx(exact, abs=0.02)


def test_beta_guide_conjugate_and_posterior_sample():
    def tm():
        p = ftt.sample("p", ftt.Beta(2.0, 3.0))
        ftt.observe("obs", ftt.Bernoulli(p), torch.tensor([True] * 12 + [False] * 7))

    res = tvi.optimize_meanfield_vi(1, tm, tvi.VIConfig(n_iterations=1500, n_samples=64,
                                                        learning_rate=0.05), device="cpu")
    a, b = float(torch.exp(res.params["p"]["raw_a"])), float(torch.exp(res.params["p"]["raw_b"]))
    assert a / (a + b) == pytest.approx(14 / 24, abs=0.03)
    draws = res.posterior_sample(2, 4000)["p"]
    assert draws.shape == (4000,)
    assert float(draws.mean()) == pytest.approx(14 / 24, abs=0.03)
    assert float(draws.var()) == pytest.approx(14 * 10 / (24**2 * 25), rel=0.5)


def test_fullrank_captures_correlation():
    rho = 0.9

    def tm():
        x = ftt.sample("x", ftt.Normal(0.0, 1.0))
        ftt.sample("y", ftt.Normal(rho * x, float(np.sqrt(1 - rho**2))))

    res = tvi.optimize_fullrank_vi(0, tm, tvi.VIConfig(n_iterations=1000, n_samples=16,
                                                       learning_rate=0.05), device="cpu")
    cov = _np(res.guide.covariance(res.params))
    assert cov[0, 0] == pytest.approx(1.0, rel=0.15) and cov[1, 1] == pytest.approx(1.0, rel=0.15)
    assert cov[0, 1] == pytest.approx(rho, rel=0.15)
    draws = res.posterior_sample(1, 4000)
    corr = np.corrcoef(_np(draws["x"]), _np(draws["y"]))[0, 1]
    assert corr == pytest.approx(rho, abs=0.06)


def test_fullrank_transforms_positive_site():
    def tm():
        lam = ftt.sample("lam", ftt.Gamma(2.0, 1.0))
        ftt.observe("ks", ftt.Poisson(lam), torch.tensor([3, 2, 2]))

    res = tvi.optimize_fullrank_vi(2, tm, tvi.VIConfig(n_iterations=1000, n_samples=16),
                                   device="cpu")
    draws = res.posterior_sample(3, 4000)["lam"]
    assert float(draws.min()) > 0
    assert float(draws.mean()) == pytest.approx(9 / 4, rel=0.1)
