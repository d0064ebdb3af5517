"""The Gaussian-plate likelihood kernel of the PyTorch port, on the CPU.

On the CPU the wrapper runs its plain PyTorch version; that version is held
against fugue_tpu's ``pnormal_loglik_sum`` run as tests/test_pallas_kernels.py
runs it (Pallas forced on, in TPU interpret mode), in float64 at
N = 2*8192 + 100 (a ragged tail past two 8192-element tiles), relative
tolerance 1e-9. The CUDA kernel itself runs only on a card: its test is
marked ``gpu`` and skips here. What can be checked here is its arithmetic:
a float64 numpy mirror of the kernel (its layout, per-thread batches, Chan
merges in the kernel's order, shift and epilogue) is held against the
per-row plain version to 1e-12 relative, on the cases where moments lose
digits, and on non-finite rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from fugue_tpu.ops import pallas_kernels as pk
from fugue_tpu_torch import settings
from fugue_tpu_torch.ops import _build
from fugue_tpu_torch.ops import kernels as K

N = 2 * 8192 + 100
PARAMS = [(1.5, 2.0), (0.3, 0.7), (-2.0, 5.0)]


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


@pytest.fixture
def pallas_interpret():
    from jax.experimental.pallas import tpu as pltpu

    pk.enable_pallas(True)
    try:
        with pltpu.force_tpu_interpret_mode():
            yield
    finally:
        pk.enable_pallas(None)


def _y(n=N, seed=5):
    return np.random.default_rng(seed).normal(1.5, 2.0, n)


@pytest.mark.parametrize("mu, sigma", PARAMS)
def test_plain_version_matches_pallas_interpret(pallas_interpret, mu, sigma):
    y = _y()
    jv, (jdy, jdmu, jds) = jax.value_and_grad(pk.pnormal_loglik_sum, argnums=(0, 1, 2))(
        jnp.asarray(y), jnp.asarray(mu), jnp.asarray(sigma)
    )
    yt = torch.tensor(y, requires_grad=True)
    mt = torch.tensor(mu, dtype=torch.float64, requires_grad=True)
    st = torch.tensor(sigma, dtype=torch.float64, requires_grad=True)
    out = K.pnormal_loglik_sum(yt, mt, st)
    out.backward()
    np.testing.assert_allclose(out.item(), float(jv), rtol=1e-9)
    np.testing.assert_allclose(mt.grad.item(), float(jdmu), rtol=1e-9)
    np.testing.assert_allclose(st.grad.item(), float(jds), rtol=1e-9)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(jdy), rtol=1e-9, atol=1e-12)


def test_batched_form_equals_unbatched_calls():
    """C=5 chains in one call equal five scalar calls (1e-12 relative)."""
    y = torch.as_tensor(_y())
    rng = np.random.default_rng(6)
    mu = torch.as_tensor(rng.normal(1.5, 0.3, 5))
    sigma = torch.as_tensor(np.exp(rng.normal(0.7, 0.2, 5)))
    out = K.pnormal_loglik_sum(y, mu, sigma)
    dmu, dsig = K.pnormal_loglik_sum_grad(y, mu, sigma)
    assert out.shape == dmu.shape == dsig.shape == (5,)
    for c in range(5):
        np.testing.assert_allclose(
            out[c].item(), K.pnormal_loglik_sum(y, mu[c], sigma[c]).item(), rtol=1e-12)
        gm, gs = K.pnormal_loglik_sum_grad(y, mu[c], sigma[c])
        np.testing.assert_allclose(dmu[c].item(), gm.item(), rtol=1e-12)
        np.testing.assert_allclose(dsig[c].item(), gs.item(), rtol=1e-12)


def test_vmap_grad_and_value_enters_once_per_batch(monkeypatch):
    """vmap(grad_and_value(U)) over 7 chains makes one fused value-and-grad
    call, on the whole batch, and matches per-chain calls."""
    calls = []
    plain = K.normal_loglik_sum_value_and_grad_ref

    def count(y, mu, sigma):
        calls.append(tuple(mu.shape))
        return plain(y, mu, sigma)

    monkeypatch.setattr(K, "normal_loglik_sum_value_and_grad_ref", count)
    y = torch.as_tensor(_y())

    def potential(q):
        return -K.pnormal_loglik_sum(y, q[0], torch.exp(q[1]))

    q = torch.as_tensor(np.random.default_rng(7).normal([1.5, 0.7], 0.1, (7, 2)))
    g, v = vmap(grad_and_value(potential))(q)
    assert calls == [(7,)]
    for c in range(7):
        qc = q[c].clone().requires_grad_(True)
        u = potential(qc)
        (gc,) = torch.autograd.grad(u, qc)
        np.testing.assert_allclose(v[c].item(), u.item(), rtol=1e-12)
        np.testing.assert_allclose(g[c].numpy(), gc.numpy(), rtol=1e-12)


def test_scalar_params_and_broadcast():
    y = torch.as_tensor(_y(1000))
    a = K.pnormal_loglik_sum(y, 1.5, torch.tensor([2.0, 3.0], dtype=torch.float64))
    b = K.normal_loglik_sum_value_and_grad_ref(
        y, torch.tensor([1.5, 1.5], dtype=torch.float64),
        torch.tensor([2.0, 3.0], dtype=torch.float64))[0]
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)
    two_d = K.pnormal_loglik_sum(y.reshape(10, 100), 1.5, 2.0)
    np.testing.assert_allclose(two_d.item(), a[0].item(), rtol=1e-12)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    y = torch.zeros(10, dtype=torch.float64)
    with pytest.raises(TypeError):
        K.pnormal_loglik_sum(y, torch.tensor(0.0, dtype=torch.float32), 1.0)
    with pytest.raises(ValueError):
        K.pnormal_loglik_sum(y.to("meta"), 0.0, 1.0)
    f32 = torch.zeros(10, dtype=torch.float32)
    with pytest.raises(TypeError):
        K._check_launch(y, f32[:1], f32[:1])
    with pytest.raises(ValueError):
        K._check_launch(y, y[::2], y[::2])  # not contiguous
    with pytest.raises(ValueError):
        K._check_launch(y, y[:2], y[:3])
    with pytest.raises(TypeError):
        K._check_launch(y.to(torch.int64), y[:1], y[:1])


@pytest.mark.parametrize("n, offset", [(1, 1), (100, 3), (N, 2), (1 << 24, 1), ((1 << 20) + 17, 3)])
def test_block_partition_covers_every_row(n, offset):
    """The plate kernel's layout: scalar head up to the first 16-byte
    boundary, whole vectors, a ragged scalar tail; every tile goes to one
    block, and the grid is at most two blocks per SM."""
    for itemsize in (4, 8):
        w = 16 // itemsize
        off = offset % w
        head, n_vec, nb = K._plate_partition(n, off, itemsize, n_sms=132)
        tail = n - head - n_vec * w
        assert 0 <= head < w and 0 <= tail < w
        assert head == n or (off + head) % w == 0
        n_tiles = -(-n_vec // (K._THREADS * K._LOADS))
        assert 1 <= nb <= 2 * 132 and (nb <= n_tiles or n_tiles == 0)


# ---------------------------------------------------------------------------
# A float64 numpy mirror of the kernel's arithmetic: its layout, per-thread
# batches, Chan merges in the kernel's fixed order, and its epilogue
# ---------------------------------------------------------------------------

_NAN, _POS, _NEG = 1, 2, 4


def _merge(a, b):
    """Chan's merge of moments b into a, elementwise: (count, mean, M2, flags)."""
    (an, am, aq, af), (bn, bm, bq, bf) = a, b
    n = an + bn
    with np.errstate(invalid="ignore", divide="ignore"):
        d = bm - am
        w = bn / n
        q = aq + bq + d * d * an * w
        m = am + d * w
    m = np.where(bn == 0, am, np.where(an == 0, bm, m))
    q = np.where(bn == 0, aq, np.where(an == 0, bq, q))
    return n, m, q, af | bf


def _no_rows(shape):
    return np.zeros(shape), np.zeros(shape), np.zeros(shape), np.zeros(shape, np.int64)


def _batch(x, valid, shift):
    """Each last-axis row of x as one thread's batch: moments of its finite
    valid entries (two passes) and the flags of its non-finite ones."""
    f = np.where(valid, np.where(np.isnan(x), _NAN, np.where(x == np.inf, _POS,
                                                             np.where(x == -np.inf, _NEG, 0))), 0)
    keep = valid & (f == 0)
    d = np.where(keep, x - shift, 0.0)
    cnt = keep.sum(-1)
    mean = d.sum(-1) / np.maximum(cnt, 1)
    e = np.where(keep, d - mean[..., None], 0.0)
    return cnt.astype(np.float64), mean, (e * e).sum(-1), np.bitwise_or.reduce(f, axis=-1)


def _tree(s):
    """The shuffle tree over the last axis (32 lanes): lane l takes lane
    l + o for o = 16, ..., 1; the result is lane 0's."""
    s = tuple(a.copy() for a in s)
    o = 16
    while o:
        merged = _merge(tuple(a[..., :o] for a in s), tuple(a[..., o:2 * o] for a in s))
        for a, v in zip(s, merged):
            a[..., :o] = v
        o //= 2
    return tuple(a[..., 0] for a in s)


def _block(s):
    """block_merge over the last axis (the block's threads)."""
    warps = K._THREADS // 32
    per_warp = _tree(tuple(a.reshape(*a.shape[:-1], warps, 32) for a in s))
    lanes = tuple(np.concatenate([a, np.zeros((*a.shape[:-1], 32 - warps), a.dtype)], -1)
                  for a in per_warp)
    return _tree(lanes)


def _merge_into(acc, rows, first):
    """acc[:k] = merge(acc[:k], rows[first:first + k]): one step of a
    strided loop over ``rows``."""
    k = min(acc[0].shape[0], rows[0].shape[0] - first)
    merged = _merge(tuple(a[:k] for a in acc), tuple(r[first:first + k] for r in rows))
    for a, v in zip(acc, merged):
        a[:k] = v


def _pick_shift(y):
    vals = [v for v in (y[0], y[y.size // 2], y[-1]) if np.isfinite(v)] if y.size else []
    if len(vals) == 3:
        a, b, c = vals
        return max(min(a, b), min(max(a, b), c))
    return vals[0] if vals else 0.0


def _kernel_mirror(y, mu, sigma, offset, itemsize, n_sms=132):
    """(value, dmu, dsigma) as normal_loglik_sum.cu computes them, in float64."""
    n, w, t, loads = y.size, 16 // itemsize, K._THREADS, K._LOADS
    head, n_vec, nb = K._plate_partition(n, offset, itemsize, n_sms)
    shift = _pick_shift(y)
    with np.errstate(invalid="ignore"):
        state = _no_rows((nb, t))  # (block, thread)
        edge = np.concatenate([y[:head], y[head + n_vec * w:]])[None]
        for a, v in zip(state, _batch(edge, np.ones(edge.shape, bool), shift)):
            a[0, 0] = v[0]  # block 0, thread 0 starts with the head and tail rows
        n_tiles = -(-n_vec // (t * loads))
        body = np.zeros(n_tiles * t * loads * w)
        body[:n_vec * w] = y[head:head + n_vec * w]

        def per_thread(a):  # (tile, load, thread, lane) -> (tile, thread, batch)
            return a.reshape(n_tiles, loads, t, w).transpose(0, 2, 1, 3).reshape(n_tiles, t, loads * w)

        batches = _batch(per_thread(body), per_thread(np.arange(body.size) < n_vec * w), shift)
        for first in range(0, n_tiles, nb):  # tile i goes to block i % nb
            _merge_into(state, batches, first)
        parts = _block(state)
        acc = _no_rows(t)  # finish: thread j takes partials j, j + t, ...
        for first in range(0, nb, t):
            _merge_into(acc, parts, first)
        m, mean, m2, flags = (a[()] for a in _block(acc))
    with np.errstate(all="ignore"):
        s1, s2 = np.zeros_like(mu), np.zeros_like(mu)
        if m > 0:
            d = (shift - mu) + mean
            s1 = m * d
            s2 = m2 + s1 * d
        for bit, inf in ((_POS, np.inf), (_NEG, -np.inf)):
            if flags & bit:
                e = inf - mu
                s1, s2 = s1 + e, s2 + e * e
        if flags & _NAN:
            s1 = s2 = np.full_like(mu, np.nan)
        q = s2 / (sigma * sigma)
        return (-0.5 * q - n * (np.log(sigma) + 0.5 * np.log(2 * np.pi)),
                (s1 / sigma) / sigma, q / sigma - n / sigma)


def _plain(y, mu, sigma):
    return [t.numpy() for t in K.normal_loglik_sum_value_and_grad_ref(
        *(torch.as_tensor(a) for a in (y, mu, sigma)))]


def _mirror_case(name):
    """(y, mu, sigma, offset, itemsize): data far from 0, a first row that
    is a 1e3-sigma outlier, mu 1e3 away from ybar, one row, and 2^20 + 17
    rows (offsets in elements past a 16-byte boundary)."""
    rng = np.random.default_rng(11)
    if name == "one_row":
        return np.array([0.7]), np.array([0.2, 1.9, -3.0]), np.array([1.0, 0.5, 2.0]), 1, 4
    if name == "far_from_zero":
        y = 1e4 + rng.normal(0.0, 1.0, 3 * 8192 + 5)
        return y, y.mean() + np.array([-0.5, 0.05, 1.3]), np.array([0.8, 1.0, 1.7]), 0, 8
    y = rng.normal(1.5, 2.0, (1 << 20) + 17 if name == "large" else 3 * 8192 + 5)
    if name == "outlier_first":
        y[0] = 1.5 + 1e3 * 2.0
        return y, y.mean() + np.array([-0.3, 0.004, 0.7]), np.array([1.5, 2.0, 3.0]), 3, 4
    if name == "mu_far":
        return y, y.mean() + np.array([1e3, -1e3, 1.5e3]), np.array([2.0, 5.0, 50.0]), 1, 8
    return y, y.mean() + np.array([-0.05, 0.01, 0.2]), np.array([1.9, 2.0, 2.2]), 1, 8


@pytest.mark.parametrize("case", ["far_from_zero", "outlier_first", "mu_far", "one_row", "large"])
def test_kernel_mirror_matches_plain_version(case):
    """The kernel's moments and epilogue, mirrored in float64 numpy, agree
    with the per-row plain version to 1e-12 relative: the shift, the
    batches and Chan's merges keep the digits a per-row sum keeps."""
    y, mu, sigma, offset, itemsize = _mirror_case(case)
    got = _kernel_mirror(y, mu, sigma, offset, itemsize)
    for g, p in zip(got, _plain(y, mu, sigma)):
        np.testing.assert_allclose(g, p, rtol=1e-12, atol=0)


@pytest.mark.parametrize("special", ["nan", "pos_inf", "neg_inf", "both_inf"])
def test_kernel_mirror_special_values_match_plain_version(special):
    """Non-finite rows: the mirror's flags give the plain version's NaN and
    +-inf pattern, for finite chains and for chains with mu = +-inf or NaN,
    sigma = inf, -1 or NaN."""
    y = np.random.default_rng(3).normal(1.5, 2.0, 5000)
    at = {"nan": {17: np.nan}, "pos_inf": {17: np.inf, 4000: np.inf},
          "neg_inf": {123: -np.inf}, "both_inf": {17: np.inf, 4000: -np.inf}}[special]
    for i, v in at.items():
        y[i] = v
    mu = np.array([1.4, np.inf, -np.inf, np.nan, 1.4, 1.4, 1.4])
    sigma = np.array([2.0, 2.0, 2.0, 2.0, np.inf, -1.0, np.nan])
    for offset in (0, 1):
        got = _kernel_mirror(y, mu, sigma, offset, 8)
        for g, p in zip(got, _plain(y, mu, sigma)):
            np.testing.assert_array_equal(np.isnan(g), np.isnan(p))
            np.testing.assert_allclose(g, p, rtol=1e-12, atol=0)  # infs: equal


@pytest.mark.parametrize("how", ["create_graph", "hessian"])
def test_second_derivative_raises(how):
    """The saved gradients are constants to autograd: a second derivative
    must raise, not come out zero."""
    y = torch.as_tensor(_y(100))
    mu = torch.tensor(1.4, dtype=torch.float64, requires_grad=True)
    sigma = torch.tensor(2.0, dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        if how == "create_graph":
            (g,) = torch.autograd.grad(K.pnormal_loglik_sum(y, mu, sigma) + mu * mu, mu,
                                       create_graph=True)
            torch.autograd.grad(g, mu)
        else:
            torch.func.hessian(lambda m: K.pnormal_loglik_sum(y, m, sigma))(mu.detach())


def test_library_name_carries_the_source_hash():
    h = _build.source_hash("normal_loglik_sum")
    assert len(h) == 16 and h == _build.source_hash("normal_loglik_sum")
    path = _build.library_path("normal_loglik_sum")
    assert path.name == f"libnormal_loglik_sum_{h}.so"
    assert path.parent == _build.BUILD_DIR
    assert (_build.CSRC / "normal_loglik_sum.cu").is_file()


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """On a card: one value-and-grad call launches (and counts) once and
    agrees with the plain float64 version to 1e-12 relative, from an
    aligned y and from y[1:]; the float32 kernel is no further from float64
    than the plain float32 version (or one float32 eps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    n = (1 << 20) + 17
    y = 1.5 + 2.0 * torch.randn(n, generator=g, device="cuda", dtype=torch.float64)
    mu = 1.5 + 0.01 * torch.randn(3, generator=g, device="cuda", dtype=torch.float64)
    sigma = torch.full((3,), 2.0, device="cuda", dtype=torch.float64)
    for yy in (y, y[1:]):
        before = K.LAUNCHES["nll"]
        got = K.pnormal_loglik_sum_value_and_grad(yy, mu, sigma)
        torch.cuda.synchronize()
        assert K.LAUNCHES["nll"] == before + 1
        for k, p in zip(got, K.normal_loglik_sum_value_and_grad_ref(yy, mu, sigma)):
            torch.testing.assert_close(k, p, rtol=1e-12, atol=1e-9)
    y32, mu32, s32 = y.float(), mu.float(), sigma.float()
    refs = K.normal_loglik_sum_value_and_grad_ref(y32.double(), mu32.double(), s32.double())
    plains = K.normal_loglik_sum_value_and_grad_ref(y32, mu32, s32)
    eps = torch.finfo(torch.float32).eps
    for k, p, r in zip(K.pnormal_loglik_sum_value_and_grad(y32, mu32, s32), plains, refs):
        k_err, p_err = (k.double() - r).abs(), (p.double() - r).abs()
        assert bool((k_err <= torch.maximum(p_err, eps * r.abs())).all())
