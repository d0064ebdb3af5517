"""The SMC kernels' algorithms, mirrored in numpy float64, on the CPU.

The CUDA kernels (``csrc/logsumexp.cu``, ``csrc/systematic_resample.cu``,
both over ``csrc/lse_reduce.cuh``) run only on a card. What can be checked
here is their arithmetic, in the kernels' own order:

- the log-sum-exp mirror (the grid of ``kernels._lse_partition``, per-thread
  batches of ``kLoads`` vectors, the block merge with its butterfly warp
  sums, the parts folded in block order) against the plain version and
  JAX's ``logsumexp_xla`` in float64: relative 1e-12 on finite inputs, the
  same NaN/+inf/-inf on special values;
- the resampling mirror (its own lse from the same parts, fixed-point q's,
  per-tile totals and exclusive integer offsets, counts against the
  nominal total 2^60, each element's slots [c_{j-1}, c_j)) against the
  exact float64 reference under chip_smoke's float32 contract at 2^17
  (max ancestor deviation <= max(4, 2 x the plain float32 version's), under
  2% of slots differ), against JAX's ``systematic_resample_xla`` with the
  same u0 in float64 (deviation <= 1 on under 0.1% of slots), and against
  the plain version on degenerate weights;
- the launch grids: every element read once, every tile taken once.
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fugue_tpu.ops import pallas_kernels as pk
from fugue_tpu_torch.ops import _build
from fugue_tpu_torch.ops import kernels as K

N_SMS = 132  # an H100's SMs: the grids below are the card's
LOADS = 2  # kLoads in csrc/lse_reduce.cuh
TILE = K._RESAMPLE_TILE
FIXED_ONE = 2.0**60
INF = math.inf


def test_mirror_constants_match_the_sources():
    cuh = (_build.CSRC / "lse_reduce.cuh").read_text()
    res = (_build.CSRC / "systematic_resample.cu").read_text()
    lse = (_build.CSRC / "logsumexp.cu").read_text()
    assert re.search(r"constexpr int kLoads = (\d+);", cuh).group(1) == str(LOADS)
    for src in (res, lse):
        assert re.search(r"constexpr int kThreads = (\d+);", src).group(1) == str(K._THREADS)
    per = int(re.search(r"constexpr int kPer = (\d+);", res).group(1))
    assert K._THREADS * per == TILE


# ---------------------------------------------------------------------------
# log-sum-exp: the reduction of csrc/lse_reduce.cuh
# ---------------------------------------------------------------------------


def _butterfly_lane0(v):
    """Lane 0's value of a warp's xor-shuffle sum, v (..., 32)."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    return v[..., 0]


def _fold_batch(m, s, nan, v, valid):
    """acc_batch for every thread at once: v, valid (threads, K)."""
    nan = nan | np.any(valid & np.isnan(v), axis=1)
    bm = np.max(np.where(valid & ~np.isnan(v), v, -INF), axis=1)
    rise = bm > m
    s = np.where(rise, s * np.exp(m - bm), s)
    m = np.where(rise, bm, m)
    fin = np.isfinite(m)
    for k in range(v.shape[1]):
        use = valid[:, k] & (v[:, k] < INF) & fin
        s = s + np.where(use, np.exp(np.where(use, v[:, k] - m, 0.0)), 0.0)
    return m, s, nan


def _fold_part(m, s, nan, pm, ps, pn):
    """acc_part for every thread at once."""
    nan = nan | pn
    rise = pm > m
    add = ~rise & np.isfinite(m) & (pm > -INF)
    s_rise = s * np.exp(np.where(rise, m - pm, 0.0)) + ps
    s_add = s + ps * np.exp(np.where(add, pm - m, 0.0))
    s = np.where(rise, s_rise, np.where(add, s_add, s))
    m = np.where(rise, pm, m)
    return m, s, nan


def _block_all(m, s, nan):
    """block_all over blocks of K._THREADS threads: m, s, nan (blocks, threads)."""
    bm = np.max(m, axis=1)
    bn = np.any(nan, axis=1)
    use = np.isfinite(bm)[:, None] & (m > -INF)
    sr = np.where(use, s * np.exp(np.where(use, m - bm[:, None], 0.0)), 0.0)
    warp = _butterfly_lane0(sr.reshape(m.shape[0], -1, 32))
    tot = np.zeros(m.shape[0])
    for w in range(warp.shape[1]):
        tot = tot + warp[:, w]
    return bm, tot, bn


def _lse_of(m, s, nan):
    if nan:
        return math.nan
    if not math.isfinite(m):
        return m
    return m + math.log(s)


def _lse_parts(x, offset=0):
    """The parts of the reduction's grid over x (numpy, float32 or float64)
    starting ``offset`` elements past a 16-byte boundary, and the grid."""
    n, w, T = x.size, 16 // x.itemsize, K._THREADS
    head, n_vec, nb = K._lse_partition(n, offset, x.itemsize, N_SMS)
    S = nb * T
    xd = x.astype(np.float64)
    body = xd[head:head + n_vec * w].reshape(n_vec, w) if n_vec else np.zeros((0, w))
    m, s, nan = np.full(S, -INF), np.zeros(S), np.zeros(S, bool)
    g = np.arange(S)
    with np.errstate(all="ignore"):
        for base in range(0, n_vec, S * LOADS):
            idx = base + g[:, None] + np.arange(LOADS)[None, :] * S  # (S, LOADS) vectors
            valid = idx < n_vec
            v = body[np.where(valid, idx, 0)].reshape(S, LOADS * w)
            m, s, nan = _fold_batch(m, s, nan, v, np.repeat(valid, w, axis=1))
        # thread 0: the scalars before the first boundary and after the last vector
        scal = np.zeros((S, 2 * w))
        sv = np.zeros((S, 2 * w), bool)
        tail = xd[head + n_vec * w:]
        scal[0, :head], sv[0, :head] = xd[:head], True
        scal[0, w:w + tail.size], sv[0, w:w + tail.size] = tail, True
        m, s, nan = _fold_batch(m, s, nan, scal, sv)
        return _block_all(m.reshape(nb, T), s.reshape(nb, T), nan.reshape(nb, T)), nb


def _merge_parts(parts):
    """lse_finish (and each resampling emit block): thread t folds parts
    t, t + T, ... in order, then block_all."""
    pm, ps, pn = parts
    T = K._THREADS
    m, s, nan = np.full(T, -INF), np.zeros(T), np.zeros(T, bool)
    with np.errstate(all="ignore"):
        for base in range(0, pm.size, T):
            j = base + np.arange(T)
            ok = j < pm.size
            jj = np.where(ok, j, 0)
            m, s, nan = _fold_part(m, s, nan, np.where(ok, pm[jj], -INF),
                                   np.where(ok, ps[jj], 0.0), ok & pn[jj])
        bm, bs, bn = _block_all(m[None], s[None], nan[None])
    return float(bm[0]), float(bs[0]), bool(bn[0])


def lse_mirror(x, offset=0):
    parts, _ = _lse_parts(x, offset)
    return _lse_of(*_merge_parts(parts))


def _lse_case(kind, n, dtype):
    rng = np.random.default_rng(n)
    if kind == "normal_x10":
        x = rng.normal(size=n) * 10
    elif kind == "near_+1e4":
        x = 1e4 + rng.normal(size=n)
    elif kind == "near_-1e4":
        x = -1e4 + rng.normal(size=n)
    else:  # one_outlier
        x = rng.normal(size=n)
        x[n // 2] = 50.0
    return x.astype(dtype)


@pytest.mark.parametrize("kind", ["normal_x10", "near_+1e4", "near_-1e4", "one_outlier"])
@pytest.mark.parametrize("n, offset", [(131072, 0), (131073, 1), (3 * 8192 + 17, 3), (5, 1)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lse_mirror_matches_plain_and_jax(kind, n, offset, dtype):
    x = _lse_case(kind, n, dtype)
    x64 = x.astype(np.float64)
    got = lse_mirror(x, offset % (16 // x.itemsize))
    plain = K.logsumexp_ref(torch.as_tensor(x64)).item()
    jax_ = float(pk.logsumexp_xla(jnp.asarray(x64)))
    assert got == pytest.approx(plain, rel=1e-12, abs=1e-12)
    assert got == pytest.approx(jax_, rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("case, want", [
    ({}, -INF),  # all -inf
    ({7: 3.0}, 3.0),  # one finite
    ({7: 3.0, 9000: INF}, INF),
    ({7: 3.0, 9000: math.nan}, math.nan),
    ({7: INF, 9000: math.nan}, math.nan),
    ({0: INF}, INF),  # in the scalar head of an unaligned start
])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lse_mirror_special_values(case, want, dtype):
    x = np.full(20001, -INF, dtype=dtype)
    for i, v in case.items():
        x[i] = v
    for offset in (0, 1):
        got = lse_mirror(x, offset)
        plain = K.logsumexp_ref(torch.as_tensor(x.astype(np.float64))).item()
        if math.isnan(want):
            assert math.isnan(got) and math.isnan(plain)
        else:
            assert got == want == plain


@pytest.mark.parametrize("n, offset", [(1, 0), (3, 1), (100, 3), (131072, 0), (131072 + 5, 2),
                                       ((1 << 20) + 17, 1), (1 << 24, 3)])
def test_lse_partition_reads_every_element_once(n, offset):
    """The reduction's layout: scalar head up to the first 16-byte boundary,
    vectors g, g + S, ... in batches of kLoads, a scalar tail; every
    element is read once, the grid is at most two blocks per SM and has at
    least one vector per thread where it can."""
    for itemsize in (4, 8):
        w = 16 // itemsize
        off = offset % w
        head, n_vec, nb = K._lse_partition(n, off, itemsize, N_SMS)
        assert head == n or (off + head) % w == 0
        assert 1 <= nb <= 2 * N_SMS and (nb == 1 or n_vec >= (nb - 1) * K._THREADS)
        seen = np.zeros(n, np.int8)
        S = nb * K._THREADS
        for base in range(0, n_vec, S * LOADS):
            for k in range(LOADS):
                v = base + k * S + np.arange(S)
                v = v[v < n_vec]
                for j in range(w):
                    np.add.at(seen, head + v * w + j, 1)
        seen[:head] += 1
        seen[head + n_vec * w:] += 1
        assert n - head - n_vec * w < w and bool((seen == 1).all())


# ---------------------------------------------------------------------------
# systematic resampling: csrc/systematic_resample.cu
# ---------------------------------------------------------------------------


def _comb(prefix, n, u0):
    """comb_count: clamp(floor(P * (n 2^-60) - u0) + 1, 0, n), each step
    rounded as the kernel does (no fused multiply-add)."""
    c = np.floor(prefix.astype(np.float64) * (n / FIXED_ONE) - u0) + 1.0
    return np.clip(c, 0.0, n).astype(np.int64)


def resample_mirror(lw, u0, offset=0, nominal=True):
    """Ancestors from the kernel's algorithm; ``nominal=False`` divides by
    the exact sum of the q's instead (the design the kernel does not use)."""
    n = lw.size
    parts, _ = _lse_parts(lw, offset)
    m, s, nan = _merge_parts(parts)
    if nan or not math.isfinite(m):
        return np.arange(n)
    lse = m + math.log(s)
    with np.errstate(all="ignore"):
        w = np.exp(lw.astype(np.float64) - lse)
    w = np.where(w > 0.0, np.minimum(w, 1.0), 0.0)  # NaN: 0
    q = np.rint(w * FIXED_ONE).astype(np.uint64)
    # per-tile totals, exclusive integer offsets (the look-back's sums) and
    # the within-tile prefix: exact, so the same as one global prefix
    n_tiles, _ = K._resample_grid(n, N_SMS)
    qt = np.zeros(n_tiles * TILE, np.uint64)
    qt[:n] = q
    totals = qt.reshape(n_tiles, TILE).sum(axis=1, dtype=np.uint64)
    offsets = np.concatenate([[np.uint64(0)], np.cumsum(totals, dtype=np.uint64)[:-1]])
    prefix = (offsets[:, None] + np.cumsum(qt.reshape(n_tiles, TILE), axis=1,
                                           dtype=np.uint64)).reshape(-1)[:n]
    assert np.array_equal(prefix, np.cumsum(q, dtype=np.uint64))
    assert int(prefix[-1]) < 2**61  # the look-back's flags keep the top two bits
    if nominal:
        c = _comb(prefix, n, u0)
    else:
        c = np.clip(np.floor(prefix.astype(np.float64) / float(prefix[-1]) * n - u0) + 1.0,
                    0.0, n).astype(np.int64)
    c[-1] = n
    starts = np.concatenate([[0], c[:-1]])
    assert bool((c >= starts).all())  # monotone: every slot written once
    return np.repeat(np.arange(n), c - starts)


def _exact_systematic(logits64, u0):
    """Systematic resampling in float64 numpy (chip_smoke's reference)."""
    n = logits64.size
    w = np.exp(logits64 - np.max(logits64))
    cdf = np.cumsum(w / np.sum(w))
    return np.clip(np.searchsorted(cdf, (np.arange(n) + u0) / n, side="left"), 0, n - 1)


def _plain(lw, u0):
    t = torch.as_tensor(lw)
    return K.systematic_resample_ref(torch.tensor(u0, dtype=t.dtype),
                                     torch.exp(t - K.logsumexp_ref(t))).numpy()


@pytest.mark.parametrize("u0", [0.4170219898223877, 0.0, 1.0 - 2.0**-24])
@pytest.mark.parametrize("offset", [0, 1])
def test_resample_mirror_meets_the_float32_contract(u0, offset):
    """chip_smoke's float32 contract at 2^17 logits (normal x 4)."""
    n = 1 << 17
    logits = np.random.default_rng(7).normal(size=n) * 4.0
    lw32 = logits.astype(np.float32)
    u0 = float(np.float32(u0))
    got = resample_mirror(lw32, u0, offset)
    ref = _exact_systematic(logits, u0)
    floor = np.abs(_plain(lw32, u0) - ref).max()
    dev = np.abs(got - ref)
    assert got.shape == (n,) and bool((np.diff(got) >= 0).all())
    assert dev.max() <= max(4, 2 * floor) and (dev > 0).mean() < 0.02


@pytest.mark.parametrize("u0", [0.0, 0.37, 1.0 - 2.0**-40])
def test_resample_mirror_equals_jax_xla(u0):
    n = 1 << 17
    logits = np.random.default_rng(11).normal(size=n) * 4.0
    w = np.exp(logits - logits.max())
    w /= w.sum()
    want = np.asarray(pk.systematic_resample_xla(jnp.float64(u0), jnp.asarray(w)))
    dev = np.abs(resample_mirror(logits, u0) - want)
    assert dev.max() <= 1 and (dev > 0).mean() < 1e-3


def _degenerate(case):
    n = 1 << 17
    lw = np.full(n, -INF)
    if case == "one_live":
        lw[12345] = 0.0
    elif case == "two_live":
        lw[[12345, 100000]] = 0.0
    elif case == "live_last":  # unequal, so no comb point sits on a boundary
        lw[5], lw[n - 1] = -3.0, -1.7
    elif case in ("nan_weight", "pos_inf_weight"):
        lw = np.random.default_rng(3).normal(size=n)
        lw[777] = math.nan if case == "nan_weight" else INF
    elif case == "ragged":
        lw = np.random.default_rng(4).normal(size=5 * 2048 + 17) * 3.0
    elif case != "all_neg_inf":
        lw = np.random.default_rng(5).normal(size=n) * 3.0
    return lw


@pytest.mark.parametrize("case", ["one_live", "two_live", "live_last", "ragged", "u0_edges"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_resample_mirror_matches_plain_on_degenerate_weights(case, dtype):
    """The plain version runs in float64 on the same (widened) weights, as
    the kernel computes."""
    lw = _degenerate(case).astype(dtype)
    for u0 in (0.0, 0.5, 1.0 - 2.0**-24):
        got, plain = resample_mirror(lw, u0), _plain(lw.astype(np.float64), u0)
        if case in ("ragged", "u0_edges"):  # plain rounds its cdf: the f64 gate
            dev = np.abs(got - plain)
            assert dev.max() <= 1 and (dev > 0).mean() < 1e-3
        else:
            np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("case", ["all_neg_inf", "nan_weight", "pos_inf_weight"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_resample_mirror_gives_identity_without_weight(case, dtype):
    """No finite weight, a NaN or a +inf weight: the lse is not finite, every
    q is 0, and the indices are the identity (as the first design did)."""
    lw = _degenerate(case).astype(dtype)
    np.testing.assert_array_equal(resample_mirror(lw, 0.3), np.arange(lw.size))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nominal_total_moves_no_slot(seed):
    """Dividing by 2^60 in place of the exact sum of the q's: at 2^17 the
    comb moves by under 1e-7 of a slot, so no ancestor changes."""
    lw = (np.random.default_rng(seed).normal(size=1 << 17) * 4.0).astype(np.float32)
    u0 = float(np.random.default_rng(seed + 10).uniform())
    np.testing.assert_array_equal(resample_mirror(lw, u0),
                                  resample_mirror(lw, u0, nominal=False))


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 131072, 131072 + 5, 1 << 24])
def test_resample_tiles_cover_every_element_once(n):
    """Tiles of kTile elements cover [0, n) once, none empty; the emit grid
    never has more blocks than tiles (a block that finds every tile had its
    block stops after one) and at most four per SM."""
    n_tiles, n_emit = K._resample_grid(n, N_SMS)
    edges = np.minimum(np.arange(n_tiles + 1) * TILE, n)
    assert edges[0] == 0 and edges[-1] == n and bool((np.diff(edges) > 0).all())
    assert 1 <= n_emit <= min(n_tiles, K._EMIT_BLOCKS_PER_SM * N_SMS)
    assert n_emit == n_tiles or n_emit == K._EMIT_BLOCKS_PER_SM * N_SMS
