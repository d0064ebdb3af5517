"""The port's CUDA kernels, each beside its plain PyTorch version.

The ports of the TPU kernels in ``fugue_tpu/ops/pallas_kernels.py``:

- ``pnormal_loglik_sum`` (forward ``_nll_fwd_kernel`` and backward
  ``_nll_bwd_kernel``, as one value-and-grad kernel;
  ``csrc/normal_loglik_sum.cu``): the force term of models whose
  likelihood is ``factor(pnormal_loglik_sum(y, mu, sigma))``;
- ``plogsumexp`` (``_plogsumexp_kernel``; ``csrc/logsumexp.cu``): SMC's
  weight normalisation, evidence and ESS reductions, two launches per
  call, the second a programmatic dependent launch;
- ``psystematic_resample`` (``_presample_kernel``;
  ``csrc/systematic_resample.cu``): SMC's ancestor draw, two launches per
  call with its own float64 log-sum-exp. Both share the reduction of
  ``csrc/lse_reduce.cuh``.

The TPU kernel ran once per chain under ``vmap``, once per direction. Here
one call takes the chain batch natively, ``y`` (N,) shared by all chains,
``mu`` and ``sigma`` (C,), and returns the value and both gradients (C,)
from one read of ``y``. ``pnormal_loglik_sum`` is a
``torch.autograd.Function`` whose ``vmap`` rule turns a batch of per-chain
calls into one batched call, so ``vmap(grad_and_value(potential))`` over C
chains makes one call.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
PyTorch version beside it. There is no fallback, size threshold or switch.
``LAUNCHES`` counts the calls of each C entry point.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

_LOG_2PI = math.log(2.0 * math.pi)
_NLL, _LSE, _RESAMPLE = "normal_loglik_sum", "logsumexp", "systematic_resample"
_THREADS = 256  # kThreads in the .cu sources
_LOADS = 4  # kLoads in normal_loglik_sum.cu: 16-byte loads per thread in a tile
_BLOCKS_PER_SM = 2  # the plate kernel's and the lse reduction's grid: about two blocks per SM
_MAX_CHAINS = 2**31 - 1
_RESAMPLE_TILE = _THREADS * 4  # kTile in systematic_resample.cu
_EMIT_BLOCKS_PER_SM = 4  # the resampling kernel's emit grid
_FLOATS = (torch.float32, torch.float64)

# calls of each C entry point
LAUNCHES = {"nll": 0, "lse": 0, "resample": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    _NLL: {"fugue_nll_value_grad_{}": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]},
    _LSE: {"fugue_lse_{}": [_P, _P, _P, _I, _I, _P]},
    _RESAMPLE: {"fugue_resample_{}": [_P, _P, _P, _P, _I, _I, _I, _P]},
}


# ---------------------------------------------------------------------------
# Plain versions (CPU path; the card checks the kernel against them)
# ---------------------------------------------------------------------------


def normal_loglik_sum_value_and_grad_ref(y, mu, sigma):
    """Σ_i log N(y_i; mu_c, sigma_c) and its (d/dmu, d/dsigma) for each chain
    c, row by row: y (N,), mu/sigma (C,). With z = (y - mu) / sigma:
    (-Σz²/2 - N(log σ + log(2π)/2), Σz/σ, Σz²/σ - N/σ)."""
    z = (y.reshape(1, -1) - mu.reshape(-1, 1)) / sigma.reshape(-1, 1)
    n = y.numel()
    sz2 = torch.sum(z * z, dim=1)
    value = -0.5 * sz2 - n * (torch.log(sigma) + 0.5 * _LOG_2PI)
    return value, torch.sum(z, dim=1) / sigma, sz2 / sigma - n / sigma


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


@functools.cache
def _lib(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>.cu`` with its C
    signatures set."""
    lib = _build.load(source)
    for pattern, argtypes in _SIGNATURES[source].items():
        for dt in ("f32", "f64"):
            fn = getattr(lib, pattern.format(dt))
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _entry(source: str, pattern: str, dtype):
    return getattr(_lib(source), pattern.format("f32" if dtype == torch.float32 else "f64"))


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _vector_layout(n: int, offset: int, itemsize: int):
    """(head, n_vec): a vector of n elements that starts ``offset``
    elements past a 16-byte boundary has ``head`` elements before its first
    boundary, then ``n_vec`` whole 16-byte vectors, then a ragged tail of
    fewer than 16 / itemsize elements."""
    w = 16 // itemsize
    head = min(n, (w - offset % w) % w)
    return head, (n - head) // w


def _offset(x) -> int:
    """x's start in elements past a 16-byte boundary."""
    return x.data_ptr() % 16 // x.element_size()


def _plate_partition(n: int, offset: int, itemsize: int, n_sms: int):
    """How the plate kernel cuts y into work: (head, n_vec, n_blocks).

    Rows ``[0, head)`` and ``[head + n_vec * w, n)`` (w elements per 16
    bytes; ``_vector_layout``) are read as scalars; the ``n_vec`` 16-byte
    vectors between go in tiles of ``_THREADS * _LOADS`` vectors, tile t to
    block ``t % n_blocks``. The grid is about two blocks per SM, fewer when
    there are fewer tiles; it never depends on the number of chains."""
    head, n_vec = _vector_layout(n, offset, itemsize)
    n_tiles = -(-n_vec // (_THREADS * _LOADS))
    return head, n_vec, max(1, min(_BLOCKS_PER_SM * n_sms, n_tiles))


def _check_launch(y, mu, sigma) -> None:
    for name, t in (("y", y), ("mu", mu), ("sigma", sigma)):
        if t.device != y.device:
            raise ValueError(f"{name} is on {t.device}, y on {y.device}")
        if t.dtype not in _FLOATS or t.dtype != y.dtype:
            raise TypeError(
                f"{name} has dtype {t.dtype}; the kernel takes float32 or "
                f"float64, the same for y, mu and sigma (y is {y.dtype})"
            )
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be 1-D and contiguous, got {tuple(t.shape)}")
    if mu.shape != sigma.shape:
        raise ValueError(f"mu {tuple(mu.shape)} and sigma {tuple(sigma.shape)} differ")
    if not 1 <= mu.numel() <= _MAX_CHAINS:
        raise ValueError(f"the kernel takes 1..{_MAX_CHAINS} chains, got {mu.numel()}")


def _launch_nll(y, mu, sigma):
    _check_launch(y, mu, sigma)
    n, n_chains, itemsize = y.numel(), mu.numel(), y.element_size()
    _, _, nb = _plate_partition(n, _offset(y), itemsize, _sm_count(y.device.index))
    # 32 bytes of moments per block, then the shift
    scratch = torch.empty(4 * nb + 1, dtype=torch.float64, device=y.device)
    outs = [torch.empty_like(mu) for _ in range(3)]
    fn = _entry(_NLL, "fugue_nll_value_grad_{}", y.dtype)
    with torch.cuda.device(y.device):
        rc = fn(y.data_ptr(), mu.data_ptr(), sigma.data_ptr(), scratch.data_ptr(),
                *[o.data_ptr() for o in outs], n, n_chains, nb, _stream(y.device))
    _raise_on(rc, "normal_loglik_sum")
    LAUNCHES["nll"] += 1
    return outs


def _value_and_grad(y, mu, sigma):
    """Kernel for CUDA tensors, plain version for CPU tensors, else raise."""
    if y.is_cuda:
        return _launch_nll(y, mu, sigma)
    if all(t.device.type == "cpu" for t in (y, mu, sigma)):
        if not (mu.dtype == sigma.dtype == y.dtype):
            raise TypeError(
                f"y, mu and sigma must share a dtype, got {y.dtype}, "
                f"{mu.dtype}, {sigma.dtype}"
            )
        return normal_loglik_sum_value_and_grad_ref(y, mu, sigma)
    raise ValueError(
        f"pnormal_loglik_sum runs on CUDA or CPU tensors, got y on {y.device}, "
        f"mu on {mu.device}, sigma on {sigma.device}"
    )


# ---------------------------------------------------------------------------
# autograd + vmap
# ---------------------------------------------------------------------------


def _batch_first(x, dim, size):
    return x.expand(size, *x.shape) if dim is None else x.movedim(dim, 0)


def _flat(x):
    return x.reshape(-1).contiguous()


class _NormalLoglikSum(torch.autograd.Function):
    """(value, d/dmu, d/dsigma) for mu/sigma of any equal shape, from one
    kernel call.

    The backward scales the saved gradients. They stay outputs of this
    Function, so a second derivative, which differentiates g * dmu through
    dmu, comes back here with a gradient for dmu or dsigma and raises: the
    saved gradients are constants to autograd, and letting it through would
    give zero where d²/dmu² is -N/σ²."""

    @staticmethod
    def forward(y, mu, sigma):
        return tuple(t.reshape(mu.shape) for t in _value_and_grad(y, _flat(mu), _flat(sigma)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs, output[1], output[2])

    @staticmethod
    def backward(ctx, g, g_dmu, g_dsigma):
        if g_dmu is not None or g_dsigma is not None:
            raise NotImplementedError("pnormal_loglik_sum has no second derivative")
        y, mu, sigma, dmu, dsigma = ctx.saved_tensors
        dy = None
        if ctx.needs_input_grad[0]:
            # dy_i = Σ_c g_c · (-(y_i - mu_c) / sigma_c²), as the JAX
            # package computes dy outside its kernel
            w = g / (sigma * sigma)
            dy = -(y * torch.sum(w) - torch.sum(mu * w))
        return dy, g * dmu, g * dsigma

    @staticmethod
    def vmap(info, in_dims, y, mu, sigma):
        if in_dims[0] is not None:
            raise ValueError("pnormal_loglik_sum: y must not be batched under vmap")
        mu = _batch_first(mu, in_dims[1], info.batch_size)
        sigma = _batch_first(sigma, in_dims[2], info.batch_size)
        return _NormalLoglikSum.apply(y, mu, sigma), (0, 0, 0)


def _as_param(x, like):
    if isinstance(x, torch.Tensor):
        return x
    return torch.full((), float(x), dtype=like.dtype, device=like.device)


def pnormal_loglik_sum_value_and_grad(y, mu, sigma):
    """(Σ_i log N(y_i; mu, sigma), d/dmu, d/dsigma) over all elements of
    ``y``, from one kernel call for CUDA tensors.

    ``mu`` and ``sigma`` are scalars, or tensors of one shape (a batch of
    chains); each result has their shape. The value is differentiable in
    all three inputs, once; under ``torch.func.vmap`` a batch of calls is
    one call."""
    y = _flat(y)
    mu, sigma = torch.broadcast_tensors(_as_param(mu, y), _as_param(sigma, y))
    return _NormalLoglikSum.apply(y, mu, sigma)


def pnormal_loglik_sum(y, mu, sigma):
    """Σ_i log N(y_i; mu, sigma) over all elements of ``y``; see
    ``pnormal_loglik_sum_value_and_grad``."""
    return pnormal_loglik_sum_value_and_grad(y, mu, sigma)[0]


def pnormal_loglik_sum_grad(y, mu, sigma):
    """(d/dmu, d/dsigma) of ``pnormal_loglik_sum``; see
    ``pnormal_loglik_sum_value_and_grad``."""
    return pnormal_loglik_sum_value_and_grad(y, mu, sigma)[1:]


# ---------------------------------------------------------------------------
# log-sum-exp
# ---------------------------------------------------------------------------


def logsumexp_ref(x):
    """log Σ exp(x) over all elements (the port of ``logsumexp_xla``): NaN
    propagates, +inf gives +inf, all -inf gives -inf."""
    m = torch.amax(x)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.zeros_like(m))
    out = m_safe + torch.log(torch.sum(torch.exp(x - m_safe)))
    return torch.where(finite, out, m)


def _check_vector(name: str, x) -> None:
    if x.dtype not in _FLOATS:
        raise TypeError(f"{name} has dtype {x.dtype}; the kernel takes float32 or float64")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{name} must be 1-D and contiguous, got shape {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError(f"{name} is empty")


def _lse_partition(n: int, offset: int, itemsize: int, n_sms: int):
    """How the log-sum-exp reduction (``csrc/lse_reduce.cuh``; logsumexp's
    first launch and the resampling kernel's) cuts x into work: (head,
    n_vec, n_blocks), with head and n_vec from ``_vector_layout``. The grid
    is ``n_blocks`` blocks of ``_THREADS``, about two per SM, fewer when
    there are fewer than one vector per thread; global thread g reads
    vectors g, g + S, g + 2S, ... (S threads in the grid)."""
    head, n_vec = _vector_layout(n, offset, itemsize)
    return head, n_vec, max(1, min(_BLOCKS_PER_SM * n_sms, -(-n_vec // _THREADS)))


def _launch_lse(x):
    """The logsumexp kernel on a CUDA vector: a 0-dim result in x's dtype."""
    _check_vector("x", x)
    n = x.numel()
    _, _, nb = _lse_partition(n, _offset(x), x.element_size(), _sm_count(x.device.index))
    scratch = torch.empty(3 * nb, dtype=torch.float64, device=x.device)  # 24 bytes a block
    out = torch.empty((), dtype=x.dtype, device=x.device)
    fn = _entry(_LSE, "fugue_lse_{}", x.dtype)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), scratch.data_ptr(), out.data_ptr(), n, nb, _stream(x.device))
    _raise_on(rc, "logsumexp")
    LAUNCHES["lse"] += 1
    return out


def plogsumexp(x):
    """log Σ exp(x) over all elements of a contiguous float tensor, as a
    0-dim tensor of its dtype: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    x = x.reshape(-1) if x.is_contiguous() else x
    if x.is_cuda:
        return _launch_lse(x)
    if x.device.type == "cpu":
        _check_vector("x", x)
        return logsumexp_ref(x)
    raise ValueError(f"plogsumexp runs on CUDA or CPU tensors, got {x.device}")


# ---------------------------------------------------------------------------
# systematic resampling
# ---------------------------------------------------------------------------


def systematic_resample_ref(u0, weights):
    """Ancestor indices (int64) of systematic resampling with comb offset
    ``u0`` (the port of ``systematic_resample_xla``): normalised cumsum,
    then ``searchsorted`` of the comb (k + u0) / n."""
    n = weights.shape[-1]
    cdf = torch.cumsum(weights, dim=-1)
    cdf = cdf / cdf[-1]
    us = (torch.arange(n, dtype=weights.dtype, device=weights.device) + u0) / n
    return torch.clamp(torch.searchsorted(cdf, us, side="left"), 0, n - 1)


def _resample_grid(n: int, n_sms: int):
    """(n_tiles, n_emit): the resampling kernel's second pass cuts the
    weights into tiles of ``_RESAMPLE_TILE`` elements, tile t being
    elements ``[t * tile, min((t + 1) * tile, n))``, and runs ``n_emit``
    blocks, about four per SM and never more than the tiles, which take
    tiles in ticket order until none is left."""
    n_tiles = -(-n // _RESAMPLE_TILE)
    return n_tiles, max(1, min(_EMIT_BLOCKS_PER_SM * n_sms, n_tiles))


def _launch_resample(log_weights, u0):
    _check_vector("log_weights", log_weights)
    n = log_weights.numel()
    if u0.dtype != log_weights.dtype:
        raise TypeError("the resampling kernel takes u0 in the weights' dtype")
    if u0.device != log_weights.device or u0.numel() != 1:
        raise ValueError(f"u0 must be one element on {log_weights.device}")
    n_sms = _sm_count(log_weights.device.index)
    _, _, n_parts = _lse_partition(n, _offset(log_weights), log_weights.element_size(), n_sms)
    n_tiles, n_emit = _resample_grid(n, n_sms)
    # the first pass's parts (3 words each), the tiles' look-back words, a ticket
    scratch = torch.empty(3 * n_parts + n_tiles + 1, dtype=torch.int64, device=log_weights.device)
    idx = torch.empty(n, dtype=torch.int64, device=log_weights.device)
    fn = _entry(_RESAMPLE, "fugue_resample_{}", log_weights.dtype)
    with torch.cuda.device(log_weights.device):
        rc = fn(log_weights.data_ptr(), u0.data_ptr(), scratch.data_ptr(), idx.data_ptr(),
                n, n_parts, n_emit, _stream(log_weights.device))
    _raise_on(rc, "systematic_resample")
    LAUNCHES["resample"] += 1
    return idx


def systematic_resample_from_u0(log_weights, u0):
    """Systematic-resampling ancestors of a 1-D log-weight vector with a
    given comb offset ``u0`` (0-dim, the weights' dtype and device). On a
    CUDA tensor: the resampling kernel, which takes its own float64
    log-sum-exp of the weights (two launches, no ``plogsumexp``)."""
    if log_weights.is_cuda:
        return _launch_resample(log_weights, u0)
    if log_weights.device.type == "cpu":
        _check_vector("log_weights", log_weights)
        w = torch.exp(log_weights - logsumexp_ref(log_weights))
        return systematic_resample_ref(u0, w)
    raise ValueError(f"psystematic_resample runs on CUDA or CPU tensors, got {log_weights.device}")


def psystematic_resample(generator: torch.Generator, log_weights):
    """Ancestor indices (int64, (N,)) of systematic resampling of a 1-D
    log-weight vector. The comb offset u0 is the one draw taken from
    ``generator``; nothing random runs inside the kernel."""
    _check_vector("log_weights", log_weights)  # before the draw, which takes its dtype
    u0 = torch.rand((), generator=generator, device=log_weights.device,
                    dtype=log_weights.dtype)
    return systematic_resample_from_u0(log_weights, u0)
