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

Beside them, one kernel that replaces no TPU kernel:

- ``normal_plane`` (``csrc/normal_plane.cu``): ``Normal(loc, scale).log_prob(y)``
  for data ``y`` shared by every chain and a scalar loc and scale per
  chain, written as one (C, N) plane forward and read once backward for
  the (C,) sums d/dloc and d/dscale. The JAX package leaves the same
  expression (``fugue_tpu/core/distributions.py:198``) to XLA's fusion
  under ``jit``; eager PyTorch streams a dozen (C, N) planes for it.

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
import types

import torch

from ..utils import profiling
from . import _build

_LOG_2PI = math.log(2.0 * math.pi)
_NLL, _LSE, _RESAMPLE = "normal_loglik_sum", "logsumexp", "systematic_resample"
_PLANE = "normal_plane"
_THREADS = 256  # kThreads in the .cu sources
_LOADS = 4  # kLoads in normal_loglik_sum.cu: 16-byte loads per thread in a tile
_BLOCKS_PER_SM = 2  # the plate kernel's and the lse reduction's grid: about two blocks per SM
_MAX_CHAINS = 2**31 - 1
_RESAMPLE_TILE = _THREADS * 4  # kTile in systematic_resample.cu
_EMIT_BLOCKS_PER_SM = 4  # the resampling kernel's emit grid
_FLOATS = (torch.float32, torch.float64)
_PLANE_TILE = 2048  # kTile in normal_plane.cu: elements of y a block holds in shared memory
_PLANE_ROWS = _THREADS // 32  # rows a block takes at a time: one per warp
_PLANE_BLOCKS_PER_SM = 8  # the normal_plane kernels' grid
_MAX_GRID_Y = 65535

# calls of each C entry point
LAUNCHES = {"nll": 0, "lse": 0, "resample": 0, "normal_plane": 0, "normal_plane_grad": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    _NLL: {"fugue_nll_value_grad_{}": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]},
    _LSE: {"fugue_lse_{}": [_P, _P, _P, _I, _I, _P]},
    _RESAMPLE: {"fugue_resample_{}": [_P, _P, _P, _P, _I, _I, _I, _P]},
    _PLANE: {"fugue_normal_plane_{}": [_P, _P, _P, _P, _I, _I, _I, _P],
             "fugue_normal_plane_grad_{}": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P]},
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
# Normal log-density of shared data under per-chain scalar parameters
# ---------------------------------------------------------------------------


def normal_plane_routes(value, loc, scale) -> bool:
    """Whether ``Normal(loc, scale).log_prob(value)`` takes ``normal_plane``:
    ``value`` is data shared by every chain (a plain floating tensor with at
    least one element and one dimension, not wrapped by a ``torch.func``
    transform and not requiring grad), and ``loc`` and ``scale`` are 0-d
    tensors of its dtype and device (per chain under ``vmap``). Reads
    tensor metadata only, so a call that does not route runs no extra
    operation."""
    if not (isinstance(value, torch.Tensor) and isinstance(loc, torch.Tensor)
            and isinstance(scale, torch.Tensor)):
        return False
    if (value.dim() == 0 or value.numel() == 0 or value.requires_grad
            or value.dtype not in _FLOATS
            or torch._C._functorch.is_functorch_wrapped_tensor(value)):
        return False
    return all(p.dim() == 0 and p.dtype == value.dtype and p.device == value.device
               for p in (loc, scale))


def _rows_of(p, y):
    """A parameter of shape S as S + (1,) * y.dim(), against S + y.shape."""
    return p.reshape(p.shape + (1,) * y.dim())


def _z(y, loc, scale):
    return (y - _rows_of(loc, y)) / _rows_of(scale, y)


def _sum_data(x, y):
    """x (S + y.shape) summed over y's dimensions: shape S."""
    return torch.sum(x, dim=tuple(range(-y.dim(), 0)))


def normal_plane_ref(y, loc, scale):
    """log N(y; loc_c, scale_c) for each row c (loc and scale of one shape
    S): the plane S + y.shape, as ``Normal.log_prob`` writes it."""
    z = _z(y, loc, scale)
    return -0.5 * z * z - _rows_of(torch.log(scale), y) - 0.5 * _LOG_2PI


def normal_plane_grad_ref(g, y, loc, scale):
    """(Σ_i g·z/σ, Σ_i g·(z² - 1)/σ) for each row c, with z = (y - loc_c) /
    σ_c, σ = scale: d/dloc and d/dscale of Σ_i g_i · log N(y_i; loc_c, σ_c)."""
    z = _z(y, loc, scale)
    return _sum_data(g * z, y) / scale, _sum_data(g * (z * z - 1.0), y) / scale


def _plane_blocks(rows: int, sm_count: int) -> int:
    """The ``normal_plane`` kernels' grid: blocks of ``_PLANE_ROWS`` warps,
    a warp a row at a time, about eight blocks per SM, fewer when there
    are fewer rows (the forward's grid has one such row of blocks per tile
    of ``_PLANE_TILE`` elements of y)."""
    return max(1, min(_PLANE_BLOCKS_PER_SM * sm_count, -(-rows // _PLANE_ROWS)))


def _check_plane(y, loc, scale) -> None:
    _check_launch(y, loc, scale)
    if -(-y.numel() // _PLANE_TILE) > _MAX_GRID_Y:
        raise ValueError(f"the kernel takes at most {_MAX_GRID_Y * _PLANE_TILE} elements "
                         f"of y, got {y.numel()}")


def _launch_plane(y, loc, scale):
    """The forward kernel: y (N,), loc and scale (C,) → the (C, N) plane."""
    _check_plane(y, loc, scale)
    n, rows = y.numel(), loc.numel()
    nb = _plane_blocks(rows, _sm_count(y.device.index))
    out = torch.empty((rows, n), dtype=y.dtype, device=y.device)
    fn = _entry(_PLANE, "fugue_normal_plane_{}", y.dtype)
    with torch.cuda.device(y.device):
        rc = fn(y.data_ptr(), loc.data_ptr(), scale.data_ptr(), out.data_ptr(), n, rows, nb,
                _stream(y.device))
    _raise_on(rc, "normal_plane")
    LAUNCHES["normal_plane"] += 1
    return out


def _launch_plane_grad(g, y, loc, scale):
    """The backward kernel: the cotangent g (C, N), read in place through
    its row stride when its elements are contiguous in a row, → (d/dloc,
    d/dscale), each (C,)."""
    _check_plane(y, loc, scale)
    n, rows = y.numel(), loc.numel()
    if g.shape != (rows, n) or g.dtype != y.dtype or g.device != y.device:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} on {g.device} does not match "
                         f"the plane ({rows}, {n}) {y.dtype} on {y.device}")
    if n > 1 and g.stride(1) != 1:
        g = g.contiguous()
    nb = _plane_blocks(rows, _sm_count(y.device.index))
    dloc, dscale = torch.empty_like(loc), torch.empty_like(scale)
    fn = _entry(_PLANE, "fugue_normal_plane_grad_{}", y.dtype)
    with torch.cuda.device(y.device):
        rc = fn(g.data_ptr(), g.stride(0), y.data_ptr(), loc.data_ptr(), scale.data_ptr(),
                dloc.data_ptr(), dscale.data_ptr(), n, rows, nb, _stream(y.device))
    _raise_on(rc, "normal_plane_grad")
    LAUNCHES["normal_plane_grad"] += 1
    return dloc, dscale


def _on_one_kind(what, *ts) -> bool:
    """True for CUDA tensors, False for CPU tensors, else raise."""
    if ts[0].is_cuda:
        return True
    if all(t.device.type == "cpu" for t in ts):
        return False
    raise ValueError(f"{what} runs on CUDA or CPU tensors, got "
                     + ", ".join(str(t.device) for t in ts))


def _plane(y, loc, scale):
    """The plane S + y.shape for loc and scale of one shape S: the kernel
    for CUDA tensors, the plain version for CPU tensors. One call, one
    ``density.normal_plane`` count."""
    profiling.count("density.normal_plane")
    if not _on_one_kind("normal_plane", y, loc, scale):
        return normal_plane_ref(y, loc, scale)
    out = _launch_plane(_flat(y), _flat(loc), _flat(scale))
    return out.reshape(loc.shape + y.shape)


def _plane_grad(g, y, loc, scale):
    """(d/dloc, d/dscale), each of shape S: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if not _on_one_kind("normal_plane_grad", g, y, loc, scale):
        return normal_plane_grad_ref(g, y, loc, scale)
    dloc, dscale = _launch_plane_grad(g.reshape(loc.numel(), y.numel()), _flat(y),
                                      _flat(loc), _flat(scale))
    return dloc.reshape(loc.shape), dscale.reshape(scale.shape)


# The drives evaluate a potential as vmap(grad_and_value(potential)).
# functorch runs an autograd.Function under those two transforms through
# Python at each level, per call: about 1 ms of host time per call on an
# H100 machine's host, which set the pace of the SMC moves once the kernels
# had cut their device time (PERF.md §6). For exactly that stack, a grad
# level on top of at most one vmap level, the calls below build the grad
# level's node themselves (``_at_grad().Function``) and run the kernels
# below both levels; any other stack (jvp, hessian, nested grads, plain
# autograd below) takes the Functions through functorch. These are torch's
# private functorch hooks, imported at the first routed call (``_at_grad``)
# and held to the Functions bitwise by tests/test_torch_normal_plane.py.
# Once SMC's moves replay captured graphs, no call pays that host cost and
# this path goes (ROADMAP D.10).


@functools.cache
def _at_grad():
    """torch's private functorch hooks, and ``_NormalPlane``'s node at the
    drives' grad level built on them: its forward runs ``_plane`` on the
    tensors below the levels, its backward is ``_NormalPlane``'s."""
    from torch._C import _functorch
    from torch._functorch.pyfunctorch import TransformType, temporarily_clear_interpreter_stack
    from torch._functorch.utils import enable_single_level_autograd_function

    class NormalPlaneAtGrad(torch.autograd.function._SingleLevelFunction):
        @staticmethod
        def forward(y, loc, scale, levels, below):
            with temporarily_clear_interpreter_stack():
                out = _plane(*below)
            return _above(out, levels)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(*inputs[:3])

        @staticmethod
        def backward(ctx, g):
            return (*_NormalPlane.backward(ctx, g), None, None)

    return types.SimpleNamespace(
        C=_functorch, TransformType=TransformType, cleared=temporarily_clear_interpreter_stack,
        single_level=enable_single_level_autograd_function, Function=NormalPlaneAtGrad)


def _drive_levels():
    """(grad level, vmap level, batch size) when the transform stack is a
    ``grad`` on top of at most one ``vmap`` (vmap level and size None
    without it), else None."""
    h = _at_grad()
    stack = h.C.get_interpreter_stack()
    if not stack or len(stack) > 2 or stack[-1].key() != h.TransformType.Grad:
        return None
    if len(stack) == 1:
        return stack[0].level(), None, None
    if stack[0].key() != h.TransformType.Vmap:
        return None
    return stack[1].level(), stack[0].level(), h.C.CVmapInterpreterPtr(stack[0]).batchSize()


def _unwrapped(t, levels, batched=True):
    """(``t`` under the two levels, its batch dimension or None), or None
    where something else wraps it or plain autograd tracks it below.
    ``batched=False``: the data, which no level batches."""
    C = _at_grad().C
    level, vmap_level, _ = levels
    t, dim = C._unwrap_for_grad(t, level), None
    if (vmap_level is not None and batched and C.is_batchedtensor(t)
            and C.maybe_get_level(t) == vmap_level):
        t, dim = C._unwrap_batched(t, vmap_level)
    if C.is_functorch_wrapped_tensor(t) or t.requires_grad:
        return None
    return t, dim


def _all_below(levels, y, *params):
    """(y, *params) under the levels, each param batch first where a vmap
    level is there, or None where one cannot go. Call it with the stack
    cleared: an op while the transforms are on wraps its result."""
    below = [_unwrapped(y, levels, batched=False), *(_unwrapped(p, levels) for p in params)]
    if any(t is None for t in below):
        return None
    size = levels[2]
    return [below[0][0], *(t if size is None else _batch_first(t, dim, size)
                           for t, dim in below[1:])]


def _above(t, levels):
    """A result computed below the levels, batch first, as the grad
    level's tensor."""
    C = _at_grad().C
    level, vmap_level, _ = levels
    if vmap_level is not None:
        t = C._add_batch_dim(t, 0, vmap_level)
    return C._wrap_for_grad(t, level)


def _sums_at_grad(g, y, loc, scale):
    """(d/dloc, d/dscale) for the backward of the drives' grad level, run
    below the levels, or None for any other stack. functorch takes a grad
    level's gradient with ``create_graph`` and drops that level's graph of
    it on return, so the sums need no node at that level."""
    levels = _drive_levels()
    if levels is None:
        return None
    with _at_grad().cleared():
        below = _all_below(levels, y, g, loc, scale)
        sums = None if below is None else _plane_grad(below[1], below[0], *below[2:])
    return None if sums is None else tuple(_above(t, levels) for t in sums)


def _unbatched_data(in_dim) -> None:
    if in_dim is not None:
        raise ValueError("normal_plane: the data must not be batched under vmap")


class _NormalPlane(torch.autograd.Function):
    """log N(y; loc, scale) as the plane S + y.shape, for loc and scale of
    one shape S. Saves no plane: the backward recomputes z from y, loc and
    scale inside ``_NormalPlaneGrad``, a Function of its own, so second
    derivatives (reverse over reverse, forward over reverse) go through its
    plain backward and jvp."""

    @staticmethod
    def forward(y, loc, scale):
        return _plane(y, loc, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, g):
        y, loc, scale = ctx.saved_tensors
        sums = _sums_at_grad(g, y, loc, scale)
        dloc, dscale = sums if sums is not None else _NormalPlaneGrad.apply(g, y, loc, scale)
        dy = None
        if ctx.needs_input_grad[0]:
            dy = (-g * _z(y, loc, scale) / _rows_of(scale, y)).sum_to_size(y.shape)
        return dy, dloc, dscale

    @staticmethod
    def jvp(ctx, ty, tloc, tscale):
        y, loc, scale = ctx.saved_tensors
        z = _z(y, loc, scale)
        s = _rows_of(scale, y)
        out = torch.zeros_like(z)
        if ty is not None:
            out = out - ty * z / s
        if tloc is not None:
            out = out + _rows_of(tloc, y) * z / s
        if tscale is not None:
            out = out + _rows_of(tscale, y) * (z * z - 1.0) / s
        return out

    @staticmethod
    def vmap(info, in_dims, y, loc, scale):
        _unbatched_data(in_dims[0])
        loc = _batch_first(loc, in_dims[1], info.batch_size)
        scale = _batch_first(scale, in_dims[2], info.batch_size)
        return _NormalPlane.apply(y, loc, scale), 0


class _NormalPlaneGrad(torch.autograd.Function):
    """(Σ_i g·z/σ, Σ_i g·(z² - 1)/σ) over y's dimensions, for the cotangent
    g (S + y.shape) of ``_NormalPlane``: its backward kernel, with a plain
    backward and jvp of its own."""

    @staticmethod
    def forward(g, y, loc, scale):
        return _plane_grad(g, y, loc, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, a, b):
        # d/dloc = Σ g z / σ and d/dscale = Σ g (z² - 1) / σ, with dz/dloc =
        # -1/σ, dz/dσ = -z/σ, dz/dy = 1/σ
        g, y, loc, scale = ctx.saved_tensors
        z = _z(y, loc, scale)
        s = _rows_of(scale, y)
        ar, br = _rows_of(a, y), _rows_of(b, y)
        dg = (ar * z + br * (z * z - 1.0)) / s
        gz, g1 = _sum_data(g * z, y), _sum_data(g, y)
        d_loc = -(a * g1 + 2.0 * b * gz) / (scale * scale)
        d_scale = (-2.0 * a * gz + b * _sum_data(g * (1.0 - 3.0 * z * z), y)) / (scale * scale)
        dy = None
        if ctx.needs_input_grad[1]:
            dy = (g * (ar + 2.0 * br * z) / (s * s)).sum_to_size(y.shape)
        return dg, dy, d_loc, d_scale

    @staticmethod
    def jvp(ctx, tg, ty, tloc, tscale):
        g, y, loc, scale = ctx.saved_tensors
        z = _z(y, loc, scale)
        s = _rows_of(scale, y)
        # the tangent of (g z, g (z² - 1)) before the sums and the 1/σ
        tz = torch.zeros_like(z)
        if ty is not None:
            tz = tz + ty / s
        if tloc is not None:
            tz = tz - _rows_of(tloc, y) / s
        if tscale is not None:
            tz = tz - _rows_of(tscale, y) * z / s
        t1 = g * tz
        t2 = 2.0 * g * z * tz
        if tg is not None:
            t1 = t1 + tg * z
            t2 = t2 + tg * (z * z - 1.0)
        d1, d2 = _sum_data(t1, y) / scale, _sum_data(t2, y) / scale
        if tscale is not None:
            d1 = d1 - tscale * _sum_data(g * z, y) / (scale * scale)
            d2 = d2 - tscale * _sum_data(g * (z * z - 1.0), y) / (scale * scale)
        return d1, d2

    @staticmethod
    def vmap(info, in_dims, g, y, loc, scale):
        _unbatched_data(in_dims[1])
        g = _batch_first(g, in_dims[0], info.batch_size)
        loc = _batch_first(loc, in_dims[2], info.batch_size)
        scale = _batch_first(scale, in_dims[3], info.batch_size)
        return _NormalPlaneGrad.apply(g, y, loc, scale), (0, 0)


def normal_plane(value, loc, scale):
    """``Normal(loc, scale).log_prob(value)`` for data ``value`` and 0-d
    ``loc`` and ``scale`` (``normal_plane_routes``): one kernel launch per
    call, and per batched call under ``torch.func.vmap``; differentiable in
    loc and scale to any order (first derivatives from the backward
    kernel, higher ones plain)."""
    levels = _drive_levels()
    if levels is not None:
        h = _at_grad()
        with h.cleared():
            below = _all_below(levels, value, loc, scale)
        if below is not None:
            with h.single_level():
                return h.Function.apply(value, loc, scale, levels, below)
    return _NormalPlane.apply(value, loc, scale)


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
