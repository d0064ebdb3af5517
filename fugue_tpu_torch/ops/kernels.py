"""The Gaussian-plate log-likelihood kernel and its plain version.

The port of ``pnormal_loglik_sum`` from ``fugue_tpu/ops/pallas_kernels.py``
(forward ``_nll_fwd_kernel``, backward ``_nll_bwd_kernel``): the force term
of models whose likelihood is ``factor(pnormal_loglik_sum(y, mu, sigma))``.

The TPU kernel ran once per chain under ``vmap``. Here the kernel takes the
chain batch natively: ``y`` (N,) shared by all chains, ``mu`` and ``sigma``
(C,), output (C,). ``pnormal_loglik_sum`` is a ``torch.autograd.Function``
whose ``vmap`` rule turns a batch of per-chain calls into one batched
launch, so ``vmap(grad_and_value(potential))`` over C chains launches the
forward kernel once and the backward kernel once.

A CUDA tensor launches the kernel in ``csrc/normal_loglik_sum.cu`` or
raises; a CPU tensor takes the plain PyTorch version beside it. There is no
fallback, size threshold or switch. ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

_LOG_2PI = math.log(2.0 * math.pi)
_SOURCE = "normal_loglik_sum"
_THREADS = 256  # kThreads in the .cu source
_MAX_CHAINS = 2**31 - 1  # gridDim.x; blocks per chain go on gridDim.y

# kernel launches, one per call of each C entry point
LAUNCHES = {"fwd": 0, "bwd": 0}


# ---------------------------------------------------------------------------
# Plain versions (CPU path; the card checks the kernel against them)
# ---------------------------------------------------------------------------


def normal_loglik_sum_ref(y, mu, sigma):
    """Σ_i log N(y_i; mu_c, sigma_c) for each chain c: y (N,), mu/sigma (C,)."""
    z = (y.reshape(1, -1) - mu.reshape(-1, 1)) / sigma.reshape(-1, 1)
    n = y.numel()
    return -0.5 * torch.sum(z * z, dim=1) - n * (torch.log(sigma) + 0.5 * _LOG_2PI)


def normal_loglik_sum_grad_ref(y, mu, sigma):
    """(d/dmu, d/dsigma) of ``normal_loglik_sum_ref``: (Σz/σ, Σz²/σ − N/σ)."""
    z = (y.reshape(1, -1) - mu.reshape(-1, 1)) / sigma.reshape(-1, 1)
    n = y.numel()
    return torch.sum(z, dim=1) / sigma, torch.sum(z * z, dim=1) / sigma - n / sigma


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int64
    for dt in ("f32", "f64"):
        fwd = getattr(lib, f"fugue_nll_fwd_{dt}")
        fwd.argtypes = [p, p, p, p, p, i, i, i, p]
        fwd.restype = ctypes.c_int
        bwd = getattr(lib, f"fugue_nll_bwd_{dt}")
        bwd.argtypes = [p, p, p, p, p, p, i, i, i, p]
        bwd.restype = ctypes.c_int
    return lib


def _n_blocks(n: int, n_chains: int) -> int:
    """Blocks per chain: about 2048 blocks in all (several waves over the
    card's 132 SMs), but at least 4 elements per thread; never above 2048,
    well inside gridDim.y's 65535."""
    return max(1, min(-(-2048 // n_chains), -(-n // (_THREADS * 4))))


def _check_launch(y, mu, sigma) -> None:
    for name, t in (("y", y), ("mu", mu), ("sigma", sigma)):
        if t.device != y.device:
            raise ValueError(f"{name} is on {t.device}, y on {y.device}")
        if t.dtype not in (torch.float32, torch.float64) or t.dtype != y.dtype:
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


def _launch(direction: str, y, mu, sigma):
    _check_launch(y, mu, sigma)
    n, n_chains = y.numel(), mu.numel()
    nb = _n_blocks(n, n_chains)
    n_scratch = 1 if direction == "fwd" else 2
    scratch = torch.empty((n_scratch, n_chains, nb), dtype=torch.float64, device=y.device)
    outs = [torch.empty_like(mu) for _ in range(n_scratch)]
    dt = "f32" if y.dtype == torch.float32 else "f64"
    fn = getattr(_lib(), f"fugue_nll_{direction}_{dt}")
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = fn(y.data_ptr(), mu.data_ptr(), sigma.data_ptr(), scratch.data_ptr(),
                *[o.data_ptr() for o in outs], n, n_chains, nb, stream)
    if rc != 0:
        raise RuntimeError(f"normal_loglik_sum {direction} launch failed: CUDA error {rc}")
    LAUNCHES[direction] += 1
    return outs


def _dispatch(direction: str, y, mu, sigma):
    """Kernel for CUDA tensors, plain version for CPU tensors, else raise."""
    if y.is_cuda:
        return _launch(direction, y, mu, sigma)
    if all(t.device.type == "cpu" for t in (y, mu, sigma)):
        if not (mu.dtype == sigma.dtype == y.dtype):
            raise TypeError(
                f"y, mu and sigma must share a dtype, got {y.dtype}, "
                f"{mu.dtype}, {sigma.dtype}"
            )
        if direction == "fwd":
            return [normal_loglik_sum_ref(y, mu, sigma)]
        return list(normal_loglik_sum_grad_ref(y, mu, sigma))
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


class _NormalLoglikSumGrad(torch.autograd.Function):
    """(dmu, dsigma) for mu/sigma of any equal shape; the backward kernel."""

    @staticmethod
    def forward(y, mu, sigma):
        dmu, dsigma = _dispatch("bwd", y, _flat(mu), _flat(sigma))
        return dmu.reshape(mu.shape), dsigma.reshape(mu.shape)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g_dmu, g_dsigma):
        raise NotImplementedError("pnormal_loglik_sum has no second derivative")

    @staticmethod
    def vmap(info, in_dims, y, mu, sigma):
        if in_dims[0] is not None:
            raise ValueError("pnormal_loglik_sum: y must not be batched under vmap")
        mu = _batch_first(mu, in_dims[1], info.batch_size)
        sigma = _batch_first(sigma, in_dims[2], info.batch_size)
        return _NormalLoglikSumGrad.apply(y, mu, sigma), (0, 0)


class _NormalLoglikSum(torch.autograd.Function):
    """Σ_i log N(y_i; mu, sigma) for mu/sigma of any equal shape; the
    forward kernel, with the backward kernel behind its gradient."""

    @staticmethod
    def forward(y, mu, sigma):
        (out,) = _dispatch("fwd", y, _flat(mu), _flat(sigma))
        return out.reshape(mu.shape)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        y, mu, sigma = ctx.saved_tensors
        dmu, dsigma = _NormalLoglikSumGrad.apply(y, mu, sigma)
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
        return _NormalLoglikSum.apply(y, mu, sigma), 0


def _as_param(x, like):
    if isinstance(x, torch.Tensor):
        return x
    return torch.full((), float(x), dtype=like.dtype, device=like.device)


def pnormal_loglik_sum(y, mu, sigma):
    """Σ_i log N(y_i; mu, sigma) over all elements of ``y``.

    ``mu`` and ``sigma`` are scalars, or tensors of one shape (a batch of
    chains); the result has their shape. Differentiable in all three;
    under ``torch.func.vmap`` a batch of calls is one kernel launch."""
    y = _flat(y)
    mu, sigma = torch.broadcast_tensors(_as_param(mu, y), _as_param(sigma, y))
    return _NormalLoglikSum.apply(y, mu, sigma)


def pnormal_loglik_sum_grad(y, mu, sigma):
    """(d/dmu, d/dsigma) of ``pnormal_loglik_sum``, through the backward
    kernel for CUDA tensors."""
    y = _flat(y)
    mu, sigma = torch.broadcast_tensors(_as_param(mu, y), _as_param(sigma, y))
    return _NormalLoglikSumGrad.apply(y, mu, sigma)
