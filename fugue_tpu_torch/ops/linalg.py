"""bf16 design-matrix products for model code.

The port of ``fugue_tpu/ops/linalg.py``: ``matmul_bf16``, ``matvec_bf16``,
``matmul_bf16x2`` and ``matmul_bf16x2_fastgrad``. None of them is a kernel
of its own: each is one or two dense products with bfloat16 operands and
float32 accumulation and output, which is what the H100's tensor cores do
natively. Inside a model:

    logits = matmul_bf16x2_fastgrad(X, w)       # (N,) float32
    observe("y", BernoulliLogits(logits), y)

The route on the card is ``torch.mm(a, b, out_dtype=torch.float32)`` on
bf16 operands: one cuBLAS GEMM that accumulates and writes float32. A plain
``a @ b`` of two bf16 tensors returns bf16 and rounds the logits, which
makes the potential rough at the bf16 scale; the route never switches to
it. A CUDA tensor takes this route or raises (a PyTorch without
``out_dtype`` for ``mm`` raises). A CPU tensor takes the plain version: the
bf16 operands widened to float32 (their products are exact there) and one
float32 product.

Batching over chains. The products are ``torch.autograd.Function``s with
``vmap`` rules: under ``vmap(grad_and_value(potential))`` over C chains the
C per-chain vectors ``w`` (D,) become ONE (N, D) x (D, C) GEMM, and the
backward's C cotangents (N,) one (D, N) x (N, C) GEMM. A batched gradient
through ``matmul_bf16x2_fastgrad`` is three GEMMs whatever C is: hi and lo
for the value, one for the gradient. ``GEMMS`` counts the products made.

Forward mode: the split products have custom backwards only, so
``torch.func.hessian`` (forward over reverse) cannot run through them, as
``jax.hessian`` cannot run through the JAX package's custom VJPs. Laplace
curvature needs a model written with ``matmul_bf16`` or plain products.
"""

from __future__ import annotations

import torch

# GEMMs made by the products here, by route ("cuda", "cpu")
GEMMS = {"cuda": 0, "cpu": 0}


def _gemm(a, b):
    """a (M, K) @ b (K, P), both bf16, accumulated and returned in float32:
    one product."""
    if a.device.type == "cuda":
        GEMMS["cuda"] += 1
        return torch.mm(a, b, out_dtype=torch.float32)
    if a.device.type != "cpu":
        raise NotImplementedError(f"no bf16 product route for device {a.device}")
    GEMMS["cpu"] += 1
    return torch.mm(a.to(torch.float32), b.to(torch.float32))


class _MatVec(torch.autograd.Function):
    """a (N, K) @ x (K,) → (N,) float32, a and x bf16. Batched over x only
    (the chains' parameters through one design matrix) it is one GEMM
    (N, K) x (K, C); a batched a takes one product per member. No
    gradient: the Functions below own it."""

    @staticmethod
    def forward(a, x):
        return _gemm(a, x[:, None])[:, 0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, a, x):
        return _batched(lambda m, v: _gemm(m, v), a, x, in_dims, info.batch_size)


class _TMatVec(torch.autograd.Function):
    """aᵀ (K, N) @ g (N,) → (K,) float32, a and g bf16: the contraction over
    the shared N axis. Batched over g only it is one GEMM (K, N) x (N, C)."""

    @staticmethod
    def forward(a, g):
        return _gemm(a.T, g[:, None])[:, 0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, a, g):
        return _batched(lambda m, v: _gemm(m.T, v), a, g, in_dims, info.batch_size)


def _batched(product, a, v, in_dims, size):
    """A matrix-vector product under vmap: ``product(matrix, (K, C)
    vectors)`` → (rows, C). With only the vectors batched, one product with
    the batch as its columns (out dim 1); otherwise one per member."""
    da, dv = in_dims
    if da is None:
        return product(a, v.movedim(dv, 0).T), 1
    a_b = a.movedim(da, 0)
    v_b = v.movedim(dv, 0) if dv is not None else v.expand(size, *v.shape)
    return torch.stack([product(a_b[i], v_b[i][:, None])[:, 0] for i in range(size)]), 0


def _mm(a, b):
    """a (N, K) @ b (K,) or (K, P), bf16 operands, float32 result."""
    if b.dim() == 1:
        return _MatVec.apply(a, b)
    return _gemm(a, b)


def _tmm(a, g):
    """aᵀ @ g over the leading N axis: g (N,) or (N, P)."""
    if g.dim() == 1:
        return _TMatVec.apply(a, g)
    return _gemm(a.T, g)


def _split_bf16(w):
    """w (float32) → (hi, lo) bf16 pair with hi + lo ≈ w to ~16 mantissa
    bits."""
    hi = w.to(torch.bfloat16)
    lo = (w - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def _grad_a(g, w):
    """The cotangent of the data: g ⊗ w for a vector w, g @ wᵀ for a
    matrix (rarely needed: the data is usually a constant)."""
    dt = torch.promote_types(g.dtype, w.dtype)
    g, w = g.to(dt), w.to(dt)
    if w.dim() == 1:
        return g[..., :, None] * w[None, :]
    return g @ w.T


class _MatmulBf16(torch.autograd.Function):
    """``a @ b`` with bf16 inputs and float32 accumulation. Its gradient is
    that of the JAX package's autodiff: the float32 cotangent times the
    other bf16 operand, in float32, rounded to bf16 (the dtype of the
    operand it belongs to). A float32 product: no gradient engine runs
    through this one."""

    @staticmethod
    def forward(a, b):
        return _mm(a.to(torch.bfloat16), b.to(torch.bfloat16))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        g32 = g.to(torch.float32)

        def bf16(x):
            return x.to(torch.bfloat16).to(torch.float32)

        if ctx.needs_input_grad[0]:
            ga = bf16(_grad_a(g32, bf16(b))).to(a.dtype)
        if ctx.needs_input_grad[1]:
            ab = bf16(a)
            gb = ab.T @ g32
            gb = bf16(gb).to(b.dtype)
        return ga, gb

    generate_vmap_rule = True


class _MatmulBf16x2(torch.autograd.Function):
    """Split-precision forward (two bf16 passes over w = hi + lo), and a
    backward with the same split of the cotangent: two passes."""

    @staticmethod
    def forward(a, w):
        hi, lo = _split_bf16(w.to(torch.float32))
        ab = a.to(torch.bfloat16)
        return _mm(ab, hi) + _mm(ab, lo)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        ga = gw = None
        if ctx.needs_input_grad[0]:
            ga = _grad_a(g, w).to(a.dtype)
        if ctx.needs_input_grad[1]:
            ab = a.to(torch.bfloat16)
            g_hi, g_lo = _split_bf16(g.to(torch.float32))
            gw = (_tmm(ab, g_hi) + _tmm(ab, g_lo)).to(w.dtype)
        return ga, gw

    generate_vmap_rule = True


class _MatmulBf16x2Fastgrad(_MatmulBf16x2):
    """The split-precision forward with a single-pass bf16 backward: the
    cotangent is rounded to bf16 once."""

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        ga = gw = None
        if ctx.needs_input_grad[0]:
            ga = _grad_a(g, w).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gw = _tmm(a.to(torch.bfloat16), g.to(torch.bfloat16)).to(w.dtype)
        return ga, gw


def matmul_bf16(a, b):
    """``a @ b`` with bf16 inputs and float32 accumulation: one pass.

    The relative error per output element is about bf16's eps (7.8e-3) on
    the INPUTS only; the contraction accumulates in float32, so the result
    does not degrade with its length. Right for GLM linear predictors; use
    a plain float32 product where a gate needs moments tighter than about
    1e-2 relative."""
    return _MatmulBf16.apply(a, b)


def matvec_bf16(a, x):
    """``a @ x`` for a matrix and a vector (an alias of ``matmul_bf16``)."""
    return matmul_bf16(a, x)


def matmul_bf16x2(a, w):
    """``a @ w`` with bf16 DATA and split-bf16 (pseudo-float32) PARAMETERS.

    A plain bf16 cast of the parameters makes the potential a rough
    function of position (log-density wiggles at the bf16 ULP of ``w``),
    which collapses HMC's dual averaging toward useless step sizes.
    Splitting w = hi + lo into two bf16 passes restores about 16 mantissa
    bits of the parameters; it costs twice the work of ``matmul_bf16``.
    The backward splits the cotangent the same way (autodiff through the
    split would round the tangents to bf16)."""
    return _MatmulBf16x2.apply(a, w)


def matmul_bf16x2_fastgrad(a, w):
    """``matmul_bf16x2``'s split forward (a smooth potential) with a
    single-pass bf16 backward: the cotangent is rounded to bf16 once.

    Sound for MCMC: the backward feeds the leapfrog force only, and the
    acceptance uses the exact split-precision potential at the endpoints,
    so a force error costs a little acceptance, never bias. Three GEMMs per
    value and gradient instead of four. Use ``matmul_bf16x2`` where the
    gradient itself is the result (MAP, VI at convergence)."""
    return _MatmulBf16x2Fastgrad.apply(a, w)
