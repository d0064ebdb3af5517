"""The port's device building blocks: the CUDA kernels (``kernels``),
resampling, and the bf16 design-matrix products (``linalg``)."""

from .linalg import matmul_bf16, matmul_bf16x2, matmul_bf16x2_fastgrad, matvec_bf16

__all__ = ["matmul_bf16", "matmul_bf16x2", "matmul_bf16x2_fastgrad", "matvec_bf16"]
