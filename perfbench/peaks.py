"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates at the
700 W power limit (NVIDIA's data sheet), and the kernel names of GEMMs."""

BF16_FLOPS = 989e12  # bf16 / fp16 tensor cores
FP32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
GEMM_WORDS = ("gemm", "nvjet", "cutlass", "xmma", "sm90_", "splitk", "cublas")
