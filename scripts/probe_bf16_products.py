#!/usr/bin/env python3
"""Probe the bf16 product route of ``fugue_tpu_torch.ops.linalg`` on a GPU.

    python3 scripts/probe_bf16_products.py

Checks that the installed PyTorch has ``torch.mm(a, b, out_dtype=
torch.float32)`` for bf16 operands on CUDA (the port's only route for the
split-bf16 products), then times a batched value-and-gradient of a plain
logistic potential through ``matmul_bf16x2_fastgrad`` at
``bench_scale_logistic``'s shape (C = 256 chains, D = 1024, N = 100,000):
the GEMMs made per gradient (``linalg.GEMMS``), the profiler's device-time
table, the wall per gradient, and each GEMM shape alone. Needs a CUDA
device; imports no JAX.
"""

import os
import sys
import time

import torch
from torch.func import grad_and_value, vmap
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fugue_tpu_torch.ops import linalg  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_bf16_products: no CUDA device")
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    a = torch.randn(64, 32, device="cuda").bfloat16()
    b = torch.randn(32, 8, device="cuda").bfloat16()
    out = torch.mm(a, b, out_dtype=torch.float32)
    err = (out.double() - a.double() @ b.double()).abs().max().item()
    print("mm out_dtype:", out.dtype, "max error against float64:", err)

    n, d, c = 100_000, 1024, 256
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(n, d, generator=g, device="cuda") / d**0.5).bfloat16()
    w = torch.randn(c, d, generator=g, device="cuda")
    y = (torch.rand(n, generator=g, device="cuda") < 0.5).float()

    def potential(wi):
        logits = linalg.matmul_bf16x2_fastgrad(x, wi)
        return -(y * logits - torch.nn.functional.softplus(logits)).sum()

    force = vmap(grad_and_value(potential))
    force(w)
    torch.cuda.synchronize()
    before = linalg.GEMMS["cuda"]
    force(w)
    torch.cuda.synchronize()
    print("GEMMs per batched gradient:", linalg.GEMMS["cuda"] - before)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        force(w)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))
    t0 = time.perf_counter()
    for _ in range(20):
        force(w)
    torch.cuda.synchronize()
    print("ms per batched gradient:", (time.perf_counter() - t0) / 20 * 1e3)

    hi = w.bfloat16()
    cot = torch.randn(n, c, device="cuda").bfloat16()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for name, fn in (("(N, D) x (D, C)", lambda: torch.mm(x, hi.T, out_dtype=torch.float32)),
                     ("(D, N) x (N, C)", lambda: torch.mm(x.T, cot, out_dtype=torch.float32))):
        fn()
        start.record()
        for _ in range(10):
            fn()
        end.record()
        torch.cuda.synchronize()
        print(name, "ms per GEMM:", start.elapsed_time(end) / 10)


if __name__ == "__main__":
    main()
