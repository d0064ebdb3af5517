#!/usr/bin/env python3
"""Time the Gaussian-plate kernel against one-edit variants of its source, on a GPU.

    python3 scripts/plate_kernel_variants.py

Builds ``fugue_tpu_torch/csrc/normal_loglik_sum.cu`` as it is and with one
edit each, all with the C interface the port calls:

- ``no_pdl``: ``finish`` launched after ``partial_moments`` ends, not as a
  programmatic dependent launch;
- ``partials_only``: ``partial_moments`` alone (the outputs are not
  written: a timing of the first kernel, not a result);
- ``loads2`` / ``loads8``: 2 or 8 16-byte loads per thread in a tile,
  not 4.

For float32 y at (C, N) = (1, 2^24) and (64, 2^20) it prints one JSON line
with each build's device time per call (``chip_smoke.device_ms``: CUDA-graph
replays, twice each in the order A..E, E..A) and that of ``torch.sum(y)``,
PyTorch's own one-read reduction over the same bytes, and how far each
build's outputs lie from the committed build's (largest |a - b| / max(|b|,
1); the loads variants merge in another order, so they differ by rounding).
Needs nvcc and a CUDA device; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import device_ms  # noqa: E402
from fugue_tpu_torch.ops import _build  # noqa: E402
from fugue_tpu_torch.ops import kernels as K  # noqa: E402

SOURCE = _build.CSRC / "normal_loglik_sum.cu"
LOADS = "constexpr int kLoads = 4;"
PDL = "programmaticStreamSerializationAllowed = 1;"
FINISH = "  // programmatic dependent launch: finish is scheduled while"
# name -> (the text edited, its replacement, loads per thread)
VARIANTS = {
    "committed": (None, None, 4),
    "no_pdl": (PDL, "programmaticStreamSerializationAllowed = 0;", 4),
    "partials_only": (FINISH, "  if (n_chains > 0) return 0;\n" + FINISH, 4),
    "loads2": (LOADS, "constexpr int kLoads = 2;", 2),
    "loads8": (LOADS, "constexpr int kLoads = 8;", 8),
}


def build(name, workdir):
    old, new, _ = VARIANTS[name]
    src = SOURCE.read_text()
    if old is not None:
        if old not in src:
            raise RuntimeError(f"{name}: {old!r} is no longer in {SOURCE.name}")
        src = src.replace(old, new)
    cu, so = os.path.join(workdir, f"{name}.cu"), os.path.join(workdir, f"{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    fn = lib.fugue_nll_value_grad_f32
    fn.argtypes = K._SIGNATURES[K._NLL]["fugue_nll_value_grad_{}"]
    fn.restype = ctypes.c_int
    return name, fn


def call(fn, loads, y, mu, sigma):
    """The wrapper's launch, with the variant's loads per thread."""
    isz = y.element_size()
    saved, K._LOADS = K._LOADS, loads
    try:
        _, _, nb = K._plate_partition(y.numel(), y.data_ptr() % 16 // isz, isz,
                                      K._sm_count(y.device.index))
    finally:
        K._LOADS = saved
    scratch = torch.empty(4 * nb + 1, dtype=torch.float64, device=y.device)
    outs = [torch.empty_like(mu) for _ in range(3)]
    rc = fn(y.data_ptr(), mu.data_ptr(), sigma.data_ptr(), scratch.data_ptr(),
            *[o.data_ptr() for o in outs], y.numel(), mu.numel(), nb,
            torch.cuda.current_stream().cuda_stream)
    K._raise_on(rc, "variant")
    return outs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("plate_kernel_variants: no CUDA device")
    with tempfile.TemporaryDirectory() as workdir, ThreadPoolExecutor(len(VARIANTS)) as pool:
        fns = dict(pool.map(lambda name: build(name, workdir), VARIANTS))
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    for c, n in ((1, 1 << 24), (64, 1 << 20)):
        g = torch.Generator(device="cuda").manual_seed(c)
        y = 1.5 + 2.0 * torch.randn(n, generator=g, device="cuda")
        mu = 1.5 + 0.01 * torch.randn(c, generator=g, device="cuda")
        sigma = 2.0 * torch.exp(0.01 * torch.randn(c, generator=g, device="cuda"))
        want = call(fns["committed"], 4, y, mu, sigma)
        row = {"chains": c, "rows": n, "dtype": "float32",
               "rel_diff": {name: max(((a.double() - b.double()).abs()
                                       / b.double().abs().clamp(min=1.0)).max().item()
                                      for a, b in zip(call(fns[name], VARIANTS[name][2],
                                                           y, mu, sigma), want))
                            for name in VARIANTS if name != "partials_only"}}
        for name in order:
            loads = VARIANTS[name][2]
            row.setdefault(f"{name}_us", []).append(
                1e3 * device_ms(lambda: call(fns[name], loads, y, mu, sigma)))
        row["torch_sum_us"] = 1e3 * device_ms(lambda: torch.sum(y))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
