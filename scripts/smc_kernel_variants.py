#!/usr/bin/env python3
"""Time the SMC kernels against their first designs and one-edit variants, on a GPU.

    python3 scripts/smc_kernel_variants.py

Builds ``fugue_tpu_torch/csrc/logsumexp.cu`` and ``systematic_resample.cu``
(with ``lse_reduce.cuh``) as they are and with one edit each, and the first
designs of both kernels (those the kept ones replaced), whose sources this
script carries (``FIRST_*`` below; the package no longer has them). Every build keeps the C interface
its wrapper calls.

logsumexp, float32 at 131,072 (SMC's particles) and 2^24:

- ``committed``: the full grid's parts, then a one-block merge as a
  programmatic dependent launch;
- ``no_pdl``: the merge launched after the parts' grid ends;
- ``cluster``, ``cluster8``: one launch, one thread-block cluster of 16 (or
  8) blocks of 1024 threads whose block 0 merges through distributed
  shared memory (a trial design, ``ONE_LAUNCH_LSE`` below);
- ``last_block``: one launch, the full grid whose last block, chosen by an
  atomic ticket, merges (the same trial source);
- ``loads1``, ``loads4``: 1 or 4 16-byte loads per thread in a batch, not 2;
- ``first``: the first design's two passes (64 blocks of 8 elements per thread, then one
  1,024-thread block).

systematic resampling, float32 at 131,072 (normal x 0.83: ESS about N/2,
and normal x 4: degenerate) and at 2^24 (normal x 0.83):

- ``committed``: the lse pass, then emit;
- ``pdl``: emit as a programmatic dependent launch of the lse pass;
- ``thread_runs``: every element writes its own slots, however many;
- ``block_runs``: every run goes to the block's list;
- ``tile512``, ``tile2048``: 2 or 8 elements per thread in a tile, not 4;
- ``cooperative``: one cooperative launch, a tile per block, each
  thread's weights held in registers across two grid barriers
  (``COOPERATIVE_RESAMPLE`` below; 131,072 only, where every block is
  resident);
- ``first``: the first design (the two-launch float64 logsumexp, tile totals,
  one scan block, emit with a binary search per slot).

It prints one JSON line per kernel and size: each build's device time per
call in microseconds (``chip_smoke.device_ms``: CUDA-graph replays),
measured twice in the order A..Z, Z..A, and whether its output equals the
committed build's (logsumexp: |a - b| / |b|; resampling: the largest
ancestor difference). Needs nvcc and a CUDA device; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import device_ms  # noqa: E402
from fugue_tpu_torch.ops import _build  # noqa: E402
from fugue_tpu_torch.ops import kernels as K  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int64
LSE, RES = "logsumexp", "systematic_resample"
ROUTE = "constexpr int kLoads = 2;"
CLUSTER = "size = (err == cudaSuccess && n_clusters >= 1) ? kMaxCluster : 8;"
PDL = "programmaticStreamSerializationAllowed = 1;"
SHORT = "constexpr int kShortRun = 8;"
PER = "constexpr int kPer = 4;"
# pdl: emit as a programmatic dependent launch of lse_parts
PARTS_START = "  __shared__ fugue_lse::BlockRed<kThreads> red;\n  const int64_t g"
EMIT_START = "  __shared__ int64_t long_a[kTile], long_b[kTile];\n"
EMIT_LAUNCH = """  emit<T><<<static_cast<unsigned>(n_emit), kThreads, 0, st>>>(
      x, static_cast<const T*>(u0), static_cast<const Part*>(parts), n_parts, status, ticket, n,
      n_tiles, static_cast<int64_t*>(idx));
  return static_cast<int>(cudaGetLastError());"""
EMIT_PDL = """  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_emit));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, emit<T>, x, static_cast<const T*>(u0),
                           static_cast<const Part*>(parts), n_parts, status, ticket, n,
                           n_tiles, static_cast<int64_t*>(idx));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());"""

# name -> (source, [(text, replacement)], wrapper options)
LSE_VARIANTS = {
    "committed": (LSE, [], {}),
    "no_pdl": (LSE, [(PDL, "programmaticStreamSerializationAllowed = 0;")], {}),
    "cluster": ("one_launch", [], {"cluster": True}),
    "cluster8": ("one_launch", [(CLUSTER, "size = 8;")], {"cluster": True}),
    "last_block": ("one_launch", [], {}),
    "loads1": (LSE, [(ROUTE, "constexpr int kLoads = 1;")], {}),
    "loads4": (LSE, [(ROUTE, "constexpr int kLoads = 4;")], {}),
    "first": ("first_lse", [], {}),
}
RES_VARIANTS = {
    "committed": (RES, [], {}),
    "pdl": (RES, [(PARTS_START, PARTS_START.replace(
        "\n  const", "\n  asm volatile(\"griddepcontrol.launch_dependents;\");\n  const")),
                   (EMIT_START, EMIT_START + "  asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n"),
                   (EMIT_LAUNCH, EMIT_PDL)], {}),
    "thread_runs": (RES, [(SHORT, "constexpr int kShortRun = 1 << 30;")], {}),
    "block_runs": (RES, [(SHORT, "constexpr int kShortRun = 0;")], {}),
    "tile512": (RES, [(PER, "constexpr int kPer = 2;")], {"tile": 512}),
    "tile2048": (RES, [(PER, "constexpr int kPer = 8;")], {"tile": 2048}),
    "cooperative": ("cooperative", [], {}),
    "first": ("first_resample", [], {}),
}

ONE_LAUNCH_LSE = r'''// One launch: a 16-block cluster (n_blocks == 0) or the full grid whose
// last block merges (n_blocks > 0); lse_reduce.cuh as committed.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "lse_reduce.cuh"

namespace {

namespace cg = cooperative_groups;
using fugue_lse::Acc;
using fugue_lse::Part;

constexpr int kThreads = 256;          // lse_grid's blocks
constexpr int kClusterThreads = 1024;  // lse_cluster's blocks
constexpr int kMaxCluster = 16;

__device__ unsigned int g_ticket;  // lse_grid's; 0 between calls

template <typename T>
__device__ __forceinline__ void store_lse(T* out, const Acc& a) {
  *out = static_cast<T>(fugue_lse::lse_of(a));
}

template <typename T>
__global__ void __launch_bounds__(kClusterThreads)
lse_cluster(const T* __restrict__ x, int64_t n, T* __restrict__ out) {
  __shared__ fugue_lse::BlockRed<kClusterThreads> red;
  __shared__ Part mine;
  cg::cluster_group cluster = cg::this_cluster();
  const Acc t = fugue_lse::block_all<kClusterThreads>(
      fugue_lse::thread_acc<T, kClusterThreads>(x, n, gridDim.x), red);
  if (threadIdx.x == 0) mine = Part{t.m, t.s, t.nan, 0u};
  cluster.sync();
  if (cluster.block_rank() == 0 && threadIdx.x < 32) {
    // lane r takes block r's part; the lanes merge like a block's warp
    Acc a = fugue_lse::acc_empty();
    if (threadIdx.x < cluster.num_blocks()) {
      const Part p = *cluster.map_shared_rank(&mine, threadIdx.x);
      a = Acc{p.m, p.s, p.nan};
    }
    double m = a.m;
    unsigned nan = a.nan;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m = fmax(m, __shfl_xor_sync(fugue_lse::kFullMask, m, o));
      nan |= __shfl_xor_sync(fugue_lse::kFullMask, nan, o);
    }
    double s = (isfinite(m) && a.m > -CUDART_INF) ? a.s * exp(a.m - m) : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(fugue_lse::kFullMask, s, o);
    if (threadIdx.x == 0) store_lse(out, Acc{m, s, nan});
  }
  cluster.sync();  // block 0 has read every block's shared memory
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lse_grid(const T* __restrict__ x, int64_t n, Part* __restrict__ parts, T* __restrict__ out) {
  __shared__ fugue_lse::BlockRed<kThreads> red;
  __shared__ bool last;
  const Acc t = fugue_lse::block_all<kThreads>(
      fugue_lse::thread_acc<T, kThreads>(x, n, gridDim.x), red);
  if (threadIdx.x == 0) {
    parts[blockIdx.x] = Part{t.m, t.s, t.nan, 0u};
    __threadfence();  // the part is visible before the ticket counts it
    last = atomicInc(&g_ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  Acc a = fugue_lse::acc_empty();
  for (int64_t j = threadIdx.x; j < gridDim.x; j += kThreads) {
    fugue_lse::acc_part(a, __ldcg(&parts[j].m), __ldcg(&parts[j].s), __ldcg(&parts[j].nan));
  }
  const Acc tot = fugue_lse::block_all<kThreads>(a, red);
  if (threadIdx.x == 0) store_lse(out, tot);
}

// 16 where the card can place a 16-block cluster of lse_cluster, else 8.
template <typename T>
int cluster_size(cudaStream_t st) {
  static int size = 0;  // one card type per process
  if (size == 0) {
    const void* fn = reinterpret_cast<const void*>(lse_cluster<T>);
    cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kMaxCluster);
    cfg.blockDim = dim3(kClusterThreads);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kMaxCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n_clusters = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&n_clusters, fn, &cfg);
    cudaGetLastError();  // a refused query only means: use 8
    size = (err == cudaSuccess && n_clusters >= 1) ? kMaxCluster : 8;
  }
  return size;
}

// n_blocks == 0: one cluster; else lse_grid with n_blocks blocks and
// `scratch` of n_blocks parts.
template <typename T>
int launch(const void* x, void* scratch, void* out, int64_t n, int64_t n_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (n_blocks > 0) {
    lse_grid<T><<<static_cast<unsigned>(n_blocks), kThreads, 0, st>>>(
        xt, n, static_cast<Part*>(scratch), o);
    return static_cast<int>(cudaGetLastError());
  }
  const int size = cluster_size<T>(st);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(size);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, lse_cluster<T>, xt, n, o);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fugue_lse_f32(const void* x, void* scratch, void* out, int64_t n, int64_t n_blocks,
                  void* stream) {
  return launch<float>(x, scratch, out, n, n_blocks, stream);
}

int fugue_lse_f64(const void* x, void* scratch, void* out, int64_t n, int64_t n_blocks,
                  void* stream) {
  return launch<double>(x, scratch, out, n, n_blocks, stream);
}

}  // extern "C"
'''

COOPERATIVE_RESAMPLE = r"""// One cooperative launch, one 1024-element tile per block (all blocks
// resident): each thread holds its four weights in registers across two
// grid barriers. 1: block lse parts; 2: every block merges them, its q's,
// tile total; 3: its offset from the totals before it, counts and slots.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "lse_reduce.cuh"

namespace {

namespace cg = cooperative_groups;
using fugue_lse::Acc;
using fugue_lse::Part;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;
constexpr int kTile = kThreads * kPer;
constexpr int kShortRun = 8;
constexpr double kFixedOne = 1152921504606846976.0;

__device__ __forceinline__ uint64_t fixed_weight(double lw, double lse) {
  double w = exp(lw - lse);
  if (!(w > 0.0)) return 0ull;
  if (w > 1.0) w = 1.0;
  return __double2ull_rn(__dmul_rn(w, kFixedOne));
}

__device__ __forceinline__ int64_t comb_count(uint64_t prefix, double scale, int64_t n,
                                              double u0) {
  double c = floor(__dsub_rn(__dmul_rn(__ull2double_rn(prefix), scale), u0)) + 1.0;
  c = fmin(fmax(c, 0.0), static_cast<double>(n));
  return static_cast<int64_t>(c);
}

__device__ __forceinline__ uint64_t warp_sum(uint64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ uint64_t block_inclusive_scan(uint64_t v, uint64_t* warp_tot, uint64_t* block_total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint64_t u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint64_t t = lane < kWarps ? warp_tot[lane] : 0ull;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint64_t u = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += u;
    }
    if (lane < kWarps) warp_tot[lane] = t;
    if (lane == kWarps - 1) *block_total = t;
  }
  __syncthreads();
  if (warp > 0) v += warp_tot[warp - 1];
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
coop(const T* __restrict__ lw, const T* __restrict__ u0_ptr, Part* __restrict__ parts,
     uint64_t* __restrict__ totals, int64_t n, int64_t* __restrict__ idx) {
  __shared__ fugue_lse::BlockRed<kThreads> red;
  __shared__ uint64_t warp_tot[kWarps];
  __shared__ uint64_t tile_total;
  __shared__ int n_long;
  __shared__ int long_i[kTile];
  __shared__ int64_t long_a[kTile], long_b[kTile];
  cg::grid_group grid = cg::this_grid();
  const int64_t tile = blockIdx.x;
  const int64_t first = tile * kTile + int64_t(threadIdx.x) * kPer;
  double v[kPer];
  bool in[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    in[k] = first + k < n;
    v[k] = in[k] ? static_cast<double>(lw[first + k]) : -CUDART_INF;
  }
  Acc a = fugue_lse::acc_empty();
  fugue_lse::acc_batch(a, v, in);
  const Acc t = fugue_lse::block_all<kThreads>(a, red);
  if (threadIdx.x == 0) {
    parts[tile] = Part{t.m, t.s, t.nan, 0u};
    n_long = 0;
  }
  grid.sync();
  Acc b = fugue_lse::acc_empty();
  for (int64_t j = threadIdx.x; j < gridDim.x; j += kThreads)
    fugue_lse::acc_part(b, __ldcg(&parts[j].m), __ldcg(&parts[j].s), __ldcg(&parts[j].nan));
  const Acc tot = fugue_lse::block_all<kThreads>(b, red);
  const bool identity = tot.nan != 0u || !isfinite(tot.m);
  const double lse = identity ? 0.0 : tot.m + log(tot.s);
  uint64_t q[kPer];
  uint64_t run = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    q[k] = identity ? 0ull : fixed_weight(v[k], lse);
    run += q[k];
  }
  const uint64_t before = block_inclusive_scan(run, warp_tot, &tile_total) - run;
  if (threadIdx.x == 0) totals[tile] = tile_total;
  grid.sync();
  if (identity) {
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (in[k]) idx[first + k] = first + k;
    return;
  }
  uint64_t o = 0;
  for (int64_t j = threadIdx.x; j < tile; j += kThreads) o += __ldcg(&totals[j]);
  o = warp_sum(o);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = o;
  __syncthreads();
  uint64_t off = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) off += warp_tot[w];
  const double u0 = static_cast<double>(*u0_ptr);
  const double scale = static_cast<double>(n) * (1.0 / kFixedOne);
  uint64_t prefix = off + before;
  int64_t start = first == 0 ? 0 : comb_count(prefix, scale, n, u0);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t j = first + k;
    if (j < n) {
      prefix += q[k];
      const int64_t end = j == n - 1 ? n : comb_count(prefix, scale, n, u0);
      if (end - start <= kShortRun) {
        for (int64_t s = start; s < end; ++s) idx[s] = j;
      } else {
        const int e = atomicAdd(&n_long, 1);
        long_i[e] = static_cast<int>(j - tile * kTile);
        long_a[e] = start;
        long_b[e] = end;
      }
      start = end;
    }
  }
  __syncthreads();
  for (int e = 0; e < n_long; ++e) {
    const int64_t j = tile * kTile + long_i[e];
    for (int64_t s = long_a[e] + threadIdx.x; s < long_b[e]; s += kThreads) idx[s] = j;
  }
}

}  // namespace

extern "C" int fugue_resample_f32(const void* lw, const void* u0, void* scratch, void* idx,
                                  int64_t n, int64_t, int64_t, void* stream) {
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_tiles));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  Part* parts = static_cast<Part*>(scratch);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, coop<float>, static_cast<const float*>(lw), static_cast<const float*>(u0), parts,
      reinterpret_cast<uint64_t*>(parts + n_tiles), n, static_cast<int64_t*>(idx));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
"""

FIRST_LSE = r'''// The first design's logsumexp.cu (its note dropped)
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFinalThreads = 1024;
constexpr unsigned kSawNaN = 1u;
constexpr unsigned kSawPosInf = 2u;

// (m, s) stands for s * exp(m); m == -inf means the empty sum (s == 0).
struct Lse {
  double m;
  double s;
  unsigned flags;
};

__device__ __forceinline__ void push(Lse& a, double v) {
  if (isnan(v)) {
    a.flags |= kSawNaN;
  } else if (isinf(v)) {
    if (v > 0) a.flags |= kSawPosInf;  // -inf adds nothing
  } else if (v > a.m) {
    a.s = a.s * exp(a.m - v) + 1.0;  // exp(-inf) = 0 for the first element
    a.m = v;
  } else {
    a.s += exp(v - a.m);
  }
}

__device__ __forceinline__ void combine(Lse& a, const Lse& b) {
  a.flags |= b.flags;
  if (b.m == -CUDART_INF) return;
  if (a.m == -CUDART_INF) {
    a.m = b.m;
    a.s = b.s;
  } else if (b.m > a.m) {
    a.s = a.s * exp(a.m - b.m) + b.s;
    a.m = b.m;
  } else {
    a.s += b.s * exp(b.m - a.m);
  }
}

__device__ __forceinline__ void warp_combine(Lse& a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Lse b;
    b.m = __shfl_down_sync(0xffffffffu, a.m, o);
    b.s = __shfl_down_sync(0xffffffffu, a.s, o);
    b.flags = __shfl_down_sync(0xffffffffu, a.flags, o);
    combine(a, b);
  }
}

// Block total, valid in thread 0. `smem` holds one slot per warp.
template <int kBlock>
__device__ Lse block_combine(Lse a, Lse* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_combine(a);
  if (lane == 0) smem[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = (lane < kBlock / 32) ? smem[lane] : Lse{-CUDART_INF, 0.0, 0u};
    warp_combine(a);
  }
  return a;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
partial_lse(const T* __restrict__ x, int64_t n, int64_t chunk,
            double* __restrict__ part) {
  __shared__ Lse smem[kThreads / 32];
  const int64_t b = blockIdx.x;
  const int64_t lo = b * chunk;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  Lse a{-CUDART_INF, 0.0, 0u};
#pragma unroll 4
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    push(a, static_cast<double>(x[i]));
  }
  a = block_combine<kThreads>(a, smem);
  if (threadIdx.x == 0) {
    part[3 * b] = a.m;
    part[3 * b + 1] = a.s;
    part[3 * b + 2] = static_cast<double>(a.flags);
  }
}

template <typename T>
__global__ void __launch_bounds__(kFinalThreads)
finalize_lse(const double* __restrict__ part, int64_t n_blocks,
             T* __restrict__ out, double* __restrict__ out64) {
  __shared__ Lse smem[kFinalThreads / 32];
  Lse a{-CUDART_INF, 0.0, 0u};
  for (int64_t j = threadIdx.x; j < n_blocks; j += kFinalThreads) {
    combine(a, Lse{part[3 * j], part[3 * j + 1],
                   static_cast<unsigned>(part[3 * j + 2])});
  }
  a = block_combine<kFinalThreads>(a, smem);
  if (threadIdx.x == 0) {
    double r;
    if (a.flags & kSawNaN) {
      r = CUDART_NAN;
    } else if (a.flags & kSawPosInf) {
      r = CUDART_INF;
    } else if (a.m == -CUDART_INF) {
      r = -CUDART_INF;
    } else {
      r = a.m + log(a.s);
    }
    if (out != nullptr) *out = static_cast<T>(r);
    if (out64 != nullptr) *out64 = r;
  }
}

template <typename T>
int launch(const void* x, void* scratch, void* out, void* out64, int64_t n,
           int64_t n_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* part = static_cast<double*>(scratch);
  const int64_t chunk = (n + n_blocks - 1) / n_blocks;
  partial_lse<T><<<static_cast<unsigned>(n_blocks), kThreads, 0, st>>>(
      static_cast<const T*>(x), n, chunk, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finalize_lse<T><<<1, kFinalThreads, 0, st>>>(
      part, n_blocks, static_cast<T*>(out), static_cast<double*>(out64));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// `out` (T) and `out64` (double) may each be null; one of them is written.
int fugue_lse_f32(const void* x, void* scratch, void* out, void* out64,
                  int64_t n, int64_t n_blocks, void* stream) {
  return launch<float>(x, scratch, out, out64, n, n_blocks, stream);
}

int fugue_lse_f64(const void* x, void* scratch, void* out, void* out64,
                  int64_t n, int64_t n_blocks, void* stream) {
  return launch<double>(x, scratch, out, out64, n, n_blocks, stream);
}

}  // extern "C"
'''

FIRST_RESAMPLE = r'''// The first design's systematic_resample.cu (its note dropped)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;  // elements per tile
constexpr int kScanThreads = 1024;
constexpr double kFixedOne = 1152921504606846976.0;  // 2^60

template <typename T>
__device__ __forceinline__ uint64_t fixed_weight(T lw, double lse) {
  double w = exp(static_cast<double>(lw) - lse);
  if (!(w > 0.0)) return 0ull;  // 0 or NaN
  if (w > 1.0) w = 1.0;
  return __double2ull_rn(__dmul_rn(w, kFixedOne));
}

// c = clamp(floor(n * prefix / total - u0) + 1, 0, n); monotone in prefix.
__device__ __forceinline__ int64_t comb_count(uint64_t prefix, uint64_t total,
                                              int64_t n, double u0) {
  const double dn = static_cast<double>(n);
  double p = __ddiv_rn(__ull2double_rn(prefix), __ull2double_rn(total));
  double c = floor(__dsub_rn(__dmul_rn(p, dn), u0)) + 1.0;
  c = fmin(fmax(c, 0.0), dn);
  return static_cast<int64_t>(c);
}

__device__ __forceinline__ uint64_t warp_sum(uint64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint64_t warp_inclusive_scan(uint64_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint64_t u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Inclusive scan over the block; `warp_tot` holds one slot per warp and
// `*block_total` (shared) receives the block's sum.
template <int kBlock>
__device__ uint64_t block_inclusive_scan(uint64_t v, uint64_t* warp_tot,
                                         uint64_t* block_total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_inclusive_scan(v);
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint64_t t = lane < kBlock / 32 ? warp_tot[lane] : 0ull;
    t = warp_inclusive_scan(t);
    if (lane < kBlock / 32) warp_tot[lane] = t;  // inclusive over warps
    if (lane == kBlock / 32 - 1) *block_total = t;
  }
  __syncthreads();
  if (warp > 0) v += warp_tot[warp - 1];
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_totals(const T* __restrict__ lw, const double* __restrict__ lse_ptr,
            int64_t n, uint64_t* __restrict__ totals) {
  __shared__ uint64_t warp_tot[kThreads / 32];
  const double lse = *lse_ptr;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t hi = lo + kTile < n ? lo + kTile : n;
  uint64_t a = 0;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    a += fixed_weight(lw[i], lse);
  }
  a = warp_sum(a);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint64_t t = 0;
    for (int w = 0; w < kThreads / 32; ++w) t += warp_tot[w];
    totals[blockIdx.x] = t;
  }
}

__global__ void __launch_bounds__(kScanThreads)
scan_totals(const uint64_t* __restrict__ totals, int64_t n_tiles,
            uint64_t* __restrict__ offsets, uint64_t* __restrict__ grand) {
  __shared__ uint64_t warp_tot[kScanThreads / 32];
  __shared__ uint64_t chunk_total;
  uint64_t carry = 0;
  for (int64_t base = 0; base < n_tiles; base += kScanThreads) {
    const int64_t j = base + threadIdx.x;
    const uint64_t v = j < n_tiles ? totals[j] : 0ull;
    const uint64_t incl = block_inclusive_scan<kScanThreads>(v, warp_tot, &chunk_total);
    if (j < n_tiles) offsets[j] = carry + incl - v;
    carry += chunk_total;
    __syncthreads();  // warp_tot and chunk_total are reused
  }
  if (threadIdx.x == 0) *grand = carry;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
emit(const T* __restrict__ lw, const double* __restrict__ lse_ptr,
     const T* __restrict__ u0_ptr, const uint64_t* __restrict__ offsets,
     const uint64_t* __restrict__ grand, int64_t n, int64_t* __restrict__ idx) {
  __shared__ uint64_t sh[kTile];  // the tile's q's, then its counts
  __shared__ uint64_t warp_tot[kThreads / 32];
  __shared__ uint64_t block_total;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int tile_n = static_cast<int>(n - base < kTile ? n - base : kTile);
  const uint64_t total = *grand;
  if (total == 0) {  // no weight anywhere: identity
    for (int i = threadIdx.x; i < tile_n; i += kThreads) idx[base + i] = base + i;
    return;
  }
  const double lse = *lse_ptr;
  const double u0 = static_cast<double>(*u0_ptr);
  for (int i = threadIdx.x; i < tile_n; i += kThreads) {
    sh[i] = fixed_weight(lw[base + i], lse);
  }
  __syncthreads();

  // this thread's run of kPerThread elements, scanned in sequence
  const int first = threadIdx.x * kPerThread;
  uint64_t local[kPerThread];
  uint64_t run = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    run += (first + k < tile_n) ? sh[first + k] : 0ull;
    local[k] = run;
  }
  const uint64_t before =
      offsets[blockIdx.x] + block_inclusive_scan<kThreads>(run, warp_tot, &block_total) - run;
  __syncthreads();  // every q is read; sh now takes the counts
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = first + k;
    if (i < tile_n) {
      const int64_t j = base + i;
      sh[i] = static_cast<uint64_t>(
          j == n - 1 ? n : comb_count(before + local[k], total, n, u0));
    }
  }
  __syncthreads();

  // slots [c_start, c_end) belong to this tile's elements
  const int64_t c_start = blockIdx.x == 0 ? 0 : comb_count(offsets[blockIdx.x], total, n, u0);
  const int64_t c_end = static_cast<int64_t>(sh[tile_n - 1]);
  for (int64_t k = c_start + threadIdx.x; k < c_end; k += kThreads) {
    int lo = 0;
    int hi = tile_n;  // first i with count_i > k
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (static_cast<int64_t>(sh[mid]) > k) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    idx[k] = base + lo;
  }
}

template <typename T>
int launch(const void* lw, const void* lse, const void* u0, void* scratch,
           void* idx, int64_t n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  uint64_t* totals = static_cast<uint64_t*>(scratch);
  uint64_t* offsets = totals + n_tiles;
  uint64_t* grand = offsets + n_tiles;
  const T* x = static_cast<const T*>(lw);
  const double* l = static_cast<const double*>(lse);
  tile_totals<T><<<static_cast<unsigned>(n_tiles), kThreads, 0, st>>>(x, l, n, totals);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_totals<<<1, kScanThreads, 0, st>>>(totals, n_tiles, offsets, grand);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  emit<T><<<static_cast<unsigned>(n_tiles), kThreads, 0, st>>>(
      x, l, static_cast<const T*>(u0), offsets, grand, n, static_cast<int64_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fugue_resample_f32(const void* lw, const void* lse, const void* u0,
                       void* scratch, void* idx, int64_t n, void* stream) {
  return launch<float>(lw, lse, u0, scratch, idx, n, stream);
}

int fugue_resample_f64(const void* lw, const void* lse, const void* u0,
                       void* scratch, void* idx, int64_t n, void* stream) {
  return launch<double>(lw, lse, u0, scratch, idx, n, stream);
}

}  // extern "C"
'''


def build(key, workdir):
    """Compile one variant; returns (key, ctypes function for float32)."""
    kernel, name = key
    source, edits, _ = (LSE_VARIANTS if kernel == "lse" else RES_VARIANTS)[name]
    vdir = os.path.join(workdir, f"{kernel}_{name}")
    os.makedirs(vdir)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, vdir)
    if source == "first_lse":
        src = FIRST_LSE
    elif source == "one_launch":
        src = ONE_LAUNCH_LSE
    elif source == "cooperative":
        src = COOPERATIVE_RESAMPLE
    elif source == "first_resample":
        src = FIRST_RESAMPLE
    else:
        src = (_build.CSRC / f"{source}.cu").read_text()
    for old, new in edits:
        target = os.path.join(vdir, "lse_reduce.cuh") if old == ROUTE else None
        if target:
            text = open(target).read()
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is no longer in lse_reduce.cuh")
            open(target, "w").write(text.replace(old, new))
            continue
        if old not in src:
            raise RuntimeError(f"{kernel} {name}: {old!r} is no longer in {source}")
        src = src.replace(old, new)
    cu, so = os.path.join(vdir, "k.cu"), os.path.join(vdir, "k.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {kernel} {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    if source == "first_lse":
        fn = lib.fugue_lse_f32
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _P]
    elif source == "first_resample":
        fn = lib.fugue_resample_f32
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _P]
    elif kernel == "lse":
        fn = lib.fugue_lse_f32
        fn.argtypes = K._SIGNATURES[K._LSE]["fugue_lse_{}"]
    else:
        fn = lib.fugue_resample_f32
        fn.argtypes = K._SIGNATURES[K._RESAMPLE]["fugue_resample_{}"]
    fn.restype = ctypes.c_int
    return key, fn


def _stream():
    return torch.cuda.current_stream().cuda_stream


def first_lse(fn, x, out64=False):
    """The first design's wrapper: 8 elements per thread, at most 1024 blocks."""
    n = x.numel()
    nb = max(1, min(1024, -(-n // (256 * 8))))
    scratch = torch.empty(3 * nb, dtype=torch.float64, device=x.device)
    out = torch.empty((), dtype=torch.float64 if out64 else x.dtype, device=x.device)
    ptrs = (None, out.data_ptr()) if out64 else (out.data_ptr(), None)
    K._raise_on(fn(x.data_ptr(), scratch.data_ptr(), *ptrs, n, nb, _stream()), "first lse")
    return out


def lse_call(fn, x, cluster=False):
    """The wrapper's launch; ``cluster``: the one-cluster trial (n_blocks 0)."""
    n = x.numel()
    _, _, nb = K._lse_partition(n, K._offset(x), x.element_size(), K._sm_count(x.device.index))
    nb = 0 if cluster else nb
    scratch = torch.empty(3 * nb, dtype=torch.float64, device=x.device) if nb else None
    out = torch.empty((), dtype=x.dtype, device=x.device)
    K._raise_on(fn(x.data_ptr(), None if scratch is None else scratch.data_ptr(),
                   out.data_ptr(), n, nb, _stream()), "lse variant")
    return out


def res_call(fn, lw, u0, tile=1024):
    n = lw.numel()
    n_sms = K._sm_count(lw.device.index)
    _, _, n_parts = K._lse_partition(n, K._offset(lw), lw.element_size(), n_sms)
    n_tiles = -(-n // tile)
    n_emit = max(1, min(K._EMIT_BLOCKS_PER_SM * n_sms, n_tiles))
    scratch = torch.empty(3 * n_parts + n_tiles + 1, dtype=torch.int64, device=lw.device)
    idx = torch.empty(n, dtype=torch.int64, device=lw.device)
    K._raise_on(fn(lw.data_ptr(), u0.data_ptr(), scratch.data_ptr(), idx.data_ptr(), n,
                   n_parts, n_emit, _stream()), "resample variant")
    return idx


def first_res_call(fn, lse_fn, lw, u0):
    n = lw.numel()
    lse64 = first_lse(lse_fn, lw, out64=True)
    n_tiles = -(-n // 2048)
    scratch = torch.empty(2 * n_tiles + 1, dtype=torch.int64, device=lw.device)
    idx = torch.empty(n, dtype=torch.int64, device=lw.device)
    K._raise_on(fn(lw.data_ptr(), lse64.data_ptr(), u0.data_ptr(), scratch.data_ptr(),
                   idx.data_ptr(), n, _stream()), "first resample")
    return idx


def timed(row, names, make_call):
    """Each build's device time, in turns; a build whose calls cannot be
    captured in a CUDA graph records why (the port's callers capture)."""
    for name in names + names[::-1]:
        try:
            t = 1e3 * device_ms(make_call(name))
        except RuntimeError as e:
            t = f"not captured: {str(e)[:160]}"
        row.setdefault(f"{name}_us", []).append(t)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("smc_kernel_variants: no CUDA device")
    keys = [("lse", v) for v in LSE_VARIANTS] + [("res", v) for v in RES_VARIANTS]
    with tempfile.TemporaryDirectory() as workdir, ThreadPoolExecutor(len(keys)) as pool:
        fns = dict(pool.map(lambda key: build(key, workdir), keys))
    lse_names, res_names = list(LSE_VARIANTS), list(RES_VARIANTS)

    def lse_fn(name, x):
        if name == "first":
            return lambda: first_lse(fns[("lse", "first")], x)
        return lambda: lse_call(fns[("lse", name)], x, **LSE_VARIANTS[name][2])

    for n in (K._THREADS * 512, 1 << 24):  # 131,072 and 2^24
        x = 10.0 * torch.randn(n, generator=torch.Generator(device="cuda").manual_seed(n),
                               device="cuda")
        want = lse_fn("committed", x)().double().item()
        row = {"kernel": "logsumexp", "n": n, "dtype": "float32",
               "rel_diff": {name: abs(lse_fn(name, x)().double().item() - want) / abs(want)
                            for name in lse_names}}
        timed(row, lse_names, lambda name: lse_fn(name, x))
        row["torch_logsumexp_us"] = 1e3 * device_ms(lambda: torch.logsumexp(x, 0))
        print(json.dumps(row), flush=True)

    def res_fn(name, lw, u0):
        if name == "first":
            return lambda: first_res_call(fns[("res", "first")], fns[("lse", "first")], lw, u0)
        return lambda: res_call(fns[("res", name)], lw, u0, **RES_VARIANTS[name][2])

    u0 = torch.tensor(0.37, device="cuda")
    for n, scale in ((K._THREADS * 512, 0.83), (K._THREADS * 512, 4.0), (1 << 24, 0.83)):
        lw = torch.as_tensor(np.random.default_rng(8).normal(size=n) * scale,
                             dtype=torch.float32, device="cuda")
        want = res_fn("committed", lw, u0)()
        names = [v for v in res_names if v != "cooperative" or n <= K._THREADS * 512]
        row = {"kernel": "systematic_resample", "n": n, "dtype": "float32",
               "weights": f"normal x {scale}",
               "max_abs_diff": {name: int((res_fn(name, lw, u0)() - want).abs().max())
                                for name in names}}
        timed(row, names, lambda name: res_fn(name, lw, u0))
        print(json.dumps(row), flush=True)
    one = torch.zeros(1, device="cuda")
    print(json.dumps({"launch_floor_us": 1e3 * device_ms(lambda: one.add_(1.0))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
