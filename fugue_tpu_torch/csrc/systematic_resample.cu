// Systematic resampling for Hopper (sm_90a): log-weights -> ancestor indices.
//
// Replaces the TPU kernel in fugue_tpu/ops/pallas_kernels.py:
//   _presample_kernel with _tile_prefix_sum (via psystematic_resample)
//
// With w_j = exp(lw_j - lse), W_j = w_0 + ... + w_j and comb points
// u_k = (k + u0) / N, slot k takes the ancestor searchsorted(W / W_{N-1},
// u_k, side="left"): the first j whose normalised prefix reaches u_k. So
// element j owns the slots [c_{j-1}, c_j) with
//   c_j = clamp(floor(N * W_j / W_{N-1} - u0) + 1, 0, N),   c_{-1} = 0,
// and c_{N-1} = N by definition.
//
// The TPU kernel walked a sequential grid and carried the running prefix
// from tile to tile in a split integer/fraction float32 pair; the counts it
// wrote went back to HBM and a cummax repaired their rounding before a
// searchsorted. Blocks here run in parallel, and the design keeps the
// prefix exact instead:
//   - Each weight is widened to double and rounded once to a 64-bit fixed-
//     point integer q_j = rint(w_j * 2^60). Integer sums are exact in any
//     order, so every prefix is the exact sum of the q's before it, a block
//     total is exactly the last element of the block's own scan, and the
//     counts are monotone by construction: no cummax. (With lse from the
//     double output of the logsumexp kernel the q's sum to 2^60 (1 +- 1e-15)
//     plus at most N/2, far inside 64 bits.)
//   - c_j comes from the prefix through int->double conversion, division,
//     multiplication, subtraction (each correctly rounded, never fused) and
//     floor: all monotone, so c_j never decreases, and neighbouring blocks
//     compute the shared boundary count from the same integer.
// Three passes, no atomics, no CDF and no count array in HBM:
//   1. tile_totals: per 2048-element tile, the sum of its q's.
//   2. scan_totals: one block scans the tile totals into exclusive offsets
//      and the grand total.
//   3. emit: per tile, the q's again (coalesced, into shared memory), each
//      thread's eight in sequence, a block scan of the thread sums, the
//      counts into shared memory; then the block's threads share the slots
//      [c_{first-1}, c_last) that the tile owns, and each finds its element
//      by binary search over the tile's counts. Every slot is written once.
// If all weights are 0 (or NaN), the indices are the identity.
//
// What bounds it: bytes. It must read lw (N * sizeof(T)) and write the
// int64 indices (8N); the arithmetic (one double exp, a few integer adds
// and one division per element) is far below the FP64 peak. lw is read
// twice (passes 1 and 3), the second time mostly from L2.
//
// Interface: plain C entry points for ctypes; each runs the three passes on
// the given stream, allocates nothing (the caller provides a uint64 scratch
// of 2 * n_tiles + 1 and the int64 output) and returns cudaGetLastError()
// after its launches. lse is a double on the device, u0 a T on the device.

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
