// Systematic resampling for Hopper (sm_90a): log-weights -> ancestor indices.
//
// Replaces the TPU kernel in fugue_tpu/ops/pallas_kernels.py:
//   _presample_kernel :186 with _tile_prefix_sum :158 (via psystematic_resample)
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
//     point integer q_j = rint(min(w_j, 1) * 2^60) (0 for NaN). Integer sums
//     are exact in any order, so every prefix is the exact sum of the q's
//     before it, whichever block computes it, and the counts are monotone by
//     construction: no cummax.
//   - The comb divides by the nominal total 2^60, not by the exact sum Q of
//     the q's: c_j = clamp(floor(P_j * (N 2^-60) - u0) + 1, 0, N) for the
//     integer prefix P_j, through int->double conversion, one multiplication
//     and one subtraction (each correctly rounded, never fused) and floor:
//     all monotone, so c_j never decreases, and neighbouring blocks compute
//     a shared boundary count from the same integer. The counts then need
//     no grand total and no third pass. What it costs: the lse is exact to
//     about 1e-15 relative and each q to half a unit, so Q = 2^60 (1 + d)
//     with |d| <= 1e-15 + N 2^-61, and the comb point u_k moves by N |d|
//     slots: 1.4e-10 + 7.5e-9 at N = 2^17, far under one slot in 10^7. A
//     slot can change owner only when a comb point lies that close to a
//     boundary, as a different rounding of the lse would move it
//     (tests/test_torch_resampling.py's mirror holds this algorithm to the
//     exact float64 reference). One live particle or two equal ones give
//     q's of exactly 2^60 or 2^59, so Q = 2^60 and nothing moves.
//   - If the lse is not finite (a NaN or +inf weight, or every weight -inf)
//     every q would be 0: the indices are the identity, as before.
// Two launches, the lse folded in:
//   1. lse_parts: the log-sum-exp reduction of lse_reduce.cuh over the
//      grid (16-byte loads, about two blocks per SM); each block writes its
//      (m, s, nan) part. It also zeroes pass 2's tile flags and ticket, so
//      nothing outlives a call: back-to-back calls and graph replays start
//      from zero, and calls on two streams have separate scratch.
//   2. emit. Every block merges the parts in the same fixed order, so all
//      derive the same lse without a round trip. Then, tile by tile (kTile
//      elements; tile ids from an atomic ticket, in the order blocks take
//      them): each thread's four q's and their running sum in registers, a
//      block scan, and the tile's exclusive offset from a single-pass
//      decoupled look-back (Merrill & Garland) over the earlier tiles'
//      totals: each tile publishes its total (flag A) and then its
//      inclusive prefix (flag P) in one 64-bit word, value in the low 62
//      bits (the sums stay below 2^61), flag in the top two; the block
//      reads 256 predecessors at a time (one round at SMC's 128 tiles) and
//      stops at the nearest P. A tile waits only on tiles with smaller
//      tickets, which running blocks hold, so the look-back cannot
//      deadlock. The first tile's ticket, the parts and the tile's weights
//      are all in flight at once; with one block per tile (SMC's sizes) a
//      block takes no second ticket. Each element then writes its own
//      slots [c_{j-1}, c_j); runs longer than kShortRun go to a list that
//      the whole block writes, so one heavy particle does not leave a
//      thread writing alone. Each slot is written once.
//      emit is a plain launch: as a programmatic dependent launch it was
//      about 4 us slower at 131,072 (PERF.md,
//      scripts/smc_kernel_variants.py).
//
// What bounds it: bytes. It must read lw (N * sizeof(T)) and write the
// int64 indices (8N); the arithmetic (two double exps, a few integer adds
// and a multiplication per element) is far below the FP64 peak. lw is read
// twice (passes 1 and 2), the second time mostly from L2.
//
// Interface: plain C entry points for ctypes; each runs both passes on the
// given stream, allocates nothing (the caller provides a scratch of
// 3 * n_parts + n_tiles + 1 eight-byte words and the int64 output) and
// returns the first CUDA error of its launches, or 0. u0 is a T on the
// device.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "lse_reduce.cuh"

namespace {

using fugue_lse::Acc;
using fugue_lse::Part;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                       // elements per thread in a tile
constexpr int kTile = kThreads * kPer;        // elements per tile
constexpr int kShortRun = 8;                  // longer runs: the block writes them
constexpr double kFixedOne = 1152921504606846976.0;  // 2^60
constexpr uint64_t kFlagA = 1ull << 62;       // tile total published
constexpr uint64_t kFlagP = 2ull << 62;       // inclusive prefix published
constexpr uint64_t kFlags = 3ull << 62;
constexpr uint64_t kValue = ~kFlags;

__device__ __forceinline__ uint64_t fixed_weight(double lw, double lse) {
  double w = exp(lw - lse);
  if (!(w > 0.0)) return 0ull;  // 0 or NaN
  if (w > 1.0) w = 1.0;
  return __double2ull_rn(__dmul_rn(w, kFixedOne));
}

// c = clamp(floor(prefix * (n 2^-60) - u0) + 1, 0, n); monotone in prefix.
__device__ __forceinline__ int64_t comb_count(uint64_t prefix, double scale, int64_t n,
                                              double u0) {
  double c = floor(__dsub_rn(__dmul_rn(__ull2double_rn(prefix), scale), u0)) + 1.0;
  c = fmin(fmax(c, 0.0), static_cast<double>(n));
  return static_cast<int64_t>(c);
}

__device__ __forceinline__ uint64_t load_status(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t warp_sum(uint64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(fugue_lse::kFullMask, v, o);
  return v;
}

__device__ __forceinline__ uint64_t warp_inclusive_scan(uint64_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint64_t u = __shfl_up_sync(fugue_lse::kFullMask, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Inclusive scan over the block; `warp_tot` holds one slot per warp and
// `*block_total` (shared) receives the block's sum.
__device__ uint64_t block_inclusive_scan(uint64_t v, uint64_t* warp_tot, uint64_t* block_total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_inclusive_scan(v);
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint64_t t = lane < kWarps ? warp_tot[lane] : 0ull;
    t = warp_inclusive_scan(t);
    if (lane < kWarps) warp_tot[lane] = t;  // inclusive over warps
    if (lane == kWarps - 1) *block_total = t;
  }
  __syncthreads();
  if (warp > 0) v += warp_tot[warp - 1];
  return v;
}

// Sum of the tiles before `tile`, by the whole block: thread i reads tile
// base - i and waits until it has published; the block adds the values
// down to the nearest inclusive prefix (at SMC's 128 tiles: one round).
// Every thread returns the sum.
struct LookBack {
  int first_p[kWarps];
  uint64_t sum[kWarps];
};

__device__ uint64_t look_back(const uint64_t* status, int64_t tile, LookBack& sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint64_t off = 0;
  for (int64_t base = tile - 1; base >= 0; base -= kThreads) {
    const int64_t p = base - threadIdx.x;
    uint64_t st = kFlagP;  // before tile 0: an inclusive prefix of 0
    if (p >= 0) {
      do {
        st = load_status(status + p);
      } while ((st & kFlags) == 0);
    }
    const unsigned pm = __ballot_sync(fugue_lse::kFullMask, (st & kFlags) == kFlagP);
    if (lane == 0) sh.first_p[warp] = pm ? warp * 32 + __ffs(pm) - 1 : kThreads;
    __syncthreads();
    int stop = kThreads;  // the nearest P, kThreads for none
#pragma unroll
    for (int w = 0; w < kWarps; ++w) stop = min(stop, sh.first_p[w]);
    const uint64_t v = warp_sum(static_cast<int>(threadIdx.x) <= stop ? (st & kValue) : 0ull);
    if (lane == 0) sh.sum[warp] = v;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) off += sh.sum[w];
    __syncthreads();  // sh is reused
    if (stop < kThreads) break;
  }
  return off;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lse_parts(const T* __restrict__ lw, int64_t n, Part* __restrict__ parts,
          uint64_t* __restrict__ status, int64_t n_tiles,
          unsigned long long* __restrict__ ticket) {
  __shared__ fugue_lse::BlockRed<kThreads> red;
  const int64_t g = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  for (int64_t i = g; i < n_tiles; i += int64_t(gridDim.x) * kThreads) status[i] = 0ull;
  if (g == 0) *ticket = 0ull;
  const Acc t = fugue_lse::block_all<kThreads>(
      fugue_lse::thread_acc<T, kThreads>(lw, n, gridDim.x), red);
  if (threadIdx.x == 0) parts[blockIdx.x] = Part{t.m, t.s, t.nan, 0u};
}

// This thread's kPer elements of the tile starting at `first` (-inf past n).
template <typename T>
__device__ __forceinline__ void load_run(const T* __restrict__ lw, int64_t first, int64_t n,
                                         bool aligned, double (&v)[kPer]) {
  using V = typename fugue_lse::Vec16<T>::type;
  constexpr int kW = 16 / sizeof(T);
  if constexpr (kPer % kW == 0) {
    if (aligned && first + kPer <= n) {
      const V* p = reinterpret_cast<const V*>(lw + first);
      V vec[kPer / kW];
#pragma unroll
      for (int k = 0; k < kPer / kW; ++k) vec[k] = __ldg(p + k);
#pragma unroll
      for (int k = 0; k < kPer; ++k) v[k] = fugue_lse::lane_of(vec[k / kW], k % kW);
      return;
    }
  }
  {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      v[k] = first + k < n ? static_cast<double>(lw[first + k]) : -CUDART_INF;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
emit(const T* __restrict__ lw, const T* __restrict__ u0_ptr, const Part* __restrict__ parts,
     int64_t n_parts, uint64_t* __restrict__ status, unsigned long long* __restrict__ ticket,
     int64_t n, int64_t n_tiles, int64_t* __restrict__ idx) {
  __shared__ fugue_lse::BlockRed<kThreads> red;
  __shared__ LookBack lb;
  __shared__ uint64_t warp_tot[kWarps];
  __shared__ uint64_t tile_total;
  __shared__ int64_t tile_id;
  __shared__ int n_long;
  __shared__ int long_i[kTile];  // a long run's element, from the tile's start
  __shared__ int64_t long_a[kTile], long_b[kTile];

  // the first ticket and the parts are read at once, the tile's weights
  // are in flight while the parts merge
  if (threadIdx.x == 0) {
    tile_id = static_cast<int64_t>(atomicAdd(ticket, 1ull));
    n_long = 0;
  }
  Acc a = fugue_lse::acc_empty();
  for (int64_t j = threadIdx.x; j < n_parts; j += kThreads) {
    fugue_lse::acc_part(a, parts[j].m, parts[j].s, parts[j].nan);
  }
  __syncthreads();
  int64_t tile = tile_id;
  const bool aligned = (reinterpret_cast<uintptr_t>(lw) & 15u) == 0;
  double v[kPer];
  if (tile < n_tiles) load_run(lw, tile * kTile + int64_t(threadIdx.x) * kPer, n, aligned, v);

  // the lse: every block merges the parts in the same order
  const Acc tot = fugue_lse::block_all<kThreads>(a, red);
  if (tot.nan != 0u || !isfinite(tot.m)) {  // no weight anywhere: identity
    for (int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x; i < n;
         i += int64_t(gridDim.x) * kThreads) {
      idx[i] = i;
    }
    return;
  }
  const double lse = tot.m + log(tot.s);
  const double u0 = static_cast<double>(*u0_ptr);
  const double scale = static_cast<double>(n) * (1.0 / kFixedOne);  // exact: n 2^-60

  while (tile < n_tiles) {
    const int64_t first = tile * kTile + int64_t(threadIdx.x) * kPer;
    uint64_t q[kPer];
    uint64_t run = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      q[k] = fixed_weight(v[k], lse);
      run += q[k];
    }
    const uint64_t before = block_inclusive_scan(run, warp_tot, &tile_total) - run;
    const uint64_t agg = tile_total;
    if (threadIdx.x == 0) store_status(status + tile, (tile == 0 ? kFlagP : kFlagA) | agg);
    const uint64_t off = tile == 0 ? 0ull : look_back(status, tile, lb);
    if (threadIdx.x == 0 && tile > 0) store_status(status + tile, kFlagP | (off + agg));

    // element j owns the slots [c_{j-1}, c_j)
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
    if (gridDim.x >= n_tiles) break;  // every tile had its block
    __syncthreads();  // n_long and the list are read
    if (threadIdx.x == 0) {
      tile_id = static_cast<int64_t>(atomicAdd(ticket, 1ull));
      n_long = 0;
    }
    __syncthreads();
    tile = tile_id;
    if (tile < n_tiles) load_run(lw, tile * kTile + int64_t(threadIdx.x) * kPer, n, aligned, v);
  }
}

template <typename T>
int launch(const void* lw, const void* u0, void* scratch, void* idx, int64_t n,
           int64_t n_parts, int64_t n_emit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  Part* parts = static_cast<Part*>(scratch);
  uint64_t* status = reinterpret_cast<uint64_t*>(parts + n_parts);
  unsigned long long* ticket = reinterpret_cast<unsigned long long*>(status + n_tiles);
  const T* x = static_cast<const T*>(lw);
  lse_parts<T><<<static_cast<unsigned>(n_parts), kThreads, 0, st>>>(
      x, n, parts, status, n_tiles, ticket);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  emit<T><<<static_cast<unsigned>(n_emit), kThreads, 0, st>>>(
      x, static_cast<const T*>(u0), static_cast<const Part*>(parts), n_parts, status, ticket, n,
      n_tiles, static_cast<int64_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fugue_resample_f32(const void* lw, const void* u0, void* scratch, void* idx, int64_t n,
                       int64_t n_parts, int64_t n_emit, void* stream) {
  return launch<float>(lw, u0, scratch, idx, n, n_parts, n_emit, stream);
}

int fugue_resample_f64(const void* lw, const void* u0, void* scratch, void* idx, int64_t n,
                       int64_t n_parts, int64_t n_emit, void* stream) {
  return launch<double>(lw, u0, scratch, idx, n, n_parts, n_emit, stream);
}

}  // extern "C"
