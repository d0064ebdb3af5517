// The log-sum-exp reduction shared by logsumexp.cu and
// systematic_resample.cu (whose first pass is this reduction).
//
// A value set reduces to (m, s, nan): m the largest value that is not NaN
// (+inf included), s = sum of exp(v - m) over the finite values, nan
// whether any value was NaN. Its log-sum-exp is NaN if nan, else +inf if
// m = +inf, else -inf if m = -inf (nothing finite), else m + log(s); the
// plain version's special values. Everything is in double: each element is
// widened before the subtraction, the sums stay double, and the only
// rounding to float32 is the caller's final store.
//
// Layout over x (n elements of T): rows [0, head) before x's first 16-byte
// boundary and [head + n_vec * kW, n) after its last whole vector are read
// as scalars by thread 0 of block 0; the n_vec 16-byte vectors between go
// to the grid's threads, global thread g taking vectors g, g + S, g + 2S,
// ... (S threads in the grid), kLoads at a time: all kLoads loads are
// issued, then the batch's maximum is taken in registers, then its exps,
// which do not depend on each other. ops/kernels.py's _vector_layout and
// _lse_partition give the same layout and grid.
//
// Merges run in a fixed order: a thread folds its batches in sequence; a
// block takes the maximum, rescales each thread's sum once and adds the
// warps' sums in warp order; parts fold in index order. No atomics touch a
// sum, so a result is bitwise the same from run to run.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace fugue_lse {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kLoads = 2;  // 16-byte loads in flight per thread in a batch

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

__device__ __forceinline__ double lane_of(const float4& v, int j) {
  return static_cast<double>(j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w);
}
__device__ __forceinline__ double lane_of(const double2& v, int j) {
  return j == 0 ? v.x : v.y;
}

// Elements of x before its first 16-byte boundary (at most n).
template <typename T>
__device__ __forceinline__ int64_t head_elems(const T* x, int64_t n) {
  constexpr int64_t kW = 16 / sizeof(T);
  const int64_t off = static_cast<int64_t>((reinterpret_cast<uintptr_t>(x) & 15u) / sizeof(T));
  const int64_t h = (kW - off) % kW;
  return h < n ? h : n;
}

struct Acc {
  double m;      // largest non-NaN value seen, -inf for none
  double s;      // sum of exp(v - m) over the finite values
  unsigned nan;  // 1 if a NaN was seen
};

// A block's or a thread's reduction in scratch or shared memory.
struct Part {
  double m;
  double s;
  unsigned nan;
  unsigned pad;
};
static_assert(sizeof(Part) == 24, "a part is three 8-byte words");

__device__ __forceinline__ Acc acc_empty() { return {-CUDART_INF, 0.0, 0u}; }

// Folds a batch of K values (in[k] false: value k absent) into a: the
// batch's maximum first, one rescale of a.s if it rises, then the exps.
template <int K>
__device__ __forceinline__ void acc_batch(Acc& a, const double (&v)[K], const bool (&in)[K]) {
  double bm = -CUDART_INF;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (in[k]) {
      a.nan |= isnan(v[k]) ? 1u : 0u;
      bm = fmax(bm, v[k]);  // fmax skips NaN
    }
  }
  if (bm > a.m) {  // exp(-inf) = 0 empties a sum taken against -inf or below +inf
    a.s *= exp(a.m - bm);
    a.m = bm;
  }
  if (isfinite(a.m)) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (in[k] && v[k] < CUDART_INF) a.s += exp(v[k] - a.m);  // NaN fails v < inf
    }
  }
}

// Folds one part into a (the same rules as a batch of one value, with a
// sum attached).
__device__ __forceinline__ void acc_part(Acc& a, double m, double s, unsigned nan) {
  a.nan |= nan;
  if (m > a.m) {
    a.s = a.s * exp(a.m - m) + s;
    a.m = m;
  } else if (isfinite(a.m) && m > -CUDART_INF) {
    a.s += s * exp(m - a.m);
  }
}

__device__ __forceinline__ double lse_of(const Acc& a) {
  if (a.nan) return CUDART_NAN;
  if (!isfinite(a.m)) return a.m;  // +inf, or -inf for nothing finite
  return a.m + log(a.s);
}

// Shared memory for block_all.
template <int kBlock>
struct BlockRed {
  double m[kBlock / 32];
  double s[kBlock / 32];
  unsigned nan[kBlock / 32];
};

// The block's reduction, in every thread: the maximum, then each thread's
// sum rescaled once to it, then the warp sums added in warp order.
template <int kBlock>
__device__ Acc block_all(Acc a, BlockRed<kBlock>& red) {
  constexpr int kWarps = kBlock / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  double m = a.m;
  unsigned nan = a.nan;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m = fmax(m, __shfl_xor_sync(kFullMask, m, o));
    nan |= __shfl_xor_sync(kFullMask, nan, o);
  }
  if (lane == 0) {
    red.m[warp] = m;
    red.nan[warp] = nan;
  }
  __syncthreads();
  Acc t{red.m[0], 0.0, red.nan[0]};
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    t.m = fmax(t.m, red.m[w]);
    t.nan |= red.nan[w];
  }
  double s = (isfinite(t.m) && a.m > -CUDART_INF) ? a.s * exp(a.m - t.m) : 0.0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFullMask, s, o);
  if (lane == 0) red.s[warp] = s;  // lane 0's sum: a fixed order
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t.s += red.s[w];
  __syncthreads();  // red may be reused
  return t;
}

// This thread's reduction over its share of x under the layout above, in a
// grid of n_blocks blocks of kBlock threads.
template <typename T, int kBlock>
__device__ Acc thread_acc(const T* __restrict__ x, int64_t n, int64_t n_blocks) {
  using V = typename Vec16<T>::type;
  constexpr int kW = 16 / sizeof(T);
  const int64_t head = head_elems(x, n);
  const int64_t n_vec = (n - head) / kW;
  const int64_t tail = head + n_vec * kW;
  const V* __restrict__ body = reinterpret_cast<const V*>(x + head);
  const int64_t g = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  const int64_t stride = n_blocks * kBlock;
  Acc a = acc_empty();
  for (int64_t base = g; base < n_vec; base += stride * kLoads) {
    V vec[kLoads];
    bool vin[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int64_t i = base + k * stride;
      vin[k] = i < n_vec;
      vec[k] = vin[k] ? __ldg(body + i) : V{};
    }
    double v[kLoads * kW];
    bool in[kLoads * kW];
#pragma unroll
    for (int b = 0; b < kLoads * kW; ++b) {
      v[b] = lane_of(vec[b / kW], b % kW);
      in[b] = vin[b / kW];
    }
    acc_batch(a, v, in);
  }
  if (g == 0) {  // the scalar rows: fewer than kW before, fewer than kW after
    double v[2 * kW];
    bool in[2 * kW];
#pragma unroll
    for (int j = 0; j < 2 * kW; ++j) {
      const int64_t i = j < kW ? j : tail + (j - kW);
      in[j] = j < kW ? i < head : i < n;
      v[j] = in[j] ? static_cast<double>(x[i]) : 0.0;
    }
    acc_batch(a, v, in);
  }
  return a;
}

}  // namespace fugue_lse
