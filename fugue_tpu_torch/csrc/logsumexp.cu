// Log-sum-exp of a 1-D vector for Hopper (sm_90a).
//
// Replaces the TPU kernel in fugue_tpu/ops/pallas_kernels.py:
//   _plogsumexp_kernel (via plogsumexp)
//
//   out = log sum_i exp(x_i)
//
// with the special values of the plain version (logsumexp_xla): any NaN
// gives NaN, else any +inf gives +inf, else all -inf gives -inf.
//
// The TPU kernel walked a sequential grid of 8192-element tiles and carried
// one running (max, sum of exp(x - max)) pair in SMEM from step to step.
// Blocks here run in parallel in no order, so the reduction has two passes:
//   1. partial_lse: n_blocks blocks, each over one contiguous chunk of x.
//      Each thread reads neighbouring elements (coalesced) and keeps an
//      online (max, sum) pair in double: a new maximum rescales the sum
//      once, any other element adds exp(x - max). Threads, then warps, then
//      the block combine pairs with the same renormalisation; the block's
//      pair and a flag word (NaN seen, +inf seen) go to scratch.
//   2. finalize: one block combines the n_blocks pairs in a fixed order and
//      writes log(sum) + max in the input type, and in double where the
//      caller asks for it (the resampling kernel takes a double lse).
// No atomics: the result is bitwise the same from run to run. The ragged
// tail is masked by the loop bound, so there is no -inf padding.
//
// What bounds it: reading x once (N * sizeof(T) bytes). Each element costs
// one double exp and a few double adds; at 4 operations per element over
// the card's FP64 peak that is about a tenth of the time x takes to read
// from HBM, so the bound is bytes. One read of x, no second pass over it
// and no max pass before the sum, is what the design does about that.
// Vectorised 16-byte loads are later work.
//
// Precision: every element is widened to double before the subtraction and
// the sums stay double to the end, so the only rounding to float32 is the
// final store (half an ulp of the result).
//
// Interface: plain C entry points for ctypes; each runs both passes on the
// given stream, allocates nothing (the caller provides a double scratch of
// 3 * n_blocks) and returns cudaGetLastError() after its launches.

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
