// Gaussian-plate log-likelihood and its (mu, sigma) gradient, batched over
// chains, for Hopper (sm_90a).
//
// Replaces the TPU kernels in fugue_tpu/ops/pallas_kernels.py:
//   _nll_fwd_kernel (via _nll_pallas_fwd / pnormal_loglik_sum)  forward
//   _nll_bwd_kernel (via _pnormal_bwd)                          backward
//
// For each chain c, with y (N,) shared by all chains:
//   fwd:  out[c]    = -0.5 * S2 / s^2 - N * (log s + 0.5 log 2pi)
//   bwd:  dmu[c]    = S1 / s^2
//         dsigma[c] = S2 / s^3 - N / s
// where S1 = sum_i (y_i - mu_c), S2 = sum_i (y_i - mu_c)^2 and s = sigma_c.
//
// The TPU kernel ran once per chain, walked a sequential grid of 8192-element
// tiles and carried the running sum in SMEM from one grid step to the next.
// Blocks here run in parallel in no order, so the reduction has two passes:
//   1. partial_sums: grid (C, n_blocks). Block (c, b) takes the b-th
//      contiguous chunk of y, each thread reads neighbouring elements
//      (coalesced) and accumulates in double; the block total goes to
//      scratch[c, b]. Chains vary fastest in the block order, so the blocks
//      resident at one time read the same chunk of y and share it in L2.
//   2. finalize_*: one block per chain sums its n_blocks partials in a fixed
//      order and applies the -N(log s + 0.5 log 2pi) term.
// No atomics, so a result is the same from run to run. The ragged tail is
// masked by the loop bound: no padding and no padding correction.
//
// What bounds it: reading y. One pass over y per chain: C * N * sizeof(T)
// bytes, mostly from L2 when y (4 MB at N = 2^20 in f32) is shared by the
// chains of one launch. The double arithmetic (3 flops/element) stays well
// under the card's FP64 rate. Making it fast (one read of each y tile for all
// chains, TMA, fused value-and-grad) is later work.
//
// Precision: every element is widened to double before the subtraction, and
// the sums stay double to the end, so the only float32 rounding is the final
// store. Against a float64 reference the float32 result is off by at most
// half an ulp of |out| (plus the float32 rounding of mu and sigma, which both
// versions share). The plain float32 PyTorch version also rounds every
// element and every partial sum, so its error is at least as large.
//
// Interface: plain C entry points for ctypes, one per direction; each runs
// both passes on the given stream, allocates nothing (the caller provides
// outputs and a double scratch of C * n_blocks, twice that for bwd) and
// returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr double kHalfLog2Pi = 0.91893853320467274178;  // 0.5 * log(2 pi)

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Block total, valid in thread 0. `smem` holds one slot per warp.
__device__ double block_sum(double v, double* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = (threadIdx.x < (blockDim.x >> 5)) ? smem[threadIdx.x] : 0.0;
  if (warp == 0) v = warp_sum(v);
  __syncthreads();  // smem may be reused by the caller
  return v;
}

template <typename T, bool kWithS1>
__global__ void __launch_bounds__(kThreads)
partial_sums(const T* __restrict__ y, const T* __restrict__ mu, int64_t n,
             int64_t n_blocks, int64_t chunk, double* __restrict__ s2,
             double* __restrict__ s1) {
  __shared__ double smem[kThreads / 32];
  const int64_t c = blockIdx.x;
  const int64_t b = blockIdx.y;
  const double m = static_cast<double>(mu[c]);
  const int64_t lo = b * chunk;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  double a2 = 0.0;
  double a1 = 0.0;
#pragma unroll 4
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    const double d = static_cast<double>(y[i]) - m;
    a2 = fma(d, d, a2);
    if (kWithS1) a1 += d;
  }
  a2 = block_sum(a2, smem);
  if (kWithS1) a1 = block_sum(a1, smem);
  if (threadIdx.x == 0) {
    s2[c * n_blocks + b] = a2;
    if (kWithS1) s1[c * n_blocks + b] = a1;
  }
}

__device__ double chain_total(const double* __restrict__ part, int64_t n_blocks,
                              double* smem) {
  double a = 0.0;
  for (int64_t j = threadIdx.x; j < n_blocks; j += kThreads) a += part[j];
  return block_sum(a, smem);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
finalize_fwd(const double* __restrict__ s2, const T* __restrict__ sigma,
             int64_t n, int64_t n_blocks, T* __restrict__ out) {
  __shared__ double smem[kThreads / 32];
  const int64_t c = blockIdx.x;
  const double a2 = chain_total(s2 + c * n_blocks, n_blocks, smem);
  if (threadIdx.x == 0) {
    const double s = static_cast<double>(sigma[c]);
    out[c] = static_cast<T>(-0.5 * a2 / (s * s) -
                            static_cast<double>(n) * (log(s) + kHalfLog2Pi));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
finalize_bwd(const double* __restrict__ s2, const double* __restrict__ s1,
             const T* __restrict__ sigma, int64_t n, int64_t n_blocks,
             T* __restrict__ dmu, T* __restrict__ dsigma) {
  __shared__ double smem[kThreads / 32];
  const int64_t c = blockIdx.x;
  const double a2 = chain_total(s2 + c * n_blocks, n_blocks, smem);
  const double a1 = chain_total(s1 + c * n_blocks, n_blocks, smem);
  if (threadIdx.x == 0) {
    const double s = static_cast<double>(sigma[c]);
    dmu[c] = static_cast<T>(a1 / (s * s));
    dsigma[c] = static_cast<T>(a2 / (s * s * s) - static_cast<double>(n) / s);
  }
}

inline int64_t chunk_of(int64_t n, int64_t n_blocks) {
  return (n + n_blocks - 1) / n_blocks;
}

template <typename T>
int launch_fwd(const void* y, const void* mu, const void* sigma, void* scratch,
               void* out, int64_t n, int64_t n_chains, int64_t n_blocks,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* s2 = static_cast<double*>(scratch);
  dim3 grid1(static_cast<unsigned>(n_chains), static_cast<unsigned>(n_blocks));
  partial_sums<T, false><<<grid1, kThreads, 0, st>>>(
      static_cast<const T*>(y), static_cast<const T*>(mu), n, n_blocks,
      chunk_of(n, n_blocks), s2, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finalize_fwd<T><<<static_cast<unsigned>(n_chains), kThreads, 0, st>>>(
      s2, static_cast<const T*>(sigma), n, n_blocks, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* y, const void* mu, const void* sigma, void* scratch,
               void* dmu, void* dsigma, int64_t n, int64_t n_chains,
               int64_t n_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* s2 = static_cast<double*>(scratch);
  double* s1 = s2 + n_chains * n_blocks;
  dim3 grid1(static_cast<unsigned>(n_chains), static_cast<unsigned>(n_blocks));
  partial_sums<T, true><<<grid1, kThreads, 0, st>>>(
      static_cast<const T*>(y), static_cast<const T*>(mu), n, n_blocks,
      chunk_of(n, n_blocks), s2, s1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finalize_bwd<T><<<static_cast<unsigned>(n_chains), kThreads, 0, st>>>(
      s2, s1, static_cast<const T*>(sigma), n, n_blocks, static_cast<T*>(dmu),
      static_cast<T*>(dsigma));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fugue_nll_fwd_f32(const void* y, const void* mu, const void* sigma,
                      void* scratch, void* out, int64_t n, int64_t n_chains,
                      int64_t n_blocks, void* stream) {
  return launch_fwd<float>(y, mu, sigma, scratch, out, n, n_chains, n_blocks,
                           stream);
}

int fugue_nll_fwd_f64(const void* y, const void* mu, const void* sigma,
                      void* scratch, void* out, int64_t n, int64_t n_chains,
                      int64_t n_blocks, void* stream) {
  return launch_fwd<double>(y, mu, sigma, scratch, out, n, n_chains, n_blocks,
                            stream);
}

int fugue_nll_bwd_f32(const void* y, const void* mu, const void* sigma,
                      void* scratch, void* dmu, void* dsigma, int64_t n,
                      int64_t n_chains, int64_t n_blocks, void* stream) {
  return launch_bwd<float>(y, mu, sigma, scratch, dmu, dsigma, n, n_chains,
                           n_blocks, stream);
}

int fugue_nll_bwd_f64(const void* y, const void* mu, const void* sigma,
                      void* scratch, void* dmu, void* dsigma, int64_t n,
                      int64_t n_chains, int64_t n_blocks, void* stream) {
  return launch_bwd<double>(y, mu, sigma, scratch, dmu, dsigma, n, n_chains,
                            n_blocks, stream);
}

}  // extern "C"
