// Gaussian-plate log-likelihood and its (mu, sigma) gradient, batched over
// chains, in one value-and-grad call, for Hopper (sm_90a).
//
// Replaces the TPU kernels in fugue_tpu/ops/pallas_kernels.py:
//   _nll_fwd_kernel :310 (via _nll_pallas_fwd / pnormal_loglik_sum)  value
//   _nll_bwd_kernel :332 (via _pnormal_bwd)                          gradient
//
// Σ_i (y_i - mu)^2 is a quadratic in mu whose coefficients depend on y
// only. With m, ybar and M2 the count, mean and squared deviations of the
// finite rows of y, for each chain c (s = sigma_c, n = N):
//   S1 = m (ybar - mu_c),  S2 = M2 + m (ybar - mu_c)^2
//   value  = -0.5 S2 / s^2 - n (log s + 0.5 log 2pi)
//   dmu    = S1 / s^2
//   dsigma = S2 / s^3 - n / s
// So one read of y serves every chain and both directions, where the TPU
// kernel read y once per chain and direction.
//
// What bounds it: bytes, one read of y (N * sizeof(T)) plus 5 C values in
// and out: 20 µs at 2^24 float32 rows on 3.35 TB/s. The design keeps the
// stream full: the grid is about two 256-thread blocks per SM whatever C
// is, each thread keeps kLoads 16-byte loads in flight (float4 / double2),
// and the double arithmetic is a few operations per row, under the FP64
// rate. Two launches: partial_moments writes one (count, mean, M2, flags)
// per block; finish merges them in block order and runs the C-way epilogue.
// finish is a programmatic dependent launch: it is scheduled while
// partial_moments runs and waits for it (griddepcontrol), so the second
// launch's latency is hidden.
//
// Precision: each row is widened to double. A thread takes its kLoads
// vectors of a tile as one batch (two passes in registers) and merges it
// into its running moments with Chan's formula; warps, blocks and the
// block partials merge in a fixed tree, so no atomics and the result is
// bitwise the same run to run. The moments are of y - shift, where shift is
// the median of the finite rows among y[0], y[N/2], y[N-1]: the mean's
// rounding is then relative to |ybar - shift| and not |ybar|, which keeps
// S1's digits when the data sit far from 0; one outlier does not move it.
// M2 comes from Welford/Chan merges, never from Σd^2 - (Σd)^2/m.
//
// Non-finite rows stay out of the moments and set flags (NaN, +inf, -inf),
// as logsumexp.cu does: inf - inf inside a mean would make NaN where the
// per-row sums give +-inf. The epilogue adds (+-inf - mu) to S1 and its
// square to S2 for each sign present, and NaN makes S1 and S2 NaN, so the
// results follow the per-row formulas' IEEE rules. mu and sigma go through
// the same formulas unguarded.
//
// Layout: rows [0, head) before y's first 16-byte boundary and the ragged
// tail after the last whole vector are read as scalars by block 0, thread
// 0. The vectors between go in tiles of kThreads * kLoads vectors, tile t
// to block t % gridDim.x; in a tile, thread i reads vectors i + k kThreads.
// ops/kernels.py's _plate_partition gives the grid from the same layout.
//
// Interface: one plain C entry point per dtype for ctypes. It launches
// both kernels on the given stream, allocates nothing (the caller gives
// the outputs and a scratch of 32 bytes per block plus 8 for the shift)
// and returns the first CUDA error of its launches, or 0.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;  // 16-byte loads in flight per thread in a tile
constexpr int kMaxFinishBlocks = 1024;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr double kHalfLog2Pi = 0.91893853320467274178;  // 0.5 * log(2 pi)
constexpr unsigned kNan = 1u, kPosInf = 2u, kNegInf = 4u;

struct Moments {
  double n;        // finite rows
  double mean;     // of y - shift
  double m2;       // squared deviations from mean
  unsigned flags;  // kNan | kPosInf | kNegInf: rows outside the moments
  unsigned pad;
};
static_assert(sizeof(Moments) == 32, "the scratch holds 4 doubles per block");

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
__device__ __forceinline__ double lane_of(const double2& v, int j) {
  return j == 0 ? v.x : v.y;
}

__device__ __forceinline__ Moments no_rows() { return {0.0, 0.0, 0.0, 0u, 0u}; }

// Chan's parallel merge of b into a.
__device__ __forceinline__ Moments merge(Moments a, const Moments& b) {
  a.flags |= b.flags;
  if (b.n == 0.0) return a;
  if (a.n == 0.0) {
    a.n = b.n;
    a.mean = b.mean;
    a.m2 = b.m2;
    return a;
  }
  const double n = a.n + b.n;
  const double d = b.mean - a.mean;
  const double w = b.n / n;
  a.m2 = a.m2 + b.m2 + d * d * a.n * w;
  a.mean = a.mean + d * w;
  a.n = n;
  return a;
}

template <typename T>
__device__ __forceinline__ unsigned classify(T x) {  // 0 for a finite row
  if (isfinite(x)) return 0u;
  return isnan(x) ? kNan : (x > T(0) ? kPosInf : kNegInf);
}

// Row x of a batch, slot b: a finite row goes into d[b] and `keep`, any
// other into `flags`.
template <typename T, int K>
__device__ __forceinline__ void add_row(T x, int b, double shift, double (&d)[K],
                                        unsigned& keep, unsigned& flags) {
  const unsigned f = classify(x);
  flags |= f;
  if (f == 0u) {
    d[b] = static_cast<double>(x) - shift;
    keep |= 1u << b;
  }
}

// Moments of the d[j] whose bit is set in `keep`: two passes in registers.
template <int K>
__device__ __forceinline__ Moments batch_moments(const double (&d)[K], unsigned keep,
                                                 unsigned flags) {
  Moments r = no_rows();
  r.flags = flags;
  if (keep == 0u) return r;
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (keep >> j & 1u) s += d[j];
  const int cnt = __popc(keep);
  const double mean = s / static_cast<double>(cnt);
  double m2 = 0.0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (keep >> j & 1u) {
      const double e = d[j] - mean;
      m2 = fma(e, e, m2);
    }
  }
  r.n = static_cast<double>(cnt);
  r.mean = mean;
  r.m2 = m2;
  return r;
}

// Lane l takes lane l + o for o = 16, 8, 4, 2, 1: lane 0 ends with the
// warp's moments, in a fixed order.
__device__ __forceinline__ Moments warp_merge(Moments m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Moments b;
    b.n = __shfl_down_sync(kFullMask, m.n, o);
    b.mean = __shfl_down_sync(kFullMask, m.mean, o);
    b.m2 = __shfl_down_sync(kFullMask, m.m2, o);
    b.flags = __shfl_down_sync(kFullMask, m.flags, o);
    m = merge(m, b);
  }
  return m;
}

// The block's moments, valid in thread 0: each warp's, then warp 0 merges
// the kWarps of them the same way.
__device__ Moments block_merge(Moments m, Moments* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  m = warp_merge(m);
  if (lane == 0) smem[warp] = m;
  __syncthreads();
  if (warp == 0) m = warp_merge(lane < kWarps ? smem[lane] : no_rows());
  __syncthreads();  // smem may be reused by the caller
  return m;
}

// Median of the finite rows among y[0], y[n/2], y[n-1] (the first of them
// when two are finite); 0 when none is.
template <typename T>
__device__ double pick_shift(const T* __restrict__ y, int64_t n) {
  if (n == 0) return 0.0;
  const double a = static_cast<double>(y[0]);
  const double b = static_cast<double>(y[n / 2]);
  const double c = static_cast<double>(y[n - 1]);
  const bool fa = isfinite(a), fb = isfinite(b), fc = isfinite(c);
  if (fa && fb && fc) return fmax(fmin(a, b), fmin(fmax(a, b), c));
  return fa ? a : fb ? b : fc ? c : 0.0;
}

template <typename T>
__device__ __forceinline__ int64_t head_rows(const T* y, int64_t n) {
  constexpr int64_t kW = 16 / sizeof(T);
  const int64_t off =
      static_cast<int64_t>((reinterpret_cast<uintptr_t>(y) & 15u) / sizeof(T));
  const int64_t h = (kW - off) % kW;
  return h < n ? h : n;
}

// Loads the kLoads vectors of the tile at `base` that thread threadIdx.x
// reads; in[k] is false past the last vector.
template <typename V>
__device__ __forceinline__ void load_tile(const V* __restrict__ body, int64_t n_vec,
                                          int64_t base, V (&v)[kLoads], bool (&in)[kLoads]) {
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int64_t i = base + threadIdx.x + int64_t(k) * kThreads;
    in[k] = i < n_vec;
    if (in[k]) v[k] = __ldg(body + i);
  }
}

// One thread's batch of a tile: the moments of its finite rows. A whole
// batch whose sum is finite has only finite rows, so it skips the per-row
// checks; both paths add the same values in the same order.
template <typename T, typename V>
__device__ __forceinline__ Moments tile_moments(const V (&v)[kLoads], const bool (&in)[kLoads],
                                                double shift) {
  constexpr int kW = 16 / sizeof(T);
  constexpr int kBatch = kLoads * kW;
  double d[kBatch];
  bool whole = true;
#pragma unroll
  for (int k = 0; k < kLoads; ++k) whole = whole && in[k];
  if (whole) {
    double s = 0.0;
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      d[b] = static_cast<double>(lane_of(v[b / kW], b % kW)) - shift;
      s += d[b];
    }
    if (isfinite(s)) {
      const double mean = s / kBatch;
      double m2 = 0.0;
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const double e = d[b] - mean;
        m2 = fma(e, e, m2);
      }
      return {static_cast<double>(kBatch), mean, m2, 0u, 0u};
    }
  }
  unsigned keep = 0u, flags = 0u;
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      const int b = k * kW + j;
      d[b] = 0.0;
      if (in[k]) add_row(lane_of(v[k], j), b, shift, d, keep, flags);
    }
  }
  return batch_moments(d, keep, flags);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
partial_moments(const T* __restrict__ y, int64_t n, Moments* __restrict__ part,
                double* __restrict__ shift_out) {
  using V = typename Vec16<T>::type;
  constexpr int kW = 16 / sizeof(T);
  constexpr int64_t kTile = int64_t(kThreads) * kLoads;  // vectors
  __shared__ Moments smem[kWarps];
  // finish may start launching now; it waits for this grid to complete
  asm volatile("griddepcontrol.launch_dependents;");
  const int64_t head = head_rows(y, n);
  const int64_t n_vec = (n - head) / kW;
  const int64_t tail = head + n_vec * kW;
  const int64_t stride = int64_t(gridDim.x) * kTile;
  const V* __restrict__ body = reinterpret_cast<const V*>(y + head);

  // the first tile's loads are in flight while the shift is read
  int64_t base = int64_t(blockIdx.x) * kTile;
  V cur[kLoads];
  bool in_cur[kLoads];
  load_tile(body, n_vec, base, cur, in_cur);
  const double shift = pick_shift(y, n);

  Moments acc = no_rows();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *shift_out = shift;
    // rows [0, head) and [tail, n): fewer than kW each
    double d[2 * kW];
    unsigned keep = 0u, flags = 0u;
#pragma unroll
    for (int j = 0; j < 2 * kW; ++j) {
      const int64_t i = j < kW ? j : tail + (j - kW);
      d[j] = 0.0;
      if (j < kW ? i < head : i < n) add_row(y[i], j, shift, d, keep, flags);
    }
    acc = batch_moments(d, keep, flags);
  }

  // each tile's batch is computed while the next tile's loads are in flight
  for (; base < n_vec; base += stride) {
    V nxt[kLoads];
    bool in_nxt[kLoads];
    load_tile(body, n_vec, base + stride, nxt, in_nxt);
    acc = merge(acc, tile_moments<T>(cur, in_cur, shift));
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      cur[k] = nxt[k];
      in_cur[k] = in_nxt[k];
    }
  }
  acc = block_merge(acc, smem);
  if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
finish(const Moments* __restrict__ part, int64_t n_parts, const double* __restrict__ shift_in,
       int64_t n, const T* __restrict__ mu, const T* __restrict__ sigma,
       int64_t n_chains, T* __restrict__ value, T* __restrict__ dmu,
       T* __restrict__ dsigma) {
  __shared__ Moments smem[kWarps];
  // launched before partial_moments ends: wait for its writes
  asm volatile("griddepcontrol.wait;" ::: "memory");
  // every block merges all partials in the same order: the same totals
  Moments acc = no_rows();
  for (int64_t j = threadIdx.x; j < n_parts; j += kThreads) acc = merge(acc, part[j]);
  acc = block_merge(acc, smem);
  if (threadIdx.x == 0) smem[0] = acc;
  __syncthreads();
  const Moments tot = smem[0];
  const double shift = *shift_in;
  const double nd = static_cast<double>(n);
  for (int64_t c = int64_t(blockIdx.x) * kThreads + threadIdx.x; c < n_chains;
       c += int64_t(gridDim.x) * kThreads) {
    const double m = static_cast<double>(mu[c]);
    const double s = static_cast<double>(sigma[c]);
    double s1 = 0.0, s2 = 0.0;
    if (tot.n > 0.0) {
      const double d = (shift - m) + tot.mean;  // ybar - mu
      s1 = tot.n * d;
      s2 = tot.m2 + s1 * d;
    }
    if (tot.flags & kPosInf) {
      const double e = CUDART_INF - m;
      s1 += e;
      s2 += e * e;
    }
    if (tot.flags & kNegInf) {
      const double e = -CUDART_INF - m;
      s1 += e;
      s2 += e * e;
    }
    if (tot.flags & kNan) s1 = s2 = CUDART_NAN;
    const double q = s2 / (s * s);  // Σ z^2, z = (y - mu) / s
    value[c] = static_cast<T>(-0.5 * q - nd * (log(s) + kHalfLog2Pi));
    dmu[c] = static_cast<T>((s1 / s) / s);
    dsigma[c] = static_cast<T>(q / s - nd / s);
  }
}

template <typename T>
int launch(const void* y, const void* mu, const void* sigma, void* scratch, void* value,
           void* dmu, void* dsigma, int64_t n, int64_t n_chains, int64_t n_blocks,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Moments* part = static_cast<Moments*>(scratch);
  double* shift = reinterpret_cast<double*>(part + n_blocks);
  const T* yt = static_cast<const T*>(y);
  partial_moments<T><<<static_cast<unsigned>(n_blocks), kThreads, 0, st>>>(yt, n, part, shift);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // programmatic dependent launch: finish is scheduled while
  // partial_moments runs and waits for it in griddepcontrol.wait
  const int64_t want = (n_chains + kThreads - 1) / kThreads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(want < kMaxFinishBlocks ? want : kMaxFinishBlocks));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, finish<T>, static_cast<const Moments*>(part), n_blocks,
                           static_cast<const double*>(shift), n, static_cast<const T*>(mu),
                           static_cast<const T*>(sigma), n_chains, static_cast<T*>(value),
                           static_cast<T*>(dmu), static_cast<T*>(dsigma));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fugue_nll_value_grad_f32(const void* y, const void* mu, const void* sigma,
                             void* scratch, void* value, void* dmu, void* dsigma,
                             int64_t n, int64_t n_chains, int64_t n_blocks, void* stream) {
  return launch<float>(y, mu, sigma, scratch, value, dmu, dsigma, n, n_chains, n_blocks,
                       stream);
}

int fugue_nll_value_grad_f64(const void* y, const void* mu, const void* sigma,
                             void* scratch, void* value, void* dmu, void* dsigma,
                             int64_t n, int64_t n_chains, int64_t n_blocks, void* stream) {
  return launch<double>(y, mu, sigma, scratch, value, dmu, dsigma, n, n_chains, n_blocks,
                        stream);
}

}  // extern "C"
