// Normal log-density of data shared by C rows, each row with its own scalar
// loc and scale, and its (loc, scale) gradient, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package leaves the same expression,
// Normal.log_prob at fugue_tpu/core/distributions.py:198, to XLA's fusion
// under jit. Eager PyTorch under vmap(grad_and_value) runs it as six
// (C, N) elementwise ops forward and a dozen backward, each a pass over
// device memory. Here (z = (y_i - loc_c) / scale_c):
//   normal_plane       out[c, i] = -z^2 / 2 - log scale_c - log(2 pi) / 2
//   normal_plane_grad  dloc[c]   = sum_i g[c, i] z / scale_c
//                      dscale[c] = sum_i g[c, i] (z^2 - 1) / scale_c
// for the cotangent g of the plane, read through its row stride.
//
// What bounds them: bytes. The forward writes the plane once (4 C N bytes
// in float32: 524 MB, 156.5 us at C = 131,072, N = 1,000 on 3.35 TB/s);
// the backward reads g once, the same bytes. y (N values) and loc and
// scale (C each) are small beside them. So neither kernel saves or reads
// anything else of size C N: the backward recomputes z.
//
// Design. A block of kThreads threads holds a tile of y (kTile elements)
// in shared memory and walks rows, one warp per row, row r of the grid's
// stride to warp (r mod kWarps) of block (r / kWarps mod gridDim.x). A
// warp moves its row in 16-byte vectors (float4, double2), lane l taking
// vectors l, l + 32, ...; the backward's lanes keep kLoads vectors in
// flight, add in the row's precision and reduce with warp shuffles in a
// fixed order, so a result is the same from run to run. A row's first
// 16-byte boundary may sit anywhere (N need not be a multiple of the
// vector, and g comes with its own stride), so the tile is held in kW
// copies, copy r shifted by r elements: for a row with h elements before
// its boundary, copy (kW - h) mod kW puts y at the same offset in its
// vector, and each vector of y is one aligned 16-byte read of shared
// memory. The h head elements and the ragged tail go one per lane. Per
// row, 1 / scale and log scale + log(2 pi) / 2 are computed once. With N
// above kTile the forward takes one tile per blockIdx.y; the backward
// walks the tiles in order inside the block for each group of kWarps rows,
// restaging each tile, so its sums keep their order.
//
// Interface: one plain C entry point per dtype and kernel for ctypes. Each
// launches on the given stream, allocates nothing and returns the CUDA
// error of its launch, or 0. ops/kernels.py's _plane_blocks gives the grid
// from the same constants.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;  // elements of y a block holds (in kW copies)
constexpr int kLoads = 4;    // 16-byte loads in flight per lane in the backward
constexpr unsigned kFullMask = 0xffffffffu;
constexpr double kHalfLog2Pi = 0.91893853320467274178;  // 0.5 * log(2 pi)

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

__device__ __forceinline__ float log_of(float x) { return logf(x); }
__device__ __forceinline__ double log_of(double x) { return log(x); }

// elements of T in one 16-byte vector
template <typename T>
__host__ __device__ constexpr int width() { return 16 / static_cast<int>(sizeof(T)); }

// One element of the plane, and a vector of them.
template <typename T>
__device__ __forceinline__ T density(T y, T m, T inv, T k) {
  const T z = (y - m) * inv;
  return fma(T(-0.5) * z, z, -k);
}
__device__ __forceinline__ float4 density(float4 y, float m, float inv, float k) {
  return make_float4(density(y.x, m, inv, k), density(y.y, m, inv, k),
                     density(y.z, m, inv, k), density(y.w, m, inv, k));
}
__device__ __forceinline__ double2 density(double2 y, double m, double inv, double k) {
  return make_double2(density(y.x, m, inv, k), density(y.y, m, inv, k));
}

// One element's terms of the backward's two sums, and a vector's.
template <typename T>
__device__ __forceinline__ void add_terms(T g, T y, T m, T inv, T& a1, T& a2) {
  const T z = (y - m) * inv;
  a1 = fma(g, z, a1);
  a2 = fma(g, fma(z, z, T(-1)), a2);
}
__device__ __forceinline__ void add_terms(float4 g, float4 y, float m, float inv, float& a1,
                                          float& a2) {
  add_terms(g.x, y.x, m, inv, a1, a2);
  add_terms(g.y, y.y, m, inv, a1, a2);
  add_terms(g.z, y.z, m, inv, a1, a2);
  add_terms(g.w, y.w, m, inv, a1, a2);
}
__device__ __forceinline__ void add_terms(double2 g, double2 y, double m, double inv,
                                          double& a1, double& a2) {
  add_terms(g.x, y.x, m, inv, a1, a2);
  add_terms(g.y, y.y, m, inv, a1, a2);
}

// Elements of one copy of the tile in shared memory: a tile of `tile`
// elements shifted by up to kW - 1, rounded up to whole vectors.
template <typename T>
__host__ __device__ constexpr int copy_len(int tile) {
  return (tile + 2 * width<T>() - 2) / width<T>() * width<T>();
}

// Elements before the first 16-byte boundary at or after p, at most len.
template <typename T>
__device__ __forceinline__ int head_of(const T* p, int len) {
  constexpr int kW = width<T>();
  const int off = static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15u) / sizeof(T));
  const int h = (kW - off) % kW;
  return h < len ? h : len;
}

// y[t0, t0 + len) into the kW shifted copies: copy r holds y[t0 + i] at
// ys[r * lc + r + i].
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ y, int64_t t0, int len,
                                           T* ys, int lc) {
  constexpr int kW = width<T>();
#pragma unroll
  for (int r = 0; r < kW; ++r)
    for (int i = threadIdx.x; i < len; i += kThreads) ys[r * lc + r + i] = y[t0 + i];
}

// The copy of the tile whose vectors line up with a row that has `head`
// elements before its first boundary: element i of the tile at [i].
template <typename T>
__device__ __forceinline__ const T* aligned_copy(const T* ys, int lc, int head) {
  constexpr int kW = width<T>();
  const int r = (kW - head) % kW;
  return ys + r * lc + r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
plane_fwd(const T* __restrict__ y, const T* __restrict__ loc, const T* __restrict__ scale,
          T* __restrict__ out, int64_t n, int64_t rows) {
  using V = typename Vec16<T>::type;
  constexpr int kW = width<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ys = reinterpret_cast<T*>(smem_raw);
  const int64_t t0 = int64_t(blockIdx.y) * kTile;
  const int len = static_cast<int>(n - t0 < kTile ? n - t0 : kTile);
  const int lc = copy_len<T>(n < kTile ? static_cast<int>(n) : kTile);
  stage_tile(y, t0, len, ys, lc);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t stride = int64_t(gridDim.x) * kWarps;
  for (int64_t c = int64_t(blockIdx.x) * kWarps + (threadIdx.x >> 5); c < rows; c += stride) {
    const T m = loc[c];
    const T inv = T(1) / scale[c];
    const T k = log_of(scale[c]) + static_cast<T>(kHalfLog2Pi);
    T* row = out + c * n + t0;
    const int head = head_of(row, len);
    const int n_vec = (len - head) / kW;
    const T* yc = aligned_copy(ys, lc, head);
    V* body = reinterpret_cast<V*>(row + head);
    const V* yv = reinterpret_cast<const V*>(yc + head);
    for (int v = lane; v < n_vec; v += 32) body[v] = density(yv[v], m, inv, k);
    // the head before the first boundary and the ragged tail: fewer than
    // kW elements each
    const int tail = head + n_vec * kW;
    const int i = lane < kW ? lane : tail + lane - kW;
    if (lane < kW ? i < head : (lane < 2 * kW && i < len)) row[i] = density(yc[i], m, inv, k);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
plane_bwd(const T* __restrict__ g, int64_t g_stride, const T* __restrict__ y,
          const T* __restrict__ loc, const T* __restrict__ scale, T* __restrict__ dloc,
          T* __restrict__ dscale, int64_t n, int64_t rows) {
  using V = typename Vec16<T>::type;
  constexpr int kW = width<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ys = reinterpret_cast<T*>(smem_raw);
  const int n_tiles = static_cast<int>((n + kTile - 1) / kTile);
  const int lc = copy_len<T>(n < kTile ? static_cast<int>(n) : kTile);
  if (n_tiles == 1) {
    stage_tile(y, 0, static_cast<int>(n), ys, lc);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int64_t n_groups = (rows + kWarps - 1) / kWarps;
  // the loop runs the same number of times in every thread of the block
  for (int64_t grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    const int64_t c = grp * kWarps + (threadIdx.x >> 5);
    const bool live = c < rows;
    const T m = live ? loc[c] : T(0);
    const T s = live ? scale[c] : T(1);
    const T inv = T(1) / s;
    T a1 = T(0), a2 = T(0);  // sum g z, sum g (z^2 - 1)
    for (int t = 0; t < n_tiles; ++t) {
      const int64_t t0 = int64_t(t) * kTile;
      const int len = static_cast<int>(n - t0 < kTile ? n - t0 : kTile);
      if (n_tiles > 1) {
        __syncthreads();  // every warp is done with the last tile
        stage_tile(y, t0, len, ys, lc);
        __syncthreads();
      }
      if (!live) continue;
      const T* row = g + c * g_stride + t0;
      const int head = head_of(row, len);
      const int n_vec = (len - head) / kW;
      const T* yc = aligned_copy(ys, lc, head);
      const V* body = reinterpret_cast<const V*>(row + head);
      const V* yv = reinterpret_cast<const V*>(yc + head);
      for (int v0 = lane; v0 < n_vec; v0 += 32 * kLoads) {
        V gv[kLoads];
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
          const int v = v0 + 32 * k;
          if (v < n_vec) gv[k] = __ldcs(body + v);
        }
#pragma unroll
        for (int k = 0; k < kLoads; ++k)
          if (v0 + 32 * k < n_vec) add_terms(gv[k], yv[v0 + 32 * k], m, inv, a1, a2);
      }
      const int tail = head + n_vec * kW;
      const int i = lane < kW ? lane : tail + lane - kW;
      if (lane < kW ? i < head : (lane < 2 * kW && i < len)) add_terms(row[i], yc[i], m, inv, a1, a2);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a1 += __shfl_down_sync(kFullMask, a1, o);
      a2 += __shfl_down_sync(kFullMask, a2, o);
    }
    if (live && lane == 0) {
      dloc[c] = a1 / s;
      dscale[c] = a2 / s;
    }
  }
}

template <typename T>
size_t smem_bytes(int64_t n) {
  return sizeof(T) * width<T>() * copy_len<T>(n < kTile ? static_cast<int>(n) : kTile);
}

template <typename T>
int launch_fwd(const void* y, const void* loc, const void* scale, void* out, int64_t n,
               int64_t rows, int64_t n_blocks, void* stream) {
  const dim3 grid(static_cast<unsigned>(n_blocks), static_cast<unsigned>((n + kTile - 1) / kTile));
  plane_fwd<T><<<grid, kThreads, smem_bytes<T>(n), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(loc), static_cast<const T*>(scale),
      static_cast<T*>(out), n, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* g, int64_t g_stride, const void* y, const void* loc,
               const void* scale, void* dloc, void* dscale, int64_t n, int64_t rows,
               int64_t n_blocks, void* stream) {
  plane_bwd<T><<<static_cast<unsigned>(n_blocks), kThreads, smem_bytes<T>(n),
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), g_stride, static_cast<const T*>(y),
      static_cast<const T*>(loc), static_cast<const T*>(scale), static_cast<T*>(dloc),
      static_cast<T*>(dscale), n, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fugue_normal_plane_f32(const void* y, const void* loc, const void* scale, void* out,
                           int64_t n, int64_t rows, int64_t n_blocks, void* stream) {
  return launch_fwd<float>(y, loc, scale, out, n, rows, n_blocks, stream);
}

int fugue_normal_plane_f64(const void* y, const void* loc, const void* scale, void* out,
                           int64_t n, int64_t rows, int64_t n_blocks, void* stream) {
  return launch_fwd<double>(y, loc, scale, out, n, rows, n_blocks, stream);
}

int fugue_normal_plane_grad_f32(const void* g, int64_t g_stride, const void* y,
                                const void* loc, const void* scale, void* dloc, void* dscale,
                                int64_t n, int64_t rows, int64_t n_blocks, void* stream) {
  return launch_bwd<float>(g, g_stride, y, loc, scale, dloc, dscale, n, rows, n_blocks, stream);
}

int fugue_normal_plane_grad_f64(const void* g, int64_t g_stride, const void* y,
                                const void* loc, const void* scale, void* dloc, void* dscale,
                                int64_t n, int64_t rows, int64_t n_blocks, void* stream) {
  return launch_bwd<double>(g, g_stride, y, loc, scale, dloc, dscale, n, rows, n_blocks,
                            stream);
}

}  // extern "C"
