// Log-sum-exp of a 1-D vector for Hopper (sm_90a).
//
// Replaces the TPU kernel in fugue_tpu/ops/pallas_kernels.py:
//   _plogsumexp_kernel :83 (via plogsumexp)
//
//   out = log sum_i exp(x_i)
//
// with the special values of the plain version (logsumexp_xla): any NaN
// gives NaN, else any +inf gives +inf, else all -inf gives -inf. There is
// no -inf padding: the ragged edges are masked.
//
// The TPU kernel walked a sequential grid of 8192-element tiles and carried
// one running (max, sum of exp(x - max)) pair in SMEM from step to step.
// Blocks here run in parallel in no order. The reduction is lse_reduce.cuh's
// over the whole card: about two 256-thread blocks per SM, or one 16-byte
// vector per thread where there are fewer (SMC's 131,072 float32 particles:
// 128 blocks), 16-byte loads, kLoads of them in flight per thread, each
// batch's maximum taken in registers before its independent exps, and a
// block merge that rescales each thread's sum once (no exp per shuffle
// round). Two launches:
//   1. lse_partial writes each block's (m, s, nan) part to scratch;
//   2. lse_finish, one block, merges the parts in block order and writes
//      the result. It is a programmatic dependent launch: scheduled while
//      lse_partial runs, it waits for it in griddepcontrol.wait, so its
//      launch latency is hidden.
// One launch was tried and is slower at SMC's size (PERF.md; the
// designs are in scripts/smc_kernel_variants.py): a single thread-block
// cluster merging through distributed shared memory (16 SMs' FP64 units
// for the exps), and the full grid whose last block, chosen by an atomic
// ticket, merges (a fence and an atomic round trip per block).
// Nothing outlives a call: scratch is the caller's, every word of it is
// written before it is read, so back-to-back calls, graph replays and calls
// on two streams at once are all safe.
//
// What bounds it: reading x once (N * sizeof(T) bytes), 0.16 us at 131,072
// float32 on 3.35 TB/s, far under the fixed cost of a launch; each element
// costs one double exp (a few dozen FP64 instructions). The design keeps
// every load in flight at once, spreads the exps over every SM, and keeps
// the merges off the FP64 pipe (one exp per thread and per part).
//
// Precision: every element is widened to double before the subtraction and
// the sums stay double to the end, so the only rounding to float32 is the
// final store (half an ulp of the result). The merge order is fixed and no
// atomic touches a sum, so the result is bitwise the same run to run.
//
// Interface: plain C entry points for ctypes; each launches both kernels on
// the given stream, allocates nothing (the caller gives a scratch of 24
// bytes per block of lse_partial) and returns the first CUDA error of its
// launches, or 0.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "lse_reduce.cuh"

namespace {

using fugue_lse::Acc;
using fugue_lse::Part;

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
lse_partial(const T* __restrict__ x, int64_t n, Part* __restrict__ parts) {
  __shared__ fugue_lse::BlockRed<kThreads> red;
  // lse_finish may start launching now; it waits for this grid to complete
  asm volatile("griddepcontrol.launch_dependents;");
  const Acc t = fugue_lse::block_all<kThreads>(
      fugue_lse::thread_acc<T, kThreads>(x, n, gridDim.x), red);
  if (threadIdx.x == 0) parts[blockIdx.x] = Part{t.m, t.s, t.nan, 0u};
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lse_finish(const Part* __restrict__ parts, int64_t n_parts, T* __restrict__ out) {
  __shared__ fugue_lse::BlockRed<kThreads> red;
  // launched before lse_partial ends: wait for its parts
  asm volatile("griddepcontrol.wait;" ::: "memory");
  Acc a = fugue_lse::acc_empty();
  for (int64_t j = threadIdx.x; j < n_parts; j += kThreads) {
    fugue_lse::acc_part(a, parts[j].m, parts[j].s, parts[j].nan);
  }
  const Acc tot = fugue_lse::block_all<kThreads>(a, red);
  if (threadIdx.x == 0) *out = static_cast<T>(fugue_lse::lse_of(tot));
}

template <typename T>
int launch(const void* x, void* scratch, void* out, int64_t n, int64_t n_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Part* parts = static_cast<Part*>(scratch);
  lse_partial<T><<<static_cast<unsigned>(n_blocks), kThreads, 0, st>>>(
      static_cast<const T*>(x), n, parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // programmatic dependent launch: lse_finish is scheduled while
  // lse_partial runs and waits for it in griddepcontrol.wait
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lse_finish<T>, static_cast<const Part*>(parts), n_blocks,
                           static_cast<T*>(out));
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
