// K12: the rank-ordered combine of a device mesh's per-shard partials.
//
// Replaces the float psum of ndt_2d_tpu/parallel/solver.py::solve_multichip
// (the LM cost, the per-node gradient and block diagonal each LM step, and
// the PCG matvec each CG iteration; solver.py:83, :92-93, :111), whose
// order is the collective's own.  Here every rank all-gathers the [S, n]
// partials of the S shards and adds them in rank order, r = 0 .. S - 1, so
// every rank holds the same bits and the replicated host loops (the LM
// accept test, the CG stop test) cannot part between ranks.
//
// What bounds it on the card: bytes.  S x n floats read once and n written,
// one add a read; at the district's shapes (S = 2, n = 9 x 50,000) 5.4 MB
// moved, about 1.6 us at 3.35 TB/s, below one launch's host side.  Design:
// the wrapper picks the launch geometry (kernels/shard_combine.py::
// geometry): 16-byte loads and stores (float4) where n % 4 == 0 and both
// pointers are 16-byte aligned, else one float a thread; a grid of a few
// blocks an SM whose threads stride over the units.  A unit's S partials
// are read with stride n (neighbouring threads on neighbouring addresses)
// and added in order from the rank-0 partial, lane by lane.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) rank_sum4(
    const float4* __restrict__ x, int S, int units, float4* __restrict__ out) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < units;
       i += gridDim.x * kThreads) {
    float4 acc = x[i];
#pragma unroll 4
    for (int r = 1; r < S; ++r) {
      const float4 v = x[(size_t)r * units + i];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    out[i] = acc;
  }
}

__global__ void __launch_bounds__(kThreads) rank_sum1(
    const float* __restrict__ x, int S, int units, float* __restrict__ out) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < units;
       i += gridDim.x * kThreads) {
    float acc = x[i];
#pragma unroll 4
    for (int r = 1; r < S; ++r) acc += x[(size_t)r * units + i];
    out[i] = acc;
  }
}

}  // namespace

// x [S, n] f32, out [n] f32:
//   out[i] = (((x[0, i] + x[1, i]) + ...) + x[S-1, i]).
// width 4 (n % 4 == 0, x and out 16-byte aligned) or 1; blocks >= 1 of
// 256 threads.
NDT2D_API int ndt2d_rank_sum(const void* x, int S, int n, int width,
                             int blocks, void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (S < 1 || n < 0 || blocks < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (width == 4) {
    if (n % 4 || reinterpret_cast<uintptr_t>(x) % 16 ||
        reinterpret_cast<uintptr_t>(out) % 16)
      return (int)cudaErrorInvalidValue;
    rank_sum4<<<blocks, kThreads, 0, st>>>(static_cast<const float4*>(x), S,
                                           n / 4, static_cast<float4*>(out));
  } else if (width == 1) {
    rank_sum1<<<blocks, kThreads, 0, st>>>(static_cast<const float*>(x), S,
                                           n, static_cast<float*>(out));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
