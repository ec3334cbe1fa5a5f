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
// moved, about 1.6 us at 3.35 TB/s.  Design: one thread an element, the S
// partials of an element read with stride n (neighbouring threads read
// neighbouring addresses), added in order from the rank-0 partial.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) rank_sum(
    const float* __restrict__ x, int S, int n, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float acc = x[i];
  for (int r = 1; r < S; ++r) acc += x[(size_t)r * n + i];
  out[i] = acc;
}

}  // namespace

// x [S, n] f32, out [n] f32: out[i] = (((x[0, i] + x[1, i]) + ...) + x[S-1, i]).
NDT2D_API int ndt2d_rank_sum(const void* x, int S, int n, void* out,
                             void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (n > 0)
    rank_sum<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        static_cast<const float*>(x), S, n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
