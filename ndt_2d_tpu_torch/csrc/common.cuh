// Shared device helpers of the port's kernels.
//
// Every kernel is compiled with -fmad=false and without fast math, so each
// float32 expression below rounds once per operation, in the order written:
// the same roundings as the plain-PyTorch twins and the JAX reference, which
// keeps floor() binning of boundary points in the same cell.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NDT2D_API extern "C" __attribute__((visibility("default")))

namespace ndt2d {

// Stride subsampling of a padded scan to `max_beams` slots
// (matching/matcher.py::subsample): used = min(max_beams, n),
// step = n / used, idx_i = floor(i * step), clipped into the buffer.
struct Subsample {
  int used;
  float step;

  __device__ __forceinline__ Subsample(int num_points, int max_beams) {
    used = min(max_beams, num_points);
    step = (float)num_points / (float)max(used, 1);
  }

  __device__ __forceinline__ int index(int i, int num_points,
                                       int capacity) const {
    int idx = min((int)((float)i * step), num_points - 1);
    return min(max(idx, 0), capacity - 1);
  }
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// The lattice searches' finalize (K2, K6, KB3; defined in
// candidate_scores.cu): out [R, 13] from each row's A x per partials of 12
// floats in (angle, tile) order, read from the gathered send buffers of a
// split of blk angles a rank as they lie (blk = A: one [R, A * per, 12]
// buffer, 16-byte aligned); nums [R] i32 or null (every row has `num`
// points), dths [A], dls [L] f32.
cudaError_t split_finalize(const float* gathered, int R, int A, int L,
                           int blk, int per, const int* nums, int num,
                           int max_beams, const float* dths,
                           const float* dls, float* out, cudaStream_t st);

// core/pose.py::normalize_angle in float32: t - 2 pi floor((t + pi) / 2 pi).
__device__ __forceinline__ float normalize_angle(float t) {
  constexpr float kPi = 3.14159265358979323846f;
  constexpr float kTwoPi = 6.28318530717958647692f;
  return t - kTwoPi * floorf((t + kPi) / kTwoPi);
}

}  // namespace ndt2d
