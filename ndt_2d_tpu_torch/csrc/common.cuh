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

// core/pose.py::normalize_angle in float32: t - 2 pi floor((t + pi) / 2 pi).
__device__ __forceinline__ float normalize_angle(float t) {
  constexpr float kPi = 3.14159265358979323846f;
  constexpr float kTwoPi = 6.28318530717958647692f;
  return t - kTwoPi * floorf((t + kPi) / kTwoPi);
}

}  // namespace ndt2d
