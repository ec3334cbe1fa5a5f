// K3: score of one scan at one pose against an NDT grid.
//
// Replaces the jitted XLA scoring of the JAX package:
// ndt_2d_tpu/matching/matcher.py::score_points_at_pose ->
// ndt_2d_tpu/ndt/grid.py::score_points -> score_at_cells.
//
// What bounds it on the card: launch latency.  The work is <= laser_max_beams
// (100) gathers of a cell record plus one exp each (2.0 us on an NVIDIA
// H100 80GB HBM3 at a 700 W power limit).
// Design: one block of 128 threads, one beam per thread
// (strided past 128), a fixed-shape shared-memory tree for the sum so the
// result is bitwise reproducible, and the normalization -sum / max(used, 1)
// in the same launch so the host reads one float.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void score_points_kernel(
    const float* __restrict__ points, const uint8_t* __restrict__ pmask,
    int P, int num_points, int max_beams, const float* __restrict__ pose,
    const float* __restrict__ origin, float cell, int W, int H,
    const float* __restrict__ mean, const float* __restrict__ info,
    const int* __restrict__ count, float* __restrict__ out) {
  __shared__ float partial[kThreads];
  const ndt2d::Subsample sub(num_points, max_beams);
  const float c = cosf(pose[2]), s = sinf(pose[2]);
  const float ox = origin[0], oy = origin[1];
  float acc = 0.f;
  for (int i = threadIdx.x; i < max_beams; i += kThreads) {
    const int idx = sub.index(i, num_points, P);
    const bool m = (i < sub.used) && pmask[idx];
    const float px = points[2 * idx], py = points[2 * idx + 1];
    const float wx = c * px - s * py + pose[0];
    const float wy = s * px + c * py + pose[1];
    const int ix = (int)floorf((wx - ox) / cell);
    const int iy = (int)floorf((wy - oy) / cell);
    const bool valid = m && ix >= 0 && iy >= 0 && ix < W && iy < H;
    const int f = valid ? ndt2d::clampi(iy, 0, H - 1) * W +
                              ndt2d::clampi(ix, 0, W - 1)
                        : 0;
    const float qx = wx - mean[2 * f];
    const float qy = wy - mean[2 * f + 1];
    const float e = -0.5f * (info[3 * f] * qx * qx +
                             2.f * info[3 * f + 1] * qx * qy +
                             info[3 * f + 2] * qy * qy);
    const float sc = expf(fminf(e, 0.f));
    acc += (valid && count[f] >= 5) ? sc : 0.f;
  }
  partial[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) partial[threadIdx.x] += partial[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = -partial[0] / (float)max(sub.used, 1);
}

}  // namespace

// points [P,2] f32, pmask [P] u8, pose [3] f32, origin [2] f32,
// mean [C,2] f32, info [C,3] f32, count [C] i32 -> out [1] f32.
NDT2D_API int ndt2d_score_points(const void* points, const void* pmask, int P,
                                 int num_points, int max_beams,
                                 const void* pose, const void* origin,
                                 float cell, int W, int H, const void* mean,
                                 const void* info, const void* count,
                                 void* out, void* stream) {
  score_points_kernel<<<1, kThreads, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const uint8_t*>(pmask),
      P, num_points, max_beams, static_cast<const float*>(pose),
      static_cast<const float*>(origin), cell, W, H,
      static_cast<const float*>(mean), static_cast<const float*>(info),
      static_cast<const int*>(count), static_cast<float*>(out));
  return (int)cudaGetLastError();
}
