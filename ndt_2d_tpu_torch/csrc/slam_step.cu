// KB4: the fused multichip SLAM step's append, in one launch.
//
// Replaces the jitted state update of the JAX package's fused step,
// ndt_2d_tpu/parallel/slam_step.py::make_slam_step (:99-124): the corrected
// pose (est_pose + the match's correction when a prior scan exists), the
// scan written into slot i of the padded [S, 3] poses, [S, P, 2] points and
// [S, P] mask, the odometry constraint of core/constraint.py::
// make_constraint (the relative transform of the corrected pose in the
// previous pose's frame, core/pose.py::relative, and the inverse of the
// match's covariance) written into constraint slot j, and prev_pose set to
// the corrected pose.  Slots i and j and has_prior are host ints (the host
// issues every step and knows its counts), so nothing is read back.
//
// What bounds it on the card: launch latency.  It moves one scan (P x 12
// bytes) and a few dozen floats.  Design: one block; its threads copy the
// scan's points and mask, thread 0 does the pose and constraint math in the
// twin's order (core/constraint.py; the inverse is solve3 of each column of
// the identity, LU with partial pivoting, matching/newton.py::solve3).
#include "common.cuh"
#include "solve3.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) slam_append(
    const float* __restrict__ est, const float* __restrict__ corr,
    const float* __restrict__ cov, int has_prior, int i, int j,
    int begin_id, const float* __restrict__ scan_points,
    const uint8_t* __restrict__ scan_mask, int P, float* __restrict__ poses,
    float* __restrict__ points, uint8_t* __restrict__ pmask,
    int* __restrict__ c_begin, int* __restrict__ c_end,
    float* __restrict__ c_transform, float* __restrict__ c_info,
    float* __restrict__ prev) {
  for (int k = threadIdx.x; k < P; k += kThreads) {
    points[((size_t)i * P + k) * 2] = scan_points[2 * k];
    points[((size_t)i * P + k) * 2 + 1] = scan_points[2 * k + 1];
    pmask[(size_t)i * P + k] = scan_mask[k];
  }
  if (threadIdx.x != 0) return;
  float pose[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) pose[k] = has_prior ? est[k] + corr[k] : est[k];
  // core/pose.py::relative(prev, pose): R(-prev_theta) (pose - prev)_xy,
  // theta the raw difference.
  const float nt = -prev[2];
  const float c = cosf(nt), s = sinf(nt);
  const float dx = pose[0] - prev[0], dy = pose[1] - prev[1];
  c_transform[3 * j] = c * dx - s * dy;
  c_transform[3 * j + 1] = s * dx + c * dy;
  c_transform[3 * j + 2] = pose[2] - prev[2];
  // The information matrix: the covariance's inverse, column by column.
  for (int col = 0; col < 3; ++col) {
    float a[3][3], b[3], x[3];
    for (int r = 0; r < 3; ++r) {
      for (int q = 0; q < 3; ++q) a[r][q] = cov[3 * r + q];
      b[r] = r == col ? 1.f : 0.f;
    }
    solve3(a, b, x);
    for (int r = 0; r < 3; ++r) c_info[9 * j + 3 * r + col] = x[r];
  }
  c_begin[j] = begin_id;
  c_end[j] = i;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    poses[3 * i + k] = pose[k];
    prev[k] = pose[k];
  }
}

}  // namespace

// est [3], corr [3], cov [3,3] f32 (the match's correction and covariance),
// scan_points [P,2] f32, scan_mask [P] u8; state, updated in place: poses
// [S,3], points [S,P,2] f32, pmask [S,P] u8, c_begin / c_end [C] i32,
// c_transform [C,3], c_info [C,3,3], prev [3] f32.  Slot i of the scans and
// j of the constraints (host ints, in range).
NDT2D_API int ndt2d_slam_append(const void* est, const void* corr,
                                const void* cov, int has_prior, int i, int j,
                                int begin_id, const void* scan_points,
                                const void* scan_mask, int P, void* poses,
                                void* points, void* pmask, void* c_begin,
                                void* c_end, void* c_transform, void* c_info,
                                void* prev, void* stream) {
  slam_append<<<1, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(est), static_cast<const float*>(corr),
      static_cast<const float*>(cov), has_prior, i, j, begin_id,
      static_cast<const float*>(scan_points),
      static_cast<const uint8_t*>(scan_mask), P, static_cast<float*>(poses),
      static_cast<float*>(points), static_cast<uint8_t*>(pmask),
      static_cast<int*>(c_begin), static_cast<int*>(c_end),
      static_cast<float*>(c_transform), static_cast<float*>(c_info),
      static_cast<float*>(prev));
  return (int)cudaGetLastError();
}
