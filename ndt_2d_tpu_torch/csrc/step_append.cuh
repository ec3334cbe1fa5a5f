// KB4's body, shared by its own launch (slam_step.cu) and by the fused
// step's K12 finalize that folds it in (candidate_scores.cu::finalize with
// an Append): one body, so both write the same bits.
//
// It replaces the state update of the JAX package's fused step,
// ndt_2d_tpu/parallel/slam_step.py::make_slam_step (:99-124): the corrected
// pose (est_pose + the match's correction when a prior scan exists), the
// scan written into slot i of the padded [S, 3] poses, [S, P, 2] points and
// [S, P] mask, the odometry constraint of core/constraint.py::
// make_constraint (the relative transform of the corrected pose in the
// previous pose's frame, core/pose.py::relative, and the inverse of the
// match's covariance) written into constraint slot j, and prev_pose set to
// the corrected pose.  The pose and constraint math runs on one thread in
// the twin's order (core/constraint.py; the inverse is solve3 of each
// column of the identity, LU with partial pivoting, matching/newton.py::
// solve3); the scan's copy is spread over the block's other threads.
#pragma once

#include "common.cuh"
#include "solve3.cuh"

namespace {

// The fused step's state (parallel/slam_step.py::SlamState), updated in
// place: poses [S,3], points [S,P,2] f32, pmask [S,P] u8, c_begin / c_end
// [C] i32, c_transform [C,3], c_info [C,3,3], prev [3] f32.  Its tensors
// never move, so kernels/slam_step.py::SlamPlan packs it once.
struct StepState {
  float* poses;
  float* points;
  uint8_t* pmask;
  int* c_begin;
  int* c_end;
  float* c_transform;
  float* c_info;
  float* prev;
  int P;
};

// One step's inputs: slot i of the scans, j of the constraints (host ints,
// in range), whether a prior scan exists, the constraint's begin id; the
// dead-reckoned pose est [3] and the scan (points [P,2] f32, mask [P] u8).
struct StepInputs {
  int has_prior, i, j, begin_id;
  const float* est;
  const float* scan_points;
  const uint8_t* scan_mask;
};

// Thread t of n copies the scan's points and mask into slot i.
__device__ __forceinline__ void step_copy_scan(const StepState& st,
                                               const StepInputs& in, int t,
                                               int n) {
  const int P = st.P;
  for (int k = t; k < P; k += n) {
    st.points[((size_t)in.i * P + k) * 2] = in.scan_points[2 * k];
    st.points[((size_t)in.i * P + k) * 2 + 1] = in.scan_points[2 * k + 1];
    st.pmask[(size_t)in.i * P + k] = in.scan_mask[k];
  }
}

// One thread: the corrected pose from the match's correction corr [3] and
// covariance cov [9] (row-major), the constraint into slot j, the pose into
// slot i and prev.
__device__ __forceinline__ void step_constraint(const StepState& st,
                                                const StepInputs& in,
                                                const float corr[3],
                                                const float cov[9]) {
  const float* est = in.est;
  float* prev = st.prev;
  const int j = in.j;
  float pose[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    pose[k] = in.has_prior ? est[k] + corr[k] : est[k];
  // core/pose.py::relative(prev, pose): R(-prev_theta) (pose - prev)_xy,
  // theta the raw difference.
  const float nt = -prev[2];
  const float c = cosf(nt), s = sinf(nt);
  const float dx = pose[0] - prev[0], dy = pose[1] - prev[1];
  st.c_transform[3 * j] = c * dx - s * dy;
  st.c_transform[3 * j + 1] = s * dx + c * dy;
  st.c_transform[3 * j + 2] = pose[2] - prev[2];
  // The information matrix: the covariance's inverse, column by column.
  for (int col = 0; col < 3; ++col) {
    float a[3][3], b[3], x[3];
    for (int r = 0; r < 3; ++r) {
      for (int q = 0; q < 3; ++q) a[r][q] = cov[3 * r + q];
      b[r] = r == col ? 1.f : 0.f;
    }
    solve3(a, b, x);
    for (int r = 0; r < 3; ++r) st.c_info[9 * j + 3 * r + col] = x[r];
  }
  st.c_begin[j] = in.begin_id;
  st.c_end[j] = in.i;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    st.poses[3 * in.i + k] = pose[k];
    prev[k] = pose[k];
  }
}

}  // namespace
