// KB4: the fused multichip SLAM step's append, in one launch.
//
// Replaces the jitted state update of the JAX package's fused step,
// ndt_2d_tpu/parallel/slam_step.py::make_slam_step (:99-124); what it
// computes is step_append.cuh's (the corrected pose, the scan into slot i,
// the odometry constraint into slot j, prev_pose).  Slots i and j and
// has_prior are host ints (the host issues every step and knows its
// counts), so nothing is read back.
//
// What bounds it on the card: launch latency and the host's side of the
// launch.  It moves one scan (P x 12 bytes) and a few dozen floats.
// Design: one block; its threads copy the scan's points and mask, thread 0
// does the pose and constraint math (step_append.cuh).  The entry reads
// the state's pointers from a StepState packed once (kernels/slam_step.py::
// SlamPlan), so a call passes the slots and the step's own pointers only.
// Where the fused step's search is K12's split K2 with nothing between it
// and the append, the append rides in the search's finalize instead
// (candidate_scores.cu, ndt2d_candidate_finalize_append) and this kernel
// does not launch.
#include "step_append.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) slam_append(
    StepState st, StepInputs in, const float* __restrict__ corr,
    const float* __restrict__ cov) {
  step_copy_scan(st, in, threadIdx.x, kThreads);
  if (threadIdx.x != 0) return;
  float c[3], v[9];
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = corr[k];
#pragma unroll
  for (int k = 0; k < 9; ++k) v[k] = cov[k];
  step_constraint(st, in, c, v);
}

}  // namespace

// *state the fused step's StepState, updated in place; has_prior, slot i of
// the scans and j of the constraints (host ints, in range), the
// constraint's begin id; est [3], corr [3], cov [3,3] f32 (the match's
// correction and covariance), scan_points [P,2] f32, scan_mask [P] u8.
NDT2D_API int ndt2d_slam_append(const void* state, int has_prior, int i,
                                int j, int begin_id, const void* est,
                                const void* corr, const void* cov,
                                const void* scan_points,
                                const void* scan_mask, void* stream) {
  const StepInputs in = {has_prior, i, j, begin_id,
                         static_cast<const float*>(est),
                         static_cast<const float*>(scan_points),
                         static_cast<const uint8_t*>(scan_mask)};
  slam_append<<<1, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      *static_cast<const StepState*>(state), in,
      static_cast<const float*>(corr), static_cast<const float*>(cov));
  return (int)cudaGetLastError();
}

// sizeof(StepState), for the ctypes mirror's check.
NDT2D_API int ndt2d_slam_plan_size() { return (int)sizeof(StepState); }
