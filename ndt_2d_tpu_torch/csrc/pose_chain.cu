// K13: the device-resident pose chain of the pipelined paths.
//
// Replaces the pose arithmetic of the jitted XLA programs
// ndt_2d_tpu/matching/matcher.py::mapping_step_async (:657-666) and
// localization_step_async (:697-705), which keep the robot's pose on the
// device so that no host read separates two scans:
//   compose: c, s = cos(prev[2]), sin(prev[2]); th = prev[2] + delta[2]
//            pose = [prev[0] + c * delta[0] - s * delta[1],
//                    prev[1] + s * delta[0] + c * delta[1],
//                    atan2(sin(th), cos(th))]
//   apply:   new_pose = pose + correction, also written into the rolling
//            window's newest pose slot (window_append, :666) when a window
//            is given.
// The correction is read where the search leaves it: the [3] slice of K2's
// (or K6's, after K7 its refined) [13] output row.
//
// What bounds it on the card: neither bytes nor operations (a handful of
// scalar operations on 36 bytes); a launch costs its latency.  Its point is
// where it runs: one thread on the stream between the kernels of a step, so
// the host never waits for a pose.  Built with -fmad=false like every
// source, each expression rounds once per operation in the order written,
// as the twin's eager torch operations do.
#include "common.cuh"

namespace {

__global__ void compose_kernel(const float* __restrict__ prev,
                               const float* __restrict__ delta,
                               float* __restrict__ pose) {
  const float c = cosf(prev[2]), s = sinf(prev[2]);
  const float th = prev[2] + delta[2];
  pose[0] = prev[0] + c * delta[0] - s * delta[1];
  pose[1] = prev[1] + s * delta[0] + c * delta[1];
  pose[2] = atan2f(sinf(th), cosf(th));
}

__global__ void apply_kernel(const float* __restrict__ pose,
                             const float* __restrict__ correction,
                             float* __restrict__ new_pose,
                             float* __restrict__ slot) {
  const int i = threadIdx.x;
  const float v = pose[i] + correction[i];
  new_pose[i] = v;
  if (slot != nullptr) slot[i] = v;
}

}  // namespace

// prev [3] f32, delta [3] f32 -> pose [3] f32.
NDT2D_API int ndt2d_pose_compose(const void* prev, const void* delta,
                                 void* pose, void* stream) {
  compose_kernel<<<1, 1, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prev), static_cast<const float*>(delta),
      static_cast<float*>(pose));
  return (int)cudaGetLastError();
}

// pose [3] f32, correction [3] f32 -> new_pose [3] f32, and the same three
// floats into slot (the window's newest pose row) unless it is null.
NDT2D_API int ndt2d_pose_apply(const void* pose, const void* correction,
                               void* new_pose, void* slot, void* stream) {
  apply_kernel<<<1, 3, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pose), static_cast<const float*>(correction),
      static_cast<float*>(new_pose), static_cast<float*>(slot));
  return (int)cudaGetLastError();
}
