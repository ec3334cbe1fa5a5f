// K13: the rolling window's append, with the corrected pose of the
// pipelined paths.
//
// Replaces the JAX package's jitted window_append
// (ndt_2d_tpu/matching/matcher.py:485-493: shift the window's poses [D,3],
// points [D,P,2], point mask [D,P] and mask [D] left by one slot and put the
// new scan in slot D-1, its mask set) and the pose arithmetic around it in
// mapping_step_async (:668-669, new_pose = pose + correction, appended) and
// localization_step_async (:699, new_pose alone):
//   v = pose + correction   (with a correction; else the given pose)
//   new_pose = v            (when asked)
//   window: slot i <- slot i + 1 for i < D-1; slot D-1 <- (v, points,
//           point_mask, true)
// The correction is read where the search leaves it: the [3] slice of K2's
// (or K6's, after K7 its refined) [13] output row.  The step's start pose
// (K13's compose, :660-664 and :691-695) is dead-reckoned inside K3's
// single-pose launch (score_points.cu), which reads it first.
//
// What bounds it on the card: launch latency.  It moves the window once
// (D x P x 9 bytes and the poses; about 46 KB at config 2's D = 10, P =
// 512) and adds three floats.  Design: the shift is in place, and it cannot
// race because every thread owns whole columns: one element index across
// all D slots (thread t: points t and point mask t, poses column t for
// t < 3, the mask for t = 3).  A thread walks its slots upward, reading
// slot i + 1 before it writes slot i, kAhead slots loaded ahead of their
// stores, so no thread reads what another writes.  Built with -fmad=false
// like every source, the three additions round as the twin's do.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kAhead = 8;  // slots of a column loaded before they are stored

// Column col[k * stride], k < D: slot i <- slot i + 1, slot D-1 <- v.
template <typename T>
__device__ __forceinline__ void shift_column(T* col, size_t stride, int D,
                                             T v) {
  for (int base = 0; base < D - 1; base += kAhead) {
    T r[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (base + k < D - 1) r[k] = col[(size_t)(base + k + 1) * stride];
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (base + k < D - 1) col[(size_t)(base + k) * stride] = r[k];
  }
  col[(size_t)(D - 1) * stride] = v;
}

__global__ void __launch_bounds__(kThreads) window_append_kernel(
    const float* __restrict__ pose, const float* __restrict__ correction,
    float* __restrict__ new_pose, float* poses, float* points,
    uint8_t* pmask, uint8_t* mask, const float* __restrict__ new_points,
    const uint8_t* __restrict__ new_pmask, int D, int P) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < 3) {
    const float v = correction != nullptr ? pose[t] + correction[t] : pose[t];
    if (new_pose != nullptr) new_pose[t] = v;
    if (D > 0) shift_column(poses + t, 3, D, v);
  }
  if (D == 0) return;
  if (t == 3) shift_column(mask, 1, D, (uint8_t)1);
  if (t < P) {
    const size_t row = (size_t)2 * P;
    shift_column(points + 2 * t, row, D, new_points[2 * t]);
    shift_column(points + 2 * t + 1, row, D, new_points[2 * t + 1]);
    shift_column(pmask + t, (size_t)P, D, new_pmask[t]);
  }
}

}  // namespace

// pose [3] f32 and correction [3] f32 or null -> v = pose + correction (or
// pose), into new_pose [3] f32 unless null.  With D > 0 the window poses
// [D,3] f32, points [D,P,2] f32, pmask [D,P] u8 and mask [D] u8 shift left
// by one slot in place and take (v, new_points [P,2] f32, new_pmask [P] u8,
// 1) in slot D-1; D = 0 leaves the window pointers unread.
NDT2D_API int ndt2d_window_append(const void* pose, const void* correction,
                                  void* new_pose, void* poses, void* points,
                                  void* pmask, void* mask,
                                  const void* new_points,
                                  const void* new_pmask, int D, int P,
                                  void* stream) {
  const int n = D > 0 ? (P > 4 ? P : 4) : 3;
  window_append_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pose), static_cast<const float*>(correction),
      static_cast<float*>(new_pose), static_cast<float*>(poses),
      static_cast<float*>(points), static_cast<uint8_t*>(pmask),
      static_cast<uint8_t*>(mask), static_cast<const float*>(new_points),
      static_cast<const uint8_t*>(new_pmask), D, P);
  return (int)cudaGetLastError();
}
