// K9's motion sample of one particle, shared by its own launch
// (particle_filter.cu::pf_motion: the mesh's filter step and
// ParticleFilter.update) and by K3's particle launch that folds it in
// (score_points.cu::particle_kernel: the filter's step on one device): one
// body, so both write the same bits.
//
// It replaces the per-particle half of the JAX package's
// ndt_2d_tpu/filter/motion_model.py::sample (:49-57): the rot-trans-rot
// step with the noise scaled by the sigmas, cos and sin of the first
// heading, and the angle wrap, expression for expression in that order.
// The six scalars (filter/motion_model.py::motion_scalars) come from the
// host, the standard normals from the filter's generator.
#pragma once

#include "common.cuh"

namespace ndt2d {

// (rot1, trans, rot2, sigma_rot1, sigma_trans, sigma_rot2) of one step.
struct Motion {
  float rot1, trans, rot2, s_rot1, s_trans, s_rot2;
};

// in [3] and noise [3] of one particle -> out [3].
__device__ __forceinline__ void motion_sample(const float* in,
                                              const float* noise,
                                              const Motion& m, float out[3]) {
  const float r1 = m.rot1 + noise[0] * m.s_rot1;
  const float t = m.trans + noise[1] * m.s_trans;
  const float r2 = m.rot2 + noise[2] * m.s_rot2;
  const float a = in[2] + r1;
  out[0] = in[0] + t * cosf(a);
  out[1] = in[1] + t * sinf(a);
  out[2] = normalize_angle(a + r2);
}

}  // namespace ndt2d
