// K3: score of one scan at M poses against an NDT grid.
//
// Replaces the jitted XLA scoring of the JAX package:
// ndt_2d_tpu/matching/matcher.py::score_points_at_pose (-> ndt/grid.py::
// score_points -> score_at_cells) and its jax.vmap over poses,
// matcher.py::score_points_batch, the particle filter's measurement.  With
// a grid axis (G = 4, the overlapping grids, matcher.py:411-416) a beam's
// term is the mean of its G clamped Gaussians, ((((0 + s0) + s1) + s2) + s3)
// / 4, before the beams are summed; at G = 1 it is the one grid's Gaussian.
//
// What bounds it on the card: the cell gathers.  Each (pose, beam) reads one
// cell's mean, information and count (24 bytes, scattered, from a grid that
// sits in L2) and evaluates one exp; 5000 poses x 100 beams is 0.5 M of
// them.  At M = 1 (the uncorrected score of every scan) it is launch latency.
// Design: one warp per pose, kWarps poses per block.  Each block stages the
// subsampled beams once in shared memory (they are the same for every pose).
// Lane l evaluates beams l, l + 32, l + 64, ... in that order, summing from
// 0, and a fixed __shfl_down_sync tree (16, 8, 4, 2, 1) adds the lanes; the
// normalization -sum / max(used, 1) follows in the same launch.  A pose's
// score therefore depends neither on M nor on its index, and the single-pose
// entry is this kernel at M = 1: a particle's score and the scan's score at
// the same pose are the same bits.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void score_points_kernel(
    const float* __restrict__ points, const uint8_t* __restrict__ pmask,
    int P, int num_points, int max_beams, int slots,
    const float* __restrict__ poses, int M, int G,
    const float* __restrict__ origin, float cell, int W, int H,
    const float* __restrict__ mean,
    const float* __restrict__ info, const int* __restrict__ count,
    float* __restrict__ out) {
  extern __shared__ float sbeam[];  // [3, slots]: x, y, in-use flag
  float* sx = sbeam;
  float* sy = sx + slots;
  float* sv = sy + slots;
  const ndt2d::Subsample sub(num_points, max_beams);
  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    float x = 0.f, y = 0.f, v = 0.f;
    if (i < max_beams) {
      const int idx = sub.index(i, num_points, P);
      x = points[2 * idx];
      y = points[2 * idx + 1];
      v = (i < sub.used && pmask[idx]) ? 1.f : 0.f;
    }
    sx[i] = x;
    sy[i] = y;
    sv[i] = v;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (m >= M) return;  // whole warps leave together
  const float px0 = poses[3 * m], py0 = poses[3 * m + 1];
  const float c = cosf(poses[3 * m + 2]), s = sinf(poses[3 * m + 2]);
  const size_t C = (size_t)W * H;
  float acc = 0.f;
  for (int i = lane; i < slots; i += 32) {
    const float px = sx[i], py = sy[i];
    const float wx = c * px - s * py + px0;
    const float wy = s * px + c * py + py0;
    float term = 0.f;  // the beam's score: grid 0's, or the grids' mean
    for (int g = 0; g < G; ++g) {
      const float ox = origin[2 * g], oy = origin[2 * g + 1];
      const float* gmean = mean + g * C * 2;
      const float* ginfo = info + g * C * 3;
      const int ix = (int)floorf((wx - ox) / cell);
      const int iy = (int)floorf((wy - oy) / cell);
      const bool valid =
          sv[i] != 0.f && ix >= 0 && iy >= 0 && ix < W && iy < H;
      const int f = valid ? ndt2d::clampi(iy, 0, H - 1) * W +
                                ndt2d::clampi(ix, 0, W - 1)
                          : 0;
      const float qx = wx - gmean[2 * f];
      const float qy = wy - gmean[2 * f + 1];
      const float e = -0.5f * (ginfo[3 * f] * qx * qx +
                               2.f * ginfo[3 * f + 1] * qx * qy +
                               ginfo[3 * f + 2] * qy * qy);
      const float sc = expf(fminf(e, 0.f));
      const float v = (valid && count[g * C + f] >= 5) ? sc : 0.f;
      term = G == 1 ? v : term + v;
    }
    if (G > 1) term = term / (float)G;
    acc += term;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[m] = -acc / (float)max(sub.used, 1);
}

}  // namespace

// points [P,2] f32, pmask [P] u8, poses [M,3] f32; G grids: origin
// [G,2] f32, mean [G,C,2] f32, info [G,C,3] f32, count [G,C] i32 -> out
// [M] f32.
NDT2D_API int ndt2d_score_points(const void* points, const void* pmask, int P,
                                 int num_points, int max_beams,
                                 const void* poses, int M, int G,
                                 const void* origin,
                                 float cell, int W, int H, const void* mean,
                                 const void* info, const void* count,
                                 void* out, void* stream) {
  const int slots = ((max_beams + 31) / 32) * 32;
  const size_t smem = (size_t)3 * slots * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  score_points_kernel<<<(M + kWarps - 1) / kWarps, 32 * kWarps, smem,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const uint8_t*>(pmask),
      P, num_points, max_beams, slots, static_cast<const float*>(poses), M,
      G, static_cast<const float*>(origin), cell, W, H,
      static_cast<const float*>(mean), static_cast<const float*>(info),
      static_cast<const int*>(count), static_cast<float*>(out));
  return (int)cudaGetLastError();
}
