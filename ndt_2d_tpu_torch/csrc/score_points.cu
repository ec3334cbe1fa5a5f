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
// subsampled beams in shared memory, at most kChunk at a time (they are the
// same for every pose).  Lane l evaluates beams l, l + 32, l + 64, ... in
// that order, summing from 0, and a fixed __shfl_down_sync tree (16, 8, 4,
// 2, 1) adds the lanes; the normalization -sum / max(used, 1) follows in the
// same launch.  A pose's score therefore depends neither on M nor on its
// index, and the single-pose entry is this kernel at M = 1: a particle's
// score and the scan's score at the same pose are the same bits.
//
// KB2, the stripe scores: one device's share of the scoring against a
// y-stripe-sharded map, ndt_2d_tpu/parallel/ndt_blocks.py::
// score_points_sharded (:88-113) and score_particles_sharded_map
// (:116-166), is this kernel on the grid rows [row0, row0 + h) with raw = 1
// (the dense grid is row0 = 0, h = H).  A beam counts only when its GLOBAL
// bin (against the map's origin) lies in those rows; it reads the stripe's
// cell (iy - row0) * W + ix.  raw = 1 writes -sum without the division: the
// stripes' partials are added in rank order first (K12's rank_sum) and the
// caller divides by max(used, 1) after, as JAX psums then divides.  Given
// world points are scored at the identity pose with num_points = max_beams
// = P, so every point counts, in order.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kChunk = 1024;  // most beams staged in shared memory at once

__global__ void score_points_kernel(
    const float* __restrict__ points, const uint8_t* __restrict__ pmask,
    int P, int num_points, int max_beams, int slots, int chunk,
    const float* __restrict__ poses, int M, int G,
    const float* __restrict__ origin, float cell, int W, int row0, int h,
    const float* __restrict__ mean,
    const float* __restrict__ info, const int* __restrict__ count,
    int raw, float* __restrict__ out) {
  extern __shared__ float sbeam[];  // [3, chunk]: x, y, in-use flag
  float* sx = sbeam;
  float* sy = sx + chunk;
  float* sv = sy + chunk;
  const ndt2d::Subsample sub(num_points, max_beams);
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = m < M;  // whole warps; every thread stages beams
  float px0 = 0.f, py0 = 0.f, c = 1.f, s = 0.f;
  if (active) {
    px0 = poses[3 * m];
    py0 = poses[3 * m + 1];
    c = cosf(poses[3 * m + 2]);
    s = sinf(poses[3 * m + 2]);
  }
  const size_t C = (size_t)W * h;
  float acc = 0.f;
  for (int base = 0; base < slots; base += chunk) {
    const int n = min(chunk, slots - base);
    __syncthreads();  // every warp is done with the previous chunk
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int i = base + j;
      float x = 0.f, y = 0.f, v = 0.f;
      if (i < max_beams) {
        const int idx = sub.index(i, num_points, P);
        x = points[2 * idx];
        y = points[2 * idx + 1];
        v = (i < sub.used && pmask[idx]) ? 1.f : 0.f;
      }
      sx[j] = x;
      sy[j] = y;
      sv[j] = v;
    }
    __syncthreads();
    if (!active) continue;
    for (int j = lane; j < n; j += 32) {
      const float px = sx[j], py = sy[j];
      const float wx = c * px - s * py + px0;
      const float wy = s * px + c * py + py0;
      float term = 0.f;  // the beam's score: grid 0's, or the grids' mean
      for (int g = 0; g < G; ++g) {
        const float ox = origin[2 * g], oy = origin[2 * g + 1];
        const float* gmean = mean + g * C * 2;
        const float* ginfo = info + g * C * 3;
        const int ix = (int)floorf((wx - ox) / cell);
        const int iy = (int)floorf((wy - oy) / cell);
        const bool valid = sv[j] != 0.f && ix >= 0 && ix < W &&
                           iy >= row0 && iy < row0 + h;
        const int f = valid ? (iy - row0) * W + ix : 0;
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
  }
  if (!active) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[m] = raw ? -acc : -acc / (float)max(sub.used, 1);
}

}  // namespace

// points [P,2] f32, pmask [P] u8, poses [M,3] f32; G grids holding the rows
// [row0, row0 + h) of a W-wide map: origin [G,2] f32 (the map's), mean
// [G,h*W,2] f32, info [G,h*W,3] f32, count [G,h*W] i32 -> out [M] f32:
// -sum / max(used, 1), or the raw -sum when raw != 0.
NDT2D_API int ndt2d_score_points(const void* points, const void* pmask, int P,
                                 int num_points, int max_beams,
                                 const void* poses, int M, int G,
                                 const void* origin, float cell, int W,
                                 int row0, int h, const void* mean,
                                 const void* info, const void* count, int raw,
                                 void* out, void* stream) {
  const int slots = ((max_beams + 31) / 32) * 32;
  const int chunk = slots < kChunk ? (slots > 32 ? slots : 32) : kChunk;
  const size_t smem = (size_t)3 * chunk * sizeof(float);
  score_points_kernel<<<(M + kWarps - 1) / kWarps, 32 * kWarps, smem,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const uint8_t*>(pmask),
      P, num_points, max_beams, slots, chunk,
      static_cast<const float*>(poses), M, G,
      static_cast<const float*>(origin), cell, W, row0, h,
      static_cast<const float*>(mean), static_cast<const float*>(info),
      static_cast<const int*>(count), raw, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
