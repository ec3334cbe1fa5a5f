// K7: Newton refinement of a match on the NDT score surface, all iterations
// in one launch.
//
// Replaces the jitted lax.scan of the JAX package:
// ndt_2d_tpu/matching/newton.py::refine_pose (-> _objective_grad_hess ->
// _objective_grad_hess_one), chained after the lattice search in
// matcher.py::match_scan (:384-393), and its jax.vmap over the rows of
// match_scan_batch_multi.  With a grid axis (G = 4, the overlapping grids,
// newton.py:52-58) the objective, gradient and Hessian are the mean of the
// grids' ((((0 + p0) + p1) + p2) + p3) / 4; at G = 1 they are the one grid's.
//
// What it computes, per row: from start = pose + K2's correction, `iters`
// damped Newton steps on f = -sum_b exp(min(-q^T L q / 2, 0)) over the
// in-grid, count >= 5, in-use beams (binned through cell_index, so it reads
// K1's mean / information / count arrays, not K2's patch table); H is damped
// by max(1e-3 tr(H) / 3 + 1e-6, 1e-6) I, the 3x3 system solved by LU with
// partial pivoting, non-finite step entries zeroed, and the displacement from
// the start clamped to one lattice step per axis; the best pose seen
// (strictly lower f) wins, the last iterate evaluated once more.  It writes
// score = best_f / max(used, 1) and correction = best - pose into the row's
// K2 output, which keeps K2's covariance.
//
// What bounds it on the card: latency.  Its bytes are tiny (~100 beams x G
// cells of 24 bytes, 11 evaluations); the work is a chain of ~11 dependent
// rounds, each a gather of the beams' cells, ten sums and a 3x3 solve.
// Design: one warp per row.  Lane l adds beams l, l + 32, ... from 0 for each
// of the ten sums (f, 3 gradient, 6 Hessian entries), a fixed shuffle tree
// (16, 8, 4, 2, 1) reduces them, and lane 0's totals are broadcast, so every
// lane runs the same damping, solve and trust clamp and holds the same pose.
// The plain-PyTorch twin (matching/newton.py) writes the same operations in
// the same order, so kernel and twin agree bitwise.  A row reads only its
// own inputs: its bits do not depend on R or on the other rows.
#include "common.cuh"
#include "solve3.cuh"

namespace {

constexpr int kSums = 10;  // sum sc, gradient (3), Hessian h11..h33 (6)

// The ten sums of one grid at pose (x, y) with cos / sin (c, s), reduced in
// the fixed lane order and broadcast to every lane of the warp.
__device__ void grid_sums(const float* sx, const float* sy, const float* sv,
                          int max_beams, const float* __restrict__ mean,
                          const float* __restrict__ info,
                          const int* __restrict__ count, float ox, float oy,
                          float cell, int W, int H, float x, float y,
                          float c, float s, float out[kSums]) {
  const int lane = threadIdx.x & 31;
  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
  for (int i = lane; i < max_beams; i += 32) {
    const float px = sx[i], py = sy[i];
    const float rx = c * px - s * py;  // R p
    const float ry = s * px + c * py;
    const float wx = rx + x;
    const float wy = ry + y;
    // ndt/grid.py::cell_index
    const int ix = (int)floorf((wx - ox) / cell);
    const int iy = (int)floorf((wy - oy) / cell);
    const bool valid = ix >= 0 && iy >= 0 && ix < W && iy < H;
    const int f =
        valid ? ndt2d::clampi(iy, 0, H - 1) * W + ndt2d::clampi(ix, 0, W - 1)
              : 0;
    const float mx = mean[2 * f], my = mean[2 * f + 1];
    const float i00 = info[3 * f], i01 = info[3 * f + 1],
                i11 = info[3 * f + 2];
    const bool ok = valid && sv[i] != 0.f && count[f] >= 5;
    const float qx = wx - mx;
    const float qy = wy - my;
    const float lqx = i00 * qx + i01 * qy;  // L q
    const float lqy = i01 * qx + i11 * qy;
    const float e = -0.5f * (qx * lqx + qy * lqy);
    const float sc = ok ? expf(fminf(e, 0.f)) : 0.f;
    const float j3x = -s * px - c * py;  // dR/dth p
    const float j3y = c * px - s * py;
    const float a3 = lqx * j3x + lqy * j3y;
    const float lj3x = i00 * j3x + i01 * j3y;  // L J_3
    const float lj3y = i01 * j3x + i11 * j3y;
    const float j33 = j3x * lj3x + j3y * lj3y;
    const float hq = -(lqx * rx + lqy * ry);  // q^T L d2q/dth2
    acc[0] += sc;
    acc[1] += sc * lqx;
    acc[2] += sc * lqy;
    acc[3] += sc * a3;
    acc[4] += sc * (-lqx * lqx + i00);
    acc[5] += sc * (-lqx * lqy + i01);
    acc[6] += sc * (-lqx * a3 + lj3x);
    acc[7] += sc * (-lqy * lqy + i11);
    acc[8] += sc * (-lqy * a3 + lj3y);
    acc[9] += sc * (-a3 * a3 + j33 + hq);
  }
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    out[k] = __shfl_sync(0xffffffffu, v, 0);
  }
}

// f, gradient and Hessian at pose p, over the G grids of a row:
// tot = (f, g0, g1, g2, h11, h12, h13, h22, h23, h33).
__device__ void objective(const float* sx, const float* sy, const float* sv,
                          int max_beams, const float* origin,
                          const float* mean, const float* info,
                          const int* count, int G, size_t C, float cell,
                          int W, int H, const float p[3], float tot[kSums]) {
  const float c = cosf(p[2]), s = sinf(p[2]);
  for (int g = 0; g < G; ++g) {
    float part[kSums];
    grid_sums(sx, sy, sv, max_beams, mean + g * C * 2, info + g * C * 3,
              count + g * C, origin[2 * g], origin[2 * g + 1], cell, W, H,
              p[0], p[1], c, s, part);
    part[0] = -part[0];  // f = -sum sc
#pragma unroll
    for (int k = 0; k < kSums; ++k)
      tot[k] = G == 1 ? part[k] : (g == 0 ? 0.f : tot[k]) + part[k];
  }
  if (G > 1) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) tot[k] = tot[k] / (float)G;
  }
}

// Grid (R), one warp a block: row r = blockIdx.x.
__global__ void newton_kernel(const float* __restrict__ origin,
                              const float* __restrict__ mean,
                              const float* __restrict__ info,
                              const int* __restrict__ count, int G,
                              float cell, int W, int H,
                              const float* __restrict__ points,
                              const uint8_t* __restrict__ pmask, int P,
                              const int* __restrict__ nums, int num,
                              int max_beams, const float* __restrict__ poses,
                              float trust_lin, float trust_ang, int iters,
                              float* __restrict__ out) {
  extern __shared__ float sbeam[];  // [3, max_beams]: x, y, in-use flag
  float* sx = sbeam;
  float* sy = sx + max_beams;
  float* sv = sy + max_beams;
  const size_t r = blockIdx.x;
  const size_t C = (size_t)W * H;
  const int num_points = nums != nullptr ? nums[r] : num;
  origin += r * G * 2;
  mean += r * G * C * 2;
  info += r * G * C * 3;
  count += r * G * C;
  points += r * P * 2;
  pmask += r * P;
  out += r * 13;
  const ndt2d::Subsample sub(num_points, max_beams);
  for (int i = threadIdx.x; i < max_beams; i += 32) {
    const int idx = sub.index(i, num_points, P);
    sx[i] = points[2 * idx];
    sy[i] = points[2 * idx + 1];
    sv[i] = (i < sub.used && pmask[idx]) ? 1.f : 0.f;
  }
  __syncwarp();

  const float pose[3] = {poses[3 * r], poses[3 * r + 1], poses[3 * r + 2]};
  const float trust[3] = {trust_lin, trust_lin, trust_ang};
  float start[3], cur[3], best[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    start[k] = pose[k] + out[1 + k];  // the lattice winner
    cur[k] = start[k];
    best[k] = start[k];
  }
  float best_f = __int_as_float(0x7f800000);  // +inf
  float tot[kSums];
  for (int it = 0; it < iters; ++it) {
    objective(sx, sy, sv, max_beams, origin, mean, info, count, G, C, cell,
              W, H, cur, tot);
    const float lam = 1e-3f * (((tot[4] + tot[7]) + tot[9]) / 3.f) + 1e-6f;
    const float d = lam < 1e-6f ? 1e-6f : lam;  // jnp.maximum, NaN kept
    float a[3][3] = {{tot[4] + d, tot[5], tot[6]},
                     {tot[5], tot[7] + d, tot[8]},
                     {tot[6], tot[8], tot[9] + d}};
    float b[3] = {tot[1], tot[2], tot[3]};
    float x[3];
    solve3(a, b, x);
    const bool better = tot[0] < best_f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float step = -x[k];
      if (!isfinite(step)) step = 0.f;
      // Trust region: within one lattice step of the start per axis.
      const float dk = (cur[k] + step) - start[k];
      const float nxt = start[k] + fminf(fmaxf(dk, -trust[k]), trust[k]);
      if (better) best[k] = cur[k];
      cur[k] = nxt;
    }
    if (better) best_f = tot[0];
  }
  // The last iterate was stepped to but not evaluated in the loop.
  objective(sx, sy, sv, max_beams, origin, mean, info, count, G, C, cell, W,
            H, cur, tot);
  if (tot[0] < best_f) {
    best_f = tot[0];
#pragma unroll
    for (int k = 0; k < 3; ++k) best[k] = cur[k];
  }
  if (threadIdx.x == 0) {
    out[0] = best_f / (float)max(sub.used, 1);
#pragma unroll
    for (int k = 0; k < 3; ++k) out[1 + k] = best[k] - pose[k];
  }
}

}  // namespace

// G grids a row: origin [R,G,2] f32, mean [R,G,C,2] f32, info [R,G,C,3]
// f32, count [R,G,C] i32; points [R,P,2] f32, pmask [R,P] u8, nums [R] i32
// (or null: every row has `num` points), poses [R,3] f32; out [R,13] f32,
// K2's rows: read (correction) and rewritten (score, correction) in place.
NDT2D_API int ndt2d_newton(const void* origin, const void* mean,
                           const void* info, const void* count, int G,
                           float cell, int W, int H, const void* points,
                           const void* pmask, int R, int P, const void* nums,
                           int num, int max_beams, const void* poses,
                           float trust_lin, float trust_ang, int iters,
                           void* out, void* stream) {
  const size_t smem = (size_t)3 * max_beams * sizeof(float);
  if (smem > 48 * 1024 || max_beams < 1) return (int)cudaErrorInvalidValue;
  newton_kernel<<<R, 32, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(origin), static_cast<const float*>(mean),
      static_cast<const float*>(info), static_cast<const int*>(count), G,
      cell, W, H, static_cast<const float*>(points),
      static_cast<const uint8_t*>(pmask), P, static_cast<const int*>(nums),
      num, max_beams, static_cast<const float*>(poses), trust_lin, trust_ang,
      iters, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
