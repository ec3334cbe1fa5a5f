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
// in-grid, count >= 5, in-use beams (binned through cell_index); H is damped
// by max(1e-3 tr(H) / 3 + 1e-6, 1e-6) I, the 3x3 system solved by LU with
// partial pivoting, non-finite step entries zeroed, and the displacement from
// the start clamped to one lattice step per axis; the best pose seen
// (strictly lower f) wins, the last iterate evaluated once more.  It writes
// score = best_f / max(used, 1) and correction = best - pose into the row's
// K2 output, which keeps K2's covariance.
//
// What bounds it on the card: latency.  Its bytes are tiny (~100 beams x G
// cells of 32 bytes, 11 evaluations); the work is a chain of ~11 dependent
// rounds, each a gather of the beams' cells, ten sums and a 3x3 solve.
// Design: a block a row of G x S warps, S = the beams' 32-beam strides (at
// most 4; above that a warp takes every S-th stride).  Warp (g, s) computes
// the ten terms (f, 3 gradient, 6 Hessian entries) of beams l + 32 (s + S j)
// on grid g, reading each beam's cell as one 32-byte record of K1's packed
// table (mean, information, the count >= 5 flag: the first 8 floats of table
// row f), and stages them in shared memory; then warp (g, s) takes the sums
// k = s, s + S, ...: its lane l adds beams l, l + 32, ... of each in beam
// order from 0, and their (16, 8, 4, 2, 1) shuffle trees run interleaved.
// Shared memory broadcasts the grids' totals; they add in grid order, and
// the damping, the solve and the clamp follow (at G = 1 in every thread, on
// the same values, so that no second broadcast waits on one thread; at G = 4
// in warp 0, which broadcasts the pose, so that sixteen warps do not contend
// for the schedulers over one serial chain).  So each sum keeps the order of
// the one-warp-a-row design it replaced: the plain-PyTorch twin
// (matching/newton.py) writes the same operations in the same order, and
// kernel and twin agree bitwise.  A row reads only its own inputs: its bits
// do not depend on R or on the other rows.
#include "common.cuh"
#include "solve3.cuh"

namespace {

constexpr int kSums = 10;  // sum sc, gradient (3), Hessian h11..h33 (6)
constexpr int kMaxStrides = 4;  // warps a grid (kernels/newton.py)

// The ten terms of beam (px, py) at pose (x, y, c, s) on one grid, its cell
// read from the grid's packed table [C, 32] (the arithmetic of
// matching/newton.py::_grid_sums).
__device__ __forceinline__ void beam_terms(float px, float py, bool in_use,
                                           const float* __restrict__ table,
                                           float ox, float oy, float cell,
                                           int W, int H, float x, float y,
                                           float c, float s,
                                           float t[kSums]) {
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
  const float4* rec = reinterpret_cast<const float4*>(table + (size_t)f * 32);
  const float4 lo = __ldg(rec), hi = __ldg(rec + 1);
  const float mx = lo.x, my = lo.y;
  const float i00 = lo.z, i01 = lo.w, i11 = hi.x;
  const bool ok = valid && in_use && hi.y != 0.f;  // count >= 5
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
  t[0] = sc;
  t[1] = sc * lqx;
  t[2] = sc * lqy;
  t[3] = sc * a3;
  t[4] = sc * (-lqx * lqx + i00);
  t[5] = sc * (-lqx * lqy + i01);
  t[6] = sc * (-lqx * a3 + lj3x);
  t[7] = sc * (-lqy * lqy + i11);
  t[8] = sc * (-lqy * a3 + lj3y);
  t[9] = sc * (-a3 * a3 + j33 + hq);
}

// Grid (R), G x S warps a block: row r = blockIdx.x, warp s G + g.  Dynamic
// shared memory: the beams (x, y, in-use) [3, max_beams], the staged terms
// [G, kSums, 32 S], the grids' totals [G, kSums] and the pose broadcast.
template <int S, bool kOneGrid>
__global__ void newton_block(const float* __restrict__ origin,
                             const float* __restrict__ table, int G,
                             float cell, int W, int H,
                             const float* __restrict__ points,
                             const uint8_t* __restrict__ pmask, int P,
                             const int* __restrict__ nums, int num,
                             int max_beams, const float* __restrict__ poses,
                             float trust_lin, float trust_ang, int iters,
                             float* __restrict__ out) {
  constexpr int kPerWarp = (kSums + S - 1) / S;  // sums a warp adds
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + max_beams;
  float* sv = sy + max_beams;
  const int chunk = 32 * S;
  float* terms = sv + max_beams;
  float* parts = terms + G * kSums * chunk;
  float* pose_b = parts + G * kSums;  // x, y, cos, sin (above one grid)
  // Warp w is (g, s) = (w % G, w / G).
  const int lane = threadIdx.x & 31;
  const int g = (threadIdx.x >> 5) % G;
  const int sw = (threadIdx.x >> 5) / G;
  const size_t r = blockIdx.x;
  const size_t C = (size_t)W * H;
  const int num_points = nums != nullptr ? nums[r] : num;
  origin += r * G * 2;
  table += r * G * C * 32;
  points += r * P * 2;
  pmask += r * P;
  out += r * 13;
  const ndt2d::Subsample sub(num_points, max_beams);
  for (int i = threadIdx.x; i < max_beams; i += blockDim.x) {
    const int idx = sub.index(i, num_points, P);
    sx[i] = points[2 * idx];
    sy[i] = points[2 * idx + 1];
    sv[i] = (i < sub.used && pmask[idx]) ? 1.f : 0.f;
  }
  const float* gtable = table + (size_t)g * C * 32;
  const float ox = origin[2 * g], oy = origin[2 * g + 1];
  float* gterms = terms + g * kSums * chunk;

  // The iteration: at G = 1 every thread runs it on the same values once
  // the totals are shared (no second broadcast); above, warp 0 runs it
  // and shared memory broadcasts the pose, so that the block's many warps
  // do not contend for the schedulers over one serial chain.
  const bool steps = kOneGrid || threadIdx.x < 32;
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
  if (!kOneGrid && threadIdx.x == 0) {
    pose_b[0] = cur[0];
    pose_b[1] = cur[1];
    pose_b[2] = cosf(cur[2]);
    pose_b[3] = sinf(cur[2]);
  }
  __syncthreads();

  for (int it = 0;; ++it) {
    // f, gradient and Hessian at cur: grid g's sums, warp (g, s) adding
    // the sums k = s, s + S, ... (acc[j]: sum s + S j; a k past the ten
    // repeats sum 9, whose copy is not kept).
    float x = cur[0], y = cur[1], c, s;
    if (kOneGrid) {
      c = cosf(cur[2]);
      s = sinf(cur[2]);
    } else {
      x = pose_b[0];
      y = pose_b[1];
      c = pose_b[2];
      s = pose_b[3];
    }
    float acc[kPerWarp];
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) acc[j] = 0.f;
    for (int base = 0; base < max_beams; base += chunk) {
      const int i = base + 32 * sw + lane;
      float t[kSums];
      if (i < max_beams) {
        beam_terms(sx[i], sy[i], sv[i] != 0.f, gtable, ox, oy, cell, W, H,
                   x, y, c, s, t);
      } else {
#pragma unroll
        for (int k = 0; k < kSums; ++k) t[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < kSums; ++k)
        gterms[k * chunk + 32 * sw + lane] = t[k];
      __syncthreads();
      // Lane l's beams of this chunk, l + 32 m, in beam order (all loaded
      // first, then added).
      float st[S][kPerWarp];
#pragma unroll
      for (int m = 0; m < S; ++m) {
#pragma unroll
        for (int j = 0; j < kPerWarp; ++j)
          st[m][j] =
              gterms[min(sw + S * j, kSums - 1) * chunk + 32 * m + lane];
      }
#pragma unroll
      for (int m = 0; m < S; ++m) {
        if (base + 32 * m < max_beams) {
#pragma unroll
          for (int j = 0; j < kPerWarp; ++j) acc[j] += st[m][j];
        }
      }
      if (base + chunk < max_beams) __syncthreads();  // before the next
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < kPerWarp; ++j)
        acc[j] += __shfl_down_sync(0xffffffffu, acc[j], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kPerWarp; ++j)
        if (sw + S * j < kSums) parts[g * kSums + sw + S * j] = acc[j];
    }
    __syncthreads();
    if (steps) {
      // objective(): the grids' totals in grid order, then their mean.
      float tot[kSums];
      for (int gg = 0; gg < G; ++gg) {
        float part[kSums];
#pragma unroll
        for (int k = 0; k < kSums; ++k) part[k] = parts[gg * kSums + k];
        part[0] = -part[0];  // f = -sum sc
#pragma unroll
        for (int k = 0; k < kSums; ++k)
          tot[k] = kOneGrid ? part[k] : (gg == 0 ? 0.f : tot[k]) + part[k];
      }
      if (!kOneGrid) {
#pragma unroll
        for (int k = 0; k < kSums; ++k) tot[k] = tot[k] / (float)G;
      }
      if (it == iters) {
        // The last iterate was stepped to but not evaluated in the loop.
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
      } else {
        const float lam =
            1e-3f * (((tot[4] + tot[7]) + tot[9]) / 3.f) + 1e-6f;
        const float d = lam < 1e-6f ? 1e-6f : lam;  // jnp.maximum, NaN kept
        float a[3][3] = {{tot[4] + d, tot[5], tot[6]},
                         {tot[5], tot[7] + d, tot[8]},
                         {tot[6], tot[8], tot[9] + d}};
        float b[3] = {tot[1], tot[2], tot[3]};
        float xs[3];
        solve3(a, b, xs);
        const bool better = tot[0] < best_f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float step = -xs[k];
          if (!isfinite(step)) step = 0.f;
          // Trust region: within one lattice step of the start per axis.
          const float dk = (cur[k] + step) - start[k];
          const float nxt = start[k] + fminf(fmaxf(dk, -trust[k]), trust[k]);
          if (better) best[k] = cur[k];
          cur[k] = nxt;
        }
        if (better) best_f = tot[0];
        if (!kOneGrid && threadIdx.x == 0) {
          pose_b[0] = cur[0];
          pose_b[1] = cur[1];
          pose_b[2] = cosf(cur[2]);
          pose_b[3] = sinf(cur[2]);
        }
      }
    }
    if (it == iters) break;
    if (!kOneGrid) __syncthreads();
  }
}

}  // namespace

// G grids a row: origin [R,G,2] f32, table [R,G,C,32] f32 (K1's packed
// tables; row f starts with cell f's record); points [R,P,2] f32, pmask
// [R,P] u8, nums [R] i32 (or null: every row has `num` points), poses [R,3]
// f32; S warps a grid (newton.py::plan); out [R,13] f32, K2's rows: read
// (correction) and rewritten (score, correction) in place.
NDT2D_API int ndt2d_newton(const void* origin, const void* table, int G,
                           float cell, int W, int H, const void* points,
                           const void* pmask, int R, int P, const void* nums,
                           int num, int max_beams, int S, const void* poses,
                           float trust_lin, float trust_ang, int iters,
                           void* out, void* stream) {
  const size_t smem = ((size_t)3 * max_beams + (size_t)G * kSums * 32 * S +
                       (size_t)G * kSums + 4) * sizeof(float);
  if (smem > 48 * 1024 || max_beams < 1 || S < 1 || S > kMaxStrides ||
      G < 1 || G * S * 32 > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto run = [&](auto kernel) {
    kernel<<<R, 32 * G * S, smem, st>>>(
        static_cast<const float*>(origin), static_cast<const float*>(table),
        G, cell, W, H, static_cast<const float*>(points),
        static_cast<const uint8_t*>(pmask), P, static_cast<const int*>(nums),
        num, max_beams, static_cast<const float*>(poses), trust_lin,
        trust_ang, iters, static_cast<float*>(out));
  };
  const bool one = G == 1;
  switch (S) {
    case 1: one ? run(newton_block<1, true>) : run(newton_block<1, false>);
      break;
    case 2: one ? run(newton_block<2, true>) : run(newton_block<2, false>);
      break;
    case 3: one ? run(newton_block<3, true>) : run(newton_block<3, false>);
      break;
    default: one ? run(newton_block<4, true>) : run(newton_block<4, false>);
  }
  return (int)cudaGetLastError();
}

