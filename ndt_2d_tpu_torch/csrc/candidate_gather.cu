// K6: exhaustive 3-DoF candidate scoring over a lattice WIDER than one NDT
// cell, with its argmin + Olson reduction.
//
// Replaces the jitted XLA general path of the JAX package,
// ndt_2d_tpu/matching/matcher.py::_candidate_scores_gather ->
// reduce_candidates -> finalize_match, which candidate_scores picks when
// 2 * search_linear_size > ndt_resolution: the coarse stage of the
// coarse-to-fine loop-closure confirmation (about 21 angles x 41 x 41
// offsets of 0.1 m on 0.5 m cells) and the full-heading coarse search of
// the map merge (126 angles).  With a row axis it is the jax.vmap of
// match_scan in match_scan_batch_multi_coarse_fine; with a grid axis
// (G = 4, overlapping grids, matcher.py:194-202) every candidate's beam
// sum is taken per grid and the candidate score is their mean
// ((((0 + p0) + p1) + p2) + p3) / 4 before the argmin and the Olson sums;
// at G = 1 the score is the one grid's sum.
//
// What it computes: for every candidate (angle a, dx, dy), the negated sum
// over the subsampled beams of exp(min(-q^T Lambda q / 2, 0)) against the
// cell the rotated, shifted beam itself falls in (floor((w - origin) /
// cell), masked when that cell lies outside the grid or holds < 5 points);
// then the first-index argmin in (angle, dx, dy) order, the correction
// (applied only when the best score is < 0) and the Olson covariance
// K/s + u u^T / s^2, with the weak isotropic fallback when s == 0.  The
// output rows [R, 13] are K2's, so K7 chains after either.
//
// Cell records: the first 8 floats of a row of K1's [C, 32] patch table
// are the cell's own record (mean_x, mean_y, i00, i01, i11, scorable), so
// the kernel reads K1's table as K2 does, two float4 loads a (candidate,
// beam).
//
// What bounds it on the card: operations.  A x L x L x B = 3.5e6
// (candidate, beam) terms a row at the coarse shape, each a division, a
// floor, a 32-byte gather that the L1/L2 caches serve (the beams of one
// row reach a few thousand cells) and an exp: about 30 operations.  The
// XLA program materializes [A, L, L, B] intermediates in device memory;
// here nothing but the per-block partials leaves the SM.  Design: one
// block per (tile of 256 offsets, angle, row), one thread per (dx, dy).
// K2's one-block-per-angle launch cannot hold 1681 offsets, hence the
// tiles.  The block stages the angle's rotated beams in shared memory;
// each thread walks them in order, so a candidate's score sums in a fixed
// order.  Warp shuffles plus an ordered combine of the warps reduce (min,
// first flat index) and the 10 Olson sums per tile; a second launch, one
// block per row, combines the row's (angle, tile) partials in order and
// finalizes.  A row's blocks read only that row's inputs, so its bits do
// not depend on R.  The [A, L, L] scores never reach device memory, except
// through the optional debug output used to check the kernel against its
// twin.
#include "common.cuh"

namespace {

constexpr int kTile = 256;  // offsets (threads) a block
constexpr int kWarps = kTile / 32;
constexpr int kBeamChunk = 128;
// Olson sums: s, u0..u2, k00, k01, k02, k11, k12, k22.
constexpr int kSums = 10;
// Per-(angle, tile) partial: best, best flat index (as float), the sums.
constexpr int kPartial = 2 + kSums;
constexpr int kFinalizeThreads = 128;
constexpr int kStage = 256;  // partials staged at a time by finalize

struct Beam {
  float rx, ry;
  int used;
};

__device__ __forceinline__ int row_points(const int* nums, int num, int r) {
  return nums != nullptr ? nums[r] : num;
}

// Grid (tiles, A, R): offsets tile blockIdx.x of angle blockIdx.y of row
// blockIdx.z; G grids a row.
__global__ void __launch_bounds__(kTile) gather_tiles(
    const float* __restrict__ table, const float* __restrict__ origin,
    int G, float cell, int W, int H, const float* __restrict__ points,
    const uint8_t* __restrict__ pmask, int P, const int* __restrict__ nums,
    int num, int max_beams, const float* __restrict__ pose,
    const float* __restrict__ dths, const float* __restrict__ dls, int A,
    int L, float* __restrict__ partial, float* __restrict__ scores) {
  __shared__ Beam beams[kBeamChunk];
  __shared__ float warp_sums[kWarps][kPartial];

  const int tile = blockIdx.x, tiles = gridDim.x;
  const int a = blockIdx.y;
  const size_t r = blockIdx.z;
  const int num_points = row_points(nums, num, r);
  table += r * G * W * H * 32;
  origin += r * G * 2;
  points += r * P * 2;
  pmask += r * P;
  pose += r * 3;
  partial += (r * A * tiles + (size_t)a * tiles + tile) * kPartial;
  const int LL = L * L;
  if (scores != nullptr) scores += r * A * LL;
  const int t = tile * kTile + threadIdx.x;  // offset index lx * L + ly
  const bool live = t < LL;
  const int lx = live ? t / L : 0;
  const int ly = live ? t % L : 0;
  const float dx = dls[lx], dy = dls[ly];

  const ndt2d::Subsample sub(num_points, max_beams);
  const float th = pose[2] + dths[a];
  const float c = cosf(th), s = sinf(th);

  float mean_sum = 0.f;  // sum over grids, from 0 (G > 1 only)
  float cand = 0.f;
  for (int g = 0; g < G; ++g) {
    const float* gtable = table + (size_t)g * W * H * 32;
    const float ox = origin[2 * g], oy = origin[2 * g + 1];
    float acc = 0.f;
    for (int base = 0; base < max_beams; base += kBeamChunk) {
      const int nb = min(kBeamChunk, max_beams - base);
      __syncthreads();
      // Rotate once per angle: R(theta + dth) p + pose_xy.
      for (int j = threadIdx.x; j < nb; j += blockDim.x) {
        const int b = base + j;
        const int idx = sub.index(b, num_points, P);
        const float px = points[2 * idx], py = points[2 * idx + 1];
        beams[j].rx = c * px - s * py + pose[0];
        beams[j].ry = s * px + c * py + pose[1];
        beams[j].used = (b < sub.used) && pmask[idx];
      }
      __syncthreads();
      // matcher.py::_candidate_scores_gather, beams in order.
      for (int j = 0; j < nb; ++j) {
        const float wx = beams[j].rx + dx;
        const float wy = beams[j].ry + dy;
        const int ix = (int)floorf((wx - ox) / cell);
        const int iy = (int)floorf((wy - oy) / cell);
        const bool inb = ix >= 0 && iy >= 0 && ix < W && iy < H;
        const int flat = inb ? iy * W + ix : 0;
        const float4* rec =
            reinterpret_cast<const float4*>(gtable + (size_t)flat * 32);
        const float4 lo = rec[0], hi = rec[1];
        const float qx = wx - lo.x;
        const float qy = wy - lo.y;
        const float e =
            -0.5f * (lo.z * qx * qx + 2.f * lo.w * qx * qy + hi.x * qy * qy);
        const bool valid = inb && hi.y > 0.5f && beams[j].used;
        acc += valid ? expf(fminf(e, 0.f)) : 0.f;
      }
    }
    cand = -acc;
    mean_sum = mean_sum + cand;
  }
  if (G > 1) cand = mean_sum / (float)G;
  const int flat = a * LL + t;
  if (live && scores != nullptr) scores[flat] = cand;

  // matcher.py::reduce_candidates over this tile: x = (dx, dy, dth).
  float best = live ? cand : __int_as_float(0x7f800000);  // +inf
  int best_i = live ? flat : 0x7fffffff;
  float v[kSums] = {0.f};
  if (live) {
    const float x0 = dx, x1 = dy, x2 = dths[a];
    v[0] = cand;
    v[1] = x0 * cand;
    v[2] = x1 * cand;
    v[3] = x2 * cand;
    v[4] = x0 * x0 * cand;
    v[5] = x0 * x1 * cand;
    v[6] = x0 * x2 * cand;
    v[7] = x1 * x1 * cand;
    v[8] = x1 * x2 * cand;
    v[9] = x2 * x2 * cand;
  }
  // Fixed-shape warp tree; ties keep the lower flat index (jnp.argmin).
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (ob < best || (ob == best && oi < best_i)) {
      best = ob;
      best_i = oi;
    }
#pragma unroll
    for (int k = 0; k < kSums; ++k)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    warp_sums[warp][0] = best;
    warp_sums[warp][1] = __int_as_float(best_i);
#pragma unroll
    for (int k = 0; k < kSums; ++k) warp_sums[warp][2 + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = warp_sums[0][0];
    int bi = __float_as_int(warp_sums[0][1]);
    float acc_s[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc_s[k] = warp_sums[0][2 + k];
    for (int w = 1; w < kWarps; ++w) {  // warps hold increasing flat indices
      if (warp_sums[w][0] < b) {
        b = warp_sums[w][0];
        bi = __float_as_int(warp_sums[w][1]);
      }
#pragma unroll
      for (int k = 0; k < kSums; ++k) acc_s[k] += warp_sums[w][2 + k];
    }
    partial[0] = b;
    partial[1] = __int_as_float(bi);
#pragma unroll
    for (int k = 0; k < kSums; ++k) partial[2 + k] = acc_s[k];
  }
}

// Combine a row's N = A * tiles partials in (angle, tile) order;
// matcher.py::finalize_match.  out = [score, correction (3), covariance (9,
// row-major)].  The block stages the partials through shared memory with
// coalesced loads, kStage at a time; one thread combines them in order.
// Grid (R): row r = blockIdx.x.
__global__ void finalize(const float* __restrict__ partial, int N, int L,
                         const int* __restrict__ nums, int num,
                         int max_beams, const float* __restrict__ dths,
                         const float* __restrict__ dls,
                         float* __restrict__ out) {
  __shared__ float sp[kStage * kPartial];
  const size_t r = blockIdx.x;
  const int num_points = row_points(nums, num, r);
  partial += r * N * kPartial;
  out += r * 13;
  float best = __int_as_float(0x7f800000);  // +inf
  int bi = 0;
  float v[kSums] = {0.f};
  for (int base = 0; base < N; base += kStage) {
    const int n = min(kStage, N - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n * kPartial; i += blockDim.x)
      sp[i] = partial[(size_t)base * kPartial + i];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int j = 0; j < n; ++j) {
        const float* p = sp + j * kPartial;
        if (base + j == 0) {
          best = p[0];
          bi = __float_as_int(p[1]);
#pragma unroll
          for (int k = 0; k < kSums; ++k) v[k] = p[2 + k];
          continue;
        }
        if (p[0] < best) {  // strict: earlier partials hold lower indices
          best = p[0];
          bi = __float_as_int(p[1]);
        }
#pragma unroll
        for (int k = 0; k < kSums; ++k) v[k] += p[2 + k];
      }
    }
  }
  if (threadIdx.x != 0) return;
  const int LL = L * L;
  const int ai = bi / LL, xi = (bi / L) % L, yi = bi % L;
  const bool apply = best < 0.f;
  out[1] = apply ? dls[xi] : 0.f;
  out[2] = apply ? dls[yi] : 0.f;
  out[3] = apply ? dths[ai] : 0.f;

  const float s = v[0];
  const float u[3] = {v[1], v[2], v[3]};
  const float k[3][3] = {{v[4], v[5], v[6]}, {v[5], v[7], v[8]},
                         {v[6], v[8], v[9]}};
  const bool ok = s < 0.f;
  const float safe = ok ? s : -1.f;
  const float fallback[3] = {1.f, 1.f, 0.25f};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[4 + 3 * i + j] =
          ok ? k[i][j] / safe + (u[i] * u[j]) / (safe * safe)
             : (i == j ? fallback[i] : 0.f);
  const int used = min(max_beams, num_points);
  out[0] = best / (float)max(used, 1);
}

}  // namespace

// table [R,G,H*W,32] f32 (K1's patch table; its first 8 floats a row are
// read), origin [R,G,2] f32, points [R,P,2] f32, pmask [R,P] u8, nums [R]
// i32 (or null: every row has `num` points), pose [R,3] f32, dths [A] f32,
// dls [L] f32; scratch partial [R, A * ceil(L*L / 256), 12] f32; out [R,13]
// f32; scores [R,A,L,L] f32 or null.
NDT2D_API int ndt2d_candidate_gather(
    const void* table, const void* origin, int G, float cell, int W, int H,
    const void* points, const void* pmask, int R, int P, const void* nums,
    int num, int max_beams, const void* pose, const void* dths, int A,
    const void* dls, int L, void* partial, void* out, void* scores,
    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int tiles = (L * L + kTile - 1) / kTile;
  gather_tiles<<<dim3(tiles, A, R), kTile, 0, st>>>(
      static_cast<const float*>(table), static_cast<const float*>(origin), G,
      cell, W, H, static_cast<const float*>(points),
      static_cast<const uint8_t*>(pmask), P, static_cast<const int*>(nums),
      num, max_beams, static_cast<const float*>(pose),
      static_cast<const float*>(dths), static_cast<const float*>(dls), A, L,
      static_cast<float*>(partial), static_cast<float*>(scores));
  finalize<<<R, kFinalizeThreads, 0, st>>>(
      static_cast<const float*>(partial), A * tiles, L,
      static_cast<const int*>(nums), num, max_beams,
      static_cast<const float*>(dths), static_cast<const float*>(dls),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
