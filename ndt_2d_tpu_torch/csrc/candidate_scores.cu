// K2: exhaustive 3-DoF candidate scoring with its argmin + Olson reduction.
//
// Replaces the jitted XLA fast path of the JAX package (and the retired
// Pallas kernels candidate_scores_pallas / _gather that computed it):
// ndt_2d_tpu/matching/matcher.py::prepare_neighborhood ->
// _candidate_scores_local -> reduce_candidates -> finalize_match, reading
// ndt_2d_tpu/ndt/grid.py::packed_patch_table; with a row axis, the
// jax.vmap of match_scan in match_scan_batch_multi (R loop-closure
// confirmation rows, each with its own table, origin, query scan and start
// pose, in one launch per pass).  With a grid axis (G = 4, the overlapping
// grids, matcher.py:194-202) every candidate's beam sum is taken per grid,
// each grid with its own patch table, crossing lines and bounds mask, and
// the candidate score is their mean ((((0 + p0) + p1) + p2) + p3) / 4, as
// Python's sum builds it, before the argmin and the Olson sums; at G = 1 the
// score is the one grid's sum, bit for bit the single-grid launch.
//
// What it computes: for every candidate (angle a, dx, dy) of the lattice,
// the negated sum over the subsampled beams of exp(min(-q^T Lambda q / 2, 0))
// against the one cell of the beam's 2x2 patch that the shifted beam falls
// in; then the first-index argmin, the correction (applied only when the
// best score is < 0) and the Olson covariance K/s + u u^T / s^2, with the
// weak isotropic fallback when s == 0.
//
// What bounds it on the card: the exp and quadratic form of
// A x L x L x B = 3.5e6 (candidate, beam) terms, about 0.1 GFLOP; the
// only gathers are A x B patch rows of 128 bytes.  Design: one block per
// (angle, row); one thread per (dx, dy), the block padded to whole warps.  The
// block first stages every beam's rotated point, crossing lines and
// 2x2 patch records in shared memory (one 32-float row gather per beam), then
// each thread walks the beams in order, so its candidate score sums in a
// fixed order.  Warp shuffles plus an ordered combine of the warps reduce
// (min, first flat index) and the 10 Olson sums per angle; a second
// launch, one block per row, combines the row's angles in angle order and
// finalizes (A <= 512 angles, L*L <= 1024 offsets per angle).  A row's
// blocks read only that row's inputs, so its bits do not depend on R.  The
// [A, L, L] scores never reach device memory, except through the optional
// debug output used to check the kernel against its twin.
#include "common.cuh"

namespace {

constexpr int kBeamChunk = 128;
constexpr int kMaxWarps = 32;
// Olson sums: s, u0..u2, k00, k01, k02, k11, k12, k22.
constexpr int kSums = 10;
// Per-angle partial: best, best flat index (as float), the 10 sums.
constexpr int kPartial = 2 + kSums;

struct Beam {
  float bx, by, cx, cy;
  float rec[4][6];  // y-major 2x2: mean_x, mean_y, i00, i01, i11, ok
};

// Per-row beam count: the row's entry of `nums` when given, else `num`.
__device__ __forceinline__ int row_points(const int* nums, int num, int r) {
  return nums != nullptr ? nums[r] : num;
}

// Grid (A, R): angle a = blockIdx.x of row r = blockIdx.y; G grids a row.
__global__ void score_angles(
    const float* __restrict__ table, const float* __restrict__ origin,
    int G, float cell, int W, int H, const float* __restrict__ points,
    const uint8_t* __restrict__ pmask, int P, const int* __restrict__ nums,
    int num, int max_beams, const float* __restrict__ pose,
    const float* __restrict__ dths, const float* __restrict__ dls, int A,
    int L, float* __restrict__ partial, float* __restrict__ scores) {
  __shared__ Beam beams[kBeamChunk];
  __shared__ float warp_sums[kMaxWarps][kPartial];

  const int a = blockIdx.x;
  const size_t r = blockIdx.y;
  const int num_points = row_points(nums, num, r);
  table += r * G * W * H * 32;
  origin += r * G * 2;
  points += r * P * 2;
  pmask += r * P;
  pose += r * 3;
  partial += r * A * kPartial;
  if (scores != nullptr) scores += r * A * L * L;
  const int t = threadIdx.x;
  const int LL = L * L;
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
    const float x_hi = ox + (float)W * cell;
    const float y_hi = oy + (float)H * cell;
    float acc = 0.f;
    for (int base = 0; base < max_beams; base += kBeamChunk) {
      const int nb = min(kBeamChunk, max_beams - base);
      __syncthreads();
      // matcher.py::prepare_neighborhood for this chunk of beams.
      for (int j = t; j < nb; j += blockDim.x) {
        const int b = base + j;
        const int idx = sub.index(b, num_points, P);
        const bool m = (b < sub.used) && pmask[idx];
        const float px = points[2 * idx], py = points[2 * idx + 1];
        const float bx = c * px - s * py + pose[0];
        const float by = s * px + c * py + pose[1];
        const int ix0 = (int)floorf((bx + dls[0] - ox) / cell);
        const int iy0 = (int)floorf((by + dls[0] - oy) / cell);
        const int ixc = ndt2d::clampi(ix0, 0, W - 2);
        const int iyc = ndt2d::clampi(iy0, 0, H - 2);
        Beam& bm = beams[j];
        bm.bx = bx;
        bm.by = by;
        bm.cx = ox + ((float)ixc + 1.f) * cell;
        bm.cy = oy + ((float)iyc + 1.f) * cell;
        const float4* row = reinterpret_cast<const float4*>(
            gtable + (size_t)(iyc * W + ixc) * 32);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 lo = row[2 * q], hi = row[2 * q + 1];
          bm.rec[q][0] = lo.x;
          bm.rec[q][1] = lo.y;
          bm.rec[q][2] = lo.z;
          bm.rec[q][3] = lo.w;
          bm.rec[q][4] = hi.x;
          bm.rec[q][5] = (hi.y > 0.5f && m) ? 1.f : 0.f;
        }
      }
      __syncthreads();
      // matcher.py::_candidate_scores_local, beams in order.
      for (int j = 0; j < nb; ++j) {
        const Beam& bm = beams[j];
        const float wxc = bm.bx + dx;
        const float wyc = bm.by + dy;
        const int q = (wyc >= bm.cy ? 2 : 0) + (wxc >= bm.cx ? 1 : 0);
        const float* r = bm.rec[q];
        const bool valid = r[5] > 0.5f && wxc >= ox && wxc < x_hi &&
                           wyc >= oy && wyc < y_hi;
        const float qx = wxc - r[0];
        const float qy = wyc - r[1];
        const float e =
            -0.5f * (r[2] * qx * qx + 2.f * r[3] * qx * qy + r[4] * qy * qy);
        acc += valid ? expf(fminf(e, 0.f)) : 0.f;
      }
    }
    cand = -acc;
    mean_sum = mean_sum + cand;
  }
  if (G > 1) cand = mean_sum / (float)G;
  const int flat = a * LL + t;
  if (live && scores != nullptr) scores[flat] = cand;

  // matcher.py::reduce_candidates over this angle: x = (dx, dy, dth).
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
  const int warp = t >> 5, lane = t & 31;
  if (lane == 0) {
    warp_sums[warp][0] = best;
    warp_sums[warp][1] = __int_as_float(best_i);
#pragma unroll
    for (int k = 0; k < kSums; ++k) warp_sums[warp][2 + k] = v[k];
  }
  __syncthreads();
  if (t == 0) {
    const int nw = blockDim.x >> 5;
    float b = warp_sums[0][0];
    int bi = __float_as_int(warp_sums[0][1]);
    float acc_s[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc_s[k] = warp_sums[0][2 + k];
    for (int w = 1; w < nw; ++w) {  // warps hold increasing flat indices
      if (warp_sums[w][0] < b) {
        b = warp_sums[w][0];
        bi = __float_as_int(warp_sums[w][1]);
      }
#pragma unroll
      for (int k = 0; k < kSums; ++k) acc_s[k] += warp_sums[w][2 + k];
    }
    float* out = partial + (size_t)a * kPartial;
    out[0] = b;
    out[1] = __int_as_float(bi);
#pragma unroll
    for (int k = 0; k < kSums; ++k) out[2 + k] = acc_s[k];
  }
}

// Combine the per-angle partials in angle order; matcher.py::finalize_match.
// out = [score, correction (3), covariance (9, row-major)].  The block
// stages the partials in shared memory with coalesced loads, then one
// thread combines them in order (a chain of global loads would serialize
// on their latency).
constexpr int kFinalizeThreads = 128;
constexpr int kMaxAngles = 512;

// Grid (R): row r = blockIdx.x.
__global__ void finalize(const float* __restrict__ partial, int A, int L,
                         const int* __restrict__ nums, int num,
                         int max_beams, const float* __restrict__ dths,
                         const float* __restrict__ dls,
                         float* __restrict__ out) {
  __shared__ float sp[kMaxAngles * kPartial];
  const size_t r = blockIdx.x;
  const int num_points = row_points(nums, num, r);
  partial += r * A * kPartial;
  out += r * 13;
  for (int i = threadIdx.x; i < A * kPartial; i += blockDim.x)
    sp[i] = partial[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  float best = sp[0];
  int bi = __float_as_int(sp[1]);
  float v[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) v[k] = sp[2 + k];
  for (int a = 1; a < A; ++a) {
    const float* p = sp + a * kPartial;
    if (p[0] < best) {  // strict: earlier angles hold lower flat indices
      best = p[0];
      bi = __float_as_int(p[1]);
    }
#pragma unroll
    for (int k = 0; k < kSums; ++k) v[k] += p[2 + k];
  }
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

// table [R,G,H*W,32] f32, origin [R,G,2] f32, points [R,P,2] f32, pmask
// [R,P] u8, nums [R] i32 (or null: every row has `num` points), pose [R,3]
// f32, dths [A] f32, dls [L] f32; scratch partial [R,A,12] f32; out [R,13]
// f32; scores [R,A,L,L] f32 or null.
NDT2D_API int ndt2d_candidate_scores(
    const void* table, const void* origin, int G, float cell, int W, int H,
    const void* points, const void* pmask, int R, int P, const void* nums,
    int num, int max_beams, const void* pose, const void* dths, int A,
    const void* dls, int L, void* partial, void* out, void* scores,
    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int threads = ((L * L + 31) / 32) * 32;
  score_angles<<<dim3(A, R), threads, 0, st>>>(
      static_cast<const float*>(table), static_cast<const float*>(origin), G,
      cell, W, H, static_cast<const float*>(points),
      static_cast<const uint8_t*>(pmask), P, static_cast<const int*>(nums),
      num, max_beams, static_cast<const float*>(pose),
      static_cast<const float*>(dths), static_cast<const float*>(dls), A, L,
      static_cast<float*>(partial), static_cast<float*>(scores));
  finalize<<<R, kFinalizeThreads, 0, st>>>(
      static_cast<const float*>(partial), A, L, static_cast<const int*>(nums),
      num, max_beams, static_cast<const float*>(dths),
      static_cast<const float*>(dls), static_cast<float*>(out));
  return (int)cudaGetLastError();
}
