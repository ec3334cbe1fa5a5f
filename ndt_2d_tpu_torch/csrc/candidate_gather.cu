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
// finalizes (lattice.cuh, shared with K11's lattice).  A row's blocks read
// only that row's inputs, so its bits do not depend on R.  The [A, L, L]
// scores never reach device memory, except through the optional debug
// output used to check the kernel against its twin.
//
// K12 (a device mesh): the two launches are also entries of their own, as
// K2's are.  ndt2d_candidate_gather_partials scores a contiguous block of
// angles from global angle a0 (flat indices stay global) and writes its
// (angle, tile) partials; ndt2d_candidate_gather_finalize combines the
// partials of all A angles, gathered from the ranks in rank order, in
// (angle, tile) order: bit for bit the one-launch search.
//
// KB3 (a y-stripe-sharded map, ndt_2d_tpu/parallel/ndt_blocks.py::
// match_scan_sharded_map, :169-217): ndt2d_stripe_field runs the same
// scoring over the whole lattice against one stripe's cells, a beam
// counting only where its GLOBAL bin lies in the stripe's rows [row0,
// row0 + h), and writes the raw [A, L, L] field, no reduction (the stripe
// table is KB1's, [h * W, 32]).  The ranks add their fields in rank order
// (K12's rank_sum); ndt2d_field_partials then reduces a given field into
// this search's (angle, tile) partials, which ndt2d_candidate_gather_finalize
// folds into the [13] row.  At one stripe (row0 = 0, h = H) the field is
// the one-launch search's candidate scores bit for bit, and so is the row.
#include "lattice.cuh"

namespace {

using lattice::kTile;
constexpr int kBeamChunk = 128;

struct Beam {
  float rx, ry;
  int used;
};

__device__ __forceinline__ int row_points(const int* nums, int num, int r) {
  return nums != nullptr ? nums[r] : num;
}

// Grid (tiles, A, R): offsets tile blockIdx.x of angle a0 + blockIdx.y of
// row blockIdx.z; G grids a row.  dths holds the whole lattice's angles; the
// partials [R, A * tiles, 12] (or null: no reduction) and the scores
// [R, A, L, L] the launch's A.  The grid's cells are the rows [row0,
// row0 + H) of a grid binned at `origin` (row0 = 0: the whole grid).
__global__ void __launch_bounds__(kTile) gather_tiles(
    const float* __restrict__ table, const float* __restrict__ origin,
    int G, float cell, int W, int row0, int H,
    const float* __restrict__ points,
    const uint8_t* __restrict__ pmask, int P, const int* __restrict__ nums,
    int num, int max_beams, const float* __restrict__ pose,
    const float* __restrict__ dths, int a0, const float* __restrict__ dls,
    int A, int L, float* __restrict__ partial, float* __restrict__ scores) {
  __shared__ Beam beams[kBeamChunk];

  const int tile = blockIdx.x, tiles = gridDim.x;
  const int a = blockIdx.y;
  const size_t r = blockIdx.z;
  const int num_points = row_points(nums, num, r);
  table += r * G * W * H * 32;
  origin += r * G * 2;
  points += r * P * 2;
  pmask += r * P;
  pose += r * 3;
  if (partial != nullptr)
    partial += (r * A * tiles + (size_t)a * tiles + tile) * lattice::kPartial;
  const int LL = L * L;
  if (scores != nullptr) scores += r * A * LL;
  const int t = tile * kTile + threadIdx.x;  // offset index lx * L + ly
  const bool live = t < LL;
  const int lx = live ? t / L : 0;
  const int ly = live ? t % L : 0;
  const float dx = dls[lx], dy = dls[ly];

  const ndt2d::Subsample sub(num_points, max_beams);
  const int ag = a0 + a;  // the angle's index in the whole lattice
  const float th = pose[2] + dths[ag];
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
        const int iy = (int)floorf((wy - oy) / cell) - row0;
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
  const int flat = ag * LL + t;
  if (live && scores != nullptr) scores[a * LL + t] = cand;

  // matcher.py::reduce_candidates over this tile: x = (dx, dy, dth).
  if (partial != nullptr)
    lattice::reduce_tile(cand, live, flat, dx, dy, dths[ag], partial);
}

// KB3's reduction.  Grid (tiles, A): the tile blockIdx.x of angle
// blockIdx.y of a given [A, L, L] field; the partials [A * tiles, 12].
__global__ void __launch_bounds__(kTile) field_tiles(
    const float* __restrict__ field, const float* __restrict__ dths,
    const float* __restrict__ dls, int L, float* __restrict__ partial) {
  const int tile = blockIdx.x, tiles = gridDim.x;
  const int a = blockIdx.y;
  const int LL = L * L;
  const int t = tile * kTile + threadIdx.x;
  const bool live = t < LL;
  const int lx = live ? t / L : 0;
  const int ly = live ? t % L : 0;
  const float cand = live ? field[(size_t)a * LL + t] : 0.f;
  lattice::reduce_tile(cand, live, a * LL + t, dls[lx], dls[ly], dths[a],
                       partial + ((size_t)a * tiles + tile) *
                                     lattice::kPartial);
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
      cell, W, 0, H, static_cast<const float*>(points),
      static_cast<const uint8_t*>(pmask), P, static_cast<const int*>(nums),
      num, max_beams, static_cast<const float*>(pose),
      static_cast<const float*>(dths), 0, static_cast<const float*>(dls), A,
      L, static_cast<float*>(partial), static_cast<float*>(scores));
  lattice::finalize<<<R, lattice::kFinalizeThreads, 0, st>>>(
      static_cast<const float*>(partial), A * tiles, L,
      static_cast<const int*>(nums), num, max_beams,
      static_cast<const float*>(dths), static_cast<const float*>(dls),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// K12, first half: the (angle, tile) partials [R, A * tiles, 12] f32 of
// angles a0 .. a0 + A - 1 of the lattice dths (other arguments as above).
NDT2D_API int ndt2d_candidate_gather_partials(
    const void* table, const void* origin, int G, float cell, int W, int H,
    const void* points, const void* pmask, int R, int P, const void* nums,
    int num, int max_beams, const void* pose, const void* dths, int a0,
    int A, const void* dls, int L, void* partial, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int tiles = (L * L + kTile - 1) / kTile;
  gather_tiles<<<dim3(tiles, A, R), kTile, 0, st>>>(
      static_cast<const float*>(table), static_cast<const float*>(origin), G,
      cell, W, 0, H, static_cast<const float*>(points),
      static_cast<const uint8_t*>(pmask), P, static_cast<const int*>(nums),
      num, max_beams, static_cast<const float*>(pose),
      static_cast<const float*>(dths), a0, static_cast<const float*>(dls), A,
      L, static_cast<float*>(partial), nullptr);
  return (int)cudaGetLastError();
}

// K12, second half: out [R, 13] from the partials [R, A * tiles, 12] of all
// A angles in (angle, tile) order.
NDT2D_API int ndt2d_candidate_gather_finalize(
    const void* partial, int R, int A, int L, const void* nums, int num,
    int max_beams, const void* dths, const void* dls, void* out,
    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int tiles = (L * L + kTile - 1) / kTile;
  lattice::finalize<<<R, lattice::kFinalizeThreads, 0, st>>>(
      static_cast<const float*>(partial), A * tiles, L,
      static_cast<const int*>(nums), num, max_beams,
      static_cast<const float*>(dths), static_cast<const float*>(dls),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// KB3, the field: table [h*W,32] f32 (KB1's stripe table), origin [2] f32
// (the map's), points [P,2] f32, pmask [P] u8, num points, pose [3] f32,
// dths [A] f32, dls [L] f32 -> field [A,L,L] f32, each candidate's -sum
// over the beams whose global bin lies in rows [row0, row0 + h).
NDT2D_API int ndt2d_stripe_field(const void* table, const void* origin,
                                 float cell, int W, int row0, int h,
                                 const void* points, const void* pmask,
                                 int P, int num, int max_beams,
                                 const void* pose, const void* dths, int A,
                                 const void* dls, int L, void* field,
                                 void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int tiles = (L * L + kTile - 1) / kTile;
  gather_tiles<<<dim3(tiles, A, 1), kTile, 0, st>>>(
      static_cast<const float*>(table), static_cast<const float*>(origin), 1,
      cell, W, row0, h, static_cast<const float*>(points),
      static_cast<const uint8_t*>(pmask), P, nullptr, num, max_beams,
      static_cast<const float*>(pose), static_cast<const float*>(dths), 0,
      static_cast<const float*>(dls), A, L, nullptr,
      static_cast<float*>(field));
  return (int)cudaGetLastError();
}

// KB3, the reduction: field [A,L,L] f32 -> partial [A * ceil(L*L / 256), 12]
// f32 in (angle, tile) order, the input of ndt2d_candidate_gather_finalize.
NDT2D_API int ndt2d_field_partials(const void* field, int A, const void* dths,
                                   const void* dls, int L, void* partial,
                                   void* stream) {
  const int tiles = (L * L + kTile - 1) / kTile;
  field_tiles<<<dim3(tiles, A), kTile, 0,
                reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(field), static_cast<const float*>(dths),
      static_cast<const float*>(dls), L, static_cast<float*>(partial));
  return (int)cudaGetLastError();
}
