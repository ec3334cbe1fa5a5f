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
// What bounds it on the card: the instruction throughput.  A (candidate,
// beam) term is about thirty instructions (the cell pick, the form's seven
// roundings, the clamp, expf's ten and the sum), and -fmad=false with the
// twin's expression order (the parity rule) keeps a multiply-add as two,
// so the operations bound (an FMA as two operations at 67 TFLOP/s) is out
// of reach bitwise; the only gathers are A x B patch rows of 128 bytes.
// Design (candidate_scores.py::tile_plan sets the numbers), one block an
// (angle, row):
//  - the block stages its beams in chunks of 128 (one a grid at 100
//    beams): a header float4 (the rotated beam and its crossing lines)
//    and the beam's 128-byte patch row, copied as it lies in the table
//    with cp.async (zeros for a masked beam), so every record is two
//    aligned 16-byte (and 8-byte) loads.  A block of one candidate a
//    thread (one block an SM) with several chunks (G = 4 grids) has two
//    stages and copies chunk k + 1 while it scores chunk k, keeping each
//    beam's point in registers across grids, so only the first chunk's
//    gather is waited for.  A 2 x 4 block keeps one stage: six of them
//    share an SM and hide each other's gathers, and a second stage costs
//    registers and occupancy (measured slower on an H100, PERF.md §6);
//  - each thread scores KX dx rows x KY dy columns with its sums in
//    registers: per beam it loads the header and, per dx, the two records
//    of its x half, and computes the dx-only parts of the form ((i00 qx)
//    qx, (2 i01) qx) once, the first as +inf where the record is not
//    scorable or the shift leaves the grid in x; per dy it adds -inf to
//    the exponent off the grid in y.  An invalid term's exponent is thus
//    -inf and the term +0, which leaves a sum of non-negative terms bit for
//    bit unchanged, with no branch or select on validity.  Per candidate
//    it picks the y half and adds ((A + B qy) + (i11 qy) qy), the twin's
//    rounding sequence, its beams in order from 0.  A thread of one
//    candidate (KX = KY = 1, the launches of fewer blocks than SMs) loads
//    only the record its shift falls in and adds +0 for an invalid term
//    (a select, as the twin's where), four beams an iteration;
//  - the block reduces the angle in the one-launch order: 32 consecutive
//    flat indices a warp, folded by the shuffle tree (16, 8, 4, 2, 1),
//    then the warps in order (min, first flat index and the 10 Olson
//    sums); a tiled block goes through its scores in shared memory, a
//    block of one candidate a thread (thread t is flat index t) folds
//    from registers (L*L <= 1024 offsets per angle).  A second launch,
//    one block per row, combines the row's angles in angle order and
//    finalizes; it also folds K6's (angle, tile) partials.
// Each candidate's sum is a chain of max_beams dependent adds, so a launch
// of few rows is bound by that chain's latency, not by the SMs it fills:
// spreading an angle's candidates over a cluster of blocks only added
// staging and barriers, and made a one-row launch slower on an H100.
// A row's blocks read only that row's inputs, so its bits do not depend on
// R.  The [A, L, L] scores never reach device memory, except through the
// optional debug output used to check the kernel against its twin.
//
// K12 (a device mesh, ndt_2d_tpu/parallel/matcher.py::match_scan_multichip
// with its psum and all_gather): the two launches are also entries of their
// own.  ndt2d_candidate_partials scores a contiguous block of angles
// starting at global angle a0 (a rank's share; flat indices stay global)
// and writes only its per-angle partials; the finalize combines the
// partials of all A angles, gathered from the ranks in rank order, reading
// the gathered send buffers as they lie (ndt2d_candidate_finalize_planned;
// ndt2d_candidate_finalize takes one [R, A, 12] buffer).  The finalize adds
// in angle order, so the split search is the one-launch search bit for bit,
// whatever the split.  ndt2d_candidate_finalize_append is the planned
// finalize of the fused SLAM step with KB4's append in the same launch
// (step_append.cuh).
#include "common.cuh"
#include "step_append.cuh"

namespace {

// Beams a chunk: a stage holds a chunk's headers and patch rows.
constexpr int kChunk = 128;
constexpr int kStageBytes = kChunk * (16 + 32 * 4);
constexpr int kMaxWarps = 32;
constexpr int kMaxCand = kMaxWarps * 32;
// Olson sums: s, u0..u2, k00, k01, k02, k11, k12, k22.
constexpr int kSums = 10;
// Per-angle partial: best, best flat index (as float), the 10 sums.
constexpr int kPartial = 2 + kSums;
constexpr float kInf = __builtin_huge_valf();

// The tile plan: thread t = tx * nyg + ty (tx < nxg) takes dx rows tx +
// i * nxg (i < KX) and dy columns ty + j * nyg (j < KY), those below L.
struct Tile {
  int nxg, nyg;
};

// Per-row beam count: the row's entry of `nums` when given, else `num`.
__device__ __forceinline__ int row_points(const int* nums, int num, int r) {
  return nums != nullptr ? nums[r] : num;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The most threads a block of a KX x KY tile has (L <= 32), its launch
// bound.
constexpr int tile_threads(int kx, int ky) {
  return ((31 + kx) / kx * ((31 + ky) / ky) + 31) / 32 * 32;
}

// matcher.py::reduce_candidates of one warp's 32 consecutive flat indices
// f (the angle's own, live below L*L) with scores v0: the shuffle tree
// (16, 8, 4, 2, 1) into warp_sums[w]; x = (dx, dy, dth).
__device__ __forceinline__ void fold_warp(
    float v0, bool live, int f, int ag, int L, const float* dls,
    const float* dths, float (*warp_sums)[kPartial], int w) {
  float best = live ? v0 : kInf;
  int best_i = live ? ag * L * L + f : 0x7fffffff;
  float v[kSums] = {0.f};
  if (live) {
    const float x0 = dls[f / L], x1 = dls[f % L], x2 = dths[ag];
    v[0] = v0;
    v[1] = x0 * v0;
    v[2] = x1 * v0;
    v[3] = x2 * v0;
    v[4] = x0 * x0 * v0;
    v[5] = x0 * x1 * v0;
    v[6] = x0 * x2 * v0;
    v[7] = x1 * x1 * v0;
    v[8] = x1 * x2 * v0;
    v[9] = x2 * x2 * v0;
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
  if ((threadIdx.x & 31) == 0) {
    warp_sums[w][0] = best;
    warp_sums[w][1] = __int_as_float(best_i);
#pragma unroll
    for (int k = 0; k < kSums; ++k) warp_sums[w][2 + k] = v[k];
  }
}

// Grid (A, R): angle a0 + a of the lattice, a = blockIdx.x, of row r =
// blockIdx.y; G grids a row.  dths holds the whole lattice's angles; the
// partials [R, A, 12] and the scores [R, A, L, L] hold the launch's A.
template <int KX, int KY>
__global__ void __launch_bounds__(tile_threads(KX, KY)) score_angles(
    const float* __restrict__ table, const float* __restrict__ origin,
    int G, float cell, int W, int H, const float* __restrict__ points,
    const uint8_t* __restrict__ pmask, int P, const int* __restrict__ nums,
    int num, int max_beams, const float* __restrict__ pose,
    const float* __restrict__ dths, int a0, const float* __restrict__ dls,
    int A, int L, Tile tile, float* __restrict__ partial,
    float* __restrict__ scores) {
  constexpr bool kOne = KX * KY == 1;
  // Stages (two for a block of one candidate a thread and more than one
  // chunk) of kChunk beams in dynamic shared memory: headers (bx, by, cross_x,
  // cross_y), then the beams' 2x2 patch rows, y-major quadrants of
  // (mean_x, mean_y, i00, i01, i11, scorable, 0, 0).
  extern __shared__ float4 stage_mem[];
  __shared__ float cand_s[kOne ? 1 : kMaxCand];
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
  const int warp = t >> 5, lane = t & 31;
  const int nw = blockDim.x >> 5;
  const int LL = L * L;

  const int tx = t / tile.nyg, ty = t % tile.nyg;
  int lxs[KX], lys[KY];
  bool livex[KX], livey[KY];
  float dxv[KX], dyv[KY];
#pragma unroll
  for (int i = 0; i < KX; ++i) {
    lxs[i] = tx + i * tile.nxg;
    livex[i] = tx < tile.nxg && lxs[i] < L;
    dxv[i] = dls[livex[i] ? lxs[i] : 0];
  }
#pragma unroll
  for (int j = 0; j < KY; ++j) {
    lys[j] = ty + j * tile.nyg;
    livey[j] = lys[j] < L;
    dyv[j] = dls[livey[j] ? lys[j] : 0];
  }

  const ndt2d::Subsample sub(num_points, max_beams);
  const int ag = a0 + a;  // the angle's index in the whole lattice
  const float th = pose[2] + dths[ag];
  const float c = cosf(th), s = sinf(th);

  // The chunks: k = g * per_grid + i holds beams i * kChunk .. of grid g.
  const int per_grid = (max_beams + kChunk - 1) / kChunk;
  const int nk = G * per_grid;
  const bool two = kOne && nk > 1;
  auto hdr_of = [&](int k) {
    return stage_mem + (two ? (k & 1) : 0) * (kStageBytes / 16);
  };
  auto rows_of = [&](int k) {
    return reinterpret_cast<float(*)[32]>(hdr_of(k) + kChunk);
  };
  // matcher.py::prepare_neighborhood for chunk k, a thread a beam: the
  // header and the patch row copied as it lies in the table (cp.async,
  // 16 bytes at a time; zeros for a masked beam), committed as a group.
  // A thread of one candidate keeps its last beam's point, so the next
  // grid's copy of the same beam waits on no global load.
  int pb = -1;
  float px = 0.f, py = 0.f;
  bool m = false;
  auto stage = [&](int k) {
    const int g = k / per_grid, base = (k % per_grid) * kChunk;
    const int nb = min(kChunk, max_beams - base);
    const float ox = origin[2 * g], oy = origin[2 * g + 1];
    float4* hdr = hdr_of(k);
    float(*rows)[32] = rows_of(k);
    for (int j = t; j < nb; j += blockDim.x) {
      const int b = base + j;
      if (!kOne || b != pb) {
        const int idx = sub.index(b, num_points, P);
        m = (b < sub.used) && pmask[idx];
        px = points[2 * idx];
        py = points[2 * idx + 1];
        pb = b;
      }
      const float bx = c * px - s * py + pose[0];
      const float by = s * px + c * py + pose[1];
      const int ix0 = (int)floorf((bx + dls[0] - ox) / cell);
      const int iy0 = (int)floorf((by + dls[0] - oy) / cell);
      const int ixc = ndt2d::clampi(ix0, 0, W - 2);
      const int iyc = ndt2d::clampi(iy0, 0, H - 2);
      hdr[j] = make_float4(bx, by, ox + ((float)ixc + 1.f) * cell,
                           oy + ((float)iyc + 1.f) * cell);
      const float* src =
          table + ((size_t)g * W * H + (size_t)(iyc * W + ixc)) * 32;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (m)
          cp_async16(&rows[j][4 * q], src + 4 * q);
        else  // a masked beam's cells are never scorable
          *reinterpret_cast<float4*>(&rows[j][4 * q]) =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    cp_async_commit();
  };

  float acc[KX][KY], cand[KX][KY], mean_sum[KX][KY];  // mean: G > 1 only
#pragma unroll
  for (int i = 0; i < KX; ++i)
#pragma unroll
    for (int j = 0; j < KY; ++j) {
      acc[i][j] = mean_sum[i][j] = 0.f;
      cand[i][j] = -0.f;  // -(a sum of no beams)
    }
  if (nk > 0) stage(0);
  for (int k = 0; k < nk; ++k) {
    cp_async_wait_all();
    __syncthreads();
    // With two stages the next chunk's rows are copied while this one is
    // scored: its stage was last read by chunk k - 1, before the barrier.
    if (two && k + 1 < nk) stage(k + 1);
    const int g = k / per_grid;
    const int nb = min(kChunk, max_beams - (k % per_grid) * kChunk);
    const float ox = origin[2 * g], oy = origin[2 * g + 1];
    const float x_hi = ox + (float)W * cell;
    const float y_hi = oy + (float)H * cell;
    const float4* hs = hdr_of(k);
    const float(*rs)[32] = rows_of(k);
    // matcher.py::_candidate_scores_local, beams in order.
    if constexpr (kOne) {
      // One candidate a thread: the one record its shift falls in; four
      // beams an iteration, so their loads and expf overlap the adds.
#pragma unroll 4
      for (int j = 0; j < nb; ++j) {
        const float4 h = hs[j];
        const float wxc = h.x + dxv[0], wyc = h.y + dyv[0];
        const int q = (wyc >= h.w ? 2 : 0) + (wxc >= h.z ? 1 : 0);
        const float* rec = &rs[j][8 * q];
        const float4 lo = *reinterpret_cast<const float4*>(rec);
        const float2 hi = *reinterpret_cast<const float2*>(rec + 4);
        const bool valid = hi.y > 0.5f && wxc >= ox && wxc < x_hi &&
                           wyc >= oy && wyc < y_hi;
        const float qx = wxc - lo.x, qy = wyc - lo.y;
        const float e = -0.5f * (lo.z * qx * qx + 2.f * lo.w * qx * qy +
                                 hi.x * qy * qy);
        acc[0][0] += valid ? expf(fminf(e, 0.f)) : 0.f;
      }
    } else {
      for (int j = 0; j < nb; ++j) {
        const float4 h = hs[j];
        // Per dx: the two records of its x half (y half 0, 1) and the
        // dx-only parts of the form, (i00 qx) qx and (2 i01) qx.  The
        // first is +inf where the record is not scorable or the shift
        // leaves the grid in x: that term's exponent is then -inf and it
        // adds +0, which leaves a sum of non-negative terms bit for bit.
        float am0[KX], am1[KX], bm0[KX], bm1[KX], my0[KX], my1[KX];
        float ky0[KX], ky1[KX];
#pragma unroll
        for (int i = 0; i < KX; ++i) {
          const float wxc = h.x + dxv[i];
          const int sx = wxc >= h.z ? 1 : 0;
          const bool inx = wxc >= ox && wxc < x_hi;
          const float* rec0 = &rs[j][8 * sx];
          const float* rec1 = &rs[j][8 * (2 + sx)];
          const float4 lo0 = *reinterpret_cast<const float4*>(rec0);
          const float2 hi0 = *reinterpret_cast<const float2*>(rec0 + 4);
          const float4 lo1 = *reinterpret_cast<const float4*>(rec1);
          const float2 hi1 = *reinterpret_cast<const float2*>(rec1 + 4);
          const float qx0 = wxc - lo0.x, qx1 = wxc - lo1.x;
          am0[i] = (inx && hi0.y > 0.5f) ? lo0.z * qx0 * qx0 : kInf;
          am1[i] = (inx && hi1.y > 0.5f) ? lo1.z * qx1 * qx1 : kInf;
          bm0[i] = 2.f * lo0.w * qx0;
          bm1[i] = 2.f * lo1.w * qx1;
          my0[i] = lo0.y;
          my1[i] = lo1.y;
          ky0[i] = hi0.x;
          ky1[i] = hi1.x;
        }
#pragma unroll
        for (int jj = 0; jj < KY; ++jj) {
          const float wyc = h.y + dyv[jj];
          const bool sy = wyc >= h.w;
          // -inf off the grid in y (the same +0 term), else +0: adding it
          // changes at most the sign of a zero exponent.
          const float off = (wyc >= oy && wyc < y_hi) ? 0.f : -kInf;
#pragma unroll
          for (int i = 0; i < KX; ++i) {
            const float qy = wyc - (sy ? my1[i] : my0[i]);
            const float i11 = sy ? ky1[i] : ky0[i];
            const float e = -0.5f * (((sy ? am1[i] : am0[i]) +
                                      (sy ? bm1[i] : bm0[i]) * qy) +
                                     i11 * qy * qy);
            acc[i][jj] += expf(fminf(e + off, 0.f));
          }
        }
      }
    }
    if (k % per_grid == per_grid - 1) {  // grid g's last chunk
#pragma unroll
      for (int i = 0; i < KX; ++i)
#pragma unroll
        for (int j = 0; j < KY; ++j) {
          cand[i][j] = -acc[i][j];
          mean_sum[i][j] = mean_sum[i][j] + cand[i][j];
          acc[i][j] = 0.f;
        }
    }
    if (!two && k + 1 < nk) {  // one stage: refill it once all are done
      __syncthreads();
      stage(k + 1);
    }
  }

  // matcher.py::reduce_candidates over this angle: 32 consecutive flat
  // indices a warp, then the warps in order.
  const int nwc = (LL + 31) >> 5;  // the angle's candidate warps
  if constexpr (kOne) {
    // Thread t holds flat index t: its warp is the candidates' warp.
    const bool live = livex[0] && livey[0];
    const float v = G > 1 ? mean_sum[0][0] / (float)G : cand[0][0];
    if (live && scores != nullptr) scores[a * LL + t] = v;
    if (warp < nwc) fold_warp(v, live, t, ag, L, dls, dths, warp_sums, warp);
  } else {
#pragma unroll
    for (int i = 0; i < KX; ++i)
#pragma unroll
      for (int j = 0; j < KY; ++j) {
        if (!(livex[i] && livey[j])) continue;
        const float v = G > 1 ? mean_sum[i][j] / (float)G : cand[i][j];
        const int f = lxs[i] * L + lys[j];
        cand_s[f] = v;
        if (scores != nullptr) scores[a * LL + f] = v;
      }
    __syncthreads();
    for (int w = warp; w < nwc; w += nw) {
      const int f = w * 32 + lane;
      const bool live = f < LL;
      fold_warp(live ? cand_s[f] : 0.f, live, f, ag, L, dls, dths,
                warp_sums, w);
    }
  }
  __syncthreads();
  if (t == 0) {
    float b = warp_sums[0][0];
    int bi = __float_as_int(warp_sums[0][1]);
    float acc_s[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc_s[k] = warp_sums[0][2 + k];
    for (int w = 1; w < nwc; ++w) {  // warps hold increasing flat indices
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

// The scoring launch of a plan (kx, ky, nxg, nyg, threads);
// cudaErrorInvalidValue for a plan the kernel does not take.
cudaError_t launch_scores(const int* plan, int A, int R, cudaStream_t st,
                          const float* table, const float* origin, int G,
                          float cell, int W, int H, const float* points,
                          const uint8_t* pmask, int P, const int* nums,
                          int num, int max_beams, const float* pose,
                          const float* dths, int a0, const float* dls, int L,
                          float* partial, float* scores) {
  const int kx = plan[0], ky = plan[1], threads = plan[4];
  const Tile tile = {plan[2], plan[3]};
  // The one-candidate path folds its warps from registers: thread t must
  // be flat index t.
  const bool one = kx == 1 && ky == 1;
  // Two stages when a block of one candidate a thread scores more than
  // one chunk of beams (score_angles' `two`).
  const int chunks = G * ((max_beams + kChunk - 1) / kChunk);
  const size_t smem = (one && chunks > 1 ? 2 : 1) * (size_t)kStageBytes;
  if (L * L > kMaxCand || threads < 32 || threads % 32 != 0 ||
      threads > tile_threads(kx, ky) || tile.nxg * kx < L ||
      tile.nyg * ky < L || tile.nxg * tile.nyg > threads ||
      (one && (tile.nyg != L || threads < L * L)))
    return cudaErrorInvalidValue;
#define NDT2D_TILE(X, Y)                                                  \
  if (kx == X && ky == Y) {                                               \
    score_angles<X, Y><<<dim3(A, R), threads, smem, st>>>(                \
        table, origin, G, cell, W, H, points, pmask, P, nums, num,        \
        max_beams, pose, dths, a0, dls, A, L, tile, partial, scores);     \
    return cudaGetLastError();                                            \
  }
  NDT2D_TILE(2, 4)
  NDT2D_TILE(1, 1)
#undef NDT2D_TILE
  return cudaErrorInvalidValue;
}

// Combine a row's partials in order; matcher.py::finalize_match.  out =
// [score, correction (3), covariance (9, row-major)].  K2 writes one
// partial an angle, K6 (candidate_gather.cu) `per` = ceil(L*L / 256) an
// angle, one a tile of its offsets: a row's N = A x per partials in
// (angle, tile) order.  This launch folds both searches' rows, split or
// not, and KB3's.
//
// Where a row's partials lie.  A split search's S ranks each write their
// block of blk = ceil(A / S) angles at the head of a send buffer of R x
// blk x per partials, and the all-gather stacks the S buffers in rank
// order; the finalize reads that stack as it lies: partial i is angle a =
// i / per's tile t = i - a per, angle a is rank s = a / blk's angle j = a
// - s blk, and rank s's [R, n_s per, 12] block (n_s = min(blk, A - s blk)
// angles) starts its buffer, so row r's partial (j, t) sits at ((s R blk
// + r n_s) per + j per + t) 12.  At R = 1, or where n_s = blk, that is
// slot j per + t of the stack seen as [S, R, blk per, 12].  A buffer's
// tail (a short or empty last block) is never read, and no copy reorders
// the stack.  The one-launch search is the same rule at S = 1 (blk = A:
// its scratch [R, A per, 12]).
//
// The fold.  The block stages the row's partials in shared memory in
// order, three 16-byte loads a partial: a row of up to kStagePartials in
// one round by every thread, a longer one in rounds of kStagePartials / 2
// through the stage's two halves, round k + 1 loaded by warps 2.. while
// warps 0 and 1 fold round k.  Lane k < 10 of warp 0 adds Olson sum k over
// the partials in order, from the first partial on.  Warp 1 finds a
// round's (min, first index): lanes over strided partials with strict
// `<` from +inf (a NaN never enters), then a shuffle tree that breaks
// ties by the lower index; the row's first partial opens the running
// pair and a round's pair replaces it only where strictly less.  That is
// the serial scan's result: with a non-NaN first partial, the first of
// the least non-NaN values; with a NaN one, the NaN.  Warp 1 hands its
// pair to warp 0 through shared memory at a barrier of the two warps;
// lane 0 takes the ten sums by shuffles and writes the row; the other
// warps leave after staging.
//
// With an Append (the fused SLAM step, K2 at R = 1), lane 0 then forms the
// corrected pose from the winner's correction and covariance in registers
// and writes KB4's constraint, slot and previous pose (step_append.cuh's
// step_constraint, the body KB4's own launch runs), while warps 2.. copy
// the scan into slot i.
constexpr int kFinalizeThreads = 256;
constexpr int kStagePartials = 512;
constexpr int kFoldWarps = 2;  // warp 0 the sums, warp 1 the (min, index)

struct Append {
  StepState st;
  StepInputs in;
};

__device__ __forceinline__ size_t split_at(int i, int r, int R, int A,
                                           int blk, int per) {
  const int a = i / per;
  const int t = i - a * per;
  const int s = a / blk;
  const int j = a - s * blk;
  const int n = min(blk, A - s * blk);
  return (((size_t)s * R * blk + (size_t)r * n) * per + (size_t)j * per +
          t) *
         kPartial;
}

// Partials [base, base + n) of row r into dst, by threads tid of nt.
__device__ __forceinline__ void stage_partials(
    float4* __restrict__ dst, const float* __restrict__ gathered, int base,
    int n, int r, int R, int A, int blk, int per, int tid, int nt) {
#pragma unroll 4
  for (int q = tid; q < n * 3; q += nt) {
    const int i = q / 3;
    dst[q] = reinterpret_cast<const float4*>(
        gathered + split_at(base + i, r, R, A, blk, per))[q - 3 * i];
  }
}

// Grid (R): row r = blockIdx.x.  gathered: the stacked send buffers (16-byte
// aligned); blk the angles of a rank's block, per the partials an angle.
template <bool kAppend>
__global__ void __launch_bounds__(kFinalizeThreads) finalize(
    const float* __restrict__ gathered, int R, int A, int L, int blk,
    int per, const int* __restrict__ nums, int num, int max_beams,
    const float* __restrict__ dths, const float* __restrict__ dls,
    float* __restrict__ out, Append ap) {
  __shared__ float4 sp4[kStagePartials * 3];
  __shared__ float pair[2];
  const int r = blockIdx.x;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int N = A * per;
  const int chunk = N <= kStagePartials ? N : kStagePartials / 2;
  stage_partials(sp4, gathered, 0, chunk, r, R, A, blk, per, t,
                 kFinalizeThreads);
  __syncthreads();
  const int col = lane < kSums ? 2 + lane : 2;
  float v = 0.f, best = 0.f;
  int bi = 0;
  for (int base = 0, k = 0; base < N; base += chunk, ++k) {
    const int n = min(chunk, N - base);
    const float* sp = reinterpret_cast<const float*>(
        sp4 + (k & 1) * (kStagePartials / 2) * 3);
    if (warp >= kFoldWarps) {
      const int next = base + chunk;
      if (next < N)
        stage_partials(sp4 + ((k + 1) & 1) * (kStagePartials / 2) * 3,
                       gathered, next, min(chunk, N - next), r, R, A, blk,
                       per, t - 32 * kFoldWarps,
                       kFinalizeThreads - 32 * kFoldWarps);
    } else if (warp == 0) {
      int j = 0;
      if (base == 0) {
        v = sp[col];
        j = 1;
      }
#pragma unroll 16
      for (; j < n; ++j) v += sp[j * kPartial + col];
    } else {
      float b = __int_as_float(0x7f800000);  // +inf
      int i = 0x7fffffff;
      for (int j = lane; j < n; j += 32) {
        const float pv = sp[j * kPartial];
        if (pv < b) {
          b = pv;
          i = __float_as_int(sp[j * kPartial + 1]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_down_sync(0xffffffffu, b, off);
        const int oi = __shfl_down_sync(0xffffffffu, i, off);
        if (ob < b || (ob == b && oi < i)) {
          b = ob;
          i = oi;
        }
      }
      if (base == 0) {
        best = sp[0];
        bi = __float_as_int(sp[1]);
      }
      if (b < best) {  // strict: earlier partials hold lower flat indices
        best = b;
        bi = i;
      }
    }
    if (base + chunk < N) __syncthreads();
  }
  if (warp >= kFoldWarps) {
    if (kAppend)
      step_copy_scan(ap.st, ap.in, t - 32 * kFoldWarps,
                     kFinalizeThreads - 32 * kFoldWarps);
    return;
  }
  if (warp == 1 && lane == 0) {
    pair[0] = best;
    pair[1] = __int_as_float(bi);
  }
  asm volatile("bar.sync 1, 64;" ::: "memory");  // warps 0 and 1
  if (warp != 0) return;
  float sums[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) sums[k] = __shfl_sync(0xffffffffu, v, k);
  if (lane != 0) return;
  best = pair[0];
  bi = __float_as_int(pair[1]);
  const int num_points = row_points(nums, num, r);
  const int LL = L * L;
  const int ai = bi / LL, xi = (bi / L) % L, yi = bi % L;
  const bool apply = best < 0.f;
  float o[13];
  o[1] = apply ? dls[xi] : 0.f;
  o[2] = apply ? dls[yi] : 0.f;
  o[3] = apply ? dths[ai] : 0.f;

  const float s = sums[0];
  const float u[3] = {sums[1], sums[2], sums[3]};
  const float kk[3][3] = {{sums[4], sums[5], sums[6]},
                          {sums[5], sums[7], sums[8]},
                          {sums[6], sums[8], sums[9]}};
  const bool ok = s < 0.f;
  const float safe = ok ? s : -1.f;
  const float fallback[3] = {1.f, 1.f, 0.25f};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      o[4 + 3 * i + j] =
          ok ? kk[i][j] / safe + (u[i] * u[j]) / (safe * safe)
             : (i == j ? fallback[i] : 0.f);
  const int used = min(max_beams, num_points);
  o[0] = best / (float)max(used, 1);
  out += (size_t)r * 13;
#pragma unroll
  for (int i = 0; i < 13; ++i) out[i] = o[i];
  if (kAppend) step_constraint(ap.st, ap.in, o + 1, o + 4);
}

}  // namespace

// The finalize of a stack read by the rule above (blk = A: one [R, A *
// per, 12] buffer); K6's and KB3's entries (candidate_gather.cu) launch it
// too.
cudaError_t ndt2d::split_finalize(const float* gathered, int R, int A,
                                  int L, int blk, int per, const int* nums,
                                  int num, int max_beams, const float* dths,
                                  const float* dls, float* out,
                                  cudaStream_t st) {
  if (A < 1 || blk < 1 || blk > A || per < 1 ||
      reinterpret_cast<uintptr_t>(gathered) % 16 != 0)
    return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  finalize<false><<<R, kFinalizeThreads, 0, st>>>(gathered, R, A, L, blk,
                                                  per, nums, num, max_beams,
                                                  dths, dls, out, Append{});
  return cudaGetLastError();
}

namespace {

// A split search's finalize, planned (k2.SplitPlan): the stack it reads,
// its shape (with the partials an angle), the lattice (dths [A], dls [L]
// f32) and max_beams, packed once (the lattice again when the matcher's
// changes).
struct SplitFinalize {
  const float* gathered;
  const float* dths;
  const float* dls;
  int R, A, L, blk, per, max_beams;
};

}  // namespace

// table [R,G,H*W,32] f32 (16-byte aligned), origin [R,G,2] f32, points
// [R,P,2] f32, pmask [R,P] u8, nums [R] i32 (or null: every row has `num`
// points), pose [R,3] f32, dths [A] f32, dls [L] f32; scratch partial
// [R,A,12] f32; out [R,13] f32; scores [R,A,L,L] f32 or null; the tile
// plan (candidate_scores.py::tile_plan): kx, ky, nxg, nyg, threads.
NDT2D_API int ndt2d_candidate_scores(
    const void* table, const void* origin, int G, float cell, int W, int H,
    const void* points, const void* pmask, int R, int P, const void* nums,
    int num, int max_beams, const void* pose, const void* dths, int A,
    const void* dls, int L, void* partial, void* out, void* scores, int kx,
    int ky, int nxg, int nyg, int threads, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int plan[5] = {kx, ky, nxg, nyg, threads};
  const cudaError_t err = launch_scores(
      plan, A, R, st, static_cast<const float*>(table),
      static_cast<const float*>(origin), G, cell, W, H,
      static_cast<const float*>(points), static_cast<const uint8_t*>(pmask),
      P, static_cast<const int*>(nums), num, max_beams,
      static_cast<const float*>(pose), static_cast<const float*>(dths), 0,
      static_cast<const float*>(dls), L, static_cast<float*>(partial),
      static_cast<float*>(scores));
  if (err != cudaSuccess) return (int)err;
  return (int)ndt2d::split_finalize(
      static_cast<const float*>(partial), R, A, L, A, 1,
      static_cast<const int*>(nums), num, max_beams,
      static_cast<const float*>(dths), static_cast<const float*>(dls),
      static_cast<float*>(out), st);
}

// K12, first half: the partials [R, A, 12] f32 of angles a0 .. a0 + A - 1 of
// the lattice dths (other arguments and the plan as above); no finalize.
NDT2D_API int ndt2d_candidate_partials(
    const void* table, const void* origin, int G, float cell, int W, int H,
    const void* points, const void* pmask, int R, int P, const void* nums,
    int num, int max_beams, const void* pose, const void* dths, int a0,
    int A, const void* dls, int L, void* partial, int kx, int ky, int nxg,
    int nyg, int threads, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int plan[5] = {kx, ky, nxg, nyg, threads};
  const cudaError_t err = launch_scores(
      plan, A, R, st, static_cast<const float*>(table),
      static_cast<const float*>(origin), G, cell, W, H,
      static_cast<const float*>(points), static_cast<const uint8_t*>(pmask),
      P, static_cast<const int*>(nums), num, max_beams,
      static_cast<const float*>(pose), static_cast<const float*>(dths), a0,
      static_cast<const float*>(dls), L, static_cast<float*>(partial),
      nullptr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K12, second half: out [R, 13] from the partials [R, A, 12] of all A angles
// in angle order (nums, num, max_beams, dths [A], dls [L] as above).
NDT2D_API int ndt2d_candidate_finalize(const void* partial, int R, int A,
                                       int L, const void* nums, int num,
                                       int max_beams, const void* dths,
                                       const void* dls, void* out,
                                       void* stream) {
  return (int)ndt2d::split_finalize(
      static_cast<const float*>(partial), R, A, L, A, 1,
      static_cast<const int*>(nums), num, max_beams,
      static_cast<const float*>(dths), static_cast<const float*>(dls),
      static_cast<float*>(out), reinterpret_cast<cudaStream_t>(stream));
}

// K12, second half, planned: out [R, 13] from the split search's gathered
// send buffers as they lie (*plan: the stack, its shape and the lattice;
// the rule above finalize); nums [R] i32 or null (every row has `num`
// points).
NDT2D_API int ndt2d_candidate_finalize_planned(const void* plan,
                                               const void* nums, int num,
                                               void* out, void* stream) {
  const SplitFinalize& p = *static_cast<const SplitFinalize*>(plan);
  return (int)ndt2d::split_finalize(
      p.gathered, p.R, p.A, p.L, p.blk, p.per, static_cast<const int*>(nums),
      num, p.max_beams, p.dths, p.dls, static_cast<float*>(out),
      reinterpret_cast<cudaStream_t>(stream));
}

// The planned finalize of one row (plan->R = 1) with the fused SLAM step's
// append in the same launch: *state the step's StepState (kernels/
// slam_step.py::SlamPlan), has_prior, slots i and j, the constraint's
// begin id, est [3] f32, scan_points [P,2] f32, scan_mask [P] u8.  out is
// written as ndt2d_candidate_finalize_planned writes it; the state as
// ndt2d_slam_append writes it from that row's correction and covariance.
NDT2D_API int ndt2d_candidate_finalize_append(
    const void* plan, const void* nums, int num, void* out,
    const void* state, int has_prior, int i, int j, int begin_id,
    const void* est, const void* scan_points, const void* scan_mask,
    void* stream) {
  const SplitFinalize& p = *static_cast<const SplitFinalize*>(plan);
  if (p.R != 1 || p.A < 1 || p.blk < 1 || p.blk > p.A || p.per != 1 ||
      reinterpret_cast<uintptr_t>(p.gathered) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Append ap = {*static_cast<const StepState*>(state),
                     {has_prior, i, j, begin_id,
                      static_cast<const float*>(est),
                      static_cast<const float*>(scan_points),
                      static_cast<const uint8_t*>(scan_mask)}};
  finalize<true><<<1, kFinalizeThreads, 0,
                   reinterpret_cast<cudaStream_t>(stream)>>>(
      p.gathered, 1, p.A, p.L, p.blk, 1, static_cast<const int*>(nums), num,
      p.max_beams, p.dths, p.dls, static_cast<float*>(out), ap);
  return (int)cudaGetLastError();
}

// sizeof(SplitFinalize), for the ctypes mirror's check.
NDT2D_API int ndt2d_split_plan_size() { return (int)sizeof(SplitFinalize); }
