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
// the kernel reads K1's table as K2 does.
//
// What bounds it on the card: A x L x L x B = 3.5e6 (candidate, beam)
// terms a row at the coarse shape, each a 32-byte cell record, the
// quadratic form's seven roundings, the clamp, an exp and the add: about
// 30 operations.  The XLA program materializes [A, L, L, B] intermediates
// in device memory; here nothing but the per-block partials leaves the SM.
// Design (candidate_gather.py::plan sets the numbers): one block of 256
// threads an (angle, row) covers all of the angle's L x L offsets.
//  - Beams are staged a chunk at a time, two stages in flight: while the
//    block scores chunk q, it stages chunk q + 1 (and rotates chunk q + 2's
//    beams, R(theta + dth) p + pose_xy, once an angle).  A stage holds,
//    per beam, for every (beam, dx) and (beam, dy) the shifted coordinate
//    w = r + d and the index of its cell (int)floorf((w - origin) / cell)
//    (- row0 in y) - the twin's own float32 expressions, computed once
//    instead of once a candidate - relative to the beam's window: the
//    winx x winy cells from the cell of its first offsets, whose records
//    (the first 8 floats of K1's patch-table rows) are copied in with
//    cp.async, zeros (not scorable) off the grid and for a masked beam.
//  - A thread owns kx dx rows x ky dy columns (tx + i nxg, ty + j nyg); a
//    term reads its two entries and its record from shared memory, forms
//    the exponent in the twin's order, and an invalid term (off the grid,
//    not scorable, masked) takes an exponent of -inf, whose exp is +0: a
//    sum of non-negative terms keeps its bits.  The beam loop has no
//    branch a beam.  A chunk in which some offset leaves its beam's window
//    (a lattice wider than the plan's window) runs the twin's term as it
//    is, gathering from the table: bit for bit the same sum.
//  - Each candidate sums its beams in order from 0 (per grid at G > 1,
//    then the mean ((((0 + p0) + p1) + p2) + p3) / G); the block writes its
//    scores to shared memory and folds them tile by tile, 256 offsets a
//    tile, through lattice::reduce_tile: the (angle, tile) partials of the
//    one-block-a-tile design.  A second launch, one block per row, combines
//    a row's partials in order and finalizes: K2's fold
//    (candidate_scores.cu's finalize through ndt2d::split_finalize, at
//    `per` = the tiles an angle; lanes add the sums, a warp finds the
//    (min, first index)).  Where no tile covers the lattice in one pass (L >
//    42), a block a pass writes its scores to a field in device memory and
//    field_tiles folds the field into the same partials; KB3's field
//    (nothing to fold) takes a block a pass too.
// On an H100 (PERF.md §6) the time is set neither by the exp (without
// it, 3% less) nor by the record loads (16%): a block spends about a third
// of its cycles staging, when every warp waits on the same dependent
// loads and divisions, and the terms' own chains are latency-bound.
// A row's blocks read only that row's inputs, so its bits do not depend on
// R.  The [A, L, L] scores never reach device memory, except through the
// optional debug output used to check the kernel against its twin.
//
// K12 (a device mesh): the two launches are also entries of their own, as
// K2's are.  ndt2d_candidate_gather_partials scores a contiguous block of
// angles from global angle a0 (flat indices stay global) and writes its
// (angle, tile) partials; ndt2d_candidate_gather_finalize combines the
// partials of all A angles in one [R, A * tiles, 12] buffer, in (angle,
// tile) order: bit for bit the one-launch search.  A split search's
// planned finalize (k2.SplitPlan at per = tiles) reads the gathered send
// buffers in place through ndt2d_candidate_finalize_planned.
//
// KB3 (a y-stripe-sharded map, ndt_2d_tpu/parallel/ndt_blocks.py::
// match_scan_sharded_map, :169-217): ndt2d_stripe_field runs the same
// scoring over the whole lattice against one stripe's cells, a beam
// counting only where its GLOBAL bin lies in the stripe's rows [row0,
// row0 + h), and writes the raw [A, L, L] field, no reduction (the stripe
// table is KB1's, [h * W, 32]).  The ranks all-gather their fields in rank
// order, and ndt2d_field_match turns the gathered stack into the [13] row
// in one launch (its note is above the kernel, field_match).  At one
// stripe (row0 = 0, h = H) the field is the one-launch search's candidate
// scores bit for bit, and so is the row.
#include "lattice.cuh"

namespace {

using lattice::kTile;  // the threads of a block
constexpr float kInf = __builtin_huge_valf();

// candidate_gather.py::plan: thread t = tx * nyg + ty (tx < nxg) takes the
// dx rows x0 + tx + i nxg (i < kx) and the dy columns ty + j nyg (j < ky)
// of pass p (x0 = p nxg kx); `chunk` beams staged at a time, each with a
// window of winx x winy cell records.  Fused: one block an (angle, row)
// runs its one pass and folds the angle's scores from shared memory; else
// a block a pass (blockIdx.x) writes its scores to the field.  (kx, ky) is
// one of the tiles the kernel is built for (candidate_gather.py::TILES).
struct Plan {
  int kx, ky, nxg, nyg, passes, chunk, fused, winx, winy;
};

// A launch's operands: table [R,G,H*W,32], origin [R,G,2], points [R,P,2],
// pmask [R,P], nums [R] (or null: every row has `num` points), pose [R,3],
// dths (the whole lattice's angles; the launch scores a0 .. a0 + A - 1), dls
// [L]; the grid's cells are the rows [row0, row0 + H) of a grid of width W
// binned at `origin` (row0 = 0: the whole grid).  Outputs: the partials [R,
// A * tiles, 12] (or null: no reduction) and the field [R, A, L, L] (or
// null).
struct Lattice {
  const float* table;
  const float* origin;
  const float* points;
  const uint8_t* pmask;
  const int* nums;
  const float* pose;
  const float* dths;
  const float* dls;
  float* partial;
  float* field;
  int G, W, row0, H, P, num, max_beams, a0, A, L, R;
  float cell;
};

__device__ __forceinline__ int row_points(const int* nums, int num, int r) {
  return nums != nullptr ? nums[r] : num;
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (bytes == 16)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

// A staged chunk's shared memory: per beam a window of records, the first
// 8 floats of a patch-table row as lo = (mean_x, mean_y, i00, i01) and hi
// = (i11, scorable) (zeros off the grid: not scorable), and the beam's
// (beam, dx) and (beam, dy) entries: the index of the offset's cell in the
// window (x: its column; y: beam j's first record + its row times winx)
// and the shifted coordinate.
struct Stage {
  float4* lo;  // [chunk * winx * winy]
  float2* hi;  // [chunk * winx * winy]
  float2* xe;  // [chunk * nxg kx]: (column, wx)
  float2* ye;  // [chunk * L]: (record, wy)
};

// A chunk's beams: the rotated beam R(theta + dth) p + pose_xy, its
// window's first cell (ix0, iy0) and its mask; `slow`: some offset of some
// beam of the chunk leaves its window, and the chunk's terms gather from
// the table.
struct Beams {
  float* x;
  float* y;
  int* ix0;
  int* iy0;
  int* masked;
  int* slow;
};

__host__ __device__ inline size_t stage_bytes(const Plan& p, int L) {
  const size_t b = (size_t)p.chunk * (24 * (size_t)p.winx * p.winy +
                                      8 * (size_t)(p.nxg * p.kx + L));
  return (b + 15) / 16 * 16;  // the next stage's records are float4s
}

// Dynamic shared memory of a block: two stages and three chunks of beams
// (5 words a beam, 1 a chunk); fused, the angle's scores [L * L] after the
// last chunk, in the same bytes.
__host__ __device__ inline size_t smem_bytes(const Plan& p, int L) {
  const size_t stages = 2 * stage_bytes(p, L) + 12 * (5 * (size_t)p.chunk + 1);
  const size_t scores = p.fused ? (size_t)4 * L * L : 0;
  return stages > scores ? stages : scores;
}

// Grid (fused ? 1 : passes, A, R): angle a0 + blockIdx.y of the lattice,
// row blockIdx.z; G grids a row.  A thread's KX x KY candidates are
// compile-time, so the compiler interleaves their terms; three blocks an
// SM (at most 85 registers a thread) measured faster on an H100 than two
// with more registers or four with fewer (PERF.md §6).
template <int KX, int KY>
__global__ void __launch_bounds__(kTile, 3) gather_lattice(const Lattice k,
                                                           const Plan plan) {
  extern __shared__ float4 smem4[];
  const int L = k.L;
  const int XW = plan.nxg * KX;  // a pass's dx rows
  const int WW = plan.winx * plan.winy;
  float* cand_s = reinterpret_cast<float*>(smem4);  // [L*L], at the end
  // Stage b (of 2) and the beams of set b (of 3), as pointers formed from
  // the set's index (an array of them would live in local memory).
  const size_t stage_b = stage_bytes(plan, L);
  auto stage = [&](int b) {
    Stage sg;
    sg.lo = reinterpret_cast<float4*>(reinterpret_cast<char*>(smem4) +
                                      b * stage_b);
    sg.hi = reinterpret_cast<float2*>(sg.lo + plan.chunk * WW);
    sg.xe = sg.hi + plan.chunk * WW;
    sg.ye = sg.xe + plan.chunk * XW;
    return sg;
  };
  auto beams = [&](int b) {
    Beams bm;
    bm.x = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                    2 * stage_b) +
           b * (5 * plan.chunk + 1);
    bm.y = bm.x + plan.chunk;
    bm.ix0 = reinterpret_cast<int*>(bm.y + plan.chunk);
    bm.iy0 = bm.ix0 + plan.chunk;
    bm.masked = bm.iy0 + plan.chunk;
    bm.slow = bm.masked + plan.chunk;
    return bm;
  };

  const int a = blockIdx.y;
  const size_t r = blockIdx.z;
  const int num_points = row_points(k.nums, k.num, r);
  const float* table = k.table + r * k.G * k.W * k.H * 32;
  const float* origin = k.origin + r * k.G * 2;
  const float* points = k.points + r * k.P * 2;
  const uint8_t* pmask = k.pmask + r * k.P;
  const float* pose = k.pose + r * 3;
  const int LL = L * L;
  float* field = k.field != nullptr ? k.field + (r * k.A + a) * LL : nullptr;
  const int t = threadIdx.x;
  const int tx = t / plan.nyg, ty = t % plan.nyg;
  const bool active = tx < plan.nxg;

  const ndt2d::Subsample sub(num_points, k.max_beams);
  const int ag = k.a0 + a;  // the angle's index in the whole lattice
  const float th = pose[2] + k.dths[ag];
  const float c = cosf(th), s = sinf(th);
  // The chunks: q = g per_grid + i holds beams i chunk .. of grid g.
  const int per_grid = (sub.used + plan.chunk - 1) / plan.chunk;
  const int nq = k.G * per_grid;
  auto beams_of = [&](int q) {
    return min(plan.chunk, sub.used - (q % per_grid) * plan.chunk);
  };

  int lys[KY];
#pragma unroll
  for (int j = 0; j < KY; ++j) lys[j] = min(ty + j * plan.nyg, L - 1);
  const int p0 = plan.fused ? 0 : blockIdx.x;
  const int p1 = plan.fused ? plan.passes : p0 + 1;
  for (int pass = p0; pass < p1; ++pass) {
    const int x0 = pass * XW;
    const float dx_lo = k.dls[x0];
    // Chunk q's beams (thread j < nb: one beam) into set q % 3: rotated
    // once per angle; its window starts at the cell of its first offsets.
    auto stage_beams = [&](int q) {
      const int g = q / per_grid, base = (q % per_grid) * plan.chunk;
      const float ox = origin[2 * g], oy = origin[2 * g + 1];
      const Beams b = beams(q % 3);
      if (t == 0) b.slow[0] = WW == 0;
      for (int j = t; j < beams_of(q); j += kTile) {
        const int idx = sub.index(base + j, num_points, k.P);
        const float px = points[2 * idx], py = points[2 * idx + 1];
        const float bx = c * px - s * py + pose[0];
        const float by = s * px + c * py + pose[1];
        b.x[j] = bx;
        b.y[j] = by;
        b.ix0[j] = (int)floorf((bx + dx_lo - ox) / k.cell);
        b.iy0[j] = (int)floorf((by + k.dls[0] - oy) / k.cell) - k.row0;
        b.masked[j] = !pmask[idx];
      }
    };
    // matcher.py::_candidate_scores_gather's per-axis parts of chunk q into
    // stage q & 1 (its beams staged): the entries, and the window's records
    // copied with cp.async (zeros, not scorable, for a cell off the grid
    // and for a masked beam, so that every term of it adds +0).
    // Who stages what: of n items a beam, thread t takes item t % n of
    // beams t / n, t / n + kTile / n, ... (n <= kTile), else item t,
    // t + kTile, ... of every beam; fixed for the pass, so the staging
    // divides no integers.
    struct Share {
      int item, beam0, step, items;  // items: a thread's items a beam
    };
    auto share = [&](int n) {
      if (n <= 0) return Share{0, 0, 1, 0};
      if (n > kTile) return Share{t, 0, 1, (n - t + kTile - 1) / kTile};
      const int per = kTile / n;
      return t < per * n ? Share{t % n, t / n, per, 1} : Share{0, 0, 1, 0};
    };
    const Share sx = share(XW), sy = share(L), sr = share(WW);
    const int rcy = sr.item / max(plan.winx, 1);  // a record's window row
    const int rcx = sr.item - rcy * plan.winx;    // and column
    // matcher.py::_candidate_scores_gather's per-axis parts of chunk q into
    // stage q & 1 (its beams staged): the entries, and the window's records
    // copied with cp.async (zeros, not scorable, for a cell off the grid
    // and for a masked beam, so that every term of it adds +0).  An offset
    // outside its beam's window sends the chunk to the table.
    auto stage_rest = [&](int q) {
      const int g = q / per_grid, nb = beams_of(q);
      const float ox = origin[2 * g], oy = origin[2 * g + 1];
      const Beams b = beams(q % 3);
      const Stage sg = stage(q & 1);
      for (int j = sx.beam0; j < nb; j += sx.step)
        for (int m = 0; m < sx.items; ++m) {
          const int l = sx.item + m * kTile;
          const float wx = b.x[j] + k.dls[min(x0 + l, L - 1)];
          const int col = (int)floorf((wx - ox) / k.cell) - b.ix0[j];
          if (col < 0 || col >= plan.winx) b.slow[0] = 1;
          sg.xe[j * XW + l] = make_float2(
              __int_as_float(min(max(col, 0), plan.winx - 1)), wx);
        }
      for (int j = sy.beam0; j < nb; j += sy.step)
        for (int m = 0; m < sy.items; ++m) {
          const int l = sy.item + m * kTile;
          const float wy = b.y[j] + k.dls[l];
          const int row =
              (int)floorf((wy - oy) / k.cell) - k.row0 - b.iy0[j];
          if (row < 0 || row >= plan.winy) b.slow[0] = 1;
          sg.ye[j * L + l] = make_float2(
              __int_as_float(j * WW + min(max(row, 0), plan.winy - 1) *
                                          plan.winx),
              wy);
        }
      // The records: a thread's window cell (rcx, rcy) of its beams (a
      // window holds at most kTile cells: candidate_gather.py::plan).
      for (int j = sr.beam0; sr.items && j < nb; j += sr.step) {
        const int e = j * WW + sr.item;
        const int ix = b.ix0[j] + rcx, iy = b.iy0[j] + rcy;
        if (!b.masked[j] && ix >= 0 && ix < k.W && iy >= 0 && iy < k.H) {
          const float* rec =
              table + ((size_t)g * k.W * k.H + (size_t)iy * k.W + ix) * 32;
          cp_async(&sg.lo[e], rec, 16);
          cp_async(&sg.hi[e], rec + 4, 8);
        } else {
          sg.lo[e] = make_float4(0.f, 0.f, 0.f, 0.f);
          sg.hi[e] = make_float2(0.f, 0.f);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    int lxs[KX];
#pragma unroll
    for (int i = 0; i < KX; ++i) lxs[i] = min(tx + i * plan.nxg, XW - 1);
    float acc[KX][KY], mean_sum[KX][KY];
#pragma unroll
    for (int i = 0; i < KX; ++i)
#pragma unroll
      for (int j = 0; j < KY; ++j) acc[i][j] = mean_sum[i][j] = 0.f;
    __syncthreads();  // the last pass's stages are read
    if (nq > 0) stage_beams(0);
    __syncthreads();
    if (nq > 0) stage_rest(0);
    if (nq > 1) stage_beams(1);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int q = 0; q < nq; ++q) {
      // Chunk q + 1's entries and records go in while q is scored (its
      // stage was last read by chunk q - 1, before the barrier), chunk
      // q + 2's beams into the third set.
      if (q + 1 < nq) stage_rest(q + 1);
      if (q + 2 < nq) stage_beams(q + 2);
      const int g = q / per_grid, nb = beams_of(q);
      const Beams b = beams(q % 3);
      const Stage sg = stage(q & 1);
      // The candidates' terms, beams in order.
      if (active && !b.slow[0]) {
        // No branch a beam: the warps' loads and arithmetic interleave.
#pragma unroll 1
        for (int j = 0; j < nb; ++j) {
          float2 ex[KX], ey[KY];
#pragma unroll
          for (int i = 0; i < KX; ++i) ex[i] = sg.xe[j * XW + lxs[i]];
#pragma unroll
          for (int jj = 0; jj < KY; ++jj) ey[jj] = sg.ye[j * L + lys[jj]];
#pragma unroll
          for (int i = 0; i < KX; ++i)
#pragma unroll
            for (int jj = 0; jj < KY; ++jj) {
              const int w =
                  __float_as_int(ex[i].x) + __float_as_int(ey[jj].x);
              const float4 lo = sg.lo[w];
              const float2 hi = sg.hi[w];
              const float qx = ex[i].y - lo.x;
              const float qy = ey[jj].y - lo.y;
              const float e = -0.5f * (lo.z * qx * qx +
                                       2.f * lo.w * qx * qy + hi.x * qy * qy);
              // Off the grid, not scorable or masked: an exponent of -inf,
              // +0.
              acc[i][jj] += expf(fminf(hi.y > 0.5f ? e : -kInf, 0.f));
            }
        }
      } else if (active) {  // the twin's terms as they are, from the table
        const float* gtable = table + (size_t)g * k.W * k.H * 32;
        const float ox = origin[2 * g], oy = origin[2 * g + 1];
        for (int j = 0; j < nb; ++j) {
          if (b.masked[j]) continue;  // every term +0
#pragma unroll
          for (int i = 0; i < KX; ++i)
#pragma unroll
            for (int jj = 0; jj < KY; ++jj) {
              const float wx = sg.xe[j * XW + lxs[i]].y;
              const float wy = sg.ye[j * L + lys[jj]].y;
              const int ix = (int)floorf((wx - ox) / k.cell);
              const int iy = (int)floorf((wy - oy) / k.cell) - k.row0;
              const bool inb = ix >= 0 && iy >= 0 && ix < k.W && iy < k.H;
              const float* rec =
                  gtable + (size_t)(inb ? iy * k.W + ix : 0) * 32;
              const float4 lo = *reinterpret_cast<const float4*>(rec);
              const float2 hi = *reinterpret_cast<const float2*>(rec + 4);
              const float qx = wx - lo.x;
              const float qy = wy - lo.y;
              const float e = -0.5f * (lo.z * qx * qx +
                                       2.f * lo.w * qx * qy + hi.x * qy * qy);
              acc[i][jj] += inb && hi.y > 0.5f ? expf(fminf(e, 0.f)) : 0.f;
            }
        }
      }
      if (active) {
        if (q % per_grid == per_grid - 1) {  // grid g's last chunk
#pragma unroll
          for (int i = 0; i < KX; ++i)
#pragma unroll
            for (int j = 0; j < KY; ++j) {
              mean_sum[i][j] = mean_sum[i][j] + -acc[i][j];
              if (g + 1 < k.G) acc[i][j] = 0.f;
            }
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
    if (!active) continue;
#pragma unroll
    for (int i = 0; i < KX; ++i)
#pragma unroll
      for (int j = 0; j < KY; ++j) {
        const int lx = x0 + tx + i * plan.nxg, ly = ty + j * plan.nyg;
        if (lx >= L || ly >= L) continue;
        // At G = 1 the one grid's -sum, else the mean over the grids.
        const float v = k.G > 1 ? mean_sum[i][j] / (float)k.G : -acc[i][j];
        const int f = lx * L + ly;
        if (plan.fused) cand_s[f] = v;  // the stages are read: see below
        if (field != nullptr) field[f] = v;
      }
  }
  if (!plan.fused || k.partial == nullptr) return;

  // matcher.py::reduce_candidates, tile by tile: x = (dx, dy, dth).  The
  // one pass's scores went to cand_s after the last chunk's barrier (a
  // fused plan has one pass: candidate_gather.py::plan).
  __syncthreads();
  const int tiles = (LL + kTile - 1) / kTile;
  float* partial = k.partial + (r * k.A + a) * tiles * lattice::kPartial;
  for (int q = 0; q < tiles; ++q) {
    const int f = q * kTile + t;
    const bool live = f < LL;
    const int lx = live ? f / L : 0, ly = live ? f % L : 0;
    lattice::reduce_tile(live ? cand_s[f] : 0.f, live, ag * LL + f,
                         k.dls[lx], k.dls[ly], k.dths[ag],
                         partial + q * lattice::kPartial);
    __syncthreads();  // reduce_tile's warp sums are read
  }
}

// The reduction of a field.  Grid (tiles, A, R): the tile blockIdx.x of
// angle a0 + blockIdx.y of row blockIdx.z of a [R, A, L, L] field; the
// partials [R, A * tiles, 12].
__global__ void __launch_bounds__(kTile) field_tiles(
    const float* __restrict__ field, const float* __restrict__ dths, int a0,
    const float* __restrict__ dls, int A, int L,
    float* __restrict__ partial) {
  const int tile = blockIdx.x, tiles = gridDim.x;
  const int a = blockIdx.y, ag = a0 + a;
  const size_t r = blockIdx.z;
  const int LL = L * L;
  const int t = tile * kTile + threadIdx.x;
  const bool live = t < LL;
  const int lx = live ? t / L : 0;
  const int ly = live ? t % L : 0;
  const float cand = live ? field[(r * A + a) * LL + t] : 0.f;
  lattice::reduce_tile(cand, live, ag * LL + t, dls[lx], dls[ly], dths[ag],
                       partial + ((r * A + a) * tiles + tile) *
                                     lattice::kPartial);
}

// KB3's match: the stripes' fields, all-gathered in rank order, to the
// [13] row in one launch.
//
// Replaces, in ndt_2d_tpu/parallel/ndt_blocks.py::match_scan_sharded_map,
// the psum of the stripes' fields over 'space' (:212), reduce_candidates
// (:216) and finalize_match (:217).  Every rank runs it on the same
// gathered stack, so every rank holds the same bits.
//
// What bounds it on the card: bytes.  The stack's S x A x L x L floats are
// read once, and the A x tiles partials (48 bytes each) are written and
// read back once; at S = 2 and 80 x 21 x 21 that is 282,240 + 15,360
// bytes, 0.0000888 ms at 3.35 TB/s, far below one launch.  So the floor is
// one launch and the fold's serial chain, and the design has no more than
// that: one launch where there were three (K12's rank_sum into a summed
// field, field_tiles into the partials, K2's finalize launch), no summed
// field in device memory, and the scratch and ticket kept by the plan
// (nothing allocated a match but the row).
//
// Design.  Grid (tiles, A) of 256 threads, thread t of block (q, a) the
// candidate f = q * 256 + t of angle a.  The block reads its tile from
// each of the S stripes, neighbouring threads on neighbouring addresses,
// one float a load: 16-byte loads staged through shared memory timed no
// faster on the H100 at 80 x 21 x 21 (PERF.md §6, KB3's row), so there
// is one load path, whatever the alignment.  Each thread adds its
// candidate's stripes in rank order from rank 0's value, as
// shard_combine.cu's rank_sum adds, so the sum has the summed field's
// bits.
// lattice::reduce_tile folds the tile into its (angle, tile) partial,
// field_tiles' tree; then, after __threadfence(), the block takes a
// ticket, and the last of the A x tiles blocks folds the partials with
// lattice::finalize_row and resets the ticket for the plan's next launch
// on the stream (K11's lattice launch does the same, correlative.cu).
//
// Why the fold has the bits of K2's finalize launch (ndt2d::split_finalize)
// on the same partials: both add each Olson sum by one lane, serially, in
// (angle, tile) order from the first partial; both find a round's (min,
// first index) by lanes over strided partials with a strict `<` and a
// shuffle tree that breaks ties by the lower index, and carry it across
// rounds with a strict `<` from the first partial, which is the serial
// scan's winner whatever the round's length (256 partials here, 512 there);
// and both finish the row with the same expressions.
struct FieldMatch {
  const float* stack;   // [S, A * L * L], rank r's field in row r
  const float* dths;    // [A]
  const float* dls;     // [L]
  float* partial;       // scratch [A * tiles, 12]
  unsigned* ticket;     // [1], 0 before and after a launch
  int S, A, L, max_beams;
};

__global__ void __launch_bounds__(kTile) field_match(const FieldMatch m,
                                                     int num_points,
                                                     float* __restrict__ out) {
  __shared__ __align__(16) float sp[(lattice::kStage + 1) *
                                    lattice::kPartial];  // the fold's
  __shared__ bool last;
  const int tile = blockIdx.x, tiles = gridDim.x, a = blockIdx.y;
  const int L = m.L, LL = L * L, t = threadIdx.x;
  const int f = tile * kTile + t;
  const bool live = f < LL;
  const size_t stride = (size_t)m.A * LL;  // a stripe's field
  const float* first = m.stack + (size_t)a * LL + f;
  float cand = 0.f;
  if (live) {
    cand = first[0];
    for (int s = 1; s < m.S; ++s) cand += first[s * stride];
  }
  const int lx = live ? f / L : 0, ly = live ? f % L : 0;
  lattice::reduce_tile(cand, live, a * LL + f, m.dls[lx], m.dls[ly],
                       m.dths[a],
                       m.partial + ((size_t)a * tiles + tile) *
                                       lattice::kPartial);
  __threadfence();  // this block's partial before its ticket
  __syncthreads();
  if (t == 0) last = atomicAdd(m.ticket, 1u) == (unsigned)(m.A * tiles - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  lattice::finalize_row<true, true>(m.partial, m.A * tiles, L, num_points,
                                    m.max_beams, m.dths, m.dls, out, sp);
  if (t == 0) *m.ticket = 0u;
}

// gather_lattice<KX, KY> with `smem` bytes of dynamic shared memory (above
// the default 48 KB the card is asked first, once a device and size).
template <int KX, int KY>
cudaError_t launch_lattice(const Lattice& k, const Plan& plan, size_t smem,
                           cudaStream_t st) {
  static int last_dev = -1;
  static size_t allowed = 0;
  if (smem + 2048 > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && (dev != last_dev || smem > allowed)) {
      err = cudaFuncSetAttribute(gather_lattice<KX, KY>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err == cudaSuccess) {
        last_dev = dev;
        allowed = smem;
      }
    }
    if (err != cudaSuccess) {
      cudaGetLastError();  // a refusal no later launch's check reports again
      return err;
    }
  }
  gather_lattice<KX, KY>
      <<<dim3(plan.fused ? 1 : plan.passes, k.A, k.R), kTile, smem, st>>>(
          k, plan);
  return cudaGetLastError();
}

// The scoring launch and, where its scores are not folded in the block,
// the field's reduction.  A plan that is not one of candidate_gather.py::
// plan's shapes fails without a launch.
int score(const Lattice& k, const Plan& plan, cudaStream_t st) {
  if (plan.nxg < 1 || plan.nyg < 1 || plan.nxg * plan.nyg > kTile ||
      plan.nyg * plan.ky < k.L || plan.passes * plan.nxg * plan.kx < k.L ||
      plan.chunk < 1 || plan.winx < 0 || plan.winy < 0 ||
      plan.winx * plan.winy > kTile ||
      (plan.fused && plan.passes != 1) ||
      (k.partial != nullptr && !plan.fused && k.field == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(plan, k.L);
  cudaError_t err;
  switch (plan.kx * 16 + plan.ky) {  // candidate_gather.py::TILES
    case 16 + 1: err = launch_lattice<1, 1>(k, plan, smem, st); break;
    case 16 + 7: err = launch_lattice<1, 7>(k, plan, smem, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  if (k.partial != nullptr && !plan.fused)
    field_tiles<<<dim3((k.L * k.L + kTile - 1) / kTile, k.A, k.R), kTile, 0,
                  st>>>(k.field, k.dths, k.a0, k.dls, k.A, k.L, k.partial);
  return (int)cudaGetLastError();
}

}  // namespace

#define NDT2D_PLAN_ARGS                                                    \
  int kx, int ky, int nxg, int nyg, int passes, int chunk, int fused,      \
      int winx, int winy

// table [R,G,H*W,32] f32 (K1's patch table; its first 8 floats a row are
// read), origin [R,G,2] f32, points [R,P,2] f32, pmask [R,P] u8, nums [R]
// i32 (or null: every row has `num` points), pose [R,3] f32, dths [A] f32,
// dls [L] f32; scratch partial [R, A * ceil(L*L / 256), 12] f32; out [R,13]
// f32; scores [R,A,L,L] f32 or null (not fused: the field, required); the
// plan candidate_gather.py::plan's.
NDT2D_API int ndt2d_candidate_gather(
    const void* table, const void* origin, int G, float cell, int W, int H,
    const void* points, const void* pmask, int R, int P, const void* nums,
    int num, int max_beams, const void* pose, const void* dths, int A,
    const void* dls, int L, void* partial, void* out, void* scores,
    NDT2D_PLAN_ARGS, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Lattice k{static_cast<const float*>(table),
                  static_cast<const float*>(origin),
                  static_cast<const float*>(points),
                  static_cast<const uint8_t*>(pmask),
                  static_cast<const int*>(nums),
                  static_cast<const float*>(pose),
                  static_cast<const float*>(dths),
                  static_cast<const float*>(dls),
                  static_cast<float*>(partial),
                  static_cast<float*>(scores),
                  G, W, 0, H, P, num, max_beams, 0, A, L, R, cell};
  const int err =
      score(k, Plan{kx, ky, nxg, nyg, passes, chunk, fused, winx, winy}, st);
  if (err != 0) return err;
  const int tiles = (L * L + kTile - 1) / kTile;
  return (int)ndt2d::split_finalize(
      static_cast<const float*>(partial), R, A, L, A, tiles,
      static_cast<const int*>(nums), num, max_beams,
      static_cast<const float*>(dths), static_cast<const float*>(dls),
      static_cast<float*>(out), st);
}

// K12, first half: the (angle, tile) partials [R, A * tiles, 12] f32 of
// angles a0 .. a0 + A - 1 of the lattice dths (other arguments as above;
// field [R,A,L,L] f32 scratch where the plan is not fused, else null).
NDT2D_API int ndt2d_candidate_gather_partials(
    const void* table, const void* origin, int G, float cell, int W, int H,
    const void* points, const void* pmask, int R, int P, const void* nums,
    int num, int max_beams, const void* pose, const void* dths, int a0,
    int A, const void* dls, int L, void* partial, void* field,
    NDT2D_PLAN_ARGS, void* stream) {
  const Lattice k{static_cast<const float*>(table),
                  static_cast<const float*>(origin),
                  static_cast<const float*>(points),
                  static_cast<const uint8_t*>(pmask),
                  static_cast<const int*>(nums),
                  static_cast<const float*>(pose),
                  static_cast<const float*>(dths),
                  static_cast<const float*>(dls),
                  static_cast<float*>(partial),
                  static_cast<float*>(field),
                  G, W, 0, H, P, num, max_beams, a0, A, L, R, cell};
  return score(k, Plan{kx, ky, nxg, nyg, passes, chunk, fused, winx, winy},
               reinterpret_cast<cudaStream_t>(stream));
}

// K12, second half: out [R, 13] from the partials [R, A * tiles, 12] of all
// A angles in (angle, tile) order.
NDT2D_API int ndt2d_candidate_gather_finalize(
    const void* partial, int R, int A, int L, const void* nums, int num,
    int max_beams, const void* dths, const void* dls, void* out,
    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int tiles = (L * L + kTile - 1) / kTile;
  return (int)ndt2d::split_finalize(
      static_cast<const float*>(partial), R, A, L, A, tiles,
      static_cast<const int*>(nums), num, max_beams,
      static_cast<const float*>(dths), static_cast<const float*>(dls),
      static_cast<float*>(out), st);
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
                                 NDT2D_PLAN_ARGS, void* stream) {
  const Lattice k{static_cast<const float*>(table),
                  static_cast<const float*>(origin),
                  static_cast<const float*>(points),
                  static_cast<const uint8_t*>(pmask),
                  nullptr,
                  static_cast<const float*>(pose),
                  static_cast<const float*>(dths),
                  static_cast<const float*>(dls),
                  nullptr,
                  static_cast<float*>(field),
                  1, W, row0, h, P, num, max_beams, 0, A, L, 1, cell};
  return score(k, Plan{kx, ky, nxg, nyg, passes, chunk, fused, winx, winy},
               reinterpret_cast<cudaStream_t>(stream));
}

// KB3, the match, planned (candidate_gather.py::FieldPlan): sizeof the
// FieldMatch block the plan packs.
NDT2D_API int ndt2d_field_match_plan_size() { return (int)sizeof(FieldMatch); }

// KB3, the match: *plan (the stack [S, A*L*L] f32 of the stripes' fields in
// rank order, dths [A] f32, dls [L] f32, the scratch [A * ceil(L*L / 256),
// 12] f32, the ticket [1] u32 at 0, S, A, L, max_beams), `num` points of
// the scan -> out [13] f32, the row ndt2d_candidate_gather_finalize writes
// from the summed field's partials.
NDT2D_API int ndt2d_field_match(const void* plan, int num, void* out,
                                void* stream) {
  const FieldMatch& m = *static_cast<const FieldMatch*>(plan);
  if (m.S < 1 || m.A < 1 || m.A > 65535 || m.L < 1 ||
      (long long)m.S * m.A * m.L * m.L >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int tiles = (m.L * m.L + kTile - 1) / kTile;
  field_match<<<dim3(tiles, m.A), kTile, 0,
                reinterpret_cast<cudaStream_t>(stream)>>>(
      m, num, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
