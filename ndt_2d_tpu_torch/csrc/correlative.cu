// K11: the correlative matcher's three device computations.
//
// Replaces the jitted XLA programs of ndt_2d_tpu/matching/correlative.py:
//  * build_field (:38): the window's points to the world frame, floor-binned
//    from the window origin (min over the window's poses - range_max) into
//    an [H, W] hit count; a separable 7-tap Gaussian blur (sigma 1 cell,
//    jnp.convolve mode="same") along rows, then along columns; then divided
//    by max(max(field), 1e-6).
//  * match_scan_field (:76): the exhaustive (angle, dx, dy) lattice; a
//    candidate's score is minus the sum over the subsampled beams of the
//    field value of the cell the rotated, shifted beam falls in (0 outside
//    the grid); then reduce_candidates and finalize_match as the NDT
//    matcher's (lattice.cuh).  With a row axis: R (window, scan, pose) rows
//    a launch, each row's bits independent of R.
//  * score_points_field (:108): minus the mean field value under the beams
//    at M poses.
//
// What bounds them on the card: the field build moves bytes (S * P points
// read, an [H, W] int and two float planes written and read back, 7 taps a
// cell a pass; 192 x 192 cells of 4 bytes are 147 kB and stay in L2); the
// lattice is K6's shape with a 4-byte cell record and no exp, so it is
// bound by its A * L * L * B (candidate, beam) terms, each (with the
// per-angle tables and windows below) three shared loads and an add, and
// by forming the tables; the point score is launch latency at M = 1.
//
// Designs.  Field: hit counts by integer atomics (exact in any order), the
// blur one thread per cell adding its 7 taps in index order from 0 (the
// taps computed once by torch and handed in), the maximum by one block
// (order-free), the division by it last; the twin does each step in the
// same order.  Point score: K3's, one warp per pose, lane l adding beams l,
// l + 32, ... from 0, then a __shfl_down_sync tree (16, 8, 4, 2, 1).
//
// Lattice (lattice_tables, entry ndt2d_correlative_match_tables).  A term
// (candidate, beam) needs the cell column ix = floor((rx_b + dx - ox) /
// cell) and the row iy = floor((ry_b + dy - oy) / cell); ix depends only on
// (angle, beam, dx) and iy only on (angle, beam, dy), so a block computes
// them once for a chunk of beams into two tables in shared memory (the
// columns of the dx its offsets span, the rows of every dy; the parent
// form, lattice_tiles, paid two IEEE divisions, two floors and a bounds
// test a term: 25.6 M divisions at the box drive's 80 x 40 x 40 x 100,
// against ~0.8 M in the tables).  The offsets' step is a fraction of a
// cell, so a beam's candidates reach a few cells: each beam's window of
// them is copied from the field into shared memory beside the tables, and
// the tables hold offsets into it, so that a term is three shared loads
// and an add, no gather from L2.  A block owns a run of tiles of kTile flat
// offsets of one (angle, row), a candidate of each a thread, each
// candidate's beams added in order from +0: the parent's float additions,
// so the scores and each tile's partial (reduce_tiles, in flat order) are
// bitwise the parent's and the twin's.  The row's last block to take its
// ticket, after a fence, folds the row's partials (finalize_row, read
// through L2, each of the ten sums a lane's chain and the (min, index) a
// warp's) and resets the ticket: one launch a match and one a batch of
// rows.  The block's shape (kernels/correlative.py::lattice_plan: one
// wave of blocks of up to 1024 threads where the lattice allows it)
// changes which block forms a partial, never its bits.
#include <algorithm>

#include "lattice.cuh"

namespace {

using lattice::kTile;
constexpr int kThreads = 256;
constexpr int kBeamChunk = 128;
constexpr int kTaps = 7;  // radius 3
constexpr int kPeakThreads = 1024;
constexpr int kWarpsPerBlock = 8;

// min over the window's poses - range_max, per axis (window_origin); one
// thread.  A window without a scan keeps FLT_MAX - range_max, as the
// reference's masked minimum does.
__global__ void field_origin(const float* __restrict__ poses,
                             const uint8_t* __restrict__ wmask, int S,
                             float range_max, float* __restrict__ origin) {
  float mx = 3.402823466e+38f, my = 3.402823466e+38f;
  for (int s = 0; s < S; ++s) {
    if (!wmask[s]) continue;
    mx = fminf(mx, poses[3 * s]);
    my = fminf(my, poses[3 * s + 1]);
  }
  origin[0] = mx - range_max;
  origin[1] = my - range_max;
}

// One thread per (scan, point): transform_points, floor-binning, and an
// integer atomic add into the cell's count.
__global__ void field_hits(const float* __restrict__ poses,
                           const float* __restrict__ points,
                           const uint8_t* __restrict__ pmask,
                           const uint8_t* __restrict__ wmask, int S, int P,
                           const float* __restrict__ origin, float cell,
                           int W, int H, int* __restrict__ hits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * P) return;
  const int s = i / P;
  if (!wmask[s] || !pmask[i]) return;
  const float th = poses[3 * s + 2];
  const float c = cosf(th), sn = sinf(th);
  const float x = points[2 * i], y = points[2 * i + 1];
  const float wx = (c * x - sn * y) + poses[3 * s];
  const float wy = (sn * x + c * y) + poses[3 * s + 1];
  const int ix = (int)floorf((wx - origin[0]) / cell);
  const int iy = (int)floorf((wy - origin[1]) / cell);
  if (ix < 0 || iy < 0 || ix >= W || iy >= H) return;
  atomicAdd(&hits[iy * W + ix], 1);
}

// One blur pass, one thread per cell: out[c] = sum over k = 0..6, in that
// order from 0, of taps[k] * in[c + (k - 3) * stride] (0 past the edge),
// along x (stride 1) or y (stride W).  `in` is the int hit count on the
// first pass and a float plane on the second.
template <typename T>
__global__ void field_blur(const T* __restrict__ in,
                           const float* __restrict__ taps, int W, int H,
                           bool along_y, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= W * H) return;
  const int x = i % W, y = i / W;
  const int n = along_y ? H : W, pos = along_y ? y : x;
  const int stride = along_y ? W : 1;
  float acc = 0.f;
  for (int k = 0; k < kTaps; ++k) {
    const int q = pos + k - kTaps / 2;
    const float v = (q >= 0 && q < n) ? (float)in[i + (k - kTaps / 2) * stride]
                                      : 0.f;
    acc = acc + taps[k] * v;
  }
  out[i] = acc;
}

// max(max(field), 1e-6) by one block.
__global__ void __launch_bounds__(kPeakThreads) field_peak(
    const float* __restrict__ field, int n, float* __restrict__ peak) {
  __shared__ float warp_max[kPeakThreads / 32];
  float m = -3.402823466e+38f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) m = fmaxf(m, field[i]);
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kPeakThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    peak[0] = fmaxf(m, 1e-6f);
  }
}

__global__ void field_scale(float* __restrict__ field, int n,
                            const float* __restrict__ peak) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) field[i] = field[i] / peak[0];
}

// The tables' sentinel: a column or row offset off the grid (or an unused
// beam's column).  A term's cell is the sum of its two entries, negative
// exactly where either is a sentinel (W H <= 2^30, checked by the entry).
constexpr int kOff = -(1 << 30);

struct LatticeTables {
  const float* field;   // [R, H*W]
  const float* origin;  // [R, 2]
  float cell;
  int W, H;
  const float* points;   // [R, P, 2]
  const uint8_t* pmask;  // [R, P]
  int P;
  const int* nums;  // [R] or null (every row has `num` points)
  int num, max_beams;
  const float* pose;  // [R, 3]
  const float *dths, *dls;
  int A, L;
  int tiles;   // tiles of kTile flat offsets an angle
  int groups;  // blocks an angle: ceil(tiles / (kG kPer))
  int nx;      // the column table's rows (the most dx a block spans)
  int cx, cy;  // a beam's field window: cx columns, cy rows of cells
  int chunk;   // beams a table chunk, a multiple of 4
  int stride;  // the tables' and windows' row stride, 4 mod 32, >= chunk
  int stage;   // partials the fold stages at a time
  float* partial;    // [R, A * tiles, kPartial]
  float* scores;     // [R, A, L, L] or null
  float* out;        // [R, 13]
  unsigned* ticket;  // [R], 0 before the launch; the folding block resets
};

// Words of shared memory a beam of a chunk takes beside its tables and
// window: its rotated x and y, used flag, window corner (x, y) and whether
// its cells fit the window.
constexpr int kBeamWords = 6;

// u / d and u % d for u d < 2^32 by a multiply-high with m = ceil(2^32 /
// d) (exact there: the error u / 2^32 stays below 1 / d).
__device__ __forceinline__ unsigned magic(unsigned d) {
  return 0xffffffffu / d + 1u;
}
__device__ __forceinline__ int quot(int u, unsigned m) {
  return (int)__umulhi((unsigned)u, m);
}

// Grid (A * groups, R), blocks of kG kTile threads: block (a * groups + j,
// r) scores the kG kPer tiles from j kG kPer of angle a of row r, thread t
// of group g a candidate of tiles j kG kPer + p kG + g, p < kPer.
// Dynamic shared memory: max(kBeamWords chunk + (nx + L + (cx + 1) (cy +
// 1)) S, 12 stage + 12) 4-byte words, S = stride: a chunk's beams, its
// column table [nx, S], its row table [L, S] and the beams' field windows
// [(cx + 1) (cy + 1), S], beam j at column j of each (S = 4 mod 32, so
// that the eight lanes of a 16-byte load's phase, on consecutive rows, and
// lanes writing consecutive beams meet no bank conflict), then the fold's
// staging.
//
// A chunk is three passes.  (1) A thread a beam rotates it and finds the
// cells its entries can reach (from its first and last offsets: below)
// and whether they fit cx x cy.  (2) The tables and windows, a lane a beam
// and a warp a row of a table (or a cell of the windows): each entry an
// offset into its beam's window (a sentinel into a zero column cx or zero
// row cy) where the beam fits, else a field offset (iy W, kOff); each
// fitting beam's cells copied from the field.  The chunk is padded to a
// multiple of 4 beams with empty windows.  (3) The terms: where every beam
// of the chunk fits, four beams a step, a thread's column and row entries
// of the four as one 16-byte load each, then win[x + y] four times and
// four adds; else a beam that does not fit gathers from the field as the
// parent did.  Either way a term adds the field value of its cell, or +0,
// in beam order (a padded beam's +0 last changes no bit: the sum starts at
// +0 and never holds -0).
template <int kG, int kPer>
__global__ void __launch_bounds__(kG* kTile) lattice_tables(
    const LatticeTables a) {
  extern __shared__ __align__(16) int tab[];
  __shared__ bool last;
  constexpr int kThreads = kG * kTile, kWarps = kThreads / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = threadIdx.x / kTile, tid = threadIdx.x % kTile;
  const int ang = blockIdx.x / a.groups, grp = blockIdx.x % a.groups;
  const size_t r = blockIdx.y;
  const int L = a.L, LL = L * L, W = a.W, H = a.H;
  const int num_points = a.nums != nullptr ? a.nums[r] : a.num;
  const float* field = a.field + r * W * H;
  const float* points = a.points + r * a.P * 2;
  const uint8_t* pmask = a.pmask + r * a.P;
  const float* pose = a.pose + r * 3;
  const float ox = a.origin[2 * r], oy = a.origin[2 * r + 1];
  const int tile0 = grp * kG * kPer;
  const int f0 = tile0 * kTile;
  const int f1 = min((tile0 + kG * kPer) * kTile, LL);
  const int lx0 = f0 / L, nxb = (f1 - 1) / L - lx0 + 1;
  const int cx = a.cx, cy = a.cy, cw = cx + 1, win_words = cw * (cy + 1);
  const int chunk = a.chunk, S = a.stride;
  float* bx = reinterpret_cast<float*>(tab);
  float* by = bx + chunk;
  int* bused = tab + 2 * chunk;
  int* blox = tab + 3 * chunk;
  int* bloy = tab + 4 * chunk;
  int* bfit = tab + 5 * chunk;
  const int xs = kBeamWords * chunk;  // the tables' offsets in tab
  const int ys = xs + a.nx * S;
  float* win = reinterpret_cast<float*>(tab + ys + L * S);
  // This thread's candidate in each of its tiles: where its rows of the
  // column and row tables start in tab.
  int xr[kPer], yr[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int t = (tile0 + p * kG + g) * kTile + tid;
    const bool live = tile0 + p * kG + g < a.tiles && t < LL;
    xr[p] = xs + (live ? t / L - lx0 : 0) * S;
    yr[p] = ys + (live ? t % L : 0) * S;
  }
  const ndt2d::Subsample sub(num_points, a.max_beams);
  const float th = pose[2] + a.dths[ang];
  const float c = cosf(th), s = sinf(th);
  // Windows need the entries of a beam to grow with their offsets, which
  // holds where dls ascends and the cell is positive: every step of an
  // entry's expression is then monotone, so a beam's valid columns lie in
  // [max(first, 0), min(last, W - 1)] of its first and last dx (rows
  // likewise).  Else no beam takes a window.
  bool ascending = a.cell > 0.f && cx > 0 && cy > 0;
  for (int q = threadIdx.x; q + 1 < L; q += kThreads)
    ascending = ascending && a.dls[q] <= a.dls[q + 1];
  const bool windows = __syncthreads_and(ascending);
  const int row = nxb + L;  // a beam's entries: nxb columns, then L rows
  const unsigned row_m = magic(row), win_m = magic(win_words),
                 cw_m = magic(cw);
  float acc[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) acc[p] = 0.f;
  for (int base = 0; base < a.max_beams; base += chunk) {
    const int nb = min(chunk, a.max_beams - base), nb4 = (nb + 3) & ~3;
    __syncthreads();  // the previous chunk is read
    // (1) A thread a beam: rotated, and its window (the cells between its
    // first and last entries, each formed as its entries are).  A padded
    // beam fits an empty window.
    bool fits = true;
    for (int j = threadIdx.x; j < nb4; j += kThreads) {
      const int b = base + j;
      bool used = false, fit = j >= nb;
      int lo = W, ylo = H;
      if (j < nb) {
        const int idx = sub.index(b, num_points, a.P);
        const float px = points[2 * idx], py = points[2 * idx + 1];
        const float rx = c * px - s * py + pose[0];
        const float ry = s * px + c * py + pose[1];
        used = b < sub.used && pmask[idx];
        bx[j] = rx;
        by[j] = ry;
        if (windows) {
          lo = max((int)floorf((rx + a.dls[lx0] - ox) / a.cell), 0);
          const int hi = min(
              (int)floorf((rx + a.dls[lx0 + nxb - 1] - ox) / a.cell), W - 1);
          ylo = max((int)floorf((ry + a.dls[0] - oy) / a.cell), 0);
          const int yhi =
              min((int)floorf((ry + a.dls[L - 1] - oy) / a.cell), H - 1);
          fit = (!used || hi - lo < cx) && yhi - ylo < cy;
        }
      }
      bused[j] = used;
      blox[j] = lo;
      bloy[j] = ylo;
      bfit[j] = fit;
      fits = fits && fit;
    }
    const bool all_fit = __syncthreads_and(fits);
    // (2) Lane: a beam of a group of 32; warp: a row of a table (u < row
    // groups) or a cell of the windows.
    const int bgroups = (nb4 + 31) / 32;
    for (int u = warp; u < bgroups * row; u += kWarps) {
      const int bg = quot(u, row_m), q = u - bg * row, j = 32 * bg + lane;
      if (j >= nb4) continue;
      const bool fit = bfit[j];
      if (q < nxb) {
        int v = fit ? cx * S : kOff;
        if (j < nb) {
          const int ix =
              (int)floorf((bx[j] + a.dls[lx0 + q] - ox) / a.cell);
          if (bused[j] && ix >= 0 && ix < W) v = fit ? (ix - blox[j]) * S : ix;
        }
        tab[xs + q * S + j] = v;
      } else {
        int v = fit ? cy * cw * S + j : kOff;
        if (j < nb) {
          const int iy =
              (int)floorf((by[j] + a.dls[q - nxb] - oy) / a.cell);
          if (iy >= 0 && iy < H) v = fit ? (iy - bloy[j]) * cw * S + j
                                         : iy * W;
        }
        tab[ys + (q - nxb) * S + j] = v;
      }
    }
#pragma unroll 4
    for (int u = warp; u < bgroups * win_words; u += kWarps) {
      const int bg = quot(u, win_m), k = u - bg * win_words;
      const int j = 32 * bg + lane, yy = quot(k, cw_m), xx = k - yy * cw;
      if (j >= nb4) continue;
      const int gx = blox[j] + xx, gy = bloy[j] + yy;
      const bool cell = bfit[j] && xx < cx && yy < cy && gx < W && gy < H;
      win[k * S + j] = cell ? __ldg(field + gy * W + gx) : 0.f;
    }
    __syncthreads();
    if (all_fit) {  // (3)
#pragma unroll 2
      for (int j = 0; j < nb4; j += 4) {
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          const int4 x = *reinterpret_cast<const int4*>(tab + xr[p] + j);
          const int4 y = *reinterpret_cast<const int4*>(tab + yr[p] + j);
          acc[p] += win[x.x + y.x];
          acc[p] += win[x.y + y.y];
          acc[p] += win[x.z + y.z];
          acc[p] += win[x.w + y.w];
        }
      }
    } else {
      for (int j = 0; j < nb4; ++j) {
        if (bfit[j]) {
#pragma unroll
          for (int p = 0; p < kPer; ++p)
            acc[p] += win[tab[xr[p] + j] + tab[yr[p] + j]];
        } else {
#pragma unroll
          for (int p = 0; p < kPer; ++p) {
            const int cellid = tab[xr[p] + j] + tab[yr[p] + j];
            const float v = __ldg(field + max(cellid, 0));
            acc[p] += cellid >= 0 ? v : 0.f;
          }
        }
      }
    }
  }
  float* partial = a.partial + (r * a.A + ang) * a.tiles * lattice::kPartial;
  float* scores =
      a.scores != nullptr ? a.scores + (r * a.A + ang) * LL : nullptr;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    if (tile0 + p * kG >= a.tiles) break;  // the same for the whole block
    const int tile = tile0 + p * kG + g;
    const int t = tile * kTile + tid;
    const bool live = tile < a.tiles && t < LL;
    const int lx = live ? t / L : 0, ly = live ? t % L : 0;
    const float cand = -acc[p];
    if (live && scores != nullptr) scores[t] = cand;
    lattice::reduce_tiles<kG>(
        cand, live, ang * LL + t, a.dls[lx], a.dls[ly], a.dths[ang],
        tile < a.tiles ? partial + tile * lattice::kPartial : nullptr);
    __syncthreads();  // each group's thread 0 has read its warp sums
  }
  __threadfence();  // this block's partials before its ticket
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(a.ticket + r, 1u) == (unsigned)(a.A * a.groups - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  lattice::finalize_row<true, true>(
      a.partial + r * a.A * a.tiles * lattice::kPartial, a.A * a.tiles, L,
      num_points, a.max_beams, a.dths, a.dls, a.out + r * 13,
      reinterpret_cast<float*>(tab), a.stage);
  if (threadIdx.x == 0) a.ticket[r] = 0u;
}

// The launch, refused where its dynamic shared memory and the kernel's
// static (reduce_tiles' warp sums and the fold's flag, read once from the
// compiled kernel) pass the 48 KB a block may take without opting in.
template <int kG, int kPer>
cudaError_t launch_tables(const LatticeTables& a, int R, size_t smem,
                          cudaStream_t st) {
  static const size_t fixed = [] {
    cudaFuncAttributes f{};
    return cudaFuncGetAttributes(&f, lattice_tables<kG, kPer>) == cudaSuccess
               ? f.sharedSizeBytes
               : (size_t)48 * 1024;
  }();
  if (smem + fixed > 48 * 1024) return cudaErrorInvalidValue;
  lattice_tables<kG, kPer>
      <<<dim3(a.A * a.groups, R), kG * kTile, smem, st>>>(a);
  return cudaGetLastError();
}

struct Beam {
  float rx, ry;
  int used;
};

// The lattice's first form, kept as the comparison arm of
// ndt2d_correlative_match: grid (tiles, A, R), offsets tile blockIdx.x of
// angle blockIdx.y of row blockIdx.z (K6's gather_tiles with the field
// value as the beam's term), each term its own divisions; then
// lattice::finalize as a second launch.
__global__ void __launch_bounds__(kTile) lattice_tiles(
    const float* __restrict__ field, const float* __restrict__ origin,
    float cell, int W, int H, const float* __restrict__ points,
    const uint8_t* __restrict__ pmask, int P, const int* __restrict__ nums,
    int num, int max_beams, const float* __restrict__ pose,
    const float* __restrict__ dths, const float* __restrict__ dls, int A,
    int L, float* __restrict__ partial, float* __restrict__ scores) {
  __shared__ Beam beams[kBeamChunk];

  const int tile = blockIdx.x, tiles = gridDim.x;
  const int a = blockIdx.y;
  const size_t r = blockIdx.z;
  const int num_points = nums != nullptr ? nums[r] : num;
  field += r * W * H;
  origin += r * 2;
  points += r * P * 2;
  pmask += r * P;
  pose += r * 3;
  partial += (r * A * tiles + (size_t)a * tiles + tile) * lattice::kPartial;
  const int LL = L * L;
  if (scores != nullptr) scores += r * A * LL;
  const int t = tile * kTile + threadIdx.x;  // offset index lx * L + ly
  const bool live = t < LL;
  const int lx = live ? t / L : 0;
  const int ly = live ? t % L : 0;
  const float dx = dls[lx], dy = dls[ly];
  const float ox = origin[0], oy = origin[1];

  const ndt2d::Subsample sub(num_points, max_beams);
  const float th = pose[2] + dths[a];
  const float c = cosf(th), s = sinf(th);
  float acc = 0.f;
  for (int base = 0; base < max_beams; base += kBeamChunk) {
    const int nb = min(kBeamChunk, max_beams - base);
    __syncthreads();
    for (int j = threadIdx.x; j < nb; j += blockDim.x) {
      const int b = base + j;
      const int idx = sub.index(b, num_points, P);
      const float px = points[2 * idx], py = points[2 * idx + 1];
      beams[j].rx = c * px - s * py + pose[0];
      beams[j].ry = s * px + c * py + pose[1];
      beams[j].used = (b < sub.used) && pmask[idx];
    }
    __syncthreads();
    for (int j = 0; j < nb; ++j) {
      const float wx = beams[j].rx + dx;
      const float wy = beams[j].ry + dy;
      const int ix = (int)floorf((wx - ox) / cell);
      const int iy = (int)floorf((wy - oy) / cell);
      const bool inb = ix >= 0 && iy >= 0 && ix < W && iy < H;
      const float v = field[inb ? iy * W + ix : 0];
      acc += (inb && beams[j].used) ? v : 0.f;
    }
  }
  const float cand = -acc;
  const int flat = a * LL + t;
  if (live && scores != nullptr) scores[flat] = cand;
  lattice::reduce_tile(cand, live, flat, dx, dy, dths[a], partial);
}

// One warp per pose: minus the mean field value under the used beams.
__global__ void point_scores(const float* __restrict__ field,
                             const float* __restrict__ origin, float cell,
                             int W, int H, const float* __restrict__ points,
                             const uint8_t* __restrict__ pmask, int P,
                             int num_points, int max_beams,
                             const float* __restrict__ poses, int M,
                             float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (m >= M) return;  // whole warps leave together
  const ndt2d::Subsample sub(num_points, max_beams);
  const float px0 = poses[3 * m], py0 = poses[3 * m + 1];
  const float c = cosf(poses[3 * m + 2]), s = sinf(poses[3 * m + 2]);
  const int slots = ((max_beams + 31) / 32) * 32;
  float acc = 0.f;
  for (int i = lane; i < slots; i += 32) {
    float v = 0.f;
    if (i < max_beams) {
      const int idx = sub.index(i, num_points, P);
      const float x = points[2 * idx], y = points[2 * idx + 1];
      const float wx = c * x - s * y + px0;
      const float wy = s * x + c * y + py0;
      const int ix = (int)floorf((wx - origin[0]) / cell);
      const int iy = (int)floorf((wy - origin[1]) / cell);
      const bool ok = i < sub.used && pmask[idx] && ix >= 0 && iy >= 0 &&
                      ix < W && iy < H;
      v = ok ? field[iy * W + ix] : 0.f;
    }
    acc += v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[m] = -acc / (float)max(sub.used, 1);
}

int blocks(int n, int threads) { return (n + threads - 1) / threads; }

}  // namespace

// poses [S,3] f32, points [S,P,2] f32, pmask [S,P] u8, wmask [S] u8, taps
// [7] f32; scratch hits [H*W] i32, tmp [H*W] f32, peak [1] f32 -> origin
// [2] f32, field [H*W] f32.
NDT2D_API int ndt2d_correlative_field(
    const void* poses, const void* points, const void* pmask,
    const void* wmask, int S, int P, float range_max, float cell, int W,
    int H, const void* taps, void* hits, void* tmp, void* peak, void* origin,
    void* field, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int C = W * H;
  const float* fposes = static_cast<const float*>(poses);
  const uint8_t* fwmask = static_cast<const uint8_t*>(wmask);
  float* forigin = static_cast<float*>(origin);
  cudaError_t err = cudaMemsetAsync(hits, 0, (size_t)C * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  field_origin<<<1, 1, 0, st>>>(fposes, fwmask, S, range_max, forigin);
  if (S * P > 0)
    field_hits<<<blocks(S * P, kThreads), kThreads, 0, st>>>(
        fposes, static_cast<const float*>(points),
        static_cast<const uint8_t*>(pmask), fwmask, S, P, forigin, cell, W,
        H, static_cast<int*>(hits));
  field_blur<int><<<blocks(C, kThreads), kThreads, 0, st>>>(
      static_cast<const int*>(hits), static_cast<const float*>(taps), W, H,
      false, static_cast<float*>(tmp));
  field_blur<float><<<blocks(C, kThreads), kThreads, 0, st>>>(
      static_cast<const float*>(tmp), static_cast<const float*>(taps), W, H,
      true, static_cast<float*>(field));
  field_peak<<<1, kPeakThreads, 0, st>>>(static_cast<const float*>(field), C,
                                         static_cast<float*>(peak));
  field_scale<<<blocks(C, kThreads), kThreads, 0, st>>>(
      static_cast<float*>(field), C, static_cast<const float*>(peak));
  return (int)cudaGetLastError();
}

// The parent form, two launches (lattice_tiles, then lattice::finalize),
// kept as chip_smoke.py's comparison arm: no path of the package launches
// it.
// field [R,H*W] f32, origin [R,2] f32, points [R,P,2] f32, pmask [R,P] u8,
// nums [R] i32 (or null: every row has `num` points), pose [R,3] f32, dths
// [A] f32, dls [L] f32; scratch partial [R, A * ceil(L*L / 256), 12] f32;
// out [R,13] f32; scores [R,A,L,L] f32 or null.
NDT2D_API int ndt2d_correlative_match(
    const void* field, const void* origin, float cell, int W, int H,
    const void* points, const void* pmask, int R, int P, const void* nums,
    int num, int max_beams, const void* pose, const void* dths, int A,
    const void* dls, int L, void* partial, void* out, void* scores,
    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int tiles = (L * L + kTile - 1) / kTile;
  lattice_tiles<<<dim3(tiles, A, R), kTile, 0, st>>>(
      static_cast<const float*>(field), static_cast<const float*>(origin),
      cell, W, H, static_cast<const float*>(points),
      static_cast<const uint8_t*>(pmask), P, static_cast<const int*>(nums),
      num, max_beams, static_cast<const float*>(pose),
      static_cast<const float*>(dths), static_cast<const float*>(dls), A, L,
      static_cast<float*>(partial), static_cast<float*>(scores));
  lattice::finalize<<<R, lattice::kFinalizeThreads, 0, st>>>(
      static_cast<const float*>(partial), A * tiles, L,
      static_cast<const int*>(nums), num, max_beams,
      static_cast<const float*>(dths), static_cast<const float*>(dls),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// The lattice search in one launch (lattice_tables): the arguments as
// ndt2d_correlative_match's, with threads (a block's: 256, 512 or 1024)
// and per (tiles a thread: 1, 2, 4 or 8 at 256, 1 at 512, 1 or 2 at
// 1024; kernels/correlative.py::SHAPES), nx
// (the column table's rows), cx x cy (a beam's field window), chunk (beams
// a table chunk, a multiple of 4), stride (the tables' row stride, 4 mod
// 32) and stage (partials the fold stages at a time) from
// kernels/correlative.py::lattice_plan, and ticket [R] u32, 0 before the
// launch (left 0).  partial [R, A * ceil(L*L / 256), 12] f32 scratch; out
// [R,13] f32; scores [R,A,L,L] f32 or null.
NDT2D_API int ndt2d_correlative_match_tables(
    const void* field, const void* origin, float cell, int W, int H,
    const void* points, const void* pmask, int R, int P, const void* nums,
    int num, int max_beams, const void* pose, const void* dths, int A,
    const void* dls, int L, int threads, int per, int nx, int cx, int cy,
    int chunk, int stride, int stage, void* partial, void* out,
    void* scores, void* ticket, void* stream) {
  if (R < 1 || A < 1 || L < 1 || max_beams < 1 || chunk < 4 ||
      chunk % 4 || nx < 1 || cx < 0 || cy < 0 || stride < chunk ||
      stride % 32 != 4 || stage < 1 || (long long)W * H > (1ll << 30))
    return (int)cudaErrorInvalidValue;
  const int tiles = (L * L + kTile - 1) / kTile;
  const LatticeTables a{static_cast<const float*>(field),
                        static_cast<const float*>(origin),
                        cell,
                        W,
                        H,
                        static_cast<const float*>(points),
                        static_cast<const uint8_t*>(pmask),
                        P,
                        static_cast<const int*>(nums),
                        num,
                        max_beams,
                        static_cast<const float*>(pose),
                        static_cast<const float*>(dths),
                        static_cast<const float*>(dls),
                        A,
                        L,
                        tiles,
                        (tiles + per * (threads / kTile) - 1) /
                            (per * (threads / kTile)),
                        nx,
                        cx,
                        cy,
                        chunk,
                        stride,
                        stage,
                        static_cast<float*>(partial),
                        static_cast<float*>(scores),
                        static_cast<float*>(out),
                        static_cast<unsigned*>(ticket)};
  const size_t words =
      std::max((size_t)kBeamWords * chunk +
                   (size_t)(nx + L + (cx + 1) * (cy + 1)) * stride,
               (size_t)lattice::kPartial * (stage + 1));
  const size_t smem = words * sizeof(int);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (threads * 16 + per) {
    case 256 * 16 + 1: return (int)launch_tables<1, 1>(a, R, smem, st);
    case 256 * 16 + 2: return (int)launch_tables<1, 2>(a, R, smem, st);
    case 256 * 16 + 4: return (int)launch_tables<1, 4>(a, R, smem, st);
    case 256 * 16 + 8: return (int)launch_tables<1, 8>(a, R, smem, st);
    case 512 * 16 + 1: return (int)launch_tables<2, 1>(a, R, smem, st);
    case 1024 * 16 + 1: return (int)launch_tables<4, 1>(a, R, smem, st);
    case 1024 * 16 + 2: return (int)launch_tables<4, 2>(a, R, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// field [H*W] f32, origin [2] f32, points [P,2] f32, pmask [P] u8, poses
// [M,3] f32 -> out [M] f32.
NDT2D_API int ndt2d_correlative_score(
    const void* field, const void* origin, float cell, int W, int H,
    const void* points, const void* pmask, int P, int num_points,
    int max_beams, const void* poses, int M, void* out, void* stream) {
  point_scores<<<blocks(M, kWarpsPerBlock), 32 * kWarpsPerBlock, 0,
                 reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(field), static_cast<const float*>(origin),
      cell, W, H, static_cast<const float*>(points),
      static_cast<const uint8_t*>(pmask), P, num_points, max_beams,
      static_cast<const float*>(poses), M, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
