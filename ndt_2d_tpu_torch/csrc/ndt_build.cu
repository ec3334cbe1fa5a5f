// K1: window NDT build, deterministic, with K2's packed patch table.
//
// Replaces the jitted XLA build of the JAX package:
// ndt_2d_tpu/matching/matcher.py::window_origin + build_window_ndt ->
// ndt_2d_tpu/ndt/grid.py::build_ndt_from_scans -> build_ndt_binned, and
// ndt_2d_tpu/ndt/grid.py::packed_patch_table; with a row axis, the
// jax.vmap of build_window_ndt in match_scan_batch_multi (R loop-closure
// confirmation windows in one launch per pass).  With a grid axis of G = 4
// it is also the overlapping-grids build (build_window_ndt with
// config.overlapping_grids, matcher.py:95-103): grid g of a window has the
// origin window_origin - offs[g], offs = (0,0), (h,0), (0,h), (h,h) with
// h = 0.5 * cell in float32, and is a full build of the same points.  The
// launch runs R x G "virtual rows" v = r * G + g; every output is laid out
// [R, G, ...], and at G = 1 the offsets are 0 and the bits are those of the
// single-grid build.
//
// What bounds it on the card: the bytes of the [C, 32] patch table, four
// copies of every cell's 8-float record (0.08 ms at 64 rows of 160^2
// cells).  The per-cell moment sums must add each cell's points from 0 in
// point-index order (the reference's parity rule: every reduction is
// deterministic), so no float atomics.  Design: sort, then segment, work
// proportional to N + C a row:
//  1. bin_points: one thread a point: world transform, floor binning
//     against the row's origin, key = flat cell, or C when the point is
//     masked or off the grid; the same threads zero the row's run ends.
//  2. sort_cells: one block a row sorts its (key, x, y) by key, stably, in
//     8-bit LSD passes (ndt_build.py::build_plan says how many).  Each pass
//     takes tiles of 4096 points in order; a warp ranks its 256 points in
//     sub-rounds of 32 with __match_any_sync + __popc, keeping a running
//     count per digit; the warps' counts are scanned in warp order and
//     added to the digit's base, which carries from tile to tile.  So the
//     placement is a fixed function of the keys, whatever the scheduling.
//     The block then marks each occupied cell's run [start, end).
//  3. cell_records: one thread a cell sums its run in order (the same
//     float32 additions as a loop over the points in index order),
//     finalizes it and writes mean / information / covariance / count; as
//     many threads again finalize the cells one grid row above the block's
//     own (and the next cell of each range); the block stages the records
//     in shared memory and writes its table rows whole, as coalesced
//     16-byte stores.
// Rows never read each other's data, so a row's bits do not depend on R or
// on the other rows.
//
// KB1, the stripe build (ndt2d_ndt_build_stripe): one device's block of a
// y-stripe-sharded map, ndt_2d_tpu/parallel/ndt_blocks.py::
// build_ndt_sharded (:46-85).  The points bin against the map's GLOBAL
// origin (given, not window_origin) and a point belongs to the stripe of
// rows [row0, row0 + h) when its global floor bin iy does; its key is
// (iy - row0) * W + ix.  Binning against a shifted stripe origin would
// differ at cell edges.  Passes 2-3 are K1's over the stripe's h x W cells,
// so each cell sums the same points in the same order as the dense build
// and the stripe's cells are bitwise rows [row0, row0 + h) of the dense K1
// grid.  Its [h * W, 32] patch table wraps at the stripe's own edge; the
// stripe match reads only a row's first 8 floats (the cell's own record).
#include "common.cuh"

#include <float.h>

namespace {

constexpr int kBinThreads = 256;
constexpr int kCellThreads = 256;
// The sort: 16 warps, 8 points a thread; a tile of 4096 points a round.
constexpr int kSortThreads = 512;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kSortThreads * kItems;
constexpr int kRadix = 256;
constexpr int kMaxDigits = 4;

// matcher.py::window_origin: min over the window's poses - range_max.
__device__ __forceinline__ void window_origin(const float* poses,
                                              const uint8_t* wmask, int S,
                                              float range_max, float* ox,
                                              float* oy) {
  float mx = FLT_MAX, my = FLT_MAX;
  for (int s = 0; s < S; ++s) {
    float x = wmask[s] ? poses[3 * s] : FLT_MAX;
    float y = wmask[s] ? poses[3 * s + 1] : FLT_MAX;
    mx = fminf(mx, x);
    my = fminf(my, y);
  }
  *ox = mx - range_max;
  *oy = my - range_max;
}

// Grid (blocks over max(N, C), R * G): virtual row v = blockIdx.y is grid
// g = v % G of window r = v / G.  Thread i < C zeroes run end i; thread
// i < N bins point i (key C: not in the grid).
__global__ void bin_points(const float* __restrict__ poses,
                           const float* __restrict__ points,
                           const uint8_t* __restrict__ pmask,
                           const uint8_t* __restrict__ wmask, int S, int P,
                           int G, float half, float range_max, float cell,
                           int W, int H, int* __restrict__ key,
                           float* __restrict__ wx, float* __restrict__ wy,
                           int* __restrict__ run_end,
                           float* __restrict__ origin_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t v = blockIdx.y;
  const size_t r = v / G;
  const int g = (int)(v % G);
  const size_t N = (size_t)S * P;
  const int C = W * H;
  if (i < C) run_end[v * C + i] = 0;
  poses += r * S * 3;
  points += r * N * 2;
  pmask += r * N;
  wmask += r * S;
  key += v * N;
  wx += v * N;
  wy += v * N;
  origin_out += v * 2;
  float ox, oy;
  window_origin(poses, wmask, S, range_max, &ox, &oy);
  // matcher.py:96-103: origin - offs[g] (offs[0] = 0: the single grid).
  ox = ox - ((g & 1) ? half : 0.f);
  oy = oy - ((g & 2) ? half : 0.f);
  if (i == 0) {
    origin_out[0] = ox;
    origin_out[1] = oy;
  }
  if (i >= S * P) return;
  const int s = i / P;
  const float th = poses[3 * s + 2];
  const float c = cosf(th), sn = sinf(th);
  const float px = points[2 * i], py = points[2 * i + 1];
  // core/pose.py::transform_points: R(theta) p + t.
  const float x = c * px - sn * py + poses[3 * s];
  const float y = sn * px + c * py + poses[3 * s + 1];
  const int ix = (int)floorf((x - ox) / cell);
  const int iy = (int)floorf((y - oy) / cell);
  const bool valid = pmask[i] && wmask[s] && ix >= 0 && iy >= 0 && ix < W &&
                     iy < H;
  key[i] = valid ? iy * W + ix : C;
  wx[i] = x;
  wy[i] = y;
}

// KB1's pass 1.  Grid (blocks over max(N, C)): one thread a window point,
// binned against the global origin into the stripe of rows [row0, row0 +
// h); thread i < C zeroes run end i.
__global__ void bin_stripe(const float* __restrict__ poses,
                           const float* __restrict__ points,
                           const uint8_t* __restrict__ pmask,
                           const uint8_t* __restrict__ wmask, int S, int P,
                           const float* __restrict__ origin, float cell,
                           int W, int row0, int h, int* __restrict__ key,
                           float* __restrict__ wx, float* __restrict__ wy,
                           int* __restrict__ run_end) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int C = W * h;
  if (i < C) run_end[i] = 0;
  if (i >= S * P) return;
  const int s = i / P;
  const float th = poses[3 * s + 2];
  const float c = cosf(th), sn = sinf(th);
  const float px = points[2 * i], py = points[2 * i + 1];
  const float x = c * px - sn * py + poses[3 * s];
  const float y = sn * px + c * py + poses[3 * s + 1];
  const int ix = (int)floorf((x - origin[0]) / cell);
  const int iy = (int)floorf((y - origin[1]) / cell);
  const bool valid = pmask[i] && wmask[s] && ix >= 0 && ix < W &&
                     iy >= row0 && iy < row0 + h;
  key[i] = valid ? (iy - row0) * W + ix : C;
  wx[i] = x;
  wy[i] = y;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Grid (R * G): block v sorts virtual row v's N (key, x, y) by key, stably,
// in `digits` LSD passes of 8 bits, from buffer 0 (bin_points' output)
// to buffer 1 and back; the sorted row ends in buffer digits % 2.  Then
// run_start / run_end [C] hold each occupied cell's run of sorted points.
__global__ void __launch_bounds__(kSortThreads)
    sort_cells(int N, int C, int digits, int* __restrict__ key0,
               float* __restrict__ x0, float* __restrict__ y0,
               int* __restrict__ key1, float* __restrict__ x1,
               float* __restrict__ y1, int* __restrict__ run_start,
               int* __restrict__ run_end) {
  __shared__ int hist[kMaxDigits][kRadix];
  __shared__ int wcnt[kSortWarps][kRadix];
  __shared__ int base[kRadix];
  __shared__ int total[kRadix];
  __shared__ int wsum[kRadix / 32];
  const size_t v = blockIdx.x;
  int* ks = key0 + v * N;
  float* xs = x0 + v * N;
  float* ys = y0 + v * N;
  int* kd = key1 + v * N;
  float* xd = x1 + v * N;
  float* yd = y1 + v * N;
  run_start += v * C;
  run_end += v * C;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // Every pass's digit counts (they do not depend on the order).
  for (int i = t; i < kMaxDigits * kRadix; i += kSortThreads)
    (&hist[0][0])[i] = 0;
  __syncthreads();
  for (int i = t; i < N; i += kSortThreads) {
    const int k = ks[i];
    for (int p = 0; p < digits; ++p)
      atomicAdd(&hist[p][(k >> (8 * p)) & (kRadix - 1)], 1);
  }
  __syncthreads();

  for (int p = 0; p < digits; ++p) {
    const int shift = 8 * p;
    // base = exclusive scan of hist[p] (threads 0..255: whole warps).
    if (t < kRadix) {
      const int x = hist[p][t];
      int incl = x;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      if (lane == 31) wsum[warp] = incl;
      base[t] = incl - x;
    }
    __syncthreads();
    if (t < kRadix) {
      int add = 0;
      for (int w = 0; w < warp; ++w) add += wsum[w];
      base[t] += add;
    }
    __syncthreads();
    for (int t0 = 0; t0 < N; t0 += kTile) {
      for (int d = lane; d < kRadix; d += 32) wcnt[warp][d] = 0;
      __syncwarp();
      // Warp w ranks points t0 + 256 w .. + 255, 32 at a time, in order.
      int k[kItems], rank[kItems];
      float xv[kItems], yv[kItems];
#pragma unroll
      for (int m = 0; m < kItems; ++m) {
        const int i = t0 + warp * (32 * kItems) + m * 32 + lane;
        const bool ok = i < N;
        k[m] = ok ? ks[i] : 0;
        xv[m] = ok ? xs[i] : 0.f;
        yv[m] = ok ? ys[i] : 0.f;
      }
#pragma unroll
      for (int m = 0; m < kItems; ++m) {
        const bool ok = t0 + warp * (32 * kItems) + m * 32 + lane < N;
        const int d = ok ? (k[m] >> shift) & (kRadix - 1) : kRadix;
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        const int below = __popc(peers & lanemask_lt());
        const int prior = ok ? wcnt[warp][d] : 0;
        rank[m] = prior + below;
        __syncwarp();
        if (ok && below == 0) wcnt[warp][d] = prior + __popc(peers);
        __syncwarp();
      }
      __syncthreads();
      // Per digit: the warps' counts as an exclusive scan in warp order.
      if (t < kRadix) {
        int run = 0;
        for (int w = 0; w < kSortWarps; ++w) {
          const int c = wcnt[w][t];
          wcnt[w][t] = run;
          run += c;
        }
        total[t] = run;
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kItems; ++m) {
        const int i = t0 + warp * (32 * kItems) + m * 32 + lane;
        if (i < N) {
          const int d = (k[m] >> shift) & (kRadix - 1);
          const int dst = base[d] + wcnt[warp][d] + rank[m];
          kd[dst] = k[m];
          xd[dst] = xv[m];
          yd[dst] = yv[m];
        }
      }
      __syncthreads();
      if (t < kRadix) base[t] += total[t];
      __syncthreads();
    }
    int* tk = ks;
    ks = kd;
    kd = tk;
    float* tx = xs;
    xs = xd;
    xd = tx;
    float* ty = ys;
    ys = yd;
    yd = ty;
  }
  // Runs of the sorted keys (key C, the points off the grid, sorts last).
  for (int i = t; i < N; i += kSortThreads) {
    const int k = ks[i];
    if (k >= C) continue;
    if (i == 0 || ks[i - 1] != k) run_start[k] = i;
    if (i == N - 1 || ks[i + 1] != k) run_end[k] = i + 1;
  }
}

// Cell c's moments from its run of sorted points, in point-index order,
// then grid.py::build_ndt_binned's finalize, expression for expression.
// rec = packed_cell_table's 8 floats; out_* get the grid's fields.
struct Cell {
  float mx, my, i00, i01, i11, c00, c01, c11;
  int cnt;
};

__device__ __forceinline__ Cell finalize_cell(const float* __restrict__ sx,
                                              const float* __restrict__ sy,
                                              const int* __restrict__ start,
                                              const int* __restrict__ end,
                                              int c) {
  float n = 0.f, mx_s = 0.f, my_s = 0.f, xx = 0.f, xy = 0.f, yy = 0.f;
  const int e = end[c];
  int j = e > 0 ? start[c] : 0;
  // Four loads ahead, then the same adds as one point at a time.
  for (; j + 4 <= e; j += 4) {
    float xs[4], ys[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      xs[q] = sx[j + q];
      ys[q] = sy[j + q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float x = xs[q], y = ys[q];
      n += 1.f;
      mx_s += x;
      my_s += y;
      xx += x * x;
      xy += x * y;
      yy += y * y;
    }
  }
  for (; j < e; ++j) {
    const float x = sx[j], y = sy[j];
    n += 1.f;
    mx_s += x;
    my_s += y;
    xx += x * x;
    xy += x * y;
    yy += y * y;
  }
  const float n_safe = fmaxf(n, 1.f);
  const float mx = mx_s / n_safe, my = my_s / n_safe;
  const float r00 = xx / n_safe, r01 = xy / n_safe, r11 = yy / n_safe;
  const float scale = n / fmaxf(n - 1.f, 1.f);
  const float c00 = (r00 - mx * mx) * scale;
  const float c01 = (r01 - mx * my) * scale;
  const float c11 = (r11 - my * my) * scale;
  const float half_tr = 0.5f * (c00 + c11);
  const float det = c00 * c11 - c01 * c01;
  const float disc = sqrtf(fmaxf(half_tr * half_tr - det, 0.f));
  const float large = half_tr + disc;
  const float small = half_tr - disc;
  float det_used = (small < 0.001f * large) ? (0.001f * large) * large : det;
  if (fabsf(det_used) < 1e-20f) det_used = 1e-20f;
  const float inv = 1.f / det_used;
  const bool has_stats = n >= 3.f;
  Cell out;
  out.mx = mx;
  out.my = my;
  out.i00 = has_stats ? c11 * inv : 0.f;
  out.i01 = has_stats ? -c01 * inv : 0.f;
  out.i11 = has_stats ? c00 * inv : 0.f;
  out.c00 = has_stats ? c00 : 0.f;
  out.c01 = has_stats ? c01 : 0.f;
  out.c11 = has_stats ? c11 : 0.f;
  out.cnt = (int)n;
  return out;
}

__device__ __forceinline__ void put_record(float4* rec, const Cell& k) {
  rec[0] = make_float4(k.mx, k.my, k.i00, k.i01);
  rec[1] = make_float4(k.i11, k.cnt >= 5 ? 1.f : 0.f, 0.f, 0.f);
}

// Grid (C / kCellThreads blocks, R * G), 2 x kCellThreads threads: block
// b of virtual row v owns cells c0 .. c0 + 255 (c0 = 256 b).  Thread t <
// 256 finalizes cell c0 + t (writing the grid's fields), thread 256 + t
// the cell W above it, and threads 0 and 256 also cells c0 + 256 and c0 +
// W + 256.  The block then writes table rows c0 .. c0 + 255: row i =
// cells (i, i+1, i+W, i+W+1) mod C (grid.py::packed_patch_table), 16
// bytes a thread a store.
__global__ void __launch_bounds__(2 * kCellThreads)
    cell_records(const float* __restrict__ sx, const float* __restrict__ sy,
                 const int* __restrict__ run_start,
                 const int* __restrict__ run_end, int N, int W, int C,
                 float* __restrict__ mean, float* __restrict__ info,
                 float* __restrict__ cov, int* __restrict__ count,
                 float* __restrict__ table) {
  // own[j] = cell c0 + j, up[j] = cell c0 + W + j (mod C), j <= 256.
  __shared__ float4 own[kCellThreads + 1][2];
  __shared__ float4 up[kCellThreads + 1][2];
  const size_t v = blockIdx.y;
  sx += v * N;
  sy += v * N;
  run_start += v * C;
  run_end += v * C;
  mean += v * C * 2;
  info += v * C * 3;
  cov += v * C * 3;
  count += v * C;
  table += v * C * 32;
  const int t = threadIdx.x % kCellThreads;
  const bool upper = threadIdx.x >= kCellThreads;
  const int c0 = blockIdx.x * kCellThreads;
  const int c = c0 + t;
  if (upper) {
    put_record(up[t], finalize_cell(sx, sy, run_start, run_end,
                                    (int)(((size_t)c + W) % C)));
    if (t == 0)
      put_record(up[kCellThreads],
                 finalize_cell(sx, sy, run_start, run_end,
                               (int)(((size_t)c0 + W + kCellThreads) % C)));
  } else {
    const Cell k = finalize_cell(sx, sy, run_start, run_end, c % C);
    put_record(own[t], k);
    if (t == 0)
      put_record(own[kCellThreads],
                 finalize_cell(sx, sy, run_start, run_end,
                               (c0 + kCellThreads) % C));
    if (c < C) {
      mean[2 * c] = k.mx;
      mean[2 * c + 1] = k.my;
      info[3 * c] = k.i00;
      info[3 * c + 1] = k.i01;
      info[3 * c + 2] = k.i11;
      cov[3 * c] = k.c00;
      cov[3 * c + 1] = k.c01;
      cov[3 * c + 2] = k.c11;
      count[c] = k.cnt;
    }
  }
  __syncthreads();
  // 8 float4 pieces a row: quarter q = p / 2 (cell i, i+1, i+W, i+W+1),
  // half p % 2 of its record.
  const int rows = min(kCellThreads, C - c0);
  float4* out = reinterpret_cast<float4*>(table + (size_t)c0 * 32);
  for (int p = threadIdx.x; p < rows * 8; p += 2 * kCellThreads) {
    const int j = p >> 3, q = (p >> 1) & 3, h = p & 1;
    const float4* src = (q & 2) ? up[j + (q & 1)] : own[j + (q & 1)];
    out[p] = src[h];
  }
}

// The sort and the cell pass of one launch's V rows, after the binning
// wrote buffer 0 and zeroed the run ends.
int sort_and_finalize(int V, int N, int W, int C, int digits, int tile,
                      int cell_blocks, int* key0, float* x0, float* y0,
                      int* key1, float* x1, float* y1, int* run_start,
                      int* run_end, float* mean, float* info, float* cov,
                      int* count, float* table, cudaStream_t st) {
  if (digits < 1 || digits > kMaxDigits || tile != kTile ||
      cell_blocks * kCellThreads < C)
    return (int)cudaErrorInvalidValue;
  sort_cells<<<V, kSortThreads, 0, st>>>(N, C, digits, key0, x0, y0, key1,
                                         x1, y1, run_start, run_end);
  const bool odd = digits & 1;
  cell_records<<<dim3(cell_blocks, V), 2 * kCellThreads, 0, st>>>(
      odd ? x1 : x0, odd ? y1 : y0, run_start, run_end, N, W, C, mean, info,
      cov, count, table);
  return (int)cudaGetLastError();
}

}  // namespace

// poses [R,S,3] f32, points [R,S,P,2] f32, pmask [R,S,P] u8, wmask [R,S]
// u8; G grids per window (1, or 4 overlapping ones offset by `half`);
// the plan (kernels/ndt_build.py::build_plan): `digits` sort passes,
// `tile` points a sort round, `bin_blocks` x 256 threads over max(N, C),
// `cell_blocks` x 256 cells; scratch, each [R*G, ...]: key0/key1 [N] i32,
// x0/y0/x1/y1 [N] f32, run_start/run_end [C] i32; out: origin [R,G,2],
// mean [R,G,C,2], info [R,G,C,3], cov [R,G,C,3] f32, count [R,G,C] i32,
// table [R,G,C,32] f32.
NDT2D_API int ndt2d_ndt_build(
    const void* poses, const void* points, const void* pmask,
    const void* wmask, int R, int S, int P, int G, float half,
    float range_max, float cell, int W, int H, int digits, int tile,
    int bin_blocks, int cell_blocks, void* key0, void* x0, void* y0,
    void* key1, void* x1, void* y1, void* run_start, void* run_end,
    void* origin, void* mean, void* info, void* cov, void* count,
    void* table, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int N = S * P;
  const int C = W * H;
  if (bin_blocks * kBinThreads < max(N, C))
    return (int)cudaErrorInvalidValue;
  bin_points<<<dim3(bin_blocks, R * G), kBinThreads, 0, st>>>(
      static_cast<const float*>(poses), static_cast<const float*>(points),
      static_cast<const uint8_t*>(pmask), static_cast<const uint8_t*>(wmask),
      S, P, G, half, range_max, cell, W, H, static_cast<int*>(key0),
      static_cast<float*>(x0), static_cast<float*>(y0),
      static_cast<int*>(run_end), static_cast<float*>(origin));
  return sort_and_finalize(
      R * G, N, W, C, digits, tile, cell_blocks, static_cast<int*>(key0),
      static_cast<float*>(x0), static_cast<float*>(y0),
      static_cast<int*>(key1), static_cast<float*>(x1),
      static_cast<float*>(y1), static_cast<int*>(run_start),
      static_cast<int*>(run_end), static_cast<float*>(mean),
      static_cast<float*>(info), static_cast<float*>(cov),
      static_cast<int*>(count), static_cast<float*>(table), st);
}

// KB1: poses [S,3] f32, points [S,P,2] f32, pmask [S,P] u8, wmask [S] u8,
// origin [2] f32 (the map's global origin); the stripe of rows [row0,
// row0 + h) of a W-wide grid; plan and scratch as ndt2d_ndt_build's at
// one row of C = h * W cells; out: mean [h*W,2], info [h*W,3], cov
// [h*W,3] f32, count [h*W] i32, table [h*W,32] f32.
NDT2D_API int ndt2d_ndt_build_stripe(
    const void* poses, const void* points, const void* pmask,
    const void* wmask, int S, int P, const void* origin, float cell, int W,
    int row0, int h, int digits, int tile, int bin_blocks, int cell_blocks,
    void* key0, void* x0, void* y0, void* key1, void* x1, void* y1,
    void* run_start, void* run_end, void* mean, void* info, void* cov,
    void* count, void* table, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int N = S * P;
  const int C = W * h;
  if (bin_blocks * kBinThreads < max(N, C))
    return (int)cudaErrorInvalidValue;
  bin_stripe<<<bin_blocks, kBinThreads, 0, st>>>(
      static_cast<const float*>(poses), static_cast<const float*>(points),
      static_cast<const uint8_t*>(pmask), static_cast<const uint8_t*>(wmask),
      S, P, static_cast<const float*>(origin), cell, W, row0, h,
      static_cast<int*>(key0), static_cast<float*>(x0),
      static_cast<float*>(y0), static_cast<int*>(run_end));
  return sort_and_finalize(
      1, N, W, C, digits, tile, cell_blocks, static_cast<int*>(key0),
      static_cast<float*>(x0), static_cast<float*>(y0),
      static_cast<int*>(key1), static_cast<float*>(x1),
      static_cast<float*>(y1), static_cast<int*>(run_start),
      static_cast<int*>(run_end), static_cast<float*>(mean),
      static_cast<float*>(info), static_cast<float*>(cov),
      static_cast<int*>(count), static_cast<float*>(table), st);
}
