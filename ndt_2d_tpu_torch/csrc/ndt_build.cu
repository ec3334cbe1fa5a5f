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
// What bounds it on the card: the per-cell moment sums.  A scatter with
// float atomics would be the fast form, but its summation order changes from
// run to run, and the reference's parity rule is that every reduction is
// deterministic.  Design: pass A bins each window point (one thread per
// point of one row: world transform, floor binning against the row's own
// origin, key = flat cell or -1).  Pass B gives every thread one cell of one
// row; each block stages the (key, x, y) of its row's S x P points through
// shared memory in chunks and every thread sums its cell's moments in
// point-index order, then finalizes the cell (mean, covariance n/(n-1),
// closed-form eigenvalue floor, information) and writes its packed 8-float
// record into the four rows of the row's [C, 32] patch table that hold it.
// Rows never read each other's data, so a row's bits do not depend on R or
// on the other rows.  The cost is O(cells x points) shared-memory compares
// per row (about 1.9e8 at 192^2 cells and 10 x 512 points), which a
// sort-by-key build would cut; the sums stay bitwise reproducible either
// way.
#include "common.cuh"

#include <float.h>

namespace {

constexpr int kBinThreads = 256;
constexpr int kCellThreads = 256;
// Points staged per shared-memory pass: 4096 x (int + 2 floats) = 48 KB,
// the most a block may take without opting in to more.
constexpr int kChunk = 4096;

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

// Grid (point blocks, R * G): virtual row v = blockIdx.y is grid
// g = v % G of window r = v / G.
__global__ void bin_points(const float* __restrict__ poses,
                           const float* __restrict__ points,
                           const uint8_t* __restrict__ pmask,
                           const uint8_t* __restrict__ wmask, int S, int P,
                           int G, float half, float range_max, float cell,
                           int W, int H, int* __restrict__ key,
                           float* __restrict__ wx, float* __restrict__ wy,
                           float* __restrict__ origin_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t v = blockIdx.y;
  const size_t r = v / G;
  const int g = (int)(v % G);
  const size_t N = (size_t)S * P;
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
  key[i] = valid ? iy * W + ix : -1;
  wx[i] = x;
  wy[i] = y;
}

__device__ __forceinline__ int wrap(int r, int C) { return ((r % C) + C) % C; }

// Grid (cell blocks, R * G): virtual row r = blockIdx.y; N = S * P points.
__global__ void accumulate_cells(const int* __restrict__ key,
                                 const float* __restrict__ wx,
                                 const float* __restrict__ wy, int N, int W,
                                 int C, float* __restrict__ mean,
                                 float* __restrict__ info,
                                 float* __restrict__ cov,
                                 int* __restrict__ count,
                                 float* __restrict__ table) {
  const size_t r = blockIdx.y;
  key += r * N;
  wx += r * N;
  wy += r * N;
  mean += r * C * 2;
  info += r * C * 3;
  cov += r * C * 3;
  count += r * C;
  table += r * C * 32;
  extern __shared__ unsigned char smem[];
  int* skey = reinterpret_cast<int*>(smem);
  float* sx = reinterpret_cast<float*>(skey + kChunk);
  float* sy = sx + kChunk;

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  float n = 0.f, mx_s = 0.f, my_s = 0.f, xx = 0.f, xy = 0.f, yy = 0.f;
  for (int base = 0; base < N; base += kChunk) {
    const int m = min(kChunk, N - base);
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      skey[j] = key[base + j];
      sx[j] = wx[base + j];
      sy[j] = wy[base + j];
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      if (skey[j] == c) {  // point-index order: a fixed summation order
        const float x = sx[j], y = sy[j];
        n += 1.f;
        mx_s += x;
        my_s += y;
        xx += x * x;
        xy += x * y;
        yy += y * y;
      }
    }
  }
  if (c >= C) return;

  // grid.py::build_ndt_binned finalize, expression for expression.
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
  const float i00 = has_stats ? c11 * inv : 0.f;
  const float i01 = has_stats ? -c01 * inv : 0.f;
  const float i11 = has_stats ? c00 * inv : 0.f;
  const int cnt = (int)n;

  mean[2 * c] = mx;
  mean[2 * c + 1] = my;
  info[3 * c] = i00;
  info[3 * c + 1] = i01;
  info[3 * c + 2] = i11;
  cov[3 * c] = has_stats ? c00 : 0.f;
  cov[3 * c + 1] = has_stats ? c01 : 0.f;
  cov[3 * c + 2] = has_stats ? c11 : 0.f;
  count[c] = cnt;

  // grid.py::packed_patch_table: row i = cells (i, i+1, i+W, i+W+1) mod C,
  // so this cell's record goes to rows c, c-1, c-W, c-W-1 (mod C).
  const float4 lo = make_float4(mx, my, i00, i01);
  const float4 hi = make_float4(i11, cnt >= 5 ? 1.f : 0.f, 0.f, 0.f);
  const int rows[4] = {c, wrap(c - 1, C), wrap(c - W, C), wrap(c - W - 1, C)};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float4* dst = reinterpret_cast<float4*>(table + (size_t)rows[q] * 32 + 8 * q);
    dst[0] = lo;
    dst[1] = hi;
  }
}

}  // namespace

// poses [R,S,3] f32, points [R,S,P,2] f32, pmask [R,S,P] u8, wmask [R,S]
// u8; G grids per window (1, or 4 overlapping ones offset by `half`);
// scratch: key [R,G,S*P] i32, wx/wy [R,G,S*P] f32; out: origin [R,G,2],
// mean [R,G,C,2], info [R,G,C,3], cov [R,G,C,3] f32, count [R,G,C] i32,
// table [R,G,C,32] f32.
NDT2D_API int ndt2d_ndt_build(const void* poses, const void* points,
                              const void* pmask, const void* wmask, int R,
                              int S, int P, int G, float half,
                              float range_max, float cell, int W, int H,
                              void* key, void* wx, void* wy, void* origin,
                              void* mean, void* info, void* cov, void* count,
                              void* table, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int N = S * P;
  const int C = W * H;
  const dim3 nb(max((N + kBinThreads - 1) / kBinThreads, 1), R * G);
  bin_points<<<nb, kBinThreads, 0, st>>>(
      static_cast<const float*>(poses), static_cast<const float*>(points),
      static_cast<const uint8_t*>(pmask), static_cast<const uint8_t*>(wmask),
      S, P, G, half, range_max, cell, W, H, static_cast<int*>(key),
      static_cast<float*>(wx), static_cast<float*>(wy),
      static_cast<float*>(origin));
  const dim3 nc((C + kCellThreads - 1) / kCellThreads, R * G);
  const size_t smem = (size_t)kChunk * (sizeof(int) + 2 * sizeof(float));
  accumulate_cells<<<nc, kCellThreads, smem, st>>>(
      static_cast<const int*>(key), static_cast<const float*>(wx),
      static_cast<const float*>(wy), N, W, C, static_cast<float*>(mean),
      static_cast<float*>(info), static_cast<float*>(cov),
      static_cast<int*>(count), static_cast<float*>(table));
  return (int)cudaGetLastError();
}
