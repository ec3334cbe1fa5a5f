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
// bound by its A * L * L * B (candidate, beam) terms, each a division, a
// floor and a gather the L1/L2 caches serve; the point score is launch
// latency at M = 1.
//
// Designs.  Field: hit counts by integer atomics (exact in any order), the
// blur one thread per cell adding its 7 taps in index order from 0 (the
// taps computed once by torch and handed in), the maximum by one block
// (order-free), the division by it last; the twin does each step in the
// same order.  Lattice: K6's tiling, one block per (tile of 256 offsets,
// angle, row), one thread per (dx, dy) summing the beams in order from 0,
// the block's rotated beams staged in shared memory, and K6's reduction.
// Point score: K3's, one warp per pose, lane l adding beams l, l + 32, ...
// from 0, then a __shfl_down_sync tree (16, 8, 4, 2, 1).
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

struct Beam {
  float rx, ry;
  int used;
};

// Grid (tiles, A, R): offsets tile blockIdx.x of angle blockIdx.y of row
// blockIdx.z (K6's gather_tiles with the field value as the beam's term).
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
