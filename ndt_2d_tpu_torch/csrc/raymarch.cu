// K5: occupancy ray-march, hit and empty counts per cell.
//
// Replaces the jitted XLA program of the JAX package:
// ndt_2d_tpu/mapping/occupancy.py::_raymarch_counts.
//
// Per ray: K samples at t = linspace(0, 1, K); the cell of each sample
// (floor binning clipped into the grid); consecutive repeats of a cell are
// dropped; every remaining cell except the end cell counts "empty", and the
// end cell counts "hit".  The sample parameter follows jnp.linspace's
// float32 formula (jax/_src/numpy/array_creation.py::_linspace): for
// endpoint=True, out[k] = start * (1 - step_k) + stop * step_k with
// step_k = float(k) / float(K - 1), and the last sample is `stop` itself.
// With start = 0 and stop = 1 that is exactly t_k = float(k) / float(K - 1)
// (IEEE division, no fast math), t_{K-1} = 1.
//
// Each crossed cell is found once.  Along a ray, each axis's cell index
// ix_k = clamp(floor((s + d * t_k - o) / res), 0, n - 1) is monotone in k:
// t_k is non-decreasing (a correctly rounded quotient of a non-decreasing
// numerator by a fixed positive denominator, and t_{K-1} = 1 is the
// largest); d * t is monotone in t (non-decreasing for d >= 0,
// non-increasing for d < 0), and so are adding s, subtracting o, dividing
// by res > 0, floor and the clamp, since IEEE rounding of each operation is
// monotone.  Hence (ix_k, iy_k) moves monotonically on both axes: a cell
// the ray leaves never comes back, the twin's consecutive dedupe keeps each
// distinct cell exactly once, and nothing lies between two samples of one
// cell.  A thread therefore jumps from one change of an axis index to the
// next: it estimates the sample where the ray reaches the next cell edge
// of that axis, then settles the first changed sample by evaluating the
// twin's expression above at candidate samples, two at a time (the
// estimate and the sample before it; then the next two past the side the
// estimate missed on; then thirds of the bracket), keeping a bracket (last
// sample unchanged, first changed).  An axis that does not move (d = 0),
// or sits at the grid edge it moves towards (the clamp holds it there),
// has no next change.  The estimate only picks the samples evaluated; the
// counts are the twin's bitwise.  Each step advances the axis whose change
// comes first, the same code for x and y, so a warp's lanes do not split
// by axis.
//
// A ray's samples are cut into kSegments runs of about K / kSegments, a
// thread each (adjacent lanes), so a long ray's chain of dependent
// evaluations is spread over eight threads: the kernel is bound by its
// longest chains, not by its evaluations.  A segment's first cell is
// counted unless the sample before the segment lies in it (then the
// previous segment's thread counted it); the first segment counts the
// hit.  The block keeps t_j of the first kTable samples in shared memory
// (the same quotients), so an evaluation divides once.  Config 2's
// export: ~220 one-axis evaluations a ray against 1282 (two a sample),
// and the longest thread's chain an eighth of a whole ray's.
//
// Counting: a block counts kRays consecutive rays (mostly one scan's,
// sharing an origin) into a shared window of kWindow x kWindow cells around
// its first ray's start, an empty count in a word's low 16 bits and a hit
// count in its high 16: a ray counts a cell at most once, so a count stays
// below kRays < 2^16.  Cells outside the window are counted straight into
// global memory.  The block then adds each non-zero window count to global
// memory with one atomic.  Integer adds commute, so the counts are
// deterministic and bitwise the twin's, for any contiguous run of rays (a
// mesh rank's shard).
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;    // a block
constexpr int kSegments = 8;     // threads a ray (kernels/raymarch.py)
constexpr int kRays = kThreads / kSegments;  // rays a block (BLOCK_RAYS)
constexpr int kWindow = 64;      // window side (WINDOW): 16 KB
constexpr int kTable = 4096;     // sample parameters kept in shared memory
constexpr unsigned kHit = 1u << 16;
static_assert(kRays < (1 << 16), "a window count must fit 16 bits");

// One axis of a ray: start s, extent d = e - s, grid origin o, cell size
// res, cells n, and (K - 1) / d for the estimates.
struct Axis {
  float s, d, o, res, scale;
  int n;
};

// The sample parameter t_j = float(j) / float(K - 1), t_{K-1} = 1.
__device__ __forceinline__ float sample_t(int j, int K) {
  return (j == K - 1) ? 1.f : (float)j / (float)(K - 1);
}

// The twin's cell index of point coordinate p along an axis.
__device__ __forceinline__ int point_cell(float p, float o, float res,
                                          int n) {
  return (int)fminf(fmaxf(floorf((p - o) / res), 0.f), (float)(n - 1));
}

// The twin's cell index of sample j along axis a; t_j from the block's
// table of the first kTable parameters (the same values).
__device__ __forceinline__ int axis_cell(const Axis& a, int j, int K,
                                         const float* table) {
  const float t = j < kTable ? table[j] : sample_t(j, K);
  return point_cell(a.s + a.d * t, a.o, a.res, a.n);
}

// The first sample j in (lo, end) whose cell along a differs from cur (the
// cell of sample lo), with that cell in *v; end where none does.
__device__ __forceinline__ int next_change(const Axis a, int lo, int cur,
                                           int end, int K,
                                           const float* table, int* v) {
  if (a.d == 0.f || (a.d > 0.f && cur >= a.n - 1) ||
      (a.d < 0.f && cur <= 0) || lo >= end - 1)
    return end;
  const float edge = (float)(a.d > 0.f ? cur + 1 : cur);
  const float est = ((a.o + edge * a.res) - a.s) * a.scale;
  int c = (int)fminf(fmaxf(ceilf(est), (float)(lo + 1)), (float)(end - 1));
  int hi = end;
  for (int round = 0; hi - lo > 1; ++round) {
    int j1, j2;
    if (round < 2) {
      j2 = min(max(c, lo + 1), hi - 1);
      j1 = max(j2 - 1, lo + 1);
    } else {
      j1 = min(max(lo + (hi - lo) / 3, lo + 1), hi - 1);
      j2 = min(max(lo + 2 * (hi - lo) / 3, j1), hi - 1);
    }
    const int x1 = axis_cell(a, j1, K, table);
    const int x2 = axis_cell(a, j2, K, table);
    if (x1 != cur) {
      hi = j1;
      *v = x1;
      c = j1 - 1;
    } else if (x2 != cur) {
      lo = j1;
      hi = j2;
      *v = x2;
      c = j2 + 2;
    } else {
      lo = j2;
      c = j2 + 2;
    }
  }
  return hi;
}

// Counts cell (ix, iy) of the block's window (wx0, wy0) in shared memory,
// or a cell outside it straight into global memory.
__device__ __forceinline__ void count(unsigned* window, int wx0, int wy0,
                                      int* global, int W, int ix, int iy,
                                      unsigned one) {
  const int wx = ix - wx0, wy = iy - wy0;
  if ((unsigned)wx < (unsigned)kWindow && (unsigned)wy < (unsigned)kWindow)
    atomicAdd(window + wy * kWindow + wx, one);
  else
    atomicAdd(global + iy * W + ix, 1);
}

__global__ void __launch_bounds__(kThreads, 6)
    raymarch_kernel(const float* __restrict__ starts,
                    const float* __restrict__ ends,
                    const uint8_t* __restrict__ mask, int R,
                    const float* __restrict__ origin, float res, int W, int H,
                    int K, int* __restrict__ hit, int* __restrict__ empty) {
  extern __shared__ unsigned window[];
  float* table = reinterpret_cast<float*>(window + kWindow * kWindow);
  const float ox = origin[0], oy = origin[1];
  const int r0 = blockIdx.x * kRays;
  const int wx0 = point_cell(starts[2 * r0], ox, res, W) - kWindow / 2;
  const int wy0 = point_cell(starts[2 * r0 + 1], oy, res, H) - kWindow / 2;
  for (int i = threadIdx.x; i < kWindow * kWindow; i += kThreads)
    window[i] = 0;
  for (int i = threadIdx.x; i < min(K, kTable); i += kThreads)
    table[i] = sample_t(i, K);
  __syncthreads();

  const int r = r0 + threadIdx.x / kSegments;
  const int seg = threadIdx.x % kSegments;
  const int k0 = seg * K / kSegments, k1 = (seg + 1) * K / kSegments;
  if (r < R && k0 < k1 && mask[r]) {
    const float sx = starts[2 * r], sy = starts[2 * r + 1];
    const float ex = ends[2 * r], ey = ends[2 * r + 1];
    const int end_x = point_cell(ex, ox, res, W);
    const int end_y = point_cell(ey, oy, res, H);
    if (k0 == 0) count(window, wx0, wy0, hit, W, end_x, end_y, kHit);
    const float km1 = (float)(K - 1);
    const float dx = ex - sx, dy = ey - sy;
    const Axis ax{sx, dx, ox, res, km1 / dx, W};
    const Axis ay{sy, dy, oy, res, km1 / dy, H};
    int ix = axis_cell(ax, k0, K, table), iy = axis_cell(ay, k0, K, table);
    const bool fresh = k0 == 0 || axis_cell(ax, k0 - 1, K, table) != ix ||
                       axis_cell(ay, k0 - 1, K, table) != iy;
    int vx = ix, vy = iy;
    int kx = next_change(ax, k0, ix, k1, K, table, &vx);
    int ky = next_change(ay, k0, iy, k1, K, table, &vy);
    if (fresh && (ix != end_x || iy != end_y))
      count(window, wx0, wy0, empty, W, ix, iy, 1u);
    while (true) {
      const bool use_x = kx <= ky;
      const int k = use_x ? kx : ky;
      if (k >= k1) break;
      const int cur = use_x ? vx : vy;
      // The axis that changes first, field by field (kept in registers).
      const Axis a{use_x ? sx : sy, use_x ? dx : dy, use_x ? ox : oy, res,
                   use_x ? ax.scale : ay.scale, use_x ? W : H};
      int v = cur;
      const int kn = next_change(a, k, cur, k1, K, table, &v);
      if (use_x) {
        ix = cur;
        kx = kn;
        vx = v;
      } else {
        iy = cur;
        ky = kn;
        vy = v;
      }
      if (min(kx, ky) > k && (ix != end_x || iy != end_y))
        count(window, wx0, wy0, empty, W, ix, iy, 1u);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kWindow * kWindow; i += kThreads) {
    const unsigned w = window[i];
    if (w == 0) continue;
    const int cell = (wy0 + i / kWindow) * W + wx0 + i % kWindow;
    if (w & (kHit - 1)) atomicAdd(empty + cell, (int)(w & (kHit - 1)));
    if (w >> 16) atomicAdd(hit + cell, (int)(w >> 16));
  }
}

}  // namespace

// starts/ends [R,2] f32, mask [R] u8, origin [2] f32;
// hit/empty [H*W] i32, zeroed by the caller.
NDT2D_API int ndt2d_raymarch(const void* starts, const void* ends,
                             const void* mask, int R, const void* origin,
                             float res, int W, int H, int K, void* hit,
                             void* empty, void* stream) {
  if (R < 0 || W < 1 || H < 1 || K < 2) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  // At most 32 KB: no opt-in above the default 48 KB.
  const size_t smem = sizeof(unsigned) * kWindow * kWindow +
                      sizeof(float) * std::min(K, kTable);
  const int nb = (R + kRays - 1) / kRays;
  raymarch_kernel<<<nb, kThreads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(starts), static_cast<const float*>(ends),
      static_cast<const uint8_t*>(mask), R, static_cast<const float*>(origin),
      res, W, H, K, static_cast<int*>(hit), static_cast<int*>(empty));
  return (int)cudaGetLastError();
}
