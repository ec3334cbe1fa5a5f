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
// What bounds it on the card: the integer atomics, about one per crossed
// cell (a few hundred per ray over ~1e5 rays), contended near each scan's
// origin where all of its rays start.  Design: one thread per ray walking
// its samples with the previous cell in a register for the dedupe.  int32
// atomicAdd is order-free, so the counts are deterministic and bitwise
// equal to the twin's.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int cell_of(float x, float y, float ox, float oy,
                                       float res, int W, int H) {
  const float fx = fminf(fmaxf(floorf((x - ox) / res), 0.f), (float)(W - 1));
  const float fy = fminf(fmaxf(floorf((y - oy) / res), 0.f), (float)(H - 1));
  return (int)fy * W + (int)fx;
}

__global__ void raymarch_kernel(const float* __restrict__ starts,
                                const float* __restrict__ ends,
                                const uint8_t* __restrict__ mask, int R,
                                const float* __restrict__ origin, float res,
                                int W, int H, int K, int* __restrict__ hit,
                                int* __restrict__ empty) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R || !mask[r]) return;
  const float ox = origin[0], oy = origin[1];
  const float sx = starts[2 * r], sy = starts[2 * r + 1];
  const float ex = ends[2 * r], ey = ends[2 * r + 1];
  const int end_cell = cell_of(ex, ey, ox, oy, res, W, H);
  atomicAdd(hit + end_cell, 1);
  const float dx = ex - sx, dy = ey - sy;
  const float denom = (float)(K - 1);
  int prev = -1;
  for (int k = 0; k < K; ++k) {
    const float t = (k == K - 1) ? 1.f : (float)k / denom;
    const int cell = cell_of(sx + dx * t, sy + dy * t, ox, oy, res, W, H);
    if (cell != prev && cell != end_cell) atomicAdd(empty + cell, 1);
    prev = cell;
  }
}

}  // namespace

// starts/ends [R,2] f32, mask [R] u8, origin [2] f32;
// hit/empty [H*W] i32, zeroed by the caller.
NDT2D_API int ndt2d_raymarch(const void* starts, const void* ends,
                             const void* mask, int R, const void* origin,
                             float res, int W, int H, int K, void* hit,
                             void* empty, void* stream) {
  const int nb = max((R + kThreads - 1) / kThreads, 1);
  raymarch_kernel<<<nb, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(starts), static_cast<const float*>(ends),
      static_cast<const uint8_t*>(mask), R, static_cast<const float*>(origin),
      res, W, H, K, static_cast<int*>(hit), static_cast<int*>(empty));
  return (int)cudaGetLastError();
}
