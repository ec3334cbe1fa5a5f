// The reduction shared by the tiled lattice searches, K6
// (candidate_gather.cu) and K11's lattice (correlative.cu):
// matcher.py::reduce_candidates + finalize_match over candidates scored one
// per thread in blocks of (tile of kTile offsets, angle, row).
//
// reduce_tile folds a block's candidates into one partial: (min, first flat
// index) and the 10 Olson sums through a fixed-shape warp tree, then the
// warps in order.  finalize, one block per row, combines a row's (angle,
// tile) partials in order and writes the [13] output row (score,
// correction, row-major covariance), K2's layout, so K7 chains after either
// search.  Every sum has a fixed order, so a row's bits depend neither on
// the launch nor on the other rows.
#pragma once

#include "common.cuh"

namespace {
namespace lattice {

constexpr int kTile = 256;  // offsets (threads) a block
constexpr int kWarps = kTile / 32;
// Olson sums: s, u0..u2, k00, k01, k02, k11, k12, k22.
constexpr int kSums = 10;
// Per-(angle, tile) partial: best, best flat index (as float), the sums.
constexpr int kPartial = 2 + kSums;
constexpr int kFinalizeThreads = 128;
constexpr int kStage = 256;  // partials staged at a time by finalize

// Called by all kTile threads of a block: thread t holds candidate `cand`
// at flat index `flat` (a * L * L + offset) with lattice coordinates x =
// (dx, dy, dth); `live` is false for the padding past the last offset.
// Thread 0 writes the block's partial [kPartial].
__device__ __forceinline__ void reduce_tile(float cand, bool live, int flat,
                                            float x0, float x1, float x2,
                                            float* __restrict__ partial) {
  __shared__ float warp_sums[kWarps][kPartial];
  float best = live ? cand : __int_as_float(0x7f800000);  // +inf
  int best_i = live ? flat : 0x7fffffff;
  float v[kSums] = {0.f};
  if (live) {
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
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    warp_sums[warp][0] = best;
    warp_sums[warp][1] = __int_as_float(best_i);
#pragma unroll
    for (int k = 0; k < kSums; ++k) warp_sums[warp][2 + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = warp_sums[0][0];
    int bi = __float_as_int(warp_sums[0][1]);
    float acc_s[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc_s[k] = warp_sums[0][2 + k];
    for (int w = 1; w < kWarps; ++w) {  // warps hold increasing flat indices
      if (warp_sums[w][0] < b) {
        b = warp_sums[w][0];
        bi = __float_as_int(warp_sums[w][1]);
      }
#pragma unroll
      for (int k = 0; k < kSums; ++k) acc_s[k] += warp_sums[w][2 + k];
    }
    partial[0] = b;
    partial[1] = __int_as_float(bi);
#pragma unroll
    for (int k = 0; k < kSums; ++k) partial[2 + k] = acc_s[k];
  }
}

// Combine a row's N = A * tiles partials in (angle, tile) order;
// matcher.py::finalize_match.  out = [score, correction (3), covariance (9,
// row-major)].  The block stages the partials through shared memory with
// coalesced loads, kStage at a time; one thread combines them in order.
// A row's points are nums[r] (or `num` for every row when nums is null).
// Grid (R): row r = blockIdx.x.
__global__ void __launch_bounds__(kFinalizeThreads) finalize(
    const float* __restrict__ partial, int N, int L,
    const int* __restrict__ nums, int num, int max_beams,
    const float* __restrict__ dths, const float* __restrict__ dls,
    float* __restrict__ out) {
  __shared__ float sp[kStage * kPartial];
  const size_t r = blockIdx.x;
  const int num_points = nums != nullptr ? nums[r] : num;
  partial += r * N * kPartial;
  out += r * 13;
  float best = __int_as_float(0x7f800000);  // +inf
  int bi = 0;
  float v[kSums] = {0.f};
  for (int base = 0; base < N; base += kStage) {
    const int n = min(kStage, N - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n * kPartial; i += blockDim.x)
      sp[i] = partial[(size_t)base * kPartial + i];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int j = 0; j < n; ++j) {
        const float* p = sp + j * kPartial;
        if (base + j == 0) {
          best = p[0];
          bi = __float_as_int(p[1]);
#pragma unroll
          for (int k = 0; k < kSums; ++k) v[k] = p[2 + k];
          continue;
        }
        if (p[0] < best) {  // strict: earlier partials hold lower indices
          best = p[0];
          bi = __float_as_int(p[1]);
        }
#pragma unroll
        for (int k = 0; k < kSums; ++k) v[k] += p[2 + k];
      }
    }
  }
  if (threadIdx.x != 0) return;
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

}  // namespace lattice
}  // namespace
