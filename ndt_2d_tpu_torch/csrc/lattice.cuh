// The reduction shared by the tiled lattice searches, K6
// (candidate_gather.cu) and K11's lattice (correlative.cu):
// matcher.py::reduce_candidates + finalize_match over candidates scored one
// per thread in groups of kTile threads (a tile of kTile offsets of an
// angle of a row each).
//
// reduce_tiles folds each group's candidates into one partial: (min, first
// flat index) and the 10 Olson sums through a fixed-shape warp tree, then
// the warps in order.  finalize_row combines a row's (angle, tile)
// partials in order and writes the [13] output row (score, correction,
// row-major covariance), K2's layout, so K7 chains after either search:
// inside K11's lattice launch, by the row's last block, or as its own
// launch (finalize, a block a row: the parent form of K11's lattice, kept
// for comparison).  K6's rows fold in K2's finalize launch
// (ndt2d::split_finalize, common.cuh), in the same order.  Every sum has a
// fixed order, so a row's bits depend neither on the launch nor on the
// other rows.
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

// Called by all kG kTile threads of a block, kG groups of kTile: thread t
// of group g holds candidate `cand` at flat index `flat` (a * L * L +
// offset) with lattice coordinates x = (dx, dy, dth); `live` is false for
// the padding past the last offset.  Thread 0 of group g writes the
// group's partial [kPartial] to `partial`, its own (none where null).
template <int kG>
__device__ __forceinline__ void reduce_tiles(float cand, bool live, int flat,
                                             float x0, float x1, float x2,
                                             float* __restrict__ partial) {
  __shared__ float warp_sums[kG][kWarps][kPartial];
  const int g = threadIdx.x / kTile, t = threadIdx.x % kTile;
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
  const int warp = t >> 5, lane = t & 31;
  if (lane == 0) {
    warp_sums[g][warp][0] = best;
    warp_sums[g][warp][1] = __int_as_float(best_i);
#pragma unroll
    for (int k = 0; k < kSums; ++k) warp_sums[g][warp][2 + k] = v[k];
  }
  __syncthreads();
  if (t == 0 && partial != nullptr) {
    float b = warp_sums[g][0][0];
    int bi = __float_as_int(warp_sums[g][0][1]);
    float acc_s[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc_s[k] = warp_sums[g][0][2 + k];
    for (int w = 1; w < kWarps; ++w) {  // warps hold increasing flat indices
      if (warp_sums[g][w][0] < b) {
        b = warp_sums[g][w][0];
        bi = __float_as_int(warp_sums[g][w][1]);
      }
#pragma unroll
      for (int k = 0; k < kSums; ++k) acc_s[k] += warp_sums[g][w][2 + k];
    }
    partial[0] = b;
    partial[1] = __int_as_float(bi);
#pragma unroll
    for (int k = 0; k < kSums; ++k) partial[2 + k] = acc_s[k];
  }
}

// reduce_tiles for a block of one group of kTile threads.
__device__ __forceinline__ void reduce_tile(float cand, bool live, int flat,
                                            float x0, float x1, float x2,
                                            float* __restrict__ partial) {
  reduce_tiles<1>(cand, live, flat, x0, x1, x2, partial);
}

// Combine one row's N = A * tiles partials in (angle, tile) order;
// matcher.py::finalize_match.  out = [score, correction (3), covariance (9,
// row-major)].  The block stages the partials through `sp` (stage *
// kPartial floats of shared memory, kPartial more with kLanes) with
// coalesced loads, `stage` at a time.  Then one thread combines them in
// order.  kLanes (a block of at least 64 threads; partials other blocks of
// the same launch wrote, read through L2, sixteen loads a thread in flight
// at once): lane k < kSums of warp 0 adds sum k's chain, each in the
// serial thread's order, and warp 1 finds the stage's (min, first index),
// lanes over strided partials, then a shuffle tree that breaks ties by
// the lower index; the first partial opens the running pair and a stage's
// pair replaces it only where strictly less.  That is the serial scan's
// result: with a non-NaN first partial, the first of the least non-NaN
// values; with a NaN one, the NaN.  Every thread of the block calls it;
// thread 0 writes out.
template <bool kL2, bool kLanes>
__device__ __forceinline__ void finalize_row(
    const float* __restrict__ partial, int N, int L, int num_points,
    int max_beams, const float* __restrict__ dths,
    const float* __restrict__ dls, float* __restrict__ out, float* sp,
    int stage = kStage) {
  constexpr int kLoads = 16;  // kLanes: a thread's loads in flight at once
  float best = __int_as_float(0x7f800000);  // +inf
  int bi = 0;
  float v[kSums] = {0.f};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float mine = 0.f;  // kLanes: lane k's sum
  for (int base = 0; base < N; base += stage) {
    const int n = min(stage, N - base);
    const float* src = partial + (size_t)base * kPartial;
    __syncthreads();
    if (kLanes) {
      const int nt = blockDim.x;
      for (int i0 = threadIdx.x; i0 < n * kPartial; i0 += kLoads * nt) {
        float vals[kLoads];
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
          const int i = i0 + k * nt;
          vals[k] = i < n * kPartial ? (kL2 ? __ldcg(src + i) : src[i])
                                     : 0.f;
        }
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
          const int i = i0 + k * nt;
          if (i < n * kPartial) sp[i] = vals[k];
        }
      }
    } else {
      for (int i = threadIdx.x; i < n * kPartial; i += blockDim.x)
        sp[i] = kL2 ? __ldcg(src + i) : src[i];
    }
    __syncthreads();
    if (kLanes) {
      const int first = base == 0 ? 1 : 0;  // the row's first partial
      if (warp == 0 && lane < kSums) {
        const float* col = sp + 2 + lane;
        if (first) mine = col[0];
#pragma unroll 16
        for (int j = first; j < n; ++j) mine += col[j * kPartial];
      } else if (warp == 1) {
        float b = __int_as_float(0x7f800000);
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
        if (lane == 0) {
          if (first) {
            best = sp[0];
            bi = __float_as_int(sp[1]);
          }
          if (b < best) {
            best = b;
            bi = i;
          }
        }
      }
    } else if (threadIdx.x == 0) {
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
  if (kLanes) {
    float* folded = sp + stage * kPartial;
    __syncthreads();
    if (warp == 0 && lane < kSums) folded[2 + lane] = mine;
    if (threadIdx.x == 32) {
      folded[0] = best;
      folded[1] = __int_as_float(bi);
    }
    __syncthreads();
    best = folded[0];
    bi = __float_as_int(folded[1]);
#pragma unroll
    for (int k = 0; k < kSums; ++k) v[k] = folded[2 + k];
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

// finalize_row over R rows, a block a row: row r = blockIdx.x.  A row's
// points are nums[r] (or `num` for every row when nums is null).
__global__ void __launch_bounds__(kFinalizeThreads) finalize(
    const float* __restrict__ partial, int N, int L,
    const int* __restrict__ nums, int num, int max_beams,
    const float* __restrict__ dths, const float* __restrict__ dls,
    float* __restrict__ out) {
  __shared__ float sp[kStage * kPartial];
  const size_t r = blockIdx.x;
  finalize_row<false, false>(partial + r * N * kPartial, N, L,
                      nums != nullptr ? nums[r] : num, max_beams, dths, dls,
                      out + r * 13, sp);
}

}  // namespace lattice
}  // namespace
