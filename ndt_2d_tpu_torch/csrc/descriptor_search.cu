// K10 (search): cosine similarity of descriptor rows and the k best per
// query.
//
// Replaces the jitted ndt_2d_tpu/parallel/loop_search.py::search_all_pairs
// (:153-175, one [N, B] x [B, N] product, the eligibility mask and a
// row-wise top-k) and ::search_dense (:131-149, the same for one query).
// Per query row q:
//   sim[j] = sum_b query[q, b] * keys[j, b]      (b in order from 0)
//   sim[j] = -inf unless valid[j] and j <= limit[q]
// and the k largest sim[j] come out in descending order, equal values in
// ascending j (the order jax.lax.top_k returns them in).
//
// What bounds it on the card: operations.  Nq x Nk x B multiply-adds
// against (Nq + Nk) x B floats read and Nq x k pairs written.  Design: one
// block per query row.  The query sits in shared memory; the keys come
// through a [128 keys x 32 dims] shared tile (read coalesced, stored with
// one column of padding), and thread t adds key j0 + t's products in index
// order from 0 into one register, so a similarity has one summation order
// whatever the launch: row q of an all-pairs launch and a one-row launch of
// q give the same bits, and the twin adds in the same order.  Key blocks
// wholly above the row's limit are skipped.  The similarities of the row
// stay in shared memory; the k best are taken in k passes, each the
// block-wide maximum among the entries that come after the previous winner
// in the (value descending, index ascending) order, so nothing is marked
// or moved and ties need no special case.
#include "common.cuh"

#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;
constexpr int kWarps = kThreads / 32;

// (v, j) ranks before (bv, bj): larger value, then lower index.
__device__ __forceinline__ bool before(float v, int j, float bv, int bj) {
  return v > bv || (v == bv && j < bj);
}

// Grid (Nq): query row q = blockIdx.x.  Dynamic shared memory: B floats
// (the query), Nk floats (the row's similarities), the key tile.
__global__ void __launch_bounds__(kThreads) top_k_rows(
    const float* __restrict__ query, const float* __restrict__ keys,
    const uint8_t* __restrict__ valid, const int* __restrict__ limit, int Nk,
    int B, int k, int* __restrict__ out_idx, float* __restrict__ out_score) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* sims = qs + B;
  float* tile = sims + Nk;  // [kThreads][kTile + 1]
  __shared__ float red_v[kWarps];
  __shared__ int red_j[kWarps];
  __shared__ float win_v;
  __shared__ int win_j;

  const int q = blockIdx.x;
  const int t = threadIdx.x;
  const int lim = limit[q];
  query += (size_t)q * B;
  for (int b = t; b < B; b += kThreads) qs[b] = query[b];
  __syncthreads();

  for (int j0 = 0; j0 < Nk; j0 += kThreads) {
    const int j = j0 + t;
    if (j0 > lim) {  // the whole block of keys is ineligible
      if (j < Nk) sims[j] = -INFINITY;
      continue;
    }
    float acc = 0.f;
    for (int b0 = 0; b0 < B; b0 += kTile) {
      for (int i = 0; i < kTile; ++i) {
        const int flat = i * kThreads + t;
        const int kk = flat / kTile, bb = flat % kTile;
        const int row = j0 + kk, col = b0 + bb;
        tile[kk * (kTile + 1) + bb] =
            (row < Nk && col < B) ? keys[(size_t)row * B + col] : 0.f;
      }
      __syncthreads();
      const int nb = min(kTile, B - b0);
      for (int bb = 0; bb < nb; ++bb)
        acc += qs[b0 + bb] * tile[t * (kTile + 1) + bb];
      __syncthreads();
    }
    if (j < Nk) sims[j] = (valid[j] && j <= lim) ? acc : -INFINITY;
  }
  __syncthreads();

  float pv = 0.f;
  int pj = -1;
  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bj = INT_MAX;
    for (int j = t; j < Nk; j += kThreads) {
      const float v = sims[j];
      const bool open = r == 0 || before(pv, pj, v, j);
      if (open && before(v, j, bv, bj)) {
        bv = v;
        bj = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oj = __shfl_down_sync(0xffffffffu, bj, off);
      if (before(ov, oj, bv, bj)) {
        bv = ov;
        bj = oj;
      }
    }
    if ((t & 31) == 0) {
      red_v[t >> 5] = bv;
      red_j[t >> 5] = bj;
    }
    __syncthreads();
    if (t == 0) {
      for (int w = 1; w < kWarps; ++w)
        if (before(red_v[w], red_j[w], bv, bj)) {
          bv = red_v[w];
          bj = red_j[w];
        }
      win_v = bv;
      win_j = bj;
      out_idx[(size_t)q * k + r] = bj;
      out_score[(size_t)q * k + r] = bv;
    }
    __syncthreads();
    pv = win_v;
    pj = win_j;
  }
}

}  // namespace

// Shared memory of one block for Nk keys of B floats.
static size_t top_k_shared(int Nk, int B) {
  return ((size_t)B + (size_t)Nk + (size_t)kThreads * (kTile + 1)) *
         sizeof(float);
}

// query [Nq,B] f32, keys [Nk,B] f32, valid [Nk] u8, limit [Nq] i32; outputs
// idx [Nq,k] i32 and score [Nq,k] f32.  1 <= k <= Nk; the similarities of a
// row must fit one block's shared memory.
NDT2D_API int ndt2d_descriptor_top_k(const void* query, const void* keys,
                                     const void* valid, const void* limit,
                                     int Nq, int Nk, int B, int k,
                                     void* out_idx, void* out_score,
                                     void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t shared = top_k_shared(Nk, B);
  if (k < 1 || k > Nk || shared > 200 * 1024)
    return (int)cudaErrorInvalidValue;
  if (Nq == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      top_k_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err != cudaSuccess) return (int)err;
  top_k_rows<<<Nq, kThreads, shared, st>>>(
      static_cast<const float*>(query), static_cast<const float*>(keys),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(limit), Nk,
      B, k, static_cast<int*>(out_idx), static_cast<float*>(out_score));
  return (int)cudaGetLastError();
}
