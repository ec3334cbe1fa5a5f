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
// against (Nq + Nk) x B floats read and Nq x k pairs written; 0.8 G
// operations at a 2048-keyframe table.  The sums must keep one order (row
// q of an all-pairs launch and a one-row launch of q give the same bits,
// and the twin adds in the same order), and the reference computes them
// at HIGHEST precision, so neither TF32 nor a split-precision product on
// the tensor cores applies: the CUDA cores carry them, a multiply and an
// add each (-fmad=false).  Two launches:
//
// similarity_tiles: a block computes 64 query rows x 64 keys, 256 threads
//   holding 4 x 4 outputs each.  The descriptor dimension streams through
//   shared memory 32 elements at a time, double-buffered with cp.async
//   (16-byte copies where B % 4 == 0 and the tables are 16-byte aligned,
//   else 4-byte ones), so a key chunk is read once per 64 query rows.
//   Every output is one register that adds its B products in index order
//   from 0: register tiling changes no sum's order.  Elements past B, rows
//   past Nq and keys past Nk are staged as zeros; a zero product added to
//   a sum that starts at +0 leaves its bits unchanged, and padded outputs
//   are never written.  A tile whose keys all lie above the largest limit
//   of its rows is skipped: the all-pairs search is lower-triangular.  The
//   masked similarities go to a scratch [Nq, Nk] buffer (16.8 MB at 2048
//   keyframes, which stays in the 50 MB L2).
// top_k_warps: one warp per query row reads j <= min(limit[q], Nk - 1),
//   each lane keeping a sorted list of its 4 best (value descending, index
//   ascending), then the lists merge by shuffles, one warp-wide best head
//   a slot.  More than 4 slots take further rounds over the entries ranked
//   after the last one emitted.  The loop search asks for 3 (one round),
//   the merge for 10 (three rounds of a 106-row table); a longer list
//   would lengthen every insertion of the main path's rows.  Slots past
//   the row's eligible range take the indices that follow it with -inf,
//   as the order places them.
#include "common.cuh"

#include <limits.h>
#include <math.h>

namespace {

constexpr int kTile = 64;            // query rows and keys of a tile
constexpr int kChunk = 32;           // descriptor elements a stage
constexpr int kStride = kChunk + 4;  // a staged row: 16-byte aligned,
                                     // conflict-free float4 reads
constexpr int kSimThreads = 256;     // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTopKWarps = 8;        // query rows of a top-k block
constexpr int kList = 4;             // a lane's list: k <= 4 in one round

// (v, j) ranks before (bv, bj): larger value, then lower index.
__device__ __forceinline__ bool before(float v, int j, float bv, int bj) {
  return v > bv || (v == bv && j < bj);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage elements [b0, b0 + 32) of rows [r0, r0 + 64) of src [rows, B] into
// tile [64][kStride]; zeros past the rows or B (a copy of 0 bytes fills).
template <bool kVec>
__device__ __forceinline__ void stage(float* tile,
                                      const float* __restrict__ src,
                                      int rows, int B, int r0, int b0) {
  if (kVec) {
    for (int f = threadIdx.x; f < kTile * (kChunk / 4); f += kSimThreads) {
      const int r = f / (kChunk / 4), c = f % (kChunk / 4) * 4;
      const bool in = r0 + r < rows && b0 + c < B;
      cp_async16(tile + r * kStride + c,
                 in ? src + (size_t)(r0 + r) * B + b0 + c : src, in);
    }
  } else {
    for (int f = threadIdx.x; f < kTile * kChunk; f += kSimThreads) {
      const int r = f / kChunk, c = f % kChunk;
      const bool in = r0 + r < rows && b0 + c < B;
      cp_async4(tile + r * kStride + c,
                in ? src + (size_t)(r0 + r) * B + b0 + c : src, in);
    }
  }
}

// Grid (key tiles, query tiles).  sims[q, j] for the tile's q < Nq, j < Nk.
template <bool kVec>
__global__ void __launch_bounds__(kSimThreads) similarity_tiles(
    const float* __restrict__ query, const float* __restrict__ keys,
    const uint8_t* __restrict__ valid, const int* __restrict__ limit, int Nq,
    int Nk, int B, float* __restrict__ sims) {
  __shared__ __align__(16) float qs[2][kTile * kStride];
  __shared__ __align__(16) float ks[2][kTile * kStride];
  __shared__ int lim_s[kTile];
  __shared__ uint8_t valid_s[kTile];
  __shared__ int lim_max;
  const int t = threadIdx.x;
  const int k0 = blockIdx.x * kTile, q0 = blockIdx.y * kTile;
  if (t == 0) lim_max = INT_MIN;
  __syncthreads();
  if (t < kTile) {
    lim_s[t] = q0 + t < Nq ? limit[q0 + t] : INT_MIN;
    valid_s[t] = k0 + t < Nk ? valid[k0 + t] : 0;
    atomicMax(&lim_max, lim_s[t]);
  }
  __syncthreads();
  if (k0 > lim_max) return;  // no key of the tile is eligible for its rows

  const int tx = t % 16, ty = t / 16;  // keys tx + 16 j, rows ty + 16 i
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int chunks = (B + kChunk - 1) / kChunk;
  if (chunks > 0) {
    stage<kVec>(qs[0], query, Nq, B, q0, 0);
    stage<kVec>(ks[0], keys, Nk, B, k0, 0);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage<kVec>(qs[(c + 1) & 1], query, Nq, B, q0, (c + 1) * kChunk);
      stage<kVec>(ks[(c + 1) & 1], keys, Nk, B, k0, (c + 1) * kChunk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* qa = qs[c & 1];
    const float* ka = ks[c & 1];
#pragma unroll
    for (int b = 0; b < kChunk; b += 4) {
      float4 a[4], k[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qa + (ty + 16 * i) * kStride
                                                + b);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        k[j] = *reinterpret_cast<const float4*>(ka + (tx + 16 * j) * kStride
                                                + b);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] += a[i].x * k[j].x;
          acc[i][j] += a[i].y * k[j].y;
          acc[i][j] += a[i].z * k[j].z;
          acc[i][j] += a[i].w * k[j].w;
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, q = q0 + r;
    if (q >= Nq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, key = k0 + c;
      if (key < Nk)
        sims[(size_t)q * Nk + key] =
            (valid_s[c] && key <= lim_s[r]) ? acc[i][j] : -INFINITY;
    }
  }
}

// Grid (ceil(Nq / 8)), a warp a query row: its k best of sims[q, 0 ..
// min(limit[q], Nk - 1)], then (-inf, s) in slots s past them.
__global__ void __launch_bounds__(kTopKWarps * 32) top_k_warps(
    const float* __restrict__ sims, const int* __restrict__ limit, int Nq,
    int Nk, int k, long long* __restrict__ out_idx,
    float* __restrict__ out_score) {
  const int lane = threadIdx.x % 32;
  const int q = blockIdx.x * kTopKWarps + threadIdx.x / 32;
  if (q >= Nq) return;
  const int jmax = min(limit[q], Nk - 1);
  const int m = min(k, max(jmax + 1, 0));  // slots filled from the row
  const float* row = sims + (size_t)q * Nk;
  out_idx += (size_t)q * k;
  out_score += (size_t)q * k;
  float pv = INFINITY;  // the last slot emitted; every entry ranks after
  int pj = -1;          // (+inf, -1)
  for (int s0 = 0; s0 < m; s0 += kList) {
    float lv[kList];
    int lj[kList];
#pragma unroll
    for (int i = 0; i < kList; ++i) {
      lv[i] = -INFINITY;  // ranks after every entry of the row
      lj[i] = INT_MAX;
    }
    for (int j = lane; j <= jmax; j += 32) {
      const float v = row[j];
      if (before(pv, pj, v, j) &&
          before(v, j, lv[kList - 1], lj[kList - 1])) {
        lv[kList - 1] = v;
        lj[kList - 1] = j;
#pragma unroll
        for (int i = kList - 1; i > 0; --i)
          if (before(lv[i], lj[i], lv[i - 1], lj[i - 1])) {
            const float tv = lv[i];
            const int tj = lj[i];
            lv[i] = lv[i - 1];
            lj[i] = lj[i - 1];
            lv[i - 1] = tv;
            lj[i - 1] = tj;
          }
      }
    }
    const int take = min(kList, m - s0);
    for (int s = 0; s < take; ++s) {
      float bv = lv[0];
      int bj = lj[0];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
        if (before(ov, oj, bv, bj)) {
          bv = ov;
          bj = oj;
        }
      }
      if (lj[0] == bj) {  // this lane's head is the slot's: pop it
#pragma unroll
        for (int i = 0; i < kList - 1; ++i) {
          lv[i] = lv[i + 1];
          lj[i] = lj[i + 1];
        }
        lv[kList - 1] = -INFINITY;
        lj[kList - 1] = INT_MAX;
      }
      if (lane == 0) {
        out_idx[s0 + s] = bj;
        out_score[s0 + s] = bv;
      }
      pv = bv;
      pj = bj;
    }
  }
  for (int s = m + lane; s < k; s += 32) {
    out_idx[s] = s;
    out_score[s] = -INFINITY;
  }
}

}  // namespace

// query [Nq,B] f32, keys [Nk,B] f32, valid [Nk] u8, limit [Nq] i32, scratch
// sims [Nq,Nk] f32; outputs idx [Nq,k] i64 and score [Nq,k] f32.  The plan
// (kernels/descriptor_search.py::plan): vec (16-byte copies: B % 4 == 0,
// query and keys 16-byte aligned), key tiles and query tiles of 64.
NDT2D_API int ndt2d_descriptor_top_k(const void* query, const void* keys,
                                     const void* valid, const void* limit,
                                     int Nq, int Nk, int B, int k, int vec,
                                     int key_tiles, int query_tiles,
                                     void* sims, void* out_idx,
                                     void* out_score, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (k < 1 || k > Nk || Nq < 0 || B < 0 ||
      (long long)key_tiles * kTile < Nk ||
      (long long)query_tiles * kTile < Nq || query_tiles > 65535 ||
      (vec && (B % 4 || reinterpret_cast<uintptr_t>(query) % 16 ||
               reinterpret_cast<uintptr_t>(keys) % 16)))
    return (int)cudaErrorInvalidValue;
  if (Nq == 0) return 0;
  const dim3 grid(key_tiles, query_tiles);
  const float* qf = static_cast<const float*>(query);
  const float* kf = static_cast<const float*>(keys);
  const uint8_t* vf = static_cast<const uint8_t*>(valid);
  const int* lf = static_cast<const int*>(limit);
  float* sf = static_cast<float*>(sims);
  if (vec)
    similarity_tiles<true><<<grid, kSimThreads, 0, st>>>(qf, kf, vf, lf, Nq,
                                                         Nk, B, sf);
  else
    similarity_tiles<false><<<grid, kSimThreads, 0, st>>>(qf, kf, vf, lf, Nq,
                                                          Nk, B, sf);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (Nq + kTopKWarps - 1) / kTopKWarps;
  long long* oi = static_cast<long long*>(out_idx);
  float* os = static_cast<float*>(out_score);
  top_k_warps<<<blocks, kTopKWarps * 32, 0, st>>>(sf, lf, Nq, Nk, k, oi, os);
  return (int)cudaGetLastError();
}
