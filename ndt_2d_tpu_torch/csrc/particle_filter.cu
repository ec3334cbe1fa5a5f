// K9: the particle filter's motion sample, KLD resample, recovery injection
// and statistics.
//
// Replaces the jitted XLA hot loop of the JAX package's particle filter:
// ndt_2d_tpu/filter/motion_model.py::sample, and filter/particle_filter.py::
// normalize_weights, kld_resample, inject_free_space and update_statistics,
// which pf_step and pf_step_recovery fuse.  The random numbers are drawn
// outside (torch generators) and handed in, so this code and its twin see
// the same draws.
//
// What bounds it on the card: latency, not bytes.  M = 5000-20000 particles
// are 60-240 KB of state; the work is a handful of dependent passes over
// them (a CDF, a draw, a first-occurrence mark, a prefix count, weighted
// sums), each a few microseconds wide.  Two launches a resample:
//  * pf_motion: one thread per particle (rot-trans-rot sample with pre-drawn
//    standard normals and host-computed scalars; the body in pf_motion.cuh,
//    which K3's particle launch, score_points.cu, also runs: on one device
//    the filter's step folds the motion into that launch, and this one
//    serves the mesh's step and ParticleFilter.update).
//  * pf_chain: everything else in one cooperative launch of `blocks` blocks
//    (kernels/particle_filter.py::plan), phases separated by grid syncs:
//    the masked weight total (and, with recovery, the sum of the negated
//    weights: w_slow/w_fast and p_inject); normalize and the chunks' running
//    sums; the chunk offsets and the CDF; the draw (the binary search of
//    jnp.searchsorted, 'scan' method, side left, on r = cdf[M-1] * (1 - u),
//    over the CDF staged in shared memory), the gather, the truncated bin
//    keys (IEEE division) and an open-addressed table of the keys whose
//    integer atomicMin leaves each key's first draw index (the same table
//    contents whatever the order of the atomics); the first-occurrence
//    marks; the prefix count k(m), the KLD bound and n_active; with recovery
//    the free-space injection; then the statistics.  The entry
//    ndt2d_pf_statistics runs the last phases alone (update_statistics, with
//    or without the injection), ndt2d_pf_ewma the first (measure()'s EWMAs).
// Every float sum is taken in one fixed order, the twin's: the M items are
// 1024 chunks of L = ceil(M / 1024) consecutive items, each chunk summed from
// 0 in order, then a halving tree over the 1024 chunk sums; the CDF scans
// each chunk and offsets it by the inclusive Hillis-Steele scan of the chunk
// totals, shifted by one.  Block b owns the cpb consecutive chunks b cpb ..:
// its threads load and compute the chunks' items one a thread (coalesced,
// the cosf/sinf of the statistics on every SM), stage them in shared memory
// (in a device-memory scratch of the block's own where they do not fit),
// and one thread a chunk adds the chunk in order; after a grid sync every
// block folds the same 1024 chunk sums by the same tree (its last five
// levels as shuffles, which add the same pairs), all the sums of one stage
// in one pass, so every block holds the same total and no result travels
// back through device memory.  Each stage writes its chunk sums to a region
// of the scratch of its own, so no block overwrites sums that another is
// still folding.  No float atomics anywhere: every output is bitwise
// reproducible, and the twin adds in the same order.  The launch needs its
// blocks co-resident: the plan asks the card how many it holds
// (ndt2d_pf_chain_fit) and takes more chunks a block until they fit; where
// the card cannot hold a plan's blocks, or refuses its shared memory, the
// entry returns the error and launches nothing.
#include <cooperative_groups.h>
#include <limits.h>

#include "common.cuh"
#include "pf_motion.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kChunks = 1024;             // chunks of every sum
constexpr int kPer = kChunks / kThreads;  // chunk sums a thread folds
constexpr int kSums = 7;                  // the most sums of one stage
constexpr int kWarps = kThreads / 32;

// Modes of pf_chain (update_statistics ends every mode but kRecovery
// alone).
constexpr int kResample = 1;  // normalize, CDF, draw, first occurrences, n
constexpr int kRecovery = 2;  // the negated weights' sum: w_slow/w_fast
constexpr int kInject = 4;    // the free-space injection

// Regions of the chunk-sum scratch [kRegions, kChunks], one a stage.
enum Region {
  kTotal,
  kGood,
  kChunkTotal,
  kNeutral,
  kStatTotal,
  kMoments,  // kSums regions
  kSpread = kMoments + kSums,
  kRegions
};

using ndt2d::normalize_angle;

__device__ __forceinline__ unsigned key_hash(int a, int b, int c) {
  unsigned h = (unsigned)a * 73856093u;
  h ^= (unsigned)b * 19349663u;
  h ^= (unsigned)c * 83492791u;
  h ^= h >> 15;
  h *= 2654435761u;
  return h ^ (h >> 13);
}

// kernels/particle_filter.py::plan: chunks of L items, cpb chunks a block,
// blocks = kChunks / cpb blocks of items = cpb L items; staged: the CDF is
// searched in shared memory; spill: the block's item arrays lie in device
// memory (Chain::spill), not in shared memory.
struct Plan {
  int L, cpb, blocks, items, staged, spill;
};

// The item arrays of a block: kSums + 4 float arrays and one int array
// [items].
constexpr int kItemArrays = kSums + 5;

// Dynamic shared memory of a block (floats and ints, 4 bytes each): the
// staged CDF [M], the item arrays unless spilled, the scan's two buffers
// [2 kChunks], the fold's scratch [kSums (kThreads + 1)] and two int chunk
// arrays [cpb].
__host__ __device__ inline size_t smem_bytes(const Plan& p, int M) {
  return 4 * ((size_t)(p.staged ? M : 0) +
              (size_t)(p.spill ? 0 : kItemArrays) * p.items + 2 * kChunks +
              kSums * (kThreads + 1) + 2 * p.cpb);
}

struct Chain {
  // Inputs: raw weights [M], uniforms [M], particles [M,3] f32, n_in [1]
  // i32; wstate [2] (w_slow, w_fast); scal [1] p_inject (statistics entry);
  // the injection's pool free_xy [F,2] and draws u_sel [M], inj_idx [M] i32,
  // jitter [M,2], theta [M].
  const float *w, *u, *parts, *wstate, *scal, *free_xy, *u_sel, *jitter,
      *theta;
  const int *n_in, *inj_idx;
  int M, levels, mode, ewma, T, min_p;
  float bx, by, bt, kld_err, kld_z, alpha_slow, alpha_fast, free_cell;
  Plan plan;
  // Outputs (as the entries below describe them).
  float *wstate_out, *out_p, *out_w, *out_wn, *stats;
  int *n_out, *idx;
  uint8_t* marks;
  // Scratch: cdf [M], part [kRegions, kChunks] f32; keys [M,3], owner and
  // first [T], ipart [2 blocks] i32; spill [blocks, kItemArrays, items] f32
  // (a spilled plan's item arrays).
  float *cdf, *part, *spill;
  int *keys, *owner, *first, *ipart;
};

// The chunk sums of one stage: thread q < cpb adds the D values of its
// chunk's items (val[d][q L ..], the block's items [0, nb)) in order from 0
// and writes them to regions r0 .. r0 + D - 1 at chunk b cpb + q.
template <int D>
__device__ __forceinline__ void chunk_sums(float* const* val, int nb,
                                           const Plan& p, float* part,
                                           int r0) {
  const int q = threadIdx.x;
  if (q >= p.cpb) return;
  float s[D];
#pragma unroll
  for (int d = 0; d < D; ++d) s[d] = 0.f;
  const int lo = q * p.L, hi = min(lo + p.L, nb);
  for (int k = lo; k < hi; ++k)
#pragma unroll
    for (int d = 0; d < D; ++d) s[d] += val[d][k];
  const int c = blockIdx.x * p.cpb + q;
#pragma unroll
  for (int d = 0; d < D; ++d) __stcg(part + (size_t)(r0 + d) * kChunks + c,
                                     s[d]);
}

// The halving tree over the kChunks sums of regions r0 .. r0 + D - 1
// (chunk i + h into chunk i, h = kChunks / 2, ..., 1): thread t loads chunks
// t + kThreads k; levels kChunks / 2 .. kThreads fold in registers,
// kThreads / 2 .. 32 in shared memory, 16 .. 1 by shuffles in warp 0.  Every
// thread of the block gets the D totals.  scratch: D (kThreads + 1) floats.
template <int D>
__device__ __forceinline__ void fold(const float* part, int r0,
                                     float* scratch, float total[D]) {
  const int t = threadIdx.x;
  float v[D][kPer];
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      v[d][k] = __ldcg(part + (size_t)(r0 + d) * kChunks + t + kThreads * k);
#pragma unroll
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int h = kPer / 2; h >= 1; h >>= 1)
#pragma unroll
      for (int k = 0; k < h; ++k) v[d][k] = v[d][k] + v[d][k + h];
    scratch[d * (kThreads + 1) + t] = v[d][0];
  }
  __syncthreads();
#pragma unroll
  for (int h = kThreads / 2; h >= 32; h >>= 1) {
    if (t < h) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        float* sc = scratch + d * (kThreads + 1);
        sc[t] = sc[t] + sc[t + h];
      }
    }
    __syncthreads();
  }
  if (t < 32) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float* sc = scratch + d * (kThreads + 1);
      float s = sc[t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s = s + __shfl_down_sync(0xffffffffu, s, off);
      if (t == 0) sc[kThreads] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int d = 0; d < D; ++d)
    total[d] = scratch[d * (kThreads + 1) + kThreads];
  __syncthreads();  // read by every thread before the scratch is reused
}

// The inclusive Hillis-Steele scan of the kChunks chunk totals of region r:
// at step off, x_i + (i >= off ? x_{i - off} : 0), off = 1, 2, ..., 512, in
// two buffers of buf [2 kChunks]; returns the buffer that holds the scan.
__device__ __forceinline__ float* scan_chunks(const float* part, int r,
                                              float* buf) {
  const int t = threadIdx.x;
  float* a = buf;
  float* b = buf + kChunks;
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    a[t + kThreads * k] = __ldcg(part + (size_t)r * kChunks + t +
                                 kThreads * k);
  __syncthreads();
  for (int off = 1; off < kChunks; off <<= 1) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = t + kThreads * k;
      b[i] = a[i] + (i >= off ? a[i - off] : 0.f);
    }
    __syncthreads();
    float* s = a;
    a = b;
    b = s;
  }
  return a;
}

// Integer sum and min of one value a thread over the block.
__device__ __forceinline__ int block_sum_int(int v, int* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += red[w];
    red[kWarps] = s;
  }
  __syncthreads();
  const int r = red[kWarps];
  __syncthreads();
  return r;
}

__device__ __forceinline__ int block_min_int(int v, int* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_down_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = red[0];
    for (int w = 1; w < kWarps; ++w) s = min(s, red[w]);
    red[kWarps] = s;
  }
  __syncthreads();
  const int r = red[kWarps];
  __syncthreads();
  return r;
}

// jnp.searchsorted(cdf, r) ('scan', side left): the first index with
// r <= cdf[index], as the same fixed number of halving steps, over the CDF
// in shared memory (kShared) or in device memory (read through L2).
template <bool kShared>
__device__ __forceinline__ int search(const float* cdf, int M, int levels,
                                      float r) {
  int lo = 0, hi = M;
  for (int l = 0; l < levels; ++l) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) / 2u);
    const float c = kShared ? cdf[mid] : __ldcg(cdf + mid);
    const bool left = r <= c;
    lo = left ? lo : mid;
    hi = left ? mid : hi;
  }
  return min(hi, M - 1);  // a gather clamps, as XLA's does
}

__global__ void pf_motion(const float* __restrict__ in,
                          const float* __restrict__ noise, int M,
                          ndt2d::Motion mo, float* __restrict__ out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float p[3];
  ndt2d::motion_sample(in + 3 * m, noise + 3 * m, mo, p);
  out[3 * m] = p[0];
  out[3 * m + 1] = p[1];
  out[3 * m + 2] = p[2];
}

__global__ void __launch_bounds__(kThreads) pf_chain(const Chain a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  __shared__ int red[kWarps + 1];
  const Plan& pl = a.plan;
  const int M = a.M, L = pl.L, cpb = pl.cpb;
  const int t = threadIdx.x;
  const int base = blockIdx.x * pl.items;    // the block's first item
  const int nb = max(0, min(pl.items, M - base));  // and its item count
  float* scdf = smem;  // [M] when staged
  float* after_cdf = smem + (pl.staged ? M : 0);
  // The item arrays: the block's slice of the spill scratch, or shared
  // memory (written and read only by this block, ordered by its barriers).
  float* val[kSums];
  val[0] = pl.spill ? a.spill + (size_t)blockIdx.x * kItemArrays * pl.items
                    : after_cdf;
#pragma unroll
  for (int d = 1; d < kSums; ++d) val[d] = val[d - 1] + pl.items;
  float* px = val[kSums - 1] + pl.items;
  float* py = px + pl.items;
  float* pt = py + pl.items;
  float* pw = pt + pl.items;
  int* ik = reinterpret_cast<int*>(pw + pl.items);
  float* scan =
      pl.spill ? after_cdf : reinterpret_cast<float*>(ik + pl.items);
  float* fsc = scan + 2 * kChunks;
  int* ccount = reinterpret_cast<int*>(fsc + kSums * (kThreads + 1));
  int* cbefore = ccount + cpb;

  int n = min(max(a.n_in[0], 0), M);
  float p_inject = 0.f;
  if (a.mode & (kResample | kRecovery)) {
    // The masked total (normalize_weights) and, with recovery, the sum of
    // the negated weights (the mean likelihood of the EWMAs).
    if (a.mode & kResample) {
      for (int h = blockIdx.x * kThreads + t; h < a.T;
           h += gridDim.x * kThreads) {
        a.owner[h] = -1;
        a.first[h] = INT_MAX;
      }
    }
    for (int it = t; it < nb; it += kThreads) {
      const int i = base + it;
      const float wi = a.w[i];
      val[0][it] = i < n ? wi : 0.f;
      val[1][it] = i < n ? -wi : 0.f;
    }
    __syncthreads();
    const bool rec = a.mode & kRecovery;
    if (rec)
      chunk_sums<2>(val, nb, pl, a.part, kTotal);
    else
      chunk_sums<1>(val, nb, pl, a.part, kTotal);
    grid.sync();
    float tot[2];
    if (rec) {
      fold<2>(a.part, kTotal, fsc, tot);
      float ws = a.wstate[0], wf = a.wstate[1];
      if (a.ewma) {
        const float w_avg = tot[1] / (float)max(n, 1);
        ws = ws == 0.f ? w_avg : ws + a.alpha_slow * (w_avg - ws);
        wf = wf == 0.f ? w_avg : wf + a.alpha_fast * (w_avg - wf);
      }
      if (blockIdx.x == 0 && t == 0) {
        a.wstate_out[0] = ws;
        a.wstate_out[1] = wf;
      }
      p_inject = fmaxf(0.f, 1.f - wf / fmaxf(ws, 1e-30f));
    } else {
      fold<1>(a.part, kTotal, fsc, tot);
    }
    if (!(a.mode & kResample)) return;  // the EWMAs alone

    // normalize_weights, then each chunk's running sums (the CDF's chunk
    // part, val[3]) and its total.
    const float total = tot[0];
    const float uni = 1.f / (float)max(n, 1);
    for (int it = t; it < nb; it += kThreads) {
      const int i = base + it;
      const float wi = val[0][it];
      val[2][it] = total != 0.f ? wi / total : (i < n ? uni : 0.f);
    }
    __syncthreads();
    if (t < cpb) {
      float run = 0.f;
      const int lo = t * L, hi = min(lo + L, nb);
      for (int k = lo; k < hi; ++k) {
        run += val[2][k];
        val[3][k] = run;
      }
      __stcg(a.part + (size_t)kChunkTotal * kChunks + blockIdx.x * cpb + t,
             run);
    }
    grid.sync();

    // Chunk offsets: the inclusive scan of the chunk totals, shifted by one.
    const float* incl = scan_chunks(a.part, kChunkTotal, scan);
    for (int it = t; it < nb; it += kThreads) {
      const int c = blockIdx.x * cpb + it / L;
      const float offset = c > 0 ? incl[c - 1] : 0.f;
      __stcg(a.cdf + base + it, offset + val[3][it]);
    }
    grid.sync();

    // The draw, the gather, the bin keys and the first-occurrence table.
    if (pl.staged) {
      const float4* src = reinterpret_cast<const float4*>(a.cdf);
      float4* dst = reinterpret_cast<float4*>(scdf);
      for (int k = t; k < M / 4; k += kThreads) dst[k] = __ldcg(src + k);
      for (int k = (M / 4) * 4 + t; k < M; k += kThreads)
        scdf[k] = __ldcg(a.cdf + k);
      __syncthreads();
    }
    const float top = pl.staged ? scdf[M - 1] : __ldcg(a.cdf + M - 1);
    for (int it = t; it < nb; it += kThreads) {
      const int i = base + it;
      const float r = top * (1.f - a.u[i]);
      const int j = pl.staged ? search<true>(scdf, M, a.levels, r)
                              : search<false>(a.cdf, M, a.levels, r);
      const float x = a.parts[3 * j], y = a.parts[3 * j + 1],
                  th = a.parts[3 * j + 2];
      px[it] = x;
      py[it] = y;
      pt[it] = th;
      pw[it] = a.w[j];
      a.idx[i] = j;
      const int ka = (int)truncf(x / a.bx);
      const int kb = (int)truncf(y / a.by);
      const int kc = (int)truncf(th / a.bt);
      a.keys[3 * i] = ka;
      a.keys[3 * i + 1] = kb;
      a.keys[3 * i + 2] = kc;
      __threadfence();  // the key before the claim that publishes it
      unsigned h = key_hash(ka, kb, kc) & (unsigned)(a.T - 1);
      for (;;) {
        const int o = atomicCAS(&a.owner[h], -1, i);
        bool same = o == -1;
        if (!same) {
          __threadfence();
          same = __ldcg(a.keys + 3 * o) == ka &&
                 __ldcg(a.keys + 3 * o + 1) == kb &&
                 __ldcg(a.keys + 3 * o + 2) == kc;
        }
        if (same) {
          atomicMin(&a.first[h], i);
          ik[it] = (int)h;
          break;
        }
        h = (h + 1u) & (unsigned)(a.T - 1);
      }
    }
    grid.sync();

    // First-occurrence marks and the block's count of them.
    for (int it = t; it < nb; it += kThreads) {
      const int i = base + it;
      const bool f = __ldcg(a.first + ik[it]) == i;
      a.marks[i] = f;
      ik[it] = f;
    }
    __syncthreads();
    if (t < cpb) {
      int c = 0;
      const int lo = t * L, hi = min(lo + L, nb);
      for (int k = lo; k < hi; ++k) c += ik[k];
      ccount[t] = c;
    }
    __syncthreads();
    if (t == 0) {
      int s = 0;
      for (int q = 0; q < cpb; ++q) {
        cbefore[q] = s;
        s += ccount[q];
      }
      __stcg(a.ipart + blockIdx.x, s);
    }
    grid.sync();

    // The prefix count k(m), the KLD bound and n_active: the first m with
    // m >= min_p and m >= Mx(k(m)), else M.
    int before = 0;
    for (int q = t; q < (int)blockIdx.x; q += kThreads)
      before += __ldcg(a.ipart + q);
    before = block_sum_int(before, red);
    if (t < cpb) {
      int k = before + cbefore[t];
      const int lo = t * L, hi = min(lo + L, nb);
      for (int q = lo; q < hi; ++q) {
        k += ik[q];
        ik[q] = k;
      }
    }
    __syncthreads();
    int done_at = M;
    for (int it = t; it < nb; it += kThreads) {
      const int k = ik[it];
      const float kf = (float)k;
      const float ka = (kf - 1.f) / (2.f * a.kld_err);
      const float kb = 2.f / (9.f * fmaxf(kf - 1.f, 1.f));
      const float kc = 1.f - kb + sqrtf(kb) * a.kld_z;
      int mx = (int)floorf(ka * kc * kc * kc);
      mx = k > 1 ? mx : M;
      const int m = base + it + 1;
      if (m >= a.min_p && m >= mx) done_at = min(done_at, m);
    }
    done_at = block_min_int(done_at, red);
    if (t == 0) __stcg(a.ipart + gridDim.x + blockIdx.x, done_at);
    grid.sync();
    int nm = M;
    for (int q = t; q < (int)gridDim.x; q += kThreads)
      nm = min(nm, __ldcg(a.ipart + gridDim.x + q));
    n = block_min_int(nm, red);
  } else {
    // The statistics entry: the particles and weights as given.
    for (int it = t; it < nb; it += kThreads) {
      const int i = base + it;
      px[it] = a.parts[3 * i];
      py[it] = a.parts[3 * i + 1];
      pt[it] = a.parts[3 * i + 2];
      pw[it] = a.w[i];
    }
    if (a.mode & kInject) p_inject = a.scal[0];
  }

  // inject_free_space: injected particles take the active mean weight.
  if (a.mode & kInject) {
    for (int it = t; it < nb; it += kThreads)
      val[0][it] = base + it < n ? pw[it] : 0.f;
    __syncthreads();
    chunk_sums<1>(val, nb, pl, a.part, kNeutral);
    grid.sync();
    float wsum[1];
    fold<1>(a.part, kNeutral, fsc, wsum);
    const float neutral = wsum[0] / (float)max(n, 1);
    for (int it = t; it < nb; it += kThreads) {
      const int i = base + it;
      if (a.u_sel[i] < p_inject && i < n) {
        const int f = a.inj_idx[i];
        px[it] = a.free_xy[2 * f] + a.jitter[2 * i] * a.free_cell;
        py[it] = a.free_xy[2 * f + 1] + a.jitter[2 * i + 1] * a.free_cell;
        pt[it] = a.theta[i];
        pw[it] = neutral;
      }
    }
  }

  // update_statistics over the first n particles.
  for (int it = t; it < nb; it += kThreads) {
    const int i = base + it;
    a.out_p[3 * i] = px[it];
    a.out_p[3 * i + 1] = py[it];
    a.out_p[3 * i + 2] = pt[it];
    a.out_w[i] = pw[it];
    val[0][it] = i < n ? pw[it] : 0.f;
  }
  __syncthreads();
  chunk_sums<1>(val, nb, pl, a.part, kStatTotal);
  grid.sync();
  float tot[1];
  fold<1>(a.part, kStatTotal, fsc, tot);
  const float total = tot[0];
  const float uni = 1.f / (float)max(n, 1);
  for (int it = t; it < nb; it += kThreads) {
    const int i = base + it;
    const float wi = i < n ? pw[it] : 0.f;
    const float p = total != 0.f ? wi / total : (i < n ? uni : 0.f);
    a.out_wn[i] = p;
    pw[it] = p;
    const float x = px[it], y = py[it], th = pt[it];
    const float ppx = p * x, ppy = p * y;
    val[0][it] = ppx;
    val[1][it] = ppy;
    val[2][it] = p * cosf(th);
    val[3][it] = p * sinf(th);
    val[4][it] = ppx * x;
    val[5][it] = ppx * y;
    val[6][it] = ppy * y;
  }
  __syncthreads();
  chunk_sums<kSums>(val, nb, pl, a.part, kMoments);
  grid.sync();
  float s[kSums];
  fold<kSums>(a.part, kMoments, fsc, s);
  const float mx = s[0], my = s[1], r00 = s[4], r01 = s[5], r11 = s[6];
  const float mth = atan2f(s[3], s[2]);
  for (int it = t; it < nb; it += kThreads) {
    const float d = normalize_angle(mth - pt[it]);
    val[0][it] = pw[it] * d * d;
  }
  __syncthreads();
  chunk_sums<1>(val, nb, pl, a.part, kSpread);
  grid.sync();
  float cth[1];
  fold<1>(a.part, kSpread, fsc, cth);
  if (blockIdx.x == 0 && t == 0) {
    a.n_out[0] = n;
    float* st = a.stats;
    st[0] = (float)n;
    st[1] = mx;
    st[2] = my;
    st[3] = mth;
    st[4] = r00 - mx * mx;
    st[5] = r01 - mx * my;
    st[6] = 0.f;
    st[7] = r01 - my * mx;
    st[8] = r11 - my * my;
    st[9] = 0.f;
    st[10] = 0.f;
    st[11] = 0.f;
    st[12] = cth[0];
  }
}

// A refusal's error, with the runtime's last error cleared, so that no
// later launch's check reports it again.
int refused(cudaError_t err) {
  cudaGetLastError();
  return (int)err;
}

// pf_chain's limit of dynamic shared memory raised to at least `smem` bytes
// on the current device (asked once a device and larger size).
cudaError_t allow_smem(size_t smem) {
  static int last_dev = -1;
  static size_t allowed = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev == last_dev && smem <= allowed)) return err;
  err = cudaFuncSetAttribute(pf_chain,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) {
    last_dev = dev;
    allowed = smem;
  }
  return err;
}

// One cooperative launch of pf_chain by its plan; fails (no launch) where
// the plan is not one of particle_filter.py::plan's, the card refuses the
// shared memory or cannot hold the blocks co-resident (the runtime's
// cudaErrorCooperativeLaunchTooLarge).
int launch_chain(const Chain& a, cudaStream_t st) {
  const Plan& p = a.plan;
  if (a.M < 1 || p.L < 1 || p.cpb < 1 || p.blocks * p.cpb != kChunks ||
      p.items != p.cpb * p.L || (size_t)p.L * kChunks < (size_t)a.M ||
      p.items > 1 << 20 || (p.spill && a.spill == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p, a.M);
  cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return refused(err);
  void* args[] = {const_cast<Chain*>(&a)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(pf_chain),
                                    p.blocks, kThreads, args, smem, st);
  return err == cudaSuccess ? 0 : refused(err);
}

Chain chain_of(int M, int mode, void* spill, int L, int cpb, int blocks,
               int items, int staged, int spilled) {
  Chain a{};
  a.M = M;
  a.mode = mode;
  a.spill = static_cast<float*>(spill);
  a.plan = Plan{L, cpb, blocks, items, staged, spilled};
  return a;
}

}  // namespace

#define NDT2D_CHAIN_PLAN_ARGS                                             \
  void *spill, int L, int cpb, int blocks, int items, int staged, int spilled
#define NDT2D_CHAIN_PLAN spill, L, cpb, blocks, items, staged, spilled

// The blocks of pf_chain the current device holds co-resident at `smem`
// bytes of dynamic shared memory a block, into blocks [1] i32 (0 on an
// error, which is returned; no cooperative launch: cudaErrorNotSupported).
NDT2D_API int ndt2d_pf_chain_fit(int smem, int* blocks) {
  *blocks = 0;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = allow_smem(smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pf_chain,
                                                        kThreads, smem);
  if (err != cudaSuccess) return refused(err);
  if (!coop) return (int)cudaErrorNotSupported;
  *blocks = per_sm * sms;
  return 0;
}

// particles [M,3] f32, noise [M,3] f32 -> out [M,3] f32.
NDT2D_API int ndt2d_pf_motion(const void* particles, const void* noise, int M,
                              float rot1, float trans, float rot2,
                              float s_rot1, float s_trans, float s_rot2,
                              void* out, void* stream) {
  pf_motion<<<(M + kThreads - 1) / kThreads, kThreads, 0,
              reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(particles), static_cast<const float*>(noise),
      M, ndt2d::Motion{rot1, trans, rot2, s_rot1, s_trans, s_rot2},
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// The resample chain: weights [M] f32 (raw), n_in [1] i32 (active mask),
// uniforms [M] f32, particles [M,3] f32.  Recovery (recovery != 0): wstate
// [2] f32 (w_slow, w_fast) goes to wstate_out [2], updated from the weights
// first when ewma != 0; injection draws u_sel [M] f32, inj_idx [M] i32,
// jitter [M,2] f32, theta [M] f32 over free_xy [F,2] f32.  Scratch: cdf [M]
// f32, part [13, 1024] f32, keys [M,3] i32, owner and first [T] i32 (T a
// power of two >= 2M), ipart [2 blocks] i32, spill [blocks * 12 * items]
// f32 (or null where the plan keeps its items in shared memory).  Outputs:
// idx [M] i32, marks [M] u8, out_p [M,3], out_w [M] (raw), out_wn [M]
// (normalized), n_out [1] i32, stats [13] f32.  The plan (L, cpb, blocks,
// items, staged, spilled) is particle_filter.py::plan(M).
NDT2D_API int ndt2d_pf_resample(
    const void* weights, const void* n_in, const void* uniforms,
    const void* particles, int M, int levels, float bx, float by, float bt,
    float kld_err, float kld_z, int min_p, int recovery, int ewma,
    float alpha_slow, float alpha_fast, const void* wstate, void* wstate_out,
    const void* free_xy, float free_cell, const void* u_sel,
    const void* inj_idx, const void* jitter, const void* theta, void* cdf,
    void* part, void* keys, void* owner, void* first, int T, void* ipart,
    void* idx, void* marks, void* out_p, void* out_w, void* out_wn,
    void* n_out, void* stats, NDT2D_CHAIN_PLAN_ARGS, void* stream) {
  if (T < 2 * M || (T & (T - 1)) != 0) return (int)cudaErrorInvalidValue;
  Chain a = chain_of(M, kResample | (recovery ? kRecovery | kInject : 0),
                     NDT2D_CHAIN_PLAN);
  a.w = static_cast<const float*>(weights);
  a.n_in = static_cast<const int*>(n_in);
  a.u = static_cast<const float*>(uniforms);
  a.parts = static_cast<const float*>(particles);
  a.levels = levels;
  a.bx = bx;
  a.by = by;
  a.bt = bt;
  a.kld_err = kld_err;
  a.kld_z = kld_z;
  a.min_p = min_p;
  a.ewma = ewma;
  a.alpha_slow = alpha_slow;
  a.alpha_fast = alpha_fast;
  a.wstate = static_cast<const float*>(wstate);
  a.wstate_out = static_cast<float*>(wstate_out);
  a.free_xy = static_cast<const float*>(free_xy);
  a.free_cell = free_cell;
  a.u_sel = static_cast<const float*>(u_sel);
  a.inj_idx = static_cast<const int*>(inj_idx);
  a.jitter = static_cast<const float*>(jitter);
  a.theta = static_cast<const float*>(theta);
  a.cdf = static_cast<float*>(cdf);
  a.part = static_cast<float*>(part);
  a.keys = static_cast<int*>(keys);
  a.owner = static_cast<int*>(owner);
  a.first = static_cast<int*>(first);
  a.T = T;
  a.ipart = static_cast<int*>(ipart);
  a.idx = static_cast<int*>(idx);
  a.marks = static_cast<uint8_t*>(marks);
  a.out_p = static_cast<float*>(out_p);
  a.out_w = static_cast<float*>(out_w);
  a.out_wn = static_cast<float*>(out_wn);
  a.n_out = static_cast<int*>(n_out);
  a.stats = static_cast<float*>(stats);
  return launch_chain(a, reinterpret_cast<cudaStream_t>(stream));
}

// The w_slow/w_fast EWMAs alone (ParticleFilter.measure): the resample's
// sum of the negated raw weights [M] f32 over the first n_in [1] i32, wstate
// [2] f32 -> wstate_out [2] f32.  Scratch part [13, 1024] f32; spill and
// the plan as ndt2d_pf_resample's.
NDT2D_API int ndt2d_pf_ewma(const void* weights, const void* n_in, int M,
                            float alpha_slow, float alpha_fast,
                            const void* wstate, void* wstate_out, void* part,
                            NDT2D_CHAIN_PLAN_ARGS, void* stream) {
  Chain a = chain_of(M, kRecovery, NDT2D_CHAIN_PLAN);
  a.w = static_cast<const float*>(weights);
  a.n_in = static_cast<const int*>(n_in);
  a.ewma = 1;
  a.alpha_slow = alpha_slow;
  a.alpha_fast = alpha_fast;
  a.wstate = static_cast<const float*>(wstate);
  a.wstate_out = static_cast<float*>(wstate_out);
  a.part = static_cast<float*>(part);
  return launch_chain(a, reinterpret_cast<cudaStream_t>(stream));
}

// update_statistics (inject == 0) or inject_free_space + update_statistics
// (inject != 0, p_inject in scal [1] f32) over the first n_in [1] i32 of
// particles [M,3] f32 with raw weights [M] f32.  Scratch part [13, 1024]
// f32; spill, outputs and plan as ndt2d_pf_resample's.
NDT2D_API int ndt2d_pf_statistics(
    const void* particles, const void* weights, const void* n_in, int M,
    int inject, const void* scal, const void* free_xy, float free_cell,
    const void* u_sel, const void* inj_idx, const void* jitter,
    const void* theta, void* part, void* out_p, void* out_w, void* out_wn,
    void* n_out, void* stats, NDT2D_CHAIN_PLAN_ARGS, void* stream) {
  Chain a = chain_of(M, inject ? kInject : 0, NDT2D_CHAIN_PLAN);
  a.parts = static_cast<const float*>(particles);
  a.w = static_cast<const float*>(weights);
  a.n_in = static_cast<const int*>(n_in);
  a.scal = static_cast<const float*>(scal);
  a.free_xy = static_cast<const float*>(free_xy);
  a.free_cell = free_cell;
  a.u_sel = static_cast<const float*>(u_sel);
  a.inj_idx = static_cast<const int*>(inj_idx);
  a.jitter = static_cast<const float*>(jitter);
  a.theta = static_cast<const float*>(theta);
  a.part = static_cast<float*>(part);
  a.out_p = static_cast<float*>(out_p);
  a.out_w = static_cast<float*>(out_w);
  a.out_wn = static_cast<float*>(out_wn);
  a.n_out = static_cast<int*>(n_out);
  a.stats = static_cast<float*>(stats);
  return launch_chain(a, reinterpret_cast<cudaStream_t>(stream));
}
