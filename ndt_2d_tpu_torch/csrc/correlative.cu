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
// bound by its A * L * L * B (candidate, beam) terms, each (with the
// per-angle tables and windows below) three shared loads and an add, and
// by forming the tables; the point score is launch latency at M = 1.
//
// Designs.  Field: hit counts by integer atomics (exact in any order), the
// blur one thread per cell adding its 7 taps in index order from 0 (the
// taps computed once by torch and handed in), the maximum (order-free),
// the division by it last; the twin does each step in the same order.  At
// 128-192 cells a side the plane is ~100-300 kB and the work a few
// microseconds, so a build is bound by its launch chain, not by bytes:
// where the stripes fit (kernels/correlative.py::field_plan) it is one
// launch of a thread-block cluster (field_cluster).  CTA k of n keeps its
// stripe of h rows, with the 3 rows above and below, of the int hit plane
// and of the x-blurred float plane in its shared memory; every CTA forms
// the origin and transforms every window point, counting those of its
// rows (no atomic crosses a CTA, no plane is zeroed in device memory);
// it blurs along x and y from its own rows, takes its stripe's maximum
// and hands it to every CTA through DSMEM before one cluster barrier, then
// writes its rows of field / peak once.  Each float operation is the
// seven-step form's on the same operands in the same order, so both forms
// are bitwise the twin.  Grids whose stripes do not fit 16 CTAs keep the
// seven-step form (a memset and six launches through device memory),
// chosen by the plan from the shape.  Point score: K3's, one warp per
// pose, lane l adding beams l, l + 32, ... from 0, then a __shfl_down_sync
// tree (16, 8, 4, 2, 1) (warp_point_score).  The mapper scores the scan at
// the lattice's centre before every match, so the lattice launch takes it
// too: given unc, each row's grid has one block more (blockIdx.x = A
// groups), whose warp 0 runs warp_point_score at the row's pose and
// leaves.  It takes no ticket and no block waits for it, so the fold's
// tail is the same; its bits are point_scores'.
//
// Lattice (lattice_tables, entry ndt2d_correlative_match_planned).  A term
// (candidate, beam) needs the cell column ix = floor((rx_b + dx - ox) /
// cell) and the row iy = floor((ry_b + dy - oy) / cell); ix depends only on
// (angle, beam, dx) and iy only on (angle, beam, dy), so a block computes
// them once for a chunk of beams into two tables in shared memory (the
// columns of the dx its offsets span, the rows of every dy; the parent
// form, lattice_tiles, paid two IEEE divisions, two floors and a bounds
// test a term: 25.6 M divisions at the box drive's 80 x 40 x 40 x 100,
// against ~0.8 M in the tables).  The offsets' step is a fraction of a
// cell, so a beam's candidates reach a few cells: each beam's window of
// them is copied from the field into shared memory beside the tables, and
// the tables hold offsets into it, so that a term is three shared loads
// and an add, no gather from L2.  A block owns a run of tiles of kTile flat
// offsets of one (angle, row), a candidate of each a thread, each
// candidate's beams added in order from +0: the parent's float additions,
// so the scores and each tile's partial (reduce_tiles, in flat order) are
// bitwise the parent's and the twin's.  The row's last block to take its
// ticket, after a fence, folds the row's partials (finalize_row, read
// through L2, each of the ten sums a lane's chain and the (min, index) a
// warp's) and resets the ticket: one launch a match and one a batch of
// rows.  The block's shape (kernels/correlative.py::lattice_plan: one
// wave of blocks of up to 1024 threads where the lattice allows it)
// changes which block forms a partial, never its bits.  The host packs a
// launch's constants once a shape (kernels/correlative.py::LatticeLauncher)
// and passes the block's address: one ctypes call of two arguments.
#include <cooperative_groups.h>

#include <algorithm>

#include "lattice.cuh"

namespace {

using lattice::kTile;
constexpr int kThreads = 256;
constexpr int kBeamChunk = 128;
constexpr int kTaps = 7;  // radius 3
constexpr int kHalo = kTaps / 2;
constexpr int kPeakThreads = 1024;
constexpr int kWarpsPerBlock = 8;
constexpr int kFieldThreads = 1024;  // the cluster form's CTA, at most
constexpr int kMaxCluster = 16;      // Hopper's non-portable cluster limit
constexpr float kFloatMax = 3.402823466e+38f;

// One field build (kernels/correlative.py::_FieldLaunch, field for field):
// the tensors' pointers (the seven-step form's scratch hits, tmp and peak;
// null in the cluster form), the shape, and the plan: n CTAs of `threads`
// a cluster, h rows a stripe, `smem` dynamic bytes a CTA; n = 0 is the
// seven-step form.
struct FieldLaunch {
  const float* poses;     // [S, 3]
  const float* points;    // [S, P, 2]
  const uint8_t* pmask;   // [S, P]
  const uint8_t* wmask;   // [S]
  const float* taps;      // [7]
  float* origin;          // [2]
  float* field;           // [H, W]
  int* hits;              // [H * W] scratch (seven-step form)
  float* tmp;             // [H * W] scratch (seven-step form)
  float* peak;            // [1] scratch (seven-step form)
  int S, P, W, H;
  int n, h, threads, smem;
  float range_max, cell;
};

// u / d and u % d for u d < 2^32 by a multiply-high with m = ceil(2^32 /
// d) (exact there: the error u / 2^32 stays below 1 / d).
__device__ __forceinline__ unsigned magic(unsigned d) {
  return 0xffffffffu / d + 1u;
}
__device__ __forceinline__ int quot(int u, unsigned m) {
  return (int)__umulhi((unsigned)u, m);
}

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

// The whole build in one cluster of l.n CTAs (the grid is the cluster):
// CTA k owns rows [k h, k h + rows) of the plane.  Each CTA transforms
// every window point and counts those of its rows and of the kHalo rows
// above and below them (its window of rows + 2 kHalo rows; rows off the
// plane stay 0, as the blur's zero edge), so that it blurs along x and y
// from its own shared memory: the only exchange between CTAs is the
// maximum: the bits of the (nonnegative) blurred values compare as
// unsigned ints, and each CTA's maximum is stored through DSMEM into a
// slot of every CTA of the cluster before the one cluster barrier (after
// a wait on a barrier every CTA arrives at on entry, so that every target
// has started).  Dynamic shared memory: each window scan's (x, y, cos,
// sin) and flag, the int hit window [h + 2 kHalo, W] (reused for the
// y-blurred stripe as float), then the x-blurred window [h + 2 kHalo, W].  Every global load of a phase is
// issued before its first use (the scans' poses a thread a scan, a
// thread's first kBatch points); a point's row is found by a
// multiplication first, and field_hits' divisions run only for the points
// within a row of the window; a blur item is kRun consecutive cells of a
// row (x) or of a column (y), its 6 + kRun inputs loaded once.
constexpr int kBatch = 8;
constexpr int kRun = 4;

__global__ void __launch_bounds__(kFieldThreads) field_cluster(FieldLaunch l) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float taps_s[kTaps];
  __shared__ unsigned warp_max[kFieldThreads / 32];
  __shared__ unsigned maxima[kMaxCluster];
  const int W = l.W, H = l.H, P = l.P, S = l.S;
  const int k = (int)cluster.block_rank();
  const int row0 = k * l.h;
  const int rows = max(0, min(l.h, H - row0));
  const int win = rows + 2 * kHalo;  // the window's rows, from row0 - kHalo
  const int win_max = l.h + 2 * kHalo;
  const int t = threadIdx.x, nt = blockDim.x, lane = t & 31;
  float4* scan = reinterpret_cast<float4*>(smem);
  int* live = reinterpret_cast<int*>(scan + S);  // S ints, padded to 4
  int* hits = live + (S + 3) / 4 * 4;
  float* yblur = reinterpret_cast<float*>(hits);
  float* xblur = reinterpret_cast<float*>(hits + (size_t)win_max * W);
  // Arrive at a cluster barrier now and wait on it just before the DSMEM
  // store below: a CTA's shared memory may be written by another only once
  // that CTA has started, which the barrier shows.  Relaxed: it orders no
  // memory, and every CTA has long arrived by the wait.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // Stage the taps and each scan's pose with cosf / sinf of its heading
  // (field_hits' values), zero the hit window and load this thread's
  // first points (point i = t + j nt, of scan i / P).
  if (t < kTaps) taps_s[t] = l.taps[t];
  for (int s = t; s < S; s += nt) {
    const float th = l.poses[3 * s + 2];
    scan[s] = make_float4(l.poses[3 * s], l.poses[3 * s + 1], cosf(th),
                          sinf(th));
    live[s] = l.wmask[s];
  }
  for (int i = t; i < win * W; i += nt) hits[i] = 0;
  const float2* pts = reinterpret_cast<const float2*>(l.points);
  const int total = S * P;
  float2 p[kBatch];
  bool ok[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int i = t + j * nt;
    ok[j] = i < total && l.pmask[i];
    p[j] = i < total ? pts[i] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  float tp[kTaps];
#pragma unroll
  for (int q = 0; q < kTaps; ++q) tp[q] = taps_s[q];

  // The origin, as field_origin forms it: each warp's lanes take the
  // minimum of every 32nd live pose, then a shuffle tree.  A minimum is
  // the same value in any order but for the sign of a zero, so a zero
  // minimum is folded again in scan order.  CTA 0 writes it.
  float mx = kFloatMax, my = kFloatMax;
  for (int s = lane; s < S; s += 32)
    if (live[s]) {
      mx = fminf(mx, scan[s].x);
      my = fminf(my, scan[s].y);
    }
  for (int off = 16; off > 0; off >>= 1) {
    mx = fminf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    my = fminf(my, __shfl_xor_sync(0xffffffffu, my, off));
  }
  if (mx == 0.f || my == 0.f) {
    mx = my = kFloatMax;
    for (int s = 0; s < S; ++s)
      if (live[s]) {
        mx = fminf(mx, scan[s].x);
        my = fminf(my, scan[s].y);
      }
  }
  const float ox = mx - l.range_max, oy = my - l.range_max;
  if (k == 0 && t == 0) {
    l.origin[0] = ox;
    l.origin[1] = oy;
  }

  // Hits: field_hits' expressions, counted by shared-memory integer
  // atomics (exact in any order) where the row lies in the window.  The
  // product by 1 / cell is within a row of the quotient, so a point whose
  // product lies more than a row outside the window is not in it; where
  // the cell is a power of 2 its reciprocal is exact and the product is
  // the quotient, bit for bit (then no division runs).
  const int lo = max(row0 - kHalo, 0), hi = min(row0 + rows + kHalo, H);
  const float inv = 1.f / l.cell;
  int e2;
  const bool pow2 = frexpf(l.cell, &e2) == 0.5f;
  const float flo = (float)(lo - 1), fhi = (float)(hi + 1);
  const int ds = nt / P, dr = nt - ds * P;
  int s = t / P, r = t - s * P;
  for (int b = t; b < total; b += kBatch * nt) {
    if (b != t) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = b + j * nt;
        ok[j] = i < total && l.pmask[i];
        p[j] = i < total ? pts[i] : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (b + j * nt >= total) break;
      const int sj = s;
      s += ds;
      r += dr;
      if (r >= P) {
        r -= P;
        ++s;
      }
      const int sc = ok[j] ? sj : 0;  // a masked or missing point: scan 0
      const float4 q = scan[sc];
      const float wy = (q.w * p[j].x + q.z * p[j].y) + q.y;
      const float fy = (wy - oy) * inv;
      if (!(ok[j] && live[sc] && fy >= flo && fy < fhi)) continue;
      const int iy = (int)floorf(pow2 ? fy : (wy - oy) / l.cell);
      if (iy < lo || iy >= hi) continue;
      const float wx = (q.z * p[j].x - q.w * p[j].y) + q.x;
      const int ix =
          (int)floorf(pow2 ? (wx - ox) * inv : (wx - ox) / l.cell);
      if (ix < 0 || ix >= W) continue;
      atomicAdd(&hits[(iy - row0 + kHalo) * W + ix], 1);
    }
  }
  __syncthreads();

  // Blur along x (field_blur<int>) over the window: kRun cells of a row a
  // thread, each its 7 taps in index order from 0, 0 past the row's ends.
  // A count is below 2^23 (the launcher keeps S P there), so 2^23 + n as a
  // float's bits, less 2^23, is (float)n without the quarter-rate
  // conversion.
  const auto count = [](int n) {
    return __int_as_float(0x4B000000 + n) - 8388608.f;
  };
  const int xruns = (W + kRun - 1) / kRun;
  const unsigned mx_runs = magic(xruns), m_w = magic(W);
  for (int it = t; it < win * xruns; it += nt) {
    const int y = quot(it, mx_runs), x0 = (it - y * xruns) * kRun;
    const int* row = hits + y * W;
    float v[kRun + 2 * kHalo];
    if (W % kRun == 0) {
      // Rows start 16-byte aligned: three int4 loads cover x0 - 4 ..
      // x0 + 7 (zero past the row's ends), one float4 store.
      const int4* r4 = reinterpret_cast<const int4*>(row) + x0 / kRun;
      const int4 zero = make_int4(0, 0, 0, 0);
      const int4 a = x0 > 0 ? r4[-1] : zero, b = r4[0];
      const int4 c = x0 + kRun < W ? r4[1] : zero;
      const int n[kRun + 2 * kHalo] = {a.y, a.z, a.w, b.x, b.y,
                                       b.z, b.w, c.x, c.y, c.z};
#pragma unroll
      for (int q = 0; q < kRun + 2 * kHalo; ++q) v[q] = count(n[q]);
    } else {
#pragma unroll
      for (int q = 0; q < kRun + 2 * kHalo; ++q) {
        const int x = x0 + q - kHalo;
        v[q] = (x >= 0 && x < W) ? count(row[x]) : 0.f;
      }
    }
    float o[kRun];
#pragma unroll
    for (int c = 0; c < kRun; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kTaps; ++q) acc = acc + tp[q] * v[c + q];
      o[c] = acc;
    }
    if (W % kRun == 0) {
      *reinterpret_cast<float4*>(xblur + y * W + x0) =
          make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int c = 0; c < kRun; ++c)
        if (x0 + c < W) xblur[y * W + x0 + c] = o[c];
    }
  }
  __syncthreads();

  // Blur along y (field_blur<float>): kRun rows of a column a thread, from
  // the window's rows (0 off the plane), into the hit window's storage;
  // the stripe's maximum into the CTA's word.
  const int yruns = (rows + kRun - 1) / kRun;
  float m = 0.f;
  for (int it = t; it < yruns * W; it += nt) {
    const int j = quot(it, m_w), x = it - j * W, y0 = j * kRun;
    float v[kRun + 2 * kHalo];
#pragma unroll
    for (int q = 0; q < kRun + 2 * kHalo; ++q)
      v[q] = y0 + q < win ? xblur[(y0 + q) * W + x] : 0.f;
#pragma unroll
    for (int c = 0; c < kRun; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kTaps; ++q) acc = acc + tp[q] * v[c + q];
      if (y0 + c < rows) {
        yblur[(y0 + c) * W + x] = acc;
        m = fmaxf(m, acc);
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off));
  if (lane == 0) warp_max[t >> 5] = __float_as_uint(m);
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // Warp 0 takes the warps' maxima (a shuffle tree, order-free), and lane
  // c stores the stripe's maximum into CTA c's slot k through DSMEM; after
  // the barrier every CTA holds the n maxima.
  if (t < 32) {
    unsigned b = lane < nt / 32 ? warp_max[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1)
      b = max(b, __shfl_xor_sync(0xffffffffu, b, off));
    if (lane < l.n) cluster.map_shared_rank(maxima, lane)[k] = b;
  }
  cluster.sync();

  // The peak: the maximum of the n slots (order-free), floored at 1e-6;
  // then each thread's cells of field / peak (a zero cell is itself: 0 /
  // peak), written once.
  unsigned bits = 0u;
  for (int c = 0; c < l.n; ++c) bits = max(bits, maxima[c]);
  const float pk = fmaxf(__uint_as_float(bits), 1e-6f);
  float* out = l.field + (size_t)row0 * W;
  for (int it = t; it < yruns * W; it += nt) {
    const int j = quot(it, m_w), x = it - j * W, y0 = j * kRun;
#pragma unroll
    for (int c = 0; c < kRun; ++c)
      if (y0 + c < rows) {
        const float v = yblur[(y0 + c) * W + x];
        out[(y0 + c) * W + x] = v == 0.f ? v : v / pk;
      }
  }
}

// The cluster launch's configuration (one cluster of l.n CTAs).
void field_config(const FieldLaunch& l, cudaStream_t st,
                  cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(l.n);
  cfg->blockDim = dim3(l.threads);
  cfg->dynamicSmemBytes = (size_t)l.smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = l.n;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The tables' sentinel: a column or row offset off the grid (or an unused
// beam's column).  A term's cell is the sum of its two entries, negative
// exactly where either is a sentinel (W H <= 2^30, checked by the entry).
constexpr int kOff = -(1 << 30);

// The lattice launch's arguments (kernels/correlative.py::_LatticeTables,
// field for field).
struct LatticeTables {
  const float* field;   // [R, H*W]
  const float* origin;  // [R, 2]
  float cell;
  int W, H;
  const float* points;   // [R, P, 2]
  const uint8_t* pmask;  // [R, P]
  int P;
  const int* nums;  // [R] or null (every row has `num` points)
  int num, max_beams;
  const float* pose;  // [R, 3]
  const float *dths, *dls;
  int A, L;
  int tiles;   // tiles of kTile flat offsets an angle
  int groups;  // blocks an angle: ceil(tiles / (kG kPer))
  int nx;      // the column table's rows (the most dx a block spans)
  int cx, cy;  // a beam's field window: cx columns, cy rows of cells
  int chunk;   // beams a table chunk, a multiple of 4
  int stride;  // the tables' and windows' row stride, 4 mod 32, >= chunk
  int stage;   // partials the fold stages at a time
  float* partial;    // [R, A * tiles, kPartial]
  float* scores;     // [R, A, L, L] or null
  float* out;        // [R, 13]
  float* unc;        // [R] point scores at the rows' poses, or null
  unsigned* ticket;  // [R], 0 before the launch; the folding block resets
};

// Minus the mean field value under the used beams at (px0, py0, th), by
// the calling warp: lane l adds slots l, l + 32, ... from 0, then the
// shuffle tree (16, 8, 4, 2, 1); lane 0's result is the score (every
// lane's on return).  point_scores' body and the lattice's fused score.
__device__ __forceinline__ float warp_point_score(
    const float* __restrict__ field, float ox, float oy, float cell, int W,
    int H, const float* __restrict__ points,
    const uint8_t* __restrict__ pmask, int P, int num_points, int max_beams,
    float px0, float py0, float th) {
  const int lane = threadIdx.x & 31;
  const ndt2d::Subsample sub(num_points, max_beams);
  const float c = cosf(th), s = sinf(th);
  const int slots = ((max_beams + 31) / 32) * 32;
  float acc = 0.f;
  for (int i = lane; i < slots; i += 32) {
    float v = 0.f;
    if (i < max_beams) {
      const int idx = sub.index(i, num_points, P);
      const float x = points[2 * idx], y = points[2 * idx + 1];
      const float wx = c * x - s * y + px0;
      const float wy = s * x + c * y + py0;
      const int ix = (int)floorf((wx - ox) / cell);
      const int iy = (int)floorf((wy - oy) / cell);
      const bool ok = i < sub.used && pmask[idx] && ix >= 0 && iy >= 0 &&
                      ix < W && iy < H;
      v = ok ? field[iy * W + ix] : 0.f;
    }
    acc += v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  return -acc / (float)max(sub.used, 1);
}

// Words of shared memory a beam of a chunk takes beside its tables and
// window: its rotated x and y, used flag, window corner (x, y) and whether
// its cells fit the window.
constexpr int kBeamWords = 6;


// Grid (A * groups, R), blocks of kG kTile threads: block (a * groups + j,
// r) scores the kG kPer tiles from j kG kPer of angle a of row r, thread t
// of group g a candidate of tiles j kG kPer + p kG + g, p < kPer.  With
// unc, block (A * groups, r) is the row's point score (warp 0).
// Dynamic shared memory: max(kBeamWords chunk + (nx + L + (cx + 1) (cy +
// 1)) S, 12 stage + 12) 4-byte words, S = stride: a chunk's beams, its
// column table [nx, S], its row table [L, S] and the beams' field windows
// [(cx + 1) (cy + 1), S], beam j at column j of each (S = 4 mod 32, so
// that the eight lanes of a 16-byte load's phase, on consecutive rows, and
// lanes writing consecutive beams meet no bank conflict), then the fold's
// staging.
//
// A chunk is three passes.  (1) A thread a beam rotates it and finds the
// cells its entries can reach (from its first and last offsets: below)
// and whether they fit cx x cy.  (2) The tables and windows, a lane a beam
// and a warp a row of a table (or a cell of the windows): each entry an
// offset into its beam's window (a sentinel into a zero column cx or zero
// row cy) where the beam fits, else a field offset (iy W, kOff); each
// fitting beam's cells copied from the field.  The chunk is padded to a
// multiple of 4 beams with empty windows.  (3) The terms: where every beam
// of the chunk fits, four beams a step, a thread's column and row entries
// of the four as one 16-byte load each, then win[x + y] four times and
// four adds; else a beam that does not fit gathers from the field as the
// parent did.  Either way a term adds the field value of its cell, or +0,
// in beam order (a padded beam's +0 last changes no bit: the sum starts at
// +0 and never holds -0).
template <int kG, int kPer>
__global__ void __launch_bounds__(kG* kTile) lattice_tables(
    const LatticeTables a) {
  extern __shared__ __align__(16) int tab[];
  __shared__ bool last;
  constexpr int kThreads = kG * kTile, kWarps = kThreads / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = threadIdx.x / kTile, tid = threadIdx.x % kTile;
  const int ang = blockIdx.x / a.groups, grp = blockIdx.x % a.groups;
  const size_t r = blockIdx.y;
  const int L = a.L, LL = L * L, W = a.W, H = a.H;
  const int num_points = a.nums != nullptr ? a.nums[r] : a.num;
  const float* field = a.field + r * W * H;
  const float* points = a.points + r * a.P * 2;
  const uint8_t* pmask = a.pmask + r * a.P;
  const float* pose = a.pose + r * 3;
  const float ox = a.origin[2 * r], oy = a.origin[2 * r + 1];
  // The row's point score: warp 0 of a block of its own after the row's
  // last, which takes no ticket and waits at no barrier, so that the fold's
  // tail does not wait for it.
  if (blockIdx.x == a.A * a.groups) {
    if (warp == 0) {
      const float u = warp_point_score(field, ox, oy, a.cell, W, H, points,
                                       pmask, a.P, num_points, a.max_beams,
                                       pose[0], pose[1], pose[2]);
      if (lane == 0) a.unc[r] = u;
    }
    return;
  }
  const int tile0 = grp * kG * kPer;
  const int f0 = tile0 * kTile;
  const int f1 = min((tile0 + kG * kPer) * kTile, LL);
  const int lx0 = f0 / L, nxb = (f1 - 1) / L - lx0 + 1;
  const int cx = a.cx, cy = a.cy, cw = cx + 1, win_words = cw * (cy + 1);
  const int chunk = a.chunk, S = a.stride;
  float* bx = reinterpret_cast<float*>(tab);
  float* by = bx + chunk;
  int* bused = tab + 2 * chunk;
  int* blox = tab + 3 * chunk;
  int* bloy = tab + 4 * chunk;
  int* bfit = tab + 5 * chunk;
  const int xs = kBeamWords * chunk;  // the tables' offsets in tab
  const int ys = xs + a.nx * S;
  float* win = reinterpret_cast<float*>(tab + ys + L * S);
  // This thread's candidate in each of its tiles: where its rows of the
  // column and row tables start in tab.
  int xr[kPer], yr[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int t = (tile0 + p * kG + g) * kTile + tid;
    const bool live = tile0 + p * kG + g < a.tiles && t < LL;
    xr[p] = xs + (live ? t / L - lx0 : 0) * S;
    yr[p] = ys + (live ? t % L : 0) * S;
  }
  const ndt2d::Subsample sub(num_points, a.max_beams);
  const float th = pose[2] + a.dths[ang];
  const float c = cosf(th), s = sinf(th);
  // Windows need the entries of a beam to grow with their offsets, which
  // holds where dls ascends and the cell is positive: every step of an
  // entry's expression is then monotone, so a beam's valid columns lie in
  // [max(first, 0), min(last, W - 1)] of its first and last dx (rows
  // likewise).  Else no beam takes a window.
  bool ascending = a.cell > 0.f && cx > 0 && cy > 0;
  for (int q = threadIdx.x; q + 1 < L; q += kThreads)
    ascending = ascending && a.dls[q] <= a.dls[q + 1];
  const bool windows = __syncthreads_and(ascending);
  const int row = nxb + L;  // a beam's entries: nxb columns, then L rows
  const unsigned row_m = magic(row), win_m = magic(win_words),
                 cw_m = magic(cw);
  float acc[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) acc[p] = 0.f;
  for (int base = 0; base < a.max_beams; base += chunk) {
    const int nb = min(chunk, a.max_beams - base), nb4 = (nb + 3) & ~3;
    __syncthreads();  // the previous chunk is read
    // (1) A thread a beam: rotated, and its window (the cells between its
    // first and last entries, each formed as its entries are).  A padded
    // beam fits an empty window.
    bool fits = true;
    for (int j = threadIdx.x; j < nb4; j += kThreads) {
      const int b = base + j;
      bool used = false, fit = j >= nb;
      int lo = W, ylo = H;
      if (j < nb) {
        const int idx = sub.index(b, num_points, a.P);
        const float px = points[2 * idx], py = points[2 * idx + 1];
        const float rx = c * px - s * py + pose[0];
        const float ry = s * px + c * py + pose[1];
        used = b < sub.used && pmask[idx];
        bx[j] = rx;
        by[j] = ry;
        if (windows) {
          lo = max((int)floorf((rx + a.dls[lx0] - ox) / a.cell), 0);
          const int hi = min(
              (int)floorf((rx + a.dls[lx0 + nxb - 1] - ox) / a.cell), W - 1);
          ylo = max((int)floorf((ry + a.dls[0] - oy) / a.cell), 0);
          const int yhi =
              min((int)floorf((ry + a.dls[L - 1] - oy) / a.cell), H - 1);
          fit = (!used || hi - lo < cx) && yhi - ylo < cy;
        }
      }
      bused[j] = used;
      blox[j] = lo;
      bloy[j] = ylo;
      bfit[j] = fit;
      fits = fits && fit;
    }
    const bool all_fit = __syncthreads_and(fits);
    // (2) Lane: a beam of a group of 32; warp: a row of a table (u < row
    // groups) or a cell of the windows.
    const int bgroups = (nb4 + 31) / 32;
    for (int u = warp; u < bgroups * row; u += kWarps) {
      const int bg = quot(u, row_m), q = u - bg * row, j = 32 * bg + lane;
      if (j >= nb4) continue;
      const bool fit = bfit[j];
      if (q < nxb) {
        int v = fit ? cx * S : kOff;
        if (j < nb) {
          const int ix =
              (int)floorf((bx[j] + a.dls[lx0 + q] - ox) / a.cell);
          if (bused[j] && ix >= 0 && ix < W) v = fit ? (ix - blox[j]) * S : ix;
        }
        tab[xs + q * S + j] = v;
      } else {
        int v = fit ? cy * cw * S + j : kOff;
        if (j < nb) {
          const int iy =
              (int)floorf((by[j] + a.dls[q - nxb] - oy) / a.cell);
          if (iy >= 0 && iy < H) v = fit ? (iy - bloy[j]) * cw * S + j
                                         : iy * W;
        }
        tab[ys + (q - nxb) * S + j] = v;
      }
    }
#pragma unroll 4
    for (int u = warp; u < bgroups * win_words; u += kWarps) {
      const int bg = quot(u, win_m), k = u - bg * win_words;
      const int j = 32 * bg + lane, yy = quot(k, cw_m), xx = k - yy * cw;
      if (j >= nb4) continue;
      const int gx = blox[j] + xx, gy = bloy[j] + yy;
      const bool cell = bfit[j] && xx < cx && yy < cy && gx < W && gy < H;
      win[k * S + j] = cell ? __ldg(field + gy * W + gx) : 0.f;
    }
    __syncthreads();
    if (all_fit) {  // (3)
#pragma unroll 2
      for (int j = 0; j < nb4; j += 4) {
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          const int4 x = *reinterpret_cast<const int4*>(tab + xr[p] + j);
          const int4 y = *reinterpret_cast<const int4*>(tab + yr[p] + j);
          acc[p] += win[x.x + y.x];
          acc[p] += win[x.y + y.y];
          acc[p] += win[x.z + y.z];
          acc[p] += win[x.w + y.w];
        }
      }
    } else {
      for (int j = 0; j < nb4; ++j) {
        if (bfit[j]) {
#pragma unroll
          for (int p = 0; p < kPer; ++p)
            acc[p] += win[tab[xr[p] + j] + tab[yr[p] + j]];
        } else {
#pragma unroll
          for (int p = 0; p < kPer; ++p) {
            const int cellid = tab[xr[p] + j] + tab[yr[p] + j];
            const float v = __ldg(field + max(cellid, 0));
            acc[p] += cellid >= 0 ? v : 0.f;
          }
        }
      }
    }
  }
  float* partial = a.partial + (r * a.A + ang) * a.tiles * lattice::kPartial;
  float* scores =
      a.scores != nullptr ? a.scores + (r * a.A + ang) * LL : nullptr;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    if (tile0 + p * kG >= a.tiles) break;  // the same for the whole block
    const int tile = tile0 + p * kG + g;
    const int t = tile * kTile + tid;
    const bool live = tile < a.tiles && t < LL;
    const int lx = live ? t / L : 0, ly = live ? t % L : 0;
    const float cand = -acc[p];
    if (live && scores != nullptr) scores[t] = cand;
    lattice::reduce_tiles<kG>(
        cand, live, ang * LL + t, a.dls[lx], a.dls[ly], a.dths[ang],
        tile < a.tiles ? partial + tile * lattice::kPartial : nullptr);
    __syncthreads();  // each group's thread 0 has read its warp sums
  }
  __threadfence();  // this block's partials before its ticket
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(a.ticket + r, 1u) == (unsigned)(a.A * a.groups - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  lattice::finalize_row<true, true>(
      a.partial + r * a.A * a.tiles * lattice::kPartial, a.A * a.tiles, L,
      num_points, a.max_beams, a.dths, a.dls, a.out + r * 13,
      reinterpret_cast<float*>(tab), a.stage);
  if (threadIdx.x == 0) a.ticket[r] = 0u;
}

// The launch, refused where its dynamic shared memory and the kernel's
// static (reduce_tiles' warp sums and the fold's flag, read once from the
// compiled kernel) pass the 48 KB a block may take without opting in.
template <int kG, int kPer>
cudaError_t launch_tables(const LatticeTables& a, int R, size_t smem,
                          cudaStream_t st) {
  static const size_t fixed = [] {
    cudaFuncAttributes f{};
    return cudaFuncGetAttributes(&f, lattice_tables<kG, kPer>) == cudaSuccess
               ? f.sharedSizeBytes
               : (size_t)48 * 1024;
  }();
  if (smem + fixed > 48 * 1024) return cudaErrorInvalidValue;
  const int score_block = a.unc != nullptr;
  lattice_tables<kG, kPer>
      <<<dim3(a.A * a.groups + score_block, R), kG * kTile, smem, st>>>(a);
  return cudaGetLastError();
}

// One lattice launch (kernels/correlative.py::_LatticeLaunch, field for
// field): the kernel's arguments, then the block's threads (256, 512 or
// 1024), tiles a thread (per: 1, 2, 4 or 8 at 256, 1 at 512, 1 or 2 at
// 1024; kernels/correlative.py::SHAPES) and the rows R.
struct LatticeLaunch {
  LatticeTables a;
  int threads, per, R;
};

// The launch of l, refused where its shape is outside the kernel's
// instantiations or its tables (W H <= 2^30, chunks of a multiple of 4
// beams, a stride 4 mod 32) outside what the kernel indexes.
cudaError_t launch_lattice(const LatticeLaunch& l, cudaStream_t st) {
  const LatticeTables& a = l.a;
  const int tiles = (a.L * a.L + kTile - 1) / kTile;
  if (l.R < 1 || a.A < 1 || a.L < 1 || a.max_beams < 1 || a.chunk < 4 ||
      a.chunk % 4 || a.nx < 1 || a.cx < 0 || a.cy < 0 ||
      a.stride < a.chunk || a.stride % 32 != 4 || a.stage < 1 ||
      (long long)a.W * a.H > (1ll << 30) || a.tiles != tiles ||
      a.groups != (tiles + l.per * (l.threads / kTile) - 1) /
                      (l.per * (l.threads / kTile)))
    return cudaErrorInvalidValue;
  const size_t words =
      std::max((size_t)kBeamWords * a.chunk +
                   (size_t)(a.nx + a.L + (a.cx + 1) * (a.cy + 1)) * a.stride,
               (size_t)lattice::kPartial * (a.stage + 1));
  const size_t smem = words * sizeof(int);
  switch (l.threads * 16 + l.per) {
    case 256 * 16 + 1: return launch_tables<1, 1>(a, l.R, smem, st);
    case 256 * 16 + 2: return launch_tables<1, 2>(a, l.R, smem, st);
    case 256 * 16 + 4: return launch_tables<1, 4>(a, l.R, smem, st);
    case 256 * 16 + 8: return launch_tables<1, 8>(a, l.R, smem, st);
    case 512 * 16 + 1: return launch_tables<2, 1>(a, l.R, smem, st);
    case 1024 * 16 + 1: return launch_tables<4, 1>(a, l.R, smem, st);
    case 1024 * 16 + 2: return launch_tables<4, 2>(a, l.R, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

struct Beam {
  float rx, ry;
  int used;
};

// The lattice's first form, kept as the comparison arm of
// ndt2d_correlative_match: grid (tiles, A, R), offsets tile blockIdx.x of
// angle blockIdx.y of row blockIdx.z (K6's gather_tiles with the field
// value as the beam's term), each term its own divisions; then
// lattice::finalize as a second launch.
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
  const int m = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (m >= M) return;  // whole warps leave together
  const float u = warp_point_score(
      field, origin[0], origin[1], cell, W, H, points, pmask, P, num_points,
      max_beams, poses[3 * m], poses[3 * m + 1], poses[3 * m + 2]);
  if ((threadIdx.x & 31) == 0) out[m] = u;
}

int blocks(int n, int threads) { return (n + threads - 1) / threads; }

// The seven-step form: a memset of the hit plane and six launches, each
// plane through device memory (the scratch hits, tmp and peak).
cudaError_t field_seven_steps(const FieldLaunch& l, cudaStream_t st) {
  const int C = l.W * l.H;
  cudaError_t err = cudaMemsetAsync(l.hits, 0, (size_t)C * sizeof(int), st);
  if (err != cudaSuccess) return err;
  field_origin<<<1, 1, 0, st>>>(l.poses, l.wmask, l.S, l.range_max,
                                l.origin);
  if (l.S * l.P > 0)
    field_hits<<<blocks(l.S * l.P, kThreads), kThreads, 0, st>>>(
        l.poses, l.points, l.pmask, l.wmask, l.S, l.P, l.origin, l.cell,
        l.W, l.H, l.hits);
  field_blur<int><<<blocks(C, kThreads), kThreads, 0, st>>>(
      l.hits, l.taps, l.W, l.H, false, l.tmp);
  field_blur<float><<<blocks(C, kThreads), kThreads, 0, st>>>(
      l.tmp, l.taps, l.W, l.H, true, l.field);
  field_peak<<<1, kPeakThreads, 0, st>>>(l.field, C, l.peak);
  field_scale<<<blocks(C, kThreads), kThreads, 0, st>>>(l.field, C, l.peak);
  return cudaGetLastError();
}

// The cluster form's plan is launchable: n, h and threads consistent with
// the shape, the stripes within the card's opt-in shared memory.
bool field_plan_ok(const FieldLaunch& l, int optin) {
  return l.n >= 1 && l.n <= kMaxCluster && l.h >= 1 &&
         (long long)l.h * l.n >= l.H && (long long)l.h * (l.n - 1) < l.H &&
         l.threads >= 32 && l.threads <= kFieldThreads &&
         l.threads % 32 == 0 &&
         (long long)l.smem >=
             8ll * (l.h + 2 * kHalo) * l.W + 16ll * l.S +
                 4ll * ((l.S + 3) / 4 * 4) &&
         l.smem <= optin;
}

}  // namespace

// sizeof(FieldLaunch), for the wrapper's check of its mirror.
NDT2D_API int ndt2d_correlative_field_launch_size() {
  return (int)sizeof(FieldLaunch);
}

// Readies the cluster form for plans of up to `smem` dynamic bytes (the
// kernel's opt-in shared memory, clusters past 8 CTAs) and reports in
// *clusters how many clusters of the launch block's plan the card holds at
// once (0: it cannot be launched).
NDT2D_API int ndt2d_correlative_field_setup(const void* launch,
                                            int* clusters) {
  const FieldLaunch& l = *static_cast<const FieldLaunch*>(launch);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, field_cluster);
  if (err != cudaSuccess) return (int)err;
  if (!field_plan_ok(l, optin - (int)fa.sharedSizeBytes))
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(field_cluster,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)fa.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        field_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  field_config(l, nullptr, &cfg, &attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, field_cluster, &cfg);
}

// One field build from its launch block (FieldLaunch): poses [S,3] f32,
// points [S,P,2] f32 (8-byte aligned), pmask [S,P] u8, wmask [S] u8, taps
// [7] f32 -> origin [2] f32, field [H*W] f32.  n = 0: the seven-step form,
// with its scratch; else one cluster launch, after
// ndt2d_correlative_field_setup has readied its plan.
NDT2D_API int ndt2d_correlative_field_planned(const void* launch,
                                              void* stream) {
  const FieldLaunch& l = *static_cast<const FieldLaunch*>(launch);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (l.n == 0) return (int)field_seven_steps(l, st);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  field_config(l, st, &cfg, &attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, field_cluster, l);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The parent form, two launches (lattice_tiles, then lattice::finalize),
// kept as chip_smoke.py's comparison arm: no path of the package launches
// it.
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

// sizeof(LatticeLaunch), for the wrapper's check of its mirror.
NDT2D_API int ndt2d_correlative_lattice_launch_size() {
  return (int)sizeof(LatticeLaunch);
}

// The lattice search in one launch (lattice_tables) from its launch block
// (LatticeLaunch): field [R,H*W] f32, origin [R,2] f32, points [R,P,2] f32,
// pmask [R,P] u8, nums [R] i32 (or null: every row has `num` points), pose
// [R,3] f32, dths [A] f32, dls [L] f32; the plan's tiles, groups, nx
// (the column table's rows), cx x cy (a beam's field window), chunk
// (beams a table chunk, a multiple of 4), stride (the tables' row stride,
// 4 mod 32) and stage (partials the fold stages at a time) from
// kernels/correlative.py::lattice_plan; partial [R, A * tiles, 12] f32
// scratch; out [R,13] f32; scores [R,A,L,L] f32 or null; unc [R] f32 (each
// row's point score at its pose, ndt2d_correlative_score's bits) or null;
// ticket [R] u32, 0 before the launch (left 0).
NDT2D_API int ndt2d_correlative_match_planned(const void* launch,
                                              void* stream) {
  return (int)launch_lattice(*static_cast<const LatticeLaunch*>(launch),
                             reinterpret_cast<cudaStream_t>(stream));
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
