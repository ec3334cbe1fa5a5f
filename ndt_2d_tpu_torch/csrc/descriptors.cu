// K10: the binning of the keyframe descriptors.
//
// Replaces the five segment sums of the jitted
// ndt_2d_tpu/parallel/loop_search.py::descriptors (binned_sum over the
// sector, ring x sector and range-bin ids, :79-83, :86-90, :105-110,
// :119-121) together with the range, angle and bin indices they are taken
// over.  Per scan s and each of its masked points p:
//   r    = sqrt(x * x + y * y)
//   sec  = clip(int((atan2(y, x) + pi) / (2 pi) * n_sectors), 0, n_sectors-1)
//   ring = clip(int(r / range_max * n_rings), 0, n_rings - 1)
//   b    = clip(int(r / range_max * n_bins), 0, n_bins - 1)
// and the outputs are the points per sector, the sum of r per sector, the
// points per (ring, sector), the points per range bin and the points of
// the scan, as float32.  A second kernel below (scan_spectra) turns these
// tables into the descriptors: mean profile, the DFT magnitudes, the centred
// histogram and the L2 norm.
//
// What bounds it on the card: bytes.  The table of S x P points is read
// once (9 bytes a point) and S x (2 n_sectors + n_rings n_sectors + n_bins
// + 1) floats are written; the arithmetic is one atan2, one sqrt and two
// divisions a point.  Design: one block per scan, its warps owning
// consecutive runs of its points.  The counts are shared-memory integer
// atomics, exact in any order.  The range sum per sector is a float sum,
// added in point order from +0 (the twin's order) with no thread walking
// all P points: a stable counting sort of the masked points by sector.
// Each warp bins its run 32 points at a time in order (one float2 load a
// point); the lanes of one sector (a __match_any_sync group) take
// consecutive ranks in lane order after the warp's earlier points of the
// sector, kept beside r.  Warp c then sums the counts of sectors [32 c,
// 32 c + 32) over the warps, gives each warp its base in the sector and
// scans the counts into the runs' starts; every thread places r at its
// warp's base + its rank, and one thread a sector adds its contiguous
// run.  A sector's chain is its own count of adds, not P.  No
// float atomics.  Operands are never negative, so the int casts truncate
// as floor does.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kAhead = 4;  // rounds of a warp's points loaded together
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

// Grid (S): scan s = blockIdx.x, kWarps warps; warp w owns points [w Q,
// w Q + Q), Q = the points rounded up to 32 kWarps, over kWarps.  Dynamic
// shared memory: P floats r, P floats sorted, the integer counters
// (sectors, ring x sector, range bins), kWarps x n_sectors warp counts,
// kWarps x n_sectors warp bases, n_sectors run starts, then P int16
// sectors (-1 for a masked point) and P int16 ranks within the warp's
// points of the sector.
template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32) bin_scans(
    const float* __restrict__ points, const uint8_t* __restrict__ mask,
    int P, float range_max, int n_sectors, int n_rings, int n_bins,
    float* __restrict__ sector_count, float* __restrict__ sector_range,
    float* __restrict__ ring_count, float* __restrict__ hist,
    float* __restrict__ total) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* rs = reinterpret_cast<float*>(smem);
  float* sorted = rs + P;
  int* c_sec = reinterpret_cast<int*>(sorted + P);
  int* c_ring = c_sec + n_sectors;
  int* c_hist = c_ring + n_rings * n_sectors;
  int* wcount = c_hist + n_bins;           // [kWarps, n_sectors]
  int* wbase = wcount + kWarps * n_sectors;  // [kWarps, n_sectors]
  int* start = wbase + kWarps * n_sectors;   // [n_sectors]
  short* secs = reinterpret_cast<short*>(start + n_sectors);
  short* rank = secs + P;

  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int Q = ((P + 32 * kWarps - 1) / (32 * kWarps)) * 32;
  const size_t s = blockIdx.x;
  const float2* pts = reinterpret_cast<const float2*>(points) + s * P;
  mask += s * P;
  // A warp's points, kAhead rounds of 32 at a time (the first rounds'
  // loads in flight across the counters' zeroing).
  float2 xy[kAhead];
  bool keep[kAhead];
  const auto load = [&](int j0) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int p = w * Q + j0 + 32 * u + lane;
      const bool in = j0 + 32 * u < Q && p < P;
      xy[u] = in ? pts[p] : make_float2(0.f, 0.f);
      keep[u] = in && mask[p];
    }
  };
  load(0);
  for (int i = t; i < n_rings * n_sectors + n_bins + kWarps * n_sectors;
       i += kWarps * 32)
    c_ring[i] = 0;
  __syncthreads();
  // Bin, 32 points of the warp's run at a time in order, kAhead rounds
  // together: each masked point's r, sector and counts for all of them,
  // then round by round its rank among the warp's points of its sector (a
  // __match_any_sync group's lanes in lane order after the earlier ones).
  int* own = wcount + w * n_sectors;
  for (int j0 = 0; j0 < Q; j0 += 32 * kAhead) {
    if (j0 > 0) load(j0);
    int sec[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      sec[u] = -1;
      if (j0 + 32 * u >= Q) break;
      const int p = w * Q + j0 + 32 * u + lane;
      if (p >= P) continue;
      if (keep[u]) {
        const float x = xy[u].x, y = xy[u].y;
        const float r = sqrtf(x * x + y * y);
        const float ang = atan2f(y, x);
        rs[p] = r;
        sec[u] = ndt2d::clampi((int)((ang + kPi) / kTwoPi * (float)n_sectors),
                               0, n_sectors - 1);
        const int ring = ndt2d::clampi((int)(r / range_max * (float)n_rings),
                                       0, n_rings - 1);
        const int b = ndt2d::clampi((int)(r / range_max * (float)n_bins), 0,
                                    n_bins - 1);
        atomicAdd(&c_ring[ring * n_sectors + sec[u]], 1);
        atomicAdd(&c_hist[b], 1);
      }
      secs[p] = (short)sec[u];
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (j0 + 32 * u >= Q) break;
      const int p = w * Q + j0 + 32 * u + lane;
      const unsigned group = __match_any_sync(0xffffffffu, sec[u]);
      if (sec[u] >= 0)
        rank[p] = (short)(own[sec[u]] + __popc(group & below));
      __syncwarp();
      if (sec[u] >= 0 && (group & below) == 0) own[sec[u]] += __popc(group);
      __syncwarp();
    }
  }
  __syncthreads();
  // Warp c takes sectors [32 c, 32 c + 32): each sector's count over the
  // warps and each warp's base in it (the warps before it), the counts of
  // the sectors before the chunk (its carry), then the run starts by an
  // exclusive scan; the last chunk's warp writes the scan's total.
  const int chunks = (n_sectors + 31) / 32;
  for (int c = w; c < chunks; c += kWarps) {
    int carry = 0;
    for (int a = lane; a < 32 * c; a += 32)
#pragma unroll
      for (int v = 0; v < kWarps; ++v) carry += wcount[v * n_sectors + a];
    for (int off = 16; off > 0; off >>= 1)
      carry += __shfl_xor_sync(0xffffffffu, carry, off);
    const int a = 32 * c + lane;
    int n[kWarps];
#pragma unroll
    for (int v = 0; v < kWarps; ++v)
      n[v] = a < n_sectors ? wcount[v * n_sectors + a] : 0;
    int cnt = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) cnt += n[v];
    int inc = cnt;
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += u;
    }
    const int first = carry + inc - cnt;
    if (a < n_sectors) {
      c_sec[a] = cnt;
      start[a] = first;
      int b = first;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        wbase[v * n_sectors + a] = b;
        b += n[v];
      }
    }
    if (c == chunks - 1 && lane == 31) total[s] = (float)(carry + inc);
  }
  __syncthreads();
  // Place each masked point's r at its warp's base in its sector + its
  // rank (each warp its own run).
  const int* base = wbase + w * n_sectors;
  for (int j = lane; j < Q; j += 32) {
    const int p = w * Q + j;
    if (p >= P) break;
    const int sec = secs[p];
    if (sec >= 0) sorted[base[sec] + rank[p]] = rs[p];
  }
  __syncthreads();
  sector_count += s * n_sectors;
  sector_range += s * n_sectors;
  ring_count += s * n_rings * n_sectors;
  hist += s * n_bins;
  // The range sum of each sector: its run of the sorted ranges, in point
  // order from 0.
  for (int a = t; a < n_sectors; a += kWarps * 32) {
    const float* run = sorted + start[a];
    const int n = c_sec[a];
    float acc = 0.f;
    int i = 0;
    for (; i + 4 <= n; i += 4) {  // four loads in flight, adds in order
      const float r0 = run[i], r1 = run[i + 1], r2 = run[i + 2],
                  r3 = run[i + 3];
      acc += r0;
      acc += r1;
      acc += r2;
      acc += r3;
    }
    for (; i < n; ++i) acc += run[i];
    sector_range[a] = acc;
    sector_count[a] = (float)n;
  }
  for (int i = t; i < n_rings * n_sectors; i += kWarps * 32)
    ring_count[i] = (float)c_ring[i];
  for (int i = t; i < n_bins; i += kWarps * 32) hist[i] = (float)c_hist[i];
}

// The descriptor of scan s = blockIdx.x from its bin tables (:92-127 of the
// reference): the mean-range profile and the n_rings occupancy profiles,
// each through |DFT| at the frequencies 1 .. n_sectors / 2 against the
// cos/sin tables [n_sectors, F] it is handed, then the mean-centred range
// histogram, all divided by their joint L2 norm; zero for a scan with no
// point.  Every sum adds in index order from 0 (a DFT term over the
// sectors, the histogram's mean over the bins, the norm over the
// descriptor's elements), as the twin does.  Dynamic shared memory:
// (1 + n_rings) * n_sectors profile floats, then the D descriptor floats.
__global__ void __launch_bounds__(kThreads) scan_spectra(
    const float* __restrict__ sector_count,
    const float* __restrict__ sector_range,
    const float* __restrict__ ring_count, const float* __restrict__ hist,
    const float* __restrict__ total, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, float range_max, int n_sectors,
    int n_rings, int n_bins, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* prof = reinterpret_cast<float*>(smem);
  const int F = n_sectors / 2;
  const int n_prof = 1 + n_rings;
  const int n_spec = n_prof * F;
  const int D = n_spec + n_bins;
  float* d = prof + n_prof * n_sectors;
  __shared__ float norm;

  const size_t s = blockIdx.x;
  sector_count += s * n_sectors;
  sector_range += s * n_sectors;
  ring_count += s * n_rings * n_sectors;
  hist += s * n_bins;
  out += s * D;
  const float points = total[s];
  const float tot = fmaxf(points, 1.f);
  for (int i = threadIdx.x; i < n_prof * n_sectors; i += blockDim.x) {
    if (i < n_sectors)
      prof[i] = sector_range[i] / fmaxf(sector_count[i], 1.f) / range_max;
    else
      prof[i] = ring_count[i - n_sectors] / tot;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < D; e += blockDim.x) {
    if (e < n_spec) {
      const float* p = prof + (e / F) * n_sectors;
      const int f = e % F;
      float re = 0.f, im = 0.f;
      for (int a = 0; a < n_sectors; ++a) {
        re += p[a] * cos_t[a * F + f];
        im += p[a] * sin_t[a * F + f];
      }
      d[e] = sqrtf(re * re + im * im);
    } else {
      float sum = 0.f;
      for (int b = 0; b < n_bins; ++b) sum += hist[b] / tot;
      d[e] = hist[e - n_spec] / tot - sum / (float)n_bins;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sq = 0.f;
    for (int e = 0; e < D; ++e) sq += d[e] * d[e];
    norm = fmaxf(sqrtf(sq), 1e-12f);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < D; e += blockDim.x)
    out[e] = points > 0.f ? d[e] / norm : 0.f;
}

// Dynamic shared bytes of a bins block of `warps` warps.
size_t bins_shared(int P, int n_sectors, int n_rings, int n_bins,
                   int warps) {
  const int n_counts = n_sectors + n_rings * n_sectors + n_bins;
  return (size_t)P * (2 * sizeof(float) + 2 * sizeof(short)) +
         ((size_t)n_counts + (size_t)(2 * warps + 1) * n_sectors) *
             sizeof(int);
}

}  // namespace

// The bin tables of ndt2d_descriptor_bins, cos_t and sin_t [n_sectors,
// n_sectors/2] f32; out [S, (1+n_rings)*n_sectors/2 + n_bins] f32.
NDT2D_API int ndt2d_descriptor_spectra(
    const void* sector_count, const void* sector_range,
    const void* ring_count, const void* hist, const void* total,
    const void* cos_t, const void* sin_t, int S, float range_max,
    int n_sectors, int n_rings, int n_bins, void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int F = n_sectors / 2;
  const size_t shared =
      ((size_t)(1 + n_rings) * (n_sectors + F) + n_bins) * sizeof(float);
  if (shared > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  scan_spectra<<<S, kThreads, shared, st>>>(
      static_cast<const float*>(sector_count),
      static_cast<const float*>(sector_range),
      static_cast<const float*>(ring_count), static_cast<const float*>(hist),
      static_cast<const float*>(total), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), range_max, n_sectors, n_rings,
      n_bins, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// points [S,P,2] f32 (8-byte aligned), mask [S,P] u8; outputs sector_count
// [S,n_sectors], sector_range [S,n_sectors], ring_count
// [S,n_rings*n_sectors], hist [S,n_bins], total [S], all f32.  threads:
// 128 or 256 (kernels/descriptors.py::bins_plan).  n_sectors < 32768; a
// block past the default 48 KB of shared memory opts in to more (the
// card's limit, 227 KB on the H100, refuses the launch past it).
NDT2D_API int ndt2d_descriptor_bins(
    const void* points, const void* mask, int S, int P, float range_max,
    int n_sectors, int n_rings, int n_bins, int threads, void* sector_count,
    void* sector_range, void* ring_count, void* hist, void* total,
    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t shared =
      bins_shared(P, n_sectors, n_rings, n_bins, threads / 32);
  if (n_sectors >= 32768 || (threads != 128 && threads != 256))
    return (int)cudaErrorInvalidValue;
  const auto kernel = threads == 128 ? &bin_scans<4> : &bin_scans<8>;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  if (S == 0) return 0;
  kernel<<<S, threads, shared, st>>>(
      static_cast<const float*>(points), static_cast<const uint8_t*>(mask),
      P, range_max, n_sectors, n_rings, n_bins,
      static_cast<float*>(sector_count), static_cast<float*>(sector_range),
      static_cast<float*>(ring_count), static_cast<float*>(hist),
      static_cast<float*>(total));
  return (int)cudaGetLastError();
}
