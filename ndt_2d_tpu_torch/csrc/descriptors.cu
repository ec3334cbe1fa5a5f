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

// The descriptor of each scan from its bin tables (:92-127 of the
// reference): the mean-range profile and the n_rings occupancy profiles,
// each through |DFT| at the frequencies 1 .. n_sectors / 2 against the
// cos/sin tables [n_sectors, F] it is handed, then the mean-centred range
// histogram, all divided by their joint L2 norm; zero for a scan with no
// point.  Every sum adds in index order from 0 (a DFT term over the
// sectors, the histogram's mean over the bins, the norm over the
// descriptor's elements), as the twin does.
//
// What bounds it: bytes (the tables in, the descriptors out), but a scan
// is a few latency chains.  Design: a warp a scan, blockDim / 32 scans a
// block.  Every load of the prologue is in flight at once: a thread's
// share of the cos/sin tables, which the block stages in shared memory
// (kStaged; else the terms read them from global memory through L1), and
// a lane's sectors, ring cells and bins of its scan (two sectors, eight
// ring cells and a bin a lane at the main path's 64 x 4 x 32; loops take
// what a batch does not hold), each divided in the lane that loaded it.
// A zero over a positive divisor is kept as itself (quotient): the same
// bits as the division, without its slow path.  Every lane adds the
// histogram's quotients in order for the mean, so no lane waits for
// another's chain.  Lane f owns frequency f
// (f + 32, ... past 32) across all 1 + n_rings profiles, so each (cos,
// sin) pair it reads feeds 2 (1 + n_rings) independent chains over the
// sectors in order (dft_pass, 5 profiles a pass), the profiles read four
// sectors a 16-byte broadcast load.  The squares of the descriptor are
// formed a lane an element, then every lane adds them in order (broadcast
// loads, eight 16-byte loads at a time): the norm's chain of D adds is the
// one long serial part.  Dynamic shared memory: the tables (staged), then
// per warp its profiles (reused for the squares) and its D descriptor
// floats, each region a multiple of 16 bytes.
constexpr int kSpectraChains = 5;  // profiles a lane's pass takes at once
constexpr int kTableLoads = 8;     // float4 of the tables a thread loads
constexpr int kSectorLoads = 2;    // sectors a lane's first batch holds
constexpr int kRingLoads = 8;      // ring cells a lane's first batch holds
constexpr int kOutLoads = 8;       // descriptor floats a lane's batch holds

__host__ __device__ __forceinline__ int round4(int n) {
  return (n + 3) & ~3;
}

// num / den, rounded as IEEE division; a zero num over a positive finite
// den is that zero itself (what the division returns), without the
// division's slow path, which a zero dividend takes.
__device__ __forceinline__ float quotient(float num, float den) {
  return num == 0.f && den > 0.f && den < __int_as_float(0x7f800000)
             ? num
             : num / den;
}

// |DFT| at frequency f of the kN profiles from p0 on: 2 kN chains over
// the sectors in order from +0 (a term's product rounded, then added),
// the profiles read four sectors a 16-byte broadcast load where
// n_sectors is a multiple of 4.  Writes d[(p0 + j) F + f].
template <int kN>
__device__ __forceinline__ void dft_pass(const float* __restrict__ prof,
                                         const float* ct, const float* st,
                                         int n_sectors, int F, int f, int p0,
                                         float* __restrict__ d) {
  float re[kN], im[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) re[j] = im[j] = 0.f;
  const float* pp = prof + p0 * n_sectors;
  int a = 0;
  if ((n_sectors & 3) == 0) {
#pragma unroll 2
    for (; a < n_sectors; a += 4) {
      float c[4], sn[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        c[u] = ct[(a + u) * F + f];
        sn[u] = st[(a + u) * F + f];
      }
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float4 pv =
            *reinterpret_cast<const float4*>(pp + j * n_sectors + a);
        re[j] += pv.x * c[0];
        im[j] += pv.x * sn[0];
        re[j] += pv.y * c[1];
        im[j] += pv.y * sn[1];
        re[j] += pv.z * c[2];
        im[j] += pv.z * sn[2];
        re[j] += pv.w * c[3];
        im[j] += pv.w * sn[3];
      }
    }
  }
  for (; a < n_sectors; ++a) {
    const float c = ct[a * F + f], sn = st[a * F + f];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const float pv = pp[j * n_sectors + a];
      re[j] += pv * c;
      im[j] += pv * sn;
    }
  }
#pragma unroll
  for (int j = 0; j < kN; ++j)
    d[(p0 + j) * F + f] = sqrtf(re[j] * re[j] + im[j] * im[j]);
}

template <bool kStaged>
__global__ void __launch_bounds__(256) scan_spectra(
    const float* __restrict__ sector_count,
    const float* __restrict__ sector_range,
    const float* __restrict__ ring_count, const float* __restrict__ hist,
    const float* __restrict__ total, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, int S, float range_max, int n_sectors,
    int n_rings, int n_bins, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  const int F = n_sectors / 2;
  const int n_prof = 1 + n_rings;
  const int n_spec = n_prof * F;
  const int D = n_spec + n_bins;
  const int n_ring = n_rings * n_sectors;
  const int table = n_sectors * F;
  const int region = round4(max(n_prof * n_sectors, D));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float* prof = sm + (kStaged ? round4(2 * table) : 0) +
                w * (region + round4(D));  // [n_prof, n_sectors]
  float* d = prof + region;                  // [D]
  const size_t s = (size_t)blockIdx.x * (blockDim.x >> 5) + w;
  const bool live = s < (size_t)S;
  sector_count += s * n_sectors;
  sector_range += s * n_sectors;
  ring_count += s * n_ring;
  hist += s * n_bins;
  // The first batch of the tables and of the scan's inputs, every load
  // issued before any store.
  const bool vec = (table & 3) == 0;
  const int n4 = kStaged && vec ? table / 2 : 0;  // float4 of both tables
  float4 tv[kTableLoads];
#pragma unroll
  for (int u = 0; u < kTableLoads; ++u) {
    const int i = threadIdx.x + u * blockDim.x;
    if (i < n4)
      tv[u] = i < n4 / 2 ? reinterpret_cast<const float4*>(cos_t)[i]
                         : reinterpret_cast<const float4*>(sin_t)[i - n4 / 2];
  }
  float cnt[kSectorLoads], rng[kSectorLoads], ring[kRingLoads], hq = 0.f;
#pragma unroll
  for (int u = 0; u < kSectorLoads; ++u) {
    const int i = lane + 32 * u;
    if (live && i < n_sectors) {
      cnt[u] = sector_count[i];
      rng[u] = sector_range[i];
    }
  }
#pragma unroll
  for (int u = 0; u < kRingLoads; ++u) {
    const int i = lane + 32 * u;
    if (live && i < n_ring) ring[u] = ring_count[i];
  }
  if (live && lane < n_bins) hq = hist[lane];
  const float points = live ? total[s] : 0.f;
#pragma unroll
  for (int u = 0; u < kTableLoads; ++u) {
    const int i = threadIdx.x + u * blockDim.x;
    if (i < n4) reinterpret_cast<float4*>(sm)[i] = tv[u];
  }
  if (kStaged) {  // what the first batch did not hold
    if (vec) {
      for (int i = threadIdx.x + kTableLoads * blockDim.x; i < n4;
           i += blockDim.x)
        reinterpret_cast<float4*>(sm)[i] =
            i < n4 / 2 ? reinterpret_cast<const float4*>(cos_t)[i]
                       : reinterpret_cast<const float4*>(sin_t)[i - n4 / 2];
    } else {
      for (int i = threadIdx.x; i < table; i += blockDim.x) {
        sm[i] = cos_t[i];
        sm[table + i] = sin_t[i];
      }
    }
  }
  // The profiles and the histogram's quotients, each in the lane that
  // loaded it, then what the first batch did not hold.
  const float tot = fmaxf(points, 1.f);
  if (live) {
#pragma unroll
    for (int u = 0; u < kSectorLoads; ++u) {
      const int i = lane + 32 * u;
      if (i < n_sectors)
        prof[i] = quotient(quotient(rng[u], fmaxf(cnt[u], 1.f)), range_max);
    }
#pragma unroll
    for (int u = 0; u < kRingLoads; ++u) {
      const int i = lane + 32 * u;
      if (i < n_ring) prof[n_sectors + i] = quotient(ring[u], tot);
    }
    hq = quotient(hq, tot);
    for (int i = lane + 32 * kSectorLoads; i < n_sectors; i += 32)
      prof[i] = quotient(quotient(sector_range[i], fmaxf(sector_count[i],
                                                          1.f)),
                         range_max);
    for (int i = lane + 32 * kRingLoads; i < n_ring; i += 32)
      prof[n_sectors + i] = quotient(ring_count[i], tot);
    for (int b = lane; b < n_bins; b += 32)
      d[n_spec + b] = b < 32 ? hq : quotient(hist[b], tot);
  }
  if (kStaged) __syncthreads();
  if (!live) return;
  const float* ct = kStaged ? sm : cos_t;
  const float* st = kStaged ? sm + table : sin_t;
  __syncwarp();
  // The histogram's mean, every lane adding the quotients in order
  // (broadcast loads).
  float sum = 0.f;
#pragma unroll 8
  for (int b = 0; b < n_bins; ++b) sum += d[n_spec + b];
  const float mean = sum / (float)n_bins;
  // |DFT| of every profile at lane f's frequencies, kSpectraChains
  // profiles a pass (one at a time past the last full pass).
  for (int f = lane; f < F; f += 32) {
    int p0 = 0;
    for (; p0 + kSpectraChains <= n_prof; p0 += kSpectraChains)
      dft_pass<kSpectraChains>(prof, ct, st, n_sectors, F, f, p0, d);
    for (; p0 < n_prof; ++p0)
      dft_pass<1>(prof, ct, st, n_sectors, F, f, p0, d);
  }
  for (int b = lane; b < n_bins; b += 32) d[n_spec + b] -= mean;
  __syncwarp();
  // The squares a lane an element, over the profiles (kOutLoads loads a
  // lane before their stores); every lane adds them in order, eight
  // 16-byte broadcast loads at a time.
  float* sq = prof;
  float v[kOutLoads];
#pragma unroll
  for (int u = 0; u < kOutLoads; ++u) {
    const int e = lane + 32 * u;
    v[u] = e < D ? d[e] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kOutLoads; ++u) {
    const int e = lane + 32 * u;
    if (e < D) sq[e] = v[u] * v[u];
  }
  for (int e = lane + 32 * kOutLoads; e < D; e += 32) sq[e] = d[e] * d[e];
  __syncwarp();
  float acc = 0.f;
  {
    const float4* sq4 = reinterpret_cast<const float4*>(sq);
    const int m4 = D / 4;
    int g = 0;
    for (; g + 8 <= m4; g += 8) {  // eight loads, then their 32 adds
      float4 x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = sq4[g + u];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        acc += x[u].x;
        acc += x[u].y;
        acc += x[u].z;
        acc += x[u].w;
      }
    }
    for (int e = 4 * g; e < D; ++e) acc += sq[e];
  }
  const float norm = fmaxf(sqrtf(acc), 1e-12f);
  out += s * D;
#pragma unroll
  for (int u = 0; u < kOutLoads; ++u) {
    const int e = lane + 32 * u;
    if (e < D) out[e] = points > 0.f ? quotient(v[u], norm) : 0.f;
  }
  for (int e = lane + 32 * kOutLoads; e < D; e += 32)
    out[e] = points > 0.f ? quotient(d[e], norm) : 0.f;
}

// Dynamic shared bytes of a spectra block of `warps` warps (kernels/
// descriptors.py::spectra_shared).
size_t spectra_shared(int n_sectors, int n_rings, int n_bins, int warps,
                      int staged) {
  const int F = n_sectors / 2, n_prof = 1 + n_rings;
  const int D = n_prof * F + n_bins;
  const int prof = n_prof * n_sectors;
  const size_t region = round4(prof > D ? prof : D) + round4(D);
  return ((staged ? (size_t)round4(2 * n_sectors * F) : 0) + warps * region) *
         sizeof(float);
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
// n_sectors/2] f32; out [S, (1+n_rings)*n_sectors/2 + n_bins] f32.  The
// plan (kernels/descriptors.py::spectra_plan): `warps` scans a block (1,
// 2, 4 or 8), the tables `staged` in shared memory or not; refused past
// the default 48 KB of shared memory.
NDT2D_API int ndt2d_descriptor_spectra(
    const void* sector_count, const void* sector_range,
    const void* ring_count, const void* hist, const void* total,
    const void* cos_t, const void* sin_t, int S, float range_max,
    int n_sectors, int n_rings, int n_bins, int warps, int staged,
    void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t shared =
      spectra_shared(n_sectors, n_rings, n_bins, warps, staged);
  if (shared > 48 * 1024 || n_sectors < 2 || n_rings < 1 || n_bins < 1 ||
      (warps != 1 && warps != 2 && warps != 4 && warps != 8))
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  const auto kernel = staged ? &scan_spectra<true> : &scan_spectra<false>;
  kernel<<<(S + warps - 1) / warps, warps * 32, shared, st>>>(
      static_cast<const float*>(sector_count),
      static_cast<const float*>(sector_range),
      static_cast<const float*>(ring_count), static_cast<const float*>(hist),
      static_cast<const float*>(total), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), S, range_max, n_sectors, n_rings,
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
