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
// divisions a point.  Design: one block per scan.  Every thread bins its
// points (p = thread, thread + 128, ...), keeps each point's sector and r
// in shared memory and counts with shared-memory integer atomics, which
// are exact in any order.  The range sum per sector is a float sum, so one
// thread per sector then adds its sector's ranges in point order from 0:
// no float atomics, and the twin adds in the same order.  Operands are
// never negative, so the int casts truncate as floor does.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

// Grid (S): scan s = blockIdx.x.  Dynamic shared memory: P floats (r), P
// int16 (sector, -1 for a masked point), then the integer counters.
__global__ void __launch_bounds__(kThreads) bin_scans(
    const float* __restrict__ points, const uint8_t* __restrict__ mask,
    int P, float range_max, int n_sectors, int n_rings, int n_bins,
    float* __restrict__ sector_count, float* __restrict__ sector_range,
    float* __restrict__ ring_count, float* __restrict__ hist,
    float* __restrict__ total) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* rs = reinterpret_cast<float*>(smem);
  int* counts = reinterpret_cast<int*>(rs + P);
  short* secs = reinterpret_cast<short*>(counts + n_sectors +
                                         n_rings * n_sectors + n_bins + 1);
  int* c_sec = counts;
  int* c_ring = c_sec + n_sectors;
  int* c_hist = c_ring + n_rings * n_sectors;
  int* c_total = c_hist + n_bins;
  const int n_counts = n_sectors + n_rings * n_sectors + n_bins + 1;

  const size_t s = blockIdx.x;
  points += s * P * 2;
  mask += s * P;
  for (int i = threadIdx.x; i < n_counts; i += blockDim.x) counts[i] = 0;
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const float x = points[2 * p], y = points[2 * p + 1];
    const float r = sqrtf(x * x + y * y);
    const float ang = atan2f(y, x);
    const int sec = ndt2d::clampi(
        (int)((ang + kPi) / kTwoPi * (float)n_sectors), 0, n_sectors - 1);
    const int ring = ndt2d::clampi((int)(r / range_max * (float)n_rings), 0,
                                   n_rings - 1);
    const int b = ndt2d::clampi((int)(r / range_max * (float)n_bins), 0,
                                n_bins - 1);
    rs[p] = r;
    if (mask[p]) {
      secs[p] = (short)sec;
      atomicAdd(&c_sec[sec], 1);
      atomicAdd(&c_ring[ring * n_sectors + sec], 1);
      atomicAdd(&c_hist[b], 1);
      atomicAdd(c_total, 1);
    } else {
      secs[p] = -1;
    }
  }
  __syncthreads();
  sector_count += s * n_sectors;
  sector_range += s * n_sectors;
  ring_count += s * n_rings * n_sectors;
  hist += s * n_bins;
  // The range sum of each sector, its points in order from 0.
  for (int a = threadIdx.x; a < n_sectors; a += blockDim.x) {
    float acc = 0.f;
    for (int p = 0; p < P; ++p)
      if (secs[p] == a) acc += rs[p];
    sector_range[a] = acc;
    sector_count[a] = (float)c_sec[a];
  }
  for (int i = threadIdx.x; i < n_rings * n_sectors; i += blockDim.x)
    ring_count[i] = (float)c_ring[i];
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x)
    hist[i] = (float)c_hist[i];
  if (threadIdx.x == 0) total[s] = (float)c_total[0];
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

// points [S,P,2] f32, mask [S,P] u8; outputs sector_count [S,n_sectors],
// sector_range [S,n_sectors], ring_count [S,n_rings*n_sectors], hist
// [S,n_bins], total [S], all f32.  n_sectors < 32768.
NDT2D_API int ndt2d_descriptor_bins(
    const void* points, const void* mask, int S, int P, float range_max,
    int n_sectors, int n_rings, int n_bins, void* sector_count,
    void* sector_range, void* ring_count, void* hist, void* total,
    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int n_counts = n_sectors + n_rings * n_sectors + n_bins + 1;
  const size_t shared = (size_t)P * sizeof(float) +
                        (size_t)n_counts * sizeof(int) +
                        (size_t)P * sizeof(short);
  if (shared > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  bin_scans<<<S, kThreads, shared, st>>>(
      static_cast<const float*>(points), static_cast<const uint8_t*>(mask),
      P, range_max, n_sectors, n_rings, n_bins,
      static_cast<float*>(sector_count), static_cast<float*>(sector_range),
      static_cast<float*>(ring_count), static_cast<float*>(hist),
      static_cast<float*>(total));
  return (int)cudaGetLastError();
}
