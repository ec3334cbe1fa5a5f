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
// sums), each a few microseconds wide.
// Design, five launches per resample and no host sync between them:
//  * pf_motion: one thread per particle (rot-trans-rot sample with pre-drawn
//    standard normals and host-computed scalars).
//  * pf_cdf (one block): masked weight total, normalization and the
//    inclusive CDF; with recovery, the w_slow/w_fast EWMAs and p_inject.
//  * pf_draw (one thread per draw): the binary search of jnp.searchsorted
//    ('scan' method, side left) on r = cdf[M-1] * (1 - u), the gather and the
//    truncated bin keys (IEEE division); it also clears the hash table.
//  * pf_hash (one thread per draw): an open-addressed table of bin keys; an
//    integer atomicMin leaves each key's first draw index, the same table
//    contents on every run whatever the order of the atomics.
//  * pf_finish (one block): first-occurrence marks, prefix count k(m), the
//    KLD bound and n_active; with recovery the free-space injection; then
//    the statistics.  Standalone, it is update_statistics (and injection);
//    pf_cdf standalone gives measure()'s EWMAs in the resample's order.
// Every float sum of the single-block launches is taken in one fixed order:
// thread t sums the contiguous chunk [tL, tL + L), L = ceil(M / 1024), from
// 0, then a halving tree over the 1024 partials; the CDF scans the chunks
// and then the chunk totals (Hillis-Steele).  No float atomics anywhere, so
// every output is bitwise reproducible, and the twin adds in the same order.
#include "common.cuh"

#include <limits.h>

namespace {

constexpr int kBlock = 1024;
constexpr int kThreads = 256;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

// core/pose.py::normalize_angle in float32.
__device__ __forceinline__ float normalize_angle(float t) {
  return t - kTwoPi * floorf((t + kPi) / kTwoPi);
}

// Sum of one value per thread over the block: a halving tree, fixed order.
__device__ float block_sum(float v, float* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int w = kBlock / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
    __syncthreads();
  }
  const float r = sh[0];
  __syncthreads();
  return r;
}

__device__ int block_min(int v, int* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int w = kBlock / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sh[threadIdx.x] = min(sh[threadIdx.x],
                                               sh[threadIdx.x + w]);
    __syncthreads();
  }
  const int r = sh[0];
  __syncthreads();
  return r;
}

// Inclusive Hillis-Steele scan of one value per thread.
template <typename T>
__device__ T block_scan(T v, T* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int off = 1; off < kBlock; off <<= 1) {
    const T x = threadIdx.x >= off ? sh[threadIdx.x - off] : T(0);
    __syncthreads();
    sh[threadIdx.x] = sh[threadIdx.x] + x;
    __syncthreads();
  }
  const T r = sh[threadIdx.x];
  __syncthreads();
  return r;
}

// The chunk [lo, hi) of this thread for M items.
struct Chunk {
  int lo, hi;
  __device__ Chunk(int M) {
    const int L = (M + kBlock - 1) / kBlock;
    lo = min((int)threadIdx.x * L, M);
    hi = min(lo + L, M);
  }
};

__global__ void pf_motion(const float* __restrict__ in,
                          const float* __restrict__ noise, int M, float rot1,
                          float trans, float rot2, float s_rot1,
                          float s_trans, float s_rot2,
                          float* __restrict__ out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const float r1 = rot1 + noise[3 * m] * s_rot1;
  const float t = trans + noise[3 * m + 1] * s_trans;
  const float r2 = rot2 + noise[3 * m + 2] * s_rot2;
  const float a = in[3 * m + 2] + r1;
  out[3 * m] = in[3 * m] + t * cosf(a);
  out[3 * m + 1] = in[3 * m + 1] + t * sinf(a);
  out[3 * m + 2] = normalize_angle(a + r2);
}

// scal out: [0] p_inject.  wstate in and out: [w_slow, w_fast].
__global__ void __launch_bounds__(kBlock)
    pf_cdf(const float* __restrict__ w, const int* __restrict__ n_in, int M,
           int recovery, int ewma, float alpha_slow, float alpha_fast,
           const float* __restrict__ wstate, float* __restrict__ wstate_out,
           float* __restrict__ cdf, float* __restrict__ scal) {
  __shared__ float sh[kBlock];
  const Chunk ch(M);
  const int n = min(max(n_in[0], 0), M);
  float acc = 0.f, good = 0.f;
  for (int i = ch.lo; i < ch.hi; ++i) {
    acc += i < n ? w[i] : 0.f;
    good += i < n ? -w[i] : 0.f;
  }
  const float total = block_sum(acc, sh);
  // normalize_weights: w / total, or uniform over the mask at total == 0.
  const float uni = 1.f / (float)max(n, 1);
  float run = 0.f;
  for (int i = ch.lo; i < ch.hi; ++i) {
    const float wi = i < n ? w[i] : 0.f;
    const float p = total != 0.f ? wi / total : (i < n ? uni : 0.f);
    run += p;
    cdf[i] = run;
  }
  // Chunk offsets: the inclusive scan of the chunk totals, shifted by one.
  const float incl = block_scan(run, sh);
  sh[threadIdx.x] = incl;
  __syncthreads();
  const float offset = threadIdx.x > 0 ? sh[threadIdx.x - 1] : 0.f;
  for (int i = ch.lo; i < ch.hi; ++i) cdf[i] = offset + cdf[i];
  __syncthreads();
  if (!recovery) return;
  const float gsum = block_sum(good, sh);
  if (threadIdx.x == 0) {
    float ws = wstate[0], wf = wstate[1];
    if (ewma) {
      const float w_avg = gsum / (float)max(n, 1);
      ws = ws == 0.f ? w_avg : ws + alpha_slow * (w_avg - ws);
      wf = wf == 0.f ? w_avg : wf + alpha_fast * (w_avg - wf);
    }
    wstate_out[0] = ws;
    wstate_out[1] = wf;
    scal[0] = fmaxf(0.f, 1.f - wf / fmaxf(ws, 1e-30f));
  }
}

__device__ __forceinline__ unsigned key_hash(int a, int b, int c) {
  unsigned h = (unsigned)a * 73856093u;
  h ^= (unsigned)b * 19349663u;
  h ^= (unsigned)c * 83492791u;
  h ^= h >> 15;
  h *= 2654435761u;
  return h ^ (h >> 13);
}

__global__ void pf_draw(const float* __restrict__ cdf,
                        const float* __restrict__ u, int M, int levels,
                        const float* __restrict__ particles,
                        const float* __restrict__ w, float bx, float by,
                        float bt, int T, float* __restrict__ samp,
                        float* __restrict__ samp_w, int* __restrict__ keys,
                        int* __restrict__ idx_out, int* __restrict__ owner,
                        int* __restrict__ first) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < T) {
    owner[i] = -1;
    first[i] = INT_MAX;
  }
  if (i >= M) return;
  const float r = cdf[M - 1] * (1.f - u[i]);
  // jnp.searchsorted(cdf, r) ('scan', side left): the first index with
  // r <= cdf[index], as the same fixed number of halving steps.
  int lo = 0, hi = M;
  for (int l = 0; l < levels; ++l) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) / 2u);
    const bool left = r <= cdf[mid];
    lo = left ? lo : mid;
    hi = left ? mid : hi;
  }
  const int j = min(hi, M - 1);  // a gather clamps, as XLA's does
  const float x = particles[3 * j], y = particles[3 * j + 1],
              t = particles[3 * j + 2];
  samp[3 * i] = x;
  samp[3 * i + 1] = y;
  samp[3 * i + 2] = t;
  samp_w[i] = w[j];
  keys[3 * i] = (int)truncf(x / bx);
  keys[3 * i + 1] = (int)truncf(y / by);
  keys[3 * i + 2] = (int)truncf(t / bt);
  idx_out[i] = j;
}

__global__ void pf_hash(const int* __restrict__ keys, int M, int T,
                        int* __restrict__ owner, int* __restrict__ first,
                        int* __restrict__ slot) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const int a = keys[3 * i], b = keys[3 * i + 1], c = keys[3 * i + 2];
  unsigned h = key_hash(a, b, c) & (unsigned)(T - 1);
  for (;;) {
    const int o = atomicCAS(&owner[h], -1, i);
    // The owner's key was written by pf_draw, a launch that has finished.
    if (o == -1 || (keys[3 * o] == a && keys[3 * o + 1] == b &&
                    keys[3 * o + 2] == c)) {
      atomicMin(&first[h], i);
      slot[i] = (int)h;
      return;
    }
    h = (h + 1u) & (unsigned)(T - 1);
  }
}

// mode bit 1: KLD count from the marks (else n = n_in); bit 2: injection.
// out: particles [M,3], raw weights [M], normalized weights [M], n [1],
// stats [13] = n, mean[3], cov[9]; marks [M] (KLD mode).
__global__ void __launch_bounds__(kBlock) pf_finish(
    const float* __restrict__ parts, const float* __restrict__ w_in,
    const int* __restrict__ n_in, int M, int mode,
    const int* __restrict__ first_of_slot, const int* __restrict__ slot,
    float kld_err, float kld_z, int min_p,
    const float* __restrict__ scal, const float* __restrict__ free_xy,
    float free_cell, const float* __restrict__ u_sel,
    const int* __restrict__ inj_idx, const float* __restrict__ jitter,
    const float* __restrict__ theta, float* __restrict__ out_p,
    float* __restrict__ out_w, float* __restrict__ out_wn,
    int* __restrict__ n_out, float* __restrict__ stats,
    uint8_t* __restrict__ marks) {
  __shared__ float sh[kBlock];
  __shared__ int shi[kBlock];
  const Chunk ch(M);
  int n;
  if (mode & 1) {
    int cnt = 0;
    for (int i = ch.lo; i < ch.hi; ++i) {
      const bool f = first_of_slot[slot[i]] == i;
      marks[i] = f;
      cnt += f;
    }
    const int before = block_scan(cnt, shi) - cnt;
    int k = before, done_at = M;
    for (int i = ch.lo; i < ch.hi; ++i) {
      k += marks[i];
      const float kf = (float)k;
      const float a = (kf - 1.f) / (2.f * kld_err);
      const float b = 2.f / (9.f * fmaxf(kf - 1.f, 1.f));
      const float c = 1.f - b + sqrtf(b) * kld_z;
      int mx = (int)floorf(a * c * c * c);
      mx = k > 1 ? mx : M;
      const int m = i + 1;
      if (m >= min_p && m >= mx && done_at == M) done_at = m;
    }
    n = block_min(done_at, shi);
  } else {
    n = min(max(n_in[0], 0), M);
  }

  // inject_free_space: injected particles take the active mean weight.
  float wsum = 0.f;
  if (mode & 2) {
    for (int i = ch.lo; i < ch.hi; ++i) wsum += i < n ? w_in[i] : 0.f;
  }
  const float neutral = (mode & 2) ? block_sum(wsum, sh) / (float)max(n, 1)
                                   : 0.f;
  const float p_inject = (mode & 2) ? scal[0] : 0.f;
  for (int i = ch.lo; i < ch.hi; ++i) {
    float x = parts[3 * i], y = parts[3 * i + 1], t = parts[3 * i + 2];
    float wi = w_in[i];
    if ((mode & 2) && u_sel[i] < p_inject && i < n) {
      const int f = inj_idx[i];
      x = free_xy[2 * f] + jitter[2 * i] * free_cell;
      y = free_xy[2 * f + 1] + jitter[2 * i + 1] * free_cell;
      t = theta[i];
      wi = neutral;
    }
    out_p[3 * i] = x;
    out_p[3 * i + 1] = y;
    out_p[3 * i + 2] = t;
    out_w[i] = wi;
  }
  __syncthreads();

  // update_statistics over the first n particles.
  float acc = 0.f;
  for (int i = ch.lo; i < ch.hi; ++i) acc += i < n ? out_w[i] : 0.f;
  const float total = block_sum(acc, sh);
  const float uni = 1.f / (float)max(n, 1);
  float sx = 0.f, sy = 0.f, sc = 0.f, ss = 0.f, cxx = 0.f, cxy = 0.f,
        cyy = 0.f;
  for (int i = ch.lo; i < ch.hi; ++i) {
    const float wi = i < n ? out_w[i] : 0.f;
    const float p = total != 0.f ? wi / total : (i < n ? uni : 0.f);
    out_wn[i] = p;
    const float x = out_p[3 * i], y = out_p[3 * i + 1], t = out_p[3 * i + 2];
    const float px = p * x, py = p * y;
    sx += px;
    sy += py;
    sc += p * cosf(t);
    ss += p * sinf(t);
    cxx += px * x;
    cxy += px * y;
    cyy += py * y;
  }
  const float mx = block_sum(sx, sh), my = block_sum(sy, sh);
  const float scos = block_sum(sc, sh), ssin = block_sum(ss, sh);
  const float r00 = block_sum(cxx, sh), r01 = block_sum(cxy, sh),
              r11 = block_sum(cyy, sh);
  const float mth = atan2f(ssin, scos);
  float dd = 0.f;
  for (int i = ch.lo; i < ch.hi; ++i) {
    const float d = normalize_angle(mth - out_p[3 * i + 2]);
    dd += out_wn[i] * d * d;
  }
  const float cth = block_sum(dd, sh);
  if (threadIdx.x == 0) {
    n_out[0] = n;
    stats[0] = (float)n;
    stats[1] = mx;
    stats[2] = my;
    stats[3] = mth;
    stats[4] = r00 - mx * mx;
    stats[5] = r01 - mx * my;
    stats[6] = 0.f;
    stats[7] = r01 - my * mx;
    stats[8] = r11 - my * my;
    stats[9] = 0.f;
    stats[10] = 0.f;
    stats[11] = 0.f;
    stats[12] = cth;
  }
}

}  // namespace

// particles [M,3] f32, noise [M,3] f32 -> out [M,3] f32.
NDT2D_API int ndt2d_pf_motion(const void* particles, const void* noise, int M,
                              float rot1, float trans, float rot2,
                              float s_rot1, float s_trans, float s_rot2,
                              void* out, void* stream) {
  pf_motion<<<(M + kThreads - 1) / kThreads, kThreads, 0,
              reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(particles), static_cast<const float*>(noise),
      M, rot1, trans, rot2, s_rot1, s_trans, s_rot2,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// The resample chain: weights [M] f32 (raw), n_in [1] i32 (active mask),
// uniforms [M] f32, particles [M,3] f32; scratch cdf [M] f32, samp [M,3],
// samp_w [M] f32, keys [M,3] i32, slot [M] i32, owner/first [T] i32 (T a
// power of two >= 2M), scal [1] f32.  Recovery (recovery != 0): wstate [2]
// f32 (w_slow, w_fast) goes to wstate_out [2], updated from the weights
// first when ewma != 0; injection draws u_sel [M] f32, inj_idx [M] i32,
// jitter [M,2] f32, theta [M] f32 over free_xy [F,2] f32.  Outputs: idx [M]
// i32, marks [M] u8, out_p [M,3], out_w [M] (raw), out_wn [M] (normalized),
// n_out [1] i32, stats [13] f32.
NDT2D_API int ndt2d_pf_resample(
    const void* weights, const void* n_in, const void* uniforms,
    const void* particles, int M, int levels, float bx, float by, float bt,
    float kld_err, float kld_z, int min_p, int recovery, int ewma,
    float alpha_slow, float alpha_fast, const void* wstate,
    void* wstate_out, const void* free_xy,
    float free_cell, const void* u_sel, const void* inj_idx,
    const void* jitter, const void* theta, void* cdf, void* samp,
    void* samp_w, void* keys, void* slot, void* owner, void* first, int T,
    void* scal, void* idx, void* marks, void* out_p, void* out_w,
    void* out_wn, void* n_out, void* stats, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  pf_cdf<<<1, kBlock, 0, st>>>(
      static_cast<const float*>(weights), static_cast<const int*>(n_in), M,
      recovery, ewma, alpha_slow, alpha_fast,
      static_cast<const float*>(wstate), static_cast<float*>(wstate_out),
      static_cast<float*>(cdf), static_cast<float*>(scal));
  const int span = max(M, T);
  pf_draw<<<(span + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(cdf), static_cast<const float*>(uniforms), M,
      levels, static_cast<const float*>(particles),
      static_cast<const float*>(weights), bx, by, bt, T,
      static_cast<float*>(samp), static_cast<float*>(samp_w),
      static_cast<int*>(keys), static_cast<int*>(idx),
      static_cast<int*>(owner), static_cast<int*>(first));
  pf_hash<<<(M + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const int*>(keys), M, T, static_cast<int*>(owner),
      static_cast<int*>(first), static_cast<int*>(slot));
  pf_finish<<<1, kBlock, 0, st>>>(
      static_cast<const float*>(samp), static_cast<const float*>(samp_w),
      nullptr, M, 1 | (recovery ? 2 : 0), static_cast<const int*>(first),
      static_cast<const int*>(slot), kld_err, kld_z, min_p,
      static_cast<const float*>(scal), static_cast<const float*>(free_xy),
      free_cell, static_cast<const float*>(u_sel),
      static_cast<const int*>(inj_idx), static_cast<const float*>(jitter),
      static_cast<const float*>(theta), static_cast<float*>(out_p),
      static_cast<float*>(out_w), static_cast<float*>(out_wn),
      static_cast<int*>(n_out), static_cast<float*>(stats),
      static_cast<uint8_t*>(marks));
  return (int)cudaGetLastError();
}

// The w_slow/w_fast EWMAs alone (ParticleFilter.measure): pf_cdf's recovery
// path on raw weights [M] f32 over the first n_in [1] i32, wstate [2] f32 ->
// wstate_out [2] f32; the CDF and p_inject land in scratch cdf [M], scal [1].
NDT2D_API int ndt2d_pf_ewma(const void* weights, const void* n_in, int M,
                            float alpha_slow, float alpha_fast,
                            const void* wstate, void* wstate_out, void* cdf,
                            void* scal, void* stream) {
  pf_cdf<<<1, kBlock, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(weights), static_cast<const int*>(n_in), M,
      1, 1, alpha_slow, alpha_fast, static_cast<const float*>(wstate),
      static_cast<float*>(wstate_out), static_cast<float*>(cdf),
      static_cast<float*>(scal));
  return (int)cudaGetLastError();
}

// update_statistics (inject == 0) or inject_free_space + update_statistics
// (inject != 0, p_inject in scal [1] f32) over the first n_in [1] i32 of
// particles [M,3] f32 with raw weights [M] f32.  Outputs as
// ndt2d_pf_resample's.
NDT2D_API int ndt2d_pf_statistics(
    const void* particles, const void* weights, const void* n_in, int M,
    int inject, const void* scal, const void* free_xy, float free_cell,
    const void* u_sel, const void* inj_idx, const void* jitter,
    const void* theta, void* out_p, void* out_w, void* out_wn, void* n_out,
    void* stats, void* stream) {
  pf_finish<<<1, kBlock, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(particles),
      static_cast<const float*>(weights), static_cast<const int*>(n_in), M,
      inject ? 2 : 0, nullptr, nullptr, 0.f, 0.f, 0,
      static_cast<const float*>(scal), static_cast<const float*>(free_xy),
      free_cell, static_cast<const float*>(u_sel),
      static_cast<const int*>(inj_idx), static_cast<const float*>(jitter),
      static_cast<const float*>(theta), static_cast<float*>(out_p),
      static_cast<float*>(out_w), static_cast<float*>(out_wn),
      static_cast<int*>(n_out), static_cast<float*>(stats), nullptr);
  return (int)cudaGetLastError();
}
