// K4: Levenberg-Marquardt normal-equation blocks and the PCG matvec of the
// pose-graph solve, deterministic.
//
// Replaces the jitted XLA programs of the JAX package's
// ndt_2d_tpu/graph/solver.py: robust_weights + _normal_blocks +
// _gather_gradient_and_diag (entry ndt2d_normal_blocks) and the matvec of
// _pcg_solve (entry ndt2d_pcg_matvec).
//
// What it computes.  Per constraint k = (a, b): the residual
// r = (R(th_a)^T (p_b - p_a) - t_xy, normalize(th_b - th_a - t_th)), the
// analytic 3x3 Jacobians Ja, Jb, the robust (IRLS) weight w of the
// information matrix, Lw = cmask ? w * Lambda : 0, and the blocks
// Baa = Ja^T Lw Ja, Bab = Ja^T Lw Jb, Bbb = Jb^T Lw Jb, ga = Ja^T Lw r,
// gb = Jb^T Lw r.  Per node n: g = sum_{begin=n} ga + sum_{end=n} gb and
// D = sum_{begin=n} Baa + sum_{end=n} Bbb.  The matvec y = A v of the
// damped system sums sum_{begin=n} (Baa v_n + Bab v_b) +
// sum_{end=n} (Bab^T v_a + Bbb v_n), adds lam * D_ii v_i and applies the
// free-node mask.
//
// What bounds it on the card: memory.  A constraint reads 3 + 3 + 9 floats
// and writes 33; a node's matvec gathers 27 floats per incident constraint.
// The arithmetic is a few hundred flops per constraint.  The node sums are
// the hard part: a scatter with float atomics changes its summation order
// from run to run, and the LM accept/reject chain then varies run to run.
// Design: one thread per constraint computes its blocks (every dot product
// summed j = 0, 1, 2, as the plain-PyTorch twin writes it), then one thread
// per node walks its incidence lists - the constraint ids that begin (end)
// at the node, in constraint order, built once per solve by a stable sort -
// and sums in that order from 0: the same float additions as the twin and
// as the reference's sequential segment_sum.  Constraints outside cmask
// are left out of the lists: their blocks are exact zeros, and adding a
// zero to a sum that starts at +0 changes no bit.  The matvec needs no
// scratch: the Baa/Bab half of a constraint is used only at its begin node
// and the Bab^T/Bbb half only at its end node, so each node computes its
// own terms while it walks its lists.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

enum RobustLoss { kNone = 0, kHuber = 1, kGemanMcClure = 2 };

// core/pose.py::normalize_angle.
__device__ __forceinline__ float normalize_angle(float t) {
  return t - kTwoPi * floorf((t + kPi) / kTwoPi);
}

// x0 y0 + x1 y1 + x2 y2, summed in that order.
__device__ __forceinline__ float dot3(float x0, float x1, float x2, float y0,
                                      float y1, float y2) {
  return (x0 * y0 + x1 * y1) + x2 * y2;
}

// C = A^T B for row-major 3x3 (C_ik = sum_j A_ji B_jk).
__device__ __forceinline__ void at_b(const float* A, const float* B,
                                     float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      C[3 * i + k] = dot3(A[i], A[3 + i], A[6 + i], B[k], B[3 + k], B[6 + k]);
}

// C = A B (C_ik = sum_j A_ij B_jk).
__device__ __forceinline__ void a_b(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      C[3 * i + k] = dot3(A[3 * i], A[3 * i + 1], A[3 * i + 2], B[k],
                          B[3 + k], B[6 + k]);
}

__device__ __forceinline__ void load3(const float* p, float* v) {
  v[0] = p[0];
  v[1] = p[1];
  v[2] = p[2];
}

__global__ void constraint_blocks(
    const float* __restrict__ poses, const int* __restrict__ begin,
    const int* __restrict__ end, const float* __restrict__ transform,
    const float* __restrict__ information, const uint8_t* __restrict__ cmask,
    const uint8_t* __restrict__ robust_mask, int loss, float delta, int C,
    float* __restrict__ baa, float* __restrict__ bab, float* __restrict__ bbb,
    float* __restrict__ ga, float* __restrict__ gb) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= C) return;
  const float* pa = poses + 3 * begin[k];
  const float* pb = poses + 3 * end[k];
  const float* t = transform + 3 * k;
  // solver.py::residuals.
  const float dx = pb[0] - pa[0], dy = pb[1] - pa[1];
  const float c = cosf(pa[2]), s = sinf(pa[2]);
  float r[3];
  r[0] = (c * dx + s * dy) - t[0];
  r[1] = (-s * dx + c * dy) - t[1];
  r[2] = normalize_angle((pb[2] - pa[2]) - t[2]);
  // solver.py::_jacobian_blocks.
  const float ja[9] = {-c, -s, -s * dx + c * dy,
                       s,  -c, -c * dx - s * dy,
                       0.f, 0.f, -1.f};
  const float jb[9] = {c, s, 0.f, -s, c, 0.f, 0.f, 0.f, 1.f};
  // solver.py::robust_weights: s2 = r^T Lambda r.
  const float* lam = information + 9 * k;
  float w = 1.f;
  if (loss != kNone && robust_mask[k]) {
    float l_r[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      l_r[i] = dot3(lam[3 * i], lam[3 * i + 1], lam[3 * i + 2], r[0], r[1],
                    r[2]);
    const float s2 = dot3(r[0], r[1], r[2], l_r[0], l_r[1], l_r[2]);
    if (loss == kHuber) {
      // max(s2, 1e-20) that keeps a NaN, as jnp.maximum and torch.clamp do.
      const float sn = sqrtf(s2 < 1e-20f ? 1e-20f : s2);
      w = sn > delta ? delta / sn : 1.f;
    } else {
      const float tt = 1.f + s2 / (delta * delta);
      w = 1.f / (tt * tt);
    }
  }
  // solver.py::_normal_blocks on Lw = cmask ? w Lambda : 0.
  const bool live = cmask[k];
  float lw[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) lw[i] = live ? lam[i] * w : 0.f;
  float lja[9], ljb[9], m[9];
  a_b(lw, ja, lja);
  a_b(lw, jb, ljb);
  at_b(ja, lja, m);
#pragma unroll
  for (int i = 0; i < 9; ++i) baa[9 * k + i] = m[i];
  at_b(ja, ljb, m);
#pragma unroll
  for (int i = 0; i < 9; ++i) bab[9 * k + i] = m[i];
  at_b(jb, ljb, m);
#pragma unroll
  for (int i = 0; i < 9; ++i) bbb[9 * k + i] = m[i];
  float lr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    lr[i] = dot3(lw[3 * i], lw[3 * i + 1], lw[3 * i + 2], r[0], r[1], r[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    ga[3 * k + i] = dot3(ja[i], ja[3 + i], ja[6 + i], lr[0], lr[1], lr[2]);
    gb[3 * k + i] = dot3(jb[i], jb[3 + i], jb[6 + i], lr[0], lr[1], lr[2]);
  }
}

// solver.py::_gather_gradient_and_diag over the incidence lists.
__global__ void node_sums(const int* __restrict__ b_ptr,
                          const int* __restrict__ b_idx,
                          const int* __restrict__ e_ptr,
                          const int* __restrict__ e_idx, int N,
                          const float* __restrict__ baa,
                          const float* __restrict__ bbb,
                          const float* __restrict__ ga,
                          const float* __restrict__ gb, float* __restrict__ g,
                          float* __restrict__ d) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float g0[3] = {0.f, 0.f, 0.f}, d0[9] = {0.f};
  for (int q = b_ptr[n]; q < b_ptr[n + 1]; ++q) {
    const int k = b_idx[q];
#pragma unroll
    for (int i = 0; i < 3; ++i) g0[i] += ga[3 * k + i];
#pragma unroll
    for (int i = 0; i < 9; ++i) d0[i] += baa[9 * k + i];
  }
  float g1[3] = {0.f, 0.f, 0.f}, d1[9] = {0.f};
  for (int q = e_ptr[n]; q < e_ptr[n + 1]; ++q) {
    const int k = e_idx[q];
#pragma unroll
    for (int i = 0; i < 3; ++i) g1[i] += gb[3 * k + i];
#pragma unroll
    for (int i = 0; i < 9; ++i) d1[i] += bbb[9 * k + i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) g[3 * n + i] = g0[i] + g1[i];
#pragma unroll
  for (int i = 0; i < 9; ++i) d[9 * n + i] = d0[i] + d1[i];
}

// y = B x for a row-major 3x3 block (y_i = sum_j B_ij x_j).
__device__ __forceinline__ void bx(const float* B, const float* x, float* y) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    y[i] = dot3(B[3 * i], B[3 * i + 1], B[3 * i + 2], x[0], x[1], x[2]);
}

// y = B^T x (y_i = sum_j B_ji x_j).
__device__ __forceinline__ void btx(const float* B, const float* x,
                                    float* y) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    y[i] = dot3(B[i], B[3 + i], B[6 + i], x[0], x[1], x[2]);
}

// The masked node vector v_n * fm_n.
__device__ __forceinline__ void masked(const float* v, const float* fm, int n,
                                       float* out) {
  load3(v + 3 * n, out);
  const float f = fm[n];
  out[0] *= f;
  out[1] *= f;
  out[2] *= f;
}

// solver.py::_pcg_solve matvec.
__global__ void matvec(const int* __restrict__ b_ptr,
                       const int* __restrict__ b_idx,
                       const int* __restrict__ e_ptr,
                       const int* __restrict__ e_idx, int N,
                       const int* __restrict__ begin,
                       const int* __restrict__ end,
                       const float* __restrict__ baa,
                       const float* __restrict__ bab,
                       const float* __restrict__ bbb,
                       const float* __restrict__ diag,
                       const float* __restrict__ lam,
                       const float* __restrict__ fm,
                       const float* __restrict__ v, float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float vn[3], vo[3], y0[3], y1[3];
  masked(v, fm, n, vn);
  float sa[3] = {0.f, 0.f, 0.f};
  for (int q = b_ptr[n]; q < b_ptr[n + 1]; ++q) {
    const int k = b_idx[q];
    masked(v, fm, end[k], vo);
    bx(baa + 9 * k, vn, y0);
    bx(bab + 9 * k, vo, y1);
#pragma unroll
    for (int i = 0; i < 3; ++i) sa[i] += y0[i] + y1[i];
  }
  float sb[3] = {0.f, 0.f, 0.f};
  for (int q = e_ptr[n]; q < e_ptr[n + 1]; ++q) {
    const int k = e_idx[q];
    masked(v, fm, begin[k], vo);
    btx(bab + 9 * k, vo, y0);
    bx(bbb + 9 * k, vn, y1);
#pragma unroll
    for (int i = 0; i < 3; ++i) sb[i] += y0[i] + y1[i];
  }
  const float l = lam[0];
  const float f = fm[n];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float di = diag[9 * n + 4 * i] * vn[i];
    out[3 * n + i] = ((sa[i] + sb[i]) + l * di) * f;
  }
}

}  // namespace

// poses [N,3] f32, begin/end [C] i32 (in [0, N)), transform [C,3] f32,
// information [C,3,3] f32, cmask/robust_mask [C] u8, loss (0 none, 1 huber,
// 2 geman_mcclure), delta; incidence lists b_ptr/e_ptr [N+1] i32,
// b_idx/e_idx i32; out: baa/bab/bbb [C,3,3], ga/gb [C,3], g [N,3],
// d [N,3,3] f32.
NDT2D_API int ndt2d_normal_blocks(
    const void* poses, const void* begin, const void* end,
    const void* transform, const void* information, const void* cmask,
    const void* robust_mask, int loss, float delta, int C, const void* b_ptr,
    const void* b_idx, const void* e_ptr, const void* e_idx, int N,
    void* baa, void* bab, void* bbb, void* ga, void* gb, void* g, void* d,
    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (C > 0)
    constraint_blocks<<<(C + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        static_cast<const float*>(poses), static_cast<const int*>(begin),
        static_cast<const int*>(end), static_cast<const float*>(transform),
        static_cast<const float*>(information),
        static_cast<const uint8_t*>(cmask),
        static_cast<const uint8_t*>(robust_mask), loss, delta, C,
        static_cast<float*>(baa), static_cast<float*>(bab),
        static_cast<float*>(bbb), static_cast<float*>(ga),
        static_cast<float*>(gb));
  node_sums<<<(N + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const int*>(b_ptr), static_cast<const int*>(b_idx),
      static_cast<const int*>(e_ptr), static_cast<const int*>(e_idx), N,
      static_cast<const float*>(baa), static_cast<const float*>(bbb),
      static_cast<const float*>(ga), static_cast<const float*>(gb),
      static_cast<float*>(g), static_cast<float*>(d));
  return (int)cudaGetLastError();
}

// Incidence lists as above; begin/end [C] i32; baa/bab/bbb [C,3,3],
// diag [N,3,3], lam [1], fm [N], v [N,3] f32; out [N,3] f32.
NDT2D_API int ndt2d_pcg_matvec(const void* b_ptr, const void* b_idx,
                               const void* e_ptr, const void* e_idx, int N,
                               const void* begin, const void* end,
                               const void* baa, const void* bab,
                               const void* bbb, const void* diag,
                               const void* lam, const void* fm, const void* v,
                               void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  matvec<<<(N + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const int*>(b_ptr), static_cast<const int*>(b_idx),
      static_cast<const int*>(e_ptr), static_cast<const int*>(e_idx), N,
      static_cast<const int*>(begin), static_cast<const int*>(end),
      static_cast<const float*>(baa), static_cast<const float*>(bab),
      static_cast<const float*>(bbb), static_cast<const float*>(diag),
      static_cast<const float*>(lam), static_cast<const float*>(fm),
      static_cast<const float*>(v), static_cast<float*>(out));
  return (int)cudaGetLastError();
}
