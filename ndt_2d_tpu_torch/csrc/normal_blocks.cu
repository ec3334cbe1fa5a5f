// K4: Levenberg-Marquardt normal-equation blocks and the PCG matvec of the
// pose-graph solve, deterministic.
//
// Replaces the jitted XLA programs of the JAX package's
// ndt_2d_tpu/graph/solver.py: robust_weights + _normal_blocks +
// _gather_gradient_and_diag (entry ndt2d_normal_blocks), the matvec of
// _pcg_solve (entry ndt2d_pcg_matvec) and the whole lax.while_loop of
// _pcg_solve (entry ndt2d_pcg_solve; its dot products alone:
// ndt2d_fixed_dot), the same loop on a mesh as three planned launches a
// step (ndt2d_cg_matvec_planned, ndt2d_cg_damp_planned,
// ndt2d_cg_update_planned), _dense_solve's assembly of the damped dense
// system (entry ndt2d_dense_system, a mesh's), the blocks, node sums and
// assembly of one device's dense LM iteration in one launch (entry
// ndt2d_dense_normal_system), the blocks, node sums, block-Jacobi
// preconditioner and right-hand side of one device's PCG LM iteration in
// one launch (entry ndt2d_pcg_normal_system; the preconditioner alone after
// a mesh's combine: ndt2d_preconditioner), and _robust_cost with the accept
// and update
// of the LM loop's body, lm_step (entry ndt2d_lm_step: one block where the
// costs fit the default 48 KB of shared memory, every dense solve, else
// one cooperative launch, as the district's PCG solve).  A planned
// solve packs the last two once and launches them by pointer
// (ndt2d_dense_normal_system_planned, ndt2d_lm_step_planned).
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
//
// The PCG solve (ndt2d_pcg_solve).  Run as a host loop, a CG step is about
// ten launches and a blocking read of the residual norm; its work is ~14 MB
// of reads (the blocks of ~55,000 constraints and ~30 floats a node of the
// 50,000-node district), ~4 us at 3.35 TB/s, all of it in the 50 MB L2.
// So the cost is the host, and the design keeps the whole loop in one
// cooperative launch: a persistent grid (at most as many blocks as fit
// co-resident) runs each step's phases - the matvec (a thread a node, the
// walk above; from the second step the direction update p = z + beta p is
// formed where the matvec reads it), the dot p.Ap, the x / r / z updates,
// the dots r.z and r.r - between grid syncs, and tests the reference's stop
// condition, sqrt(r.r) > tol && it < max_iter, on the device before every
// step.  Its dots add in a layout that does not depend on the grid: lane l
// of kLanes adds the products e = l, l + kLanes, ... of the flattened [3N]
// vectors in index order from +0, and a fixed halving tree (partial i + h
// into partial i, h = kLanes / 2, ..., 1) folds the lanes.  Every block
// folds the same partials in the same order after a sync, so all blocks
// hold the same alpha, beta and stop decision, and the bits depend neither
// on the SM count nor on the occupancy.  A lane's adds are a serial chain,
// so a block takes a group of 32 lanes: all its threads load the group's
// products into shared memory at once, then a warp adds them in order
// (two dots, r.z and r.r, in one pass by two warps).  The plain-PyTorch twin
// (kernels/normal_blocks.py::pcg_solve_twin, fixed_dot_twin) writes the same
// operations in the same order.  Data the kernel writes is read back
// through L2 (__ldcg), never through a stale L1 line.
//
// The mesh's CG loop.  On a mesh every CG product is a rank's partial,
// summed over the ranks between the matvec and the rest of the step, so the
// loop cannot live in one launch; eager, a step was ~22 PyTorch kernels
// around two hand ones (the damping, alpha and beta, the x / r / p
// updates, the preconditioner, the stop test).  A step is now three
// ordinary launches, each one ctypes call of arguments packed once a solve
// (kernels/normal_blocks.py::CgPlan), then the combine and one read of the
// stop flag: (1) the matvec (cg_matvec, a thread a node over lists of
// (constraint, other node) pairs, forming the direction z + beta p where
// it reads it and writing its node's), (2) variant (A) of the dots (the
// combined partial damped element by element, p . Ap, alpha), (3) variant
// (B) (x, r and z element by element, r . z, r . r, beta, the stop flag).
// A dot launch (lane_dots) is kGroups ordinary blocks in the lane layout
// above: each forms its group's lane partials, takes a ticket after a
// fence, and the last block to finish folds all the lanes in the fixed
// tree and writes the scalars, so no grid sync and no cooperative launch
// is needed and which block folds changes no bit.  The arithmetic is
// pcg's and pcg_loop's, operation for operation.
//
// The dense system (ndt2d_dense_system).  Eager, it is ~10 passes over the
// (3N)^2 matrix (zeros, one scatter a round of duplicate pairs, the
// diagonal updates, the mask, a permuting copy) and ~40 launches.  What
// bounds it is writing the matrix once: (3N)^2 x 4 bytes, 9.4 MB at
// N = 512.  A block takes a node row i: it maps each column node j of the
// row's node-pair slots (a per-row table of the sorted slot keys, built
// once per solve on the device) to the slot's first entry in shared
// memory, then writes its three rows once, float4 by float4, each element
// computed whole: the slot's entries from +0 in their sorted order (every
// Bab of the pair in constraint order, then every Bab^T), then the
// diagonal's D and damping and the free-node mask in the twin's order
// (kernels/normal_blocks.py::dense_system_twin).  On a mesh the pair sums
// are added over ranks between the sum and the rest, so a launch writes
// the sums, K12's rank_sum adds them, and a second launch finishes the
// matrix in place.
//
// The dense normal system (ndt2d_dense_normal_system).  On one device the
// blocks, the node sums and the assembly were three launches: a thread a
// constraint (4 blocks at 1024 constraints), a thread a node (2 blocks at
// 512 nodes), then the system, evaluating every one of the (3N)^2
// elements though nearly all are empty slots.  Baa, Bbb, ga and gb are
// read only by their own nodes' sums, and Bab only by its rows' slots, so
// one launch forms them where they are used: a block a node row zero-fills
// its rows (the write bound), sums its D and g from its incidence lists in
// the node sums' order, and writes its few nonzero blocks, each entry's
// Bab recomputed by the same constraint_terms (a few hundred flops against
// 36 bytes of blocks per use).  A block's lists and slots are the row's
// degree, so a hub of any degree is chunked, never capped.
//
// The PCG normal system (ndt2d_pcg_normal_system).  One device's PCG
// iteration was normal_blocks' two launches (constraint_blocks writing 33
// floats a constraint at 36-byte strides a thread, node_sums reading Baa,
// Bbb, ga and gb back as scattered records), then ~10 eager kernels for
// the preconditioner (a batched cuBLAS inverse whose status read synced
// the device, and a host->device copy of 1e-8).  pcg_solve reads Baa, Bab,
// Bbb, D, pinv and b, nothing of ga and gb.  One launch now forms them: a
// constraint block writes its constraints' three blocks through shared
// memory (coalesced stores), and a node block forms each node's D and g
// as dense_normal_system does, its incident constraints' terms formed
// again by constraint_terms (the district's ~2 a node) instead of read
// back, then the damped 3x3 block's inverse by three LU solves (solve3.cuh,
// bitwise on the CPU and the card, where cuBLAS and LAPACK round
// differently) and b = -g fm, written through shared memory.  lam is read
// on the device: no upload, no read.  What bounds it is bytes: the inputs
// once, 108 bytes of blocks a constraint and 84 a node written.
//
// The LM step (ndt2d_lm_step).  Eager, the robust cost of the step and
// the accept/update are ~60 launches and two host->device scalar copies.
// The work is ~80 bytes a constraint, so launches bound it at the dense
// path's sizes.  One cooperative launch forms the step's cost a constraint
// (poses + delta, NaN where the factorization failed, folded in), a thread
// a constraint, into a scratch row; after a grid sync one thread of block 0
// adds the row in constraint order from +0 (the twin:
// kernels/normal_blocks.py::ordered_sum_twin; the reference's XLA:CPU
// reduce adds a small cost in that order, and a tree order parts from its
// LM iteration count on a flat-valley graph), staged through shared
// memory; after a second sync every block decides the accept and writes
// its poses, and block 0 the damping, cost, stall count and flags.  The
// serial add chain (C add latencies, ~2.5 ns each) is the floor at the
// district's 10^5 constraints.  Neither the grid nor the padding (a
// masked constraint adds +0) changes the bits.  The scalars are
// arguments: no host->device copy.  Up to 12287 constraints (every dense
// solve) the same step runs as one ordinary block (lm_step_block): the
// costs stay in its shared memory and __syncthreads replaces the grid
// syncs, with the same cost and update bodies and the same add order.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"
#include "solve3.cuh"

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

// The constraint terms' inputs: poses [N,3], begin/end [C], transform
// [C,3], information [C,3,3], cmask/robust_mask [C], the robust loss and
// its delta.
struct Graph {
  const float* poses;
  const int *begin, *end;
  const float *transform, *information;
  const uint8_t *cmask, *robust_mask;
  int loss;
  float delta;
};

// Constraint k's blocks Baa, Bab, Bbb (row-major 3x3) and gradients ga, gb.
struct Terms {
  float baa[9], bab[9], bbb[9], ga[3], gb[3];
};

// The terms of constraint k at the poses: the residual, its Jacobians, the
// robust weight and the five blocks.  Every kernel that needs a block calls
// this one function (the compiler drops the blocks a caller leaves unread),
// so a block's bits never depend on which kernel formed it.
__device__ __forceinline__ Terms constraint_terms(const Graph& g, int k) {
  const float* pa = g.poses + 3 * g.begin[k];
  const float* pb = g.poses + 3 * g.end[k];
  const float* t = g.transform + 3 * k;
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
  const float* lam = g.information + 9 * k;
  float w = 1.f;
  if (g.loss != kNone && g.robust_mask[k]) {
    float l_r[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      l_r[i] = dot3(lam[3 * i], lam[3 * i + 1], lam[3 * i + 2], r[0], r[1],
                    r[2]);
    const float s2 = dot3(r[0], r[1], r[2], l_r[0], l_r[1], l_r[2]);
    if (g.loss == kHuber) {
      // max(s2, 1e-20) that keeps a NaN, as jnp.maximum and torch.clamp do.
      const float sn = sqrtf(s2 < 1e-20f ? 1e-20f : s2);
      w = sn > g.delta ? g.delta / sn : 1.f;
    } else {
      const float tt = 1.f + s2 / (g.delta * g.delta);
      w = 1.f / (tt * tt);
    }
  }
  // solver.py::_normal_blocks on Lw = cmask ? w Lambda : 0.
  const bool live = g.cmask[k];
  float lw[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) lw[i] = live ? lam[i] * w : 0.f;
  float lja[9], ljb[9];
  a_b(lw, ja, lja);
  a_b(lw, jb, ljb);
  Terms out;
  at_b(ja, lja, out.baa);
  at_b(ja, ljb, out.bab);
  at_b(jb, ljb, out.bbb);
  float lr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    lr[i] = dot3(lw[3 * i], lw[3 * i + 1], lw[3 * i + 2], r[0], r[1], r[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out.ga[i] = dot3(ja[i], ja[3 + i], ja[6 + i], lr[0], lr[1], lr[2]);
    out.gb[i] = dot3(jb[i], jb[3 + i], jb[6 + i], lr[0], lr[1], lr[2]);
  }
  return out;
}

__global__ void constraint_blocks(const Graph g, int C,
                                  float* __restrict__ baa,
                                  float* __restrict__ bab,
                                  float* __restrict__ bbb,
                                  float* __restrict__ ga,
                                  float* __restrict__ gb) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= C) return;
  const Terms c = constraint_terms(g, k);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    baa[9 * k + i] = c.baa[i];
    bab[9 * k + i] = c.bab[i];
    bbb[9 * k + i] = c.bbb[i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    ga[3 * k + i] = c.ga[i];
    gb[3 * k + i] = c.gb[i];
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

// The node vector v_n (read by `load`) times the free-node mask fm_n.
template <class Load>
__device__ __forceinline__ void masked(const Load& load, const float* fm,
                                       int n, float* out) {
  load(n, out);
  const float f = fm[n];
  out[0] *= f;
  out[1] *= f;
  out[2] *= f;
}

// v_n of a plain vector [N, 3].
struct Plain {
  const float* v;
  __device__ __forceinline__ void operator()(int n, float* out) const {
    load3(v + 3 * n, out);
  }
};

// Row n of the damped product A v (solver.py::_pcg_solve matvec): the
// begin list's Baa v_n + Bab v_b, then the end list's Bab^T v_a + Bbb v_n,
// each summed in constraint order from 0, plus lam D_ii v_i, times fm_n.
template <class Load>
__device__ __forceinline__ void matvec_row(
    const int* __restrict__ b_ptr, const int* __restrict__ b_idx,
    const int* __restrict__ e_ptr, const int* __restrict__ e_idx,
    const int* __restrict__ begin, const int* __restrict__ end,
    const float* __restrict__ baa, const float* __restrict__ bab,
    const float* __restrict__ bbb, const float* __restrict__ diag, float l,
    const float* __restrict__ fm, const Load& v, int n, float y[3]) {
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
  const float f = fm[n];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float di = diag[9 * n + 4 * i] * vn[i];
    y[i] = ((sa[i] + sb[i]) + l * di) * f;
  }
}

// --- The PCG solve ----------------------------------------------------------

namespace cg = cooperative_groups;

// Lanes of a dot product; a fold block holds kPer partials a thread.
constexpr int kLanes = 2048;
constexpr int kPer = kLanes / kThreads;
static_assert(kPer * kThreads == kLanes && (kPer & (kPer - 1)) == 0,
              "the fold takes kLanes / kThreads partials a thread");
// A block forms the partials of a group of 32 lanes, staging up to
// kStageRows of the group's rows of products (row k = elements
// k kLanes + 32 grp .. + 31) in shared memory at a time.
constexpr int kGroups = kLanes / 32;
constexpr int kStageRows = 128;

// The partials of D dots x_d . y_d over n floats for the 32 lanes of group
// `grp`: the block loads up to kStageRows rows of the group's products at
// once (all loads into registers first, then the stores to `stage` [D, m,
// 32]; a product past n is +0), then warp d's lane l adds dot d's column l
// row by row, continuing from +0: lane 32 grp + l adds the products e =
// 32 grp + l, + kLanes, ... in index order.  Lane partials go to
// lanes[d][32 grp + l].  Every thread of the block calls it.
template <int D>
__device__ __forceinline__ void group_partials(const float* const* x,
                                               const float* const* y, int n,
                                               int grp, float* stage,
                                               float* const* lanes) {
  constexpr int kLoads = kStageRows * 32 / kThreads;
  const int rows = (n + kLanes - 1) / kLanes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int r0 = 0; r0 < rows; r0 += kStageRows) {
    const int m = min(kStageRows, rows - r0);
    float v[D][kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = threadIdx.x + kThreads * j;  // row i / 32, lane i % 32
      const int e = (r0 + i / 32) * kLanes + 32 * grp + (i & 31);
#pragma unroll
      for (int d = 0; d < D; ++d)
        v[d][j] = i < 32 * m && e < n ? __ldcg(x[d] + e) * __ldcg(y[d] + e)
                                      : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = threadIdx.x + kThreads * j;
#pragma unroll
      for (int d = 0; d < D; ++d)
        if (i < 32 * m) stage[d * 32 * m + i] = v[d][j];
    }
    __syncthreads();
    if (warp < D) {
      const float* col = stage + warp * 32 * m + lane;
#pragma unroll 8
      for (int rr = 0; rr < m; ++rr) acc += col[32 * rr];
    }
    __syncthreads();
  }
  if (warp < D) __stcg(lanes[warp] + 32 * grp + lane, acc);
}

// group_partials' partials of the launches' dots (lane_dots), whose
// products a Step forms element by element (Step::load, then Step::apply,
// which may also write the element's results), in the same order: a
// product past n is +0, and warp d's lane l adds dot d's column l of the
// staged rows row by row, continuing from +0.  A thread loads the inputs
// of a batch of Step::kBatch of its elements before it forms and stores
// any of them, so a Step that writes keeps that many loads in flight.
// (pcg keeps group_partials: this form, with its Step, costs pcg's loop
// registers and stack, and its time.)
template <int D, class Step>
__device__ __forceinline__ void step_partials(const Step& s, int n, int grp,
                                              float* stage,
                                              float* const* lanes) {
  constexpr int kLoads = kStageRows * 32 / kThreads;
  constexpr int kBatch = Step::kBatch;
  static_assert(kLoads % kBatch == 0, "a batch divides the slots");
  const int rows = (n + kLanes - 1) / kLanes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int r0 = 0; r0 < rows; r0 += kStageRows) {
    const int m = min(kStageRows, rows - r0);
    for (int j0 = 0; j0 < kLoads; j0 += kBatch) {
      typename Step::In in[kBatch] = {};
      int es[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = threadIdx.x + kThreads * (j0 + b);  // row i / 32
        const int e = (r0 + i / 32) * kLanes + 32 * grp + (i & 31);
        es[b] = i < 32 * m && e < n ? e : -1;
        if (es[b] >= 0) in[b] = s.load(es[b]);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = threadIdx.x + kThreads * (j0 + b);
        float pr[D];
#pragma unroll
        for (int d = 0; d < D; ++d) pr[d] = 0.f;
        if (es[b] >= 0) s.apply(es[b], in[b], pr);
        if (i < 32 * m) {
#pragma unroll
          for (int d = 0; d < D; ++d) stage[d * 32 * m + i] = pr[d];
        }
      }
    }
    __syncthreads();
    if (warp < D) {
      const float* col = stage + warp * 32 * m + lane;
#pragma unroll 8
      for (int rr = 0; rr < m; ++rr) acc += col[32 * rr];
    }
    __syncthreads();
  }
  if (warp < D) __stcg(lanes[warp] + 32 * grp + lane, acc);
}

// The products x_d[e] y_d[e] of D dots, read through L2.
template <int D>
struct Products {
  const float* x[2];
  const float* y[2];
  static constexpr int kBatch = 16;
  struct In {
    float x[D], y[D];
  };
  __device__ __forceinline__ In load(int e) const {
    In in;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      in.x[d] = __ldcg(x[d] + e);
      in.y[d] = __ldcg(y[d] + e);
    }
    return in;
  }
  __device__ __forceinline__ void apply(int, const In& in, float* pr) const {
#pragma unroll
    for (int d = 0; d < D; ++d) pr[d] = in.x[d] * in.y[d];
  }
};

// The halving tree over D sets of kLanes partials (lane i + h into lane i,
// h = kLanes / 2, ..., 1): thread t loads partials t + kThreads k; levels
// kLanes / 2 .. kThreads fold in registers, kThreads / 2 .. 32 in shared
// memory, 16 .. 1 by shuffles in warp 0.  Every thread of the block gets
// the D totals.  scratch: D (kThreads + 1) floats.
template <int D>
__device__ __forceinline__ void fold_lanes(const float* const* lanes,
                                           float* scratch, float total[D]) {
  const int t = threadIdx.x;
  float v[D][kPer];
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      v[d][k] = __ldcg(lanes[d] + t + kThreads * k);
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

// v_n of a vector the kernel writes, read through L2.
struct Cached {
  const float* v;
  __device__ __forceinline__ void operator()(int n, float* out) const {
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] = __ldcg(v + 3 * n + i);
  }
};

// The zero vector (the CG start x = 0).
struct Zero {
  __device__ __forceinline__ void operator()(int, float* out) const {
    out[0] = out[1] = out[2] = 0.f;
  }
};

// The updated direction z_n + beta p_n from the previous one.
struct Direction {
  const float* z;
  const float* p;
  float beta;
  __device__ __forceinline__ void operator()(int n, float* out) const {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      out[i] = __ldcg(z + 3 * n + i) + beta * __ldcg(p + 3 * n + i);
  }
};

// The block-Jacobi preconditioner: z_n = (pinv_n r_n) fm_n.
__device__ __forceinline__ void precondition(const float* __restrict__ pinv,
                                             const float* __restrict__ fm,
                                             int n, const float r[3],
                                             float z[3]) {
  const float* m = pinv + 9 * n;
  const float f = fm[n];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    z[i] = dot3(m[3 * i], m[3 * i + 1], m[3 * i + 2], r[0], r[1], r[2]) * f;
}

// torch.maximum(a, b) for a b that is not NaN: a NaN a is kept.
__device__ __forceinline__ float max_keep_nan(float a, float b) {
  return a != a ? a : (a > b ? a : b);
}

struct Pcg {
  const int *b_ptr, *b_idx, *e_ptr, *e_idx, *begin, *end;
  const float *baa, *bab, *bbb, *diag, *lam, *fm, *pinv, *b;
  int N, max_iter;
  float tol;
  // Outputs x [N,3] and the step count; scratch r, z, p, q, ap [N,3] and the
  // lane partials of p.Ap, r.z and r.r [3, kLanes].
  float *x, *r, *z, *p, *q, *ap, *part;
  int* iters;
};

// solver.py::_pcg_solve's whole loop in one cooperative launch.
__global__ void __launch_bounds__(kThreads) pcg(const Pcg a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float stage[2 * kStageRows * 32];
  __shared__ float scratch[2 * (kThreads + 1)];
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int nth = gridDim.x * kThreads;
  const int N = a.N, n3 = 3 * N;
  const float l = a.lam[0];
  const float tiny = 1e-30f;
  float* const pap[1] = {a.part};
  float* const rzz[2] = {a.part + kLanes, a.part + 2 * kLanes};
  // The lane partials of p.Ap, and of r.z and r.r together.
  auto dot_pap = [&](const float* p) {
    const float* xs[1] = {p};
    const float* ys[1] = {a.ap};
    for (int grp = blockIdx.x; grp < kGroups; grp += gridDim.x)
      group_partials<1>(xs, ys, n3, grp, stage, pap);
  };
  auto dot_rz_rr = [&]() {
    const float* xs[2] = {a.r, a.r};
    const float* ys[2] = {a.z, a.r};
    for (int grp = blockIdx.x; grp < kGroups; grp += gridDim.x)
      group_partials<2>(xs, ys, n3, grp, stage, rzz);
  };
#define NDT2D_ROW(load, n, y)                                                \
  matvec_row(a.b_ptr, a.b_idx, a.e_ptr, a.e_idx, a.begin, a.end, a.baa,      \
             a.bab, a.bbb, a.diag, l, a.fm, load, n, y)

  // x = 0, r = b - A x, z = P r, p = z.
  for (int n = tid; n < N; n += nth) {
    float ax[3], rn[3], zn[3];
    NDT2D_ROW(Zero{}, n, ax);
#pragma unroll
    for (int i = 0; i < 3; ++i) rn[i] = a.b[3 * n + i] - ax[i];
    precondition(a.pinv, a.fm, n, rn, zn);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      a.x[3 * n + i] = 0.f;
      a.r[3 * n + i] = rn[i];
      a.z[3 * n + i] = zn[i];
      a.p[3 * n + i] = zn[i];
    }
  }
  grid.sync();
  dot_rz_rr();
  grid.sync();
  float t2[2];
  fold_lanes<2>(rzz, scratch, t2);
  float rz = t2[0], rr = t2[1];
  float beta = 0.f;
  float* p = a.p;  // the direction, and the buffer of the next one
  float* q = a.q;
  int it = 0;
  while (sqrtf(rr) > a.tol && it < a.max_iter) {
    // ap = A p; from the second step on, p = z + beta p is formed here.
    if (it == 0) {
      for (int n = tid; n < N; n += nth) {
        float y[3];
        NDT2D_ROW(Cached{p}, n, y);
#pragma unroll
        for (int i = 0; i < 3; ++i) a.ap[3 * n + i] = y[i];
      }
    } else {
      const Direction d{a.z, p, beta};
      for (int n = tid; n < N; n += nth) {
        float y[3], pn[3];
        NDT2D_ROW(d, n, y);
        d(n, pn);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          a.ap[3 * n + i] = y[i];
          q[3 * n + i] = pn[i];
        }
      }
      float* t = p;
      p = q;
      q = t;
    }
    grid.sync();
    dot_pap(p);
    grid.sync();
    float t1[1];
    fold_lanes<1>(pap, scratch, t1);
    const float alpha = rz / max_keep_nan(t1[0], tiny);
    for (int n = tid; n < N; n += nth) {
      // Every load before the first store, which the compiler cannot
      // move them past.
      float xn[3], pn[3], rn[3], an[3], m[9], zn[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        xn[i] = __ldcg(a.x + 3 * n + i);
        pn[i] = __ldcg(p + 3 * n + i);
        rn[i] = __ldcg(a.r + 3 * n + i);
        an[i] = __ldcg(a.ap + 3 * n + i);
      }
#pragma unroll
      for (int i = 0; i < 9; ++i) m[i] = a.pinv[9 * n + i];
      const float f = a.fm[n];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        xn[i] = xn[i] + alpha * pn[i];
        rn[i] = rn[i] - alpha * an[i];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i)
        zn[i] = dot3(m[3 * i], m[3 * i + 1], m[3 * i + 2], rn[0], rn[1],
                     rn[2]) * f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        a.x[3 * n + i] = xn[i];
        a.r[3 * n + i] = rn[i];
        a.z[3 * n + i] = zn[i];
      }
    }
    grid.sync();
    dot_rz_rr();
    grid.sync();
    fold_lanes<2>(rzz, scratch, t2);
    const float rz_new = t2[0];
    rr = t2[1];
    beta = rz_new / max_keep_nan(rz, tiny);
    rz = rz_new;
    ++it;
  }
#undef NDT2D_ROW
  if (tid == 0) *a.iters = it;
}

// --- The mesh's CG loop -----------------------------------------------------

// The damped product y = A v at lam (a zero for a mesh rank's undamped
// partial), a thread a node, as matvec_row sums it, but walking lists of
// (constraint, other node) pairs built once a solve: the other node comes
// with the constraint id, so a list entry is two dependent loads (the
// pair, then the blocks and the other node's v) where matvec_row's walk
// is three.  With z it is the loop's direction update too: v is z +
// beta p from the previous direction p, formed as pcg's Direction forms
// it wherever it is read, and the node's thread writes its own to p_out.
// kernels/normal_blocks.py::CgPlan packs one a launch shape; the public
// ndt2d_pcg_matvec fills one a call.
struct CgMatvec {
  const int *b_ptr, *e_ptr;     // Incidence
  const int2 *b_pair, *e_pair;  // (constraint, other node) in list order
  const float *baa, *bab, *bbb, *diag, *lam, *fm;
  const float* v;     // v, or the previous direction (with z)
  const float* z;     // null: plain v
  const float* beta;  // with z
  float* p_out;       // with z: the direction formed
  float* out;
  int N;
};

// Row n of the product: matvec_row's sums in its order.
template <class Load>
__device__ __forceinline__ void pair_row(const CgMatvec& a, const Load& v,
                                         float l, int n, float y[3]) {
  float vn[3], vo[3], y0[3], y1[3];
  masked(v, a.fm, n, vn);
  float sa[3] = {0.f, 0.f, 0.f};
  for (int q = a.b_ptr[n]; q < a.b_ptr[n + 1]; ++q) {
    const int2 ko = a.b_pair[q];
    masked(v, a.fm, ko.y, vo);
    bx(a.baa + 9 * ko.x, vn, y0);
    bx(a.bab + 9 * ko.x, vo, y1);
#pragma unroll
    for (int i = 0; i < 3; ++i) sa[i] += y0[i] + y1[i];
  }
  float sb[3] = {0.f, 0.f, 0.f};
  for (int q = a.e_ptr[n]; q < a.e_ptr[n + 1]; ++q) {
    const int2 ko = a.e_pair[q];
    masked(v, a.fm, ko.y, vo);
    btx(a.bab + 9 * ko.x, vo, y0);
    bx(a.bbb + 9 * ko.x, vn, y1);
#pragma unroll
    for (int i = 0; i < 3; ++i) sb[i] += y0[i] + y1[i];
  }
  const float f = a.fm[n];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float di = a.diag[9 * n + 4 * i] * vn[i];
    y[i] = ((sa[i] + sb[i]) + l * di) * f;
  }
}

// The direction z_n + beta p_n as pcg's Direction forms it, from vectors
// that earlier launches wrote (plain loads, which L1 may serve).
struct Formed {
  const float* z;
  const float* p;
  float beta;
  __device__ __forceinline__ void operator()(int n, float* out) const {
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] = z[3 * n + i] + beta * p[3 * n + i];
  }
};

// solver.py::_pcg_solve's matvec (the standalone launch: pcg keeps
// matvec_row), with the direction update where the plan asks for it.
__global__ void __launch_bounds__(kThreads) cg_matvec(const CgMatvec a) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= a.N) return;
  const float l = *a.lam;
  float y[3];
  if (a.z) {
    const Formed d{a.z, a.v, *a.beta};
    pair_row(a, d, l, n, y);
    float pn[3];
    d(n, pn);
#pragma unroll
    for (int i = 0; i < 3; ++i) a.p_out[3 * n + i] = pn[i];
  } else {
    pair_row(a, Plain{a.v}, l, n, y);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) a.out[3 * n + i] = y[i];
}

// The lane partials of a dot launch (D kLanes floats), the ticket that
// picks the block which folds them (0 between launches) and the floats of
// each vector.
struct Lanes {
  float* lanes;
  unsigned* ticket;
  int n;
};

// D dots of a Step in one ordinary launch of kGroups blocks: block grp
// forms lane group grp's partials; the last block to finish (the one that
// takes the last ticket, after every block's partials are visible) folds
// all the lanes in fold_lanes' tree, hands the totals to the Step and
// resets the ticket.  Which block folds changes no bit: the fold reads the
// same partials in the same order.
template <int D, class Step>
__global__ void __launch_bounds__(kThreads) lane_dots(const Step a) {
  __shared__ float stage[D * kStageRows * 32];
  __shared__ float scratch[D * (kThreads + 1)];
  __shared__ bool last;
  const Step s = a.ready();
  float* ls[D];
#pragma unroll
  for (int d = 0; d < D; ++d) ls[d] = s.dots.lanes + d * kLanes;
  step_partials<D>(s, s.dots.n, blockIdx.x, stage, ls);
  __threadfence();  // this block's partials before its ticket
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(s.dots.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float total[D];
  fold_lanes<D>(ls, scratch, total);
  if (threadIdx.x == 0) {
    s.finish(total);
    *s.dots.ticket = 0u;
  }
}

// The public dots x_d . y_d (ndt2d_fixed_dot): the totals into out [D].
template <int D>
struct PairDots : Products<D> {
  Lanes dots;
  float* out;
  __device__ __forceinline__ PairDots ready() const { return *this; }
  __device__ __forceinline__ void finish(const float* t) const {
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = t[d];
  }
};

// The planned loop's scalars on the device (kernels/normal_blocks.py::
// CgPlan): alpha, beta, r.z, r.r, p.Ap, and a zero (the lam of a mesh
// rank's undamped partial).
enum CgScalar { kAlpha = 0, kBeta = 1, kRz = 2, kRr = 3, kPap = 4,
                kZeroLam = 5 };
constexpr float kTiny = 1e-30f;

// The loop's first dots launch, variant (A): Ap = (part + lam (D_ii
// (p fm))) fm from the combined partial, then p . Ap; the folding block
// writes p . Ap and alpha = r.z / max(p . Ap, 1e-30).  The expressions
// and their order are _pcg_solve's mesh branch's and pcg_loop's.
struct CgDamp {
  Lanes dots;
  const float *part, *p, *diag, *fm, *lam;
  float *ap, *sc;
  float l;  // *lam, read at launch
  static constexpr int kBatch = 16;
  struct In {
    float p, part, f, d;
  };
  __device__ __forceinline__ CgDamp ready() const {
    CgDamp s = *this;
    s.l = *lam;
    return s;
  }
  __device__ __forceinline__ In load(int e) const {
    const int n = e / 3, c = e - 3 * n;
    In in;
    in.p = p[e];
    in.part = part[e];
    in.f = fm[n];
    in.d = diag[9 * n + 4 * c];
    return in;
  }
  __device__ __forceinline__ void apply(int e, const In& in,
                                        float* pr) const {
    const float a = (in.part + l * (in.d * (in.p * in.f))) * in.f;
    ap[e] = a;
    pr[0] = in.p * a;
  }
  __device__ __forceinline__ void finish(const float* t) const {
    sc[kPap] = t[0];
    sc[kAlpha] = sc[kRz] / max_keep_nan(t[0], kTiny);
  }
};

// The loop's second dots launch, variant (B): x += alpha p, r -= alpha Ap
// and z = (pinv r) fm in pcg's expressions (the first launch of a solve:
// r = b - Ap, z = (pinv r) fm and p = z, x staying 0), then r . z and
// r . r; the folding block writes them, beta = r.z / max(the previous
// r.z, 1e-30) and the stop flag sqrt(r.r) > tol.  An element's z needs
// its node's whole r, whose other elements other blocks update, so r is
// read from r_in and written to r_out (two buffers, swapped a step).
struct CgUpdate {
  Lanes dots;
  const float *r_in, *ap, *p, *pinv, *fm;  // r_in: b on the first launch
  float *x, *r_out, *z, *p_out, *sc;       // p_out: the first launch's p
  int* stop;
  float tol;
  int first;
  float alpha;  // sc[kAlpha], read at launch
  static constexpr int kBatch = 8;
  struct In {
    float r[3], a[3], m[3], f, x, p;
  };
  __device__ __forceinline__ CgUpdate ready() const {
    CgUpdate s = *this;
    s.alpha = first ? 0.f : sc[kAlpha];
    return s;
  }
  __device__ __forceinline__ In load(int e) const {
    const int n = e / 3, c = e - 3 * n;
    In in;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      in.r[i] = r_in[3 * n + i];
      in.a[i] = ap[3 * n + i];
      in.m[i] = pinv[9 * n + 3 * c + i];
    }
    in.f = fm[n];
    in.x = first ? 0.f : x[e];
    in.p = first ? 0.f : p[e];
    return in;
  }
  __device__ __forceinline__ void apply(int e, const In& in,
                                        float* pr) const {
    const int c = e - 3 * (e / 3);
    float rn[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      rn[i] = first ? in.r[i] - in.a[i] : in.r[i] - alpha * in.a[i];
    const float zn =
        dot3(in.m[0], in.m[1], in.m[2], rn[0], rn[1], rn[2]) * in.f;
    const float re = c == 0 ? rn[0] : c == 1 ? rn[1] : rn[2];
    if (first)
      p_out[e] = zn;
    else
      x[e] = in.x + alpha * in.p;
    r_out[e] = re;
    z[e] = zn;
    pr[0] = re * zn;
    pr[1] = re * re;
  }
  __device__ __forceinline__ void finish(const float* t) const {
    if (!first) sc[kBeta] = t[0] / max_keep_nan(sc[kRz], kTiny);
    sc[kRz] = t[0];
    sc[kRr] = t[1];
    *stop = sqrtf(t[1]) > tol;
  }
};


// --- The dense LM system ----------------------------------------------------

// Rows of the dense system a launch takes: a block's slot table holds one
// int a node in (default) shared memory.
constexpr int kDenseMaxN = 12288;

struct Dense {
  const long long* keys;  // [2C] sorted slot keys i n + j (n n: masked)
  const int* src;         // [2C] entry: s < C Bab_s, else Bab_{s-C}^T
  const int* row_ptr;     // [n + 1] row i's sorted positions
  const float *bab, *diag, *g, *lam, *fm;
  int n, C, phase;  // 0 all, 1 the pair sums alone, 2 finish hm in place
  float *hm, *rhs;
};

// An element of node-pair slot (i, j) from its pair sum v: as the twin
// does, + D_ab (d), + lam (D_ab e + 1e-12 e) with e = [ai == b], times
// fm_i, times fm_i again, + (1 - fm_i) e on the diagonal slot, and times
// fm_i then fm_j elsewhere.  Each operation rounds once, in this order, so
// -0 and NaN come out as the twin's.
__device__ __forceinline__ float finish_element(float v, bool diag, bool e,
                                                float d, float fi, float fj,
                                                float l) {
  if (!diag) return (v * fi) * fj;
  const float ef = e ? 1.f : 0.f;
  v = v + d;
  v = v + l * (d * ef + static_cast<float>(1e-12) * ef);
  v = (v * fi) * fi;
  return v + (1.f - fi) * ef;
}

// Element (3i + ai, c) of the system: node-pair slot (i, j = c / 3), entry
// (ai, b = c % 3).  The slot's entries add from +0 in their sorted order
// (phase 2 starts from `prior`, the combined sum), then finish_element.
__device__ __forceinline__ float dense_value(const Dense& a, int i, int ai,
                                             int c, float fi, float l,
                                             int hi, const int* slot,
                                             float prior) {
  const int j = c / 3, b = c - 3 * j;
  float v = prior;
  if (a.phase != 2) {
    v = 0.f;
    const int p0 = slot[j];
    if (p0 >= 0) {
      const long long key = a.keys[p0];
      for (int p = p0; p < hi && a.keys[p] == key; ++p) {
        const int s = a.src[p];
        v = v + (s < a.C ? a.bab[9 * s + 3 * ai + b]
                         : a.bab[9 * (s - a.C) + 3 * b + ai]);
      }
    }
    if (a.phase == 1) return v;
  }
  if (j != i) return finish_element(v, false, false, 0.f, fi, a.fm[j], l);
  return finish_element(v, true, ai == b, a.diag[9 * i + 3 * ai + b], fi, fi,
                        l);
}

// solver.py::_dense_solve's assembly, a block a node row i: its rows
// 3i .. 3i + 2 of hm (3 x 3n floats, contiguous) are written once, in
// float4 stores where a row's length allows, after the block has mapped
// each column node j of its pair slots to the slot's first sorted entry.
__global__ void __launch_bounds__(kThreads) dense_system(const Dense a) {
  extern __shared__ int slot[];
  const int i = blockIdx.x, n = a.n, w = 3 * n;
  const int lo = a.row_ptr[i], hi = a.row_ptr[i + 1];
  if (a.phase != 2) {
    for (int j = threadIdx.x; j < n; j += kThreads) slot[j] = -1;
    __syncthreads();
    const long long base = (long long)i * n;
    for (int p = lo + threadIdx.x; p < hi; p += kThreads)
      if (p == lo || a.keys[p] != a.keys[p - 1])
        slot[(int)(a.keys[p] - base)] = p;
    __syncthreads();
  }
  const float fi = a.fm[i];
  const float l = a.phase == 1 ? 0.f : a.lam[0];
  float* row = a.hm + (size_t)3 * i * w;
  if ((w & 3) == 0) {
    float4* row4 = reinterpret_cast<float4*>(row);
    for (int q = threadIdx.x; q < 3 * w / 4; q += kThreads) {
      const int ai = 4 * q / w, c = 4 * q - ai * w;
      const float4 prior =
          a.phase == 2 ? row4[q] : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 v;
      v.x = dense_value(a, i, ai, c, fi, l, hi, slot, prior.x);
      v.y = dense_value(a, i, ai, c + 1, fi, l, hi, slot, prior.y);
      v.z = dense_value(a, i, ai, c + 2, fi, l, hi, slot, prior.z);
      v.w = dense_value(a, i, ai, c + 3, fi, l, hi, slot, prior.w);
      row4[q] = v;
    }
  } else {
    for (int q = threadIdx.x; q < 3 * w; q += kThreads) {
      const int ai = q / w, c = q - ai * w;
      row[q] = dense_value(a, i, ai, c, fi, l, hi, slot,
                           a.phase == 2 ? row[q] : 0.f);
    }
  }
  if (a.phase != 1 && threadIdx.x < 3)
    a.rhs[3 * i + threadIdx.x] = -a.g[3 * i + threadIdx.x] * fi;
}

// --- The dense normal system ------------------------------------------------

struct DenseNormal {
  Graph g;
  int C, n;
  const int *b_ptr, *b_idx, *e_ptr, *e_idx;  // Incidence
  const long long* keys;                      // Pairs
  const int *src, *row_ptr;
  const float *lam, *fm;
  float *hm, *rhs;
};

// Whether sorted keys[lo, hi) hold `key`.
__device__ __forceinline__ bool has_key(const long long* keys, int lo, int hi,
                                        long long key) {
  int a = lo, b = hi;
  while (a < b) {
    const int mid = a + (b - a) / 2;
    if (keys[mid] < key)
      a = mid + 1;
    else
      b = mid;
  }
  return a < hi && keys[a] == key;
}

// Node-pair slot (i, j)'s 3x3 block of the system from its pair sum v:
// finish_element on each entry, D_i from the block's node sums (`part`:
// the begin list's 12 sums, then the end list's).
__device__ __forceinline__ void write_block(const DenseNormal& a, float* row,
                                            size_t w, int i, int j,
                                            const float* v, const float* part,
                                            float fi, float l) {
  const bool diag = j == i;
  const float fj = diag ? fi : a.fm[j];
#pragma unroll
  for (int ai = 0; ai < 3; ++ai)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int e = 3 * ai + b;
      const float d = diag ? part[e] + part[12 + e] : 0.f;
      row[ai * w + 3 * j + b] =
          finish_element(v[e], diag, ai == b, d, fi, fj, l);
    }
}

// Threads of a dense-normal-system block, and the constraints it stages
// at a time; 128 keep 8 blocks an SM, so 1024 rows run in one wave.
constexpr int kDnThreads = 128;

// solver.py's _normal_blocks + _gather_gradient_and_diag + _dense_solve's
// assembly in one launch, a block a node row i.  (1) It zero-fills its
// three rows of hm: an empty slot's element is (+0 fi) fm_j = +0, so only
// the row's nonzero blocks need more.  (2) It forms D_i and g_i as
// node_sums does: its threads compute the terms of i's begin list, then
// its end list, kDnThreads constraints a chunk, staged in shared memory,
// and 24 threads (12 components a list) add each component over the chunk
// in list order, carried from chunk to chunk from +0; D_i = d0 + d1 and
// g_i = g0 + g1.  (3) After a sync, a thread takes each slot head among
// the row's sorted positions of Pairs, adds the slot's entries from +0 in
// sorted order (each Bab_k formed on the fly by constraint_terms,
// transposed for an entry past C) and writes the slot's 9 elements as
// dense_system does; thread 0 writes the diagonal block from +0 where the
// row has no self-loop slot.  (4) rhs = -g_i fm_i.  Every sum is the three
// kernels' sum in their order, so the bits are theirs.
__global__ void __launch_bounds__(kDnThreads, 8)
    dense_normal_system(const DenseNormal a) {
  // A staged component's row is padded by a float, so the 24 adding
  // threads read 24 banks.
  constexpr int kRow = kDnThreads + 1;
  __shared__ float stage[12 * kRow];
  __shared__ float part[24];
  const int i = blockIdx.x, n = a.n, t = threadIdx.x;
  const size_t w = 3 * (size_t)n;
  float* row = a.hm + 3 * (size_t)i * w;
  if ((n & 3) == 0) {
    float4* row4 = reinterpret_cast<float4*>(row);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (size_t q = t; q < 3 * w / 4; q += kDnThreads) row4[q] = zero;
  } else {
    for (size_t q = t; q < 3 * w; q += kDnThreads) row[q] = 0.f;
  }
  const int b0 = a.b_ptr[i], nb = a.b_ptr[i + 1] - b0;
  const int e0 = a.e_ptr[i], items = nb + a.e_ptr[i + 1] - e0;
  const bool end_list = t >= 12;
  const float* col = stage + (t % 12) * kRow;
  float acc = 0.f;
  for (int c0 = 0; c0 < items; c0 += kDnThreads) {
    const int m = min(kDnThreads, items - c0);
    if (t < m) {
      const int q = c0 + t;
      const bool at_begin = q < nb;
      const Terms c = constraint_terms(
          a.g, at_begin ? a.b_idx[b0 + q] : a.e_idx[e0 + q - nb]);
#pragma unroll
      for (int r = 0; r < 9; ++r)
        stage[r * kRow + t] = at_begin ? c.baa[r] : c.bbb[r];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        stage[(9 + r) * kRow + t] = at_begin ? c.ga[r] : c.gb[r];
    }
    __syncthreads();
    if (t < 24) {
      const int lo = end_list ? max(nb - c0, 0) : 0;
      const int hi = end_list ? m : min(nb - c0, m);
      for (int p = lo; p < hi; ++p) acc = acc + col[p];
    }
    __syncthreads();
  }
  if (t < 24) part[t] = acc;
  __syncthreads();
  const float fi = a.fm[i], l = a.lam[0];
  const int lo = a.row_ptr[i], hi = a.row_ptr[i + 1];
  const long long base = (long long)i * n;
  for (int p = lo + t; p < hi; p += kDnThreads) {
    const long long key = a.keys[p];
    if (p != lo && a.keys[p - 1] == key) continue;
    float v[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int q = p; q < hi && a.keys[q] == key; ++q) {
      const int s = a.src[q];
      const bool tr = s >= a.C;
      const Terms c = constraint_terms(a.g, tr ? s - a.C : s);
#pragma unroll
      for (int ai = 0; ai < 3; ++ai)
#pragma unroll
        for (int b = 0; b < 3; ++b)
          v[3 * ai + b] =
              v[3 * ai + b] + (tr ? c.bab[3 * b + ai] : c.bab[3 * ai + b]);
    }
    write_block(a, row, w, i, (int)(key - base), v, part, fi, l);
  }
  if (t == 0 && !has_key(a.keys, lo, hi, base + i)) {
    const float v[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    write_block(a, row, w, i, i, v, part, fi, l);
  }
  if (t < 3) a.rhs[3 * i + t] = -(part[9 + t] + part[21 + t]) * fi;
}

// --- The PCG normal system -------------------------------------------------

// The damped block-Jacobi inverse of one node's diagonal block d (row-major
// 3x3), _pcg_solve's (solver.py:197-199): dd = d + lam (d o I) + 1e-8 I,
// plus I where the node is fixed (fm = 0), each element in JAX's expression
// order; column j of pinv is solve3(dd, e_j) (LU with partial pivoting,
// the twin's matching/newton.py::solve3).  A singular or NaN block gives
// inf / NaN, as jnp.linalg.inv does, and raises nothing.
__device__ __forceinline__ void damped_inverse(const float* d, float lam,
                                               float fm, float* pinv) {
  float dd[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.f : 0.f;
      const float v = d[3 * i + j];
      dd[i][j] = ((v + lam * (v * e)) + 1e-8f * e) + (1.f - fm) * e;
    }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float a[3][3], b[3], x[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int k = 0; k < 3; ++k) a[i][k] = dd[i][k];
      b[i] = i == j ? 1.f : 0.f;
    }
    solve3(a, b, x);
#pragma unroll
    for (int i = 0; i < 3; ++i) pinv[3 * i + j] = x[i];
  }
}

// The arguments of one device's PCG normal system (ndt2d_pcg_normal_system;
// kernels/normal_blocks.py::PcgPlan mirrors it).
struct PcgSystem {
  Graph g;
  int C, N;
  const int *b_ptr, *b_idx, *e_ptr, *e_idx;  // Incidence
  const float *lam, *fm;
  float *baa, *bab, *bbb;  // [C,3,3]
  float *d, *pinv, *b;     // [N,3,3], [N,3,3], [N,3]
};

// Words of a block's staged outputs: a constraint block's three 3x3 blocks
// for kThreads constraints, or a node block's D, pinv and b.
constexpr int kSysStage = 27 * kThreads;

// Writes a block's m staged records of `width` floats (`stage`, record t
// at width t) to out from record `first` on, consecutive threads on
// consecutive words.
__device__ __forceinline__ void store_staged(float* __restrict__ out,
                                             size_t first, int m, int width,
                                             const float* stage) {
  for (int q = threadIdx.x; q < width * m; q += kThreads)
    out[width * first + q] = stage[q];
}

// solver.py's _normal_blocks + _gather_gradient_and_diag + _pcg_solve's
// preconditioner and right-hand side (:197-199, :215) in one launch of
// ceil(C / kThreads) constraint blocks, then ceil(N / kThreads) node
// blocks.  A constraint block forms its constraints' Baa, Bab and Bbb (a
// thread a constraint, constraint_terms) and writes them through shared
// memory, so the stores coalesce.  A node block's thread n sums D_n and
// g_n over its incidence lists in node_sums' order (the begin list's Baa
// and ga from +0, the end list's Bbb and gb from +0, then their sums),
// each term formed again by constraint_terms instead of read back; then
// pinv_n (damped_inverse at lam, read on the device) and b_n = -g_n fm_n,
// and the block writes D, pinv and b through shared memory.  No float
// atomics, and no block waits on another: the sums are node_sums' and the
// blocks constraint_blocks', bit for bit.
__global__ void __launch_bounds__(kThreads) pcg_normal_system(
    const PcgSystem a) {
  __shared__ float stage[kSysStage];
  const int t = threadIdx.x;
  const int cblocks = (a.C + kThreads - 1) / kThreads;
  if ((int)blockIdx.x < cblocks) {
    const int k0 = blockIdx.x * kThreads, m = min(kThreads, a.C - k0);
    if (t < m) {
      const Terms c = constraint_terms(a.g, k0 + t);
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        stage[9 * t + i] = c.baa[i];
        stage[9 * (kThreads + t) + i] = c.bab[i];
        stage[9 * (2 * kThreads + t) + i] = c.bbb[i];
      }
    }
    __syncthreads();
    store_staged(a.baa, k0, m, 9, stage);
    store_staged(a.bab, k0, m, 9, stage + 9 * kThreads);
    store_staged(a.bbb, k0, m, 9, stage + 18 * kThreads);
    return;
  }
  const int n0 = (blockIdx.x - cblocks) * kThreads;
  const int m = min(kThreads, a.N - n0);
  if (t < m) {
    const int n = n0 + t;
    float g0[3] = {0.f, 0.f, 0.f}, d0[9] = {0.f};
    for (int q = a.b_ptr[n]; q < a.b_ptr[n + 1]; ++q) {
      const Terms c = constraint_terms(a.g, a.b_idx[q]);
#pragma unroll
      for (int i = 0; i < 3; ++i) g0[i] += c.ga[i];
#pragma unroll
      for (int i = 0; i < 9; ++i) d0[i] += c.baa[i];
    }
    float g1[3] = {0.f, 0.f, 0.f}, d1[9] = {0.f};
    for (int q = a.e_ptr[n]; q < a.e_ptr[n + 1]; ++q) {
      const Terms c = constraint_terms(a.g, a.e_idx[q]);
#pragma unroll
      for (int i = 0; i < 3; ++i) g1[i] += c.gb[i];
#pragma unroll
      for (int i = 0; i < 9; ++i) d1[i] += c.bbb[i];
    }
    float dn[9], pinv[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) dn[i] = d0[i] + d1[i];
    const float fm = a.fm[n];
    damped_inverse(dn, a.lam[0], fm, pinv);
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      stage[9 * t + i] = dn[i];
      stage[9 * (kThreads + t) + i] = pinv[i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
      stage[18 * kThreads + 3 * t + i] = -(g0[i] + g1[i]) * fm;
  }
  __syncthreads();
  store_staged(a.d, n0, m, 9, stage);
  store_staged(a.pinv, n0, m, 9, stage + 9 * kThreads);
  store_staged(a.b, n0, m, 3, stage + 18 * kThreads);
}

// The preconditioner alone, a thread a node (a mesh's, after the combine
// has summed g and D over the ranks): damped_inverse and b = -g fm, as
// pcg_normal_system's node blocks form them.
__global__ void __launch_bounds__(kThreads) precondition_nodes(
    const float* __restrict__ g, const float* __restrict__ d,
    const float* __restrict__ lam, const float* __restrict__ fm, int N,
    float* __restrict__ pinv, float* __restrict__ b) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  float dn[9], p[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) dn[i] = d[9 * n + i];
  const float f = fm[n];
  damped_inverse(dn, lam[0], f, p);
#pragma unroll
  for (int i = 0; i < 9; ++i) pinv[9 * n + i] = p[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) b[3 * n + i] = -g[3 * n + i] * f;
}

// --- The LM step ------------------------------------------------------------

enum LmMode { kCost = 0, kStep = 1, kUpdate = 2 };

struct Lm {
  int mode;
  float* poses;        // [N,3], updated in place (kStep, kUpdate)
  const float* delta;  // [N,3] or null (the cost of poses)
  const int* info;     // the factorization's status, or null
  const int *begin, *end;
  const float *transform, *information;
  const uint8_t *cmask, *robust_mask;
  int loss;
  float hdelta;
  int C, N;
  float* rho;             // [C + 1] the cost a constraint, then the sum
  float* out;             // kCost: the cost
  const float* new_cost;  // kUpdate: the (combined) cost of the step
  float *lam, *cost;
  int* stall;
  uint8_t* flags;  // accept, improved
  float down, up, tol;
};

// Node n of poses + delta, delta NaN where the factorization failed.
__device__ __forceinline__ void stepped(const Lm& a, bool ok, int n,
                                        float* p) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = a.poses[3 * n + i];
    if (a.delta)
      p[i] = p[i] + (ok ? a.delta[3 * n + i] : __int_as_float(0x7fc00000));
  }
}

// solver.py::_robust_cost of constraint k, 0 off cmask.
__device__ __forceinline__ float robust_rho(const Lm& a, bool ok, int k) {
  if (!a.cmask[k]) return 0.f;
  float pa[3], pb[3];
  stepped(a, ok, a.begin[k], pa);
  stepped(a, ok, a.end[k], pb);
  const float* t = a.transform + 3 * k;
  const float dx = pb[0] - pa[0], dy = pb[1] - pa[1];
  const float c = cosf(pa[2]), s = sinf(pa[2]);
  float r[3];
  r[0] = (c * dx + s * dy) - t[0];
  r[1] = (-s * dx + c * dy) - t[1];
  r[2] = normalize_angle((pb[2] - pa[2]) - t[2]);
  const float* lam = a.information + 9 * k;
  float l_r[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    l_r[i] = dot3(lam[3 * i], lam[3 * i + 1], lam[3 * i + 2], r[0], r[1],
                  r[2]);
  const float s2 = dot3(r[0], r[1], r[2], l_r[0], l_r[1], l_r[2]);
  if (a.loss == kNone || !a.robust_mask[k]) return s2;
  const float d = a.hdelta;
  if (a.loss == kHuber) {
    const float sn = sqrtf(s2 < static_cast<float>(1e-20)
                               ? static_cast<float>(1e-20) : s2);
    return sn > d ? d * (2.f * sn - d) : s2;
  }
  return s2 / (1.f + s2 / (d * d));
}

// Floats of the cost row block 0 stages at a time for its ordered sum.
constexpr int kSumChunk = 4096;

// x[0] + ... + x[n - 1] in index order from +0, in thread 0 of the calling
// block (every thread calls it): the block stages kSumChunk floats at a
// time in shared memory, and thread 0 adds them one by one.
__device__ __forceinline__ float ordered_sum(const float* x, int n,
                                             float* stage) {
  float acc = 0.f;
  for (int c0 = 0; c0 < n; c0 += kSumChunk) {
    const int m = min(kSumChunk, n - c0);
    for (int i = threadIdx.x; i < m; i += kThreads)
      stage[i] = __ldcg(x + c0 + i);
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll 8
      for (int i = 0; i < m; ++i) acc = acc + stage[i];
    }
    __syncthreads();
  }
  return acc;
}

// lm_step's accept and update (solver.py:303-315) from the step's total
// cost, given the state the launch started from (cost, lam, stall):
// thread tid of nth writes its share of the poses where the step is
// accepted, and thread 0 writes lam, cost, stall and the flags.  Both
// variants call it, so their bits cannot part.
__device__ __forceinline__ void lm_update(const Lm& a, bool ok, float total,
                                          float cost, float lam, int stall,
                                          int tid, int nth) {
  const bool accept = total < cost;
  if (accept)
    for (int n = tid; n < a.N; n += nth) {
      float p[3];
      stepped(a, ok, n, p);
#pragma unroll
      for (int i = 0; i < 3; ++i) a.poses[3 * n + i] = p[i];
    }
  if (tid == 0) {
    // torch.clamp(lam, 1e-12, 1e8), which keeps a NaN.
    float l = accept ? lam * a.down : lam * a.up;
    if (l == l)
      l = fminf(fmaxf(l, static_cast<float>(1e-12)), static_cast<float>(1e8));
    const bool improved =
        fabsf(cost - total) > a.tol * (cost + static_cast<float>(1e-12));
    *a.lam = l;
    *a.cost = accept ? total : cost;
    *a.stall = accept && improved ? 0 : stall + 1;
    a.flags[0] = accept;
    a.flags[1] = improved;
  }
}

// solver.py::_robust_cost + lm_step's accept and update (:303-315) in one
// cooperative launch, for more constraints than lm_step_block takes.
// Every block reads the state, then forms its constraints' costs
// into rho; after a grid sync block 0 adds them in order (kCost: into out,
// and the launch ends); after a second sync every block reads the sum,
// decides the accept and writes its share of the poses, and block 0 writes
// lam, cost, stall and the flags.  No block reads the state after block 0
// may have written it.
__global__ void __launch_bounds__(kThreads) lm_step(const Lm a) {
  __shared__ float stage[kSumChunk];
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int nth = gridDim.x * kThreads;
  const bool ok = a.info == nullptr || *a.info == 0;
  float cost = 0.f, lam = 0.f;
  int stall = 0;
  if (a.mode != kCost) {
    cost = *a.cost;
    lam = *a.lam;
    stall = *a.stall;
  }
  if (a.mode != kUpdate)
    for (int k = tid; k < a.C; k += nth)
      __stcg(a.rho + k, robust_rho(a, ok, k));
  grid.sync();
  if (a.mode != kUpdate) {
    if (blockIdx.x == 0) {
      const float total = ordered_sum(a.rho, a.C, stage);
      if (threadIdx.x == 0)
        __stcg(a.mode == kCost ? a.out : a.rho + a.C, total);
    }
    if (a.mode == kCost) return;
    grid.sync();
  }
  const float total = a.mode == kUpdate ? *a.new_cost : __ldcg(a.rho + a.C);
  lm_update(a, ok, total, cost, lam, stall, tid, nth);
}

// Threads of the one-block LM step.
constexpr int kLmBlock = 1024;
// acc + v.x + v.y + v.z + v.w, one add at a time.
__device__ __forceinline__ float add4(float acc, float4 v) {
  acc = acc + v.x;
  acc = acc + v.y;
  acc = acc + v.z;
  return acc + v.w;
}

// x[0] + ... + x[n - 1] (x = the float4 row x4) in index order from +0, one
// add at a time by the calling thread: ordered_sum's order.  The next four
// float4 groups load while the current four add, so the chain of adds does
// not wait on shared memory (x4 holds at least n / 4 groups).
__device__ __forceinline__ float row_sum(const float4* x4, int n) {
  const int n4 = n / 4;
  float acc = 0.f;
  if (n4 > 0) {
    const int last = n4 - 1;
    float4 a0 = x4[0], a1 = x4[min(1, last)], a2 = x4[min(2, last)],
           a3 = x4[min(3, last)];
    for (int i = 0; i < n4; i += 4) {
      const float4 b0 = x4[min(i + 4, last)], b1 = x4[min(i + 5, last)],
                   b2 = x4[min(i + 6, last)], b3 = x4[min(i + 7, last)];
      acc = add4(acc, a0);
      if (i + 1 < n4) acc = add4(acc, a1);
      if (i + 2 < n4) acc = add4(acc, a2);
      if (i + 3 < n4) acc = add4(acc, a3);
      a0 = b0;
      a1 = b1;
      a2 = b2;
      a3 = b3;
    }
  }
  const float* x = reinterpret_cast<const float*>(x4);
  for (int i = 4 * n4; i < n; ++i) acc = acc + x[i];
  return acc;
}

// The same step as lm_step in one ordinary block, for the constraints whose
// costs fit the default 48 KB of shared memory (C + 1 floats, C <= 12287;
// every dense solve): the threads form the costs into shared memory,
// thread 0 adds them in index order from +0 (float4 loads, one add at a
// time: ordered_sum's order), and after a second __syncthreads the block
// decides the accept and writes the poses and the state.  Nothing goes
// through global memory between the phases.  The barrier before lm_update
// runs in every mode (kUpdate forms no costs): no thread reads the state
// after thread 0 may have written it.
__global__ void __launch_bounds__(kLmBlock) lm_step_block(const Lm a) {
  extern __shared__ float4 row4[];
  float* row = reinterpret_cast<float*>(row4);
  const bool ok = a.info == nullptr || *a.info == 0;
  float cost = 0.f, lam = 0.f;
  int stall = 0;
  if (a.mode != kCost) {
    cost = *a.cost;
    lam = *a.lam;
    stall = *a.stall;
  }
  if (a.mode != kUpdate) {
    for (int k = threadIdx.x; k < a.C; k += kLmBlock)
      row[k] = robust_rho(a, ok, k);
    __syncthreads();
    if (threadIdx.x == 0) {
      const float acc = row_sum(row4, a.C);
      if (a.mode == kCost)
        *a.out = acc;
      else
        row[a.C] = acc;
    }
    if (a.mode == kCost) return;
  }
  __syncthreads();
  const float total = a.mode == kUpdate ? *a.new_cost : row[a.C];
  lm_update(a, ok, total, cost, lam, stall, threadIdx.x, kLmBlock);
}

// Dynamic shared memory of the one-block step over C constraints: C + 1
// floats, in whole float4s; at most the default 48 KB a block
// (kernels/normal_blocks.py::lm_one_block).
inline size_t lm_block_bytes(int C) {
  return sizeof(float4) * (size_t)((C + 1 + 3) / 4);
}
constexpr size_t kLmBlockBytes = 48 * 1024;

// A launch of the LM step: its arguments and shape, blocks > 0 the
// cooperative grid, 0 the one-block variant (kernels/normal_blocks.py
// _LmLaunch mirrors it).
struct LmLaunch {
  Lm a;
  int blocks;
};

// Launches one LM step as `l` says.
cudaError_t lm_launch(const LmLaunch& l, cudaStream_t st) {
  const Lm& a = l.a;
  if (a.mode < kCost || a.mode > kUpdate || l.blocks < 0 || a.C < 0 ||
      a.N < 1)
    return cudaErrorInvalidValue;
  if ((a.mode == kCost && !a.out) || (a.mode == kUpdate && !a.new_cost) ||
      (a.mode != kCost && !(a.lam && a.cost && a.stall && a.flags)))
    return cudaErrorInvalidValue;
  if (l.blocks > 0) {
    void* args[] = {const_cast<Lm*>(&a)};
    return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lm_step),
                                       l.blocks, kThreads, args, 0, st);
  }
  const size_t smem = lm_block_bytes(a.C);
  if (smem > kLmBlockBytes) return cudaErrorInvalidValue;
  lm_step_block<<<1, kLmBlock, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

static Graph graph_of(const void* poses, const void* begin, const void* end,
                      const void* transform, const void* information,
                      const void* cmask, const void* robust_mask, int loss,
                      float delta) {
  return Graph{static_cast<const float*>(poses),
               static_cast<const int*>(begin),
               static_cast<const int*>(end),
               static_cast<const float*>(transform),
               static_cast<const float*>(information),
               static_cast<const uint8_t*>(cmask),
               static_cast<const uint8_t*>(robust_mask),
               loss,
               delta};
}

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
        graph_of(poses, begin, end, transform, information, cmask,
                 robust_mask, loss, delta),
        C, static_cast<float*>(baa), static_cast<float*>(bab),
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

// One planned CG matvec as packed in *plan (CgMatvec).
NDT2D_API int ndt2d_cg_matvec_planned(const void* plan, void* stream) {
  const CgMatvec& a = *static_cast<const CgMatvec*>(plan);
  if (a.N < 1 || (a.z && !(a.beta && a.p_out)))
    return (int)cudaErrorInvalidValue;
  cg_matvec<<<(a.N + kThreads - 1) / kThreads, kThreads, 0,
              reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// y = A v: b_ptr/e_ptr [N+1] i32 and b_pair/e_pair [*,2] i32 (each list
// entry's constraint and other node; kernels/normal_blocks.py::Incidence);
// baa/bab/bbb [C,3,3], diag [N,3,3], lam [1], fm [N], v [N,3] f32; out
// [N,3] f32.
NDT2D_API int ndt2d_pcg_matvec(const void* b_ptr, const void* e_ptr,
                               const void* b_pair, const void* e_pair, int N,
                               const void* baa, const void* bab,
                               const void* bbb, const void* diag,
                               const void* lam, const void* fm, const void* v,
                               void* out, void* stream) {
  const CgMatvec a{static_cast<const int*>(b_ptr),
                   static_cast<const int*>(e_ptr),
                   static_cast<const int2*>(b_pair),
                   static_cast<const int2*>(e_pair),
                   static_cast<const float*>(baa),
                   static_cast<const float*>(bab),
                   static_cast<const float*>(bbb),
                   static_cast<const float*>(diag),
                   static_cast<const float*>(lam),
                   static_cast<const float*>(fm),
                   static_cast<const float*>(v),
                   nullptr,
                   nullptr,
                   nullptr,
                   static_cast<float*>(out),
                   N};
  return ndt2d_cg_matvec_planned(&a, stream);
}

// D = 1 or 2 dots x_d . y_d of n f32 each in the fixed lane-and-tree order
// (x1, y1 unused at D = 1) into out [D] f32; scratch [2 kLanes + 1] f32:
// the lane partials, then the ticket, 0 before the launch (the folding
// block leaves it 0).  One ordinary launch of kGroups blocks.
NDT2D_API int ndt2d_fixed_dot(const void* x0, const void* y0, const void* x1,
                              const void* y1, int d, int n, void* out,
                              void* scratch, void* stream) {
  if ((d != 1 && d != 2) || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  const Lanes lanes{sc, reinterpret_cast<unsigned*>(sc + 2 * kLanes), n};
  const float* xs[2] = {static_cast<const float*>(x0),
                        static_cast<const float*>(x1)};
  const float* ys[2] = {static_cast<const float*>(y0),
                        static_cast<const float*>(y1)};
  float* o = static_cast<float*>(out);
  if (d == 1)
    lane_dots<1><<<kGroups, kThreads, 0, st>>>(
        PairDots<1>{{{xs[0], xs[1]}, {ys[0], ys[1]}}, lanes, o});
  else
    lane_dots<2><<<kGroups, kThreads, 0, st>>>(
        PairDots<2>{{{xs[0], xs[1]}, {ys[0], ys[1]}}, lanes, o});
  return (int)cudaGetLastError();
}

// Variant (A) of a planned CG step as packed in *plan (CgDamp), on the
// combined partial `part` [N,3] f32.
NDT2D_API int ndt2d_cg_damp_planned(const void* plan, const void* part,
                                    void* stream) {
  CgDamp a = *static_cast<const CgDamp*>(plan);
  if (a.dots.n < 0 || !part) return (int)cudaErrorInvalidValue;
  a.part = static_cast<const float*>(part);
  lane_dots<1><<<kGroups, kThreads, 0,
                 reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Variant (B) of a planned CG step as packed in *plan (CgUpdate).
NDT2D_API int ndt2d_cg_update_planned(const void* plan, void* stream) {
  const CgUpdate& a = *static_cast<const CgUpdate*>(plan);
  if (a.dots.n < 0) return (int)cudaErrorInvalidValue;
  lane_dots<2><<<kGroups, kThreads, 0,
                 reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The sizes of the planned CG structures (kernels/normal_blocks.py's
// ctypes mirrors are checked against them).
NDT2D_API int ndt2d_cg_plan_sizes(int* matvec, int* damp, int* update) {
  *matvec = (int)sizeof(CgMatvec);
  *damp = (int)sizeof(CgDamp);
  *update = (int)sizeof(CgUpdate);
  return 0;
}

// The whole PCG loop of one LM step.  Incidence lists, begin/end and the
// blocks as ndt2d_pcg_matvec's; lam [1], fm [N], pinv [N,3,3], b [N,3] f32
// (b = -g fm); out: x [N,3] f32, iters [1] i32; work: 15 N + 3 kLanes f32.
// Fails (no launch) where the card cannot launch cooperatively.
NDT2D_API int ndt2d_pcg_solve(
    const void* b_ptr, const void* b_idx, const void* e_ptr,
    const void* e_idx, int N, const void* begin, const void* end,
    const void* baa, const void* bab, const void* bbb, const void* diag,
    const void* lam, const void* fm, const void* pinv, const void* b,
    int max_iter, float tol, void* x, void* work, void* iters,
    void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pcg,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // A thread a node where the card holds that many; never more blocks than
  // fit co-resident, and at least the kLanes / kThreads a dot's lanes fill.
  const int want = std::max((N + kThreads - 1) / kThreads, kPer);
  const int blocks = std::min(per_sm * sms, want);
  float* w = static_cast<float*>(work);
  const size_t v = (size_t)3 * N;
  Pcg a{static_cast<const int*>(b_ptr), static_cast<const int*>(b_idx),
        static_cast<const int*>(e_ptr), static_cast<const int*>(e_idx),
        static_cast<const int*>(begin), static_cast<const int*>(end),
        static_cast<const float*>(baa), static_cast<const float*>(bab),
        static_cast<const float*>(bbb), static_cast<const float*>(diag),
        static_cast<const float*>(lam), static_cast<const float*>(fm),
        static_cast<const float*>(pinv), static_cast<const float*>(b), N,
        max_iter, tol, static_cast<float*>(x), w, w + v, w + 2 * v,
        w + 3 * v, w + 4 * v, w + 5 * v, static_cast<int*>(iters)};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(pcg), blocks,
                                    kThreads, args, 0,
                                    reinterpret_cast<cudaStream_t>(stream));
  return (int)err;
}

// The damped dense system of one LM step.  keys [2C] i64, src [2C] i32,
// row_ptr [n+1] i32 (kernels/normal_blocks.py::pair_table); bab [C,3,3],
// diag [n,3,3], g [n,3], lam [1], fm [n] f32; phase 0 (all), 1 (the pair
// sums alone into hm) or 2 (finish hm, the pair sums combined over ranks,
// in place); out: hm [3n,3n], rhs [3n] f32 (rhs not in phase 1).
NDT2D_API int ndt2d_dense_system(const void* keys, const void* src,
                                 const void* row_ptr, const void* bab,
                                 const void* diag, const void* g,
                                 const void* lam, const void* fm, int n,
                                 int C, int phase, void* hm, void* rhs,
                                 void* stream) {
  if (n < 1 || n > kDenseMaxN || C < 0 || phase < 0 || phase > 2)
    return (int)cudaErrorInvalidValue;
  Dense a{static_cast<const long long*>(keys), static_cast<const int*>(src),
          static_cast<const int*>(row_ptr), static_cast<const float*>(bab),
          static_cast<const float*>(diag), static_cast<const float*>(g),
          static_cast<const float*>(lam), static_cast<const float*>(fm),
          n, C, phase, static_cast<float*>(hm), static_cast<float*>(rhs)};
  const size_t smem = phase == 2 ? 0 : (size_t)n * sizeof(int);
  dense_system<<<n, kThreads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      a);
  return (int)cudaGetLastError();
}

// One dense normal system as packed in *plan (ndt2d_dense_normal_system's
// arguments; kernels/normal_blocks.py::DensePlan packs it once a solve).
NDT2D_API int ndt2d_dense_normal_system_planned(const void* plan,
                                                void* stream) {
  const DenseNormal& a = *static_cast<const DenseNormal*>(plan);
  if (a.n < 1 || a.C < 0) return (int)cudaErrorInvalidValue;
  dense_normal_system<<<a.n, kDnThreads, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The damped dense system of one LM step straight from the poses (one
// launch; one device, no combine).  The constraint inputs, loss and delta
// as ndt2d_normal_blocks' (C constraints over n nodes); incidence lists
// b_ptr/e_ptr [n+1], b_idx/e_idx i32; keys [2C] i64, src [2C] i32, row_ptr
// [n+1] i32 as ndt2d_dense_system's; lam [1], fm [n] f32; out: hm
// [3n,3n], rhs [3n] f32, bitwise ndt2d_normal_blocks then
// ndt2d_dense_system's phase 0.
NDT2D_API int ndt2d_dense_normal_system(
    const void* poses, const void* begin, const void* end,
    const void* transform, const void* information, const void* cmask,
    const void* robust_mask, int loss, float delta, int C, const void* b_ptr,
    const void* b_idx, const void* e_ptr, const void* e_idx,
    const void* keys, const void* src, const void* row_ptr, const void* lam,
    const void* fm, int n, void* hm, void* rhs, void* stream) {
  DenseNormal a{graph_of(poses, begin, end, transform, information, cmask,
                         robust_mask, loss, delta),
                C,
                n,
                static_cast<const int*>(b_ptr),
                static_cast<const int*>(b_idx),
                static_cast<const int*>(e_ptr),
                static_cast<const int*>(e_idx),
                static_cast<const long long*>(keys),
                static_cast<const int*>(src),
                static_cast<const int*>(row_ptr),
                static_cast<const float*>(lam),
                static_cast<const float*>(fm),
                static_cast<float*>(hm),
                static_cast<float*>(rhs)};
  return ndt2d_dense_normal_system_planned(&a, stream);
}

// One device's PCG normal system as packed in *plan (PcgSystem;
// kernels/normal_blocks.py::PcgPlan packs it once a solve): the blocks, D,
// pinv and b in one launch.
NDT2D_API int ndt2d_pcg_normal_system_planned(const void* plan,
                                              void* stream) {
  const PcgSystem& a = *static_cast<const PcgSystem*>(plan);
  if (a.N < 1 || a.C < 0) return (int)cudaErrorInvalidValue;
  const int blocks =
      (a.C + kThreads - 1) / kThreads + (a.N + kThreads - 1) / kThreads;
  pcg_normal_system<<<blocks, kThreads, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The PCG normal system of one LM step on one device.  The constraint
// inputs, loss and delta as ndt2d_normal_blocks' (C constraints over N
// nodes), its incidence lists; lam [1], fm [N] f32 (the free-node mask);
// out: baa/bab/bbb [C,3,3], d [N,3,3] (bitwise ndt2d_normal_blocks'),
// pinv [N,3,3] (the damped block-Jacobi inverse) and b [N,3] (-g fm) f32.
NDT2D_API int ndt2d_pcg_normal_system(
    const void* poses, const void* begin, const void* end,
    const void* transform, const void* information, const void* cmask,
    const void* robust_mask, int loss, float delta, int C, const void* b_ptr,
    const void* b_idx, const void* e_ptr, const void* e_idx, int N,
    const void* lam, const void* fm, void* baa, void* bab, void* bbb,
    void* d, void* pinv, void* b, void* stream) {
  const PcgSystem a{graph_of(poses, begin, end, transform, information,
                             cmask, robust_mask, loss, delta),
                    C,
                    N,
                    static_cast<const int*>(b_ptr),
                    static_cast<const int*>(b_idx),
                    static_cast<const int*>(e_ptr),
                    static_cast<const int*>(e_idx),
                    static_cast<const float*>(lam),
                    static_cast<const float*>(fm),
                    static_cast<float*>(baa),
                    static_cast<float*>(bab),
                    static_cast<float*>(bbb),
                    static_cast<float*>(d),
                    static_cast<float*>(pinv),
                    static_cast<float*>(b)};
  return ndt2d_pcg_normal_system_planned(&a, stream);
}

// The size of PcgSystem (kernels/normal_blocks.py's mirror is checked
// against it).
NDT2D_API int ndt2d_pcg_plan_size(int* bytes) {
  *bytes = (int)sizeof(PcgSystem);
  return 0;
}

// The preconditioner alone: g [N,3], d [N,3,3], lam [1], fm [N] f32 ->
// pinv [N,3,3], b [N,3] f32, as ndt2d_pcg_normal_system forms them.
NDT2D_API int ndt2d_preconditioner(const void* g, const void* d,
                                   const void* lam, const void* fm, int N,
                                   void* pinv, void* b, void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  precondition_nodes<<<(N + kThreads - 1) / kThreads, kThreads, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(d),
      static_cast<const float*>(lam), static_cast<const float*>(fm), N,
      static_cast<float*>(pinv), static_cast<float*>(b));
  return (int)cudaGetLastError();
}

// The LM-step blocks the current device holds co-resident, into *blocks (0
// where it cannot launch cooperatively).
NDT2D_API int ndt2d_lm_step_fit(int* blocks) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lm_step,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *blocks = coop ? per_sm * sms : 0;
  return 0;
}

// One LM step (mode 1), its cost alone (mode 0: into out [1]) or its update
// from a given cost (mode 2: new_cost [1]).  poses [N,3] f32 (updated in
// place), delta [N,3] f32 or null, info [1] i32 or null, begin/end [C] i32,
// transform [C,3], information [C,3,3] f32, cmask/robust_mask [C] u8, loss
// and hdelta as ndt2d_normal_blocks'; rho [C+1] f32 scratch (the
// cooperative launch's); state lam, cost [1] f32, stall [1] i32, flags [2]
// u8 (modes 1, 2); the factors down/up and the tolerance.  blocks > 0: one
// cooperative launch of that many blocks (kernels/normal_blocks.py::
// lm_plan, at most ndt2d_lm_step_fit's), which fails where the card cannot
// hold them co-resident; blocks = 0: the one-block launch (C + 1 floats of
// shared memory, at most 48 KB: lm_one_block).
NDT2D_API int ndt2d_lm_step(int mode, int blocks, void* poses,
                            const void* delta, const void* info,
                            const void* begin, const void* end,
                            const void* transform,
                            const void* information, const void* cmask,
                            const void* robust_mask, int loss, float hdelta,
                            int C, int N, void* rho, void* out,
                            const void* new_cost, void* lam, void* cost,
                            void* stall, void* flags, float down, float up,
                            float tol, void* stream) {
  const LmLaunch l{{mode,
                    static_cast<float*>(poses),
                    static_cast<const float*>(delta),
                    static_cast<const int*>(info),
                    static_cast<const int*>(begin),
                    static_cast<const int*>(end),
                    static_cast<const float*>(transform),
                    static_cast<const float*>(information),
                    static_cast<const uint8_t*>(cmask),
                    static_cast<const uint8_t*>(robust_mask),
                    loss,
                    hdelta,
                    C,
                    N,
                    static_cast<float*>(rho),
                    static_cast<float*>(out),
                    static_cast<const float*>(new_cost),
                    static_cast<float*>(lam),
                    static_cast<float*>(cost),
                    static_cast<int*>(stall),
                    static_cast<uint8_t*>(flags),
                    down,
                    up,
                    tol},
                   blocks};
  return (int)lm_launch(l, reinterpret_cast<cudaStream_t>(stream));
}

// The planned launches of one solve: the caller packs each launch's
// arguments once (kernels/normal_blocks.py::DensePlan, whose ctypes
// structures mirror LmLaunch and DenseNormal; ndt2d_plan_sizes reports
// their sizes so the mirror is checked) and passes a pointer an iteration.
NDT2D_API int ndt2d_plan_sizes(int* lm_bytes, int* dense_bytes) {
  *lm_bytes = (int)sizeof(LmLaunch);
  *dense_bytes = (int)sizeof(DenseNormal);
  return 0;
}

// One LM step as packed in *plan (ndt2d_lm_step's arguments).
NDT2D_API int ndt2d_lm_step_planned(const void* plan, void* stream) {
  return (int)lm_launch(*static_cast<const LmLaunch*>(plan),
                        reinterpret_cast<cudaStream_t>(stream));
}
