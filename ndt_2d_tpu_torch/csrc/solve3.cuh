// The 3x3 solve shared by K7 (newton.cu) and KB4 (slam_step.cu): LU with
// partial pivoting (the first largest |pivot|), forward elimination, then
// back substitution column by column.  The plain-PyTorch twin is
// matching/newton.py::solve3, the same operations in the same order.
//
// Row swaps are selects on fixed registers, as the twin's torch.where
// swaps are: a swap by a row index known only at run time would put the
// system in local memory, and every step of the elimination would wait on
// it.
#pragma once

#include "common.cuh"

namespace {

// Rows i and j of (a | b) exchanged where `swap` holds.
__device__ __forceinline__ void swap_if(bool swap, float ai[3], float aj[3],
                                        float& bi, float& bj) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t = ai[k];
    ai[k] = swap ? aj[k] : t;
    aj[k] = swap ? t : aj[k];
  }
  const float t = bi;
  bi = swap ? bj : t;
  bj = swap ? t : bj;
}

// x = A^-1 b by LU with partial pivoting (the first largest |pivot|),
// forward elimination, then back substitution column by column.
__device__ __forceinline__ void solve3(float a[3][3], float b[3], float x[3]) {
  const bool p1 = fabsf(a[1][0]) > fabsf(a[0][0]);
  const bool p2 = fabsf(a[2][0]) > (p1 ? fabsf(a[1][0]) : fabsf(a[0][0]));
  // Row 0 swaps with the pivot row: 2 if p2, else 1 if p1.
  swap_if(p1 && !p2, a[0], a[1], b[0], b[1]);
  swap_if(p2, a[0], a[2], b[0], b[2]);
  const float l1 = a[1][0] / a[0][0];
  const float l2 = a[2][0] / a[0][0];
  a[1][1] = a[1][1] - l1 * a[0][1];
  a[1][2] = a[1][2] - l1 * a[0][2];
  b[1] = b[1] - l1 * b[0];
  a[2][1] = a[2][1] - l2 * a[0][1];
  a[2][2] = a[2][2] - l2 * a[0][2];
  b[2] = b[2] - l2 * b[0];
  swap_if(fabsf(a[2][1]) > fabsf(a[1][1]), a[1], a[2], b[1], b[2]);
  const float l = a[2][1] / a[1][1];
  a[2][2] = a[2][2] - l * a[1][2];
  b[2] = b[2] - l * b[1];
  x[2] = b[2] / a[2][2];
  float b0 = b[0] - x[2] * a[0][2];
  const float b1 = b[1] - x[2] * a[1][2];
  x[1] = b1 / a[1][1];
  b0 = b0 - x[1] * a[0][1];
  x[0] = b0 / a[0][0];
}

}  // namespace
