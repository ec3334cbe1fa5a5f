// The 3x3 solve shared by K7 (newton.cu) and KB4 (slam_step.cu): LU with
// partial pivoting (the first largest |pivot|), forward elimination, then
// back substitution column by column.  The plain-PyTorch twin is
// matching/newton.py::solve3, the same operations in the same order.
#pragma once

#include "common.cuh"

namespace {

__device__ __forceinline__ void swap_rows(float a[3][3], float b[3], int i,
                                          int j) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t = a[i][k];
    a[i][k] = a[j][k];
    a[j][k] = t;
  }
  const float t = b[i];
  b[i] = b[j];
  b[j] = t;
}

// x = A^-1 b by LU with partial pivoting (the first largest |pivot|),
// forward elimination, then back substitution column by column.
__device__ void solve3(float a[3][3], float b[3], float x[3]) {
  int p = 0;
  if (fabsf(a[1][0]) > fabsf(a[p][0])) p = 1;
  if (fabsf(a[2][0]) > fabsf(a[p][0])) p = 2;
  if (p != 0) swap_rows(a, b, 0, p);
  const float l1 = a[1][0] / a[0][0];
  const float l2 = a[2][0] / a[0][0];
  a[1][1] = a[1][1] - l1 * a[0][1];
  a[1][2] = a[1][2] - l1 * a[0][2];
  b[1] = b[1] - l1 * b[0];
  a[2][1] = a[2][1] - l2 * a[0][1];
  a[2][2] = a[2][2] - l2 * a[0][2];
  b[2] = b[2] - l2 * b[0];
  if (fabsf(a[2][1]) > fabsf(a[1][1])) swap_rows(a, b, 1, 2);
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
