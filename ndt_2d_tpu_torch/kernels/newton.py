"""K7: Newton refinement of matches (CUDA ``csrc/newton.cu``) and its twin.

Replaces ``ndt_2d_tpu/matching/newton.py::refine_pose`` (->
``_objective_grad_hess`` -> ``_objective_grad_hess_one``), which
``matcher.py::match_scan`` chains after the lattice search when
``refine_iterations > 0`` (:384-393), and its ``jax.vmap`` over the rows of
``match_scan_batch_multi``.  One launch refines R rows: each starts at its
pose plus K2's correction, read from K2's [R, 13] output rows, and writes
its score (best_f / max(used, 1)) and correction (best - pose) back into
them; K2's covariance stays.  A row is a block of G x S warps (``plan``);
each beam's cell is one 32-byte record of K1's packed table.

The twin is ``matching/newton.py``, which writes the kernel's operations in
the kernel's order, so on the same inputs kernel and twin agree bitwise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ndt_2d_tpu_torch.kernels import _build
from ndt_2d_tpu_torch.kernels.score_points import subsample
from ndt_2d_tpu_torch.matching import newton
from ndt_2d_tpu_torch.ndt import grid as ndt_grid

launches = 0

MAX_STRIDES = 4  # warps a grid (csrc/newton.cu's kMaxStrides)

_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_float]
         + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
         + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
         + [ctypes.c_float] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2)


class Plan(NamedTuple):
    strides: int     # S: warps a grid
    threads: int     # 32 G S
    chunk: int       # beams a round of staged terms: 32 S
    smem_bytes: int  # beams, staged terms, grid totals, pose broadcast


def plan(max_beams: int, grids: int) -> Plan:
    """K7's launch plan for ``max_beams`` beams on ``grids`` grids: S =
    ceil(max_beams / 32) warps a grid, at most ``MAX_STRIDES``.  Warp
    (g, s) computes beams l + 32 (s + S j) of grid g; warp (g, 0)'s lane l
    then adds beams l, l + 32, ... in beam order, one chunk of 32 S beams
    at a time."""
    if max_beams < 1 or grids < 1:
        raise ValueError(f"{max_beams} beams on {grids} grids")
    S = min(-(-max_beams // 32), MAX_STRIDES)
    smem = 4 * (3 * max_beams + grids * newton.NUM_SUMS * 32 * S
                + grids * newton.NUM_SUMS + 4)
    if smem > 48 * 1024:
        raise ValueError(f"{max_beams} beams on {grids} grids need {smem} "
                         "bytes of shared memory, above 48 KiB")
    return Plan(S, 32 * grids * S, 32 * S, smem)


def row_tables(table, rows_axis: bool):
    """K1's packed table(s) as an [R, G, C, 32] view (as
    ``newton.with_row_grid_axes`` lays out the grid)."""
    single = table.dim() == (3 if rows_axis else 2)
    if single:
        table = table.unsqueeze(1 if rows_axis else 0)
    return table if rows_axis else table[None]


def refine_rows_twin(config, grid: ndt_grid.NDTGrid, points, point_mask,
                     num_points, poses, out, iterations: int):
    """Plain-PyTorch K7 over R rows: a copy of K2's rows ``out`` [R, 13]
    with each row's score and correction refined.  grid fields [R, G, ...]
    (G = 1 or 4), points [R, P, 2], point_mask [R, P], num_points [R]
    int32, poses [R, 3]."""
    dev = points.device
    subs = [subsample(points[r], point_mask[r], int(num_points[r]),
                      config.laser_max_beams)
            for r in range(points.shape[0])]
    spts = torch.stack([s[0] for s in subs])
    smask = torch.stack([s[1] for s in subs])
    used = torch.tensor([max(s[2], 1) for s in subs], dtype=torch.float32,
                        device=dev)
    best, best_f = newton.refine_beams(config, grid, spts, smask,
                                       poses + out[:, 1:4], iterations)
    res = out.clone()
    res[:, 0] = best_f / used
    res[:, 1:4] = best - poses
    return res


def _launch(config, grid, table, points, point_mask, nums, num: int, poses,
            out, iterations: int):
    global launches
    dev = points.device
    W, H = config.grid_cells_x, config.grid_cells_y
    R, P = points.shape[0], points.shape[1]
    G, C = grid.origin.shape[1], W * H
    pl = plan(int(config.laser_max_beams), G)
    _build.require(grid.origin, "origin", torch.float32, (R, G, 2), dev)
    _build.require(table, "table", torch.float32, (R, G, C, 32), dev)
    _build.require(points, "points", torch.float32, (R, P, 2), dev)
    _build.require(point_mask, "point_mask", torch.bool, (R, P), dev)
    if nums is not None:
        _build.require(nums, "num_points", torch.int32, (R,), dev)
    _build.require(poses, "poses", torch.float32, (R, 3), dev)
    _build.require(out, "out", torch.float32, (R, 13), dev)
    p = _build.ptr
    err = _build.function("ndt2d_newton", _ARGS)(
        p(grid.origin), p(table), G, float(grid.cell_size), W, H, p(points),
        p(point_mask), R, P, None if nums is None else p(nums), int(num),
        int(config.laser_max_beams), pl.strides, p(poses),
        float(config.search_linear_resolution),
        float(config.search_angular_resolution), int(iterations), p(out),
        _build.stream_ptr(dev))
    _build.check(err, "newton")
    launches += 1
    return out


def refine_rows(config, grid: ndt_grid.NDTGrid, table, points, point_mask,
                num_points, poses, out, iterations: int):
    """K7 over R rows in one launch, chained after K2's rows ``out``
    [R, 13] f32.  grid fields [R, (G,) ...] and table [R, (G,) C, 32] (K1's
    window grids and packed tables), points [R, P, 2] f32, point_mask
    [R, P] bool, num_points [R] int32, poses [R, 3] f32.  CUDA tensors
    launch the kernel, which rewrites ``out`` in place and returns it; CPU
    tensors run the twin, which returns a refined copy."""
    grid = newton.with_row_grid_axes(grid, rows_axis=True)
    if points.device.type == "cpu":
        return refine_rows_twin(config, grid, points, point_mask, num_points,
                                poses, out, iterations)
    return _launch(config, grid, row_tables(table, True), points,
                   point_mask, num_points, 0, poses, out, iterations)


def refine(config, grid: ndt_grid.NDTGrid, table, points, point_mask,
           num_points: int, pose, out, iterations: int):
    """K7 of one scan: ``refine_rows``' launch at R = 1.  grid fields
    [(G,) ...], table [(G,) C, 32], points [P, 2], point_mask [P], pose
    [3], out [1, 13]."""
    grid = newton.with_row_grid_axes(grid, rows_axis=False)
    if points.device.type == "cpu":
        nums = torch.tensor([num_points], dtype=torch.int32)
        return refine_rows_twin(config, grid, points[None], point_mask[None],
                                nums, pose[None], out, iterations)
    return _launch(config, grid, row_tables(table, False), points[None],
                   point_mask[None], None, num_points, pose[None], out,
                   iterations)

