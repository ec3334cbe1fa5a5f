"""K3: a scan's NDT score at one pose (CUDA ``csrc/score_points.cu``) and
its twin.

Replaces ``ndt_2d_tpu/matching/matcher.py::score_points_at_pose`` ->
``ndt_2d_tpu/ndt/grid.py::score_points`` / ``score_at_cells`` (single
grid): subsample, transform, cell lookup, clamped Gaussian, then
-sum / max(used, 1), in one single-block launch.
"""

from __future__ import annotations

import ctypes

import torch

from ndt_2d_tpu_torch.kernels import _build
from ndt_2d_tpu_torch.ndt import grid as ndt_grid

launches = 0

_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
         + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5)


def subsample(points, point_mask, num_points: int, max_beams: int):
    """Stride-subsample a padded scan to ``max_beams`` slots
    (src/scan_matcher_ndt.cpp:94-101): used = min(max_beams, n),
    step = n / used, idx_i = floor(i * step).  Returns (points
    [max_beams, 2], mask [max_beams], used)."""
    dev = points.device
    used = min(int(max_beams), int(num_points))
    step = (ndt_grid.f32(num_points, dev)
            / ndt_grid.f32(max(used, 1), dev))
    i = torch.arange(max_beams, dtype=torch.float32, device=dev)
    idx = torch.clamp((i * step).to(torch.int32), max=num_points - 1)
    idx = torch.clamp(idx, 0, points.shape[0] - 1).to(torch.int64)
    mask = (torch.arange(max_beams, device=dev) < used) & point_mask[idx]
    return points[idx], mask, used


def score_at_pose_twin(grid: ndt_grid.NDTGrid, width: int, height: int,
                       max_beams: int, points, point_mask, num_points: int,
                       pose):
    """Plain-PyTorch K3: mean negative likelihood of the subsampled scan
    transformed by ``pose`` (a 0-d tensor)."""
    spts, smask, used = subsample(points, point_mask, num_points, max_beams)
    c, s = torch.cos(pose[2]), torch.sin(pose[2])
    wx = c * spts[:, 0] - s * spts[:, 1] + pose[0]
    wy = s * spts[:, 0] + c * spts[:, 1] + pose[1]
    w = torch.stack([wx, wy], dim=-1)
    sc = ndt_grid.score_points(grid, w, smask, width, height)
    return -torch.sum(sc) / ndt_grid.f32(max(used, 1), points.device)


def score_at_pose(grid: ndt_grid.NDTGrid, width: int, height: int,
                  max_beams: int, points, point_mask, num_points: int, pose):
    """K3.  points [P, 2] f32, point_mask [P] bool, pose [3] f32; returns a
    0-d float32 tensor.  CPU tensors run the twin; CUDA tensors launch
    the kernel."""
    global launches
    if points.device.type == "cpu":
        return score_at_pose_twin(grid, width, height, max_beams, points,
                                  point_mask, num_points, pose)
    dev = points.device
    P = points.shape[0]
    C = width * height
    _build.require(points, "points", torch.float32, (P, 2), dev)
    _build.require(point_mask, "point_mask", torch.bool, (P,), dev)
    _build.require(pose, "pose", torch.float32, (3,), dev)
    _build.require(grid.origin, "origin", torch.float32, (2,), dev)
    _build.require(grid.mean, "mean", torch.float32, (C, 2), dev)
    _build.require(grid.information, "information", torch.float32, (C, 3),
                   dev)
    _build.require(grid.count, "count", torch.int32, (C,), dev)
    out = torch.empty(1, dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _build.function("ndt2d_score_points", _ARGS)(
        p(points), p(point_mask), P, int(num_points), int(max_beams),
        p(pose), p(grid.origin), float(grid.cell_size), width, height,
        p(grid.mean), p(grid.information), p(grid.count), p(out),
        _build.stream_ptr(dev))
    _build.check(err, "score_points")
    launches += 1
    return out[0]
