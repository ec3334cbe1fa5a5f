"""K3: a scan's NDT score at M poses (CUDA ``csrc/score_points.cu``) and its
twin.

Replaces ``ndt_2d_tpu/matching/matcher.py::score_points_at_pose`` ->
``ndt_2d_tpu/ndt/grid.py::score_points`` / ``score_at_cells`` (single
grid), and ``matcher.py::score_points_batch``, its ``jax.vmap`` over poses
(the particle filter's measurement): subsample, transform, cell lookup,
clamped Gaussian, then -sum / max(used, 1).  ``score_batch`` is one launch
over M poses; ``score_at_pose`` is the same launch at M = 1, so a pose's
score is the same bits through either entry.

The beams of a pose are summed in the kernel's order: lane l of a warp adds
beams l, l + 32, ... from 0, then lanes combine by halving (16, 8, 4, 2, 1).
The twin adds in that order too, so kernel and twin agree bitwise.

A grid with a grid axis (the four overlapping grids: origin [4, 2], mean
[4, C, 2], ...) scores each beam as the mean over its grids, summed from 0
in grid order, before the beams are summed (matcher.py:411-416).

KB2, ``stripe_points`` / ``stripe_poses``: the same kernel against one
y-stripe of a sharded map (``ndt_2d_tpu/parallel/ndt_blocks.py:88``,
``:116``), only the points or beams whose global bin lies in the stripe
counted, as raw sums in the same lane order (the caller adds the stripes
and divides).
"""

from __future__ import annotations

import ctypes

import torch

from ndt_2d_tpu_torch.kernels import _build
from ndt_2d_tpu_torch.ndt import grid as ndt_grid

# Launches of the single-pose entry and of the batched one.
launches = 0
batch_launches = 0
# KB2: launches of the stripe scores (world points; poses).
stripe_launches = 0

_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
         + [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_float]
         + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_int]
         + [ctypes.c_void_p] * 2)


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


def lane_tree_sum(terms):
    """Sum [M, slots] per-beam terms (slots a multiple of 32) in the
    kernel's order: per lane l, beams l, l + 32, ... from 0; then lanes
    by halving.  Returns [M]."""
    lanes = terms.reshape(terms.shape[0], -1, 32)
    acc = torch.zeros_like(lanes[:, 0])
    for k in range(lanes.shape[1]):
        acc = acc + lanes[:, k]
    for off in (16, 8, 4, 2, 1):
        acc = acc[:, :off] + acc[:, off:2 * off]
    return acc[:, 0]


def score_batch_twin(grid: ndt_grid.NDTGrid, width: int, height: int,
                     max_beams: int, points, point_mask, num_points: int,
                     poses):
    """Plain-PyTorch K3 over poses [M, 3]: [M] mean negative likelihoods,
    as a [M, beams] expression summed in the kernel's order."""
    spts, smask, used = subsample(points, point_mask, num_points, max_beams)
    c, s = torch.cos(poses[:, 2:3]), torch.sin(poses[:, 2:3])
    px, py = spts[:, 0], spts[:, 1]
    wx = c * px - s * py + poses[:, 0:1]
    wy = s * px + c * py + poses[:, 1:2]
    w = torch.stack([wx, wy], dim=-1)
    wmask = smask.expand(poses.shape[0], -1)
    if grid.mean.dim() == 2:
        sc = ndt_grid.score_points(grid, w, wmask, width, height)
    else:
        grids = ndt_grid.split_grids(grid)
        sc = sum(ndt_grid.score_points(g, w, wmask, width, height)
                 for g in grids) / ndt_grid.f32(len(grids), points.device)
    slots = -(-max_beams // 32) * 32
    sc = torch.nn.functional.pad(sc, (0, slots - max_beams))
    return -lane_tree_sum(sc) / ndt_grid.f32(max(used, 1), points.device)


def score_at_pose_twin(grid: ndt_grid.NDTGrid, width: int, height: int,
                       max_beams: int, points, point_mask, num_points: int,
                       pose):
    """Plain-PyTorch K3 at one pose [3]: ``score_batch_twin`` at M = 1,
    returned as a 0-d tensor."""
    return score_batch_twin(grid, width, height, max_beams, points,
                            point_mask, num_points, pose[None])[0]


def _launch(grid, width, row0, rows, max_beams, points, point_mask,
            num_points, poses, raw):
    """One K3 launch over the grid rows [row0, row0 + rows) (the whole
    grid at row0 = 0, rows = H); ``raw`` leaves out the division."""
    dev = points.device
    P, M, C = points.shape[0], poses.shape[0], width * rows
    if M < 1:
        raise ValueError("score_points needs at least one pose")
    G = grid.mean.shape[0] if grid.mean.dim() == 3 else 1
    lead = () if grid.mean.dim() == 2 else (G,)
    _build.require(points, "points", torch.float32, (P, 2), dev)
    _build.require(point_mask, "point_mask", torch.bool, (P,), dev)
    _build.require(poses, "poses", torch.float32, (M, 3), dev)
    _build.require(grid.origin, "origin", torch.float32, (*lead, 2), dev)
    _build.require(grid.mean, "mean", torch.float32, (*lead, C, 2), dev)
    _build.require(grid.information, "information", torch.float32,
                   (*lead, C, 3), dev)
    _build.require(grid.count, "count", torch.int32, (*lead, C), dev)
    out = torch.empty(M, dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _build.function("ndt2d_score_points", _ARGS)(
        p(points), p(point_mask), P, int(num_points), int(max_beams),
        p(poses), M, G, p(grid.origin), float(grid.cell_size), width,
        int(row0), int(rows), p(grid.mean), p(grid.information),
        p(grid.count), int(raw), p(out), _build.stream_ptr(dev))
    _build.check(err, "score_points")
    return out


def score_batch(grid: ndt_grid.NDTGrid, width: int, height: int,
                max_beams: int, points, point_mask, num_points: int, poses):
    """K3 over poses [M, 3] f32 (points [P, 2] f32, point_mask [P] bool);
    returns [M] float32.  CPU tensors run the twin; CUDA tensors launch
    the kernel."""
    global batch_launches
    if points.device.type == "cpu":
        return score_batch_twin(grid, width, height, max_beams, points,
                                point_mask, num_points, poses)
    out = _launch(grid, width, 0, height, max_beams, points, point_mask,
                  num_points, poses, False)
    batch_launches += 1
    return out


def score_at_pose(grid: ndt_grid.NDTGrid, width: int, height: int,
                  max_beams: int, points, point_mask, num_points: int, pose):
    """K3 at one pose [3] f32: the batched launch at M = 1; returns a 0-d
    float32 tensor.  CPU tensors run the twin; CUDA tensors launch the
    kernel."""
    global launches
    if points.device.type == "cpu":
        return score_at_pose_twin(grid, width, height, max_beams, points,
                                  point_mask, num_points, pose)
    out = _launch(grid, width, 0, height, max_beams, points, point_mask,
                  num_points, pose.reshape(1, 3), False)
    launches += 1
    return out[0]


# --- KB2: scores against one y-stripe of a sharded map -------------------
def _pad32(x):
    """[M, n] padded with zeros to a multiple of 32 columns."""
    return torch.nn.functional.pad(x, (0, -(-x.shape[1] // 32) * 32
                                       - x.shape[1]))


def _stripe_at(stripe: ndt_grid.NDTGrid, width: int, row0: int, rows: int,
               w, wmask):
    """Clamped Gaussian scores of world points ``w`` [..., 2] against the
    stripe's cells (0 outside the stripe's global rows)."""
    flat, valid = ndt_grid.stripe_cells(stripe.origin, stripe.cell_size,
                                        width, row0, rows, w)
    return ndt_grid.score_at_cells(stripe.mean, stripe.information,
                                   stripe.count, w, valid & wmask, flat)


def stripe_points_twin(stripe: ndt_grid.NDTGrid, width: int, row0: int,
                       rows: int, points, mask):
    """Plain-PyTorch KB2, world points: the [1] sum of the scores of every
    masked point in the stripe, in the kernel's lane order."""
    sc = _stripe_at(stripe, width, row0, rows, points, mask)
    return lane_tree_sum(_pad32(sc[None]))


def stripe_poses_twin(stripe: ndt_grid.NDTGrid, width: int, row0: int,
                      rows: int, max_beams: int, points, point_mask,
                      num_points: int, poses):
    """Plain-PyTorch KB2, poses: [M] raw -sum over each pose's subsampled
    beams that fall in the stripe, in the kernel's lane order."""
    spts, smask, _ = subsample(points, point_mask, num_points, max_beams)
    c, s = torch.cos(poses[:, 2:3]), torch.sin(poses[:, 2:3])
    px, py = spts[:, 0], spts[:, 1]
    w = torch.stack([c * px - s * py + poses[:, 0:1],
                     s * px + c * py + poses[:, 1:2]], dim=-1)
    sc = _stripe_at(stripe, width, row0, rows, w,
                    smask.expand(poses.shape[0], -1))
    return -lane_tree_sum(_pad32(sc))


def stripe_points(stripe: ndt_grid.NDTGrid, width: int, row0: int,
                  rows: int, points, mask):
    """KB2 over world points [N, 2] f32 (mask [N] bool): [1], the sum of
    the clamped Gaussian scores of the masked points whose global bin lies
    in the stripe's rows [row0, row0 + rows).  ``stripe`` is KB1's (the
    map's origin, rows * width cells).  CPU tensors run the twin; CUDA
    tensors launch the kernel."""
    global stripe_launches
    if points.device.type == "cpu":
        return stripe_points_twin(stripe, width, row0, rows, points, mask)
    P = points.shape[0]
    identity = torch.zeros(1, 3, dtype=torch.float32, device=points.device)
    out = _launch(stripe, width, row0, rows, P, points, mask, P, identity,
                  True)
    stripe_launches += 1
    return -out


def stripe_poses(stripe: ndt_grid.NDTGrid, width: int, row0: int, rows: int,
                 max_beams: int, points, point_mask, num_points: int, poses):
    """KB2 over poses [M, 3] f32 (points [P, 2] f32 robot frame,
    point_mask [P] bool): [M], each pose's -sum of scores over its
    subsampled beams in the stripe, not yet divided by the beams used.
    CPU tensors run the twin; CUDA tensors launch the kernel."""
    global stripe_launches
    if points.device.type == "cpu":
        return stripe_poses_twin(stripe, width, row0, rows, max_beams,
                                 points, point_mask, num_points, poses)
    out = _launch(stripe, width, row0, rows, max_beams, points, point_mask,
                  num_points, poses, True)
    stripe_launches += 1
    return out
