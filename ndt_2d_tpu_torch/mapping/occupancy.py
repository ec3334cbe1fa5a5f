"""Occupancy-grid export on the ray-march kernel (K5).

Port of ``ndt_2d_tpu/mapping/occupancy.py`` without the mesh: the bounds
and sample count are host numpy as in the reference, the ray-march runs on
``device`` and the classification (occupied if hit/(hit+empty) >
occ_thresh, free if observed, else unknown) runs on the host.  The
reference module imports jax at the top, so its two numpy pieces
(``OccupancyGridResult``, ``compute_bounds``) are restated here.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ndt_2d_tpu_torch.kernels import raymarch


class OccupancyGridResult(NamedTuple):
    data: np.ndarray      # [H, W] int8: 100 occupied, 0 free, -1 unknown
    origin: np.ndarray    # [2] world coords of cell (0, 0) corner
    resolution: float


def compute_bounds(world_points: np.ndarray, mask: np.ndarray,
                   resolution: float) -> Tuple[np.ndarray, np.ndarray]:
    """World bounds of all valid points, snapped outward to the resolution,
    always including the world origin (OccupancyGrid::updateBounds)."""
    pts = world_points[mask]
    if pts.size == 0:
        pts = np.zeros((1, 2))
    mins = np.minimum(pts.min(0), 0.0)
    maxs = np.maximum(pts.max(0), 0.0)
    mins = np.floor(mins / resolution) * resolution
    maxs = np.ceil(maxs / resolution) * resolution
    return mins, maxs


class RayBatch(NamedTuple):
    """The ray-march's inputs, as the reference lays them out on the host."""

    starts: np.ndarray    # [R, 2] float64 world ray origins (scan poses)
    ends: np.ndarray      # [R, 2] float64 world beam endpoints
    mask: np.ndarray      # [R] bool
    origin: np.ndarray    # [2] grid corner
    width: int
    height: int
    num_samples: int


def ray_batch(poses: np.ndarray, points: np.ndarray, mask: np.ndarray,
              resolution: float, pad_cells: int = 5,
              size_bucket: int = 64) -> RayBatch:
    """One ray per (scan, beam), the grid extent (bounds padded by
    ``pad_cells``, dims rounded up to multiples of ``size_bucket``) and the
    sample count (half-cell spacing over the longest ray, rounded up to a
    multiple of 64)."""
    poses = np.asarray(poses, np.float64)
    c, s = np.cos(poses[:, 2])[:, None], np.sin(poses[:, 2])[:, None]
    px, py = points[..., 0], points[..., 1]
    wx = c * px - s * py + poses[:, 0:1]
    wy = s * px + c * py + poses[:, 1:2]
    world = np.stack([wx, wy], axis=-1)

    mins, maxs = compute_bounds(world.reshape(-1, 2), mask.reshape(-1),
                                resolution)
    pad = pad_cells * resolution
    origin = mins - pad
    span = (maxs - mins) + 2 * pad
    width = int(np.ceil(span[0] / resolution))
    height = int(np.ceil(span[1] / resolution))
    width = int(np.ceil(width / size_bucket) * size_bucket)
    height = int(np.ceil(height / size_bucket) * size_bucket)

    starts = np.broadcast_to(poses[:, None, :2], world.shape).reshape(-1, 2)
    ends = world.reshape(-1, 2)
    bmask = mask.reshape(-1)

    max_len = float(np.max(np.where(
        bmask, np.hypot(ends[:, 0] - starts[:, 0], ends[:, 1] - starts[:, 1]),
        0.0), initial=0.0))
    num_samples = max(int(np.ceil(max_len / (0.5 * resolution))) + 2, 4)
    num_samples = int(np.ceil(num_samples / 64) * 64)
    return RayBatch(starts, ends, bmask, origin, width, height, num_samples)


def ray_tensors(rays: RayBatch, resolution: float, device=None) -> tuple:
    """K5's arguments for a ray batch, as float32/bool tensors on
    ``device``."""
    def dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x)).to(
            device=device, dtype=dtype)

    return (dev(rays.starts, torch.float32), dev(rays.ends, torch.float32),
            dev(rays.mask, torch.bool), dev(rays.origin, torch.float32),
            resolution, rays.width, rays.height, rays.num_samples)


def render_occupancy(poses: np.ndarray, points: np.ndarray, mask: np.ndarray,
                     resolution: float, occ_thresh: float,
                     pad_cells: int = 5, size_bucket: int = 64,
                     device=None) -> OccupancyGridResult:
    """Render scans into an occupancy grid (OccupancyGrid::getMsg).

    poses [S, 3], points [S, P, 2] robot frame, mask [S, P] (host numpy)."""
    rays = ray_batch(poses, points, mask, resolution, pad_cells, size_bucket)
    hit, empty = raymarch.raymarch_counts(
        *ray_tensors(rays, resolution, device))
    hit = hit.cpu().numpy().astype(np.float64)
    empty = empty.cpu().numpy().astype(np.float64)

    touches = hit + empty
    data = np.full(rays.width * rays.height, -1, np.int8)
    observed = touches > 0.5
    occupied = observed & (hit / np.maximum(touches, 1.0) > occ_thresh)
    data[observed] = 0
    data[occupied] = 100
    return OccupancyGridResult(data=data.reshape(rays.height, rays.width),
                               origin=rays.origin, resolution=resolution)
