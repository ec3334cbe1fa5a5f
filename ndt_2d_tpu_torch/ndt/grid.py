"""NDT grid as tensors: cell binning, the batched build and Gaussian scoring.

Port of ``ndt_2d_tpu/ndt/grid.py``.  These plain-PyTorch functions are the
twins of two CUDA kernels: the build (``build_ndt_binned`` and
``packed_patch_table``) of K1 (``kernels/ndt_build.py``) and the scoring
(``score_at_cells``) of K3 (``kernels/score_points.py``).  Expressions keep
the reference's float32 evaluation order; the moment sums use
``index_add_``, which on the CPU adds in point-index order.

Numerical semantics (reference ``src/ndt_model.cpp``): covariance =
(corr - mean mean^T) * n/(n-1); the small eigenvalue is floored at
0.001 x the large one; the determinant is clamped at 1e-20; statistics
exist for n >= 3 and cells score only with n >= 5; out-of-grid points
score 0.
"""

from __future__ import annotations

import dataclasses

import torch

from ndt_2d_tpu_torch.core import pose as pose_ops

DET_EPS = 1e-20


@dataclasses.dataclass
class NDTGrid:
    """Dense NDT grid as structure-of-arrays (row-major ``iy * W + ix``).

    origin: [2] float32 grid min corner; cell_size: edge length (meters,
    rounded to float32 wherever it meets a tensor); mean [C, 2],
    information [C, 3] (i00, i01, i11), covariance [C, 3] (c00, c01, c11)
    float32; count [C] int32.
    """

    origin: torch.Tensor
    cell_size: float
    mean: torch.Tensor
    information: torch.Tensor
    count: torch.Tensor
    covariance: torch.Tensor

    @property
    def num_cells(self) -> int:
        return self.mean.shape[-2]


def split_grids(grid: NDTGrid) -> list:
    """The grids of a stacked NDTGrid (fields with a leading grid axis, as
    the overlapping grids' [4, ...]), each as an NDTGrid of views."""
    return [NDTGrid(origin=grid.origin[g], cell_size=grid.cell_size,
                    mean=grid.mean[g], information=grid.information[g],
                    count=grid.count[g], covariance=grid.covariance[g])
            for g in range(grid.mean.shape[0])]


def f32(x: float, device) -> torch.Tensor:
    """A python float as the float32 0-d tensor the reference computes with."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def cell_ij(origin, cell_size, points):
    """Raw (ix, iy) floor binning for [..., 2] world points."""
    rel = (points - origin) / cell_size
    ix = torch.floor(rel[..., 0]).to(torch.int32)
    iy = torch.floor(rel[..., 1]).to(torch.int32)
    return ix, iy


def cell_index(origin, cell_size, width: int, height: int, points):
    """Flat cell index + validity (NDT::getIndex): out-of-extent is invalid."""
    ix, iy = cell_ij(origin, cell_size, points)
    valid = (ix >= 0) & (iy >= 0) & (ix < width) & (iy < height)
    flat = (torch.clamp(iy, 0, height - 1) * width
            + torch.clamp(ix, 0, width - 1))
    return flat, valid


def stripe_cells(origin, cell_size: float, width: int, row0: int, rows: int,
                 points):
    """(flat stripe cell, valid) of [..., 2] world points binned against
    the map's GLOBAL origin: valid when the global bin lies in columns
    [0, W) and rows [row0, row0 + rows); flat = (iy - row0) * W + ix."""
    cell = f32(cell_size, points.device)
    ix, iy = cell_ij(origin, cell, points)
    valid = (ix >= 0) & (ix < width) & (iy >= row0) & (iy < row0 + rows)
    flat = (torch.clamp(iy - row0, 0, rows - 1) * width
            + torch.clamp(ix, 0, width - 1))
    return flat, valid


def build_ndt(points, mask, origin, cell_size: float, width: int,
              height: int) -> NDTGrid:
    """Build an NDT grid from [N, 2] world-frame points and [N] mask."""
    cell = f32(cell_size, points.device)
    origin = origin.to(torch.float32)
    flat, valid = cell_index(origin, cell, width, height, points)
    return build_ndt_binned(points, valid & mask, flat, origin, cell_size,
                            width * height)


def segment_sum_in_order(seg, vals, num_segments: int):
    """Per-segment sums of ``vals`` [N, F] for segment ids ``seg`` [N]
    (all in [0, num_segments)), each segment summed from 0 in index order.

    Round r adds the r-th member of every segment at once, so no two adds
    of a round touch one row and the order is fixed on every device: the
    same sequence of float32 additions as K1's per-cell loop (and as XLA's
    sequential scatter on the CPU).  A float atomic scatter would not be;
    the (corr - mean^2) cancellation of the covariance turns its
    last-bit differences into large relative ones.
    """
    out = torch.zeros(num_segments, vals.shape[1], dtype=vals.dtype,
                      device=vals.device)
    if seg.numel() == 0:
        return out
    sorted_seg, perm = torch.sort(seg, stable=True)
    start = torch.searchsorted(sorted_seg, sorted_seg)
    rank = torch.empty_like(perm)
    rank[perm] = torch.arange(seg.numel(), device=seg.device) - start
    for r in range(int(rank.max()) + 1):
        sel = torch.nonzero(rank == r).squeeze(1)
        out.index_add_(0, seg[sel], vals[sel])
    return out


def build_ndt_binned(points, valid, flat, origin, cell_size: float,
                     num_cells: int) -> NDTGrid:
    """Cell statistics from precomputed (flat index, validity)."""
    keep = torch.nonzero(valid).squeeze(1)
    x, y = points[keep, 0], points[keep, 1]
    vals = torch.stack([torch.ones_like(x), x, y, x * x, x * y, y * y],
                       dim=-1)
    moments = segment_sum_in_order(flat[keep].to(torch.int64), vals,
                                   num_cells)

    n = moments[:, 0]
    n_safe = torch.clamp(n, min=1.0)
    mean = moments[:, 1:3] / n_safe[:, None]
    corr = moments[:, 3:6] / n_safe[:, None]

    scale = n / torch.clamp(n - 1.0, min=1.0)
    c00 = (corr[:, 0] - mean[:, 0] * mean[:, 0]) * scale
    c01 = (corr[:, 1] - mean[:, 0] * mean[:, 1]) * scale
    c11 = (corr[:, 2] - mean[:, 1] * mean[:, 1]) * scale

    half_tr = 0.5 * (c00 + c11)
    det = c00 * c11 - c01 * c01
    disc = torch.sqrt(torch.clamp(half_tr * half_tr - det, min=0.0))
    large = half_tr + disc
    small = half_tr - disc

    floored = small < 0.001 * large
    det_used = torch.where(floored, (0.001 * large) * large, det)
    det_used = torch.where(torch.abs(det_used) < DET_EPS,
                           torch.full_like(det_used, DET_EPS), det_used)
    inv = 1.0 / det_used
    i00 = c11 * inv
    i01 = -c01 * inv
    i11 = c00 * inv

    has_stats = n >= 3.0
    zeros = torch.zeros_like(i00)
    information = torch.stack([torch.where(has_stats, i00, zeros),
                               torch.where(has_stats, i01, zeros),
                               torch.where(has_stats, i11, zeros)], dim=-1)
    covariance = torch.stack([torch.where(has_stats, c00, zeros),
                              torch.where(has_stats, c01, zeros),
                              torch.where(has_stats, c11, zeros)], dim=-1)
    return NDTGrid(origin=origin, cell_size=float(cell_size), mean=mean,
                   information=information, count=n.to(torch.int32),
                   covariance=covariance)


def build_ndt_from_scans(scan_poses, scan_points, point_mask, origin,
                         cell_size: float, width: int, height: int) -> NDTGrid:
    """Build an NDT from a window of scans: poses [S, 3], robot-frame
    points [S, P, 2], mask [S, P] (the transform is fused in)."""
    world = pose_ops.transform_points(scan_poses, scan_points)
    return build_ndt(world.reshape(-1, 2), point_mask.reshape(-1), origin,
                     cell_size, width, height)


def packed_cell_table(grid: NDTGrid) -> torch.Tensor:
    """[C, 8]: mean_x, mean_y, i00, i01, i11, scorable (n >= 5), 0, 0."""
    scorable = (grid.count >= 5).to(grid.mean.dtype)
    pad = torch.zeros_like(scorable)
    return torch.stack([grid.mean[:, 0], grid.mean[:, 1],
                        grid.information[:, 0], grid.information[:, 1],
                        grid.information[:, 2], scorable, pad, pad], dim=-1)


def packed_patch_table(grid: NDTGrid, width: int) -> torch.Tensor:
    """[C, 32]: row i packs cells (i, i+1, i+W, i+W+1), each as the 8
    packed_cell_table fields; rows near the end wrap around (consumers clip
    the patch base and mask candidates by the grid bounds)."""
    t = packed_cell_table(grid)
    return torch.cat([t, torch.roll(t, -1, 0), torch.roll(t, -width, 0),
                      torch.roll(t, -(width + 1), 0)], dim=1)


def patch_tables(grid: NDTGrid, width: int) -> torch.Tensor:
    """K1's patch table laid out from the grid's fields: [C, 32], or
    [G, C, 32] for a grid with a grid axis (the overlapping grids)."""
    if grid.mean.dim() == 3:
        return torch.stack([packed_patch_table(g, width)
                            for g in split_grids(grid)])
    return packed_patch_table(grid, width)


def score_at_cells(mean_table, info_table, count_table, points, valid, flat):
    """Clamped Gaussian scores for points with precomputed cell bindings."""
    safe = torch.where(valid, flat, torch.zeros_like(flat)).to(torch.int64)
    mean = mean_table[safe]
    info = info_table[safe]
    scorable = count_table[safe] >= 5
    q = points - mean
    qx, qy = q[..., 0], q[..., 1]
    e = -0.5 * (info[..., 0] * qx * qx + 2.0 * info[..., 1] * qx * qy
                + info[..., 2] * qy * qy)
    s = torch.exp(torch.clamp(e, max=0.0))
    return torch.where(valid & scorable, s, torch.zeros_like(s))


def score_points(grid: NDTGrid, points, mask, width: int, height: int):
    """Per-point likelihood exp(-0.5 q^T Lambda q) of [..., 2] world points;
    0 out of grid, masked, or in cells with < 5 points."""
    cell = f32(grid.cell_size, points.device)
    flat, valid = cell_index(grid.origin, cell, width, height, points)
    return score_at_cells(grid.mean, grid.information, grid.count, points,
                          valid & mask, flat)


def likelihood(grid: NDTGrid, points, mask, width: int, height: int):
    """Summed likelihood of a point set (NDT::likelihood)."""
    return torch.sum(score_points(grid, points, mask, width, height), dim=-1)
