"""Spatially-sharded NDT: the global map's rows split into y-stripes over
the mesh's ``space`` axis.

Port of ``ndt_2d_tpu/parallel/ndt_blocks.py``, for a map too large for one
device (district localization).  Rank s of a ``space`` line of S ranks
holds the grid rows [s h, (s + 1) h), h = H / S:

* **build** (KB1, ``kernels/ndt_build.py::build_stripe``): the points are
  replicated; each rank bins them against the map's GLOBAL origin and
  builds its stripe's cells, bitwise the same rows of the dense K1 grid;
* **score / measure** (KB2, ``kernels/score_points.py``): each rank scores
  the points or beams in its stripe (K3's particle launch reading the
  stripe's table, one record a beam), the partials are gathered over
  ``space`` and added in rank order (K12's ``rank_sum``) where JAX psums,
  then divided by the beams used;
* **match** (KB3, ``kernels/candidate_gather.py``): each rank scores the
  whole lattice against its stripe into a raw [A, L, L] field, the fields
  are gathered over ``space``, and one launch on every rank adds them in
  rank order, reduces the sum and folds it into the match's row
  (``field_match``, through a ``FieldPlan``: two launches a match).

Every combine is a gather and a rank-ordered sum, so every rank holds the
same bits.  The stripes' partial sums associate differently from the dense
single-grid sum, exactly as JAX's psum does; at S = 1 every result is the
dense K3 / K6 one bit for bit.  ``mesh`` is ``parallel/mesh.py``'s.
"""

from __future__ import annotations

import dataclasses

import torch

from ndt_2d_tpu_torch.config import ScanMatcherConfig
from ndt_2d_tpu_torch.kernels import candidate_gather as k6
from ndt_2d_tpu_torch.kernels import candidate_scores as k2
from ndt_2d_tpu_torch.kernels import ndt_build as k1
from ndt_2d_tpu_torch.kernels import score_points as k3
from ndt_2d_tpu_torch.kernels import shard_combine
from ndt_2d_tpu_torch.ndt import grid as ndt_grid
from ndt_2d_tpu_torch.parallel import distributed
from ndt_2d_tpu_torch.parallel.mesh import (
    BATCH_AXIS, SPACE_AXIS, axis_group, axis_rank, axis_size)


@dataclasses.dataclass
class StripeGrid(ndt_grid.NDTGrid):
    """This rank's stripe of a sharded map: the NDTGrid fields of its
    ``rows`` x ``width`` cells (origin the whole map's), the grid rows
    [row0, row0 + rows) they hold, and KB1's patch table [rows * width,
    32]."""

    table: torch.Tensor = None
    width: int = 0
    row0: int = 0
    rows: int = 0


def _stripe_params(height: int, n_shards: int) -> int:
    if height % n_shards:
        raise ValueError(f"grid height {height} must divide the shard "
                         f"count {n_shards}")
    return height // n_shards


def _space_sum(mesh, partial):
    """The stripes' partials added in rank order, on every rank."""
    return shard_combine.rank_sum(distributed.gather(
        partial, axis_group(mesh, SPACE_AXIS)))


def build_ndt_sharded(mesh, poses, points, point_mask, window_mask, origin,
                      cell_size, width: int, height: int) -> StripeGrid:
    """This rank's y-stripe of the NDT of a window of scans (KB1): poses
    [S, 3], robot-frame points [S, P, 2], point_mask [S, P], window_mask
    [S], the map's ``origin`` [2]; replicated inputs, no collective.
    Raises ValueError unless ``height`` divides over ``space``."""
    h = _stripe_params(height, axis_size(mesh, SPACE_AXIS))
    row0 = axis_rank(mesh, SPACE_AXIS) * h
    origin = torch.as_tensor(origin, dtype=torch.float32,
                             device=poses.device).contiguous()
    g, table = k1.build_stripe(poses, points, point_mask, window_mask,
                               origin, float(cell_size), width, row0, h)
    return StripeGrid(origin=g.origin, cell_size=g.cell_size, mean=g.mean,
                      information=g.information, count=g.count,
                      covariance=g.covariance, table=table, width=width,
                      row0=row0, rows=h)


def gather_grid(mesh, grid: StripeGrid) -> ndt_grid.NDTGrid:
    """The whole map on every rank: the stripes' fields gathered in rank
    order, which is row order ([H * W] cells, JAX's stripe-major
    layout)."""
    group = axis_group(mesh, SPACE_AXIS)

    def full(x):
        every = distributed.gather(x, group)
        return every.reshape(-1, *x.shape[1:])
    return ndt_grid.NDTGrid(origin=grid.origin, cell_size=grid.cell_size,
                            mean=full(grid.mean),
                            information=full(grid.information),
                            count=full(grid.count),
                            covariance=full(grid.covariance))


def score_points_sharded(mesh, grid: StripeGrid, points, mask):
    """Summed likelihood of world points [N, 2] (mask [N]) against the
    sharded map: a 0-d tensor, the same bits on every rank (KB2 on each
    stripe, then the rank-ordered sum)."""
    part = k3.stripe_points(grid, grid.table, grid.width, grid.row0,
                            grid.rows, points.contiguous(),
                            mask.contiguous())
    return _space_sum(mesh, part)[0]


def score_particles_sharded_map(config: ScanMatcherConfig, mesh,
                                grid: StripeGrid, points, point_mask,
                                num_points: int, particle_poses):
    """Particle measurement over both mesh axes: each rank scores its
    ``batch`` block of the particles [N, 3] against its map stripe (KB2),
    the stripes' partials are added in rank order over ``space`` and
    divided by the beams used, and the blocks are gathered over ``batch``.
    Returns [N] mean negative scores (the filter's weight convention) on
    every rank.  N must divide over the batch shards."""
    n_batch = axis_size(mesh, BATCH_AXIS)
    N = particle_poses.shape[0]
    if N % n_batch:
        raise ValueError(f"particle count {N} must divide the "
                         f"{BATCH_AXIS!r} shard count {n_batch}")
    b = axis_rank(mesh, BATCH_AXIS)
    mine = particle_poses[b * (N // n_batch):(b + 1) * (N // n_batch)]
    part = k3.stripe_poses(grid, grid.table, grid.width, grid.row0,
                           grid.rows, config.laser_max_beams, points,
                           point_mask, num_points, mine.contiguous())
    used = min(int(config.laser_max_beams), int(num_points))
    total = _space_sum(mesh, part) / ndt_grid.f32(max(used, 1),
                                                  points.device)
    every = distributed.gather(total, axis_group(mesh, BATCH_AXIS))
    return every.reshape(-1)


def match_scan_sharded_map(config: ScanMatcherConfig, mesh,
                           grid: StripeGrid, points, point_mask,
                           num_points: int, pose) -> k2.MatchResult:
    """matchScan against a sharded map: each rank's raw [A, L, L] field of
    its stripe (KB3, K6's per-candidate gather) into its plan's send
    buffer, the fields gathered over ``space`` into the plan's stack, then
    one launch adds them in rank order, reduces and folds them on every
    rank (``k6.field_match``).  The search always takes the gather path,
    whatever the lattice's width, as JAX's does.  Returns a MatchResult of
    0-d / [3] / [3, 3] tensors."""
    dev = points.device
    dths, dls = k2.search_offsets(config, dev)
    S, A, L = axis_size(mesh, SPACE_AXIS), dths.shape[0], dls.shape[0]
    plan = k6.field_plan(dev, S, A, L)
    k6.stripe_field(config, grid, grid.table, grid.row0, grid.rows, points,
                    point_mask, num_points, pose, dths, dls, out=plan.send)
    gathered = distributed.gather(plan.send, axis_group(mesh, SPACE_AXIS),
                                  out=plan.stack.view(S, A, L, L))
    out = k6.field_match(config, plan, gathered, int(num_points), dths, dls)
    return k2.MatchResult(out[0], out[1:4], out[4:13].view(3, 3))
