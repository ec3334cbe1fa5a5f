"""Multi-device particle-filter measurement: particles sharded over the
mesh's ``batch`` axis.

Port of ``ndt_2d_tpu/parallel/filter.py::measure_multichip``.  Each rank of a
``batch`` line scores its contiguous block of particles against the replicated
global NDT (K3's particle launch with the motion off, reading each cell's
record from the patch table); the blocks' scores are all-gathered in rank
order.  The motion sample before it is K9's own launch (the filter's
``_motion_and_measure``), the body that one device's step folds into the
particle launch.  A pose's score does not depend on the batch it rides in, so
the sharded measurement equals the single-device one bitwise.  The motion
draws, the resampling and the statistics stay replicated: every rank's
generator is seeded alike and sees the same scores.
"""

from __future__ import annotations

import torch

from ndt_2d_tpu_torch.kernels import score_points as k3
from ndt_2d_tpu_torch.ndt import grid as ndt_grid
from ndt_2d_tpu_torch.parallel import distributed
from ndt_2d_tpu_torch.parallel.mesh import (
    BATCH_AXIS, axis_group, axis_rank, axis_size)


def measure_multichip(config, mesh, grid, points, point_mask,
                      num_points: int, particles, packed_table=None):
    """[M] measurement scores of ``particles`` [M, 3] with the particle
    axis sharded over the mesh's ``batch`` axis (padded to a multiple of
    its size with zero poses, whose scores are dropped), each cell read
    from its record in ``packed_table`` (K1's patch table of ``grid``;
    without it the table is laid out from the grid)."""
    if packed_table is None:
        packed_table = ndt_grid.patch_tables(grid, config.grid_cells_x)
    M = particles.shape[0]
    S, s = axis_size(mesh, BATCH_AXIS), axis_rank(mesh, BATCH_AXIS)
    m = -(-M // S)
    mine = particles[s * m:(s + 1) * m]
    if mine.shape[0] < m:
        mine = torch.cat([mine, torch.zeros(m - mine.shape[0], 3,
                                            dtype=particles.dtype,
                                            device=particles.device)])
    scores = k3.score_records(grid, packed_table, config.grid_cells_x,
                              config.grid_cells_y, config.laser_max_beams,
                              points, point_mask, num_points,
                              mine.contiguous())
    every = distributed.gather(scores, axis_group(mesh, BATCH_AXIS))
    return every.reshape(-1)[:M]
