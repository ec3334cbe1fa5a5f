"""Multi-device particle-filter measurement: particles sharded over the
mesh's ``batch`` axis.

Port of ``ndt_2d_tpu/parallel/filter.py::measure_multichip``.  Each rank
of a ``batch`` line scores its contiguous block of particles against the
replicated global NDT (K3 over a pose axis); the blocks' scores are
all-gathered in rank order.  A pose's score does not depend on the batch it
rides in, so the sharded measurement equals the single-device one bitwise.
The motion draws, the resampling and the statistics stay replicated: every
rank's generator is seeded alike and sees the same scores.
"""

from __future__ import annotations

import torch

from ndt_2d_tpu_torch.kernels import score_points as k3
from ndt_2d_tpu_torch.parallel import distributed
from ndt_2d_tpu_torch.parallel.mesh import (
    BATCH_AXIS, axis_group, axis_rank, axis_size)


def measure_multichip(config, mesh, grid, points, point_mask,
                      num_points: int, particles):
    """[M] measurement scores of ``particles`` [M, 3] with the particle
    axis sharded over the mesh's ``batch`` axis (padded to a multiple of
    its size with zero poses, whose scores are dropped)."""
    M = particles.shape[0]
    S, s = axis_size(mesh, BATCH_AXIS), axis_rank(mesh, BATCH_AXIS)
    m = -(-M // S)
    mine = particles[s * m:(s + 1) * m]
    if mine.shape[0] < m:
        mine = torch.cat([mine, torch.zeros(m - mine.shape[0], 3,
                                            dtype=particles.dtype,
                                            device=particles.device)])
    scores = k3.score_batch(grid, config.grid_cells_x, config.grid_cells_y,
                            config.laser_max_beams, points, point_mask,
                            num_points, mine.contiguous())
    every = distributed.gather(scores, axis_group(mesh, BATCH_AXIS))
    return every.reshape(-1)[:M]
