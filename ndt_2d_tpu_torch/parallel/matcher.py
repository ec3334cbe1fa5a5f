"""Multi-device scan matching: the lattice search with its angles sharded
over the mesh's ``space`` axis.

Port of ``ndt_2d_tpu/parallel/matcher.py`` (``match_scan_multichip``,
``_padded_angles``): ``matching/matcher.py::match_scan`` with a ``mesh``
runs its search here, then the Newton polish replicated.  The NDT grid
and the scan are replicated; each rank of a ``space`` line scores a
contiguous block of ceil(A / S) angles (K12's ``partial_rows`` of K2 or
K6), the blocks' partials are all-gathered in rank order, and every rank
folds all of them in angle order (K12's ``finalize_rows``).  The fold is
the one the one-launch search makes, so the sharded search equals the
single-device one bitwise, on every rank.

Padding: the last blocks may hold fewer (or no) angles; their slots carry
best = +inf and zero sums and are dropped before the fold.  The JAX mesh
instead pads with angle-0 candidates whose scores it zeroes
(``_padded_angles``); both give the single-device winner, except that on
an all-zero score field JAX's padded slots tie with the real first
candidate (its tie-break keeps the real one) while here they never enter.
"""

from __future__ import annotations

import math

import torch

from ndt_2d_tpu_torch.parallel import distributed
from ndt_2d_tpu_torch.parallel.mesh import (
    SPACE_AXIS, axis_group, axis_rank, axis_size)


def angle_block(n_angles: int, n_shards: int, shard: int):
    """(first angle, count) of ``shard``'s contiguous block of ceil(A / S)
    angles; the count is 0 past the lattice's end."""
    blk = -(-n_angles // n_shards)
    a0 = shard * blk
    return a0, max(0, min(blk, n_angles - a0))


def search_rows(kern, config, mesh, grid, tables, points, point_mask,
                num_points, poses, dths, dls):
    """The lattice search of R rows with the angle axis sharded over the
    mesh's ``space`` axis: [R, 13] output rows, equal on every rank and
    bitwise equal to ``kern.match_rows`` on one device.  ``kern`` is the
    search's kernel module (K2 or K6); the other arguments are its
    ``match_rows``' (``num_points`` an int32 [R] tensor or one int)."""
    S = axis_size(mesh, SPACE_AXIS)
    s = axis_rank(mesh, SPACE_AXIS)
    A = dths.shape[0]
    per = kern.blocks_per_angle(dls)
    a0, n = angle_block(A, S, s)
    slots = -(-A // S) * per
    R, dev = points.shape[0], points.device
    parts = []
    if n:
        parts.append(kern.partial_rows(config, grid, tables, points,
                                       point_mask, num_points, poses, dths,
                                       dls, a0, n))
    if n * per < slots:
        pad = torch.zeros(R, slots - n * per, 12, dtype=torch.float32,
                          device=dev)
        pad[..., 0].fill_(math.inf)
        parts.append(pad)
    mine = torch.cat(parts, 1) if len(parts) > 1 else parts[0]
    every = distributed.gather(mine, axis_group(mesh, SPACE_AXIS))
    every = every.permute(1, 0, 2, 3).reshape(R, S * slots, 12)
    return kern.finalize_rows(config, every[:, :A * per].contiguous(),
                              num_points, dths, dls)
