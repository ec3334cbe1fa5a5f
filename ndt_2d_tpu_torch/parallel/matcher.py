"""Multi-device scan matching: the lattice search with its angles sharded
over the mesh's ``space`` axis.

Port of ``ndt_2d_tpu/parallel/matcher.py`` (``match_scan_multichip``,
``_padded_angles``): ``matching/matcher.py::match_scan`` with a ``mesh``
runs its search here, then the Newton polish replicated.  The NDT grid
and the scan are replicated; each rank of a ``space`` line scores a
contiguous block of ceil(A / S) angles (K12's ``partial_rows`` of K2 or
K6), the blocks' partials are all-gathered in rank order, and every rank
folds all of them in angle order (K12's finalize).  The fold is the one
the one-launch search makes, so the sharded search equals the
single-device one bitwise, on every rank.

Both searches' split runs under a plan (``kernels/candidate_scores.py::
SplitPlan``, at K6's partials an angle for K6): the partials launch writes
the head of the plan's send buffer, the all-gather writes the plan's
stack, and the finalize reads the stack in place (a short or empty last
block's unread tail is its padding).  On an NCCL group, or a group of one
rank, no tensor operation runs between the partials and the finalize;
over gloo the stack comes through the host into the plan's stack.  With
the fused SLAM step's ``append`` (K2 only) the finalize also writes KB4's
append in the same launch.  The JAX mesh instead pads with angle-0
candidates whose scores it zeroes (``_padded_angles``); both give the
single-device winner, except that on an all-zero score field JAX's padded
slots tie with the real first candidate (its tie-break keeps the real one)
while here they never enter.
"""

from __future__ import annotations

import torch

from ndt_2d_tpu_torch.kernels import candidate_scores as k2
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
                num_points, poses, dths, dls, append=None):
    """The lattice search of R rows with the angle axis sharded over the
    mesh's ``space`` axis: [R, 13] output rows, equal on every rank and
    bitwise equal to ``kern.match_rows`` on one device.  ``kern`` is the
    search's kernel module (K2 or K6); the other arguments are its
    ``match_rows``' (``num_points`` an int32 [R] tensor or one int).
    ``append`` (K2 only, a ``kernels.slam_step.Append``): the fused SLAM
    step's KB4, carried by the finalize's launch."""
    if append is not None and kern is not k2:
        raise ValueError("only K2's split search carries the append")
    S = axis_size(mesh, SPACE_AXIS)
    a0, n = angle_block(dths.shape[0], S, axis_rank(mesh, SPACE_AXIS))
    group = axis_group(mesh, SPACE_AXIS)
    plan = k2.split_plan(points.device, S, points.shape[0], dths.shape[0],
                         dls.shape[0], isinstance(num_points, torch.Tensor),
                         kern.blocks_per_angle(dls))
    if n:
        kern.partial_rows(config, grid, tables, points, point_mask,
                          num_points, poses, dths, dls, a0, n,
                          out=plan.head(n))
    every = distributed.gather(plan.send, group, out=plan.stack)
    return plan.finalize(config, every, num_points, dths, dls, append)
