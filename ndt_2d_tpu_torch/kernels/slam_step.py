"""KB4: the fused SLAM step's append (CUDA ``csrc/slam_step.cu``) and its
twin.

Replaces the state update of ``ndt_2d_tpu/parallel/slam_step.py::
make_slam_step`` (:99-124): the corrected pose, the scan into slot ``i`` of
the padded scan buffers, the odometry constraint of
``core/constraint.py::make_constraint`` into slot ``j`` and the new
previous pose, in one launch with no host read.  The state's tensors are
updated IN PLACE (JAX returns new arrays).  Kernel and twin compute in the
same order and agree bitwise.
"""

from __future__ import annotations

import ctypes

import torch

from ndt_2d_tpu_torch.core import constraint as constraint_ops
from ndt_2d_tpu_torch.kernels import _build

launches = 0

_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
         + [ctypes.c_int] + [ctypes.c_void_p] * 9)


def append_twin(state, est_pose, correction, covariance, scan_points,
                scan_mask, i: int, j: int, has_prior: bool) -> None:
    """Plain-PyTorch KB4 on ``state`` (a ``parallel.slam_step.SlamState``),
    in place."""
    pose = est_pose + correction if has_prior else est_pose.clone()
    _, _, transform, information, _ = constraint_ops.make_constraint(
        max(i - 1, 0), i, state.prev_pose, pose, covariance)
    state.points[i] = scan_points
    state.point_mask[i] = scan_mask
    state.c_transform[j] = transform
    state.c_information[j] = information
    state.c_begin[j] = max(i - 1, 0)
    state.c_end[j] = i
    state.poses[i] = pose
    state.prev_pose.copy_(pose)


def append(state, est_pose, correction, covariance, scan_points, scan_mask,
           i: int, j: int, has_prior: bool) -> None:
    """KB4: est_pose [3], correction [3], covariance [3, 3] f32 (the
    match's), scan_points [P, 2] f32, scan_mask [P] bool; scan slot ``i``
    and constraint slot ``j`` (host ints, checked against the capacities).
    CPU tensors run the twin; CUDA tensors launch the kernel."""
    global launches
    S, P = state.points.shape[0], state.points.shape[1]
    C = state.c_begin.shape[0]
    if not (0 <= i < S and 0 <= j < C):
        raise ValueError(f"slots ({i}, {j}) outside the state's capacity "
                         f"({S} scans, {C} constraints)")
    if est_pose.device.type == "cpu":
        return append_twin(state, est_pose, correction, covariance,
                           scan_points, scan_mask, i, j, has_prior)
    dev = est_pose.device
    req = _build.require
    req(est_pose, "est_pose", torch.float32, (3,), dev)
    req(correction, "correction", torch.float32, (3,), dev)
    req(covariance, "covariance", torch.float32, (3, 3), dev)
    req(scan_points, "scan_points", torch.float32, (P, 2), dev)
    req(scan_mask, "scan_mask", torch.bool, (P,), dev)
    req(state.poses, "poses", torch.float32, (S, 3), dev)
    req(state.points, "points", torch.float32, (S, P, 2), dev)
    req(state.point_mask, "point_mask", torch.bool, (S, P), dev)
    req(state.c_begin, "c_begin", torch.int32, (C,), dev)
    req(state.c_end, "c_end", torch.int32, (C,), dev)
    req(state.c_transform, "c_transform", torch.float32, (C, 3), dev)
    req(state.c_information, "c_information", torch.float32, (C, 3, 3), dev)
    req(state.prev_pose, "prev_pose", torch.float32, (3,), dev)
    p = _build.ptr
    err = _build.function("ndt2d_slam_append", _ARGS)(
        p(est_pose), p(correction), p(covariance), int(bool(has_prior)),
        int(i), int(j), max(int(i) - 1, 0), p(scan_points), p(scan_mask), P,
        p(state.poses), p(state.points), p(state.point_mask),
        p(state.c_begin), p(state.c_end), p(state.c_transform),
        p(state.c_information), p(state.prev_pose), _build.stream_ptr(dev))
    _build.check(err, "slam_append")
    launches += 1
