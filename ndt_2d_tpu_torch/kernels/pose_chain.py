"""K13: the pipelined paths' pose chain on the device (CUDA
``csrc/pose_chain.cu``) and its twins.

Replaces the pose arithmetic of ``ndt_2d_tpu/matching/matcher.py::
mapping_step_async`` (:657-666) and ``localization_step_async``
(:697-705): ``compose`` dead-reckons the step's start pose from the
previous corrected pose and the odometry motion in the previous robot
frame; ``apply`` adds the search's correction and, while mapping, writes
the corrected pose into the rolling window's newest slot.  Both read and
write device tensors only, so a step needs no host read.  The twins are
the same float32 expressions as eager torch operations; the kernel is
built with ``-fmad=false``, so on the same CUDA inputs the two agree
bitwise.
"""

from __future__ import annotations

import ctypes

import torch

from ndt_2d_tpu_torch.kernels import _build

compose_launches = 0
apply_launches = 0


def compose_twin(prev, delta):
    """Plain-PyTorch compose: prev [3] and delta [3] f32 -> pose [3]."""
    c, s = torch.cos(prev[2]), torch.sin(prev[2])
    th = prev[2] + delta[2]
    return torch.stack([prev[0] + c * delta[0] - s * delta[1],
                        prev[1] + s * delta[0] + c * delta[1],
                        torch.atan2(torch.sin(th), torch.cos(th))])


def apply_twin(pose, correction, window_poses=None):
    """Plain-PyTorch apply: pose + correction [3]; with ``window_poses``
    [D, 3] the result also goes into its last row (in place)."""
    new_pose = pose + correction
    if window_poses is not None:
        window_poses[-1] = new_pose
    return new_pose


def _check3(dev, **tensors):
    for name, t in tensors.items():
        _build.require(t, name, torch.float32, (3,), dev)


def compose(prev, delta):
    """The step's start pose from the previous corrected pose ``prev`` [3]
    and the odometry motion ``delta`` [3] in prev's robot frame (float32).
    CPU tensors run the twin; CUDA tensors launch the kernel."""
    global compose_launches
    if prev.device.type == "cpu":
        return compose_twin(prev, delta)
    dev = prev.device
    _check3(dev, prev=prev, delta=delta)
    pose = torch.empty(3, dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _build.function("ndt2d_pose_compose", [ctypes.c_void_p] * 4)(
        p(prev), p(delta), p(pose), _build.stream_ptr(dev))
    _build.check(err, "pose_compose")
    compose_launches += 1
    return pose


def apply(pose, correction, window_poses=None):
    """pose [3] + correction [3] (a view of the search's output row) into
    a new [3] tensor, also written into the last row of ``window_poses``
    [D, 3] when given.  CPU tensors run the twin; CUDA tensors launch the
    kernel."""
    global apply_launches
    if pose.device.type == "cpu":
        return apply_twin(pose, correction, window_poses)
    dev = pose.device
    _check3(dev, pose=pose, correction=correction)
    slot = None
    if window_poses is not None:
        _build.require(window_poses, "window_poses", torch.float32,
                       (window_poses.shape[0], 3), dev)
        slot = window_poses[-1]
    new_pose = torch.empty(3, dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _build.function("ndt2d_pose_apply", [ctypes.c_void_p] * 5)(
        p(pose), p(correction), p(new_pose),
        None if slot is None else p(slot), _build.stream_ptr(dev))
    _build.check(err, "pose_apply")
    apply_launches += 1
    return new_pose
