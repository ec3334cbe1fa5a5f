"""SE(2) pose utilities on ``[..., 3]`` tensors of ``(x, y, theta)``.

Port of ``ndt_2d_tpu/core/pose.py``: the same expressions in the same
evaluation order, so float32 results round like the reference's.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def normalize_angle(theta: torch.Tensor) -> torch.Tensor:
    """Normalize angle(s) to [-pi, pi)."""
    return theta - TWO_PI * torch.floor((theta + math.pi) / TWO_PI)


def rotate(theta: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Rotate [..., 2] points by angle(s) theta (broadcasting)."""
    c, s = torch.cos(theta), torch.sin(theta)
    x, y = points[..., 0], points[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def transform_points(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply SE(2) pose [..., 3] to robot-frame points [..., P, 2]."""
    return rotate(pose[..., 2:3], points) + pose[..., None, :2]


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pose composition a*b: apply b in a's frame."""
    xy = rotate(a[..., 2], b[..., :2]) + a[..., :2]
    th = a[..., 2] + b[..., 2]
    return torch.cat([xy, th[..., None]], dim=-1)


def inverse(pose: torch.Tensor) -> torch.Tensor:
    """SE(2) inverse of a [..., 3] pose."""
    th = pose[..., 2]
    xy = -rotate(-th, pose[..., :2])
    return torch.cat([xy, -th[..., None]], dim=-1)


def relative(frm: torch.Tensor, to: torch.Tensor) -> torch.Tensor:
    """Transform of ``to`` in ``frm``'s frame; theta is the raw difference."""
    d = to[..., :2] - frm[..., :2]
    xy = rotate(-frm[..., 2], d)
    th = to[..., 2] - frm[..., 2]
    return torch.cat([xy, th[..., None]], dim=-1)
