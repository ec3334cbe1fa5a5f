"""Pose-graph constraint batch as tensors.

Port of ``ndt_2d_tpu/core/constraint.py``.  The reference represents an edge
as ``Constraint{begin, end, transform(3), information(3x3), switchable}``
(include/ndt_2d/constraint.hpp:39-48) built by ``makeConstraint``
(src/constraint.cpp:35-56).  ``make_constraint`` is the plain-PyTorch twin
of the constraint half of KB4 (``kernels/slam_step.py``): the relative
transform of ``core/pose.py`` and the covariance's inverse by the port's
own LU with partial pivoting (``matching/newton.py::solve3``, K7's), where
JAX calls ``jnp.linalg.inv`` (LAPACK's LU).
"""

from __future__ import annotations

import dataclasses

import torch

from ndt_2d_tpu_torch.core import pose as pose_ops
from ndt_2d_tpu_torch.device import get_device
from ndt_2d_tpu_torch.matching.newton import solve3


@dataclasses.dataclass
class ConstraintBatch:
    """Padded batch of constraints: begin / end [C] int32, transform [C, 3],
    information [C, 3, 3], switchable [C] bool, and ``num``, the host count
    of live constraints."""

    begin: torch.Tensor
    end: torch.Tensor
    transform: torch.Tensor
    information: torch.Tensor
    switchable: torch.Tensor
    num: int = 0

    @property
    def capacity(self) -> int:
        return self.begin.shape[0]

    @property
    def mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.begin.device) < self.num


def empty_constraint_batch(capacity: int, dtype=torch.float32,
                           device=None) -> ConstraintBatch:
    """An empty batch of ``capacity`` slots on ``device`` (CUDA unless
    another is named)."""
    device = get_device(device)
    return ConstraintBatch(
        begin=torch.zeros(capacity, dtype=torch.int32, device=device),
        end=torch.zeros(capacity, dtype=torch.int32, device=device),
        transform=torch.zeros(capacity, 3, dtype=dtype, device=device),
        information=torch.zeros(capacity, 3, 3, dtype=dtype, device=device),
        switchable=torch.zeros(capacity, dtype=torch.bool, device=device))


def inverse3(a: torch.Tensor) -> torch.Tensor:
    """The inverse of a [3, 3] matrix, column by column: ``solve3`` of each
    column of the identity (the three systems as one [3] batch)."""
    rows = [[a[r, q].expand(3) for q in range(3)] for r in range(3)]
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    x = solve3(rows, [eye[r] for r in range(3)])
    return torch.stack(x)


def make_constraint(begin_id, end_id, begin_pose, end_pose, covariance,
                    switchable=False):
    """One constraint, as makeConstraint (src/constraint.cpp:35-56): the
    world-frame delta rotated into begin's frame, theta the raw difference,
    and the information matrix the inverse of ``covariance`` [3, 3].

    Returns (begin, end, transform [3], information [3, 3], switchable)."""
    dev = begin_pose.device
    return (torch.tensor(int(begin_id), dtype=torch.int32, device=dev),
            torch.tensor(int(end_id), dtype=torch.int32, device=dev),
            pose_ops.relative(begin_pose, end_pose), inverse3(covariance),
            torch.tensor(bool(switchable), device=dev))


def append_constraint(batch: ConstraintBatch, begin_id, end_id, transform,
                      information, switchable) -> ConstraintBatch:
    """Write slot ``batch.num`` IN PLACE (JAX returns a new batch) and count
    it; returns the same batch."""
    i = batch.num
    batch.begin[i] = begin_id
    batch.end[i] = end_id
    batch.transform[i] = transform
    batch.information[i] = information
    batch.switchable[i] = switchable
    batch.num = i + 1
    return batch
