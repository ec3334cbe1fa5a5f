"""KB4: the fused SLAM step's append (CUDA ``csrc/slam_step.cu``, its body
``csrc/step_append.cuh``) and its twin.

Replaces the state update of ``ndt_2d_tpu/parallel/slam_step.py::
make_slam_step`` (:99-124): the corrected pose, the scan into slot ``i`` of
the padded scan buffers, the odometry constraint of
``core/constraint.py::make_constraint`` into slot ``j`` and the new
previous pose, in one launch with no host read.  The state's tensors are
updated IN PLACE (JAX returns new arrays).  Kernel and twin compute in the
same order and agree bitwise.

Two forms launch it.  KB4's own launch goes through the state's plan
(``SlamPlan``, ``append``): the state's pointers packed once into a
structure (its tensors never move), so a call checks and passes only the
step's own tensors.  K12's finalize can carry the append in its own launch
(``Append``, read by ``kernels/candidate_scores.py::SplitPlan.finalize``),
where the fused step's search is the split K2 with nothing between it and
the append (``parallel/slam_step.py::append_route``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ndt_2d_tpu_torch.core import constraint as constraint_ops
from ndt_2d_tpu_torch.kernels import _build

# KB4's own launches (the fold's are K12's,
# ``candidate_scores.finalize_append_launches``).
launches = 0

_ARGS = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6


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


def _check_slots(state, i: int, j: int) -> None:
    S, C = state.points.shape[0], state.c_begin.shape[0]
    if not (0 <= i < S and 0 <= j < C):
        raise ValueError(f"slots ({i}, {j}) outside the state's capacity "
                         f"({S} scans, {C} constraints)")


def _state_tensors(state) -> tuple:
    """A state's tensors in ``StepState``'s order."""
    return (state.poses, state.points, state.point_mask, state.c_begin,
            state.c_end, state.c_transform, state.c_information,
            state.prev_pose)


def append(state, est_pose, correction, covariance, scan_points, scan_mask,
           i: int, j: int, has_prior: bool) -> None:
    """KB4: est_pose [3], correction [3], covariance [3, 3] f32 (the
    match's), scan_points [P, 2] f32, scan_mask [P] bool; scan slot ``i``
    and constraint slot ``j`` (host ints, checked against the capacities),
    through the state's plan (``plan_for``).  CPU tensors run the twin;
    CUDA tensors launch the kernel."""
    plan_for(state).append(est_pose, correction, covariance, scan_points,
                           scan_mask, i, j, has_prior)


class _StepState(ctypes.Structure):
    """``struct StepState`` (``csrc/step_append.cuh``)."""

    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "poses", "points", "pmask", "c_begin", "c_end", "c_transform",
        "c_info", "prev")] + [("P", ctypes.c_int)])


@functools.lru_cache(maxsize=None)
def _function():
    """KB4's entry, after checking that ``_StepState`` has the C
    structure's size."""
    theirs = _build.function("ndt2d_slam_plan_size", [])()
    if ctypes.sizeof(_StepState) != theirs:
        raise RuntimeError(f"StepState of {ctypes.sizeof(_StepState)} "
                           f"bytes, the kernels' {theirs}")
    return _build.function("ndt2d_slam_append", _ARGS)


class SlamPlan:
    """KB4 planned for one ``SlamState``: its tensors checked once and
    their pointers packed into a ``StepState``, which stays valid because
    the step updates them in place (``holds`` says whether ``state`` still
    has them).  ``append`` checks the step's own five tensors and makes one
    ctypes call; on CPU tensors it runs ``append_twin``."""

    def __init__(self, state):
        S, P = state.points.shape[0], state.points.shape[1]
        C = state.c_begin.shape[0]
        f32 = torch.float32
        tensors = _state_tensors(state)
        dev = state.poses.device
        _build.require_all(dev, tensors, (
            ("poses", f32, (S, 3)), ("points", f32, (S, P, 2)),
            ("point_mask", torch.bool, (S, P)),
            ("c_begin", torch.int32, (C,)), ("c_end", torch.int32, (C,)),
            ("c_transform", f32, (C, 3)), ("c_information", f32, (C, 3, 3)),
            ("prev_pose", f32, (3,))))
        self.state = state
        self.tensors = tensors
        self.device = dev
        self.eager = dev.type == "cpu"
        est, scan = ("est_pose", f32, (3,)), (("scan_points", f32, (P, 2)),
                                              ("scan_mask", torch.bool, (P,)))
        self._step = (est, ("correction", f32, (3,)),
                      ("covariance", f32, (3, 3))) + scan
        self._fold = (est,) + scan
        self.struct = _StepState(*(t.data_ptr() for t in tensors), P)
        self.address = ctypes.addressof(self.struct)

    def holds(self, state) -> bool:
        """Whether ``state`` is the one packed, with the same tensors."""
        return state is self.state and all(
            a is b for a, b in zip(self.tensors, _state_tensors(state)))

    def check(self, est_pose, correction, covariance, scan_points,
              scan_mask, i: int, j: int) -> None:
        """Raise unless the step's tensors and slots fit the state."""
        _check_slots(self.state, i, j)
        _build.require_all(self.device, (est_pose, correction, covariance,
                                         scan_points, scan_mask), self._step)

    def check_fold(self, est_pose, scan_points, scan_mask, i: int,
                   j: int) -> None:
        """``check`` of the tensors an ``Append`` passes to the finalize."""
        _check_slots(self.state, i, j)
        if not self.eager:
            _build.require_all(self.device, (est_pose, scan_points,
                                             scan_mask), self._fold)

    def append(self, est_pose, correction, covariance, scan_points,
               scan_mask, i: int, j: int, has_prior: bool) -> None:
        """KB4 into the planned state (``append``'s arguments)."""
        global launches
        if self.eager:
            _check_slots(self.state, i, j)
            return append_twin(self.state, est_pose, correction, covariance,
                               scan_points, scan_mask, i, j, has_prior)
        self.check(est_pose, correction, covariance, scan_points, scan_mask,
                   i, j)
        err = _function()(
            self.address, int(bool(has_prior)), int(i), int(j),
            max(int(i) - 1, 0),
            est_pose.data_ptr(), correction.data_ptr(),
            covariance.data_ptr(), scan_points.data_ptr(),
            scan_mask.data_ptr(), _build.stream_ptr(self.device))
        _build.check(err, "slam_append")
        launches += 1


def plan_for(state) -> SlamPlan:
    """The state's ``SlamPlan``, made at its first step (again if its
    tensors were replaced)."""
    plan = state.plan
    if plan is None or not plan.holds(state):
        plan = state.plan = SlamPlan(state)
    return plan


class Append(NamedTuple):
    """The fused step's append, for K12's finalize to carry: the state's
    plan and the step's dead-reckoned pose, scan and slots (``append``'s
    arguments but the match's correction and covariance, which the
    finalize computes)."""

    plan: SlamPlan
    est_pose: torch.Tensor
    scan_points: torch.Tensor
    scan_mask: torch.Tensor
    i: int
    j: int
    has_prior: bool
