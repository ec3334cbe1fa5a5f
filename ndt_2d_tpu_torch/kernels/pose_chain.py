"""K13: the rolling window's append, with the pipelined paths' corrected
pose (CUDA ``csrc/pose_chain.cu``), and its twins.

Replaces ``ndt_2d_tpu/matching/matcher.py::window_append`` (:485-493) and
the pose arithmetic of ``mapping_step_async`` (:668-669) and
``localization_step_async`` (:699): ``window_append`` adds the search's
correction to the step's pose where one is given, and shifts the rolling
window left by one scan IN PLACE, the new scan and that pose in its last
slot, all in one launch.  Without a window it writes the corrected pose
alone (localization).  The step's start pose (``compose_twin``, JAX's
:660-664 and :691-695) is dead-reckoned inside K3's single-pose launch
(``score_points.score_composed``), so a pipelined step needs no host read
and no launch of its own for it.  The twins are the same float32
expressions as eager torch operations; the kernel is built with
``-fmad=false``, so on the same CUDA inputs the two agree bitwise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ndt_2d_tpu_torch.kernels import _build

launches = 0

# pose, correction, new_pose, the window's poses, points, point mask and
# mask, the new points and point mask, D, P, stream.
_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def compose_twin(prev, delta):
    """Plain-PyTorch compose: prev [3] and delta [3] f32 -> pose [3]."""
    c, s = torch.cos(prev[2]), torch.sin(prev[2])
    th = prev[2] + delta[2]
    return torch.stack([prev[0] + c * delta[0] - s * delta[1],
                        prev[1] + s * delta[0] + c * delta[1],
                        torch.atan2(torch.sin(th), torch.cos(th))])


def window_append_twin(pose, correction=None, window=None, points=None,
                       point_mask=None):
    """Plain-PyTorch ``window_append``: v = pose + correction (or pose);
    with ``window`` each of its fields becomes JAX's concatenation of its
    slots 1.. and the new slot (v, points, point_mask, True), written back
    in place.  Returns v when a correction is given, else None."""
    v = pose if correction is None else pose + correction
    if window is not None:
        one = torch.ones((), dtype=torch.bool, device=pose.device)
        for field, new in ((window.poses, v), (window.points, points),
                           (window.point_mask, point_mask),
                           (window.mask, one)):
            field.copy_(torch.cat([field[1:], new[None]]))
    return None if correction is None else v


@functools.lru_cache(maxsize=None)
def _expect(corrected: bool, D: int, P: int):
    """The (name, dtype, shape) of each tensor of a launch: the pose, the
    correction if given, and with D > 0 the window's fields and the new
    scan."""
    f32, b = torch.float32, torch.bool
    out = (("pose", f32, (3,)),)
    if corrected:
        out += (("correction", f32, (3,)),)
    if D:
        out += (("window.poses", f32, (D, 3)),
                ("window.points", f32, (D, P, 2)),
                ("window.point_mask", b, (D, P)), ("window.mask", b, (D,)),
                ("points", f32, (P, 2)), ("point_mask", b, (P,)))
    return out


def window_append(pose, correction=None, window=None, points=None,
                  point_mask=None):
    """The step's pose [3] f32 plus ``correction`` [3] (a view of the
    search's output row) when given; with ``window`` (a rolling window:
    poses [D, 3] f32, points [D, P, 2] f32, point_mask [D, P] bool, mask
    [D] bool) that pose, ``points`` [P, 2] f32 and ``point_mask`` [P] bool
    appended as its newest slot, the window shifted left IN PLACE.
    Returns the corrected pose as a new [3] tensor when a correction is
    given, else None.  CPU tensors run the twin; CUDA tensors launch the
    kernel."""
    global launches
    dev = pose.device
    if dev.type == "cpu":
        return window_append_twin(pose, correction, window, points,
                                  point_mask)
    corrected = correction is not None
    given = (pose, correction) if corrected else (pose,)
    D = P = 0
    scan = (None,) * 6
    if window is not None:
        D, P = window.points.shape[:2]
        scan = (window.poses, window.points, window.point_mask, window.mask,
                points, point_mask)
        given += scan
    _build.require_all(dev, given, _expect(corrected, D, P))
    new_pose = pose.new_empty(3) if corrected else None
    ptrs = [None if t is None else t.data_ptr()
            for t in (pose, correction, new_pose, *scan)]
    err = _build.function("ndt2d_window_append", _ARGS)(
        *ptrs, D, P, _build.stream_ptr(dev))
    _build.check(err, "window_append")
    launches += 1
    return new_pose
