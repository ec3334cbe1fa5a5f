"""Sample-based odometry motion model.

Port of ``ndt_2d_tpu/filter/motion_model.py`` (the reference's
MotionModel::sample, src/motion_model.cpp:45-83).  The scalar part, the
rot1/trans/rot2 decomposition, the reverse-motion guard and the three
sigmas, is computed here on the host in float32, expression for expression
as the reference computes it; the per-particle part runs on K9
(``kernels/particle_filter.py::motion``) with a pre-drawn tensor of
standard normals in place of the reference's PRNG key.

Note: alpha5 is stored but unused by the reference sampler
(src/motion_model.cpp:60-66); so here.
"""

from __future__ import annotations

import math

import torch

from ndt_2d_tpu_torch.core.pose import normalize_angle
from ndt_2d_tpu_torch.kernels import particle_filter as k9


def _hypot(x, y):
    """``jnp.hypot`` as the reference evaluates it: big * sqrt(1 +
    (small / big)^2)."""
    x, y = torch.abs(x), torch.abs(y)
    big, small = torch.maximum(x, y), torch.minimum(x, y)
    safe = torch.where(big == 0, torch.ones_like(big), big)
    return torch.where(big == 0, big,
                       big * torch.sqrt(1 + torch.square(small / safe)))


def motion_scalars(dx, dy, dth, a1, a2, a3, a4) -> tuple:
    """(rot1, trans, rot2, sigma_rot1, sigma_trans, sigma_rot2) of the
    relative motion (dx, dy, dth) with noise gains a1..a4, as float32
    values in Python floats."""
    dx, dy, dth, a1, a2, a3, a4 = [torch.tensor(float(v), dtype=torch.float32)
                                   for v in (dx, dy, dth, a1, a2, a3, a4)]
    trans = _hypot(dx, dy)
    rot1 = torch.where(trans > 0.01, torch.atan2(dy, dx),
                       torch.zeros_like(trans))
    # angle_diff(from, to) = normalize(to - from)
    rot2 = normalize_angle(dth - rot1)

    # Reverse-motion guard (src/motion_model.cpp:53-57).
    rot1_ = torch.minimum(torch.abs(normalize_angle(-rot1)),
                          torch.abs(normalize_angle(math.pi - rot1)))
    rot2_ = torch.minimum(torch.abs(normalize_angle(-rot2)),
                          torch.abs(normalize_angle(math.pi - rot2)))

    sigma_rot1 = torch.sqrt(a1 * rot1_ * rot1_ + a2 * trans * trans)
    sigma_trans = torch.sqrt(a3 * trans * trans
                             + a4 * rot1_ * rot1_ + a4 * rot2_ * rot2_)
    sigma_rot2 = torch.sqrt(a1 * rot2_ * rot2_ + a2 * trans * trans)
    return tuple(float(v) for v in (rot1, trans, rot2, sigma_rot1,
                                    sigma_trans, sigma_rot2))


def sample(poses, noise, dx, dy, dth, a1, a2, a3, a4):
    """Propagate particles [M, 3] through the noisy motion model, with
    ``noise`` [M, 3] standard normals (the reference draws them from its
    key)."""
    return k9.motion(poses, noise, motion_scalars(dx, dy, dth, a1, a2, a3,
                                                  a4))
