"""Laser scan projection and motion de-skew: the port's copy of
``ndt_2d_tpu/mapping/laser.py``.

Vectorized equivalent of the projection loop in Mapper::laserCallback
(src/ndt_mapper.cpp:366-453): polar ranges -> robot-frame Cartesian points,
filtered for NaN/over-max-range, transformed by the robot->laser extrinsic,
and per-beam de-skewed by the odometry motion across the scan sweep.

Host-side numpy: per-scan work is tiny (<=few thousand beams) and the
NaN-compaction produces variable counts that must be padded for the device
anyway.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ndt_2d_tpu_torch.utils.sim import LaserScanMsg


def detect_inverted(quaternion) -> bool:
    """Auto-detect an upside-down laser from the robot->laser rotation.

    The reference flags the laser as inverted when the TF quaternion has a
    significant roll/pitch component: |q.x| > 0.02 or |q.y| > 0.02
    (src/ndt_mapper.cpp:278-283).

    Args:
      quaternion: (x, y, z, w) robot->laser rotation.
    """
    q = np.asarray(quaternion, np.float64)
    return bool(abs(q[0]) > 0.02 or abs(q[1]) > 0.02)


def quaternion_yaw(quaternion) -> float:
    """Yaw of an (x, y, z, w) quaternion (tf2::getYaw used by the
    reference's fromMsg converters, include/ndt_2d/conversions.hpp:40-62)."""
    x, y, z, w = np.asarray(quaternion, np.float64)
    return float(np.arctan2(2.0 * (w * z + x * y),
                            1.0 - 2.0 * (y * y + z * z)))


def extrinsic_from_transform(translation, quaternion):
    """Derive the 2D laser extrinsic + inverted flag from a 3D transform.

    Mirrors the reference's first-scan laser setup (ndt_mapper.cpp:271-290):
    ``laser_transform = fromMsg(t)`` keeps (x, y, yaw); the roll/pitch
    content of the quaternion only feeds the inverted-laser heuristic.

    Returns ((x, y, yaw) ndarray, inverted bool).
    """
    t = np.asarray(translation, np.float64)
    return (np.asarray([t[0], t[1], quaternion_yaw(quaternion)]),
            detect_inverted(quaternion))


def project_scan(msg: LaserScanMsg,
                 range_max: float,
                 laser_transform: np.ndarray = np.zeros(3),
                 laser_inverted: bool = False,
                 translation: Optional[np.ndarray] = None,
                 max_points: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """Project a LaserScan to padded, de-skewed robot-frame points.

    Args:
      msg: the scan message.
      range_max: max usable range (beams beyond are dropped,
        ndt_mapper.cpp:413, :436).
      laser_transform: (x, y, theta) robot->laser extrinsic
        (ndt_mapper.cpp:276-285).
      laser_inverted: mirrored-laser branch (ndt_mapper.cpp:408-430); beam
        angles negate and iteration runs from the last beam down to index 1.
      translation: (dx, dy, dtheta) odometry motion from scan start to scan
        end, used for per-beam de-skew (ndt_mapper.cpp:385-395); None = no
        motion.
    Returns (points [max_points, 2] float32, mask [max_points] bool).
    """
    ranges = np.asarray(msg.ranges, np.float64)
    n = ranges.shape[0]
    if translation is None:
        translation = np.zeros(3)
    trans_per_meas = np.asarray(translation, np.float64) / max(n, 1)

    cos_lt, sin_lt = np.cos(laser_transform[2]), np.sin(laser_transform[2])

    if laser_inverted:
        # Reference iterates i = n-1 .. 1 (skips beam 0, ndt_mapper.cpp:410).
        idx = np.arange(n - 1, 0, -1)
        angle = -(msg.angle_min + idx * msg.angle_increment)
        # Residual motion for beam i: translation - trans_per_meas * i
        frac = -idx
        base = translation
    else:
        idx = np.arange(n)
        angle = msg.angle_min + idx * msg.angle_increment
        frac = idx
        base = np.zeros(3)

    r = ranges[idx]
    keep = ~np.isnan(r) & (r <= range_max)
    idx, angle, r, frac = idx[keep], angle[keep], r[keep], frac[keep]

    # Laser-frame point.
    lx, ly = np.cos(angle) * r, np.sin(angle) * r
    # Robot frame via extrinsic.
    px = cos_lt * lx - sin_lt * ly + laser_transform[0]
    py = sin_lt * lx + cos_lt * ly + laser_transform[1]
    # De-skew: rotate/translate by the per-beam share of the sweep motion.
    tt = base[2] + trans_per_meas[2] * frac
    tx = base[0] + trans_per_meas[0] * frac
    ty = base[1] + trans_per_meas[1] * frac
    ct, st = np.cos(tt), np.sin(tt)
    qx = ct * px - st * py + tx
    qy = st * px + ct * py + ty

    m = min(len(qx), max_points)
    points = np.zeros((max_points, 2), np.float32)
    mask = np.zeros(max_points, bool)
    points[:m, 0] = qx[:m]
    points[:m, 1] = qy[:m]
    mask[:m] = True
    return points, mask
