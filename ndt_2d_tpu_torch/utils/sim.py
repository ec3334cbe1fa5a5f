"""Synthetic 2D laser world simulator (host-side, numpy): the port's copy
of ``ndt_2d_tpu/utils/sim.py``, so both packages raycast the same bags.

The reference ships no test data; its behavior is exercised live on robots.
We generate synthetic worlds (box room, corridor, office) and raycast laser
scans along ground-truth trajectories, with optional range noise and odometry
drift, to drive end-to-end tests and benchmarks (BASELINE.json configs).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class LaserScanMsg:
    """Stand-in for sensor_msgs/LaserScan as consumed by laserCallback
    (src/ndt_mapper.cpp:267-453)."""

    ranges: np.ndarray          # [N] float; NaN = invalid
    angle_min: float
    angle_increment: float
    time_increment: float = 0.0
    range_max: float = 30.0


def polygon_segments(vertices: np.ndarray) -> np.ndarray:
    """Closed polygon -> [M, 2, 2] wall segments."""
    v = np.asarray(vertices, np.float64)
    return np.stack([v, np.roll(v, -1, axis=0)], axis=1)


def make_box_world(width: float = 10.0, height: float = 8.0) -> np.ndarray:
    return polygon_segments(
        [(0, 0), (width, 0), (width, height), (0, height)])


def make_corridor_world(length: float = 40.0, width: float = 3.0,
                        n_pillars: int = 6) -> np.ndarray:
    """A long corridor with alternating wall pillars for texture."""
    segs = [polygon_segments([(0, 0), (length, 0), (length, width), (0, width)])]
    for i in range(n_pillars):
        x = (i + 1) * length / (n_pillars + 1)
        side = i % 2
        y0 = 0.0 if side == 0 else width - 0.3
        segs.append(polygon_segments(
            [(x, y0), (x + 0.3, y0), (x + 0.3, y0 + 0.3), (x, y0 + 0.3)]))
    return np.concatenate(segs, axis=0)


def make_office_world(size: float = 16.0) -> np.ndarray:
    """A square office with inner rooms, suitable for loop-closure loops."""
    s = size
    segs = [polygon_segments([(0, 0), (s, 0), (s, s), (0, s)])]
    # Inner block with a corridor ring around it.
    m = s * 0.25
    segs.append(polygon_segments(
        [(m, m), (s - m, m), (s - m, s - m), (m, s - m)]))
    # A few wall stubs off the outer wall for texture.
    for frac in (0.2, 0.5, 0.8):
        x = s * frac
        segs.append(np.asarray([[[x, 0.0], [x, 0.8]]]))
        segs.append(np.asarray([[[x, s], [x, s - 0.8]]]))
        segs.append(np.asarray([[[0.0, x], [0.8, x]]]))
        segs.append(np.asarray([[[s, x], [s - 0.8, x]]]))
    return np.concatenate(segs, axis=0)


def wall_with_doors(p0, p1, doors, door_width: float = 0.9) -> np.ndarray:
    """A straight wall broken by door gaps.

    Args:
      doors: fractions (0..1) along p0->p1 of each door center.
    Returns [K, 2, 2] segments.
    """
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    length = float(np.linalg.norm(p1 - p0))
    u = (p1 - p0) / length
    spans = []
    start = 0.0
    for f in sorted(doors):
        c = f * length
        spans.append((start, c - door_width / 2.0))
        start = c + door_width / 2.0
    spans.append((start, length))
    # Clamp to the wall extent: a door center within door_width/2 of an end
    # must not emit geometry protruding past p0/p1.
    out = [[p0 + max(a, 0.0) * u, p0 + min(b, length) * u] for a, b in spans
           if min(b, length) - max(a, 0.0) > 1e-6]
    return np.asarray(out)


def make_simlab_world() -> np.ndarray:
    """A 28 m research-lab floor plan in the spirit of the Intel Research
    Lab dataset: perimeter offices with doors onto a rectangular ring
    corridor around a partitioned core block, plus furniture clutter.

    Used by the committed CARMEN-format benchmark dataset
    (benchmarks/make_simlab.py) — the environment this engine builds in has
    no network egress, so the classic public logs cannot be fetched; this
    floor plan exercises the same pipeline (CARMEN import -> SLAM with loop
    closures -> occupancy export) on data of comparable structure.
    """
    s = 28.0
    segs = [polygon_segments([(0, 0), (s, 0), (s, s), (0, s)])]
    # Office band walls (y=5 south, y=23 north, x=5 west, x=23 east) with
    # doors onto the corridor.
    segs.append(wall_with_doors((5, 5), (23, 5), [0.15, 0.45, 0.8]))
    segs.append(wall_with_doors((5, 23), (23, 23), [0.2, 0.55, 0.85]))
    segs.append(wall_with_doors((5, 5), (5, 23), [0.3, 0.7]))
    segs.append(wall_with_doors((23, 5), (23, 23), [0.35, 0.7]))
    # Office partitions every ~5.75 m (from the outer wall to the band wall).
    for x in (9.5, 14.0, 18.5):
        segs.append(np.asarray([[[x, 0.0], [x, 5.0]]]))
        segs.append(np.asarray([[[x, s], [x, s - 5.0]]]))
    for y in (9.5, 14.0, 18.5):
        segs.append(np.asarray([[[0.0, y], [5.0, y]]]))
        segs.append(np.asarray([[[s, y], [s - 5.0, y]]]))
    # Core block with two rooms and doors onto the ring corridor.
    segs.append(wall_with_doors((9, 9), (19, 9), [0.3]))
    segs.append(wall_with_doors((9, 19), (19, 19), [0.7]))
    segs.append(np.asarray([[[9.0, 9.0], [9.0, 19.0]]]))
    segs.append(np.asarray([[[19.0, 9.0], [19.0, 19.0]]]))
    segs.append(wall_with_doors((14, 9), (14, 19), [0.5]))
    # Furniture / clutter boxes (desks, cabinets).
    clutter = [(2.0, 2.0, 0.8, 0.5), (11.5, 1.5, 1.2, 0.6),
               (20.5, 3.2, 0.6, 0.6), (25.8, 11.0, 0.5, 1.4),
               (25.5, 20.0, 0.8, 0.8), (16.0, 25.8, 1.4, 0.5),
               (6.2, 25.5, 0.6, 0.9), (1.6, 16.5, 0.5, 1.2),
               (10.5, 11.0, 1.6, 0.7), (16.5, 16.0, 0.7, 1.6),
               (2.5, 24.3, 0.9, 0.6), (24.6, 24.6, 0.7, 0.7)]
    for (cx, cy, w, h) in clutter:
        segs.append(polygon_segments(
            [(cx, cy), (cx + w, cy), (cx + w, cy + h), (cx, cy + h)]))
    return np.concatenate(segs, axis=0)


def resample_polyline(waypoints, step: float) -> np.ndarray:
    """Resample a waypoint polyline at constant arc-length spacing and derive
    headings from the direction of travel.  Returns [T, 3] poses."""
    wp = np.asarray(waypoints, np.float64)
    deltas = np.diff(wp, axis=0)
    seg_len = np.hypot(deltas[:, 0], deltas[:, 1])
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    stations = np.arange(0.0, cum[-1], step)
    xy = np.stack([np.interp(stations, cum, wp[:, i]) for i in (0, 1)],
                  axis=-1)
    th = np.zeros(len(xy))
    d = np.diff(xy, axis=0)
    th[1:] = np.arctan2(d[:, 1], d[:, 0])
    th[0] = th[1] if len(th) > 1 else 0.0
    return np.concatenate([xy, th[:, None]], axis=-1)


def raycast(segments: np.ndarray, origin: np.ndarray, angles: np.ndarray,
            range_max: float) -> np.ndarray:
    """Vectorized ray/segment intersection.

    Args:
      segments: [M, 2, 2]; origin: [2]; angles: [N] world-frame beam angles.
    Returns [N] ranges; NaN where no hit within range_max (matching the
    NaN-filtered LaserScan convention, src/ndt_mapper.cpp:413).
    """
    d = np.stack([np.cos(angles), np.sin(angles)], axis=-1)     # [N, 2]
    a = segments[:, 0]                                          # [M, 2]
    s = segments[:, 1] - segments[:, 0]                         # [M, 2]
    ap = a[None, :, :] - origin[None, None, :]                  # [1->N, M, 2]
    denom = d[:, None, 0] * s[None, :, 1] - d[:, None, 1] * s[None, :, 0]
    denom = np.where(np.abs(denom) < 1e-12, np.nan, denom)
    t = (ap[..., 0] * s[None, :, 1] - ap[..., 1] * s[None, :, 0]) / denom
    u = (ap[..., 0] * d[:, None, 1] - ap[..., 1] * d[:, None, 0]) / denom
    t = np.where((u >= 0.0) & (u <= 1.0) & (t > 1e-6), t, np.inf)
    r = np.nanmin(np.where(np.isnan(t), np.inf, t), axis=1)
    return np.where(r <= range_max, r, np.nan)


def scan_at_pose(segments: np.ndarray, pose: np.ndarray, n_beams: int = 360,
                 fov: float = 2.0 * np.pi, range_max: float = 30.0,
                 noise: float = 0.0,
                 rng: Optional[np.random.Generator] = None) -> LaserScanMsg:
    """Simulate a laser scan from pose (x, y, theta)."""
    angle_min = -fov / 2.0
    inc = fov / n_beams
    beam_angles = pose[2] + angle_min + inc * np.arange(n_beams)
    ranges = raycast(segments, np.asarray(pose[:2], np.float64), beam_angles,
                     range_max)
    if noise > 0.0:
        rng = rng or np.random.default_rng(0)
        ranges = ranges + rng.normal(0.0, noise, size=ranges.shape)
    return LaserScanMsg(ranges=ranges.astype(np.float64), angle_min=angle_min,
                        angle_increment=inc, range_max=range_max)


def project_scan(msg: LaserScanMsg, max_points: int):
    """Project a LaserScanMsg to padded robot-frame points (no de-skew).

    Returns (points [max_points, 2] float32, mask [max_points]).
    """
    valid = ~np.isnan(msg.ranges)
    idx = np.nonzero(valid)[0]
    ang = msg.angle_min + msg.angle_increment * idx
    pts = np.stack([np.cos(ang) * msg.ranges[idx],
                    np.sin(ang) * msg.ranges[idx]], axis=-1)
    n = min(len(idx), max_points)
    points = np.zeros((max_points, 2), np.float32)
    mask = np.zeros(max_points, bool)
    points[:n] = pts[:n]
    mask[:n] = True
    return points, mask


def drift_odometry(true_poses: np.ndarray, trans_noise: float = 0.01,
                   rot_noise: float = 0.002,
                   seed: int = 0) -> np.ndarray:
    """Integrate noisy relative motions to simulate odometry drift.

    Returns [T, 3] odometry-frame poses whose frame-to-frame deltas are the
    ground-truth deltas plus Gaussian noise.
    """
    rng = np.random.default_rng(seed)
    odom = np.zeros_like(true_poses)
    odom[0] = true_poses[0]
    for t in range(1, len(true_poses)):
        prev_t, cur_t = true_poses[t - 1], true_poses[t]
        # true delta in prev frame
        c, s = np.cos(prev_t[2]), np.sin(prev_t[2])
        dx_w, dy_w = cur_t[0] - prev_t[0], cur_t[1] - prev_t[1]
        dx = c * dx_w + s * dy_w + rng.normal(0, trans_noise)
        dy = -s * dx_w + c * dy_w + rng.normal(0, trans_noise)
        dth = (cur_t[2] - prev_t[2]) + rng.normal(0, rot_noise)
        # integrate in odom frame
        po = odom[t - 1]
        c2, s2 = np.cos(po[2]), np.sin(po[2])
        odom[t] = [po[0] + c2 * dx - s2 * dy,
                   po[1] + s2 * dx + c2 * dy,
                   po[2] + dth]
    return odom
