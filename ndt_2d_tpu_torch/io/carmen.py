"""CARMEN log importer: bring real 2D SLAM datasets into the engine.

The port's own copy of ``ndt_2d_tpu/io/carmen.py`` (numpy only), held to
the original by tests/test_torch_boundary.py.

The classic public 2D laser datasets (Intel Research Lab, MIT Killian
Court, Freiburg, ACES) ship as CARMEN log files.  Two scan line formats
occur in the wild, both supported here:

* the old ``FLASER`` format (Intel/ACES-era logs):

    FLASER n r_1 ... r_n laser_x laser_y laser_th odom_x odom_y odom_th
    ts host log_ts

  (`n` readings over a field of view the line does NOT record — callers set
  ``fov_degrees``, 180 for the classic SICK logs);

* the newer ``ROBOTLASER1`` format (carmen's writeRobotLaserMessage), which
  carries its own geometry:

    ROBOTLASER1 laser_type start_angle fov angular_res max_range accuracy
    remission_mode n r_1 ... r_n n_rem rem_1 ... rem_n_rem
    laser_x laser_y laser_th odom_x odom_y odom_th tv rv
    fwd_safety side_safety turn_axis ts host log_ts

Real logs mix sensor configurations (front + rear laser, reconfigured
sessions); a ScanBag is one fixed [T, N] tensor with one angular layout, so
the importer groups lines by (format, n, start, resolution), keeps the most
common group, and reports everything it skipped — pass a ``CarmenReport``
via ``load_carmen(..., report=...)`` (or watch the WARNING logs) to see the
counts.  Per-line
timestamps are captured into ``ScanBag.times`` so motion de-skew can place
the sweep at its true fraction of the inter-scan interval
(mapping/runtime.py::run_bag).

The reference package has no dataset tooling at all — its only input is a
live ROS topic.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Dict, Optional, Tuple

import numpy as np

from ndt_2d_tpu_torch.io.bag import ScanBag

logger = logging.getLogger("ndt_2d_tpu_torch.carmen")


def _open_text(path: str, mode: str = "rt"):
    """Open a (possibly gzip-compressed) text log — the public datasets ship
    as .log.gz / .clf.gz."""
    if path.endswith(".gz"):
        import gzip
        return gzip.open(path, mode)
    return open(path, mode)


@dataclasses.dataclass
class CarmenReport:
    """What the importer kept and what it skipped."""

    kept: int = 0
    kept_config: Optional[Tuple] = None       # (fmt, n, angle_min, angle_inc)
    skipped_malformed: int = 0
    skipped_other_config: Dict[Tuple, int] = dataclasses.field(
        default_factory=dict)

    @property
    def skipped(self) -> int:
        return self.skipped_malformed + sum(self.skipped_other_config.values())


def _parse_flaser(parts, fov_degrees):
    """One FLASER line -> (config key, ranges, pose_laser, pose_odom, ts)."""
    n = int(parts[1])
    vals = [float(v) for v in parts[2:2 + n + 6]]
    if len(vals) < n + 6:
        raise ValueError("short FLASER line")
    fov = math.radians(fov_degrees)
    key = ("FLASER", n, -fov / 2.0, fov / max(n - 1, 1))
    ts = float(parts[2 + n + 6]) if len(parts) > 2 + n + 6 else None
    return (key, np.asarray(vals[:n], np.float32),
            vals[n:n + 3], vals[n + 3:n + 6], ts)


def _parse_robotlaser1(parts):
    """One ROBOTLASER1 line -> (config key, ranges, laser pose, odom pose,
    ts).  Field layout per carmen's carmen_robot_ackerman_laser_message
    writer (logger format 1)."""
    start_angle = float(parts[2])
    ang_res = float(parts[4])
    n = int(parts[8])
    first = 9
    vals = [float(v) for v in parts[first:first + n]]
    if len(vals) < n:
        raise ValueError("short ROBOTLASER1 readings")
    i = first + n
    n_rem = int(parts[i])
    i += 1 + n_rem                      # skip remissions
    pose = [float(v) for v in parts[i:i + 6]]
    if len(pose) < 6:
        raise ValueError("short ROBOTLASER1 pose block")
    # tv rv fwd_safety side_safety turn_axis, then timestamp
    ts = float(parts[i + 11]) if len(parts) > i + 11 else None
    key = ("ROBOTLASER1", n, start_angle, ang_res)
    return (key, np.asarray(vals, np.float32), pose[0:3], pose[3:6], ts)


def load_carmen(path: str, fov_degrees: float = 180.0,
                range_max: float = None, invalid_beyond: float = 79.0,
                use_laser_pose: bool = True,
                time_increment: float = 0.0,
                report: Optional[CarmenReport] = None) -> ScanBag:
    """Parse a CARMEN .log/.clf file (FLASER and/or ROBOTLASER1 lines).

    Args:
      fov_degrees: laser field of view for FLASER lines, which do not record
        it (classic SICK logs are 180).  ROBOTLASER1 lines carry their own
        start angle / resolution and ignore this.
      range_max: maximum valid range; defaults to ``invalid_beyond``.
      invalid_beyond: readings >= this are out-of-range markers
        (CARMEN logs use values like 81.91) and become NaN.
      use_laser_pose: odometry columns to use — the laser pose (right after
        the readings) or the robot odometry pose (next three).
      time_increment: per-beam time (s) for motion de-skew (a 75 Hz SICK
        LMS-200 over 180 beams is ~13.3 ms/sweep => ~7.4e-5).  CARMEN lines
        record a per-SCAN timestamp but no per-beam time, so this stays a
        caller-supplied sensor constant; 0 disables de-skew (the reference
        behaves the same when a scan carries no time_increment,
        src/ndt_mapper.cpp:368-370).
      report: optional CarmenReport filled with kept/skipped accounting.

    Mixed sensor configurations (front+rear lasers, mid-log reconfigures,
    per-line beam-count changes) are resolved by keeping the most common
    (format, beams, start, resolution) group; every skipped line is counted
    and logged at WARNING.
    """
    rows = {}  # config key -> list of (ranges, pose, ts)
    rep = report if report is not None else CarmenReport()
    with _open_text(path) as f:
        for line in f:
            if line.startswith("FLASER"):
                parser = _parse_flaser
                args = (line.split(), fov_degrees)
            elif line.startswith("ROBOTLASER1"):
                parser = _parse_robotlaser1
                args = (line.split(),)
            else:
                continue
            try:
                key, r, laser_pose, odom_pose, ts = parser(*args)
            except (ValueError, IndexError):
                rep.skipped_malformed += 1
                continue  # malformed line; skip like CARMEN tools do
            pose = laser_pose if use_laser_pose else odom_pose
            rows.setdefault(key, []).append((r, pose, ts))
    if not rows:
        raise ValueError(f"no FLASER/ROBOTLASER1 scans found in {path}")

    key = max(rows, key=lambda k: len(rows[k]))
    kept = rows.pop(key)
    rep.kept = len(kept)
    rep.kept_config = key
    for other, lost in rows.items():
        rep.skipped_other_config[other] = len(lost)
    if rep.skipped:
        logger.warning(
            "%s: kept %d scans of config %s; skipped %d lines "
            "(%d malformed, other configs: %s)", path, rep.kept, key,
            rep.skipped, rep.skipped_malformed,
            {k: v for k, v in rep.skipped_other_config.items()} or "none")

    fmt, n_beams, angle_min, angle_inc = key
    ranges = np.stack([r for r, _, _ in kept])
    if range_max is None:
        range_max = float(invalid_beyond)
    ranges = np.where(ranges >= invalid_beyond, np.nan, ranges)
    ts_vals = [t for _, _, t in kept]
    times = (np.asarray([t for t in ts_vals], np.float64)
             if all(t is not None for t in ts_vals) and len(ts_vals) else None)

    return ScanBag(
        ranges=ranges.astype(np.float32),
        angle_min=float(angle_min),
        angle_increment=float(angle_inc),
        time_increment=float(time_increment),
        range_max=float(range_max),
        odom=np.asarray([p for _, p, _ in kept], np.float64),
        truth=None,
        times=times,
    )


def save_carmen(bag: ScanBag, path: str) -> None:
    """Write a ScanBag as CARMEN FLASER lines (for tooling round-trips)."""
    with _open_text(path, "wt") as f:
        for t in range(len(bag)):
            r = np.where(np.isnan(bag.ranges[t]), 81.91, bag.ranges[t])
            vals = " ".join(f"{v:.3f}" for v in r)
            x, y, th = bag.odom[t]
            stamp = (float(bag.times[t]) if bag.times is not None
                     else 0.1 * t)
            f.write(f"FLASER {bag.ranges.shape[1]} {vals} "
                    f"{x:.6f} {y:.6f} {th:.6f} {x:.6f} {y:.6f} {th:.6f} "
                    f"{stamp:.6f} host {stamp:.6f}\n")
