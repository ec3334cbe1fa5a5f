"""Scan-log ("bag") format: recorded laser + odometry streams; the port's
copy of ``ndt_2d_tpu/io/bag.py`` (the same npz and ``.ndtbag`` schemas).

The reference consumes live ROS topics; its file story is rosbag2 replay.
Our replacement is a flat npz log holding the full session — laser ranges,
sensor intrinsics, odometry poses, optional ground truth — which drives the
mapper deterministically (CLI `run`/`localize`) and the benchmarks.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np

from ndt_2d_tpu_torch.utils.sim import LaserScanMsg


@dataclasses.dataclass
class ScanBag:
    """A recorded session: [T] scans of N beams each."""

    ranges: np.ndarray            # [T, N] float32; NaN = invalid
    angle_min: float
    angle_increment: float
    time_increment: float
    range_max: float
    odom: np.ndarray              # [T, 3] odometry-frame poses
    truth: Optional[np.ndarray] = None   # [T, 3] ground truth (sim only)
    # [T] per-scan capture timestamps (seconds; e.g. from a CARMEN log).
    # When present, run_bag interpolates the sweep-end odometry pose at
    # time[t] + time_increment * (N - 1) instead of assuming the sweep spans
    # the whole inter-scan interval, so de-skew works on imported data.
    times: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.ranges.shape[0]

    def __getitem__(self, t: int) -> Tuple[LaserScanMsg, np.ndarray]:
        return (LaserScanMsg(
            ranges=self.ranges[t], angle_min=self.angle_min,
            angle_increment=self.angle_increment,
            time_increment=self.time_increment,
            range_max=self.range_max), self.odom[t])

    def __iter__(self) -> Iterator[Tuple[LaserScanMsg, np.ndarray]]:
        for t in range(len(self)):
            yield self[t]


def save_bag(bag: ScanBag, path: str) -> None:
    if path.endswith(".ndtbag"):
        # Native binary format (large sequential I/O, no compression);
        # npz stays the portable default.
        from ndt_2d_tpu_torch.io import native
        native.save_bag(bag, path)
        return
    data = dict(
        ranges=bag.ranges.astype(np.float32),
        angle_min=np.float64(bag.angle_min),
        angle_increment=np.float64(bag.angle_increment),
        time_increment=np.float64(bag.time_increment),
        range_max=np.float64(bag.range_max),
        odom=bag.odom.astype(np.float64),
    )
    if bag.truth is not None:
        data["truth"] = bag.truth.astype(np.float64)
    if bag.times is not None:
        data["times"] = np.asarray(bag.times, np.float64)
    np.savez_compressed(path, **data)


def load_bag(path: str) -> ScanBag:
    if path.endswith(".ndtbag"):
        from ndt_2d_tpu_torch.io import native
        return native.load_bag(path)
    with np.load(path) as d:
        return ScanBag(
            ranges=d["ranges"],
            angle_min=float(d["angle_min"]),
            angle_increment=float(d["angle_increment"]),
            time_increment=float(d["time_increment"]),
            range_max=float(d["range_max"]),
            odom=d["odom"],
            truth=d["truth"] if "truth" in d.files else None,
            times=d["times"] if "times" in d.files else None,
        )


def record_synthetic(world_name: str, n_scans: int, n_beams: int = 360,
                     range_max: float = 15.0, scan_noise: float = 0.01,
                     odom_trans_noise: float = 0.008,
                     odom_rot_noise: float = 0.002, seed: int = 0) -> ScanBag:
    """Generate a synthetic bag on one of the built-in worlds/trajectories
    (the BASELINE.json configs)."""
    from ndt_2d_tpu_torch.utils import sim

    if world_name == "corridor":
        world = sim.make_corridor_world(40.0, 3.0)
        xs = 2.0 + 36.0 * np.linspace(0, 1, n_scans)
        ys = 1.5 + 0.2 * np.sin(np.linspace(0, 2 * np.pi, n_scans))
        ths = np.zeros(n_scans)
        ths[1:] = np.arctan2(np.diff(ys), np.diff(xs))
        truth = np.stack([xs, ys, ths], axis=-1)
    elif world_name == "box":
        world = sim.make_box_world(10.0, 8.0)
        ang = np.linspace(0, 2 * np.pi, n_scans)
        truth = np.stack([5.0 + 2.0 * np.cos(ang), 4.0 + 1.5 * np.sin(ang),
                          ang + np.pi / 2.0], axis=-1)
    elif world_name == "office":
        world = sim.make_office_world(16.0)
        waypoints = [(2.0, 2.0), (14.0, 2.0), (14.0, 14.0), (2.0, 14.0),
                     (2.0, 2.6), (8.0, 2.6)]
        pts = []
        for i in range(len(waypoints) - 1):
            a, b = np.asarray(waypoints[i]), np.asarray(waypoints[i + 1])
            seg = max(int(np.hypot(*(b - a)) / 0.3), 1)
            for s in range(seg):
                pts.append(a + (b - a) * s / seg)
        pts = np.asarray(pts)
        idx = np.linspace(0, len(pts) - 1, n_scans).astype(int)
        pts = pts[idx]
        ths = np.zeros(len(pts))
        ths[1:] = np.arctan2(np.diff(pts[:, 1]), np.diff(pts[:, 0]))
        truth = np.concatenate([pts, ths[:, None]], axis=-1)
    else:
        raise ValueError(f"unknown world {world_name!r}")

    rng = np.random.default_rng(seed)
    ranges = []
    for t in range(len(truth)):
        msg = sim.scan_at_pose(world, truth[t], n_beams=n_beams,
                               range_max=range_max, noise=scan_noise, rng=rng)
        ranges.append(msg.ranges)
    odom = sim.drift_odometry(truth, odom_trans_noise, odom_rot_noise, seed)
    return ScanBag(
        ranges=np.asarray(ranges, np.float32),
        angle_min=-np.pi, angle_increment=2 * np.pi / n_beams,
        time_increment=0.0, range_max=range_max, odom=odom, truth=truth)
