"""The mapper runtime: synchronous rolling-window SLAM on the port's kernels.

Port of the synchronous mapping branch of ``ndt_2d_tpu/mapping/mapper.py``
(the reference's ``ndt_2d::Mapper``):

* ``process_scan`` == laserCallback: motion gate, odometry dead-reckoning,
  de-skewed projection (shared host numpy), then the mapping branch: one
  fused window build (K1) + uncorrected score (K3) + exhaustive match (K2)
  against the device-resident rolling window, the EWMA of match quality,
  and the odometry constraint into the shared host pose graph.
* ``loop_closure`` runs the host radius search; confirming a proposed
  candidate (and the solver behind it) is not ported yet, so a proposal
  raises instead of being skipped.
* ``render_map`` == the occupancy export (K5).

Refused with NotImplementedError rather than approximated: the particle
filter, localization (``enable_mapping=False``), the pipelined path
(``max_inflight > 0``), meshes, and loop searches other than "radius".
"""

from __future__ import annotations

import dataclasses
import logging
from collections import deque
from typing import Optional

import numpy as np
import torch

from ndt_2d_tpu_torch.device import get_device
from ndt_2d_tpu_torch.mapping import occupancy
from ndt_2d_tpu_torch.matching import matcher as matcher_mod
from ndt_2d_tpu_torch.matching import registry
from ndt_2d_tpu_torch.shared import (
    LaserScanMsg, MapperConfig, SessionStats, laser, pose_graph,
    serialization, trim_host_heap)

logger = logging.getLogger("ndt_2d_tpu_torch.mapper")

# The Configure service's save action (srv/Configure.srv), the one ported.
SAVE_TO_FILE = 8


def _normalize_angle(a: float) -> float:
    """Host angle normalization to [-pi, pi), as the reference mapper's."""
    return float(a - 2.0 * np.pi * np.floor((a + np.pi) / (2.0 * np.pi)))


@dataclasses.dataclass
class ScanResult:
    """Outcome of one process_scan call."""

    accepted: bool
    scan_id: int = -1
    pose: Optional[np.ndarray] = None
    uncorrected_score: float = 0.0
    matched_score: float = 0.0
    correction: Optional[np.ndarray] = None


def check_supported(config: MapperConfig) -> None:
    """Raise NotImplementedError for the mapper modes the port lacks."""
    unsupported = [
        (config.use_particle_filter, "use_particle_filter"),
        (not config.enable_mapping, "enable_mapping=False (localization)"),
        (config.max_inflight > 0, "max_inflight > 0 (pipelined mapping)"),
        (config.loop_search != "radius",
         f"loop_search={config.loop_search!r}"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet")


class Mapper:
    def __init__(self, config: MapperConfig = MapperConfig(),
                 laser_transform=np.zeros(3), laser_inverted: bool = False,
                 mesh=None, device=None):
        """Args: the robot->laser extrinsic (x, y, theta) and the
        mirrored-laser flag of the reference's projection
        (ndt_mapper.cpp:271-290); ``device``: ``cuda`` unless ``cpu`` is
        passed (the kernels' twins).  ``mesh`` is refused."""
        if mesh is not None:
            raise NotImplementedError("multi-device meshes are not ported "
                                      "yet")
        check_supported(config)
        self.config = config
        self.device = get_device(device)
        self.range_max = config.max_range

        self.graph = pose_graph.Graph(config.max_points_per_scan,
                                      config.use_barycenter)
        self.laser_transform = np.asarray(laser_transform, np.float64)
        self.laser_inverted = bool(laser_inverted)

        # The rolling-window matcher; loop-closure confirmation (the
        # reference's global matcher) is not ported yet.
        self.local_matcher = None

        self.prev_odom_pose = np.zeros(3)
        self.prev_robot_pose = np.zeros(3)
        self.typical_matcher_response = -0.5   # ndt_mapper.cpp:55
        self.global_scans_processed = 0

        self._scans_since_loop_closure = 0
        self.stats = SessionStats()
        # (query, candidate ids, query position) rows, bounded as in the
        # reference mapper.
        self.lc_log = {"candidates": deque(maxlen=100_000)}
        # Device-resident rolling window, rebuilt from the graph tail
        # whenever it is not the graph's newest rolling_depth scans;
        # _window_synced counts the graph scans it reflects (-1: rebuild).
        self._window = None
        self._window_poses_host = None  # host mirror for capacity checks
        self._window_mask_host = None
        self._window_synced = -1

    # ------------------------------------------------------------------
    def _ensure_matchers(self, msg_range_max: float) -> None:
        """Lazy matcher construction on the first scan, once range_max is
        known (ndt_mapper.cpp:270-313)."""
        if self.local_matcher is not None:
            return
        if self.range_max < 0:
            self.range_max = float(msg_range_max)
        self.local_matcher = registry.create(
            self.config.scan_matcher_type, self.config.local_scan_matcher,
            self.range_max, device=self.device)

    # ------------------------------------------------------------------
    def process_scan(self, msg: LaserScanMsg, odom_pose,
                     odom_pose_end=None) -> ScanResult:
        """laserCallback (ndt_mapper.cpp:267-567)."""
        self._ensure_matchers(msg.range_max)
        odom_pose = np.asarray(odom_pose, np.float64)
        robot_pose = np.zeros(3)

        if self.graph.num_scans:
            # Motion gate (ndt_mapper.cpp:343-355).
            dx = odom_pose[0] - self.prev_odom_pose[0]
            dy = odom_pose[1] - self.prev_odom_pose[1]
            dth = _normalize_angle(odom_pose[2] - self.prev_odom_pose[2])
            dist = dx * dx + dy * dy
            cfg = self.config
            if (dist < cfg.minimum_travel_distance ** 2
                    and abs(dth) < cfg.minimum_travel_rotation):
                self.stats.record_scan(False)
                return ScanResult(accepted=False)
            # Dead-reckon the map-frame pose from the odometry delta,
            # corrected by the odom->map heading offset (ndt_mapper.cpp:357-364).
            heading = _normalize_angle(
                self.prev_robot_pose[2] - self.prev_odom_pose[2])
            ch, sh = np.cos(heading), np.sin(heading)
            robot_pose = np.asarray([
                self.prev_robot_pose[0] + dx * ch - dy * sh,
                self.prev_robot_pose[1] + dx * sh + dy * ch,
                _normalize_angle(self.prev_robot_pose[2] + dth)])

        # De-skew translation: odometry motion across the sweep
        # (ndt_mapper.cpp:366-395).
        if odom_pose_end is not None:
            translation = np.asarray(odom_pose_end, np.float64) - odom_pose
        else:
            translation = np.zeros(3)

        points, mask = laser.project_scan(
            msg, self.range_max, self.laser_transform, self.laser_inverted,
            translation, self.config.max_points_per_scan)
        num_points = int(mask.sum())
        return self._process_mapping(robot_pose, odom_pose, points, mask,
                                     num_points)

    # ------------------------------------------------------------------
    def _sync_window(self) -> matcher_mod.RollingWindow:
        """(Re)build the device rolling window from the graph tail."""
        g = self.graph
        depth = self.config.rolling_depth
        if self._window_synced == g.num_scans and self._window is not None:
            return self._window
        start = max(0, g.num_scans - depth)
        n = g.num_scans - start
        poses = np.zeros((depth, 3), np.float32)
        pts = np.zeros((depth, g.max_points, 2), np.float32)
        pmask = np.zeros((depth, g.max_points), bool)
        wmask = np.zeros(depth, bool)
        if n:  # newest scan occupies the LAST slot (window_append order)
            poses[depth - n:] = g.poses[start:].astype(np.float32)
            pts[depth - n:] = g.points[start:]
            pmask[depth - n:] = g.point_mask[start:]
            wmask[depth - n:] = True
        # torch.tensor copies: window_append writes the window in place,
        # and on the CPU a from_numpy view would also rewrite the host
        # mirrors below.
        dev = self.device
        self._window = matcher_mod.RollingWindow(
            torch.tensor(poses, device=dev), torch.tensor(pts, device=dev),
            torch.tensor(pmask, device=dev), torch.tensor(wmask, device=dev))
        self._window_poses_host = poses
        self._window_mask_host = wmask
        self._window_synced = g.num_scans
        return self._window

    def _check_grid_capacity(self, poses_xy, cfg, what: str, remedy: str):
        """Static-grid capacity check; with config.auto_grow_grids returns
        the next 32-multiple extent (gx, gy) that fits, else raises."""
        if not len(poses_xy):
            return None
        span = poses_xy.max(0) - poses_xy.min(0) + 2 * self.range_max
        need = np.ceil(span / cfg.ndt_resolution) + 1
        if need[0] <= cfg.grid_cells_x and need[1] <= cfg.grid_cells_y:
            return None
        if not self.config.auto_grow_grids:
            raise ValueError(
                f"{what} needs {need} cells > static grid "
                f"({cfg.grid_cells_x}, {cfg.grid_cells_y}); increase "
                f"{remedy} (or set auto_grow_grids)")
        gx = max(cfg.grid_cells_x, int(-(-int(need[0]) // 32) * 32))
        gy = max(cfg.grid_cells_y, int(-(-int(need[1]) // 32) * 32))
        return gx, gy

    def _grow_matcher(self, attr: str, grown) -> None:
        """Rebuild matcher ``attr`` at the grown static extent."""
        m = getattr(self, attr)
        cfg = dataclasses.replace(m.config, grid_cells_x=grown[0],
                                  grid_cells_y=grown[1])
        logger.warning("Auto-growing %s NDT grid %dx%d -> %dx%d cells",
                       attr, m.config.grid_cells_x, m.config.grid_cells_y,
                       grown[0], grown[1])
        setattr(self, attr, type(m)(cfg, self.range_max, device=self.device))

    def _check_window_capacity(self):
        wp = self._window_poses_host[self._window_mask_host]
        grown = self._check_grid_capacity(
            wp[:, :2] if len(wp) else wp, self.local_matcher.config,
            "scan window", "local_scan_matcher.grid_cells_*")
        if grown:
            self._grow_matcher("local_matcher", grown)

    def _process_mapping(self, robot_pose, odom_pose, points, mask,
                         num_points) -> ScanResult:
        """Mapping branch (ndt_mapper.cpp:495-546)."""
        g = self.graph
        uncorrected = 0.0
        matched = 0.0
        correction = np.zeros(3)
        covariance = None
        pose = robot_pose.copy()

        # One host->device copy of the new scan, reused by the match and
        # the window append.
        dev_points = torch.from_numpy(
            np.ascontiguousarray(points, np.float32)).to(self.device)
        dev_mask = torch.from_numpy(np.ascontiguousarray(mask)).to(
            self.device)

        if g.num_scans:
            # Rolling window of the last rolling_depth scans
            # (ndt_mapper.cpp:504-509): K1 + K3 + K2 on the device window,
            # fetched with one device->host copy.
            window = self._sync_window()
            self._check_window_capacity()
            with self.stats.timer.section("local_match"):
                pose32 = torch.from_numpy(pose.astype(np.float32)).to(
                    self.device)
                out = matcher_mod.match_scan_rolling(
                    self.local_matcher.config, window, self.range_max,
                    dev_points, dev_mask, num_points, pose32)
                flat = torch.cat([out[0].reshape(1), out[1].reshape(1),
                                  out[2].reshape(3), out[3].reshape(9)])
                host = flat.cpu().numpy()
            uncorrected = float(host[0])
            matched = float(host[1])
            correction = host[2:5].astype(np.float64)
            covariance = host[5:14].reshape(3, 3).astype(np.float64)
            # EWMA of match quality -> loop-closure accept threshold
            # (ndt_mapper.cpp:518).
            self.typical_matcher_response = (
                0.95 * self.typical_matcher_response + 0.05 * matched)
            pose = pose + correction

        scan_id = g.add_scan(pose, points, mask)
        if scan_id > 0:
            # Odometry constraint from the previous scan (ndt_mapper.cpp:527-529).
            pose_graph.make_constraint_np(g, scan_id - 1, scan_id, covariance)

        # Append the corrected scan to the device window (the only per-scan
        # transfer is the new scan itself).
        if self._window is None or self._window_synced != g.num_scans - 1:
            self._window_synced = -1
            self._sync_window()
        else:
            pose32 = torch.from_numpy(pose.astype(np.float32)).to(self.device)
            matcher_mod.window_append(self._window, pose32, dev_points,
                                      dev_mask)
            self._window_poses_host = np.concatenate(
                [self._window_poses_host[1:], pose[None].astype(np.float32)])
            self._window_mask_host = np.concatenate(
                [self._window_mask_host[1:], np.ones(1, bool)])
            self._window_synced = g.num_scans

        self.prev_odom_pose = odom_pose.copy()
        self.prev_robot_pose = pose.copy()
        self.stats.record_scan(True, matched if g.num_scans > 1 else None)

        self._scans_since_loop_closure += 1
        if self._scans_since_loop_closure >= self.config.loop_closure_every:
            self.loop_closure()

        return ScanResult(accepted=True, scan_id=scan_id, pose=pose,
                          uncorrected_score=uncorrected,
                          matched_score=matched, correction=correction)

    # ------------------------------------------------------------------
    def _drain_all(self) -> None:
        """Nothing is ever in flight: the port maps synchronously."""

    def flush(self) -> None:
        """No-op: every scan is in the graph when process_scan returns."""
        self._drain_all()

    # ------------------------------------------------------------------
    def loop_closure(self) -> int:
        """One pass of the loop-closure search (loopClosureThread body,
        ndt_mapper.cpp:569-685), as far as the host radius search.

        Confirming a candidate needs the batched confirmation matcher and
        the pose-graph solver, which are not ported yet: a pass that
        proposes any candidate raises NotImplementedError.  A pass that
        proposes none advances ``global_scans_processed`` and trims the
        host heap, as the reference's pass does.  Returns 0."""
        self._scans_since_loop_closure = 0
        g = self.graph
        num_scans = g.num_scans
        depth = self.config.rolling_depth
        if num_scans <= depth:
            return 0
        if self.global_scans_processed <= depth:
            self.global_scans_processed = depth + 1
        with self.stats.timer.section("loop_closure"):
            for j in range(self.global_scans_processed, num_scans):
                cands = self._loop_candidates(j)
                if cands:
                    raise NotImplementedError(
                        f"scan {j} proposes loop-closure candidates "
                        f"{cands}; loop-closure confirmation and the "
                        "pose-graph solver are not ported yet")
            self.global_scans_processed = num_scans
        trim_host_heap()
        return 0

    def _loop_candidates(self, idx: int) -> list:
        """Radius-search candidates of scan ``idx`` (Graph::findNearest
        below the rolling window), point-less scans dropped, capped at
        global_search_limit; logged like the reference mapper's."""
        g = self.graph
        limit = self.config.global_search_limit
        rolling = idx - self.config.rolling_depth
        use_bary = (g.use_barycenter
                    and self.config.loop_search_positions != "pose")
        query = g.barycenter(idx) if use_bary else g.poses[idx, :2]
        out = []
        for i in g.find_nearest(query, self.config.global_search_size,
                                rolling, use_barycenter=use_bary):
            i = int(i)
            if len(out) >= limit:
                break
            if g.point_mask[i].any():
                out.append(i)
        if self.config.loop_search_positions == "both":
            extras = 0
            for i in g.find_nearest(g.poses[idx, :2],
                                    self.config.global_search_size, rolling,
                                    use_barycenter=False):
                i = int(i)
                if extras >= limit:
                    break
                if i in out or not g.point_mask[i].any():
                    continue
                out.append(i)
                extras += 1
        self.lc_log["candidates"].append((idx, tuple(out),
                                          tuple(np.asarray(query, float))))
        return out

    # ------------------------------------------------------------------
    def render_map(self) -> occupancy.OccupancyGridResult:
        """Occupancy-grid export (mapPublishThread, ndt_mapper.cpp:696-705)."""
        self._drain_all()
        g = self.graph
        return occupancy.render_occupancy(
            g.poses, g.points, g.point_mask, self.config.resolution,
            self.config.occupancy_threshold, device=self.device)

    # ------------------------------------------------------------------
    def configure(self, action: int, filename: str = "") -> bool:
        """Configure service (srv/Configure.srv); the port supports
        SAVE_TO_FILE only."""
        if action != SAVE_TO_FILE:
            raise NotImplementedError(
                f"configure action {action}: only SAVE_TO_FILE "
                f"({SAVE_TO_FILE}) is ported")
        logger.info("Saving map to %s", filename)
        serialization.save_graph(self.graph, filename)
        return True
