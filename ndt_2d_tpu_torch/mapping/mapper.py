"""The mapper runtime: synchronous SLAM with radius loop closure, and
localization, on the port's kernels.

Port of the synchronous branches of ``ndt_2d_tpu/mapping/mapper.py`` (the
reference's ``ndt_2d::Mapper``):

* ``process_scan`` == laserCallback: the localized gate, motion gate,
  odometry dead-reckoning, de-skewed projection (host numpy), then
  one of three branches.  Mapping: one fused window build (K1) +
  uncorrected score (K3) + exhaustive match (K2), and its Newton polish
  (K7) when the matcher refines, against the device-resident rolling
  window; the EWMA of match quality, and the odometry constraint into the
  host pose graph.  With ``overlapping_grids`` every kernel works on the
  four overlapping grids of the window.  Scan-match localization
  (``enable_mapping=False``): K3 + K2 (+ K7) against the global NDT of the
  loaded map (K1, built once).  Particle filter
  (``use_particle_filter``): one fused filter step (K9 motion, K3 over all
  particles, K9 resample and statistics) and one read.
* ``set_initial_pose`` == poseCallback; ``global_localize`` seeds the
  filter over the map's free space (K5); ``configure`` loads and saves
  maps and switches mapping on and off; ``map_to_odom`` the transform.
* ``loop_closure`` == one pass of loopClosureThread: the host radius
  search, the confirmation of every (query, candidate) row on the global
  matcher (``match_scan_batch_multi``: one K1, one K2 and, when the matcher
  refines, one K7 launch per chunk of up to 64 rows; or one window at a
  time on the sequential path), the acceptance gates, and the LM solve on
  K4 (``graph/solver.py``).
* ``render_map`` == the occupancy export (K5).

Refused with NotImplementedError rather than approximated: the pipelined
per-scan paths (``max_inflight > 0``), meshes, loop searches other than
"radius" (descriptor mode and its coarse-to-fine confirmation), and
lattices wider than one NDT cell (kernel K6; checked at construction).
"""

from __future__ import annotations

import dataclasses
import logging
from collections import deque
from typing import Optional

import numpy as np
import torch

from ndt_2d_tpu_torch.device import get_device
from ndt_2d_tpu_torch.filter.particle_filter import ParticleFilter
from ndt_2d_tpu_torch.graph import solver
from ndt_2d_tpu_torch.mapping import occupancy
from ndt_2d_tpu_torch.matching import matcher as matcher_mod
from ndt_2d_tpu_torch.matching import registry
from ndt_2d_tpu_torch.config import MapperConfig
from ndt_2d_tpu_torch.graph import pose_graph
from ndt_2d_tpu_torch.io import serialization
from ndt_2d_tpu_torch.mapping import laser
from ndt_2d_tpu_torch.utils.memory import trim_host_heap
from ndt_2d_tpu_torch.utils.profiling import SessionStats
from ndt_2d_tpu_torch.utils.sim import LaserScanMsg

logger = logging.getLogger("ndt_2d_tpu_torch.mapper")

# Configure service actions (srv/Configure.srv).
ENABLE_MAPPING = 1
DISABLE_MAPPING = 2
LOAD_FROM_FILE = 4
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
        (config.max_inflight > 0, "max_inflight > 0 (pipelined paths)"),
        (config.loop_search != "radius",
         f"loop_search={config.loop_search!r}"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet")
    for m in (config.local_scan_matcher, config.global_scan_matcher):
        matcher_mod.check_supported(m)


class Mapper:
    def __init__(self, config: MapperConfig = MapperConfig(),
                 graph: Optional[pose_graph.Graph] = None,
                 laser_transform=np.zeros(3), laser_inverted: bool = False,
                 seed: int = 0, mesh=None, device=None):
        """Args: ``graph``, a loaded map (localization, or mapping on from
        it after ``set_initial_pose``); the robot->laser extrinsic (x, y,
        theta) and the mirrored-laser flag of the reference's projection
        (ndt_mapper.cpp:271-290); ``seed`` of the particle filter's
        generator; ``device``: ``cuda`` unless ``cpu`` is passed (the
        kernels' twins).  ``mesh`` is refused."""
        if mesh is not None:
            raise NotImplementedError("multi-device meshes are not ported "
                                      "yet")
        check_supported(config)
        self.config = config
        self.device = get_device(device)
        self.enable_mapping = config.enable_mapping
        self.use_particle_filter = config.use_particle_filter
        self.range_max = config.max_range

        loaded = graph is not None
        self.graph = graph if loaded else pose_graph.Graph(
            config.max_points_per_scan, config.use_barycenter)
        self.laser_transform = np.asarray(laser_transform, np.float64)
        self.laser_inverted = bool(laser_inverted)

        self.local_matcher = None
        self.global_matcher = None
        # Descriptor mode's coarse matcher is not ported: always None, so
        # every confirmation row takes the fine (near) segment.
        self.coarse_matcher = None

        self.prev_odom_pose = np.zeros(3)
        self.prev_robot_pose = np.zeros(3)
        # A loaded map requires re-localization first (ndt_mapper.cpp:114).
        self.prev_odom_pose_is_initialized = not loaded
        self.typical_matcher_response = -0.5   # ndt_mapper.cpp:55
        self.global_scans_processed = 0
        self.optimization_last = 0
        self.map_update_available = loaded

        self.filter: Optional[ParticleFilter] = None
        if self.use_particle_filter:
            self.filter = ParticleFilter(config.particle_filter, seed=seed,
                                         device=self.device)

        self._scans_since_loop_closure = 0
        self.stats = SessionStats()
        # Loop-closure log, bounded as in the reference mapper: "candidates"
        # rows are (query, candidate ids, query position), "decisions" rows
        # (query, candidate, score, gate, accepted).
        self.lc_log = {"candidates": deque(maxlen=100_000),
                       "decisions": deque(maxlen=100_000)}
        # The negative cache of clearly rejected far rows; it only ever
        # fills with a coarse matcher (descriptor mode, not ported).
        self._reject_cache = {}
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
        mtype = self.config.scan_matcher_type
        gcfg = self.config.global_scan_matcher
        localizing = self.use_particle_filter or not self.enable_mapping
        if localizing and self.graph.num_scans:
            # Localization builds ONE global NDT over the whole loaded map
            # (ndt_mapper.cpp:296-303); the static grid grows to fit it in
            # 32-cell steps, never below the configured extent.
            wp = np.asarray(self.graph.poses[:, :2], np.float64)
            span = wp.max(0) - wp.min(0) + 2.0 * self.range_max
            need = np.ceil(span / gcfg.ndt_resolution).astype(int) + 1
            gx = max(gcfg.grid_cells_x, int(-(-need[0] // 32) * 32))
            gy = max(gcfg.grid_cells_y, int(-(-need[1] // 32) * 32))
            if (gx, gy) != (gcfg.grid_cells_x, gcfg.grid_cells_y):
                logger.info("Auto-sizing global NDT grid to %dx%d cells "
                            "for the loaded map", gx, gy)
                gcfg = dataclasses.replace(gcfg, grid_cells_x=gx,
                                           grid_cells_y=gy)
        self.global_matcher = registry.create(mtype, gcfg, self.range_max,
                                              device=self.device)
        self.local_matcher = registry.create(
            mtype, self.config.local_scan_matcher, self.range_max,
            device=self.device)
        if (self.enable_mapping
                and self.local_matcher.config.refine_iterations > 0):
            # The reference's measurement on synthetic corridors
            # (ndt_2d_tpu/mapping/mapper.py:229-239): continuous refinement
            # against the rolling window drags poses sub-cell toward the
            # window's own history and worsens trajectory ATE.
            logger.warning(
                "Newton refinement is enabled on the LOCAL (rolling-window) "
                "matcher while mapping; this was measured to worsen "
                "trajectory ATE. Prefer refinement on the global matcher "
                "only (localization / loop-closure confirmation).")
        if localizing and self.graph.num_scans:
            g = self.graph
            self.global_matcher.add_scans(g.poses.astype(np.float32),
                                          g.points, g.point_mask)

    # ------------------------------------------------------------------
    def set_initial_pose(self, pose, covariance, odom_pose) -> bool:
        """poseCallback (ndt_mapper.cpp:188-265).  pose: (x, y, theta) in
        the map frame; covariance: [3, 3] or its diagonal; odom_pose: the
        robot's current odometry-frame pose."""
        if self.enable_mapping and self.prev_odom_pose_is_initialized:
            logger.warning("Ignoring initial pose, already mapping")
            return False
        pose = np.asarray(pose, np.float64)
        cov = np.asarray(covariance, np.float64)
        if cov.ndim == 1:
            cov = np.diag(cov)

        if self.use_particle_filter:
            self.filter.init(pose[0], pose[1], pose[2], np.sqrt(cov[0, 0]),
                             np.sqrt(cov[1, 1]), np.sqrt(cov[2, 2]))
        elif self.enable_mapping:
            # Connect this pose to the graph (ndt_mapper.cpp:231-256).
            nearest = self.graph.find_nearest(pose[:2])
            if len(nearest) == 0:
                logger.error("Cannot localize robot, not close enough to "
                             "existing graph")
                return False
            P = self.config.max_points_per_scan
            scan_id = self.graph.add_scan(pose, np.zeros((P, 2), np.float32),
                                          np.zeros(P, bool))
            pose_graph.make_constraint_np(self.graph, int(nearest[0]),
                                          scan_id, cov)

        self.prev_robot_pose = pose.copy()
        self.prev_odom_pose = np.asarray(odom_pose, np.float64).copy()
        self.prev_odom_pose_is_initialized = True
        logger.info("Localized to %f, %f, %f", *pose)
        return True

    def _map_free_space(self):
        """World-frame centers of the observed-free occupancy cells of the
        map (K5), with the cell size, or None.  Renders directly, so the
        map_update_available flag is left as it is."""
        g = self.graph
        grid = occupancy.render_occupancy(
            g.poses, g.points, g.point_mask, self.config.resolution,
            self.config.occupancy_threshold, device=self.device)
        free = np.argwhere(grid.data == 0)                 # [N, (iy, ix)]
        if not len(free):
            return None
        centers = grid.origin + (free[:, ::-1] + 0.5) * grid.resolution
        return centers, grid.resolution

    def global_localize(self, odom_pose) -> bool:
        """Global relocalization: seed the particle cloud uniformly over the
        map's free space (AMCL's global_localization service; the reference
        needs a manual initial pose after a map load, README.md:50-52).
        Needs the particle filter and a loaded map."""
        if not self.use_particle_filter or self.filter is None:
            logger.error("global_localize requires use_particle_filter")
            return False
        if not self.graph.num_scans:
            logger.error("global_localize requires a loaded map")
            return False
        fs = self._map_free_space()
        if fs is None:
            logger.error("map has no observed-free cells")
            return False
        centers, res = fs
        self.filter.init_global(centers, res)
        self.prev_robot_pose = self.filter.get_mean().astype(np.float64)
        self.prev_odom_pose = np.asarray(odom_pose, np.float64).copy()
        self.prev_odom_pose_is_initialized = True
        logger.info("Global localization: %d particles over %d free cells",
                    self.filter.n_active, len(centers))
        return True

    # ------------------------------------------------------------------
    def process_scan(self, msg: LaserScanMsg, odom_pose,
                     odom_pose_end=None) -> ScanResult:
        """laserCallback (ndt_mapper.cpp:267-567)."""
        self._ensure_matchers(msg.range_max)

        if not self.prev_odom_pose_is_initialized:
            logger.warning("Can not handle scan, not localized within map")
            self.stats.record_scan(False)
            return ScanResult(accepted=False)

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
        if self.use_particle_filter:
            return self._process_particle_filter(robot_pose, odom_pose,
                                                 points, mask, num_points)
        if self.enable_mapping:
            return self._process_mapping(robot_pose, odom_pose, points, mask,
                                         num_points)
        return self._process_localization(robot_pose, odom_pose, points, mask,
                                          num_points)

    # ------------------------------------------------------------------
    def _process_localization(self, robot_pose, odom_pose, points, mask,
                              num_points) -> ScanResult:
        """Scan-match localization branch (ndt_mapper.cpp:547-566): score
        and match against the global NDT (K3 + K2), one read."""
        m = self.global_matcher
        with self.stats.timer.section("global_match"):
            if m.grid is not None:
                dev = self.device
                out = matcher_mod.match_scan_with_score(
                    m.config, m.grid,
                    torch.from_numpy(np.ascontiguousarray(
                        points, np.float32)).to(dev),
                    torch.from_numpy(np.ascontiguousarray(mask)).to(dev),
                    num_points,
                    torch.from_numpy(robot_pose.astype(np.float32)).to(dev),
                    m.packed_table)
                host = torch.cat([out[0].reshape(1), out[1].reshape(1),
                                  out[2].reshape(3)]).cpu().numpy()
            else:  # no map: the matcher's empty-grid answers
                res = m.match_scan(points, mask, num_points,
                                   robot_pose.astype(np.float32))
                host = np.concatenate([[0.0, float(res.score)],
                                       res.correction.cpu().numpy()])
        unc, score = float(host[0]), float(host[1])
        correction = host[2:5].astype(np.float64)
        pose = robot_pose + correction
        self.prev_odom_pose = odom_pose.copy()
        self.prev_robot_pose = pose.copy()
        self.stats.record_scan(True, score)
        return ScanResult(accepted=True, pose=pose, uncorrected_score=unc,
                          matched_score=score, correction=correction)

    def _process_particle_filter(self, robot_pose, odom_pose, points, mask,
                                 num_points) -> ScanResult:
        """Particle-filter branch (ndt_mapper.cpp:455-494): one fused
        filter step, one read of its mean."""
        f = self.filter
        pc = f.config
        if (pc.recovery_alpha_slow > 0.0 and pc.recovery_alpha_fast > 0.0
                and f.free_xy is None and self.graph.num_scans):
            # Arm AMCL-style recovery: the free-space pool, built once from
            # the loaded map.
            fs = self._map_free_space()
            if fs is not None:
                f.set_free_space(*fs)
                logger.info("PF recovery armed: %d free cells", len(fs[0]))
        # Robot-centric control from the map-frame delta
        # (ndt_mapper.cpp:457-468).
        delta = robot_pose[:2] - self.prev_robot_pose[:2]
        c = np.cos(-self.prev_robot_pose[2])
        s = np.sin(-self.prev_robot_pose[2])
        control = np.asarray([
            c * delta[0] - s * delta[1],
            s * delta[0] + c * delta[1],
            _normalize_angle(robot_pose[2] - self.prev_robot_pose[2])])
        with self.stats.timer.section("pf_step"):
            mean = f.step(self.global_matcher, control, points, mask,
                          num_points)
        pose = np.asarray(mean, np.float64)
        self.prev_odom_pose = odom_pose.copy()
        self.prev_robot_pose = pose.copy()
        self.stats.record_scan(True)
        return ScanResult(accepted=True, pose=pose)

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
        self.map_update_available = True
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
        ndt_mapper.cpp:569-685): radius candidates of every scan not yet
        searched, their confirmation on the global matcher, the acceptance
        gates, and the optimization cadence.  Returns the number of
        closures added."""
        self._scans_since_loop_closure = 0
        if not self.enable_mapping:
            return 0
        self._drain_all()
        g = self.graph
        num_scans = g.num_scans
        depth = self.config.rolling_depth
        if num_scans <= depth:
            return 0
        if self.global_scans_processed <= depth:
            self.global_scans_processed = depth + 1

        added = 0
        if (self._fused_confirmation_available()
                and self.config.pipeline_loop_closure):
            added = self._loop_closure_pass_pipelined(num_scans)
        else:
            while self.global_scans_processed < num_scans:
                idx = self.global_scans_processed
                with self.stats.timer.section("loop_closure"):
                    candidates = self._loop_candidates(idx)
                    if candidates:
                        added += self._confirm_candidates(idx, candidates)
                self.global_scans_processed += 1

        # Optimization cadence (ndt_mapper.cpp:676-683).
        if added and (num_scans - self.optimization_last
                      > self.config.optimization_node_limit):
            logger.info("Optimizing pose graph")
            with self.stats.timer.section("optimize"):
                self._solve_graph()
            self.stats.optimizations += 1
            self.optimization_last = g.num_scans
            self.map_update_available = True
            self._window_synced = -1  # optimized poses invalidate the window
            self._reject_cache.clear()
            self._reanchor_pose()
        # Return the pass's freed host buffers to the OS.
        trim_host_heap()
        return added

    def _reanchor_pose(self) -> None:
        """Re-anchor the dead-reckoning chain on the newest graph pose after
        an optimization (or a closure that moved the newest scan).  The
        reference never does (src/ndt_mapper.cpp:569-685 vs :541-545); its
        stale chain strands the next start pose outside the match window,
        which the JAX package fixes and the port keeps fixed."""
        g = self.graph
        if g.num_scans:
            self.prev_robot_pose = g.poses[g.num_scans - 1].copy()

    # --- loop-closure internals ------------------------------------------
    def _loop_candidates(self, idx: int) -> list:
        """Radius-search candidates of scan ``idx`` (Graph::findNearest
        below the rolling window), ordered, point-less scans dropped,
        capped at global_search_limit; "both" positions add a pose-space
        arm with its own budget.  Logged like the reference mapper's."""
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
            if not g.point_mask[i].any():
                continue
            if (self._reject_cache and self._is_far(idx, i)
                    and self._far_key(idx, i) in self._reject_cache):
                self.stats.far_rows_cache_skipped += 1
                continue
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
                if (self._reject_cache and self._is_far(idx, i)
                        and self._far_key(idx, i) in self._reject_cache):
                    self.stats.far_rows_cache_skipped += 1
                    continue
                out.append(i)
                extras += 1
        self.lc_log["candidates"].append((idx, tuple(out),
                                          tuple(np.asarray(query, float))))
        return out

    def _window_bounds(self, i: int, rolling: int):
        """[begin, end) scan range of candidate ``i``'s S-slot confirmation
        region (shared by the window build and the row-reuse key)."""
        S = self.config.loop_closure_region_size
        begin_idx = max(i - S // 2, 0)
        end_idx = max(min(i + (S - S // 2), rolling), i + 1)
        return begin_idx, begin_idx + min(end_idx - begin_idx, S)

    def _grid_cells_snapshot(self):
        """Current global (and coarse) matcher grid sizes."""
        gm = self.global_matcher.config
        cells = [gm.grid_cells_x, gm.grid_cells_y]
        if self.coarse_matcher is not None:
            cells += [self.coarse_matcher.config.grid_cells_x,
                      self.coarse_matcher.config.grid_cells_y]
        return tuple(cells)

    def _confirm_row_key(self, j: int, i: int) -> bytes:
        """Snapshot of everything a confirmation row's result depends on:
        the query pose, the candidate window's poses and the grid sizes."""
        g = self.graph
        begin_idx, end_idx = self._window_bounds(
            i, j - self.config.rolling_depth)
        return (g.poses[j].tobytes() + g.poses[begin_idx:end_idx].tobytes()
                + np.asarray(self._grid_cells_snapshot(), np.int64).tobytes())

    def _candidate_window(self, i: int, rolling: int):
        """The candidate's S-slot scan region around scan ``i``
        (ndt_mapper.cpp:627-631; S = 2 is the reference's {i-1, i}),
        never reaching into the query's rolling window, padded to S."""
        g = self.graph
        S = self.config.loop_closure_region_size
        begin_idx, end_idx = self._window_bounds(i, rolling)
        k = end_idx - begin_idx
        poses2 = np.zeros((S, 3), np.float32)
        pts2 = np.zeros((S, g.max_points, 2), np.float32)
        pmask2 = np.zeros((S, g.max_points), bool)
        wmask2 = np.zeros(S, bool)
        poses2[:k] = g.poses[begin_idx:end_idx].astype(np.float32)
        pts2[:k] = g.points[begin_idx:end_idx]
        pmask2[:k] = g.point_mask[begin_idx:end_idx]
        wmask2[:k] = True
        return poses2, pts2, pmask2, wmask2

    def _candidate_start(self, idx: int, i: int, descriptor: bool):
        """(start pose, wants_coarse) for candidate ``i`` of query ``idx``:
        the query's own pose; far descriptor candidates (not ported)
        would start at the candidate's position on the coarse lattice."""
        g = self.graph
        st = g.poses[idx].copy()
        if descriptor:
            d2 = float(np.sum((g.poses[i, :2] - st[:2]) ** 2))
            if d2 > self.config.global_search_size:
                st[:2] = g.poses[i, :2]
                return st, True
        return st, False

    # --- far-candidate pruning: only active with a coarse matcher ---------
    def _is_far(self, idx: int, i: int) -> bool:
        """Whether candidate ``i`` of ``idx`` takes the coarse-to-fine arm
        (never, without a coarse matcher)."""
        if self.coarse_matcher is None:
            return False
        g = self.graph
        d2 = float(np.sum((g.poses[i, :2] - g.poses[idx, :2]) ** 2))
        return d2 > self.config.global_search_size

    def _far_key(self, idx: int, i: int):
        """Spatial cell key of a far (query, candidate) pair."""
        cell = self.config.loop_closure_far_dedup or 2.0
        g = self.graph
        q = g.poses[idx, :2] / cell
        c = g.poses[i, :2] / cell
        return (int(np.floor(q[0])), int(np.floor(q[1])),
                int(np.floor(c[0])), int(np.floor(c[1])))

    def _prune_far_pass(self, pending: list) -> list:
        """Per-pass dedup and cap of far rows (config.loop_closure_far_dedup,
        loop_closure_max_far_rows).  Without a coarse matcher no row is
        far, so the pass comes back unchanged."""
        return pending

    def _apply_gate(self, idx: int, i: int, start, score: float, correction,
                    covariance) -> bool:
        """Acceptance gate + graph update for one confirmed candidate
        (ndt_mapper.cpp:645-668), shared by every confirmation path."""
        g = self.graph
        gate = (self.typical_matcher_response
                * self.config.loop_closure_gate_scale)
        accepted = bool(np.isfinite(score) and score < gate)
        if accepted:
            # Separation gate: the corrected query pose must land within
            # loop_closure_max_separation of the candidate (inf = parity).
            sep = np.hypot(*(start[:2] + np.asarray(correction)[:2]
                             - g.poses[i, :2]))
            accepted = sep <= self.config.loop_closure_max_separation
        self.lc_log["decisions"].append((idx, i, float(score), float(gate),
                                         accepted))
        margin = self.config.loop_closure_reject_cache_margin
        if not accepted and margin > 0 and self._is_far(idx, i):
            if (not np.isfinite(score)
                    or score - gate >= margin * abs(gate)):
                self._reject_cache[self._far_key(idx, i)] = float(score)
        if accepted:
            self._reject_cache.clear()
            self.stats.loop_closures_accepted += 1
            logger.info("***Adding loop closure from %d to %d (score %f)",
                        i, idx, score)
            new_pose = start + np.asarray(correction, np.float64)
            poses = g.poses.copy()
            poses[idx] = new_pose
            g.set_poses(poses)
            pose_graph.make_constraint_np(
                g, i, idx, np.asarray(covariance, np.float64),
                switchable=True)
            self.map_update_available = True
            # The corrected pose may sit inside the device rolling window.
            self._window_synced = -1
            if idx == g.num_scans - 1:
                # The closure moved the newest keyframe: optionally let the
                # robust solve arbitrate first, then re-anchor the chain.
                if self.config.loop_closure_solve_before_reanchor:
                    with self.stats.timer.section("optimize"):
                        if self._solve_graph():
                            self.stats.optimizations += 1
                            self.optimization_last = g.num_scans
                self._reanchor_pose()
            return True
        self.stats.loop_closures_rejected += 1
        logger.info("***Rejecting loop closure from %d to %d (score %f)",
                    i, idx, score)
        return False

    def _fused_confirmation_available(self) -> bool:
        """Whether the batched confirmation applies (NDT matchers only)."""
        return (self.config.batch_loop_closure
                and isinstance(self.global_matcher,
                               matcher_mod.NDTScanMatcher)
                and (self.coarse_matcher is None
                     or isinstance(self.coarse_matcher,
                                   matcher_mod.NDTScanMatcher)))

    def _loop_closure_pass_pipelined(self, num_scans: int) -> int:
        """The whole pass's (query, candidate) rows confirmed in batches,
        then gated in scan order.  An acceptance restarts the pass from the
        next scan with the corrected graph; rows whose inputs did not
        change (``_confirm_row_key``) reuse their result instead of
        re-running.  A row's result does not depend on the batch it rides
        in, so decisions equal the per-scan path's."""
        added = 0
        row_cache = {}
        while self.global_scans_processed < num_scans:
            pending = []
            rows = []
            with self.stats.timer.section("loop_closure"):
                for j in range(self.global_scans_processed, num_scans):
                    cands = self._loop_candidates(j)
                    if cands:
                        pending.append((j, cands))
                self.global_scans_processed = num_scans
                pending = self._prune_far_pass(pending)
                rows = [(j, i) for j, cands in pending for i in cands]
                if not rows:
                    break
                while True:
                    keys = {r: self._confirm_row_key(*r) for r in rows}
                    fresh = [r for r in rows
                             if row_cache.get(r, (None,))[0] != keys[r]]
                    if not fresh:
                        break
                    cells0 = self._grid_cells_snapshot()
                    starts, segments = self._dispatch_confirm_rows(fresh)
                    fsc, fco, fcv, ffs = self._fetch_rows(starts, segments)
                    if self._grid_cells_snapshot() != cells0:
                        # auto_grow_grids fired mid-dispatch: redo under the
                        # grown config so no entry mixes grid sizes.
                        row_cache.clear()
                        continue
                    for m, r in enumerate(fresh):
                        row_cache[r] = (keys[r], float(fsc[m]),
                                        fco[m].copy(), fcv[m].copy(),
                                        ffs[m].copy())
                    break
                self.stats.confirm_rows_reused += len(rows) - len(fresh)
                N = len(rows)
                scores = np.zeros(N)
                corrs = np.zeros((N, 3))
                covs = np.zeros((N, 3, 3))
                fstarts = np.zeros((N, 3))
                for m, r in enumerate(rows):
                    _, scores[m], corrs[m], covs[m], fstarts[m] = \
                        row_cache[r]
            off = 0
            for (j, cands) in pending:
                k = len(cands)
                with self.stats.timer.section("loop_closure"):
                    a, changed = self._gate_rows(
                        j, cands, fstarts[off:off + k], scores[off:off + k],
                        corrs[off:off + k], covs[off:off + k])
                added += a
                off += k
                if changed and j + 1 < num_scans:
                    # Everything after j saw the pre-acceptance graph.
                    self.global_scans_processed = j + 1
                    break
        return added

    def _confirm_candidates(self, idx: int, candidates: list) -> int:
        """Confirm the candidates of scan ``idx``; returns closures added."""
        if self._fused_confirmation_available():
            return self._confirm_candidates_batched(idx, candidates)
        return self._confirm_candidates_sequential(idx, candidates)

    def _confirm_candidates_sequential(self, idx: int,
                                       candidates: list) -> int:
        """Reference-shaped path: per candidate, rebuild the global
        matcher's NDT and match (ndt_mapper.cpp:623-663); the equivalence
        oracle of the batched paths."""
        g = self.graph
        rolling = idx - self.config.rolling_depth
        n = int(g.point_mask[idx].sum())
        best_mode = self.config.loop_closure_accept == "best"
        results = []
        added = 0
        for i in candidates:
            poses2, pts2, pmask2, wmask2 = self._candidate_window(i, rolling)
            grown = self._check_grid_capacity(
                poses2[wmask2][:, :2], self.global_matcher.config,
                "loop-closure candidate window", "scan matcher grid_cells_*")
            if grown:
                self._grow_matcher("global_matcher", grown)
            self.global_matcher.reset()
            self.global_matcher.add_scans(poses2, pts2, pmask2, wmask2)
            start, _ = self._candidate_start(
                idx, i, self.coarse_matcher is not None)
            res = self.global_matcher.match_scan(
                g.points[idx], g.point_mask[idx], n, start.astype(np.float32))
            flat = torch.cat([res.score.reshape(1), res.correction,
                              res.covariance.reshape(9)]).cpu().numpy()
            score = float(flat[0])
            corr = flat[1:4].astype(np.float64)
            cov = flat[4:13].reshape(3, 3).astype(np.float64)
            if best_mode:
                results.append((score, i, start, corr, cov))
                continue
            added += int(self._apply_gate(idx, i, start, score, corr, cov))
        if best_mode:
            for score, i, start, corr, cov in sorted(results,
                                                     key=lambda r: r[0]):
                if self._apply_gate(idx, i, start, score, corr, cov):
                    added += 1
                    break
        return added

    def _confirm_candidates_batched(self, idx: int, candidates: list) -> int:
        """All candidate windows of scan ``idx`` confirmed in one batch.  If
        a mid-batch acceptance moves the scan pose, the remaining
        candidates re-match from the corrected pose (_gate_rows)."""
        starts, segments = self._dispatch_confirm(idx, candidates)
        added, _ = self._drain_confirm(idx, candidates, starts, segments)
        return added

    def _dispatch_confirm(self, idx: int, candidates: list):
        """Dispatch the confirmation of ``candidates`` of scan ``idx``."""
        return self._dispatch_confirm_rows([(idx, i) for i in candidates])

    def _dispatch_confirm_rows(self, rows: list):
        """Dispatch the confirmation of ``rows``, (query, candidate) pairs
        possibly spanning many query scans, in chunks of at most 64 rows
        (one K1 and one K2 launch each).  Every row is near (the coarse
        segment needs descriptor mode).  Returns (starts [N, 3] float64,
        segments [(row positions, device outputs, coarse flag)])."""
        descriptor = self.coarse_matcher is not None
        N = len(rows)
        starts = np.zeros((N, 3), np.float64)
        for r, (q, i) in enumerate(rows):
            starts[r], _ = self._candidate_start(q, i, descriptor)
        segments = []
        pos = np.arange(N)
        cap = 64
        for c0 in range(0, N, cap):
            chunk = pos[c0:c0 + cap]
            out = self._dispatch_rows_segment([rows[r] for r in chunk],
                                              starts[chunk], False)
            segments.append((chunk, out, False))
        return starts, segments

    def _dispatch_rows_segment(self, rows: list, starts, coarse: bool):
        """One chunk: the rows padded to a power of two (at least 4) and
        confirmed by ``match_scan_batch_multi``; returns its device
        (scores, corrections, covariances)."""
        if coarse:
            raise NotImplementedError("coarse-to-fine confirmation is not "
                                      "ported yet")
        g = self.graph
        K = len(rows)
        pad = max(4, 1 << (K - 1).bit_length())
        S = self.config.loop_closure_region_size
        poses = np.zeros((pad, S, 3), np.float32)
        pts = np.zeros((pad, S, g.max_points, 2), np.float32)
        pmask = np.zeros((pad, S, g.max_points), bool)
        wmask = np.zeros((pad, S), bool)
        qpts = np.zeros((pad, g.max_points, 2), np.float32)
        qmask = np.zeros((pad, g.max_points), bool)
        qnum = np.zeros(pad, np.int32)
        st = np.zeros((pad, 3), np.float32)
        for j, (q, i) in enumerate(rows):
            rolling = q - self.config.rolling_depth
            poses[j], pts[j], pmask[j], wmask[j] = \
                self._candidate_window(i, rolling)
            qpts[j] = g.points[q]
            qmask[j] = g.point_mask[q]
            qnum[j] = int(g.point_mask[q].sum())
            st[j] = starts[j]

        self._check_batch_capacity(poses, wmask, coarse)

        dev = self.device
        args = [torch.from_numpy(a).to(dev)
                for a in (poses, pts, pmask, wmask)]
        query = [torch.from_numpy(a).to(dev) for a in (qpts, qmask, qnum, st)]
        return matcher_mod.match_scan_batch_multi(
            self.global_matcher.config, *args, self.range_max, *query)

    def _fetch_rows(self, starts, segments):
        """Materialize dispatched segments into per-row (scores, corrs,
        covs, fine_starts) host arrays in row order, one device->host copy
        per segment."""
        N = len(starts)
        scores = np.zeros(N)
        corrs = np.zeros((N, 3))
        covs = np.zeros((N, 3, 3))
        fstarts = np.asarray(starts, np.float64).copy()
        for pos, (sc, co, cv), _ in segments:
            flat = torch.cat([sc[:, None], co, cv.reshape(-1, 9)],
                             1).cpu().numpy()[:len(pos)]
            scores[pos] = flat[:, 0]
            corrs[pos] = flat[:, 1:4]
            covs[pos] = flat[:, 4:13].reshape(-1, 3, 3)
        return scores, corrs, covs, fstarts

    def _gate_rows(self, idx: int, candidates: list, fstarts, scores, corrs,
                   covs):
        """Apply the acceptance gates for one query's candidates.
        Returns (closures added, graph changed)."""
        K = len(candidates)
        if self.config.loop_closure_accept == "best":
            # Score order, at most one closure per query per pass.
            for j in np.argsort(scores[:K]):
                ok = self._apply_gate(idx, candidates[j], fstarts[j],
                                      float(scores[j]), corrs[j], covs[j])
                if ok:
                    return 1, True
            return 0, False
        added = 0
        for j, i in enumerate(candidates):
            ok = self._apply_gate(idx, i, fstarts[j], float(scores[j]),
                                  corrs[j], covs[j])
            if ok:
                added += 1
                if j + 1 < K:
                    # The acceptance moved g.poses[idx]; re-batch the rest
                    # from the corrected pose, as the sequential path does.
                    added += self._confirm_candidates_batched(
                        idx, candidates[j + 1:])
                return added, True
        return added, False

    def _drain_confirm(self, idx: int, candidates: list, starts, segments):
        """Fetch a dispatched confirmation and apply the acceptance gates in
        candidate order.  Returns (closures added, graph changed)."""
        scores, corrs, covs, fstarts = self._fetch_rows(starts, segments)
        return self._gate_rows(idx, candidates, fstarts, scores, corrs, covs)

    def _check_batch_capacity(self, poses, wmask, coarse: bool) -> None:
        """Static-grid capacity check over all candidate windows; grows the
        tripped matcher(s) to the largest window's need."""
        matchers = ["global_matcher"] + (["coarse_matcher"] if coarse else [])
        for attr in matchers:
            need = None
            for w in range(poses.shape[0]):
                wp = poses[w][wmask[w]]
                if not len(wp):
                    continue
                grown = self._check_grid_capacity(
                    wp[:, :2], getattr(self, attr).config,
                    "loop-closure candidate window",
                    "scan matcher grid_cells_*")
                if grown:
                    need = (max(grown[0], need[0]),
                            max(grown[1], need[1])) if need else grown
            if need:
                self._grow_matcher(attr, need)

    def _solve_graph(self) -> bool:
        """Optimize the graph in place on the mapper's device."""
        return solver.solve_graph(self.graph, self.config.solver,
                                  device=self.device)

    def optimize(self) -> bool:
        """Force a pose-graph optimization."""
        self._drain_all()
        ok = self._solve_graph()
        if ok:
            self.optimization_last = self.graph.num_scans
            self.map_update_available = True
            self._window_synced = -1
            self._reject_cache.clear()
            self._reanchor_pose()
        return ok

    def graph_snapshot(self) -> dict:
        """Graph visualization data (Graph::getMsg, src/graph.cpp:191-256)."""
        self._drain_all()
        g = self.graph
        return {
            "nodes": g.poses[:, :2].copy(),
            "edges": np.stack([g.constraint_begin, g.constraint_end], -1),
            "switchable": g.constraint_switchable.copy(),
        }

    # ------------------------------------------------------------------
    def render_map(self) -> occupancy.OccupancyGridResult:
        """Occupancy-grid export (mapPublishThread, ndt_mapper.cpp:696-705)."""
        self._drain_all()
        self.map_update_available = False
        g = self.graph
        return occupancy.render_occupancy(
            g.poses, g.points, g.point_mask, self.config.resolution,
            self.config.occupancy_threshold, device=self.device)

    def map_to_odom(self) -> np.ndarray:
        """map->odom transform = (map->robot) * (odom->robot)^-1
        (ndt_mapper.cpp:722-739)."""
        mr = self.prev_robot_pose
        orp = self.prev_odom_pose
        th = _normalize_angle(mr[2] - orp[2])
        c, s = np.cos(th), np.sin(th)
        return np.asarray([mr[0] - (c * orp[0] - s * orp[1]),
                           mr[1] - (s * orp[0] + c * orp[1]),
                           th])

    # ------------------------------------------------------------------
    def configure(self, action: int, filename: str = "") -> bool:
        """Configure service (srv/Configure.srv, ndt_mapper.cpp:155-186):
        ENABLE_MAPPING / DISABLE_MAPPING, then LOAD_FROM_FILE or
        SAVE_TO_FILE."""
        if action & ENABLE_MAPPING:
            logger.info("Enabling mapping")
            self.enable_mapping = True
        elif action & DISABLE_MAPPING:
            logger.info("Disabling mapping")
            self.enable_mapping = False
            self.prev_odom_pose_is_initialized = False
        if action & LOAD_FROM_FILE:
            logger.info("Loading map from %s", filename)
            self.graph = serialization.load_graph(
                filename, self.config.max_points_per_scan,
                self.config.use_barycenter)
            self.map_update_available = True
            self.prev_odom_pose_is_initialized = False
            self.global_scans_processed = 0
            self.optimization_last = 0
            self._window_synced = -1  # a new graph invalidates the window
        elif action & SAVE_TO_FILE:
            logger.info("Saving map to %s", filename)
            serialization.save_graph(self.graph, filename)
        return True
