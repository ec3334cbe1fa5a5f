"""NDT scan matching on the port's kernels: window NDT build (K1), the
uncorrected score (K3) and the exhaustive 3-DoF search (K2).

Port of the main-path subset of ``ndt_2d_tpu/matching/matcher.py``,
including the loop-closure confirmation ``match_scan_batch_multi`` (K1 and
K2 over a row axis, one launch each), and for localization
``score_points_batch`` (K3 over a pose axis, the particle filter's
measurement) and ``match_scan_with_score`` (K3 + K2 against a global
grid).  The
plain steps of the search live beside their kernels and are re-exported
here under the reference's names (``subsample``, ``window_origin``,
``prepare_neighborhood``, ``_candidate_scores_local``,
``reduce_candidates``, ``finalize_match``).

Not ported yet, and refused rather than approximated: lattices wider than
one NDT cell (the per-candidate gather path, kernel K6), overlapping grids
(K8), Newton refinement (K7) and the coarse-to-fine confirmation
(``match_scan_batch_multi_coarse_fine``, descriptor mode).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ndt_2d_tpu_torch.device import get_device
from ndt_2d_tpu_torch.kernels import candidate_scores as k2
from ndt_2d_tpu_torch.kernels import ndt_build as k1
from ndt_2d_tpu_torch.kernels import score_points as k3
from ndt_2d_tpu_torch.kernels.candidate_scores import (  # noqa: F401
    MatchResult, finalize_match, prepare_neighborhood, reduce_candidates)
from ndt_2d_tpu_torch.kernels.candidate_scores import (  # noqa: F401
    candidate_scores_local as _candidate_scores_local)
from ndt_2d_tpu_torch.kernels.ndt_build import window_origin  # noqa: F401
from ndt_2d_tpu_torch.kernels.score_points import subsample  # noqa: F401
from ndt_2d_tpu_torch.ndt import grid as ndt_grid
from ndt_2d_tpu_torch.shared import ScanMatcherConfig


def check_supported(config: ScanMatcherConfig) -> None:
    """Raise NotImplementedError for matcher options the port lacks."""
    if config.overlapping_grids:
        raise NotImplementedError(
            "overlapping_grids (kernel K8) is not ported yet")
    if config.refine_iterations > 0:
        raise NotImplementedError(
            "Newton refinement (refine_iterations > 0, kernel K7) is not "
            "ported yet")
    if 2.0 * config.search_linear_size > config.ndt_resolution:
        raise NotImplementedError(
            "lattices wider than one NDT cell (2 * search_linear_size > "
            "ndt_resolution) need the gather path, kernel K6, which is not "
            "ported yet")


@functools.lru_cache(maxsize=16)
def _search_offsets(config: ScanMatcherConfig, device: torch.device):
    """The candidate lattice (angles [A], offsets [L]) cached per device;
    the tensors are never written."""
    return k2.search_offsets(config, device)


def build_window_ndt(config: ScanMatcherConfig, poses, points, point_mask,
                     window_mask, range_max: float):
    """Window NDT (ScanMatcherNDT::addScans) on K1: (NDTGrid, patch table).

    poses [S, 3], points [S, P, 2] robot frame, point_mask [S, P],
    window_mask [S] (which scans participate)."""
    check_supported(config)
    return k1.build_window(poses, points, point_mask, window_mask,
                           range_max, config.ndt_resolution,
                           config.grid_cells_x, config.grid_cells_y)


def match_scan(config: ScanMatcherConfig, grid: ndt_grid.NDTGrid, points,
               point_mask, num_points: int, pose, range_max=None,
               packed_table=None) -> MatchResult:
    """Exhaustive 3-DoF search of one scan against a window NDT (K2).

    ``packed_table`` is K1's patch table; without it the table is laid out
    from the grid."""
    del range_max  # part of the reference's signature; unused here
    check_supported(config)
    if packed_table is None:
        packed_table = ndt_grid.packed_patch_table(grid, config.grid_cells_x)
    dths, dls = _search_offsets(config, points.device)
    return k2.match(config, grid, packed_table, points, point_mask,
                    num_points, pose, dths, dls)


def score_points_at_pose(config: ScanMatcherConfig, grid: ndt_grid.NDTGrid,
                         points, point_mask, num_points: int, pose):
    """ScanMatcherNDT::scorePoints on K3: mean negative likelihood."""
    check_supported(config)
    return k3.score_at_pose(grid, config.grid_cells_x, config.grid_cells_y,
                            config.laser_max_beams, points, point_mask,
                            num_points, pose)


def score_points_batch(config: ScanMatcherConfig, grid: ndt_grid.NDTGrid,
                       points, point_mask, num_points: int, poses):
    """scorePoints over poses [M, 3] in one K3 launch: the particle
    filter's measurement (replaces the per-particle loop at
    src/particle_filter.cpp:81-88).  Row m equals ``score_points_at_pose``
    at poses[m] bitwise."""
    check_supported(config)
    return k3.score_batch(grid, config.grid_cells_x, config.grid_cells_y,
                          config.laser_max_beams, points, point_mask,
                          num_points, poses)


def match_scan_with_score(config: ScanMatcherConfig,
                          grid: ndt_grid.NDTGrid, scan_points, scan_mask,
                          num_points: int, pose, packed_table=None):
    """scoreScan + matchScan against a prebuilt (global) grid, the
    scan-match localization step (ndt_mapper.cpp:556-558): K3 + K2 at one
    pose.  Returns (uncorrected_score, score, correction, covariance) as
    tensors, for one device->host read."""
    unc = score_points_at_pose(config, grid, scan_points, scan_mask,
                               num_points, pose)
    res = match_scan(config, grid, scan_points, scan_mask, num_points, pose,
                     packed_table=packed_table)
    return unc, res.score, res.correction, res.covariance


def match_scan_windowed(config: ScanMatcherConfig, poses, points, point_mask,
                        window_mask, range_max: float, scan_points, scan_mask,
                        num_points: int, pose):
    """Per-scan step: window build (K1), uncorrected score (K3), match (K2).
    Returns (uncorrected_score, MatchResult)."""
    grid, table = build_window_ndt(config, poses, points, point_mask,
                                   window_mask, range_max)
    unc = score_points_at_pose(config, grid, scan_points, scan_mask,
                               num_points, pose)
    res = match_scan(config, grid, scan_points, scan_mask, num_points, pose,
                     packed_table=table)
    return unc, res


def match_scan_batch_multi(config: ScanMatcherConfig, poses, points,
                           point_mask, window_mask, range_max: float,
                           query_points, query_mask, query_num, start_poses):
    """Loop-closure confirmation of N rows, each a candidate window and
    its own query scan: every row's window build (K1) and match (K2) in one
    launch each.

    poses [N, S, 3], points [N, S, P, 2], point_mask [N, S, P], window_mask
    [N, S] (all-False rows are padding: their empty grids score 0 and never
    pass the acceptance gate); query_points [N, P, 2], query_mask [N, P],
    query_num [N] int32; start_poses [N, 3].  Returns (scores [N],
    corrections [N, 3], covariances [N, 3, 3]).  A row's result does not
    depend on N or on the other rows.  CPU tensors run the twins row by
    row."""
    check_supported(config)
    grid, tables = k1.build_windows(
        poses, points, point_mask, window_mask, range_max,
        config.ndt_resolution, config.grid_cells_x, config.grid_cells_y)
    res = k2.match_rows(config, grid, tables, query_points, query_mask,
                        query_num, start_poses,
                        *_search_offsets(config, points.device))
    return res.score, res.correction, res.covariance


@dataclasses.dataclass
class RollingWindow:
    """Device-resident rolling scan window, newest scan in the last slot.

    Unlike the reference's immutable arrays, ``window_append`` updates these
    tensors in place."""

    poses: torch.Tensor       # [D, 3] float32
    points: torch.Tensor      # [D, P, 2] float32
    point_mask: torch.Tensor  # [D, P] bool
    mask: torch.Tensor        # [D] bool


def make_window(depth: int, max_points: int, device=None) -> RollingWindow:
    return RollingWindow(
        poses=torch.zeros(depth, 3, dtype=torch.float32, device=device),
        points=torch.zeros(depth, max_points, 2, dtype=torch.float32,
                           device=device),
        point_mask=torch.zeros(depth, max_points, dtype=torch.bool,
                               device=device),
        mask=torch.zeros(depth, dtype=torch.bool, device=device))


def window_append(window: RollingWindow, pose, points,
                  point_mask) -> RollingWindow:
    """Shift the window left by one scan and put the new scan in the last
    slot, IN PLACE; returns the same window."""
    for field, new in ((window.poses, pose), (window.points, points),
                       (window.point_mask, point_mask)):
        field[:-1] = field[1:].clone()
        field[-1] = new
    window.mask[:-1] = window.mask[1:].clone()
    window.mask[-1] = True
    return window


def match_scan_rolling(config: ScanMatcherConfig, window: RollingWindow,
                       range_max: float, scan_points, scan_mask,
                       num_points: int, pose):
    """match_scan_windowed over a RollingWindow; returns the flat
    (uncorrected, score, correction, covariance) tuple of tensors."""
    unc, res = match_scan_windowed(
        config, window.poses, window.points, window.point_mask, window.mask,
        range_max, scan_points, scan_mask, num_points, pose)
    return unc, res.score, res.correction, res.covariance


class NDTScanMatcher:
    """Stateful matcher with the reference's ScanMatcher interface
    (initialize / addScans / matchScan / scorePoints / reset)."""

    def __init__(self, config: ScanMatcherConfig, range_max: float,
                 device=None):
        check_supported(config)
        self.config = config
        self.range_max = float(range_max)
        self.device = get_device(device)
        self.grid: Optional[ndt_grid.NDTGrid] = None
        self.packed_table = None

    def _tensor(self, x, dtype):
        return torch.as_tensor(np.array(x), device=self.device).to(dtype)

    def add_scans(self, poses, points, point_mask, window_mask=None):
        """Build the NDT of a window of scans, or of a whole loaded map:
        poses [S, 3], robot-frame points [S, P, 2], point_mask [S, P],
        window_mask [S] (default: every scan)."""
        poses = self._tensor(poses, torch.float32)
        if window_mask is None:
            window_mask = np.ones(poses.shape[0], bool)
        window_mask = self._tensor(window_mask, torch.bool)
        # The static grid must cover the window (the reference sizes its
        # grid per window, scan_matcher_ndt.cpp:52-67).
        wp = poses.cpu().numpy()[window_mask.cpu().numpy()]
        if wp.size:
            span = wp[:, :2].max(0) - wp[:, :2].min(0) + 2 * self.range_max
            need = np.ceil(span / self.config.ndt_resolution) + 1
            if (need[0] > self.config.grid_cells_x
                    or need[1] > self.config.grid_cells_y):
                raise ValueError(
                    f"scan window needs {need} cells > static grid "
                    f"({self.config.grid_cells_x}, "
                    f"{self.config.grid_cells_y}); increase "
                    "ScanMatcherConfig.grid_cells_*")
        self.grid, self.packed_table = build_window_ndt(
            self.config, poses, self._tensor(points, torch.float32),
            self._tensor(point_mask, torch.bool), window_mask,
            self.range_max)

    def match_scan(self, points, point_mask, num_points, pose) -> MatchResult:
        if self.grid is None:  # "Scans must be added first"
            z = torch.zeros((), device=self.device)
            return MatchResult(z, torch.zeros(3, device=self.device),
                               torch.zeros(3, 3, device=self.device))
        return match_scan(self.config, self.grid,
                          self._tensor(points, torch.float32),
                          self._tensor(point_mask, torch.bool),
                          int(num_points), self._tensor(pose, torch.float32),
                          self.range_max, self.packed_table)

    def score_points(self, points, point_mask, num_points, pose):
        if self.grid is None:
            return torch.zeros((), device=self.device)
        return score_points_at_pose(self.config, self.grid,
                                    self._tensor(points, torch.float32),
                                    self._tensor(point_mask, torch.bool),
                                    int(num_points),
                                    self._tensor(pose, torch.float32))

    def reset(self):
        self.grid = None
        self.packed_table = None
