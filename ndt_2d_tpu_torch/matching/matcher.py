"""NDT scan matching on the port's kernels: window NDT build (K1), the
uncorrected score (K3), the exhaustive 3-DoF search (K2, or K6 where the
lattice is wider than one NDT cell) and its Newton polish (K7).

Port of the main-path subset of ``ndt_2d_tpu/matching/matcher.py``,
including the loop-closure confirmations ``match_scan_batch_multi`` (K1,
the search and K7 over a row axis, one launch each) and
``match_scan_batch_multi_coarse_fine`` (descriptor mode's far rows: the
coarse build and wide search, then the fine ones from the coarse-corrected
start, chained on the device), and for localization
``score_points_batch`` (K3 over a pose axis, the particle filter's
measurement) and ``match_scan_with_score`` (K3 + K2 + K7 against a global
grid).  ``config.overlapping_grids`` is a grid axis of 4 through K1, K2, K3
and K7 (the reference's K8: ``build_window_ndt`` stacks four half-cell
shifted grids, and every score is their mean); ``refine_iterations > 0``
chains K7 after K2 in every match.  The pipelined paths'
``mapping_step_async`` and ``localization_step_async`` keep the pose chain
on the device: K3 composes the start pose from the odometry motion as it
scores it, and K13 applies the correction and appends the scan to the
rolling window (``window_append``, one launch on every path), with no host
read.  The
plain steps of the search live beside their kernels and are re-exported
here under the reference's names
(``subsample``, ``window_origin``, ``prepare_neighborhood``,
``_candidate_scores_local``, ``_candidate_scores_gather``,
``reduce_candidates``, ``finalize_match``).

The search kernel follows the reference's rule (matcher.py:207-215): K2
when 2 * search_linear_size <= ndt_resolution, where every (angle, beam)
meets one 2x2 cell patch, and K6, the per-candidate cell gather, otherwise.

Every entry takes an optional device ``mesh`` (``parallel/mesh.py``), the
port of ``ndt_2d_tpu/parallel/runtime.py``'s sharded programs: the
search's angles shard over the mesh's ``space`` axis
(``parallel/matcher.py``), confirmation rows over ``batch`` (each rank
builds, searches and polishes its rows; the rows are gathered in rank
order at the end of the chain) and particles over ``batch``
(``parallel/filter.py``).  The window builds, the uncorrected score and
the Newton polish are replicated.  Every result equals the single-device
one bitwise, on every rank.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ndt_2d_tpu_torch.config import ScanMatcherConfig
from ndt_2d_tpu_torch.device import HostCopy, get_device
from ndt_2d_tpu_torch.kernels import candidate_gather as k6
from ndt_2d_tpu_torch.kernels import candidate_scores as k2
from ndt_2d_tpu_torch.kernels import ndt_build as k1
from ndt_2d_tpu_torch.kernels import newton as k7
from ndt_2d_tpu_torch.kernels import pose_chain as k13
from ndt_2d_tpu_torch.kernels import score_points as k3
from ndt_2d_tpu_torch.kernels.candidate_scores import (  # noqa: F401
    MatchResult, finalize_match, prepare_neighborhood, reduce_candidates)
from ndt_2d_tpu_torch.kernels.candidate_scores import (  # noqa: F401
    candidate_scores_local as _candidate_scores_local)
from ndt_2d_tpu_torch.kernels.candidate_gather import (  # noqa: F401
    candidate_scores_gather as _candidate_scores_gather)
from ndt_2d_tpu_torch.kernels.ndt_build import window_origin  # noqa: F401
from ndt_2d_tpu_torch.kernels.score_points import subsample  # noqa: F401
from ndt_2d_tpu_torch.ndt import grid as ndt_grid
from ndt_2d_tpu_torch.parallel import distributed
from ndt_2d_tpu_torch.parallel import filter as pfilter
from ndt_2d_tpu_torch.parallel import matcher as pmatcher
from ndt_2d_tpu_torch.parallel.mesh import (
    BATCH_AXIS, axis_group, axis_rank, axis_size)


def search_kernel(config: ScanMatcherConfig):
    """The module of the lattice search ``config`` needs: K2 when the
    translation window fits inside one NDT cell, else K6."""
    if 2.0 * config.search_linear_size <= config.ndt_resolution:
        return k2
    return k6


@functools.lru_cache(maxsize=16)
def _search_offsets(config: ScanMatcherConfig, device: torch.device):
    """The candidate lattice (angles [A], offsets [L]) cached per device;
    the tensors are never written."""
    return k2.search_offsets(config, device)


def num_grids(config: ScanMatcherConfig) -> int:
    """Grids per window: 4 with overlapping_grids, else 1."""
    return 4 if config.overlapping_grids else 1


def is_multi_grid(grid: ndt_grid.NDTGrid) -> bool:
    """True for a window's stacked overlapping grids ([4, ...] fields)."""
    return grid.mean.dim() == 3


def build_window_ndt(config: ScanMatcherConfig, poses, points, point_mask,
                     window_mask, range_max: float):
    """Window NDT (ScanMatcherNDT::addScans) on K1: (NDTGrid, patch table).

    poses [S, 3], points [S, P, 2] robot frame, point_mask [S, P],
    window_mask [S] (which scans participate).  With overlapping_grids the
    four half-cell shifted grids: [4, ...] fields and tables [4, C, 32]."""
    return k1.build_window(poses, points, point_mask, window_mask,
                           range_max, config.ndt_resolution,
                           config.grid_cells_x, config.grid_cells_y,
                           num_grids(config))


def _search_rows(config: ScanMatcherConfig, grid: ndt_grid.NDTGrid, tables,
                 points, point_mask, num_points, poses, mesh=None,
                 append=None):
    """The lattice search (K2 or K6) of R rows: [R, 13] output rows.  With
    a ``mesh`` its angles shard over the ``space`` axis (K12), and
    ``append`` (the fused SLAM step's KB4) rides in its finalize."""
    kern = search_kernel(config)
    dths, dls = _search_offsets(config, points.device)
    if mesh is None:
        return kern.match_rows(config, grid, tables, points, point_mask,
                               num_points, poses, dths, dls)
    return pmatcher.search_rows(kern, config, mesh, grid, tables, points,
                                point_mask, num_points, poses, dths, dls,
                                append)


def match_scan(config: ScanMatcherConfig, grid: ndt_grid.NDTGrid, points,
               point_mask, num_points: int, pose, range_max=None,
               packed_table=None, mesh=None, append=None) -> MatchResult:
    """Exhaustive 3-DoF search of one scan against a window NDT (K2 or
    K6), then with refine_iterations > 0 its Newton polish from the lattice
    winner (K7, matcher.py:384-393): the refined score and correction, the
    search's covariance.

    ``packed_table`` is K1's patch table; without it the table is laid out
    from the grid.  With a ``mesh`` the search's angles shard over its
    ``space`` axis (parallel/matcher.py:48) and the polish is replicated.
    ``append`` (a ``kernels.slam_step.Append``; a mesh's K2 search without
    the polish, ``parallel/slam_step.py::append_route``): the fused SLAM
    step's KB4, written by the search's finalize launch."""
    del range_max  # part of the reference's signature; unused here
    if append is not None and (mesh is None or config.refine_iterations > 0):
        raise ValueError("the append rides in a mesh's finalize, with no "
                         "polish after it")
    if packed_table is None:
        packed_table = ndt_grid.patch_tables(grid, config.grid_cells_x)
    if mesh is None:
        dths, dls = _search_offsets(config, points.device)
        out = search_kernel(config).match(config, grid, packed_table,
                                          points, point_mask, num_points,
                                          pose, dths, dls)
    else:
        row = ndt_grid.NDTGrid(origin=grid.origin[None],
                               cell_size=grid.cell_size, mean=None,
                               information=None, count=None, covariance=None)
        out = _search_rows(config, row, packed_table[None], points[None],
                           point_mask[None], num_points, pose[None], mesh,
                           append)
    if config.refine_iterations > 0:
        out = k7.refine(config, grid, packed_table, points, point_mask,
                        num_points, pose, out, config.refine_iterations)
    res = k2.unpack(out)
    return MatchResult(res.score[0], res.correction[0], res.covariance[0])


def score_points_at_pose(config: ScanMatcherConfig, grid: ndt_grid.NDTGrid,
                         points, point_mask, num_points: int, pose):
    """ScanMatcherNDT::scorePoints on K3: mean negative likelihood."""
    return k3.score_at_pose(grid, config.grid_cells_x, config.grid_cells_y,
                            config.laser_max_beams, points, point_mask,
                            num_points, pose)


def score_points_batch(config: ScanMatcherConfig, grid: ndt_grid.NDTGrid,
                       points, point_mask, num_points: int, poses,
                       mesh=None, packed_table=None):
    """scorePoints over poses [M, 3] in one launch of K3's particle kernel,
    each cell read from its record in ``packed_table`` (K1's patch table;
    without it the table is laid out from the grid): the particle filter's
    measurement (replaces the per-particle loop at
    src/particle_filter.cpp:81-88).  Row m equals ``score_points_at_pose``
    at poses[m] bitwise.  With a ``mesh`` the poses shard over its
    ``batch`` axis (parallel/filter.py)."""
    if mesh is not None:
        return pfilter.measure_multichip(config, mesh, grid, points,
                                         point_mask, num_points, poses,
                                         packed_table)
    if packed_table is None:
        packed_table = ndt_grid.patch_tables(grid, config.grid_cells_x)
    return k3.score_records(grid, packed_table, config.grid_cells_x,
                            config.grid_cells_y, config.laser_max_beams,
                            points, point_mask, num_points, poses)


def match_scan_with_score(config: ScanMatcherConfig,
                          grid: ndt_grid.NDTGrid, scan_points, scan_mask,
                          num_points: int, pose, packed_table=None,
                          mesh=None):
    """scoreScan + matchScan against a prebuilt (global) grid, the
    scan-match localization step (ndt_mapper.cpp:556-558): K3 + the search
    at one pose.  Returns (uncorrected_score, score, correction, covariance) as
    tensors, for one device->host read."""
    unc = score_points_at_pose(config, grid, scan_points, scan_mask,
                               num_points, pose)
    res = match_scan(config, grid, scan_points, scan_mask, num_points, pose,
                     packed_table=packed_table, mesh=mesh)
    return unc, res.score, res.correction, res.covariance


def match_scan_windowed(config: ScanMatcherConfig, poses, points, point_mask,
                        window_mask, range_max: float, scan_points, scan_mask,
                        num_points: int, pose, mesh=None):
    """Per-scan step: window build (K1), uncorrected score (K3), match (K2
    or K6).  Returns (uncorrected_score, MatchResult)."""
    grid, table = build_window_ndt(config, poses, points, point_mask,
                                   window_mask, range_max)
    unc = score_points_at_pose(config, grid, scan_points, scan_mask,
                               num_points, pose)
    res = match_scan(config, grid, scan_points, scan_mask, num_points, pose,
                     packed_table=table, mesh=mesh)
    return unc, res


def _match_rows(config: ScanMatcherConfig, poses, points, point_mask,
                window_mask, range_max: float, query_points, query_mask,
                query_num, start_poses, mesh=None):
    """One stage of a confirmation over N rows: every row's window build
    (K1), lattice search (K2 or K6; with a ``mesh``, angle-sharded over
    its ``space`` axis) and, with refine_iterations > 0, Newton polish
    (K7), one launch each.  Returns the [N, 13] output rows on the
    device."""
    grid, tables = k1.build_windows(
        poses, points, point_mask, window_mask, range_max,
        config.ndt_resolution, config.grid_cells_x, config.grid_cells_y,
        num_grids(config))
    out = _search_rows(config, grid, tables, query_points, query_mask,
                       query_num, start_poses, mesh)
    if config.refine_iterations > 0:
        out = k7.refine_rows(config, grid, tables, query_points,
                             query_mask, query_num, start_poses, out,
                             config.refine_iterations)
    return out


def _batch_shard(mesh, n: int) -> slice:
    """This rank's rows of an N-row batch sharded over the mesh's
    ``batch`` axis (N a multiple of its size: pad with all-False windows)."""
    nb = axis_size(mesh, BATCH_AXIS)
    if n % nb:
        raise ValueError(f"{n} rows do not divide over {nb} batch shards; "
                         "pad them")
    b = axis_rank(mesh, BATCH_AXIS)
    return slice(b * (n // nb), (b + 1) * (n // nb))


def _gather_batch(mesh, rows):
    """Every rank's rows [Nb, F] of a batch-sharded result, in rank order:
    [N, F] on every rank."""
    every = distributed.gather(rows, axis_group(mesh, BATCH_AXIS))
    return every.reshape(-1, rows.shape[1])


def match_scan_batch_multi(config: ScanMatcherConfig, poses, points,
                           point_mask, window_mask, range_max: float,
                           query_points, query_mask, query_num, start_poses,
                           mesh=None):
    """Loop-closure confirmation of N rows, each a candidate window and
    its own query scan: every row's window build (K1), match (K2 or K6)
    and, with refine_iterations > 0, Newton polish (K7) in one launch each.

    poses [N, S, 3], points [N, S, P, 2], point_mask [N, S, P], window_mask
    [N, S] (all-False rows are padding: their empty grids score 0 and never
    pass the acceptance gate); query_points [N, P, 2], query_mask [N, P],
    query_num [N] int32; start_poses [N, 3].  Returns (scores [N],
    corrections [N, 3], covariances [N, 3, 3]).  A row's result does not
    depend on N or on the other rows.  CPU tensors run the twins row by
    row.  With a ``mesh`` the rows shard over its ``batch`` axis and each
    row's angles over ``space`` (runtime.py:288); N must divide over the
    batch shards."""
    windows = (poses, points, point_mask, window_mask)
    query = (query_points, query_mask, query_num, start_poses)
    if mesh is None:
        out = _match_rows(config, *windows, range_max, *query)
    else:
        sl = _batch_shard(mesh, poses.shape[0])
        out = _gather_batch(mesh, _match_rows(
            config, *[w[sl] for w in windows], range_max,
            *[q[sl] for q in query], mesh=mesh))
    res = k2.unpack(out)
    return res.score, res.correction, res.covariance


def match_scan_batch_multi_coarse_fine(
        coarse_config: ScanMatcherConfig, fine_config: ScanMatcherConfig,
        poses, points, point_mask, window_mask, range_max: float,
        query_points, query_mask, query_num, start_poses, mesh=None):
    """Coarse-to-fine confirmation of N far rows (matcher.py:580-606):
    every row's start pose carries unknown odometry drift, so the wide
    coarse lattice aligns first (K1 at the coarse resolution, then K6),
    and the fine match (K1, K2, K7) scores from the coarse-corrected
    start.  The chain stays on the device: the fine starts are a tensor
    the host never reads before the results.  Arguments as
    ``match_scan_batch_multi``.  Returns (fine_starts [N, 3], scores [N],
    corrections [N, 3], covariances [N, 3, 3]), the corrections relative to
    the fine starts.  With a ``mesh`` each rank runs the chain on its
    ``batch`` shard of the rows (angles over ``space``), and the starts and
    results are gathered at its end (runtime.py:335)."""
    if mesh is not None:
        sl = _batch_shard(mesh, poses.shape[0])
        poses, points, point_mask, window_mask = (
            w[sl] for w in (poses, points, point_mask, window_mask))
        query_points, query_mask, query_num, start_poses = (
            q[sl] for q in (query_points, query_mask, query_num,
                            start_poses))
    windows = (poses, points, point_mask, window_mask, range_max)
    query = (query_points, query_mask, query_num)
    coarse = k2.unpack(_match_rows(coarse_config, *windows, *query,
                                   start_poses, mesh=mesh))
    fine_starts = start_poses + coarse.correction
    out = _match_rows(fine_config, *windows, *query, fine_starts, mesh=mesh)
    if mesh is not None:
        both = _gather_batch(mesh, torch.cat([fine_starts, out], 1))
        fine_starts, out = both[:, :3], both[:, 3:]
    fine = k2.unpack(out)
    return fine_starts, fine.score, fine.correction, fine.covariance


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
    """Shift the window left by one scan and put the new scan (``pose``
    [3], ``points`` [P, 2], ``point_mask`` [P]) in the last slot, IN
    PLACE, in one K13 launch; returns the same window."""
    k13.window_append(pose, None, window, points, point_mask)
    return window


def match_scan_rolling(config: ScanMatcherConfig, window: RollingWindow,
                       range_max: float, scan_points, scan_mask,
                       num_points: int, pose, mesh=None):
    """match_scan_windowed over a RollingWindow; returns the flat
    (uncorrected, score, correction, covariance) tuple of tensors."""
    unc, res = match_scan_windowed(
        config, window.poses, window.points, window.point_mask, window.mask,
        range_max, scan_points, scan_mask, num_points, pose, mesh)
    return unc, res.score, res.correction, res.covariance


def mapping_step_async(config: ScanMatcherConfig, window: RollingWindow,
                       prev_pose, range_max: float, points, mask,
                       num_points: int, delta, mesh=None):
    """One mapping step with the pose chain on the device (matcher.py:638):
    build the window NDT (K1); compose the start pose from the previous
    corrected pose ``prev_pose`` [3] and the odometry motion ``delta`` [3]
    in its robot frame and score the scan there (K3, one launch); match (K2
    or K6, K7 when refining); then apply the correction and append the scan
    at the corrected pose to the window (K13, one launch).  Everything
    runs on the current stream with no host read; the window is updated in
    place.

    Returns (window, new pose [3], (uncorrected, score, correction,
    covariance, new pose) device tensors, a ``HostCopy`` of their flat [17]
    values, already in flight)."""
    grid, table = build_window_ndt(config, window.poses, window.points,
                                   window.point_mask, window.mask, range_max)
    unc, pose = k3.score_composed(grid, config.grid_cells_x,
                                  config.grid_cells_y,
                                  config.laser_max_beams, points, mask,
                                  num_points, prev_pose, delta)
    res = match_scan(config, grid, points, mask, num_points, pose,
                     packed_table=table, mesh=mesh)
    new_pose = k13.window_append(pose, res.correction, window, points, mask)
    out = (unc, res.score, res.correction, res.covariance, new_pose)
    return window, new_pose, out, _host_copy(out)


def localization_step_async(config: ScanMatcherConfig,
                            grid: ndt_grid.NDTGrid, prev_pose, points, mask,
                            num_points: int, delta, packed_table=None,
                            mesh=None):
    """Scan-match localization step with the pose chain on the device
    (matcher.py:675): compose the start pose and score there (K3, one
    launch), match against the global grid (K2 or K6, K7 when refining),
    apply the correction (K13, with no window), with no host read.
    Returns (new pose [3], (uncorrected, score, correction, new pose)
    device tensors, a ``HostCopy`` of their flat [8] values)."""
    unc, pose = k3.score_composed(grid, config.grid_cells_x,
                                  config.grid_cells_y,
                                  config.laser_max_beams, points, mask,
                                  num_points, prev_pose, delta)
    res = match_scan(config, grid, points, mask, num_points, pose,
                     packed_table=packed_table, mesh=mesh)
    new_pose = k13.window_append(pose, res.correction)
    out = (unc, res.score, res.correction, new_pose)
    return new_pose, out, _host_copy(out)


def _host_copy(tensors) -> HostCopy:
    """The step's results as one flat tensor, copied to the host without
    blocking."""
    return HostCopy(torch.cat([t.reshape(-1) for t in tensors]))


class GridCapacityError(ValueError):
    """A scan window does not fit the matcher's static grid."""


class NDTScanMatcher:
    """Stateful matcher with the reference's ScanMatcher interface
    (initialize / addScans / matchScan / scorePoints / reset)."""

    def __init__(self, config: ScanMatcherConfig, range_max: float,
                 device=None):
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
                raise GridCapacityError(
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
