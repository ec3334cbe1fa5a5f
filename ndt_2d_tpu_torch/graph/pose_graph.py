"""Host-side pose graph store (keyframes + constraints): the port's copy of
``ndt_2d_tpu/graph/pose_graph.py``, behaviour for behaviour.

Mirrors the reference ``Graph`` container (include/ndt_2d/graph.hpp:45-118):
scans and constraints with nearest-keyframe radius search.  The reference
rebuilds a nanoflann KD-tree from scratch on every query (src/graph.cpp:167-189);
on large graphs a brute-force masked distance computation is both simpler
and faster, and is what we do (vectorized numpy on host).

Storage is structure-of-arrays numpy with amortized capacity doubling (the
analog of std::vector growth) and padded per-scan point buffers so device
transfers are contiguous slices; poses are float64 on host (the graph is the
source of truth), cast to float32 at device boundaries.
"""

from __future__ import annotations

import numpy as np


class _GrowableRows:
    """Amortized-growth row store for a fixed row shape."""

    def __init__(self, row_shape, dtype, initial=64):
        self._data = np.zeros((initial,) + tuple(row_shape), dtype)
        self._n = 0

    def append(self, row) -> int:
        if self._n == self._data.shape[0]:
            grown = np.zeros((self._data.shape[0] * 2,) + self._data.shape[1:],
                             self._data.dtype)
            grown[:self._n] = self._data
            self._data = grown
        self._data[self._n] = row
        self._n += 1
        return self._n - 1

    @property
    def view(self) -> np.ndarray:
        return self._data[:self._n]

    @property
    def padded(self) -> np.ndarray:
        """The full capacity buffer (rows >= len() are zero).  Shapes change
        only on capacity doubling, so device code keyed on this shape
        recompiles O(log N) times instead of per append."""
        return self._data

    def __len__(self) -> int:
        return self._n


class Graph:
    """Keyframe graph: scans, constraints, nearest search, barycenters."""

    def __init__(self, max_points_per_scan: int, use_barycenter: bool = True):
        self.use_barycenter = use_barycenter
        self.max_points = max_points_per_scan
        self._poses = _GrowableRows((3,), np.float64)
        self._points = _GrowableRows((max_points_per_scan, 2), np.float32)
        self._point_mask = _GrowableRows((max_points_per_scan,), bool)
        self._point_means = _GrowableRows((2,), np.float64)
        self._has_points = _GrowableRows((), bool)
        self._c_begin = _GrowableRows((), np.int32)
        self._c_end = _GrowableRows((), np.int32)
        self._c_transform = _GrowableRows((3,), np.float64)
        self._c_information = _GrowableRows((3, 3), np.float64)
        self._c_switchable = _GrowableRows((), bool)

    # -- views ------------------------------------------------------------
    @property
    def poses(self) -> np.ndarray:
        return self._poses.view

    @property
    def points(self) -> np.ndarray:
        return self._points.view

    @property
    def point_mask(self) -> np.ndarray:
        return self._point_mask.view

    @property
    def constraint_begin(self) -> np.ndarray:
        return self._c_begin.view

    @property
    def constraint_end(self) -> np.ndarray:
        return self._c_end.view

    @property
    def constraint_transform(self) -> np.ndarray:
        return self._c_transform.view

    @property
    def constraint_information(self) -> np.ndarray:
        return self._c_information.view

    @property
    def constraint_switchable(self) -> np.ndarray:
        return self._c_switchable.view

    @property
    def points_padded(self) -> np.ndarray:
        return self._points.padded

    @property
    def point_mask_padded(self) -> np.ndarray:
        return self._point_mask.padded

    @property
    def num_scans(self) -> int:
        return len(self._poses)

    @property
    def num_constraints(self) -> int:
        return len(self._c_begin)

    # -- scans ------------------------------------------------------------
    def add_scan(self, pose, points: np.ndarray, point_mask: np.ndarray) -> int:
        """Append a keyframe; returns its id (== index, as in the reference
        where Scan ids are assigned graph_->scans.size(), ndt_mapper.cpp:398)."""
        scan_id = self._poses.append(np.asarray(pose, np.float64))
        self._points.append(np.asarray(points, np.float32))
        self._point_mask.append(np.asarray(point_mask, bool))
        n = int(point_mask.sum())
        mean = points[point_mask].mean(0) if n else np.zeros(2)
        self._point_means.append(np.asarray(mean, np.float64))
        self._has_points.append(n > 0)
        return scan_id

    def set_poses(self, poses: np.ndarray) -> None:
        """Overwrite all scan poses (after optimization).  Barycenters are
        derived quantities and follow automatically (cf. Scan::setPose
        marking the cached barycenter dirty, src/scan.cpp:44-48)."""
        view = self._poses.view
        assert poses.shape == view.shape
        view[:] = poses

    def barycenters(self) -> np.ndarray:
        """[N, 2] barycenter of each scan: pose + R(theta) * mean(points)
        (src/scan.cpp:72-91); equals the pose position for empty scans."""
        poses = self.poses
        th = poses[:, 2]
        c, s = np.cos(th), np.sin(th)
        means = self._point_means.view
        mx, my = means[:, 0], means[:, 1]
        off = np.stack([c * mx - s * my, s * mx + c * my], axis=-1)
        has = self._has_points.view[:, None]
        return poses[:, :2] + np.where(has, off, 0.0)

    def barycenter(self, i: int) -> np.ndarray:
        """Single-scan barycenter — O(1), for per-query use where
        barycenters() would recompute all N rows."""
        pose = self.poses[i]
        if not self._has_points.view[i]:
            return pose[:2].copy()
        c, s = np.cos(pose[2]), np.sin(pose[2])
        mx, my = self._point_means.view[i]
        return pose[:2] + np.asarray([c * mx - s * my, s * mx + c * my])

    def find_nearest(self, query_xy, dist: float = 10.0,
                     limit_scan_index: int = -1,
                     use_barycenter=None) -> np.ndarray:
        """Radius search over scan positions/barycenters.

        Mirrors Graph::findNearest (src/graph.cpp:167-189) including the
        nanoflann convention that ``dist`` is a *squared* L2 radius, and
        returns indices sorted by ascending distance.  ``limit_scan_index > 0``
        restricts the search to scans[0:limit] (used to exclude the rolling
        window during loop closure, ndt_mapper.cpp:615).
        ``use_barycenter`` overrides the graph's own setting for this query
        (the pose-space arm of the dual radius search; None = graph
        default).
        """
        limit = limit_scan_index if limit_scan_index > 0 else self.num_scans
        if limit == 0:
            return np.zeros(0, np.int64)
        ub = self.use_barycenter if use_barycenter is None else use_barycenter
        pos = (self.barycenters() if ub else self.poses[:, :2])[:limit]
        d2 = np.sum((pos - np.asarray(query_xy)[None, :]) ** 2, axis=-1)
        hits = np.nonzero(d2 < dist)[0]
        return hits[np.argsort(d2[hits], kind="stable")]

    # -- constraints ------------------------------------------------------
    def add_constraint(self, begin: int, end: int, transform, information,
                       switchable: bool = False) -> None:
        self._c_begin.append(np.int32(begin))
        self._c_end.append(np.int32(end))
        self._c_transform.append(np.asarray(transform, np.float64))
        self._c_information.append(np.asarray(information, np.float64))
        self._c_switchable.append(bool(switchable))


def make_constraint_np(graph: Graph, begin: int, end: int,
                       covariance: np.ndarray,
                       switchable: bool = False,
                       measured_end_pose=None) -> None:
    """makeConstraint (src/constraint.cpp:35-56) directly into the graph.

    ``measured_end_pose`` overrides the graph's current estimate of ``end``
    as the measurement source (cross-session merge constraints encode the
    registered pose, not the estimate); its angle delta is normalized since
    cross-session headings can differ by up to pi (the reference keeps the
    raw difference for its small in-session deltas).
    """
    pa = graph.poses[begin]
    if measured_end_pose is None:
        pb = graph.poses[end]
        dth = pb[2] - pa[2]
    else:
        pb = np.asarray(measured_end_pose, np.float64)
        dth = float(np.arctan2(np.sin(pb[2] - pa[2]), np.cos(pb[2] - pa[2])))
    dx, dy = pb[0] - pa[0], pb[1] - pa[1]
    c, s = np.cos(pa[2]), np.sin(pa[2])
    transform = np.asarray([c * dx + s * dy, -s * dx + c * dy, dth])
    information = np.linalg.inv(np.asarray(covariance, np.float64))
    graph.add_constraint(begin, end, transform, information, switchable)
