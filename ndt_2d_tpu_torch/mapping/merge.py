"""Multi-session map merge: align and fuse two saved maps into one graph.

Port of ``ndt_2d_tpu/mapping/merge.py`` on the port's matcher, descriptors
and solver:

1. **Candidate pairs**: rotation-invariant descriptors for every keyframe
   of both maps and the cross cosine similarity (kernel K10,
   ``parallel/loop_search.py`` and ``kernels/descriptor_search.py``), the
   top-K pairs above a similarity floor.
2. **Confirmation**: per pair (i, j), a 7-slot NDT window around map A's
   scan i, and map B's scan j registered against it coarse-to-fine.  The
   relative heading of two sessions is arbitrary, so the coarse lattice
   spans the full +-pi range (126 angles x 41 x 41 offsets: kernel K6).
3. **Consistency**: every confirmed pair votes an SE(2) alignment
   T_ab = pose_j_in_a o inverse(pose_j_in_b); the largest mutually
   consistent subset wins and needs >= min_matches members.
4. **Fusion**: B's scans are appended with poses T_ab o pose_b, B's own
   constraints carry over, each surviving match becomes a switchable
   cross-map constraint with the match covariance, and one joint LM solve
   (K4) polishes the seam.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from ndt_2d_tpu_torch.config import MapperConfig, ScanMatcherConfig
from ndt_2d_tpu_torch.core import pose as pose_ops
from ndt_2d_tpu_torch.device import get_device
from ndt_2d_tpu_torch.graph import solver
from ndt_2d_tpu_torch.graph.pose_graph import Graph, make_constraint_np
from ndt_2d_tpu_torch.kernels import descriptor_search
from ndt_2d_tpu_torch.matching.matcher import (GridCapacityError,
                                               NDTScanMatcher)
from ndt_2d_tpu_torch.parallel import loop_search

logger = logging.getLogger(__name__)


def _round32(x: float) -> int:
    return int(-(-x // 32) * 32)


def _coarse_config(range_max: float, window_span: float) -> ScanMatcherConfig:
    """Full-heading coarse lattice for cross-session registration, its grid
    sized from the widest confirmation window's pose spread."""
    span = window_span + 4.0 + 2.0 * range_max
    cells = _round32(span / 0.5)
    return ScanMatcherConfig(
        ndt_resolution=0.5, search_linear_size=2.0,
        search_linear_resolution=0.1,
        search_angular_size=np.pi, search_angular_resolution=0.05,
        grid_cells_x=cells, grid_cells_y=cells)


def _fine_config(range_max: float, window_span: float) -> ScanMatcherConfig:
    span = window_span + 4.0 + 2.0 * range_max
    cells = _round32(span / 0.25)
    return ScanMatcherConfig(grid_cells_x=cells, grid_cells_y=cells)


def _window(graph: Graph, i: int, half: int = 3):
    """Scans [i-half, i+half] as a fixed (2*half+1)-slot window: wider than
    the in-session loop-closure window, because a cross-session query views
    the scene from an unrelated pose and the window NDT must explain most
    of its beams."""
    slots = 2 * half + 1
    begin = max(i - half, 0)
    end = min(i + half, graph.num_scans - 1)
    k = end - begin + 1
    poses = np.zeros((slots, 3), np.float32)
    pts = np.zeros((slots, graph.max_points, 2), np.float32)
    msk = np.zeros((slots, graph.max_points), bool)
    wmask = np.zeros(slots, bool)
    poses[:k] = graph.poses[begin:end + 1].astype(np.float32)
    pts[:k] = graph.points[begin:end + 1]
    msk[:k] = graph.point_mask[begin:end + 1]
    wmask[:k] = True
    return poses, pts, msk, wmask


def _compose(a, b) -> np.ndarray:
    """a o b on host poses, in the float32 of ``core/pose.py``."""
    return pose_ops.compose(torch.tensor(a, dtype=torch.float32),
                            torch.tensor(b, dtype=torch.float32)).numpy()


def _inverse(a) -> np.ndarray:
    return pose_ops.inverse(torch.tensor(a, dtype=torch.float32)).numpy()


class MergeError(ValueError):
    """The two maps cannot be merged: one is empty, their scan buffers
    differ, or no consistent alignment was found."""


@dataclasses.dataclass
class MergeResult:
    graph: Graph
    transform: np.ndarray          # SE(2) taking B-frame poses into A-frame
    pairs_checked: int
    pairs_accepted: int
    optimized: bool


def merge_maps(graph_a: Graph, graph_b: Graph, range_max: float,
               config: MapperConfig = MapperConfig(),
               top_k: int = 10, min_similarity: float = 0.9,
               score_threshold: float = -0.25, min_matches: int = 2,
               consistency_xy: float = 0.5,
               consistency_theta: float = 0.2, device=None) -> MergeResult:
    """Merge graph_b into graph_a's frame, on ``device`` (``cuda`` unless
    ``cpu`` is passed).  Raises MergeError if no consistent alignment is
    found."""
    dev = get_device(device)
    na, nb = graph_a.num_scans, graph_b.num_scans
    if not na or not nb:
        raise MergeError("both maps need scans to merge")
    if graph_a.max_points != graph_b.max_points:
        raise MergeError("maps were saved with different max_points_per_scan")

    # 1. Descriptor cross-similarity -> candidate pairs.
    def table(g):
        return loop_search.descriptors(
            torch.from_numpy(g.points).to(dev),
            torch.from_numpy(g.point_mask).to(dev),
            float(np.float32(range_max)), config.descriptor_bins)
    # The top_k best pairs overall are among each A-scan's top_k B-scans.
    k = min(top_k, nb)
    idx, sims = descriptor_search.top_k(
        table(graph_a), table(graph_b),
        torch.ones(nb, dtype=torch.bool, device=dev),
        torch.full((na,), nb - 1, dtype=torch.int32, device=dev), k)
    idx, sims = idx.cpu().numpy(), sims.cpu().numpy()
    order = np.argsort(sims, axis=None)[::-1][:top_k]
    pairs = [(int(p // k), int(idx.flat[p])) for p in order
             if sims.flat[p] >= min_similarity]
    # Pairs sharing an A-scan follow each other and reuse its built NDTs.
    pairs.sort()

    # Grid extent from the widest actual window, fixed per merge.
    window_span = 0.0
    for i, _ in pairs:
        poses, _, _, wmask = _window(graph_a, i)
        wp = poses[wmask]
        if len(wp):
            window_span = max(window_span,
                              float((wp[:, :2].max(0) - wp[:, :2].min(0)).max()))

    # 2. Coarse-to-fine confirmation of each pair.
    coarse = NDTScanMatcher(_coarse_config(range_max, window_span), range_max,
                            device=dev)
    fine = NDTScanMatcher(_fine_config(range_max, window_span), range_max,
                          device=dev)
    matches = []  # (i, j, pose_j_in_a [3], covariance [3,3], score)
    window_i = None
    for i, j in pairs:
        if not graph_a.point_mask[i].any() or not graph_b.point_mask[j].any():
            continue
        if i != window_i:
            poses, pts, msk, wmask = _window(graph_a, i)
            try:
                coarse.add_scans(poses, pts, msk, wmask)
                fine.add_scans(poses, pts, msk, wmask)
            except GridCapacityError as e:  # skip this window, not the merge
                logger.warning("merge: skipping window around A[%d]: %s", i, e)
                window_i = None
                continue
            window_i = i
        qpts = graph_b.points[j]
        qmask = graph_b.point_mask[j]
        nq = int(qmask.sum())
        # Start at A's candidate position; the heading is unknown, so the
        # coarse lattice covers the full +-pi range.
        start = graph_a.poses[i].copy()
        cres = coarse.match_scan(qpts, qmask, nq, start.astype(np.float32))
        start = start + cres.correction.cpu().numpy().astype(np.float64)
        fres = fine.match_scan(qpts, qmask, nq, start.astype(np.float32))
        flat = torch.cat([fres.score.reshape(1), fres.correction,
                          fres.covariance.reshape(9)]).cpu().numpy().astype(
                              np.float64)
        score = float(flat[0])
        if np.isfinite(score) and score < score_threshold:
            matches.append((i, j, start + flat[1:4], flat[4:13].reshape(3, 3),
                            score))
            logger.info("merge match A[%d] <- B[%d] score %.3f", i, j, score)
        else:
            logger.info("merge reject A[%d] <- B[%d] score %.3f", i, j, score)

    # 3. Consistency vote on T_ab, evaluated at each match's own location
    # ("does transform k predict match m's registered pose?"): comparing
    # the transforms' translations directly would amplify a small heading
    # difference by the overlap's distance from B's origin.
    def t_ab(m):
        _, j, pja, _, _ = m
        return _compose(pja, _inverse(graph_b.poses[j]))

    best_set = []
    for tk in [t_ab(m) for m in matches]:
        group = []
        for m in matches:
            _, j, pja, _, _ = m
            pred = _compose(tk, graph_b.poses[j])
            dth = float(pose_ops.normalize_angle(
                torch.tensor(pred[2] - pja[2], dtype=torch.float32)))
            if (np.hypot(*(pred[:2] - pja[:2])) < consistency_xy
                    and abs(dth) < consistency_theta):
                group.append(m)
        if len(group) > len(best_set):
            best_set = group
    if len(best_set) < min_matches:
        raise MergeError(
            f"map merge failed: {len(matches)} confirmed matches, largest "
            f"consistent set {len(best_set)} < min_matches={min_matches}")
    best_set.sort(key=lambda m: m[4])  # best (lowest) score first
    T = t_ab(best_set[0])

    # 4. Fuse into one graph.
    merged = Graph(max_points_per_scan=graph_a.max_points,
                   use_barycenter=graph_a.use_barycenter)
    for i in range(na):
        merged.add_scan(graph_a.poses[i], graph_a.points[i],
                        graph_a.point_mask[i])
    for j in range(nb):
        merged.add_scan(_compose(T, graph_b.poses[j]), graph_b.points[j],
                        graph_b.point_mask[j])
    for g, offset in ((graph_a, 0), (graph_b, na)):
        for c in range(g.num_constraints):
            merged.add_constraint(
                offset + int(g.constraint_begin[c]),
                offset + int(g.constraint_end[c]), g.constraint_transform[c],
                g.constraint_information[c],
                bool(g.constraint_switchable[c]))
    # Cross-map constraints encode the MEASURED relative pose (the match),
    # not the current estimate (makeConstraint math, constraint.cpp:35-56).
    for i, j, pja, cov, _ in best_set:
        make_constraint_np(merged, i, na + j, cov, switchable=True,
                           measured_end_pose=pja)

    # 5. Joint solve (gauge-fixed to A's frame at node 0).
    optimized = solver.solve_graph(merged, config.solver, device=dev)
    return MergeResult(graph=merged, transform=T,
                       pairs_checked=len(pairs), pairs_accepted=len(best_set),
                       optimized=bool(optimized))
