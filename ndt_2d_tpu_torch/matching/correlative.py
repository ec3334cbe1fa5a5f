"""Correlative occupancy scan matcher, the alternative matcher plugin, on
kernel K11.

Port of ``ndt_2d_tpu/matching/correlative.py``: the window's points render
into a hit grid, blurred with a 7-tap Gaussian into a smooth likelihood
field (``build_field``); a candidate pose scores minus the field values
under its subsampled beams, searched over the NDT matcher's exhaustive
(angle, dx, dy) lattice with its argmin, per-beam normalization and Olson
covariance (``match_scan_field``), so the mapper's gates and constraints
take it unchanged.  ``match_scan_with_score`` is the mapper's score at the
start pose and the search from it in one lattice launch.  Select it with
``scan_matcher_type="correlative"``.  The field's resolution is
``ndt_resolution``.
"""

from __future__ import annotations

import numpy as np
import torch

from ndt_2d_tpu_torch.config import ScanMatcherConfig
from ndt_2d_tpu_torch.device import get_device
from ndt_2d_tpu_torch.kernels import candidate_scores as k2
from ndt_2d_tpu_torch.kernels import correlative as k11
from ndt_2d_tpu_torch.kernels.candidate_scores import MatchResult
from ndt_2d_tpu_torch.matching.matcher import _search_offsets


def build_field(config: ScanMatcherConfig, poses, points, point_mask,
                window_mask, range_max: float):
    """Blurred, normalized hit field [H, W] and its origin [2] for a scan
    window (correlative.py:38): poses [S, 3], robot-frame points [S, P, 2],
    point_mask [S, P], window_mask [S]."""
    return k11.build_field(poses, points, point_mask, window_mask, range_max,
                           config.ndt_resolution, config.grid_cells_x,
                           config.grid_cells_y)


def match_scan_field(config: ScanMatcherConfig, field, origin, points,
                     point_mask, num_points: int, pose) -> MatchResult:
    """Exhaustive lattice search of one scan against the field
    (correlative.py:76)."""
    dths, dls = _search_offsets(config, points.device)
    res = k2.unpack(k11.match(config, field, origin, points, point_mask,
                              num_points, pose, dths, dls))
    return MatchResult(res.score[0], res.correction[0], res.covariance[0])


def match_scan_with_score(config: ScanMatcherConfig, field, origin, points,
                          point_mask, num_points: int, pose):
    """``score_points_field`` at ``pose``, then ``match_scan_field`` from
    it, in one lattice launch (the score written by a warp of the
    search's own launch).  Returns (0-d score, MatchResult), the same bits
    as the two calls."""
    dths, dls = _search_offsets(config, points.device)
    out, unc = k11.match(config, field, origin, points, point_mask,
                         num_points, pose, dths, dls, with_unc=True)
    res = k2.unpack(out)
    return unc[0], MatchResult(res.score[0], res.correction[0],
                               res.covariance[0])


def score_points_field(config: ScanMatcherConfig, field, origin, points,
                       point_mask, num_points: int, pose):
    """Minus the mean field value under the subsampled beams at ``pose``
    [3] (correlative.py:108); a 0-d tensor."""
    return k11.score_batch(config, field, origin, points, point_mask,
                           num_points, pose.reshape(1, 3))[0]


class CorrelativeScanMatcher:
    """Stateful matcher with the reference's ScanMatcher interface
    (initialize / addScans / matchScan / scorePoints / reset)."""

    def __init__(self, config: ScanMatcherConfig, range_max: float,
                 device=None):
        self.config = config
        self.range_max = float(range_max)
        self.device = get_device(device)
        self.field = None
        self.origin = None

    def _tensor(self, x, dtype):
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.array(x), device=self.device).to(dtype)

    def add_scans(self, poses, points, point_mask, window_mask=None):
        """Build the field of a window (numpy arrays or tensors)."""
        poses = self._tensor(poses, torch.float32)
        if window_mask is None:
            window_mask = np.ones(poses.shape[0], bool)
        self.field, self.origin = build_field(
            self.config, poses, self._tensor(points, torch.float32),
            self._tensor(point_mask, torch.bool),
            self._tensor(window_mask, torch.bool), self.range_max)

    def match_scan(self, points, point_mask, num_points, pose) -> MatchResult:
        if self.field is None:  # "Scans must be added first"
            z = torch.zeros((), device=self.device)
            return MatchResult(z, torch.zeros(3, device=self.device),
                               torch.zeros(3, 3, device=self.device))
        return match_scan_field(self.config, self.field, self.origin,
                                self._tensor(points, torch.float32),
                                self._tensor(point_mask, torch.bool),
                                int(num_points),
                                self._tensor(pose, torch.float32))

    def match_scan_with_score(self, points, point_mask, num_points, pose):
        """``score_points`` at ``pose`` and ``match_scan`` from it in one
        lattice launch: (0-d score, MatchResult), zeros before any scan
        is added."""
        if self.field is None:
            return (torch.zeros((), device=self.device),
                    self.match_scan(points, point_mask, num_points, pose))
        return match_scan_with_score(self.config, self.field, self.origin,
                                     self._tensor(points, torch.float32),
                                     self._tensor(point_mask, torch.bool),
                                     int(num_points),
                                     self._tensor(pose, torch.float32))

    def score_points(self, points, point_mask, num_points, pose):
        """scorePoints: minus the mean field value at ``pose``."""
        if self.field is None:
            return torch.zeros((), device=self.device)
        return score_points_field(self.config, self.field, self.origin,
                                  self._tensor(points, torch.float32),
                                  self._tensor(point_mask, torch.bool),
                                  int(num_points),
                                  self._tensor(pose, torch.float32))

    def reset(self):
        self.field = None
        self.origin = None
