"""Trajectory metrics (ATE) for benchmark/e2e evaluation: the port's copy
of ``ndt_2d_tpu/utils/metrics.py``.

The reference publishes no accuracy numbers; ATE against simulated ground
truth is the driver-set accuracy metric (BASELINE.json).
"""

from __future__ import annotations

import numpy as np


def relative_to_first(poses: np.ndarray) -> np.ndarray:
    """Express a trajectory [N, 3] relative to its first pose (SE(2))."""
    p0 = poses[0]
    c, s = np.cos(-p0[2]), np.sin(-p0[2])
    d = poses[:, :2] - p0[:2]
    xy = np.stack([c * d[:, 0] - s * d[:, 1],
                   s * d[:, 0] + c * d[:, 1]], axis=-1)
    th = poses[:, 2] - p0[2]
    th = th - 2 * np.pi * np.floor((th + np.pi) / (2 * np.pi))
    return np.concatenate([xy, th[:, None]], axis=-1)


def ate_rmse(estimated: np.ndarray, truth: np.ndarray) -> float:
    """Absolute trajectory error (RMSE of positions) after aligning both
    trajectories to their first pose (the map frame starts at the first
    scan's pose in both the reference and this implementation).

    Note this anchors the SLAM gauge at the first pose: an early heading
    error appears as linearly growing lateral error even when the map is
    internally consistent.  ``ate_rmse_aligned`` removes the gauge the
    standard way (least-squares SE(2) fit, Horn's method).
    """
    est = relative_to_first(np.asarray(estimated, np.float64))
    tru = relative_to_first(np.asarray(truth, np.float64))
    d = est[:, :2] - tru[:, :2]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))


def ate_rmse_aligned(estimated: np.ndarray, truth: np.ndarray) -> float:
    """ATE RMSE after optimal SE(2) alignment of the estimate onto ground
    truth (2-D Horn's method — the TUM-benchmark convention), removing the
    unobservable global gauge of open-loop SLAM."""
    p = np.asarray(estimated, np.float64)[:, :2]
    q = np.asarray(truth, np.float64)[:, :2]
    pc = p - p.mean(0)
    qc = q - q.mean(0)
    # theta maximizing tr(R * sum q_c p_c^T)
    num = np.sum(pc[:, 0] * qc[:, 1] - pc[:, 1] * qc[:, 0])
    den = np.sum(pc[:, 0] * qc[:, 0] + pc[:, 1] * qc[:, 1])
    th = np.arctan2(num, den)
    c, s = np.cos(th), np.sin(th)
    pr = np.stack([c * pc[:, 0] - s * pc[:, 1],
                   s * pc[:, 0] + c * pc[:, 1]], axis=-1)
    d = pr - qc
    return float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))
