"""Bag replay loop around the port's ``Mapper``.

Port of ``ndt_2d_tpu/mapping/runtime.py::run_bag`` and ``sweep_end_odom``
(without the UNIX-socket control channel).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ndt_2d_tpu_torch.mapping.mapper import Mapper
from ndt_2d_tpu_torch.io.bag import ScanBag
from ndt_2d_tpu_torch.utils import metrics


def sweep_end_odom(bag: ScanBag, t: int, msg) -> Optional[np.ndarray]:
    """Odometry pose at the END of scan t's sweep, for motion de-skew, or
    None when the sweep has no duration (ndt_mapper.cpp:368-370)."""
    sweep = msg.time_increment * (len(msg.ranges) - 1)
    if sweep <= 0 or t + 1 >= len(bag):
        return None
    nxt, cur = bag.odom[t + 1], bag.odom[t]
    d = nxt - cur
    d = np.asarray([d[0], d[1], np.arctan2(np.sin(d[2]), np.cos(d[2]))])
    frac = 1.0
    if bag.times is not None and bag.times[t + 1] > bag.times[t]:
        frac = min(sweep / float(bag.times[t + 1] - bag.times[t]), 1.0)
    return cur + d * frac


def run_bag(mapper: Mapper, bag: ScanBag,
            progress: Optional[Callable[[int, object], None]] = None) -> dict:
    """Replay a bag through the mapper; returns session statistics, with
    ATE against ground truth when the bag carries it."""
    est, used_truth, accepted, est_t = [], [], 0, []
    for t, (msg, odom_pose) in enumerate(bag):
        res = mapper.process_scan(msg, odom_pose, sweep_end_odom(bag, t, msg))
        if res.accepted:
            accepted += 1
            est.append(res.pose)
            est_t.append(t)
            if bag.truth is not None:
                used_truth.append(bag.truth[t])
        if progress:
            progress(t, res)
    mapper.flush()
    mapper.loop_closure()

    stats = {
        "scans_in": len(bag),
        "scans_accepted": accepted,
        "graph_scans": mapper.graph.num_scans,
        "graph_constraints": mapper.graph.num_constraints,
        "loop_closures": int(mapper.graph.constraint_switchable.sum()),
        "session": mapper.stats.summary(),
    }
    if bag.truth is not None and len(est) > 1:
        stats["ate_rmse_m"] = metrics.ate_rmse(
            np.asarray(est), np.asarray(used_truth))
        stats["odom_ate_rmse_m"] = metrics.ate_rmse(bag.odom, bag.truth)
    # Private keys (numpy, not JSON): the estimated trajectory, for
    # --traj-out export; callers pop these before serializing.
    stats["_est"] = np.asarray(est) if est else np.zeros((0, 3))
    stats["_est_t"] = np.asarray(est_t, np.int64)
    return stats
