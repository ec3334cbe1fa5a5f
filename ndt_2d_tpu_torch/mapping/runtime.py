"""Bag replay loop around the port's ``Mapper``.

Port of ``ndt_2d_tpu/mapping/runtime.py::run_bag`` (with the pipelined
paths' deferred poses) and ``sweep_end_odom``, without the UNIX-socket
control channel, and ``write_outputs``: under a device mesh every rank
replays the bag and holds the same results, and only rank 0 writes them.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

import json

from ndt_2d_tpu_torch.io import serialization
from ndt_2d_tpu_torch.io.bag import ScanBag
from ndt_2d_tpu_torch.mapping.mapper import SAVE_TO_FILE, Mapper
from ndt_2d_tpu_torch.parallel import distributed
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
    ATE against ground truth when the bag carries it.  The pipelined paths
    defer their poses: they are read after the final flush, when their
    copies to the host have long completed."""
    est, used_truth, accepted, est_t, deferred = [], [], 0, [], []
    for t, (msg, odom_pose) in enumerate(bag):
        res = mapper.process_scan(msg, odom_pose, sweep_end_odom(bag, t, msg))
        if res.accepted:
            accepted += 1
            if res.pose is not None:
                est.append(res.pose)
                est_t.append(t)
                if bag.truth is not None:
                    used_truth.append(bag.truth[t])
            elif res.pose_future is not None:
                deferred.append((res.pose_future, t))
        if progress:
            progress(t, res)
    mapper.flush()
    mapper.loop_closure()
    for fut, t in deferred:
        est.append(fut.result())
        est_t.append(t)
        if bag.truth is not None:
            used_truth.append(bag.truth[t])

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


def write_outputs(mapper: Mapper, stats: dict, traj_out=None, map_out=None,
                  grid_out=None) -> dict:
    """Write a session's trajectory (TUM), map and occupancy grid and print
    its stats line; returns the stats without their private keys.  The grid
    is rendered on every rank (with a mesh, a collective); only rank 0
    writes files and prints."""
    writer = distributed.rank() == 0
    est = stats.pop("_est")
    est_t = stats.pop("_est_t")
    if traj_out:
        if writer:
            serialization.save_tum(traj_out, est_t, est)
        stats["traj_out"] = traj_out
    if map_out:
        if writer:
            mapper.configure(SAVE_TO_FILE, map_out)
        stats["map_out"] = map_out
    if grid_out:
        grid = mapper.render_map()
        if writer:
            np.savez_compressed(grid_out, data=grid.data, origin=grid.origin,
                                resolution=grid.resolution)
        stats["grid_out"] = grid_out
    if writer:
        print(json.dumps(stats))
    return stats
