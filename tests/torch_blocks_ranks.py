"""Rank bodies of the port's stripe-sharded map, fused SLAM step and dry-run
tests (not a test module).

    python tests/torch_blocks_ranks.py SCENARIO OUT_DIR SPACE BATCH

runs one rank of a (SPACE, BATCH) gloo mesh on the CPU through
``tests/torch_mesh_ranks.py``'s runner (``run_ranks`` starts all of them)
and saves the scenario's results to ``OUT_DIR/rank<r>.npz``; every value
must be bitwise the same on every rank.  The inputs are those of
tests/test_ndt_blocks.py (a 4-scan box window, 128x128 cells) and
tests/test_sharding.py:199-225 (a 6-step box drive, 64x64 cells), made
from their seeds with the port's copy of ``utils/sim``.  This module
imports neither ``jax`` nor ``ndt_2d_tpu``.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

import torch_mesh_ranks as ranks
from ndt_2d_tpu_torch.config import MapperConfig, ScanMatcherConfig
from ndt_2d_tpu_torch.kernels import ndt_build as k1
from ndt_2d_tpu_torch.parallel import ndt_blocks, slam_step
from ndt_2d_tpu_torch.utils import sim

CFG = ScanMatcherConfig(grid_cells_x=128, grid_cells_y=128)
RANGE_MAX = 15.0
PARTICLES = 16
SLAM_CFG = MapperConfig(
    local_scan_matcher=ScanMatcherConfig(grid_cells_x=64, grid_cells_y=64),
    max_points_per_scan=128)
SLAM_STEPS = 6


def t(a, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def blocks_inputs() -> dict:
    """tests/test_ndt_blocks.py's window (_window), its origin, and the
    query scans, pose and particles of its three tests, as numpy."""
    world = sim.make_box_world(10.0, 8.0)
    poses = np.asarray([[4.6 + 0.2 * i, 3.8 + 0.1 * i, 0.05 * i]
                        for i in range(4)], np.float32)
    pts, msk = [], []
    rng = np.random.default_rng(0)
    for p in poses:
        msg = sim.scan_at_pose(world, p, n_beams=360, range_max=RANGE_MAX,
                               noise=0.01, rng=rng)
        a, b = sim.project_scan(msg, 512)
        pts.append(a)
        msk.append(b)
    out = dict(poses=poses, points=np.stack(pts), pmask=np.stack(msk),
               wmask=np.ones(4, bool))
    out["origin"] = k1.window_origin(t(poses), t(out["wmask"]),
                                     RANGE_MAX).numpy()
    # test_score_matches_dense: world points of a scan at (5, 4, 0).
    msg = sim.scan_at_pose(world, [5.0, 4.0, 0.0], n_beams=240,
                           range_max=RANGE_MAX)
    qp, qm = sim.project_scan(msg, 512)
    out.update(score_points=np.asarray(qp) + np.asarray([5.0, 4.0],
                                                        np.float32),
               score_mask=qm, pf_points=qp, pf_mask=qm)
    rng = np.random.default_rng(3)
    out["particles"] = (np.asarray([5.0, 4.0, 0.0]) + rng.normal(
        0, [0.3, 0.3, 0.05], (PARTICLES, 3))).astype(np.float32)
    # test_match_matches_dense.
    msg = sim.scan_at_pose(world, [5.0, 4.0, 0.02], n_beams=360,
                           range_max=RANGE_MAX)
    out["match_points"], out["match_mask"] = sim.project_scan(msg, 512)
    out["match_pose"] = np.asarray([5.03, 3.99, 0.0], np.float32)
    return out


def blocks_results(mesh) -> dict:
    """The four sharded entries once on ``blocks_inputs``: this rank's
    stripe, the whole grid gathered, the score, the particle weights and
    the match."""
    x = blocks_inputs()
    W, H = CFG.grid_cells_x, CFG.grid_cells_y
    g = ndt_blocks.build_ndt_sharded(
        mesh, t(x["poses"]), t(x["points"]), t(x["pmask"]), t(x["wmask"]),
        t(x["origin"]), CFG.ndt_resolution, W, H)
    full = ndt_blocks.gather_grid(mesh, g)
    out = {f"local_stripe_{f}": getattr(g, f).numpy()
           for f in ("mean", "information", "count", "covariance", "table")}
    out["local_row0"] = np.asarray(g.row0)
    out.update({f"grid_{f}": getattr(full, f).numpy()
                for f in ("mean", "information", "count", "covariance")})
    out["score"] = ndt_blocks.score_points_sharded(
        mesh, g, t(x["score_points"]), t(x["score_mask"])).numpy()
    out["weights"] = ndt_blocks.score_particles_sharded_map(
        CFG, mesh, g, t(x["pf_points"]), t(x["pf_mask"]),
        int(x["pf_mask"].sum()), t(x["particles"])).numpy()
    res = ndt_blocks.match_scan_sharded_map(
        CFG, mesh, g, t(x["match_points"]), t(x["match_mask"]),
        int(x["match_mask"].sum()), t(x["match_pose"]))
    out["match"] = torch.cat([res.score.reshape(1), res.correction,
                              res.covariance.reshape(9)]).numpy()
    try:
        ndt_blocks.build_ndt_sharded(
            mesh, t(x["poses"]), t(x["points"]), t(x["pmask"]),
            t(x["wmask"]), t(x["origin"]), CFG.ndt_resolution, W, H + 1)
        out["odd_height_raised"] = np.asarray(
            ndt_blocks.axis_size(mesh, "space") == 1)
    except ValueError:
        out["odd_height_raised"] = np.asarray(True)
    return out


def slam_drive(mesh=None, tensors: bool = False) -> dict:
    """tests/test_sharding.py:199-225's drive through the port's fused
    step: 6 box scans 0.15 m apart, 64x64 cells, optimize every 4 scans,
    capacity 16 scans / 16 constraints.  ``tensors`` hands each scan over
    as tensors without its point count, as JAX's dry run does.  Returns
    every step's match and the final state."""
    step = slam_step.make_slam_step(mesh, SLAM_CFG, range_max=6.0,
                                    optimize_every=4)
    state = slam_step.init_state(max_scans=16, max_points=128,
                                 max_constraints=16, device="cpu")
    world = sim.make_box_world(8.0, 6.0)
    pose = np.asarray([4.0, 3.0, 0.0])
    matches = []
    for k in range(SLAM_STEPS):
        msg = sim.scan_at_pose(world, pose, n_beams=120, range_max=6.0)
        pts, msk = sim.project_scan(msg, 128)
        delta = (np.asarray([0.15, 0.0, 0.0], np.float32) if k
                 else np.zeros(3, np.float32))
        if tensors:
            state, res = step(state, t(pts), t(msk), t(delta))
        else:
            state, res = step(state, pts, msk, delta)
        matches.append(torch.cat([res.score.reshape(1), res.correction,
                                  res.covariance.reshape(9)]).numpy())
        pose = pose + np.asarray([0.15, 0.0, 0.0])
    return {"matches": np.stack(matches), "poses": state.poses.numpy(),
            "num_scans": np.asarray(state.num_scans),
            "c_num": np.asarray(state.c_num),
            "c_begin": state.c_begin.numpy(), "c_end": state.c_end.numpy(),
            "c_transform": state.c_transform.numpy(),
            "c_information": state.c_information.numpy(),
            "prev_pose": state.prev_pose.numpy()}


def dryrun(mesh) -> dict:
    """The port's ``dryrun_multichip`` on the whole world."""
    from ndt_2d_tpu_torch.entry import dryrun_multichip
    return dryrun_multichip(mesh.size(), "cpu")


SCENARIOS = {"blocks": blocks_results, "slam": slam_drive,
             "dryrun": dryrun}
run_ranks = functools.partial(ranks.run_ranks, script=__file__)


if __name__ == "__main__":
    sys.exit(ranks.main(sys.argv[1:], SCENARIOS))
