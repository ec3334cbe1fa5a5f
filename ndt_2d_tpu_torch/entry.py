"""Entry points of the port: the flagship forward step and the multi-device
dry run.

Port of the JAX package's driver entry points (``__graft_entry__.py``):

* ``entry()`` returns ``(fn, args)``: the rolling-window NDT build (K1) and
  the exhaustive 32k-candidate scan match (K2), the reference's hot loop
  (src/scan_matcher_ndt.cpp:49-149), with example inputs on the device;
* ``dryrun_multichip(n_devices)`` runs every part of the multi-device
  pipeline once on an initialized process group
  (``parallel/distributed.py::initialize``), at the JAX dry run's shapes:
  a small SLAM session through ``Mapper(mesh=...)`` (sharded match,
  loop-closure confirmation, solve and export), the fused SLAM step
  (``parallel/slam_step.py``), the stripe-sharded map
  (``parallel/ndt_blocks.py``), the sharded descriptor search and the
  particle-sharded measurement.  Every rank calls it.

    python -m ndt_2d_tpu_torch.entry --ranks 4 --device cpu
    torchrun --nproc-per-node 4 -m ndt_2d_tpu_torch.entry --distributed

The first starts 4 local ranks itself (gloo on the CPU); the second runs
one rank a process under ``torchrun`` (NCCL on one GPU a rank).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ndt_2d_tpu_torch.config import MapperConfig, ScanMatcherConfig
from ndt_2d_tpu_torch.device import get_device
from ndt_2d_tpu_torch.matching import matcher
from ndt_2d_tpu_torch.utils import sim

RANGE_MAX = 15.0


def entry(device=None):
    """(fn, example_args): ``fn(*args)`` builds the window NDT of three box
    scans and matches a fourth against it, returning the MatchResult."""
    dev = get_device(device)
    config = ScanMatcherConfig(grid_cells_x=128, grid_cells_y=128)

    def forward(poses, window_points, window_mask_pts, window_mask,
                scan_points, scan_mask, num_points, pose):
        grid, table = matcher.build_window_ndt(
            config, poses, window_points, window_mask_pts, window_mask,
            RANGE_MAX)
        return matcher.match_scan(config, grid, scan_points, scan_mask,
                                  num_points, pose, packed_table=table)

    world = sim.make_box_world(10.0, 8.0)
    poses = np.asarray([[4.8, 3.9, 0.0], [5.0, 4.0, 0.05],
                        [5.2, 4.1, -0.05]], np.float32)
    pts, msk = [], []
    for p in poses:
        msg = sim.scan_at_pose(world, p, n_beams=360, range_max=RANGE_MAX)
        a, b = sim.project_scan(msg, 512)
        pts.append(a)
        msk.append(b)
    msg = sim.scan_at_pose(world, np.asarray([5.0, 4.0, 0.0]), n_beams=360,
                           range_max=RANGE_MAX)
    qpts, qmask = sim.project_scan(msg, 512)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)
    example_args = (t(poses, torch.float32), t(np.stack(pts), torch.float32),
                    t(np.stack(msk), torch.bool),
                    torch.ones(3, dtype=torch.bool, device=dev),
                    t(qpts, torch.float32), t(qmask, torch.bool),
                    int(qmask.sum()),
                    t([5.02, 3.98, 0.01], torch.float32))
    return forward, example_args


def _square_loop():
    """The dry run's small square loop that revisits its start."""
    waypoints = [(1.5, 1.5, 0.0), (6.5, 1.5, 0.0), (6.5, 4.5, 0.0),
                 (1.5, 4.5, 0.0), (1.5, 1.8, 0.0), (4.0, 1.8, 0.0)]
    traj = []
    for a, b in zip(waypoints[:-1], waypoints[1:]):
        a, b = np.asarray(a, float), np.asarray(b, float)
        steps = max(int(np.hypot(*(b - a)[:2]) / 0.5), 1)
        for s in range(steps):
            traj.append(a + (b - a) * (s / steps))
    return np.asarray(traj)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the whole multi-device pipeline once on an ``n_devices`` mesh of
    the process group (every rank calls it, with its own ``device``: the
    rank's GPU unless ``cpu`` is asked for).  Raises AssertionError where
    the JAX dry run asserts; returns a few of the results (the same on
    every rank) for a caller to compare."""
    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    from ndt_2d_tpu_torch.parallel import filter as pfilter
    from ndt_2d_tpu_torch.parallel import loop_search, ndt_blocks, slam_step
    from ndt_2d_tpu_torch.parallel import mesh as mesh_mod
    dev = get_device(device)
    mesh = mesh_mod.make_mesh(n_devices)
    out = {}

    # --- 0. The product path: a small SLAM session through Mapper(mesh). ---
    mcfg = ScanMatcherConfig(grid_cells_x=96, grid_cells_y=96)
    gcfg = ScanMatcherConfig(ndt_resolution=0.35, search_linear_size=0.15,
                             search_linear_resolution=0.01,
                             search_angular_size=0.05,
                             grid_cells_x=96, grid_cells_y=96)
    cfg = MapperConfig(local_scan_matcher=mcfg, global_scan_matcher=gcfg,
                       max_points_per_scan=128, global_search_size=4.0,
                       optimization_node_limit=2, loop_closure_every=8,
                       minimum_travel_distance=0.3)
    mapper = Mapper(cfg, mesh=mesh, device=dev)
    world = sim.make_box_world(8.0, 6.0)
    traj = _square_loop()
    for t, pose in enumerate(traj):
        msg = sim.scan_at_pose(world, pose, n_beams=240, range_max=6.0,
                               noise=0.01, rng=np.random.default_rng(t))
        mapper.process_scan(msg, pose)
    mapper.loop_closure()
    assert mapper.graph.num_scans >= len(traj) - 2
    assert mapper.graph.num_constraints >= mapper.graph.num_scans - 1
    # The revisit makes loop-closure candidates reach the sharded
    # confirmation (accepted or rejected, both exercise it).
    assert (mapper.stats.loop_closures_accepted
            + mapper.stats.loop_closures_rejected) >= 1
    assert mapper.optimize()  # constraint-sharded solve
    grid = mapper.render_map()  # rays sharded over the whole mesh
    assert (grid.data == 100).sum() > 10
    out["mapper_poses"] = mapper.graph.poses[:mapper.graph.num_scans].copy()

    # --- 1. The fused SLAM step. ---
    cfg = MapperConfig(
        local_scan_matcher=ScanMatcherConfig(grid_cells_x=64, grid_cells_y=64),
        max_points_per_scan=128)
    step = slam_step.make_slam_step(mesh, cfg, range_max=6.0,
                                    optimize_every=2)
    state = slam_step.init_state(max_scans=8, max_points=128,
                                 max_constraints=8, device=dev)
    pose = np.asarray([4.0, 3.0, 0.0])
    for t in range(2):
        msg = sim.scan_at_pose(world, pose, n_beams=90, range_max=6.0)
        pts, msk = sim.project_scan(msg, 128)
        delta = (np.asarray([0.15, 0.0, 0.0], np.float32)
                 if t else np.zeros(3, np.float32))
        state, _ = step(state, torch.as_tensor(pts, device=dev),
                        torch.as_tensor(msk, device=dev),
                        torch.as_tensor(delta, device=dev))
        pose = pose + np.asarray([0.15, 0.0, 0.0])
    assert state.num_scans == 2
    out["slam_poses"] = state.poses[:2].cpu().numpy()
    assert np.isfinite(out["slam_poses"]).all()

    # --- 2. The stripe-sharded map: y-stripe build + one combined score. ---
    space = mesh_mod.axis_size(mesh, mesh_mod.SPACE_AXIS)
    bcfg = ScanMatcherConfig(grid_cells_x=32, grid_cells_y=space * 8)
    bposes = torch.zeros(2, 3, dtype=torch.float32, device=dev)
    bpts = torch.as_tensor(np.random.default_rng(1).uniform(
        0.5, 3.0, (2, 64, 2)).astype(np.float32), device=dev)
    bmask = torch.ones(2, 64, dtype=torch.bool, device=dev)
    borigin = torch.zeros(2, dtype=torch.float32, device=dev)
    sg = ndt_blocks.build_ndt_sharded(
        mesh, bposes, bpts, bmask, torch.ones(2, dtype=torch.bool,
                                              device=dev),
        borigin, bcfg.ndt_resolution, bcfg.grid_cells_x, bcfg.grid_cells_y)
    tot = ndt_blocks.score_points_sharded(mesh, sg, bpts[0], bmask[0])
    out["blocks_score"] = tot.cpu().numpy()
    assert np.isfinite(out["blocks_score"])

    # --- 3. The sharded all-pairs descriptor search. ---
    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.normal(0.0, 3.0, (16, 64, 2)).astype(
        np.float32), device=dev)
    msk = torch.ones(16, 64, dtype=torch.bool, device=dev)
    desc = loop_search.descriptors(pts, msk, 6.0)
    dp, vp = loop_search.pad_descriptors(
        desc, torch.ones(16, dtype=torch.bool, device=dev),
        mesh_mod.axis_size(mesh, mesh_mod.BATCH_AXIS))
    idx, _ = loop_search.search_all_pairs_multichip(
        mesh, dp, vp, k=4, rolling_exclude=2)
    assert idx.shape[0] == dp.shape[0]
    out["search_idx"] = idx.cpu().numpy()

    # --- 4. The particle-sharded measurement against a replicated grid. ---
    pcfg = ScanMatcherConfig(grid_cells_x=32, grid_cells_y=32)
    gmsg = sim.scan_at_pose(world, np.asarray([2.0, 2.0, 0.0]), n_beams=90,
                            range_max=6.0)
    gpts, gmsk = sim.project_scan(gmsg, 128)
    gp = torch.as_tensor(gpts, device=dev)
    gm = torch.as_tensor(gmsk, device=dev)
    pgrid, _ = matcher.build_window_ndt(
        pcfg, torch.tensor([[2.0, 2.0, 0.0]], dtype=torch.float32,
                           device=dev), gp[None], gm[None],
        torch.ones(1, dtype=torch.bool, device=dev), 3.0)
    n_particles = mesh_mod.axis_size(mesh, mesh_mod.BATCH_AXIS) * 8
    particles = torch.as_tensor(np.random.default_rng(2).normal(
        [2.0, 2.0, 0.0], 0.1, (n_particles, 3)).astype(np.float32),
        device=dev)
    weights = pfilter.measure_multichip(pcfg, mesh, pgrid, gp, gm,
                                        int(gmsk.sum()), particles)
    assert weights.shape == (n_particles,)
    out["weights"] = weights.cpu().numpy()
    return out


def main(argv=None) -> int:
    from ndt_2d_tpu_torch.parallel import distributed
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=0,
                    help="start this many local ranks and run the dry run "
                         "on them")
    ap.add_argument("--distributed", action="store_true",
                    help="run as one rank of a process group started by "
                         "torchrun (or by --ranks)")
    ap.add_argument("--device", default=None,
                    help="cpu, or the rank's CUDA device (default)")
    args = ap.parse_args(argv)
    if args.ranks:
        cmd = [sys.executable, "-m", "ndt_2d_tpu_torch.entry",
               "--distributed"]
        if args.device:
            cmd += ["--device", args.device]
        distributed.launch(cmd, args.ranks)
        return 0
    if not args.distributed:
        ap.error("pass --ranks N or --distributed")
    dev = distributed.initialize(args.device)
    try:
        dryrun_multichip(torch.distributed.get_world_size(), dev)
        distributed.barrier()
        if distributed.rank() == 0:
            print(f"dryrun_multichip: {torch.distributed.get_world_size()} "
                  f"ranks on {dev.type} passed")
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
