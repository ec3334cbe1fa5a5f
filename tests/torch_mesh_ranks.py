"""Rank bodies of the port's mesh tests (not a test module).

    python tests/torch_mesh_ranks.py SCENARIO OUT_DIR SPACE BATCH [ARG]

runs one rank of a (SPACE, BATCH) gloo mesh on the CPU (``run_ranks``
starts all of them through ``parallel.distributed.launch``, with a
``file://`` rendezvous and one torch thread a rank) and saves the
scenario's results to ``OUT_DIR/rank<r>.npz``.  The same scenario
functions with ``mesh=None`` give the single-device results the tests hold
the ranks to.  This module imports neither ``jax`` nor ``ndt_2d_tpu``, so
the ranks stay JAX-free; each rank records whether either was imported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

from ndt_2d_tpu_torch.config import (
    MapperConfig, ParticleFilterConfig, ScanMatcherConfig, SolverConfig)
from ndt_2d_tpu_torch.filter.particle_filter import ParticleFilter
from ndt_2d_tpu_torch.graph import pose_graph, solver
from ndt_2d_tpu_torch.mapping import laser, occupancy
from ndt_2d_tpu_torch.mapping.mapper import (
    DISABLE_MAPPING, ENABLE_MAPPING, LOAD_FROM_FILE, SAVE_TO_FILE, Mapper)
from ndt_2d_tpu_torch.matching import matcher
from ndt_2d_tpu_torch.parallel import distributed, loop_search
from ndt_2d_tpu_torch.parallel import mesh as mesh_mod
from ndt_2d_tpu_torch.parallel import solver as psolver
from ndt_2d_tpu_torch.utils import metrics, sim

RANGE_MAX = 12.0
P = 256
LOCAL = ScanMatcherConfig(grid_cells_x=96, grid_cells_y=96)
GLOBAL = ScanMatcherConfig(
    ndt_resolution=0.35, search_linear_size=0.15,
    search_linear_resolution=0.01, search_angular_size=0.05,
    grid_cells_x=96, grid_cells_y=96)
# A coarse lattice of 11 x 21 x 21 on 0.5 m cells: K6's path at a size the
# CPU twins take in well under a second a row.
COARSE = ScanMatcherConfig(
    ndt_resolution=0.5, search_linear_size=0.5, search_linear_resolution=0.05,
    search_angular_size=0.1, search_angular_resolution=0.02,
    grid_cells_x=96, grid_cells_y=96)


def box_scans(n=10, beams=240):
    """Points [n, P, 2], masks [n, P] and true poses [n, 3] of a drive down
    the middle of a 10 x 8 m box."""
    world = sim.make_box_world(10.0, 8.0)
    truth = np.stack([np.linspace(2.5, 7.0, n), np.full(n, 4.0),
                      np.linspace(0.0, 0.3, n)], axis=-1)
    pts, msk = [], []
    for t in range(n):
        msg = sim.scan_at_pose(world, truth[t], n_beams=beams,
                               range_max=RANGE_MAX, noise=0.01,
                               rng=np.random.default_rng(t))
        p, m = laser.project_scan(msg, RANGE_MAX, np.zeros(3), False,
                                  np.zeros(3), P)
        pts.append(p)
        msk.append(m)
    return np.asarray(pts), np.asarray(msk), truth


RING = 40


def ring_graph(n=RING, seed=3):
    """The noisy ring of tests/test_mesh_mapper.py:150-197: n poses on a
    circle of 4 m, odometry constraints from the truth and one closing
    loop constraint; returns (graph, truth)."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    truth = np.stack([4 * np.cos(th), 4 * np.sin(th), th + np.pi / 2], -1)
    g = pose_graph.Graph(max_points_per_scan=4)
    noisy = truth + rng.normal(0, [0.1, 0.1, 0.02], (n, 3))
    noisy[0] = truth[0]
    for p in noisy:
        g.add_scan(p, np.zeros((4, 2), np.float32), np.zeros(4, bool))

    def rel(pa, pb, wrap=0.0):
        c, s = np.cos(pa[2]), np.sin(pa[2])
        d = pb[:2] - pa[:2]
        return np.asarray([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                           pb[2] - pa[2] + wrap])

    info = np.diag([1e3, 1e3, 1e4])
    for i in range(n - 1):
        g.add_constraint(i, i + 1, rel(truth[i], truth[i + 1]), info, False)
    g.add_constraint(n - 1, 0, rel(truth[-1], truth[0], 2 * np.pi), info,
                     True)
    return g, truth


def ring_solve_inputs(bucket=64) -> dict:
    """The ring graph as ``graph.solver.solve``'s tensors, nodes and
    constraints padded to ``bucket`` as ``solve_graph`` pads them."""
    g, _ = ring_graph()

    def padded(x, dtype):
        out = np.zeros((bucket,) + x.shape[1:], dtype)
        out[:len(x)] = x
        return torch.from_numpy(out)

    return dict(poses=padded(g.poses, np.float32),
                begin=padded(g.constraint_begin, np.int32),
                end=padded(g.constraint_end, np.int32),
                transform=padded(g.constraint_transform, np.float32),
                information=padded(g.constraint_information, np.float32),
                constraint_mask=torch.arange(bucket) < g.num_constraints,
                node_mask=torch.arange(bucket) < g.num_scans,
                robust_mask=padded(g.constraint_switchable, bool))


def kernel_results(mesh=None) -> dict:
    """Every sharded device step once on small inputs: the rolling match
    (G = 1, and G = 4 with Newton), the global match, near and
    coarse-to-fine confirmation rows, the filter's measurement, the
    descriptor search, the occupancy counts and the ring graph's solve
    (twice).  Returns their results as numpy arrays."""
    dev = torch.device("cpu")
    pts, msk, truth = box_scans()
    t = lambda a, dt=None: torch.as_tensor(np.ascontiguousarray(a), dtype=dt)
    out = {}
    # Rolling match of scan 6 against the window of scans 0-5.
    win = matcher.make_window(6, P, dev)
    for i in range(6):
        matcher.window_append(win, t(truth[i], torch.float32),
                              t(pts[i]), t(msk[i]))
    start = t(truth[6] + [0.03, -0.02, 0.01], torch.float32)
    n6 = int(msk[6].sum())
    for name, cfg in (("rolling", LOCAL),
                      ("rolling_g4", dataclasses.replace(
                          LOCAL, overlapping_grids=True,
                          refine_iterations=3))):
        res = matcher.match_scan_rolling(cfg, win, RANGE_MAX, t(pts[6]),
                                         t(msk[6]), n6, start, mesh=mesh)
        out[name] = torch.cat([r.reshape(-1) for r in res]).numpy()
    # Global match (scan-match localization) on the window's grid.
    grid, table = matcher.build_window_ndt(GLOBAL, win.poses, win.points,
                                           win.point_mask, win.mask,
                                           RANGE_MAX)
    res = matcher.match_scan_with_score(GLOBAL, grid, t(pts[7]), t(msk[7]),
                                        int(msk[7].sum()),
                                        t(truth[7], torch.float32), table,
                                        mesh=mesh)
    out["global"] = torch.cat([r.reshape(-1) for r in res]).numpy()
    # Confirmation rows: 4 rows (one all-False padding row), each a 3-scan
    # region and its own query scan.
    S = 3
    rows = [(1, 7), (3, 8), (5, 9)]
    N = 4
    poses = np.zeros((N, S, 3), np.float32)
    wpts = np.zeros((N, S, P, 2), np.float32)
    wmsk = np.zeros((N, S, P), bool)
    wm = np.zeros((N, S), bool)
    qp = np.zeros((N, P, 2), np.float32)
    qm = np.zeros((N, P), bool)
    qn = np.zeros(N, np.int32)
    st = np.zeros((N, 3), np.float32)
    for j, (c, q) in enumerate(rows):
        poses[j] = truth[c - 1:c + 2]
        wpts[j], wmsk[j], wm[j] = pts[c - 1:c + 2], msk[c - 1:c + 2], True
        qp[j], qm[j], qn[j] = pts[q], msk[q], msk[q].sum()
        st[j] = truth[q] + [0.2 * (j - 1), -0.15, 0.04]
    args = [t(a) for a in (poses, wpts, wmsk, wm)]
    query = [t(a) for a in (qp, qm, qn, st)]
    near = matcher.match_scan_batch_multi(GLOBAL, *args, RANGE_MAX, *query,
                                          mesh=mesh)
    out["rows_near"] = torch.cat([near[0][:, None], near[1],
                                  near[2].reshape(N, 9)], 1).numpy()
    far = matcher.match_scan_batch_multi_coarse_fine(
        COARSE, GLOBAL, *args, RANGE_MAX, *query, mesh=mesh)
    out["rows_far"] = torch.cat([far[0], far[1][:, None], far[2],
                                 far[3].reshape(N, 9)], 1).numpy()
    # The filter's measurement: 101 particles (padding on every split).
    rng = np.random.default_rng(5)
    parts = truth[7] + rng.normal(0, [0.2, 0.2, 0.05], (101, 3))
    out["measure"] = matcher.score_points_batch(
        GLOBAL, grid, t(pts[7]), t(msk[7]), int(msk[7].sum()),
        t(parts, torch.float32), mesh=mesh).numpy()
    # The same through the filter's measure() (normalized weights).
    pf = ParticleFilter(ParticleFilterConfig(min_particles=50,
                                             max_particles=101), seed=3,
                        device="cpu")
    pf.init(*truth[7], 0.2, 0.2, 0.05)
    pf.measure(SimpleNamespace(config=GLOBAL, grid=grid), pts[7], msk[7],
               int(msk[7].sum()), mesh=mesh)
    out["pf_weights"] = pf.weights.numpy()
    # Descriptor search over 11 keyframes (padded to the shard count).
    table_d = loop_search.descriptors(t(np.concatenate([pts, pts[:1]])),
                                      t(np.concatenate([msk, msk[:1]])),
                                      RANGE_MAX)
    valid = torch.ones(11, dtype=torch.bool)
    if mesh is None:
        idx, sc = loop_search.search_all_pairs(table_d, valid, k=4,
                                               rolling_exclude=3)
    else:
        dp, vp = loop_search.pad_descriptors(
            table_d, valid, mesh_mod.axis_size(mesh, mesh_mod.BATCH_AXIS))
        idx, sc = loop_search.search_all_pairs_multichip(
            mesh, dp, vp, k=4, rolling_exclude=3)
    out["search_idx"], out["search_scores"] = idx[:11].numpy(), sc[:11].numpy()
    # Occupancy counts of the ten scans.
    occ = occupancy.render_occupancy(truth, pts, msk, 0.1, 0.25, mesh=mesh)
    out["occupancy"] = occ.data
    # The ring graph's solve, twice, as the mapper solves it (dense at this
    # size), and once by JAX's always-PCG solve_multichip.
    cfg = SolverConfig(max_iterations=50)
    for k in range(2):
        g, _ = ring_graph()
        out[f"solve_ok{k}"] = np.asarray(solver.solve_graph(g, cfg,
                                                            mesh=mesh))
        out[f"solve{k}"] = g.poses.copy()
    args = ring_solve_inputs()
    res = (solver.solve(cfg, use_dense=False, **args) if mesh is None
           else psolver.solve_multichip(cfg, mesh, **args))
    out["pcg_ok"] = np.asarray(bool(res.success))
    out["pcg"] = res.poses[:RING].numpy().astype(np.float64)
    return out


def _mapper_config(loop_search="radius"):
    """The office-loop configuration of tests/test_mesh_mapper.py:30-50
    (with tests/test_mapper_e2e.py's 160-cell matchers)."""
    m = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
    g = ScanMatcherConfig(
        ndt_resolution=0.35, search_linear_size=0.15,
        search_linear_resolution=0.01, search_angular_size=0.05,
        grid_cells_x=160, grid_cells_y=160)
    return MapperConfig(
        local_scan_matcher=m, global_scan_matcher=g, max_points_per_scan=512,
        loop_closure_every=15, global_search_size=4.0,
        optimization_node_limit=10, loop_search=loop_search,
        loop_closure_gate_scale=0.85, loop_closure_region_size=3,
        solver=dataclasses.replace(SolverConfig(),
                                   robust_loss="geman_mcclure"))


def office_inputs(trans_noise=0.012, rot_noise=0.003):
    """The office ring of tests/test_mapper_e2e.py::_office_loop_inputs."""
    world = sim.make_office_world(16.0)
    waypoints = [(2.0, 2.0, 0.0), (14.0, 2.0, np.pi / 2),
                 (14.0, 14.0, np.pi), (2.0, 14.0, -np.pi / 2),
                 (2.0, 2.6, 0.0), (8.0, 2.6, 0.0)]
    traj = []
    for a, b in zip(waypoints[:-1], waypoints[1:]):
        a, b = np.asarray(a, float), np.asarray(b, float)
        steps = max(int(np.hypot(*(b[:2] - a[:2])) / 0.35), 1)
        heading = np.arctan2(b[1] - a[1], b[0] - a[0])
        for s in range(steps):
            f = s / steps
            traj.append([a[0] + f * (b[0] - a[0]), a[1] + f * (b[1] - a[1]),
                         heading])
    truth = np.asarray(traj)
    odom = sim.drift_odometry(truth, trans_noise=trans_noise,
                              rot_noise=rot_noise, seed=11)
    return world, truth, odom


def office_session(loop_search="radius", mesh=None) -> dict:
    """test_office_loop_matches_single_device's drive
    (tests/test_mesh_mapper.py:70-89) through the port's Mapper."""
    world, truth, odom = office_inputs()
    mapper = Mapper(_mapper_config(loop_search), device="cpu", mesh=mesh)
    used = []
    for t in range(len(truth)):
        msg = sim.scan_at_pose(world, truth[t], n_beams=600,
                               range_max=RANGE_MAX, noise=0.01,
                               rng=np.random.default_rng(t))
        if mapper.process_scan(msg, odom[t]).accepted:
            used.append(truth[t])
    mapper.loop_closure()
    used = np.asarray(used)
    g = mapper.graph
    return {"poses": g.poses.copy(), "num_scans": np.asarray(g.num_scans),
            "closures": np.asarray(int(g.constraint_switchable.sum())),
            "optimizations": np.asarray(mapper.stats.optimizations),
            "ate": np.asarray(metrics.ate_rmse(g.poses[:len(used)], used)),
            "decisions": np.asarray([d[4] for d in
                                     mapper.lc_log["decisions"]], bool)}


def box_drive(n=16):
    world = sim.make_box_world(10.0, 8.0)
    truth = np.stack([np.linspace(2.5, 7.0, n), np.full(n, 4.0),
                      np.zeros(n)], axis=-1)
    return world, truth


def pipelined_session(mesh=None) -> dict:
    """test_mesh_pipelining_matches_mesh_sync's drive
    (tests/test_mesh_mapper.py:99-125), 16 box scans mapped synchronously
    and at max_inflight 4, and the occupancy grid of the synchronous map
    (the bit-identical occupancy test, :127-146)."""
    world, truth = box_drive()
    odom = sim.drift_odometry(truth, 0.008, 0.002, seed=5)
    m = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
    out = {}
    for inflight in (0, 4):
        cfg = MapperConfig(local_scan_matcher=m, global_scan_matcher=m,
                           max_points_per_scan=512,
                           loop_closure_every=10 ** 9, max_inflight=inflight)
        mapper = Mapper(cfg, device="cpu", mesh=mesh)
        for t in range(len(truth)):
            msg = sim.scan_at_pose(world, truth[t], n_beams=240,
                                   range_max=RANGE_MAX, noise=0.01,
                                   rng=np.random.default_rng(t))
            mapper.process_scan(msg, odom[t])
        mapper.flush()
        out[f"poses{inflight}"] = mapper.graph.poses[
            :mapper.graph.num_scans].copy()
        if not inflight:
            grid = mapper.render_map()
            out["grid"], out["grid_origin"] = grid.data, grid.origin
    return out


def localize_session(kind="pf", mesh=None, map_path=None) -> dict:
    """tests/test_mesh_mapper.py:199-270: map 12 box scans, save the map
    (rank 0), then localize 11 more with the particle filter (``kind`` pf)
    or by scan matching against it.  Returns the position errors."""
    world = sim.make_box_world(10.0, 8.0)
    truth = np.stack([np.linspace(3.0, 7.0, 12), np.full(12, 4.0),
                      np.zeros(12)], axis=-1)
    m = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
    cfg = MapperConfig(local_scan_matcher=m, global_scan_matcher=m,
                       max_points_per_scan=512, loop_closure_every=10 ** 9)
    mapper = Mapper(cfg, device="cpu")
    for t in range(len(truth)):
        msg = sim.scan_at_pose(world, truth[t], n_beams=240, range_max=14.0,
                               noise=0.01, rng=np.random.default_rng(t))
        mapper.process_scan(msg, truth[t])
    if distributed.rank() == 0:
        mapper.configure(SAVE_TO_FILE, map_path)
    distributed.barrier()
    if kind == "pf":
        lcfg = dataclasses.replace(
            cfg, use_particle_filter=True,
            particle_filter=ParticleFilterConfig(
                min_particles=100, max_particles=500, odom_alpha1=0.05,
                odom_alpha2=0.05, odom_alpha3=0.05, odom_alpha4=0.05))
        sigma = np.diag([0.04, 0.04, 0.01])
    else:
        lcfg = dataclasses.replace(cfg, enable_mapping=False)
        sigma = np.diag([0.05, 0.05, 0.02])
    loc = Mapper(lcfg, device="cpu", mesh=mesh, seed=3)
    loc.configure(LOAD_FROM_FILE, map_path)
    rel = metrics.relative_to_first(truth)
    loc.set_initial_pose(rel[0], sigma, truth[0])
    odom = sim.drift_odometry(truth, 0.01, 0.003, seed=9)
    errs, poses = [], []
    for t in range(1, len(truth)):
        msg = sim.scan_at_pose(world, truth[t], n_beams=240, range_max=14.0,
                               noise=0.01, rng=np.random.default_rng(100 + t))
        res = loc.process_scan(msg, odom[t])
        if res.accepted:
            errs.append(np.hypot(*(res.pose[:2] - rel[t][:2])))
            poses.append(res.pose)
    return {"errors": np.asarray(errs), "poses": np.asarray(poses)}


BOX_CONFIG = MapperConfig(
    local_scan_matcher=ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160),
    global_scan_matcher=ScanMatcherConfig(
        ndt_resolution=0.35, search_linear_size=0.15,
        search_linear_resolution=0.01, search_angular_size=0.05,
        grid_cells_x=160, grid_cells_y=160),
    max_points_per_scan=256, global_search_size=4.0,
    loop_closure_region_size=3, optimization_node_limit=10,
    solver=SolverConfig(robust_loss="huber"))


def box_session(mesh=None) -> dict:
    """The 30-scan revisiting box bag (600 beams, seed 0) mapped with loop
    closure every 5 scans and optimization (BOX_CONFIG): the accepted
    count and every confirmation decision (query, candidate, accepted)."""
    from ndt_2d_tpu_torch.io.bag import record_synthetic
    from ndt_2d_tpu_torch.mapping import runtime as rt
    mapper = Mapper(BOX_CONFIG, device="cpu", mesh=mesh)
    stats = rt.run_bag(mapper, record_synthetic("box", 30, n_beams=600,
                                                seed=0))
    return {"accepted": np.asarray(stats["scans_accepted"]),
            "closures": np.asarray(stats["loop_closures"]),
            "decisions": np.asarray([(d[0], d[1], d[4]) for d in
                                     mapper.lc_log["decisions"]], np.int64),
            "poses": mapper.graph.poses.copy()}


CONTROL_SCANS = 18
# The control channel's actions after scan t (applied at the boundary
# before scan t + 1): a save with a filename too long for a mesh's
# request (refused at rank 0), a request of no action, mapping off and on,
# a save, a load of the saved map and a load of a file that does not exist
# (fails on every rank).
CONTROL_ACTIONS = {1: (SAVE_TO_FILE, "m" * 1100 + ".npz"), 2: (0, ""),
                   3: (DISABLE_MAPPING, ""), 6: (ENABLE_MAPPING, ""),
                   9: (SAVE_TO_FILE, "map.npz"),
                   12: (LOAD_FROM_FILE, "map.npz"),
                   14: (LOAD_FROM_FILE, "missing.npz")}


def control_session(mesh=None, out_dir=".", mode="socket") -> dict:
    """An 18-scan box bag through ``run_bag`` with CONTROL_ACTIONS (and
    the pose set again on every rank after scan 6, which mapping off
    forgot): sent
    over the control channel from rank 0's progress callback (``mode``
    "socket"; each request queued before the callback returns, the reply
    awaited by a client thread), or applied by every rank's callback
    straight through ``Mapper.configure`` at the same boundaries ("direct";
    a save by rank 0 alone).  Returns the graph, its scan count after
    every scan, the replies (rank 0, socket) and the files this rank
    wrote (``local_saves``)."""
    import threading

    from ndt_2d_tpu_torch.io import serialization
    from ndt_2d_tpu_torch.io.bag import record_synthetic
    from ndt_2d_tpu_torch.mapping import runtime as rt
    os.chdir(out_dir)  # a socket's path is limited to 108 bytes
    saves = []
    real_save = serialization.save_graph

    def save_graph(graph, path):
        saves.append(path)
        real_save(graph, path)
    serialization.save_graph = save_graph
    m = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
    cfg = MapperConfig(local_scan_matcher=m, global_scan_matcher=m,
                       max_points_per_scan=512, loop_closure_every=10 ** 9)
    mapper = Mapper(cfg, device="cpu", mesh=mesh)
    bag = record_synthetic("box", CONTROL_SCANS, n_beams=180, seed=0)
    rank = distributed.rank()
    control = (rt.ControlServer(mapper, "ctl.sock", mesh=mesh)
               if mode == "socket" else None)
    counts, replies, clients = [], {}, []

    def send(t, action, filename):
        try:
            replies[t] = rt.send_configure("ctl.sock", action, filename)
        except Exception as e:  # a reply that never came
            replies[t] = {"ok": False, "error": repr(e)}

    rel = metrics.relative_to_first(bag.truth)

    def progress(t, res):
        counts.append(mapper.graph.num_scans)
        if t == 6:  # mapping off forgot the pose: every rank sets it again
            mapper.set_initial_pose(rel[t], np.diag([0.04, 0.04, 0.01]),
                                    bag.odom[t])
        if t not in CONTROL_ACTIONS:
            return
        action, filename = CONTROL_ACTIONS[t]
        if mode == "direct":
            if len(filename) > rt.FILENAME_ROOM:
                return
            try:
                mapper.configure(action if rank == 0
                                 else action & ~SAVE_TO_FILE, filename)
            except FileNotFoundError:
                pass
        elif rank == 0:
            queued = control.pending()
            c = threading.Thread(target=send, args=(t, action, filename))
            c.start()
            clients.append(c)
            # A refused request is answered at once and never queued.
            while (control.pending() == queued
                   and len(filename) <= rt.FILENAME_ROOM):
                c.join(0.001)
    try:
        stats = rt.run_bag(mapper, bag, progress=progress, control=control)
    finally:
        for c in clients:
            c.join()
        if control is not None:
            control.close()
        serialization.save_graph = real_save
    g = mapper.graph
    out = {"poses": g.poses[:g.num_scans].copy(),
           "counts": np.asarray(counts), "accepted":
           np.asarray(stats["scans_accepted"]),
           "enable_mapping": np.asarray(mapper.enable_mapping),
           "local_saves": np.asarray(saves)}
    if mode == "socket":
        # Where the boundary's request lives and which backend carries it.
        out["request_on"] = np.asarray(
            [control._request.device.type,
             torch.distributed.get_backend(control._group)])
    if mode == "socket" and rank == 0:
        out["local_replies"] = np.asarray(
            [json.dumps(replies[t]) for t in sorted(replies)])
    return out


SCENARIOS = {"kernels": kernel_results, "office": office_session,
             "pipelined": pipelined_session, "localize": localize_session,
             "box": box_session, "control": control_session}


def run_ranks(scenario: str, out_dir: str, space: int, batch: int,
              arg=None, timeout: float = 600.0,
              script: str = __file__) -> list:
    """Run ``scenario`` on a (space, batch) gloo mesh of local ranks (the
    rank bodies of ``script``, this module by default); returns each rank's
    results (a dict of arrays), in rank order."""
    cmd = [sys.executable, os.path.abspath(script), scenario, out_dir,
           str(space), str(batch)] + ([] if arg is None else [str(arg)])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    distributed.launch(cmd, space * batch, env=env, timeout=timeout)
    out = []
    for r in range(space * batch):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def main(argv, scenarios=SCENARIOS) -> int:
    scenario, out_dir, space, batch = argv[:4]
    torch.set_num_threads(1)
    distributed.initialize("cpu")
    mesh = mesh_mod.make_mesh(shape=(int(space), int(batch)))
    kwargs = {"mesh": mesh}
    if scenario == "localize":
        kwargs.update(kind=argv[4], map_path=os.path.join(out_dir, "map.npz"))
    elif scenario == "control":
        kwargs.update(out_dir=out_dir, mode=argv[4])
    elif len(argv) > 4:
        kwargs["loop_search"] = argv[4]
    res = scenarios[scenario](**kwargs)
    for name, value in res.items():
        if not name.startswith("local_"):  # a rank's own shard
            distributed.assert_replicated(value, name)
    res["imported_reference"] = np.asarray(any(
        m == "jax" or m.startswith("jax.") or m == "ndt_2d_tpu"
        or m.startswith("ndt_2d_tpu.") for m in sys.modules))
    np.savez(os.path.join(out_dir, f"rank{distributed.rank()}.npz"), **res)
    distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
