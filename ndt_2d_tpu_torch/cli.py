"""Command-line interface of the port: every verb of ``python -m
ndt_2d_tpu.cli`` (the reference's scripts/enable_mapping.py,
disable_mapping.py, save_map.py, load_map.py and the node itself, in one
binary), on the port's kernels.

  python -m ndt_2d_tpu_torch.cli simulate --world corridor --scans 200 \\
      --beams 600 --out bag.npz
  python -m ndt_2d_tpu_torch.cli run --bag bag.npz --grid-out grid.npz \\
      --map-out map.npz --loop-closure-every 1000000000 \\
      --local_scan_matcher.grid_cells 192
  python -m ndt_2d_tpu_torch.cli localize --bag bag.npz --map map.npz \\
      --particle-filter --pf.max_particles 5000
  python -m ndt_2d_tpu_torch.cli run --bag bag.npz --recipe drift
  python -m ndt_2d_tpu_torch.cli run --bag a.npz --session-out s.npz
  python -m ndt_2d_tpu_torch.cli run --bag b.npz --resume s.npz
  python -m ndt_2d_tpu_torch.cli run --bag bag.npz --socket ctl.sock
  python -m ndt_2d_tpu_torch.cli disable-mapping --socket ctl.sock
  python -m ndt_2d_tpu_torch.cli save-map --socket ctl.sock --filename m.npz
  python -m ndt_2d_tpu_torch.cli serve --socket scan.sock --publish-dir pub \\
      --max-inflight 8
  python -m ndt_2d_tpu_torch.cli feed --bag bag.npz --socket scan.sock \\
      --windowed
  python -m ndt_2d_tpu_torch.cli import-carmen \
      --log datasets/simlab.clf.gz --range-max 10 --out simlab.npz
  python -m ndt_2d_tpu_torch.cli run --bag simlab.npz --recipe simlab \
      --max-inflight 8
  python -m ndt_2d_tpu_torch.cli merge-maps --map-a a.npz --map-b b.npz \
      --out merged.npz
  python -m ndt_2d_tpu_torch.cli export-rosbag2 --map m.npz --out m_bag
  python -m ndt_2d_tpu_torch.cli import-rosbag2 --bag m_bag --out m.npz
  python -m ndt_2d_tpu_torch.cli info --map m.npz
  python -m ndt_2d_tpu_torch.cli viz --map m.npz --render-grid --out m.png

``run`` and ``localize`` print the same JSON stats line as ``python -m
ndt_2d_tpu.cli`` and take the reference CLI's names for the flags they
share: the matchers' namespaced parameters
(``--global_scan_matcher.ndt_resolution`` ..., ``.refine_iterations`` for
the Newton polish and ``.overlapping_grids 1`` for the four overlapping
grids), the loop-closure and solver flags (``--loop-search`` radius,
descriptor or both, with the far-row pruning levers), ``--recipe`` (the
reference CLI's measured presets ``office``, ``office-descriptor``,
``simlab`` and ``drift``; an explicit flag overrides its preset value),
``--map``, ``--particle-filter``, ``--global-init`` and the ``--pf.*``
filter parameters.  ``--max-inflight N`` pipelines them (the pose chain
stays on the device, up to N steps in flight), and ``--scan-matcher-type
correlative`` swaps the NDT matchers for the correlative one.  ``localize``,
and ``run --map``, start from the bag's first true pose (or its origin), or
with ``--global-init`` from a particle cloud over the map's free space.
``--session-out`` checkpoints the whole session (graph, estimator state,
particle cloud and its generator) and ``--resume`` continues one
(``io/serialization.py``); ``--socket`` opens the control channel the four
configure verbs talk to (``mapping/runtime.py``); ``--viz-out`` draws the
session (matplotlib) and ``--trace-dir`` traces it with ``torch.profiler``.
``serve`` is the live node (``mapping/server.py``) and ``feed`` streams a
bag into it.  ``merge-maps`` aligns and fuses two saved maps
(``mapping/merge.py``); ``import-carmen`` converts a CARMEN log
(``io/carmen.py``) to a bag; ``import-rosbag2`` and ``export-rosbag2``
move maps from and to the reference's rosbag2 format (``io/rosbag2.py``).
All run on the CUDA device unless ``--device cpu`` is given.

``run`` and ``localize`` shard the session over a device mesh
(``parallel/``) with ``--mesh N``, which starts N local ranks, one per
CUDA device (gloo ranks with ``--device cpu``), or with ``--distributed``,
which joins the process group ``torchrun`` describes in its environment
and meshes over all of its ranks; rank 0 writes the outputs, every rank
loads ``--resume``, and ``--socket`` opens the control channel on rank 0,
which broadcasts each action to every rank at a scan boundary
(``mapping/runtime.py::ControlServer``):

  python -m ndt_2d_tpu_torch.cli run --bag bag.npz --mesh 2 --map-out m.npz
  python -m ndt_2d_tpu_torch.cli run --bag bag.npz --mesh 2 --socket ctl.sock
  torchrun --nproc-per-node 2 -m ndt_2d_tpu_torch.cli run --bag bag.npz \
      --distributed
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import sys

import numpy as np

from ndt_2d_tpu_torch.config import (
    MapperConfig, ParticleFilterConfig, ScanMatcherConfig, SolverConfig)
from ndt_2d_tpu_torch.io import carmen, serialization
from ndt_2d_tpu_torch.io.bag import load_bag, record_synthetic, save_bag
from ndt_2d_tpu_torch.utils import metrics


def cmd_simulate(args) -> int:
    bag = record_synthetic(
        args.world, args.scans, n_beams=args.beams, range_max=args.range_max,
        scan_noise=args.scan_noise, odom_trans_noise=args.odom_noise,
        odom_rot_noise=args.odom_rot_noise, seed=args.seed)
    save_bag(bag, args.out)
    print(json.dumps({"out": args.out, "scans": len(bag),
                      "beams": args.beams}))
    return 0


_MATCHER_FLOATS = ("ndt_resolution", "search_angular_resolution",
                   "search_angular_size", "search_linear_resolution",
                   "search_linear_size")
_MAPPER_FLAGS = ("resolution", "minimum_travel_rotation", "rolling_depth",
                 "occupancy_threshold", "max_range", "auto_grow_grids",
                 "loop_closure_every", "max_points_per_scan",
                 "minimum_travel_distance", "global_search_size",
                 "global_search_limit", "optimization_node_limit",
                 "loop_closure_region_size", "loop_closure_accept",
                 "loop_closure_max_separation", "loop_closure_gate_scale",
                 "loop_closure_solve_before_reanchor",
                 "loop_search_positions", "loop_search",
                 "descriptor_min_similarity", "loop_closure_far_dedup",
                 "loop_closure_reject_cache_margin",
                 "loop_closure_max_far_rows", "max_inflight",
                 "scan_matcher_type")


# The reference CLI's measured loop-closure presets (ndt_2d_tpu/cli.py:
# 102-136): each sets only the quality levers; "global_refine_iterations"
# and "robust_loss" go to the nested global-matcher and solver configs.
_RECIPES = {
    # Radius search on structured indoor loops.
    "office": dict(
        loop_closure_gate_scale=0.85, loop_closure_region_size=3,
        loop_search_positions="both", robust_loss="geman_mcclure",
        global_refine_iterations=8),
    # Appearance (descriptor) search with the far-alias pruning.
    "office-descriptor": dict(
        loop_search="descriptor", loop_closure_gate_scale=0.85,
        loop_closure_region_size=3, loop_closure_accept="best",
        loop_closure_max_separation=1.5, loop_closure_far_dedup=2.5,
        loop_closure_reject_cache_margin=0.10, loop_closure_max_far_rows=16,
        robust_loss="geman_mcclure", global_refine_iterations=8),
    # Open or cluttered geometry surveyed densely.
    "simlab": dict(
        loop_closure_gate_scale=1.0, loop_closure_region_size=3,
        loop_search_positions="both", robust_loss="geman_mcclure",
        global_refine_iterations=8),
    # High odometry drift, where the radius search cannot reach the
    # revisits: union candidates, best-accept, separation gate, pruning.
    "drift": dict(
        loop_search="both", loop_closure_accept="best",
        loop_closure_max_separation=1.5, global_search_limit=8,
        descriptor_min_similarity=0.80, loop_closure_region_size=3,
        loop_closure_far_dedup=2.5, loop_closure_reject_cache_margin=0.10,
        loop_closure_max_far_rows=16,
        robust_loss="geman_mcclure", global_refine_iterations=8),
}


def _add_matcher_args(p: argparse.ArgumentParser, ns: str) -> None:
    """The reference's namespaced matcher parameters
    (scan_matcher_ndt.cpp:37-44) and the reference CLI's additions."""
    for name in _MATCHER_FLOATS:
        p.add_argument(f"--{ns}.{name}", type=float, default=None,
                       dest=f"{ns}__{name}")
    for name in ("laser_max_beams", "grid_cells"):
        p.add_argument(f"--{ns}.{name}", type=int, default=None,
                       dest=f"{ns}__{name}")
    p.add_argument(f"--{ns}.refine_iterations", type=int, default=None,
                   dest=f"{ns}__refine_iterations",
                   help="Newton sub-lattice polish iterations (0 = off)")
    p.add_argument(f"--{ns}.overlapping_grids", type=int, default=None,
                   dest=f"{ns}__overlapping_grids",
                   help="1 = four overlapping grids (Biber), 0 = one grid")


def _matcher_config(args, ns: str) -> ScanMatcherConfig:
    kw = {f: getattr(args, f"{ns}__{f}")
          for f in _MATCHER_FLOATS + ("laser_max_beams", "refine_iterations")
          if getattr(args, f"{ns}__{f}") is not None}
    cells = getattr(args, f"{ns}__grid_cells")
    if cells is not None:
        kw.update(grid_cells_x=cells, grid_cells_y=cells)
    og = getattr(args, f"{ns}__overlapping_grids")
    if og is not None:
        kw["overlapping_grids"] = bool(og)
    return ScanMatcherConfig(**kw)


def _add_pf_args(p: argparse.ArgumentParser) -> None:
    """The reference's particle-filter parameters (ndt_mapper.cpp:71-88),
    one ``--pf.<field>`` flag per ``ParticleFilterConfig`` field."""
    for f in dataclasses.fields(ParticleFilterConfig):
        p.add_argument(f"--pf.{f.name}", type=type(f.default), default=None,
                       dest=f"pf__{f.name}")


def _pf_config(args) -> ParticleFilterConfig:
    kw = {f.name: getattr(args, f"pf__{f.name}")
          for f in dataclasses.fields(ParticleFilterConfig)
          if getattr(args, f"pf__{f.name}", None) is not None}
    return ParticleFilterConfig(**kw)


def _mapper_config(args) -> MapperConfig:
    """The session's MapperConfig: defaults, then the ``--recipe`` preset,
    then every explicit flag (ndt_2d_tpu/cli.py:139-179); a verb without
    some of the flags (``serve``) keeps their defaults."""
    recipe = dict(_RECIPES.get(getattr(args, "recipe", None) or "", {}))
    robust_loss = recipe.pop("robust_loss", None)
    robust_loss = getattr(args, "robust_loss", None) or robust_loss
    global_refine = recipe.pop("global_refine_iterations", None)
    kw = recipe
    kw.update({f: getattr(args, f) for f in _MAPPER_FLAGS
               if getattr(args, f, None) is not None})
    if robust_loss is not None:
        kw["solver"] = SolverConfig(robust_loss=robust_loss)
    if getattr(args, "no_mapping", False):
        kw["enable_mapping"] = False
    if getattr(args, "particle_filter", False):
        kw["use_particle_filter"] = True
    gm = _matcher_config(args, "global_scan_matcher")
    if (global_refine is not None
            and args.global_scan_matcher__refine_iterations is None):
        gm = dataclasses.replace(gm, refine_iterations=global_refine)
    return MapperConfig(
        local_scan_matcher=_matcher_config(args, "local_scan_matcher"),
        global_scan_matcher=gm, particle_filter=_pf_config(args), **kw)


def _spawn_mesh(args) -> bool:
    """With ``--mesh N`` (and not yet a rank), start N local ranks of this
    same command with ``--distributed`` and wait for them; returns True
    when it did.  On CUDA each rank needs a device of its own."""
    if args.mesh is None or args.distributed:
        return False
    from ndt_2d_tpu_torch.parallel import distributed
    if args.mesh < 1:
        raise ValueError("--mesh needs at least one rank")
    if distributed.backend_for(args.device) == "nccl":
        import torch
        count = torch.cuda.device_count()
        if args.mesh > count:
            raise RuntimeError(f"--mesh {args.mesh} needs {args.mesh} CUDA "
                               f"devices, {count} visible")
    distributed.launch([sys.executable, "-m", "ndt_2d_tpu_torch.cli",
                        *args.argv, "--distributed"], args.mesh)
    return True


def _session_mesh(args):
    """The session's mesh under ``--distributed``: join the process group
    (this rank's device replaces ``args.device``) and mesh over all of its
    ranks; None otherwise."""
    if not args.distributed:
        return None
    from ndt_2d_tpu_torch.parallel import distributed, mesh as mesh_mod
    args.device = distributed.initialize(args.device)
    return mesh_mod.make_mesh()


def _run_session(args, localize: bool) -> int:
    """``run`` (mapping) or ``localize`` (``enable_mapping`` off) of a bag:
    from scratch, from a map (``--map``; the pose seeded at the bag's first
    true pose, or with ``--global-init`` over the map's free space) or from
    a session checkpoint (``--resume``), with the control channel on
    ``--socket``."""
    from ndt_2d_tpu_torch.mapping import runtime
    from ndt_2d_tpu_torch.mapping.mapper import Mapper

    if args.global_init and (args.resume or (not localize
                                             and args.map is None)):
        print(json.dumps({"error": "--global-init requires a map to "
                          "localize in and is incompatible with --resume"}))
        return 1
    if _spawn_mesh(args):
        return 0
    mesh = _session_mesh(args)
    cfg = _mapper_config(args)
    if localize:
        cfg = dataclasses.replace(cfg, enable_mapping=False)
    graph = None
    if args.map:
        graph = serialization.load_graph(args.map, cfg.max_points_per_scan,
                                         cfg.use_barycenter)
    if args.resume:
        mapper = serialization.load_session(args.resume, cfg, mesh=mesh,
                                            device=args.device)
    else:
        mapper = Mapper(cfg, graph=graph, device=args.device, mesh=mesh)
    bag = load_bag(args.bag)
    if (localize or graph is not None) and not args.resume:
        if args.global_init:
            # No initial pose: a uniform cloud over the map's free space.
            if not mapper.global_localize(bag.odom[0]):
                print(json.dumps({"error": "global_localize failed "
                                  "(requires --particle-filter and a map)"}))
                return 1
        else:
            # Start at the bag's first true pose in the map frame (a
            # resumed session already carries its pose estimate).
            init = (metrics.relative_to_first(bag.truth)[0]
                    if bag.truth is not None else np.zeros(3))
            mapper.set_initial_pose(init, np.diag([0.25, 0.25, 0.06]),
                                    bag.odom[0])
    control = (runtime.ControlServer(mapper, args.socket, mesh=mesh)
               if args.socket else None)
    try:
        return _replay(args, mapper, bag, control)
    finally:
        if control:
            control.close()


def cmd_run(args) -> int:
    return _run_session(args, localize=False)


def cmd_localize(args) -> int:
    """Localize a bag against a saved map: the particle filter with
    ``--particle-filter``, else scan-match tracking."""
    return _run_session(args, localize=True)


def cmd_configure(args, action: int) -> int:
    """One configure call on a running session's control channel."""
    from ndt_2d_tpu_torch.mapping import runtime
    out = runtime.send_configure(args.socket, action,
                                 getattr(args, "filename", "") or "")
    print(json.dumps(out))
    return 0 if out.get("ok") else 1


def cmd_serve(args) -> int:
    """The live node: scans in over a UNIX socket, poses out, latched map
    artifacts in ``--publish-dir``; runs until SIGINT or SIGTERM."""
    import signal
    import threading

    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    from ndt_2d_tpu_torch.mapping.server import ScanServer

    cfg = _mapper_config(args)
    graph = None
    if args.map:
        graph = serialization.load_graph(args.map, cfg.max_points_per_scan,
                                         cfg.use_barycenter)
    mapper = Mapper(cfg, graph=graph, device=args.device)
    server = ScanServer(mapper, args.socket, publish_dir=args.publish_dir,
                        publish_png=args.publish_png)
    print(json.dumps({"serving": args.socket,
                      "publish_dir": args.publish_dir}), flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        stop.wait()
    finally:
        server.close()
    return 0


def cmd_feed(args) -> int:
    """Stream a bag into a running ``serve``."""
    from ndt_2d_tpu_torch.mapping.server import stream_bag
    last = stream_bag(args.bag, args.socket, realtime_hz=args.hz,
                      windowed=args.windowed)
    last["results"] = len(last.get("results", {}))  # keep the print short
    times = last.pop("scan_times_s", [])
    if len(times) > 3:  # median over scans 4.. (the first launches build)
        last["scan_ms_median"] = round(float(np.median(times[3:])) * 1e3, 2)
    print(json.dumps(last))
    return 0 if last.get("ok") else 1


def cmd_import_carmen(args) -> int:
    """Convert a CARMEN log to a scan bag (ndt_2d_tpu/cli.py:365-380)."""
    report = carmen.CarmenReport()
    bag = carmen.load_carmen(args.log, fov_degrees=args.fov_degrees,
                             range_max=args.range_max,
                             use_laser_pose=not args.robot_odom,
                             time_increment=args.time_increment,
                             report=report)
    save_bag(bag, args.out)
    print(json.dumps({"out": args.out, "scans": len(bag),
                      "beams": int(bag.ranges.shape[1]),
                      "range_max": bag.range_max,
                      "config": list(report.kept_config),
                      "skipped_lines": report.skipped,
                      "has_timestamps": bag.times is not None}))
    return 0


def cmd_merge_maps(args) -> int:
    """Align map B to map A, fuse the graphs and save the merged map."""
    from ndt_2d_tpu_torch.mapping import merge

    ga = serialization.load_graph(args.map_a, args.max_points)
    gb = serialization.load_graph(args.map_b, args.max_points)
    try:
        res = merge.merge_maps(ga, gb, range_max=args.max_range,
                               min_similarity=args.min_similarity,
                               score_threshold=args.score_threshold,
                               top_k=args.top_k, device=args.device)
    except merge.MergeError as e:
        print(json.dumps({"error": str(e)}))
        return 1
    serialization.save_graph(res.graph, args.out)
    print(json.dumps({
        "out": args.out,
        "scans": res.graph.num_scans,
        "constraints": res.graph.num_constraints,
        "cross_constraints": res.pairs_accepted,
        "pairs_checked": res.pairs_checked,
        "transform_b_to_a": [round(float(v), 4) for v in res.transform],
        "optimized": res.optimized,
    }))
    return 0


def cmd_import_rosbag2(args) -> int:
    """One-way migration of a reference (ROS ndt_2d) map file
    (src/graph.cpp:49-105 format) into the native npz schema."""
    from ndt_2d_tpu_torch.io import rosbag2
    g = rosbag2.import_map(args.bag, args.max_points)
    serialization.save_graph(g, args.out)
    print(json.dumps({"out": args.out, "scans": g.num_scans,
                      "constraints": g.num_constraints,
                      "loop_closures": int(g.constraint_switchable.sum())}))
    return 0


def cmd_export_rosbag2(args) -> int:
    """Write a native map as a reference-format rosbag2 directory so the
    ROS ndt_2d package can load it (src/graph.cpp:107-165 format)."""
    from ndt_2d_tpu_torch.io import rosbag2
    g = serialization.load_graph(args.map, args.max_points)
    rosbag2.export_map(g, args.out)
    print(json.dumps({"out": args.out, "scans": g.num_scans,
                      "constraints": g.num_constraints}))
    return 0


def cmd_viz(args) -> int:
    """Render a saved map (and an occupancy grid) to PNG — the offline
    analog of the reference's RViz graph/map displays."""
    from ndt_2d_tpu_torch.mapping import occupancy
    from ndt_2d_tpu_torch.utils import viz
    g = serialization.load_graph(args.map, args.max_points)
    grid = None
    if args.grid:
        z = np.load(args.grid)
        grid = occupancy.OccupancyGridResult(
            data=z["data"], origin=z["origin"],
            resolution=float(z["resolution"]))
    elif args.render_grid:
        grid = occupancy.render_occupancy(g.poses, g.points, g.point_mask,
                                          args.resolution, 0.25,
                                          device=args.device)
    viz.save_graph_png(g, args.out, grid=grid)
    print(json.dumps({"out": args.out, "scans": g.num_scans,
                      "constraints": g.num_constraints}))
    return 0


def cmd_info(args) -> int:
    """One line about a saved map: its size and the extent of its poses."""
    g = serialization.load_graph(args.map, 512)
    print(json.dumps({
        "scans": g.num_scans,
        "constraints": g.num_constraints,
        "loop_closures": int(g.constraint_switchable.sum()),
        "bounds_min": g.poses[:, :2].min(0).tolist() if g.num_scans else None,
        "bounds_max": g.poses[:, :2].max(0).tolist() if g.num_scans else None,
    }))
    return 0


def _replay(args, mapper, bag, control=None) -> int:
    """Run ``bag`` through ``mapper`` (traced into ``--trace-dir``), write
    the requested outputs and print the stats line (rank 0 of a mesh
    only; each rank of a mesh traces into its own subdirectory)."""
    from ndt_2d_tpu_torch.mapping import runtime
    from ndt_2d_tpu_torch.parallel import distributed

    def progress(t, res):
        # A pipelined scan's pose is still in flight: nothing to print.
        if args.verbose and res.pose is not None:
            print(f"scan {t}: pose={np.round(res.pose, 3)} "
                  f"score={res.matched_score:.3f}", file=sys.stderr)

    trace = contextlib.nullcontext()
    if args.trace_dir:
        from ndt_2d_tpu_torch.utils.profiling import device_trace
        trace_dir = args.trace_dir
        if mapper.mesh is not None:
            trace_dir = os.path.join(trace_dir, f"rank{distributed.rank()}")
        trace = device_trace(trace_dir)
    with trace:
        stats = runtime.run_bag(mapper, bag, progress=progress,
                                control=control)
    if args.trace_dir:
        stats["trace_dir"] = trace_dir
    truth = (metrics.relative_to_first(bag.truth) if bag.truth is not None
             else None)
    runtime.write_outputs(mapper, stats, args.traj_out, args.map_out,
                          args.grid_out, args.session_out, args.viz_out,
                          truth)
    return 0


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ndt_2d_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("simulate", help="generate a synthetic scan bag")
    p.add_argument("--world", choices=["corridor", "box", "office"],
                   default="corridor")
    p.add_argument("--scans", type=int, default=200)
    p.add_argument("--beams", type=int, default=360)
    p.add_argument("--range-max", type=float, default=15.0)
    p.add_argument("--scan-noise", type=float, default=0.01)
    p.add_argument("--odom-noise", type=float, default=0.008)
    p.add_argument("--odom-rot-noise", type=float, default=0.002)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("import-carmen",
                       help="convert a CARMEN .log/.clf dataset to a scan "
                            "bag")
    p.add_argument("--log", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--fov-degrees", type=float, default=180.0)
    p.add_argument("--range-max", type=float, default=None)
    p.add_argument("--robot-odom", action="store_true",
                   help="use the robot odometry columns instead of the "
                        "laser pose")
    p.add_argument("--time-increment", type=float, default=0.0,
                   help="per-beam time (s) for motion de-skew (0 = none)")
    p.set_defaults(fn=cmd_import_carmen)

    for name, localize in (("run", False), ("localize", True)):
        p = sub.add_parser(name, help="replay a bag, " + (
            "localizing in a saved map" if localize else "mapping"))
        _add_session_args(p)
        p.set_defaults(fn=cmd_localize if localize else cmd_run)

    # The four reference scripts (scripts/*.py) as control-channel verbs.
    for name, action, filename in (("enable-mapping", 1, False),
                                   ("disable-mapping", 2, False),
                                   ("load-map", 4, True),
                                   ("save-map", 8, True)):
        p = sub.add_parser(name, help=f"configure action {action} on a "
                                      "running session's --socket")
        p.add_argument("--socket", required=True)
        if filename:
            p.add_argument("--filename", required=True)
        p.set_defaults(fn=lambda a, action=action: cmd_configure(a, action))

    p = sub.add_parser("serve", help="live scan server (the node analog): "
                                     "scans in over a socket, pose out, "
                                     "4 Hz latched map artifacts")
    p.add_argument("--socket", required=True, help="UNIX socket path")
    p.add_argument("--map", default=None, help="map to load at startup")
    p.add_argument("--publish-dir", default=None,
                   help="directory for latched map.npz/state.json artifacts")
    p.add_argument("--publish-png", action="store_true",
                   help="also draw map.png at each publish (matplotlib)")
    p.add_argument("--particle-filter", action="store_true",
                   dest="particle_filter")
    p.add_argument("--no-mapping", action="store_true", dest="no_mapping")
    _add_matcher_args(p, "local_scan_matcher")
    _add_matcher_args(p, "global_scan_matcher")
    _add_loop_closure_args(p)
    p.add_argument("--max-range", type=float, default=None, dest="max_range")
    p.add_argument("--max-inflight", type=int, default=None,
                   dest="max_inflight",
                   help="pipelined device pose chain (what lets windowed "
                        "clients overlap scans; see 'feed --windowed')")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain twins)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("feed", help="stream a bag into a running server")
    p.add_argument("--bag", required=True)
    p.add_argument("--socket", required=True)
    p.add_argument("--hz", type=float, default=0.0,
                   help="pace the stream (0 = as fast as possible)")
    p.add_argument("--windowed", action="store_true",
                   help="windowed protocol: immediate per-scan acks, poses "
                        "stream back as their copies land (pairs with a "
                        "server run with --max-inflight)")
    p.set_defaults(fn=cmd_feed)

    p = sub.add_parser("import-rosbag2",
                       help="migrate a reference (ROS ndt_2d) rosbag2 map "
                            "file to the native npz schema")
    p.add_argument("--bag", required=True,
                   help="bag directory or .db3 file written by the "
                        "reference's save_map")
    p.add_argument("--out", required=True)
    p.add_argument("--max-points", type=int, default=512)
    p.set_defaults(fn=cmd_import_rosbag2)

    p = sub.add_parser("export-rosbag2",
                       help="write a native map as a reference-format "
                            "rosbag2 directory (loadable by the ROS "
                            "ndt_2d package)")
    p.add_argument("--map", required=True)
    p.add_argument("--out", required=True, help="bag DIRECTORY to create")
    p.add_argument("--max-points", type=int, default=512)
    p.set_defaults(fn=cmd_export_rosbag2)

    p = sub.add_parser("info", help="inspect a saved map")
    p.add_argument("--map", required=True)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("viz", help="render a saved map to PNG (matplotlib)")
    p.add_argument("--map", required=True)
    p.add_argument("--grid", default=None, help="occupancy grid npz overlay")
    p.add_argument("--render-grid", action="store_true",
                   help="re-render the occupancy grid from the map")
    p.add_argument("--resolution", type=float, default=0.05)
    p.add_argument("--max-points", type=int, default=512)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda",
                   help="where --render-grid renders: cuda (the kernel) or "
                        "cpu (its plain twin)")
    p.set_defaults(fn=cmd_viz)

    p = sub.add_parser("merge-maps",
                       help="align and fuse two saved maps (descriptor "
                            "search + full-heading NDT registration + joint "
                            "solve)")
    p.add_argument("--map-a", required=True, help="base map (keeps its frame)")
    p.add_argument("--map-b", required=True, help="map merged into A's frame")
    p.add_argument("--out", required=True)
    p.add_argument("--max-range", type=float, default=15.0)
    p.add_argument("--max-points", type=int, default=512)
    p.add_argument("--top-k", type=int, default=10,
                   help="descriptor candidate pairs to confirm")
    p.add_argument("--min-similarity", type=float, default=0.9)
    p.add_argument("--score-threshold", type=float, default=-0.25,
                   help="NDT accept gate for cross-map matches")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain twins)")
    p.set_defaults(fn=cmd_merge_maps)
    return ap


def _add_loop_closure_args(p: argparse.ArgumentParser) -> None:
    """The loop-closure and solver flags, shared by ``run``, ``localize``
    and ``serve`` (the live node tunes closures as a replay does)."""
    p.add_argument("--loop-search", choices=["radius", "descriptor", "both"],
                   default=None, dest="loop_search",
                   help="loop-closure candidate source (default radius; "
                        "descriptor = drift-robust appearance search; "
                        "both = deduped union of the two)")
    p.add_argument("--descriptor-min-similarity", type=float, default=None,
                   dest="descriptor_min_similarity",
                   help="cosine cutoff for descriptor candidates")
    p.add_argument("--loop-closure-far-dedup", type=float, default=None,
                   dest="loop_closure_far_dedup", metavar="M",
                   help="per-pass spatial dedup radius for far (coarse) "
                        "confirmation rows (0 = off)")
    p.add_argument("--loop-closure-reject-cache-margin", type=float,
                   default=None, dest="loop_closure_reject_cache_margin",
                   help="cache clearly rejected far site pairs and skip "
                        "proposing them again (fraction of |gate|; 0 = off)")
    p.add_argument("--loop-closure-max-far-rows", type=int, default=None,
                   dest="loop_closure_max_far_rows",
                   help="per-pass cap on far confirmation rows, "
                        "similarity-ranked (0 = unlimited)")
    p.add_argument("--loop-closure-region-size", type=int, default=None,
                   dest="loop_closure_region_size", metavar="S",
                   help="scans per candidate confirmation region "
                        "(2 = reference parity, 3 = one either side)")
    p.add_argument("--loop-closure-accept", choices=["first", "best"],
                   default=None, dest="loop_closure_accept")
    p.add_argument("--loop-closure-max-separation", type=float,
                   default=None, dest="loop_closure_max_separation",
                   metavar="M")
    p.add_argument("--loop-closure-gate-scale", type=float, default=None,
                   dest="loop_closure_gate_scale")
    p.add_argument("--robust-loss", default=None,
                   choices=["none", "huber", "geman_mcclure"],
                   help="robust loss on loop-closure edges in the solve")
    p.add_argument("--loop-closure-solve-before-reanchor",
                   action=argparse.BooleanOptionalAction, default=None,
                   dest="loop_closure_solve_before_reanchor")
    p.add_argument("--loop-search-positions",
                   choices=["barycenter", "pose", "both"], default=None,
                   dest="loop_search_positions")
    p.add_argument("--recipe", default=None,
                   choices=sorted(_RECIPES),
                   help="measured loop-closure preset (explicit flags "
                        "override its values)")


def _add_session_args(p: argparse.ArgumentParser) -> None:
    """The flags ``run`` and ``localize`` share."""
    p.add_argument("--bag", required=True)
    p.add_argument("--map", default=None,
                   help="pose graph npz to start from (localize in it, or "
                        "map on from it)")
    p.add_argument("--map-out", default=None, help="pose graph npz output")
    p.add_argument("--session-out", default=None, dest="session_out",
                   help="full session checkpoint (graph, estimator state, "
                        "particle cloud and its generator): resume exactly, "
                        "no re-localization")
    p.add_argument("--resume", default=None,
                   help="resume from a --session-out checkpoint (of either "
                        "package)")
    p.add_argument("--grid-out", default=None,
                   help="occupancy grid npz output")
    p.add_argument("--traj-out", default=None,
                   help="estimated trajectory in TUM format (timestamps = "
                        "scan indices)")
    p.add_argument("--viz-out", default=None, dest="viz_out",
                   help="session picture, PNG (graph + map + particles over "
                        "ground truth; matplotlib)")
    p.add_argument("--socket", default=None,
                   help="UNIX socket path of the runtime control channel")
    p.add_argument("--trace-dir", default=None, dest="trace_dir",
                   help="trace the session with torch.profiler into "
                        "DIR/trace.json (Chrome trace format)")
    p.add_argument("--particle-filter", action="store_true",
                   dest="particle_filter")
    p.add_argument("--global-init", action="store_true", dest="global_init",
                   help="global relocalization: a uniform particle cloud "
                        "over the map's free space instead of an initial "
                        "pose (needs --particle-filter and --map)")
    _add_pf_args(p)
    # The mapper's parameters (ndt_mapper.cpp:59-103).
    p.add_argument("--resolution", type=float, default=None,
                   help="occupancy-grid export resolution (m)")
    p.add_argument("--loop-closure-every", type=int, default=None,
                   dest="loop_closure_every")
    p.add_argument("--max-points-per-scan", type=int, default=None,
                   dest="max_points_per_scan")
    p.add_argument("--minimum-travel-distance", type=float, default=None,
                   dest="minimum_travel_distance")
    p.add_argument("--minimum-travel-rotation", type=float, default=None,
                   dest="minimum_travel_rotation")
    p.add_argument("--rolling-depth", type=int, default=None,
                   dest="rolling_depth")
    p.add_argument("--occupancy-threshold", type=float, default=None,
                   dest="occupancy_threshold")
    p.add_argument("--max-range", type=float, default=None,
                   dest="max_range",
                   help="beam range cap (m; negative = the bag's range)")
    p.add_argument("--auto-grow-grids",
                   action=argparse.BooleanOptionalAction, default=None,
                   dest="auto_grow_grids",
                   help="rebuild a matcher at a larger static grid when a "
                        "session outgrows it (default on; --no-... raises "
                        "with sizing advice instead)")
    p.add_argument("--no-mapping", action="store_true", dest="no_mapping",
                   help="track without adding scans to the map")
    p.add_argument("--global-search-size", type=float, default=None,
                   dest="global_search_size",
                   help="loop-closure radius search bound (squared meters)")
    p.add_argument("--global-search-limit", type=int, default=None,
                   dest="global_search_limit")
    p.add_argument("--optimization-node-limit", type=int, default=None,
                   dest="optimization_node_limit")
    p.add_argument("--max-inflight", type=int, default=None,
                   dest="max_inflight",
                   help="pipelined mapping and localization: the pose chain "
                        "stays on the device with up to N steps in flight "
                        "(0 = synchronous, the default)")
    p.add_argument("--scan-matcher-type", default=None,
                   dest="scan_matcher_type",
                   help="matcher plugin (ndt_mapper.cpp:91-92): ndt, "
                        "ndt_newton or correlative")
    _add_matcher_args(p, "local_scan_matcher")
    _add_matcher_args(p, "global_scan_matcher")
    _add_loop_closure_args(p)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain twins)")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="shard the session over N local ranks, one per "
                        "CUDA device (gloo ranks with --device cpu): match "
                        "angles over 'space', confirmation rows, particles "
                        "and constraints over 'batch', occupancy rays over "
                        "every rank")
    p.add_argument("--distributed", action="store_true",
                   help="join the process group described by the "
                        "environment (RANK, WORLD_SIZE, LOCAL_RANK and "
                        "MASTER_ADDR/MASTER_PORT, as torchrun sets them) and "
                        "mesh over all of its ranks")
    p.add_argument("--verbose", action="store_true")


def main(argv=None) -> int:
    logging.basicConfig(level=logging.WARNING)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _build_parser().parse_args(argv)
    # What a rank of --mesh N runs: this command without "--mesh N".
    args.argv = [a for i, a in enumerate(argv)
                 if a != "--mesh" and (i == 0 or argv[i - 1] != "--mesh")
                 and not a.startswith("--mesh=")]
    try:
        return args.fn(args)
    finally:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
