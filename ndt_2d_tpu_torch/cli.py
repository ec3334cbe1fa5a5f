"""Command-line interface of the port: ``simulate``, ``run`` and
``localize``.

  python -m ndt_2d_tpu_torch.cli simulate --world corridor --scans 200 \\
      --beams 600 --out bag.npz
  python -m ndt_2d_tpu_torch.cli run --bag bag.npz --grid-out grid.npz \\
      --map-out map.npz --loop-closure-every 1000000000 \\
      --local_scan_matcher.grid_cells 192
  python -m ndt_2d_tpu_torch.cli localize --bag bag.npz --map map.npz \\
      --particle-filter --pf.max_particles 5000

``run`` and ``localize`` print the same JSON stats line as ``python -m
ndt_2d_tpu.cli`` and take the reference CLI's names for the flags they
share: the matchers' namespaced parameters
(``--global_scan_matcher.ndt_resolution`` ...; not ``refine_iterations``
or ``overlapping_grids``, which the port refuses), the radius loop-closure
and solver flags, and for ``localize`` ``--map``, ``--particle-filter``,
``--global-init`` and the ``--pf.*`` filter parameters.  ``localize``
starts from the bag's first true pose (or its origin), or with
``--global-init`` from a particle cloud over the map's free space.  Both
run on the CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys

import numpy as np

from ndt_2d_tpu_torch.shared import (
    MapperConfig, ParticleFilterConfig, ScanMatcherConfig, SolverConfig,
    load_bag, metrics, record_synthetic, save_bag, serialization)


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
_MAPPER_FLAGS = ("loop_closure_every", "max_points_per_scan",
                 "minimum_travel_distance", "global_search_size",
                 "global_search_limit", "optimization_node_limit",
                 "loop_closure_region_size", "loop_closure_accept",
                 "loop_closure_max_separation", "loop_closure_gate_scale",
                 "loop_closure_solve_before_reanchor",
                 "loop_search_positions")


def _add_matcher_args(p: argparse.ArgumentParser, ns: str) -> None:
    """The reference's namespaced matcher parameters
    (scan_matcher_ndt.cpp:37-44) the port supports."""
    for name in _MATCHER_FLOATS:
        p.add_argument(f"--{ns}.{name}", type=float, default=None,
                       dest=f"{ns}__{name}")
    for name in ("laser_max_beams", "grid_cells"):
        p.add_argument(f"--{ns}.{name}", type=int, default=None,
                       dest=f"{ns}__{name}")


def _matcher_config(args, ns: str) -> ScanMatcherConfig:
    kw = {f: getattr(args, f"{ns}__{f}")
          for f in _MATCHER_FLOATS + ("laser_max_beams",)
          if getattr(args, f"{ns}__{f}") is not None}
    cells = getattr(args, f"{ns}__grid_cells")
    if cells is not None:
        kw.update(grid_cells_x=cells, grid_cells_y=cells)
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
    kw = {f: getattr(args, f) for f in _MAPPER_FLAGS
          if getattr(args, f) is not None}
    if args.robust_loss is not None:
        kw["solver"] = SolverConfig(robust_loss=args.robust_loss)
    return MapperConfig(
        local_scan_matcher=_matcher_config(args, "local_scan_matcher"),
        global_scan_matcher=_matcher_config(args, "global_scan_matcher"),
        **kw)


def cmd_run(args) -> int:
    from ndt_2d_tpu_torch.mapping.mapper import Mapper

    mapper = Mapper(_mapper_config(args), device=args.device)
    return _replay(args, mapper, load_bag(args.bag))


def cmd_localize(args) -> int:
    """Localize a bag against a saved map: the particle filter with
    ``--particle-filter``, else scan-match tracking."""
    from ndt_2d_tpu_torch.mapping.mapper import Mapper

    cfg = dataclasses.replace(
        _mapper_config(args), enable_mapping=False,
        use_particle_filter=args.particle_filter,
        particle_filter=_pf_config(args))
    graph = None
    if args.map:
        graph = serialization.load_graph(args.map, cfg.max_points_per_scan,
                                         cfg.use_barycenter)
    mapper = Mapper(cfg, graph=graph, device=args.device)
    bag = load_bag(args.bag)
    if args.global_init:
        # No initial pose: a uniform cloud over the map's free space.
        if not mapper.global_localize(bag.odom[0]):
            print(json.dumps({"error": "global_localize failed (requires "
                              "--particle-filter and a map)"}))
            return 1
    else:
        # Start at the bag's first true pose in the map frame.
        init = (metrics.relative_to_first(bag.truth)[0]
                if bag.truth is not None else np.zeros(3))
        mapper.set_initial_pose(init, np.diag([0.25, 0.25, 0.06]),
                                bag.odom[0])
    return _replay(args, mapper, bag)


def _replay(args, mapper, bag) -> int:
    """Run ``bag`` through ``mapper``, write the requested outputs and
    print the stats line."""
    from ndt_2d_tpu_torch.mapping import runtime
    from ndt_2d_tpu_torch.mapping.mapper import SAVE_TO_FILE

    def progress(t, res):
        if args.verbose and res.accepted:
            print(f"scan {t}: pose={np.round(res.pose, 3)} "
                  f"score={res.matched_score:.3f}", file=sys.stderr)

    stats = runtime.run_bag(mapper, bag, progress=progress)
    est = stats.pop("_est")
    est_t = stats.pop("_est_t")
    if args.traj_out:
        serialization.save_tum(args.traj_out, est_t, est)
        stats["traj_out"] = args.traj_out
    if args.map_out:
        mapper.configure(SAVE_TO_FILE, args.map_out)
        stats["map_out"] = args.map_out
    if args.grid_out:
        grid = mapper.render_map()
        np.savez_compressed(args.grid_out, data=grid.data, origin=grid.origin,
                            resolution=grid.resolution)
        stats["grid_out"] = args.grid_out
    print(json.dumps(stats))
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

    for name, localize in (("run", False), ("localize", True)):
        p = sub.add_parser(name, help="replay a bag, " + (
            "localizing in a saved map" if localize else "mapping"))
        _add_session_args(p)
        if localize:
            p.add_argument("--map", default=None,
                           help="pose graph npz to localize in")
            p.add_argument("--particle-filter", action="store_true",
                           dest="particle_filter")
            p.add_argument("--global-init", action="store_true",
                           dest="global_init",
                           help="global relocalization: a uniform particle "
                                "cloud over the map's free space instead of "
                                "an initial pose (needs --particle-filter)")
            _add_pf_args(p)
        p.set_defaults(fn=cmd_localize if localize else cmd_run)
    return ap


def _add_session_args(p: argparse.ArgumentParser) -> None:
    """The flags ``run`` and ``localize`` share."""
    p.add_argument("--bag", required=True)
    p.add_argument("--map-out", default=None, help="pose graph npz output")
    p.add_argument("--grid-out", default=None,
                   help="occupancy grid npz output")
    p.add_argument("--traj-out", default=None,
                   help="estimated trajectory in TUM format (timestamps = "
                        "scan indices)")
    p.add_argument("--loop-closure-every", type=int, default=None,
                   dest="loop_closure_every")
    p.add_argument("--max-points-per-scan", type=int, default=None,
                   dest="max_points_per_scan")
    p.add_argument("--minimum-travel-distance", type=float, default=None,
                   dest="minimum_travel_distance")
    p.add_argument("--global-search-size", type=float, default=None,
                   dest="global_search_size",
                   help="loop-closure radius search bound (squared meters)")
    p.add_argument("--global-search-limit", type=int, default=None,
                   dest="global_search_limit")
    p.add_argument("--optimization-node-limit", type=int, default=None,
                   dest="optimization_node_limit")
    _add_matcher_args(p, "local_scan_matcher")
    _add_matcher_args(p, "global_scan_matcher")
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
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain twins)")
    p.add_argument("--verbose", action="store_true")


def main(argv=None) -> int:
    logging.basicConfig(level=logging.WARNING)
    args = _build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
