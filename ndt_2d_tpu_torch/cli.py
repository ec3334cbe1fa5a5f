"""Command-line interface of the port: ``simulate`` and ``run``.

  python -m ndt_2d_tpu_torch.cli simulate --world corridor --scans 200 \\
      --beams 600 --out bag.npz
  python -m ndt_2d_tpu_torch.cli run --bag bag.npz --grid-out grid.npz \\
      --loop-closure-every 1000000000 --local_scan_matcher.grid_cells 192

``run`` prints the same JSON stats line as ``python -m ndt_2d_tpu.cli run``.
It maps on the CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys

import numpy as np

from ndt_2d_tpu_torch.shared import (
    MapperConfig, ScanMatcherConfig, load_bag, record_synthetic, save_bag,
    serialization)


def cmd_simulate(args) -> int:
    bag = record_synthetic(
        args.world, args.scans, n_beams=args.beams, range_max=args.range_max,
        scan_noise=args.scan_noise, odom_trans_noise=args.odom_noise,
        odom_rot_noise=args.odom_rot_noise, seed=args.seed)
    save_bag(bag, args.out)
    print(json.dumps({"out": args.out, "scans": len(bag),
                      "beams": args.beams}))
    return 0


def _mapper_config(args) -> MapperConfig:
    kw = {}
    for f in ("loop_closure_every", "max_points_per_scan"):
        v = getattr(args, f)
        if v is not None:
            kw[f] = v
    local = ScanMatcherConfig()
    if args.local_grid_cells is not None:
        local = dataclasses.replace(local, grid_cells_x=args.local_grid_cells,
                                    grid_cells_y=args.local_grid_cells)
    return MapperConfig(local_scan_matcher=local, **kw)


def cmd_run(args) -> int:
    from ndt_2d_tpu_torch.mapping import runtime
    from ndt_2d_tpu_torch.mapping.mapper import SAVE_TO_FILE, Mapper

    mapper = Mapper(_mapper_config(args), device=args.device)
    bag = load_bag(args.bag)

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

    p = sub.add_parser("run", help="replay a bag, mapping")
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
    p.add_argument("--local_scan_matcher.grid_cells", type=int, default=None,
                   dest="local_grid_cells")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain twins)")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_run)
    return ap


def main(argv=None) -> int:
    logging.basicConfig(level=logging.WARNING)
    args = _build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
