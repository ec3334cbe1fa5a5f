"""Config 2's four arms on the CPU: the JAX reference and the port, each
synchronous and at max_inflight 8, over the 200-scan corridor bag
(benchmarks/run_benchmarks.py:139-153, 600 beams, 192x192 grids).

Prints one JSON line per arm (ATE, odometry's ATE, seconds) and one per
pair of arms: the largest difference of their poses along the corridor
(x), across it (y) and in heading, the first scan where they part by more
than 5 mm and by more than 0.03 m, and the scans of the largest one-scan
jumps of their x difference.  Run from the repo root:

    python tests/corridor_arms.py
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ndt_2d_tpu.io import bag as jax_bag  # noqa: E402
from ndt_2d_tpu.mapping import runtime as jax_runtime  # noqa: E402
from ndt_2d_tpu.mapping.mapper import Mapper as JaxMapper  # noqa: E402
from ndt_2d_tpu_torch.config import (MapperConfig,  # noqa: E402
                                     ScanMatcherConfig)
from ndt_2d_tpu_torch.io.bag import record_synthetic  # noqa: E402
from ndt_2d_tpu_torch.mapping import runtime  # noqa: E402
from ndt_2d_tpu_torch.mapping.mapper import Mapper  # noqa: E402
from port_configs import to_jax  # noqa: E402


def config2(inflight: int) -> MapperConfig:
    m = ScanMatcherConfig(grid_cells_x=192, grid_cells_y=192)
    return MapperConfig(local_scan_matcher=m, global_scan_matcher=m,
                        max_points_per_scan=512, loop_closure_every=10**9,
                        max_inflight=inflight)


def first_above(d, limit):
    return int(np.argmax(d > limit)) if (d > limit).any() else None


def main() -> int:
    torch.set_num_threads(4)
    bag = record_synthetic("corridor", 200, n_beams=600, seed=0)
    jbag = jax_bag.record_synthetic("corridor", 200, n_beams=600, seed=0)
    assert np.array_equal(bag.ranges, jbag.ranges, equal_nan=True)
    assert np.array_equal(bag.odom, jbag.odom)
    arms = {}
    for name, inflight in (("jax_sync", 0), ("jax_pipelined", 8),
                           ("port_sync", 0), ("port_pipelined", 8)):
        t0 = time.perf_counter()
        cfg = config2(inflight)
        if name.startswith("jax"):
            mapper = JaxMapper(to_jax(cfg))
            stats = jax_runtime.run_bag(mapper, jbag)
        else:
            mapper = Mapper(cfg, device="cpu")
            stats = runtime.run_bag(mapper, bag)
        arms[name] = np.asarray(mapper.graph.poses, np.float64)
        print(json.dumps({"arm": name, "scans": mapper.graph.num_scans,
                          "ate_m": stats["ate_rmse_m"],
                          "odom_ate_m": stats["odom_ate_rmse_m"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    names = list(arms)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            d = arms[a] - arms[b]
            dist = np.hypot(d[:, 0], d[:, 1])
            jumps = np.abs(np.diff(d[:, 0]))
            top = np.argsort(-jumps)[:3]
            print(json.dumps({
                "arms": [a, b],
                "max_dx_m": float(np.abs(d[:, 0]).max()),
                "max_dy_m": float(np.abs(d[:, 1]).max()),
                "max_dtheta_rad": float(np.abs(d[:, 2]).max()),
                "first_scan_over_5mm": first_above(dist, 0.005),
                "first_scan_over_3cm": first_above(dist, 0.03),
                "largest_x_jumps": [[int(t) + 1, float(jumps[t])]
                                    for t in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
