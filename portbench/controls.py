"""Readings of the comparisons that decide ``correct``, for their limits.

    python3 portbench/controls.py --workload <cell> --seconds <s> \
        --seeds <n> --first-seed <seed> [--control-seeds <k>]

For each of ``n`` seeds (``first-seed`` + i * 1000003), in one process on
the card: the cell's set-up and a timed window of ``s`` seconds, as a run
makes them, then the cell's comparisons over the steps the window
recorded, once with the program's answers and, on the first ``k`` seeds,
once with the reference computed one precision below the configuration's
in the program's place (the control).  One JSON line a seed, then one
with each number's lower reading (the largest the program gives) and
upper reading (the smallest the control gives).  A limit goes between
them; PERF.md lists the readings each limit was set from.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import bench  # noqa: E402


def readings(root, cell, seed, seconds, control, device, dirs=()):
    """({number: program's value}, {number: control's value} or None)."""
    b = bench.Bench(root, dirs)
    ctx = bench.Context(b, cell, seed, device, False)
    state = ctx.driver.setup(ctx)
    ctx.driver.window(state, seconds, bench.RunRecord())
    program = {c["name"]: c["value"] for c in ctx.driver.check(state)}
    lower = None
    if control:
        lower = {c["name"]: c["value"]
                 for c in ctx.driver.check(state, control=True)}
    return program, lower


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    low, high = {}, {}
    for i in range(args.seeds):
        seed = args.first_seed + i * 1000003
        t0 = time.perf_counter()
        program, control = readings(ROOT, args.workload, seed, args.seconds,
                                    i < args.control_seeds,
                                    torch.device("cuda"))
        for k, v in program.items():
            low[k] = max(low.get(k, 0.0), v)
        for k, v in (control or {}).items():
            high[k] = min(high.get(k, float("inf")), v)
        print(json.dumps({"seed": seed, "program": program,
                          "control": control,
                          "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "lower": low, "upper": high,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
