"""BASELINE config 9 on the CPU, twice: the JAX reference and the port (its
plain-PyTorch twins), each replaying the committed simlab CARMEN log
(``datasets/simlab.clf.gz``, truth ``datasets/simlab_truth.npz``) with the
configuration ``chip_smoke.py::config9`` builds (max_inflight 8,
Geman-McClure, radius loop closure every 20 scans).

One arm a process, each writing a JSON record; then a comparison of two
records: closures, online and final ATE of each, and the first scan where
the two part (an accept decision, or the closures held after a scan).
Run from the repo root:

    python tests/config9_arms.py jax  OUT_JAX.json  [--scans N]
    python tests/config9_arms.py port OUT_PORT.json [--scans N]
    python tests/config9_arms.py compare OUT_JAX.json OUT_PORT.json

A record is written every 100 scans, so a run cut by a time limit still
says how far it got.
"""

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, ROOT)

LOG = os.path.join(ROOT, "datasets", "simlab.clf.gz")
TRUTH = os.path.join(ROOT, "datasets", "simlab_truth.npz")


def closures_of(graph) -> list:
    """The graph's switchable (loop-closure) constraints as (begin, end)
    pairs in insertion order."""
    sw = np.asarray(graph.constraint_switchable, bool)
    b = np.asarray(graph.constraint_begin)[sw]
    e = np.asarray(graph.constraint_end)[sw]
    return [[int(x), int(y)] for x, y in zip(b, e)]


def run_arm(arm: str, out: str, scans: int) -> int:
    from chip_smoke import config9
    truth = np.load(TRUTH)["truth"]
    cfg = config9()
    if arm == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax
        jax.config.update("jax_platforms", "cpu")
        from ndt_2d_tpu.io import carmen
        from ndt_2d_tpu.mapping.mapper import Mapper
        from port_configs import to_jax
        bag = carmen.load_carmen(LOG, range_max=10.0)
        mapper = Mapper(to_jax(cfg))
    else:
        import torch
        torch.set_num_threads(2)
        from ndt_2d_tpu_torch.io import carmen
        from ndt_2d_tpu_torch.mapping.mapper import Mapper
        bag = carmen.load_carmen(LOG, range_max=10.0)
        mapper = Mapper(cfg, device="cpu")
    from ndt_2d_tpu_torch.utils import metrics
    n = min(len(bag), scans)
    record = {"arm": arm, "scans_in_log": len(bag), "scans_done": 0,
              "finished": False}
    est, used, accepted, held = [], [], [], []
    t0 = time.perf_counter()

    def write(finished: bool):
        poses = [np.asarray(e.result() if hasattr(e, "result") else e,
                            np.float64) for e in est]
        record.update(scans_done=len(accepted), finished=finished,
                      seconds=time.perf_counter() - t0,
                      accepted=accepted, closures_held=held,
                      closures=closures_of(mapper.graph),
                      loop_closures_rejected=int(
                          mapper.stats.loop_closures_rejected),
                      optimizations=int(mapper.stats.optimizations))
        if poses:
            p = np.stack(poses)
            u = np.asarray(used)
            record["ate_online_m"] = metrics.ate_rmse(p, u)
            if finished:
                final = np.asarray(mapper.graph.poses[:len(u)], np.float64)
                record["ate_final_m"] = metrics.ate_rmse(final, u)
                record["ate_final_aligned_m"] = metrics.ate_rmse_aligned(
                    final, u)
                record["odom_ate_m"] = metrics.ate_rmse(
                    np.asarray(bag.odom[:n]), truth[:n])
        with open(out, "w") as fh:
            json.dump(record, fh)

    for t in range(n):
        msg, odom = bag[t]
        res = mapper.process_scan(msg, odom)
        accepted.append(bool(res.accepted))
        if res.accepted:
            est.append(res.pose if res.pose is not None else res.pose_future)
            used.append(truth[t])
        held.append(int(np.asarray(mapper.graph.constraint_switchable,
                                   bool).sum()))
        if (t + 1) % 100 == 0:
            write(False)
            print(f"{arm}: {t + 1} scans, {held[-1]} closures, "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)
    mapper.flush()
    mapper.loop_closure()
    write(True)
    print(json.dumps({k: v for k, v in record.items()
                      if k not in ("accepted", "closures_held",
                                   "closures")}), flush=True)
    return 0


def first_difference(a: list, b: list):
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return None if len(a) == len(b) else n


def compare(path_a: str, path_b: str) -> int:
    with open(path_a) as fh:
        a = json.load(fh)
    with open(path_b) as fh:
        b = json.load(fh)
    out = {}
    for r in (a, b):
        out[r["arm"]] = {k: r.get(k) for k in (
            "scans_done", "finished", "seconds", "ate_online_m",
            "ate_final_m", "ate_final_aligned_m", "odom_ate_m",
            "optimizations", "loop_closures_rejected")}
        out[r["arm"]]["closures"] = len(r["closures"])
    out["first_scan_accept_differs"] = first_difference(a["accepted"],
                                                        b["accepted"])
    out["first_scan_closures_differ"] = first_difference(a["closures_held"],
                                                         b["closures_held"])
    i = first_difference(a["closures"], b["closures"])
    out["first_closure_differs"] = None if i is None else {
        "index": i, a["arm"]: (a["closures"][i:i + 1] or [None])[0],
        b["arm"]: (b["closures"][i:i + 1] or [None])[0]}
    print(json.dumps(out))
    return 0


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["compare"]:
        return compare(args[1], args[2])
    scans = 10 ** 9
    if "--scans" in args:
        scans = int(args[args.index("--scans") + 1])
    return run_arm(args[0], args[1], scans)


if __name__ == "__main__":
    sys.exit(main())
