"""The benchmark's harness: one run of one cell, from the manifest.

A run is one process: set-up (the port loaded, the cell's inputs made from
the seed, one untimed warm pass that builds and loads every kernel the
window uses), the timed window of ``--seconds``, then, with the program's
state freed, the reference's comparison that decides ``correct``, and the
result as the last line of standard output.

Everything that belongs to one configuration, traffic mix, driver or
metric is a file of its own, found by the name the manifest gives it:

* ``configs/<config>.json`` (the manifest's ``file``): the deployment;
* ``traffic/<traffic>.json``: the mix's parameters, its ``driver`` and the
  limits of its comparisons;
* ``drivers/<driver>.py``: ``setup(ctx)``, ``window(state, seconds)`` and
  ``check(state)``;
* ``metrics/<metric>.py``: ``read(run)``, the metric's value from the run
  record, or None where the run has nothing for it to read.

``run(...)`` takes the benchmark's root and the device, so a test can run
a cell of its own files on the CPU.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
import types
from typing import Optional

from portbench import guard

HERE = os.path.dirname(os.path.abspath(__file__))


class Refused(Exception):
    """A run that must print no result: its message goes to stderr."""


def load_module(path: str, name: str) -> types.ModuleType:
    """The Python file at ``path`` as a module (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """The manifest under ``root`` (the checkout) and the files it names,
    looked up in ``dirs`` in order (the benchmark's folder last)."""

    def __init__(self, root: str, dirs=()):
        self.root = root
        self.dirs = tuple(dirs) + (HERE,)
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.manifest = json.load(fh)

    def find(self, kind: str, name: str, ext: str) -> str:
        for d in self.dirs:
            path = os.path.join(d, kind, name + ext)
            if os.path.isfile(path):
                return path
        raise Refused(f"no {kind}/{name}{ext} in {', '.join(self.dirs)}")

    def workload(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise Refused(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.manifest["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as fh:
                    return json.load(fh)
        raise Refused(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(self.find("traffic", name, ".json")) as fh:
            return json.load(fh)

    def driver(self, name: str) -> types.ModuleType:
        return load_module(self.find("drivers", name, ".py"),
                           f"portbench_driver_{name}")

    def metric(self, name: str) -> types.ModuleType:
        return load_module(self.find("metrics", name, ".py"),
                           f"portbench_metric_{name.replace('.', '_')}")

    def metrics_of(self, cell: str, traced: bool) -> list:
        """The manifest's metric entries a run of ``cell`` reports: its
        end-to-end ones untraced, its per-layer ones traced."""
        ends = [m for m in self.manifest["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]
        if not traced:
            return ends
        moved = {m["name"] for m in ends}
        return [m for m in self.manifest["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in moved
                                 else [])]


class Context:
    """What a driver's set-up is handed."""

    def __init__(self, bench: Bench, cell: str, seed: int, device,
                 traced: bool):
        w = bench.workload(cell)
        self.cell = cell
        self.seed = int(seed)
        # Inputs that do not depend on the seed are kept here, inside the
        # checkout, once made.
        self.cache = os.path.join(bench.root, ".portbench_cache")
        self.device = device
        self.traced = traced
        self.config = bench.config(w["config"])
        self.traffic = bench.traffic(w["traffic"])
        self.driver = bench.driver(self.traffic["driver"])


class RunRecord:
    """The window's measurements, which the metric readers read."""

    def __init__(self):
        self.setup_s = 0.0
        self.window_s = 0.0
        self.counts: dict = {}     # solves, attempted, failed
        self.launches: dict = {}   # counter -> launches in the window
        self.trace = None          # trace.Summary of a traced window
        self.extra: dict = {}


def check_device(device, chips: int) -> None:
    import torch
    if device.type != "cuda":
        return
    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise Refused(f"{torch.cuda.device_count()} CUDA devices, the cell "
                      f"asks for {chips}")


def device_info(device, chips: int) -> dict:
    import torch
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    device))}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": 0}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return r.stdout.strip() or "not read"


def report_trace(rec: RunRecord, device) -> None:
    """A traced run's earlier stderr lines: the kernels the trace holds
    against the launches the port counted (the profiler has dropped device
    records before), and the card's power limit beside the rooflines."""
    counted = sum(rec.launches.values())
    held = rec.trace.kernels
    note = (f"; {counted - held} launches missing from the trace"
            if held < counted else "")
    print(f"portbench: trace holds {held} kernels and {rec.trace.copies} "
          f"copies; the port counted {counted} launches{note}",
          file=sys.stderr)
    if device.type == "cuda":
        print(f"portbench: card {power_limit()}", file=sys.stderr)


def run(root: str, cell: str, seed: int, seconds: float, traced: bool,
        device, started: float, dirs=()) -> dict:
    """One run of ``cell``; returns the result's dict (the last line).
    ``dirs``: folders searched for the cell's files before the
    benchmark's own."""
    bench = Bench(root, dirs)
    chips = int(bench.workload(cell)["chips"])
    check_device(device, chips)
    ctx = Context(bench, cell, seed, device, traced)
    entries = bench.metrics_of(cell, traced)
    readers = {m["name"]: bench.metric(m["name"]) for m in entries}
    state = ctx.driver.setup(ctx)
    # The inputs made in set-up stay for the whole run: out of the garbage
    # collector's sight, as a deployment's heap would not hold them.
    gc.collect()
    gc.freeze()
    rec = RunRecord()
    rec.setup_s = time.perf_counter() - started
    ctx.driver.window(state, float(seconds), rec)
    gc.unfreeze()
    dev = device_info(device, chips)
    if traced:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        report_trace(rec, device)
    t_check = time.perf_counter()
    comparisons = ctx.driver.check(state)
    print(f"portbench: set-up {rec.setup_s:.3f} s, window {rec.window_s:.3f}"
          f" s, reference {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    metrics = {}
    for m in entries:
        value = readers[m["name"]].read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = guard.forbidden_modules()
    if found:
        raise Refused("forbidden modules loaded: " + ", ".join(found))
    correct = all(c["value"] <= c["limit"] for c in comparisons)
    out = {"correct": correct,
           "attempted": int(rec.counts.get("attempted", 0)),
           "failed": int(rec.counts.get("failed", 0)),
           "metrics": metrics, "device": dev}
    if traced and rec.trace is not None:
        out["breakdown"] = rec.trace.breakdown()
    out["compared"] = {c["name"]: {"value": finite(c["value"]),
                                   "limit": c["limit"]}
                       for c in comparisons}
    return out


def finite(x: float) -> float:
    """A compared number as JSON can carry it (inf as a large float)."""
    return x if math.isfinite(x) else 1e300


def main(argv=None, started: Optional[float] = None) -> int:
    import argparse
    started = time.perf_counter() if started is None else started
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.path.dirname(HERE)
    try:
        import torch
        out = run(root, args.workload, args.seed, args.seconds,
                  bool(args.trace), torch.device("cuda"), started)
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    for name, c in out["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out, allow_nan=False))
    return 0
