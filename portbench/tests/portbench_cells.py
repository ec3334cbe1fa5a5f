"""Cells for the benchmark's CPU tests: the real manifest plus a small cell
of the test configuration in ``data/`` (1,500-pose city graphs on the
solver's PCG path), written to a temporary checkout root.  The cell uses
the real traffic file's driver and limits, with fewer graphs."""

from __future__ import annotations

import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# cell -> (configuration file, traffic it copies, traffic overrides)
CELLS = {
    "tiny.batch": ("city10k.batch", "city_tiny", "batch", {"graphs": 2}),
}


def traffic(name: str) -> dict:
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as fh:
        return json.load(fh)


def make_root(tmp: str) -> str:
    """A checkout root under ``tmp`` whose manifest adds the test cells;
    their traffic files go to ``tmp/traffic``."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        m = json.load(fh)
    for c in m["configs"]:
        c["file"] = os.path.join(REPO, c["file"])
    for name in ("city_tiny",):
        path = os.path.join(HERE, "data", f"{name}.json")
        m["configs"].append({"name": name, "source": "test data",
                             "file": path, "reduced": [], "why": "CPU tests"})
    os.makedirs(os.path.join(tmp, "traffic"), exist_ok=True)
    for cell, (real, config, base, extra) in CELLS.items():
        t = dict(traffic(base), **extra)
        tname = cell.replace(".", "_")
        with open(os.path.join(tmp, "traffic", f"{tname}.json"), "w") as fh:
            json.dump(t, fh)
        m["workloads"].append({"name": cell, "config": config,
                               "traffic": tname, "chips": 1,
                               "why": "CPU tests"})
        for e in m["end_to_end"] + m["per_layer"]:
            if real in e.get("workloads", []):
                e["workloads"].append(cell)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as fh:
        json.dump(m, fh)
    return tmp


def run(root: str, cell: str, seed: int = 3, seconds: float = 0.0,
        traced: bool = False) -> dict:
    """One run of a cell on the CPU (the kernels' plain twins)."""
    from portbench import bench
    return bench.run(root, cell, seed, seconds, traced, torch.device("cpu"),
                     time.perf_counter(), dirs=(root,))
