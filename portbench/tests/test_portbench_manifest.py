"""BENCHMARK.json keeps the contract, every name resolves to its files,
and a cell and a metric can be added with new files alone."""

import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest

import portbench_cells as cells
from portbench import bench, roofline

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(cells.REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_manifest_keeps_the_contract(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "portbench/run.py"]
    assert manifest["paths"] == ["portbench"]
    seconds = manifest["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    # A full check of 24 cells fits its 43,200 seconds.
    assert (2 + 14 * 24) * (seconds + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert c["reduced"] == [] and 1 <= len(c["why"]) <= 200
        names.add(c["name"])
    cellnames = set()
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        cellnames.add(w["name"])
    ends = {}
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        ends[m["name"]] = m
    assert "setup_s" in ends and "workloads" not in ends["setup_s"]
    for m in manifest["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in ends and m["source"] in SOURCES
        for w in m["workloads"]:
            assert w in ends[m["moves"]].get("workloads", cellnames)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cellnames
    b = bench.Bench(cells.REPO)
    for cell in cellnames:
        untraced = [m["name"] for m in b.metrics_of(cell, False)]
        assert "setup_s" in untraced and len(untraced) >= 2
        assert b.metrics_of(cell, True)


def test_every_cell_and_metric_resolves_by_name(manifest):
    b = bench.Bench(cells.REPO)
    for w in manifest["workloads"]:
        ctx = bench.Context(b, w["name"], 1, None, False)
        for f in ("setup", "window", "check"):
            assert callable(getattr(ctx.driver, f))
        assert "limits" in ctx.traffic
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        reader = b.metric(m["name"])
        assert reader.SOURCE == m["source"] and callable(reader.read)


def test_the_pcg_launch_moves_the_bytes_its_padded_shapes_hold():
    # City10000: 10,000 nodes pad to 16,384, 20,687 constraints to 32,768.
    n, c, live = 16384, 32768, 20687
    reads = (2 * c * 4              # begin, end
             + 3 * c * 9 * 4        # Baa, Bab, Bbb
             + 2 * n * 9 * 4        # D and its block-Jacobi inverse
             + 4 + n * 4            # lam, the free mask
             + n * 3 * 4            # the right-hand side
             + 2 * (n + 1) * 4      # the incidence lists' offsets
             + 2 * live * 4)        # and their live constraints
    writes = n * 3 * 4 + 4          # the step, the count of CG steps
    assert roofline.pcg_solve_bytes(10_000, 20_687) == reads + writes
    assert math.isclose(roofline.bound_s(reads + writes),
                        (reads + writes) / 3.35e12)
    assert roofline.share(1.0, 0.0) is None


def _sources() -> dict:
    """Every file of the benchmark (compiled caches aside) by its bytes."""
    out = {}
    for dp, dirs, fs in os.walk(cells.BENCH):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in fs:
            with open(os.path.join(dp, f), "rb") as fh:
                out[os.path.join(dp, f)] = hashlib.sha256(fh.read()).digest()
    return out


def test_a_cell_and_a_metric_are_added_with_new_files_alone(tmp_path):
    before = _sources()
    root = cells.make_root(str(tmp_path))
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        m = json.load(fh)
    m["workloads"].append({"name": "tiny.again", "config": "city_tiny",
                           "traffic": "again", "chips": 1, "why": "test"})
    m["end_to_end"][[e["name"] for e in m["end_to_end"]].index(
        "solve_ms")]["workloads"].append("tiny.again")
    m["per_layer"].append({"name": "solves.tiny", "unit": "count",
                           "better": "higher", "source": "program_counter",
                           "layer": "Solver", "moves": "solve_ms",
                           "workloads": ["tiny.again"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(m, fh)
    with open(os.path.join(root, "traffic", "again.json"), "w") as fh:
        json.dump(cells.traffic("batch"), fh)
    os.makedirs(os.path.join(root, "metrics"))
    with open(os.path.join(root, "metrics", "solves.tiny.py"), "w") as fh:
        fh.write('SOURCE = "program_counter"\n\n\ndef read(run):\n'
                 '    return run.counts.get("solves")\n')
    out = cells.run(root, "tiny.again", traced=True)
    assert out["metrics"]["solves.tiny"]["value"] >= 1
    assert _sources() == before


def test_the_result_line_has_the_contracts_keys(tmp_path):
    root = cells.make_root(str(tmp_path))
    out = cells.run(root, "tiny.batch")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "compared"]
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["metrics"]) == {"solve_ms", "setup_s"}
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    traced = cells.run(root, "tiny.batch", traced=True)
    assert list(traced) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "compared"]
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(out, allow_nan=False)


def _run_py(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "city10k.batch",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300)


def test_a_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = _run_py(cells.REPO)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(os.path.join(cells.REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(cells.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run_py(str(tmp_path))
    assert r.returncode != 0 and r.stdout.strip() == ""
    # Without a card check in the way, the missing program still stops it.
    code = ("import sys, time, torch; sys.path.insert(0, '.'); "
            "from portbench import bench; bench.run('.', 'city10k.batch', 1,"
            " 1.0, False, torch.device('cpu'), time.perf_counter())")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "ndt_2d_tpu_torch" in r.stderr
