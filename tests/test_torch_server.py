"""The port's live streaming runtime (``mapping/server.py``) on the CPU:
tests/test_server.py's scenarios on the port's mapper (scans over a
socket, latched map artifacts, Configure and initialpose on the same
channel, the windowed protocol on the pipelined mapper), and the pieces
its threads rest on (``HostCopy.ready``, ``thread_binder``)."""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ndt_2d_tpu_torch import cli
from ndt_2d_tpu_torch.config import MapperConfig, ScanMatcherConfig
from ndt_2d_tpu_torch.device import HostCopy, thread_binder
from ndt_2d_tpu_torch.io import bag as bag_mod
from ndt_2d_tpu_torch.mapping import server as server_mod
from ndt_2d_tpu_torch.mapping.mapper import Mapper

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(inflight=0):
    m = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
    return MapperConfig(local_scan_matcher=m, global_scan_matcher=m,
                        max_points_per_scan=512, loop_closure_every=10**9,
                        max_inflight=inflight)


def _serve(tmp_path, inflight):
    """A server on a socket named relative to the test's directory (the
    current one): a UNIX socket's path is limited to 108 bytes."""
    mapper = Mapper(_config(inflight), device="cpu")
    sock = "scan.sock"
    pub = str(tmp_path / "pub")
    srv = server_mod.ScanServer(mapper, sock, publish_dir=pub)
    srv.publisher.period = 0.02  # shorten the publish cadence for the test
    return mapper, srv, sock, pub


@pytest.fixture()
def live(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    mapper, srv, sock, pub = _serve(tmp_path, 0)
    yield mapper, srv, sock, pub
    srv.close()


@pytest.fixture()
def live_pipelined(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    mapper, srv, sock, pub = _serve(tmp_path, 8)
    yield mapper, srv, sock, pub
    srv.close()


def _roundtrip(sock_path, req):
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(sock_path)
        f = s.makefile("rwb")
        f.write(json.dumps(req).encode() + b"\n")
        f.flush()
        return json.loads(f.readline())


def _bag_file(tmp_path, n):
    path = str(tmp_path / "bag.npz")
    bag_mod.save_bag(bag_mod.record_synthetic("box", n, n_beams=240, seed=4),
                     path)
    return path


def test_stream_bag_end_to_end(live, tmp_path):
    mapper, srv, sock, pub = live
    last = server_mod.stream_bag(_bag_file(tmp_path, 10), sock)
    assert last["ok"] and last["accepted"]
    assert mapper.graph.num_scans >= 8
    assert len(last["pose"]) == 3 and len(last["map_to_odom"]) == 3
    np.testing.assert_array_equal(last["pose"], mapper.graph.poses[-1])
    assert len(last["scan_times_s"]) == 10
    # Latched artifacts appear on the publish cadence and converge to the
    # final graph (latest wins).
    deadline = time.time() + 10.0
    map_path = os.path.join(pub, "map.npz")
    state_path = os.path.join(pub, "state.json")
    state = None
    while time.time() < deadline:
        if os.path.exists(map_path) and os.path.exists(state_path):
            with open(state_path) as f:
                state = json.load(f)
            if state["nodes"] == mapper.graph.num_scans:
                break
        time.sleep(0.05)
    assert state is not None and state["nodes"] == mapper.graph.num_scans
    assert (np.load(map_path)["data"] == 100).sum() > 10
    assert srv.publisher.publish_count >= 1


def test_configure_and_error_on_same_channel(live):
    mapper, srv, sock, pub = live
    out = _roundtrip(sock, {"action": 2})  # DISABLE_MAPPING
    assert out["ok"] and mapper.enable_mapping is False
    out = _roundtrip(sock, {"action": 1})
    assert out["ok"] and mapper.enable_mapping is True
    out = _roundtrip(sock, {"garbage": True})
    assert out["ok"] is False and "error" in out


def test_initial_pose_message(live):
    mapper, srv, sock, pub = live
    mapper.enable_mapping = False  # localization mode accepts seeds
    mapper.prev_odom_pose_is_initialized = False
    out = _roundtrip(sock, {"initial_pose": [1.0, 2.0, 0.1],
                            "odom": [0.0, 0.0, 0.0]})
    assert out["ok"]
    assert mapper.prev_odom_pose_is_initialized
    np.testing.assert_allclose(mapper.prev_robot_pose, [1.0, 2.0, 0.1])


def test_nan_ranges_survive_json(live):
    mapper, srv, sock, pub = live
    ranges = [1.0, float("nan"), 2.0] * 80
    out = _roundtrip(sock, {
        "ranges": ranges, "angle_min": -np.pi,
        "angle_increment": 2 * np.pi / len(ranges), "range_max": 10.0,
        "odom": [0.0, 0.0, 0.0]})
    assert out["ok"] and out["accepted"]
    assert mapper.graph.point_mask[0].sum() == 160


def test_windowed_stream_delivers_all_poses(live_pipelined, tmp_path):
    """Every deferred scan's pose streams back, equal to the pose that
    drained into the graph."""
    mapper, srv, sock, pub = live_pipelined
    last = server_mod.stream_bag(_bag_file(tmp_path, 12), sock,
                                 windowed=True)
    assert last["ok"] and last["flushed"] == 0
    results = last["results"]
    accepted = mapper.graph.num_scans
    assert accepted >= 10
    # Scan 0 takes the synchronous first-scan path (no future) and some
    # scans may be motion-gated; every other scan streams a result.
    assert len(results) == accepted - 1
    ids = sorted(results)
    got = np.asarray([results[i]["pose"] for i in ids])
    np.testing.assert_array_equal(got, mapper.graph.poses[-len(ids):])
    for r in results.values():
        assert len(r["map_to_odom"]) == 3 and np.isfinite(r["score"])


def test_windowed_gated_scan_does_not_drain(live_pipelined):
    """A motion-gated scan in a windowed stream acks without draining the
    in-flight pipeline."""
    mapper, srv, sock, pub = live_pipelined
    srv.publisher.period = 60.0  # its render would drain the pipeline
    time.sleep(0.2)  # let the publisher enter its long sleep
    bag = bag_mod.record_synthetic("box", 8, n_beams=240, seed=4)
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(sock)
        f = s.makefile("rwb")

        def send(t, odom):
            msg, _ = bag[t]
            f.write(json.dumps({
                "id": t, "windowed": True,
                "ranges": msg.ranges.astype(float).tolist(),
                "angle_min": msg.angle_min,
                "angle_increment": msg.angle_increment,
                "time_increment": msg.time_increment,
                "range_max": msg.range_max,
                "odom": list(map(float, odom)),
            }).encode() + b"\n")
            f.flush()
            while True:
                line = json.loads(f.readline())
                if "result" not in line:
                    return line
        for t in range(6):
            send(t, bag.odom[t])
        assert mapper._pending  # pipeline in flight
        pending_before = len(mapper._pending)
        rep = send(5, bag.odom[5])  # the same odometry: motion-gated
        assert rep["ok"] and rep["accepted"] is False
        assert "map_to_odom" not in rep
        assert len(mapper._pending) == pending_before  # NOT drained


def test_state_json_publishes_unconditionally(live_pipelined):
    """map->odom refreshes on the cadence with no map update (the
    reference broadcasts its TF every 250 ms regardless,
    ndt_mapper.cpp:716-742)."""
    mapper, srv, sock, pub = live_pipelined
    state_path = os.path.join(pub, "state.json")
    deadline = time.time() + 5.0
    while not os.path.exists(state_path) and time.time() < deadline:
        time.sleep(0.02)
    assert os.path.exists(state_path)
    m1 = os.stat(state_path).st_mtime_ns
    assert not mapper.map_update_available
    deadline = time.time() + 5.0
    while time.time() < deadline:
        if os.stat(state_path).st_mtime_ns > m1:
            break
        time.sleep(0.02)
    assert os.stat(state_path).st_mtime_ns > m1
    assert srv.publisher.publish_count == 0


def test_serve_and_feed_verbs(tmp_path):
    """``serve`` in its own process, ``feed --windowed`` against it."""
    sock = "s.sock"  # relative to the processes' directory, tmp_path
    bag = _bag_file(tmp_path, 10)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ndt_2d_tpu_torch.cli", "serve", "--socket",
         sock, "--device", "cpu", "--max-inflight", "4",
         "--local_scan_matcher.grid_cells", "160"],
        stdout=subprocess.PIPE, env=env, cwd=tmp_path)
    try:
        line = json.loads(proc.stdout.readline())
        assert line["serving"] == sock
        out = subprocess.run(
            [sys.executable, "-m", "ndt_2d_tpu_torch.cli", "feed", "--bag",
             bag, "--socket", sock, "--windowed"],
            capture_output=True, text=True, env=env, cwd=tmp_path,
            timeout=120)
        assert out.returncode == 0, out.stderr
        last = json.loads(out.stdout.strip().splitlines()[-1])
        assert last["ok"] and last["results"] >= 8
        assert last["scan_ms_median"] > 0
    finally:
        proc.terminate()
        assert proc.wait(timeout=30) == 0
    assert not os.path.exists(tmp_path / sock)


def test_server_imports_no_matplotlib():
    code = ("import sys, ndt_2d_tpu_torch.mapping.server, "
            "ndt_2d_tpu_torch.cli; "
            "assert 'matplotlib' not in sys.modules, 'matplotlib'")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=dict(os.environ, PYTHONPATH=ROOT))


def test_host_copy_ready_and_thread_binder():
    """On the CPU a copy is ready at once and the binder does nothing;
    ``cli.main`` ignores neither."""
    copy = HostCopy(torch.arange(6, dtype=torch.float32))
    assert copy.ready() and copy.future(slice(1, 3)).ready()
    np.testing.assert_array_equal(copy.future(slice(1, 3)).result(), [1, 2])
    assert thread_binder(torch.device("cpu"))() is None
    assert cli._build_parser().parse_args(
        ["serve", "--socket", "x"]).device == "cuda"
