"""The port's host verbs beside the JAX package's: the rosbag2 map codec
(``io/rosbag2.py``) against the reference's hand-assembled and frozen
blobs, with maps exported by either package imported by the other; the
``info`` line; the ``viz`` picture; and ``device_trace``'s trace."""

import json
import os

import numpy as np
import pytest

import test_rosbag2 as ref_tests
from ndt_2d_tpu import cli as jax_cli
from ndt_2d_tpu.graph.pose_graph import Graph as JaxGraph
from ndt_2d_tpu.io import rosbag2 as jax_rosbag2
from ndt_2d_tpu.io import serialization as jax_serialization
from ndt_2d_tpu.utils import viz as jax_viz
from ndt_2d_tpu_torch import cli
from ndt_2d_tpu_torch.graph.pose_graph import Graph
from ndt_2d_tpu_torch.io import rosbag2, serialization
from ndt_2d_tpu_torch.utils import profiling, viz

FROZEN = ref_tests.TestFrozenHexGoldens


def _graph(cls, n_scans=5, n_points=16, n_constraints=4, max_points=32):
    """tests/test_rosbag2.py's graph, in either package's ``Graph``."""
    rng = np.random.default_rng(3)
    g = cls(max_points, True)
    for i in range(n_scans):
        pts = np.zeros((max_points, 2), np.float32)
        mask = np.zeros(max_points, bool)
        k = n_points - i
        pts[:k] = rng.normal(0, 2.0, (k, 2))
        mask[:k] = True
        g.add_scan(rng.normal(0, 1.0, 3), pts, mask)
    for j in range(n_constraints):
        g.add_constraint(j, j + 1, rng.normal(0, 0.1, 3),
                         np.diag(rng.uniform(1, 100, 3)), switchable=j % 2)
    return g


def _same_graph(a, b):
    assert (a.num_scans, a.num_constraints) == (b.num_scans,
                                                b.num_constraints)
    for name in ("poses", "points", "point_mask", "constraint_begin",
                 "constraint_end", "constraint_transform",
                 "constraint_information", "constraint_switchable"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


@pytest.mark.parametrize("case", ["scan", "empty_scan", "constraint"])
def test_encoders_equal_the_frozen_and_hand_assembled_blobs(case):
    if case == "scan":
        args = (7, [1.5, -2.25, 0.75], [[0.5, 0.25], [-1.0, 2.0]])
        blob, hexed = rosbag2.encode_scan(*args), FROZEN.SCAN_HEX
        assert blob == ref_tests._golden_scan_blob()
        assert blob == jax_rosbag2.encode_scan(*args)
    elif case == "empty_scan":
        args = (1, [0.5, -0.5, 0.25], [])
        blob, hexed = rosbag2.encode_scan(*args), FROZEN.EMPTY_SCAN_HEX
        assert len(blob) == 4 + 68
        assert blob == jax_rosbag2.encode_scan(*args)
    else:
        args = (3, 9, [0.1, -0.2, 0.05], np.arange(1.0, 10.0).reshape(3, 3),
                True)
        blob, hexed = rosbag2.encode_constraint(*args), FROZEN.CONSTRAINT_HEX
        assert blob == ref_tests._golden_constraint_blob()
        assert blob == jax_rosbag2.encode_constraint(*args)
    assert blob.hex() == hexed


def test_decoders_read_the_frozen_blobs():
    sid, pose, pts = rosbag2.decode_scan(bytes.fromhex(FROZEN.SCAN_HEX))
    assert sid == 7
    np.testing.assert_array_equal(pose, [1.5, -2.25, 0.75])
    np.testing.assert_array_equal(pts, [[0.5, 0.25], [-1.0, 2.0]])
    sid, pose, pts = rosbag2.decode_scan(bytes.fromhex(
        FROZEN.EMPTY_SCAN_HEX))
    assert sid == 1 and pts.shape == (0, 2)
    b, e, t, info, sw = rosbag2.decode_constraint(
        bytes.fromhex(FROZEN.CONSTRAINT_HEX))
    assert (b, e, sw) == (3, 9, True)
    np.testing.assert_array_equal(t, [0.1, -0.2, 0.05])
    np.testing.assert_array_equal(info, np.arange(1.0, 10.0).reshape(3, 3))
    with pytest.raises(ValueError, match="little-endian"):
        rosbag2.decode_scan(b"\x00\x00\x00\x00" + bytes.fromhex(
            FROZEN.SCAN_HEX)[4:])


@pytest.mark.parametrize("exporter", ["port", "jax"])
def test_maps_cross_the_rosbag2_boundary(tmp_path, exporter):
    """A map exported by one package imports in the other, equal to the
    one the exporting package imports back; the storage files are the
    same bytes."""
    ours, theirs = _graph(Graph), _graph(JaxGraph)
    d_ours, d_theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    rosbag2.export_map(ours, d_ours)
    jax_rosbag2.export_map(theirs, d_theirs)
    assert rosbag2.read_messages(d_ours) == jax_rosbag2.read_messages(
        d_theirs)
    src = d_ours if exporter == "port" else d_theirs
    for cap in (32, 8):  # the exporter's capacity, and a truncating one
        _same_graph(rosbag2.import_map(src, cap),
                    jax_rosbag2.import_map(src, cap))


def test_cli_round_trip_and_info_equal_the_reference(tmp_path, capsys):
    g = _graph(Graph)
    native = str(tmp_path / "map.npz")
    serialization.save_graph(g, native)
    bag_dir = str(tmp_path / "refbag")
    assert cli.main(["export-rosbag2", "--map", native, "--out",
                     bag_dir]) == 0
    back = str(tmp_path / "back.npz")
    assert cli.main(["import-rosbag2", "--bag", bag_dir, "--out", back,
                     "--max-points", "32"]) == 0
    _same_graph(serialization.load_graph(back, 32),
                jax_serialization.load_graph(back, 32))
    capsys.readouterr()
    assert cli.main(["info", "--map", native]) == 0
    ours = capsys.readouterr().out.strip().splitlines()[-1]
    assert jax_cli.main(["info", "--map", native]) == 0
    theirs = capsys.readouterr().out.strip().splitlines()[-1]
    assert ours == theirs
    assert json.loads(ours)["scans"] == 5


def test_occupancy_image_equals_the_reference():
    data = np.random.default_rng(1).choice(
        np.asarray([-1, 0, 100, 37], np.int8), size=(23, 31))
    img = viz.occupancy_to_image(data)
    np.testing.assert_array_equal(img, jax_viz.occupancy_to_image(data))
    assert img.dtype == np.uint8 and img[0, 0] == {
        -1: 205, 0: 254, 100: 0, 37: 205}[int(data[-1, 0])]


def test_viz_writes_pngs(tmp_path, capsys):
    g = _graph(Graph)
    native = str(tmp_path / "map.npz")
    serialization.save_graph(g, native)
    out = str(tmp_path / "map.png")
    assert cli.main(["viz", "--map", native, "--render-grid", "--device",
                     "cpu", "--out", out]) == 0
    assert json.loads(capsys.readouterr().out)["scans"] == 5
    session = str(tmp_path / "session.png")
    viz.save_graph_png(g, session, particles=np.zeros((4, 3)),
                       truth=g.poses)
    for path in (out, session):
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import torch
    d = str(tmp_path / "trace")
    with profiling.device_trace(d):
        torch.ones(64).cumsum(0)
    with open(os.path.join(d, profiling.TRACE_FILE)) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::cumsum" in names
