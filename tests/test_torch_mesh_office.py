"""test_office_loop_matches_single_device (tests/test_mesh_mapper.py:63-97)
on the port: the revisiting office ring (151 scans, 600 beams, drifting
odometry, loop closure every 15 scans with the 0.85 gate, 3-scan regions
and Geman-McClure, optimization after 10 new nodes) mapped by the
single-device port and by a (2, 1) gloo mesh of spawned CPU ranks, with
radius loop search.  JAX's criteria: at least one closure, equal scan
counts, at least one optimization on the mesh, ATE within 0.08 m of the
single-device run and below 0.3 m.  Beyond them: every rank holds the
same graph bitwise.  The descriptor arm is
tests/test_torch_mesh_descriptor.py.
"""

import torch

from test_torch_mesh_sessions import _beside
import torch_mesh_ranks as ranks

torch.set_num_threads(1)


def check_office(runs, single):
    assert single["closures"] >= 1, "scenario must fire loop closures"
    for res in runs:
        assert res["closures"] >= 1
        assert res["num_scans"] == single["num_scans"]
        assert res["optimizations"] >= 1
        assert abs(float(res["ate"]) - float(single["ate"])) < 0.08
        assert float(res["ate"]) < 0.3
        assert (res["poses"] == runs[0]["poses"]).all()
        assert not res["imported_reference"]


def test_office_loop_matches_single_device_radius(tmp_path):
    check_office(*_beside("office", (2, 1), tmp_path, "radius",
                          lambda: ranks.office_session("radius")))
