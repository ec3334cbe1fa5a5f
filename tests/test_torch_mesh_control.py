"""The control channel on a device mesh (``mapping/runtime.py::
ControlServer(mesh=...)``, ``parallel/distributed.py::broadcast``), on the
CPU.

Two gloo ranks replay an 18-scan box bag (``tests/torch_mesh_ranks.py::
control_session``).  Rank 0's progress callback sends the actions of
``CONTROL_ACTIONS`` over the channel: a save with a filename too long for
a mesh's request, a request of no action after scan 2, mapping off after
scan 3 and on after scan 6, a save after scan 9, a load of that map after
scan 12 and a load of a missing file after scan 14.  The same ranks run the bag again applying the same
actions straight through ``Mapper.configure`` at the same boundaries.
Every value is bitwise: the ranks' graphs are equal to each other and to
the direct run's, so each action landed on every rank at the boundary
the callback meant.
"""

import json
import types

import numpy as np
import pytest
import torch

from ndt_2d_tpu_torch.io import serialization
from ndt_2d_tpu_torch.mapping import runtime
from ndt_2d_tpu_torch.mapping.mapper import Mapper
from ndt_2d_tpu_torch.parallel import distributed

import torch_mesh_ranks as ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mode's two ranks' results and the directory they ran in."""
    out = {}
    for mode in ("socket", "direct"):
        d = str(tmp_path_factory.mktemp(f"control_{mode}"))
        out[mode] = (ranks.run_ranks("control", d, 2, 1, mode), d)
    return out


@pytest.mark.parametrize("mode", ["socket", "direct"])
def test_ranks_bitwise_equal(runs, mode):
    a, b = runs[mode][0]
    for k in ("poses", "counts", "accepted", "enable_mapping"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not any(bool(r["imported_reference"]) for r in (a, b))


def test_socket_equals_direct_configure(runs):
    for sock, direct in zip(runs["socket"][0], runs["direct"][0]):
        for k in ("poses", "counts", "accepted", "enable_mapping"):
            np.testing.assert_array_equal(sock[k], direct[k], err_msg=k)


def test_replies(runs):
    """Rank 0 answered every request: the long filename refused before the
    broadcast, the missing map failing on both ranks, the rest (the request
    of no action too) ok."""
    replies = [json.loads(r) for r in runs["socket"][0][0]["local_replies"]]
    assert len(replies) == len(ranks.CONTROL_ACTIONS)
    refused, *middle, missing = replies
    assert not refused["ok"] and "1104 bytes" in refused["error"]
    assert all(r == {"ok": True} for r in middle)
    assert not missing["ok"] and missing["failed_ranks"] == [0, 1]
    assert "missing.npz" in missing["error"]


def test_request_crosses_a_host_group(runs):
    """Each rank's request is a host tensor carried by the server's own
    gloo group, whatever the mesh's backend."""
    for r in runs["socket"][0]:
        assert list(r["request_on"]) == ["cpu", "gloo"]


def test_mapping_off_between_scans_3_and_6(runs):
    """Scans 4-6 add nothing to the graph; scan 7 on adds again."""
    for r in runs["socket"][0]:
        c = r["counts"]
        assert c[4] == c[5] == c[6] == c[3]
        assert c[8] > c[7] >= c[6]
        assert bool(r["enable_mapping"])


def test_save_written_once_by_rank_0(runs):
    (a, b), d = runs["socket"]
    assert list(a["local_saves"]) == ["map.npz"]
    assert b["local_saves"].size == 0
    saved = serialization.load_graph(f"{d}/map.npz", 512)
    assert saved.num_scans == a["counts"][9]


def test_load_lands_on_every_rank(runs):
    """The load after scan 12 puts each rank's graph back to the saved
    map's scans before scan 13 is mapped."""
    for r in runs["socket"][0]:
        c = r["counts"]
        assert c[12] > c[9]
        assert c[13] <= c[9] + 1


@pytest.mark.parametrize("filename", ["", "map.npz", "ü/карта.npz",
                                      "x" * runtime.FILENAME_ROOM])
def test_request_round_trip(filename):
    t = runtime.pack_request(8, filename)
    assert t.dtype == torch.int32
    assert t.shape == (2 + runtime.FILENAME_ROOM // 4,)
    assert runtime.unpack_request(t) == (8, filename)


def test_long_filename_refused():
    with pytest.raises(ValueError, match="at most 1024"):
        runtime.pack_request(8, "é" * 513)


def test_broadcast_alone_is_identity():
    t = torch.arange(5, dtype=torch.int32)
    assert distributed.broadcast(t) is t
    np.testing.assert_array_equal(t.numpy(), np.arange(5))


def test_one_rank_mesh_serves_as_without_one(tmp_path, monkeypatch):
    """On a mesh of one rank the serving thread applies an action itself,
    and a scan boundary does nothing."""
    monkeypatch.chdir(tmp_path)
    mapper = Mapper(ranks.BOX_CONFIG, device="cpu")
    control = runtime.ControlServer(mapper, "one.sock",
                                    mesh=types.SimpleNamespace(
                                        size=lambda: 1))
    try:
        assert runtime.send_configure("one.sock", 2) == {"ok": True}
        assert not mapper.enable_mapping
        control.at_boundary()
        assert control.pending() == 0
    finally:
        control.close()
