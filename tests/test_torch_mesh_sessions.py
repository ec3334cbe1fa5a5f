"""Whole port sessions on a gloo mesh of spawned CPU ranks, held to the JAX
mesh tests' criteria (tests/test_mesh_mapper.py) and, where the mesh path
is exact, to the single-device port bitwise.

* Pipelining (:99-125): 16 box scans synchronously and at max_inflight 4
  on a (2, 1) mesh.  Each mesh arm's graph equals the same single-device
  arm's bitwise (no solve runs), and so does the occupancy grid of the
  synchronous map (:127-146).  The pipelined and synchronous arms are held
  to each other within the port's pipelined bound, 0.03 m
  (tests/test_torch_pipelined.py), not JAX's 1e-4: the port's
  single-device arms part by one 0.005 m lattice step at scan 14.  The
  port rounds each lattice offset twice (product, then sum), as JAX's
  op-by-op mode does, where XLA's compiled program rounds once (a fused
  multiply-add), so some offsets differ by an ulp; the synchronous pose
  chain drifts from JAX's by ~3e-8, and scan 14's match is so near a tie
  that JAX's own match leaves its candidate for 4 of 30 input moves of
  that size (tests/test_torch_box_arms.py, which also shows all four arms
  equal with the offsets rounded once).
* Particle filter and scan-match localization (:199-270) on a (1, 2) and a
  (2, 1) mesh: more than 5 scans, mean error below 0.15 m and 0.12 m, and
  the poses equal to the single-device port's bitwise (the same seed, and
  a sharded measurement or match equal to the unsharded one).
* Decisions against JAX's own mesh (conftest's 8 CPU devices): the 30-scan
  revisiting box with loop closure every 5 scans and optimization,
  mapped by the JAX mesh Mapper and by the port's (2, 2) mesh, accept the
  same scans and make the same confirmation decisions.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from ndt_2d_tpu.io import bag as jax_bag
from ndt_2d_tpu.mapping import runtime as jax_runtime
from ndt_2d_tpu.mapping.mapper import Mapper as JaxMapper
from ndt_2d_tpu.parallel import mesh as jax_mesh
from port_configs import to_jax

import torch_mesh_ranks as ranks

torch.set_num_threads(1)


def _beside(scenario, shape, tmp_path, arg=None, single=None):
    """The scenario's per-rank results on a ``shape`` mesh, and ``single()``
    computed in this process while the ranks run."""
    box = {}
    th = threading.Thread(target=lambda: box.update(out=ranks.run_ranks(
        scenario, str(tmp_path), *shape, arg)))
    th.start()
    try:
        ref = single() if single else None
    finally:
        th.join()
    if "out" not in box:
        raise RuntimeError(f"the {scenario} ranks failed")
    return box["out"], ref


def test_mesh_pipelining_matches_mesh_sync(tmp_path):
    runs, single = _beside("pipelined", (2, 1), tmp_path,
                           single=ranks.pipelined_session)
    for res in runs:
        assert len(res["poses0"]) == len(res["poses4"]) == 16
        np.testing.assert_allclose(res["poses4"], res["poses0"], atol=0.03)
        np.testing.assert_array_equal(res["poses4"], single["poses4"])
        np.testing.assert_array_equal(res["poses0"], single["poses0"])
        np.testing.assert_array_equal(res["grid"], single["grid"])
        np.testing.assert_allclose(res["grid_origin"], single["grid_origin"])
        assert not res["imported_reference"]


@pytest.mark.parametrize("kind,shape,bound", [("pf", (1, 2), 0.15),
                                              ("sm", (2, 1), 0.12)])
def test_mesh_localization(tmp_path, kind, shape, bound):
    single_dir = tmp_path / "single"
    single_dir.mkdir()
    runs, single = _beside(
        "localize", shape, tmp_path, kind,
        lambda: ranks.localize_session(
            kind, map_path=str(single_dir / "map.npz")))
    for res in runs:
        errs = res["errors"]
        assert len(errs) > 5
        assert np.mean(errs) < bound
        np.testing.assert_array_equal(res["poses"], single["poses"])
        assert not res["imported_reference"]


def test_decisions_match_the_jax_mesh(tmp_path):
    def jax_run():
        mapper = JaxMapper(to_jax(ranks.BOX_CONFIG),
                           mesh=jax_mesh.make_mesh(jax.device_count()))
        stats = jax_runtime.run_bag(mapper, jax_bag.record_synthetic(
            "box", 30, n_beams=600, seed=0))
        return stats, [(int(d[0]), int(d[1]), bool(d[4]))
                       for d in mapper.lc_log["decisions"]]

    runs, (stats, decisions) = _beside("box", (2, 2), tmp_path,
                                       single=jax_run)
    assert stats["loop_closures"] >= 1
    for res in runs:
        assert int(res["accepted"]) == stats["scans_accepted"] == 30
        assert int(res["closures"]) == stats["loop_closures"]
        assert [(int(q), int(c), bool(a))
                for q, c, a in res["decisions"]] == decisions
        np.testing.assert_array_equal(res["poses"], runs[0]["poses"])
