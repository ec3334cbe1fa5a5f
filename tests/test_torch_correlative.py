"""The port's correlative matcher (kernel K11's twins) against
ndt_2d_tpu/matching/correlative.py.

Values against op-by-op JAX (``jax.disable_jit``): the blurred, normalized
field within 1e-6 (the blur and the normalization add in another order
than XLA's convolution), the lattice search's argmin and correction equal
and its score within 1e-5 relative, the point score within 1e-6.  Then the
scenarios of tests/test_correlative.py on ``device="cpu"``: the registry,
an offset recovered, reset, and the end-to-end box mapping with the mapper
(>= 12 of 14 scans, ATE below odometry's and < 0.15 m), which stays
synchronous with ``max_inflight`` set, as the JAX mapper does; localization
and the CLI with ``--scan-matcher-type correlative``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu.matching import correlative as jax_correlative
from ndt_2d_tpu_torch import cli
from ndt_2d_tpu_torch.config import MapperConfig, ScanMatcherConfig
from ndt_2d_tpu_torch.io.bag import record_synthetic, save_bag
from ndt_2d_tpu_torch.kernels import correlative as k11
from ndt_2d_tpu_torch.mapping.mapper import (LOAD_FROM_FILE, SAVE_TO_FILE,
                                             Mapper)
from ndt_2d_tpu_torch.matching import correlative, registry
from ndt_2d_tpu_torch.matching.matcher import _search_offsets
from ndt_2d_tpu_torch.utils import metrics, sim
from port_configs import to_jax

torch.set_num_threads(2)

CFG = ScanMatcherConfig(grid_cells_x=128, grid_cells_y=128)
# 11 x 11 x 11 candidates x 60 beams for the op-by-op JAX lattice.
SMALL = dataclasses.replace(CFG, search_angular_size=0.05,
                            search_angular_resolution=0.01,
                            search_linear_size=0.05,
                            search_linear_resolution=0.01,
                            laser_max_beams=60)
WORLD = sim.make_box_world(10.0, 8.0)


def make_scan(pose, n_beams=360, max_points=512, rng=None):
    msg = sim.scan_at_pose(WORLD, np.asarray(pose, float), n_beams=n_beams,
                           range_max=15.0, noise=0.0 if rng is None else 0.01,
                           rng=rng)
    pts, mask = sim.project_scan(msg, max_points)
    return pts, mask, int(mask.sum())


def window(seed):
    """Three scans around (5, 4) and a query scan, noisy from ``seed``
    (seed None: noise-free, tests/test_correlative.py's window)."""
    rng = None if seed is None else np.random.default_rng(seed)
    poses = np.asarray([[4.8, 3.9, 0.0], [5.0, 4.0, 0.05],
                        [5.2, 4.1, -0.05]], np.float32)
    pts, msk = zip(*[make_scan(p, rng=rng)[:2] for p in poses])
    q = make_scan([5.0, 4.0, 0.0], rng=rng)
    return poses, np.stack(pts), np.stack(msk), q


def port_field(cfg, poses, pts, msk):
    return correlative.build_field(
        cfg, torch.tensor(poses), torch.tensor(pts), torch.tensor(msk),
        torch.ones(len(poses), dtype=torch.bool), 15.0)


def jax_field(cfg, poses, pts, msk):
    with jax.disable_jit():
        return jax_correlative.build_field(
            to_jax(cfg), jnp.asarray(poses), jnp.asarray(pts),
            jnp.asarray(msk), jnp.ones(len(poses), bool), jnp.float32(15.0))


@pytest.mark.parametrize("seed", [None, 0, 1])
def test_build_field_matches_op_by_op_jax(seed):
    poses, pts, msk, _ = window(seed)
    f, o = port_field(CFG, poses, pts, msk)
    jf, jo = jax_field(CFG, poses, pts, msk)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0, atol=1e-6)
    assert float(f.max()) == 1.0


def test_build_field_masks_scans_and_points():
    """A masked scan or point adds no hit; an empty window is all zeros
    (the peak floor of 1e-6 keeps the division finite)."""
    poses, pts, msk, _ = window(None)
    wmask = torch.tensor([True, False, True])
    f, _ = k11.build_field(torch.tensor(poses), torch.tensor(pts),
                           torch.tensor(msk), wmask, 15.0, 0.25, 128, 128)
    with jax.disable_jit():
        jf, _ = jax_correlative.build_field(
            to_jax(CFG), jnp.asarray(poses), jnp.asarray(pts),
            jnp.asarray(msk), jnp.asarray(wmask.numpy()), jnp.float32(15.0))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0, atol=1e-6)
    empty, _ = k11.build_field(torch.tensor(poses), torch.tensor(pts),
                               torch.zeros(msk.shape, dtype=torch.bool),
                               torch.ones(3, dtype=torch.bool), 15.0, 0.25,
                               128, 128)
    assert not empty.any()


@pytest.mark.parametrize("seed,start", [
    (None, [5.03, 3.98, 0.0]), (0, [5.03, 3.98, 0.0]),
    (1, [4.98, 4.03, 0.02])])
def test_match_scan_field_matches_op_by_op_jax(seed, start):
    poses, pts, msk, (qp, qm, qn) = window(seed)
    f, o = port_field(SMALL, poses, pts, msk)
    start = np.asarray(start, np.float32)
    res = correlative.match_scan_field(SMALL, f, o, torch.tensor(qp),
                                       torch.tensor(qm), qn,
                                       torch.tensor(start))
    with jax.disable_jit():
        ref = jax_correlative.match_scan_field(
            to_jax(SMALL), jnp.asarray(f.numpy()), jnp.asarray(o.numpy()),
            jnp.asarray(qp), jnp.asarray(qm), jnp.int32(qn),
            jnp.asarray(start))
    np.testing.assert_array_equal(res.correction.numpy(),
                                  np.asarray(ref.correction))
    assert float(res.score) == pytest.approx(float(ref.score), rel=1e-5)
    np.testing.assert_allclose(res.covariance.numpy(),
                               np.asarray(ref.covariance), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("seed", [None, 0])
def test_score_points_field_matches_op_by_op_jax(seed):
    poses, pts, msk, (qp, qm, qn) = window(seed)
    f, o = port_field(CFG, poses, pts, msk)
    for pose in ([5.0, 4.0, 0.0], [5.1, 3.9, 0.03]):
        pose = np.asarray(pose, np.float32)
        s = correlative.score_points_field(CFG, f, o, torch.tensor(qp),
                                           torch.tensor(qm), qn,
                                           torch.tensor(pose))
        with jax.disable_jit():
            ref = jax_correlative.score_points_field(
                to_jax(CFG), jnp.asarray(f.numpy()), jnp.asarray(o.numpy()),
                jnp.asarray(qp), jnp.asarray(qm), jnp.int32(qn),
                jnp.asarray(pose))
        assert float(s) == pytest.approx(float(ref), rel=0, abs=1e-6)


def test_lattice_rows_equal_one_row_at_a_time():
    """The row axis: each row of ``match_rows`` is its own ``match``."""
    fields, origins, qps, qms, qns, starts = [], [], [], [], [], []
    for seed in (0, 1, 2):
        poses, pts, msk, (qp, qm, qn) = window(seed)
        f, o = port_field(SMALL, poses, pts, msk)
        fields.append(f)
        origins.append(o)
        qps.append(torch.tensor(qp))
        qms.append(torch.tensor(qm))
        qns.append(qn)
        starts.append(torch.tensor([5.02, 3.99, 0.01 * seed]))
    dths, dls = _search_offsets(SMALL, torch.device("cpu"))
    rows = k11.match_rows(SMALL, torch.stack(fields), torch.stack(origins),
                          torch.stack(qps), torch.stack(qms),
                          torch.tensor(qns, dtype=torch.int32),
                          torch.stack(starts), dths, dls)
    for r in range(3):
        one = k11.match(SMALL, fields[r], origins[r], qps[r], qms[r], qns[r],
                        starts[r], dths, dls)
        assert torch.equal(rows[r:r + 1], one)


# --- the scenarios of tests/test_correlative.py ----------------------------

def test_registry_creates():
    m = registry.create("correlative", CFG, 15.0, device="cpu")
    assert type(m).__name__ == "CorrelativeScanMatcher"


def test_recovers_offset():
    poses, pts, msk, (qp, qm, qn) = window(None)
    m = registry.create("correlative", CFG, 15.0, device="cpu")
    m.add_scans(poses, pts, msk)
    res = m.match_scan(qp, qm, qn, np.asarray([5.03, 3.98, 0.0], np.float32))
    assert float(res.score) < -0.3
    np.testing.assert_allclose(res.correction.numpy()[:2], [-0.03, 0.02],
                               atol=0.035)
    sp = float(m.score_points(qp, qm, qn,
                              np.asarray([5.0, 4.0, 0.0], np.float32)))
    assert sp < -0.3


def test_reset():
    m = registry.create("correlative", CFG, 15.0, device="cpu")
    m.reset()
    assert float(m.match_scan(np.zeros((8, 2), np.float32), np.zeros(8, bool),
                              0, np.zeros(3, np.float32)).score) == 0.0
    assert float(m.score_points(np.zeros((8, 2), np.float32),
                                np.zeros(8, bool), 0,
                                np.zeros(3, np.float32))) == 0.0


def box_config(max_inflight=0):
    local = dataclasses.replace(CFG, grid_cells_x=160, grid_cells_y=160,
                                search_linear_size=0.15,
                                search_linear_resolution=0.0075)
    return MapperConfig(scan_matcher_type="correlative",
                        local_scan_matcher=local, global_scan_matcher=CFG,
                        max_points_per_scan=512, loop_closure_every=10**9,
                        max_inflight=max_inflight)


@pytest.mark.parametrize("max_inflight", [0, 4])
def test_end_to_end_mapping(max_inflight):
    """tests/test_correlative.py::test_end_to_end_mapping on the port; a
    correlative local matcher maps synchronously whatever max_inflight
    says (only the NDT matcher pipelines, as in the JAX mapper)."""
    truth = np.stack([np.linspace(3.0, 6.5, 14), np.full(14, 4.0),
                      np.zeros(14)], -1)
    odom = sim.drift_odometry(truth, 0.04, 0.012, seed=3)
    mapper = Mapper(box_config(max_inflight), device="cpu")
    est, tru = [], []
    for t in range(len(truth)):
        msg = sim.scan_at_pose(WORLD, truth[t], n_beams=360, range_max=12.0,
                               noise=0.01, rng=np.random.default_rng(t))
        res = mapper.process_scan(msg, odom[t])
        if res.accepted:
            assert res.pose is not None
            est.append(res.pose)
            tru.append(truth[t])
    assert not mapper._pending
    assert len(est) >= 12
    ate = metrics.ate_rmse(np.asarray(est), np.asarray(tru))
    assert ate < metrics.ate_rmse(odom, truth)
    assert ate < 0.15


def test_localization_in_a_saved_map(tmp_path):
    """Scan-match localization through the generic matcher surface: the
    correlative field of the whole map; the track stays within 0.12 m of
    the map's own poses of the same places."""
    truth = np.stack([np.linspace(3.0, 7.0, 12), np.full(12, 4.0),
                      np.zeros(12)], -1)
    mapper = Mapper(box_config(), device="cpu")
    for t in range(len(truth)):
        mapper.process_scan(sim.scan_at_pose(
            WORLD, truth[t], n_beams=360, range_max=12.0, noise=0.01,
            rng=np.random.default_rng(t)), truth[t])
    path = str(tmp_path / "map.npz")
    mapper.configure(SAVE_TO_FILE, path)
    mapped = mapper.graph.poses.copy()
    cfg = dataclasses.replace(box_config(4), enable_mapping=False)
    loc = Mapper(cfg, device="cpu")
    loc.configure(LOAD_FROM_FILE, path)
    rel = metrics.relative_to_first(truth)
    odom = sim.drift_odometry(truth, 0.01, 0.003, seed=4)
    loc.set_initial_pose(rel[0], np.diag([0.01, 0.01, 0.005]), odom[0])
    errs = []
    for t in range(1, len(truth)):
        res = loc.process_scan(sim.scan_at_pose(
            WORLD, truth[t], n_beams=360, range_max=12.0, noise=0.01,
            rng=np.random.default_rng(100 + t)), odom[t])
        assert res.pose is not None  # the generic branch is synchronous
        errs.append(float(np.hypot(*(res.pose[:2] - mapped[t][:2]))))
    assert type(loc.global_matcher).__name__ == "CorrelativeScanMatcher"
    assert np.mean(errs) < 0.12


def test_cli_scan_matcher_type(tmp_path, capsys):
    bag = record_synthetic("box", 40, n_beams=180, seed=3)
    bag = dataclasses.replace(bag, ranges=bag.ranges[:10],
                              odom=bag.odom[:10], truth=bag.truth[:10])
    path = str(tmp_path / "bag.npz")
    save_bag(bag, path)
    assert cli.main(["run", "--bag", path, "--device", "cpu",
                     "--scan-matcher-type", "correlative",
                     "--local_scan_matcher.grid_cells", "192",
                     "--loop-closure-every", "1000000000"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["scans_accepted"] == 10
    assert stats["graph_constraints"] == 9
    assert np.isfinite(stats["ate_rmse_m"])
