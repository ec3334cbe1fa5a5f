"""The port's overlapping grids (K1, K2, K3 with a grid axis of 4) against
ndt_2d_tpu's ``overlapping_grids`` (tests/test_overlapping.py's semantics).

The stacked build is compared field by field (bitwise: both add the
moments in point order and round once per operation).  K2 candidate scores
run against op-by-op JAX (``jax.disable_jit``) with test_torch_matcher.py's
tolerances: rtol/atol 1e-5 at the lattice angles where both libraries'
float32 cos and sin agree, the same argmin where the best two candidates
are more than 1e-4 |best| apart.  K3 scores agree within 1e-6.

The 30-scan config-8 corridor (overlapping grids and 10 Newton iterations on
both matchers) accepts the same scans as the jitted JAX mapper, with an ATE
within 5 mm of it and below odometry's.  Its corrections are not compared
to the jitted session's: XLA contracts a*b+c into one rounding, which moves
a Newton match by up to 5e-4 m (measured on these scans), and each match
feeds the next window, so the two sessions drift apart by design.  Instead
the port's own matches of scans 2 and 3 are replayed through op-by-op JAX
(``jax.disable_jit``, which rounds as the port does) from the same window
and start pose: corrections within 1e-6, scores within 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu.mapping import runtime as jax_runtime
from ndt_2d_tpu.mapping.mapper import Mapper as JaxMapper
from ndt_2d_tpu.matching import matcher as jax_matcher
from ndt_2d_tpu.ndt import grid as jax_grid
from ndt_2d_tpu_torch import convert
from ndt_2d_tpu_torch.config import MapperConfig, ScanMatcherConfig
from ndt_2d_tpu_torch.io.bag import record_synthetic
from ndt_2d_tpu_torch.kernels import candidate_scores as k2
from ndt_2d_tpu_torch.kernels import ndt_build as k1
from ndt_2d_tpu_torch.kernels import score_points as k3
from ndt_2d_tpu_torch.mapping import runtime
from ndt_2d_tpu_torch.mapping.mapper import Mapper
from ndt_2d_tpu_torch.matching import matcher, registry
from ndt_2d_tpu_torch.ndt import grid as ndt_grid
from ndt_2d_tpu_torch.utils import sim
from port_configs import to_jax

torch.set_num_threads(2)

CFG = ScanMatcherConfig(grid_cells_x=128, grid_cells_y=128)
OCFG = dataclasses.replace(CFG, overlapping_grids=True)
RANGE_MAX = 15.0
FIELDS = ("origin", "mean", "information", "count", "covariance")


def T(x):
    return torch.from_numpy(np.array(x))


def make_scan(pose, world, n_beams=360, max_points=512):
    msg = sim.scan_at_pose(world, np.asarray(pose, float), n_beams=n_beams,
                           range_max=RANGE_MAX)
    pts, mask = sim.project_scan(msg, max_points)
    return pts, mask, int(mask.sum())


def window():
    """The box-world window of tests/test_overlapping.py."""
    world = sim.make_box_world(10.0, 8.0)
    poses = np.asarray([[4.8, 3.9, 0.0], [5.0, 4.0, 0.05],
                        [5.2, 4.1, -0.05]], np.float32)
    scans = [make_scan(p, world) for p in poses]
    return (world, poses, np.stack([s[0] for s in scans]),
            np.stack([s[1] for s in scans]), np.ones(3, bool))


def jax_build(cfg, poses, pts, msk, wm):
    with jax.disable_jit():
        return jax_matcher.build_window_ndt(
            to_jax(cfg), jnp.asarray(poses), jnp.asarray(pts),
            jnp.asarray(msk), jnp.asarray(wm), jnp.float32(RANGE_MAX))


def test_stacked_build_matches_jax_field_by_field():
    _, poses, pts, msk, wm = window()
    grid, tables = matcher.build_window_ndt(OCFG, T(poses), T(pts), T(msk),
                                            T(wm), RANGE_MAX)
    assert matcher.is_multi_grid(grid) and tables.shape == (4, 128 * 128, 32)
    ref = jax_build(OCFG, poses, pts, msk, wm)
    for f in FIELDS:
        want = np.asarray(getattr(ref, f))
        assert getattr(grid, f).shape == want.shape, f
        np.testing.assert_array_equal(getattr(grid, f).numpy(), want)
    ref_tab = jax.vmap(jax_grid.packed_patch_table, in_axes=(0, None))(
        ref, OCFG.grid_cells_x)
    np.testing.assert_array_equal(tables.numpy(), np.asarray(ref_tab))
    # Grid g is the single build at the window origin minus offs[g].
    single, _ = matcher.build_window_ndt(CFG, T(poses), T(pts), T(msk),
                                         T(wm), RANGE_MAX)
    offs = k1.grid_offsets(OCFG.ndt_resolution, "cpu")
    np.testing.assert_array_equal(grid.origin.numpy(),
                                  (single.origin - offs).numpy())
    for f in FIELDS[1:]:
        np.testing.assert_array_equal(getattr(grid, f)[0].numpy(),
                                      getattr(single, f).numpy())
    assert all(int((grid.count[g] >= 5).sum()) > 20 for g in range(4))


def same_trig(theta0, cfg):
    th = (np.float32(theta0) + np.asarray(
        jax_matcher._search_offsets(to_jax(cfg))[0])).astype(np.float32)
    tt = torch.from_numpy(th)
    return ((np.asarray(jnp.cos(th)) == torch.cos(tt).numpy())
            & (np.asarray(jnp.sin(th)) == torch.sin(tt).numpy()))


def test_candidate_scores_are_the_mean_over_grids():
    world, poses, pts, msk, wm = window()
    grid, tables = matcher.build_window_ndt(OCFG, T(poses), T(pts), T(msk),
                                            T(wm), RANGE_MAX)
    pose = np.asarray([5.01, 3.99, 0.004], np.float32)
    qp, qm, n = make_scan([5.0, 4.0, 0.0], world)
    dths, dls = matcher._search_offsets(OCFG, torch.device("cpu"))
    out, cand = k2.match(OCFG, grid, tables, T(qp), T(qm), n, T(pose), dths,
                         dls, with_scores=True)
    res = k2.MatchResult(*(f[0] for f in k2.unpack(out)))
    # The mean of the four single-grid searches, summed from 0.
    spts, smask, _ = matcher.subsample(T(qp), T(qm), n, OCFG.laser_max_beams)
    per = [matcher._candidate_scores_local(OCFG, g, spts, smask, T(pose),
                                           dths, dls, tables[i])
           for i, g in enumerate(ndt_grid.split_grids(grid))]
    assert torch.equal(cand, (((per[0] + per[1]) + per[2]) + per[3]) / 4)
    jgrid = jax_build(OCFG, poses, pts, msk, wm)
    with jax.disable_jit():
        jspts, jsmask, _ = jax_matcher.subsample(
            jnp.asarray(qp), jnp.asarray(qm), jnp.int32(n), 100)
        ref = jax_matcher.candidate_scores(
            to_jax(OCFG), jgrid, jspts, jsmask, jnp.asarray(pose),
            *jax_matcher._search_offsets(to_jax(OCFG)))
        ref_match = jax_matcher.match_scan(
            to_jax(OCFG), jgrid, jnp.asarray(qp), jnp.asarray(qm),
            jnp.int32(n), jnp.asarray(pose), jnp.float32(RANGE_MAX))
    ok = same_trig(pose[2], OCFG)
    assert ok.sum() >= 70
    ref = np.asarray(ref)
    np.testing.assert_allclose(cand.numpy()[ok], ref[ok], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(res.correction.numpy(),
                                  np.asarray(ref_match.correction))
    assert float(res.score) == pytest.approx(float(ref_match.score),
                                             rel=1e-5)


def test_score_points_mean_over_grids_matches_jax():
    world, poses, pts, msk, wm = window()
    grid, _ = matcher.build_window_ndt(OCFG, T(poses), T(pts), T(msk),
                                       T(wm), RANGE_MAX)
    jgrid = jax_build(OCFG, poses, pts, msk, wm)
    qp, qm, n = make_scan([5.0, 4.0, 0.0], world)
    rng = np.random.default_rng(0)
    P = (np.asarray([5.0, 4.0, 0.0])
         + rng.normal(0, [0.05, 0.05, 0.02], (16, 3))).astype(np.float32)
    batch = matcher.score_points_batch(OCFG, grid, T(qp), T(qm), n, T(P))
    for m in range(16):
        one = matcher.score_points_at_pose(OCFG, grid, T(qp), T(qm), n,
                                           T(P[m]))
        assert torch.equal(one, batch[m])
        with jax.disable_jit():
            ref = jax_matcher.score_points_at_pose(
                to_jax(OCFG), jgrid, jnp.asarray(qp), jnp.asarray(qm),
                jnp.int32(n), jnp.asarray(P[m]))
        assert float(one) == pytest.approx(float(ref), abs=1e-6)
    # The beam terms are the grids' mean before the beams are summed.
    g4 = ndt_grid.split_grids(grid)
    single = [k3.score_at_pose(g, 128, 128, 100, T(qp), T(qm), n, T(P[0]))
              for g in g4]
    assert float(batch[0]) == pytest.approx(float(sum(single) / 4),
                                            abs=1e-6)


def test_match_recovers_offset_and_tables_are_optional():
    world, poses, pts, msk, wm = window()
    m = registry.create("ndt", OCFG, RANGE_MAX, device="cpu")
    m.add_scans(poses, pts, msk)
    true_pose = np.asarray([5.0, 4.0, 0.0], np.float32)
    qp, qm, n = make_scan(true_pose, world)
    offset = np.asarray([0.03, -0.02, 0.01], np.float32)
    res = m.match_scan(qp, qm, n, true_pose + offset)
    np.testing.assert_allclose(res.correction.numpy(), -offset, atol=0.011)
    tableless = matcher.match_scan(OCFG, m.grid, T(qp), T(qm), n,
                                   T(true_pose + offset))
    for a, b in zip(res, tableless):
        assert torch.equal(a, b)


def test_convert_round_trips_stacked_grids():
    _, poses, pts, msk, wm = window()
    ref = jax.device_get(jax_matcher.build_window_ndt(
        to_jax(OCFG), poses, pts, msk, wm, np.float32(RANGE_MAX)))
    grid = convert.grid_to_port(ref, "cpu")
    assert grid.mean.shape == (4, 128 * 128, 2) and grid.cell_size == 0.25
    back = jax_grid.NDTGrid(**convert.grid_to_numpy(grid))
    for f in jax_grid.NDTGrid._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(ref, f)))
    tab = jax.device_get(jax.vmap(jax_grid.packed_patch_table,
                                  in_axes=(0, None))(ref, 128))
    np.testing.assert_array_equal(
        convert.table_to_numpy(convert.table_to_port(tab, "cpu")), tab)


def config8():
    """BASELINE config 8 (benchmarks/run_benchmarks.py:139-162):
    config 2 with overlapping grids and 10 Newton iterations on both
    matchers, no loop closure."""
    m = ScanMatcherConfig(grid_cells_x=192, grid_cells_y=192,
                          overlapping_grids=True, refine_iterations=10)
    return MapperConfig(local_scan_matcher=m, global_scan_matcher=m,
                        max_points_per_scan=512, loop_closure_every=10**9)


def test_config8_corridor_matches_jax():
    bag = record_synthetic("corridor", 30, n_beams=600, seed=0)
    cfg = config8()
    mapper = Mapper(cfg, device="cpu")
    results = []
    ours = runtime.run_bag(mapper, bag,
                           progress=lambda t, r: results.append(r))
    ref = jax_runtime.run_bag(JaxMapper(to_jax(cfg)), bag)
    assert ours["scans_accepted"] == ref["scans_accepted"] == 30
    assert ours["graph_constraints"] == ref["graph_constraints"] == 29
    assert abs(ours["ate_rmse_m"] - ref["ate_rmse_m"]) <= 0.005
    assert ours["ate_rmse_m"] < ours["odom_ate_rmse_m"]
    # Newton moves most matches off the lattice.
    corr = np.asarray([r.correction for r in results[1:]])
    lattice = np.asarray([0.005, 0.005, 0.0025])
    off = np.abs(corr / lattice - np.round(corr / lattice)) > 1e-3
    assert off.any(axis=1).mean() >= 0.5
    # Replay scans 2 and 3 through op-by-op JAX from the port's window and
    # start pose.
    g, lc = mapper.graph, cfg.local_scan_matcher
    for t in (2, 3):
        s0 = max(0, t - cfg.rolling_depth)
        win = (g.poses[s0:t].astype(np.float32), g.points[s0:t],
               g.point_mask[s0:t], np.ones(t - s0, bool))
        qp, qm = g.points[t], g.point_mask[t]
        n = int(qm.sum())
        start = (g.poses[t] - results[t].correction).astype(np.float32)
        grid, tab = matcher.build_window_ndt(lc, *map(T, win), RANGE_MAX)
        res = matcher.match_scan(lc, grid, T(qp), T(qm), n, T(start),
                                 packed_table=tab)
        np.testing.assert_array_equal(res.correction.numpy(),
                                      results[t].correction.astype(
                                          np.float32))
        with jax.disable_jit():
            jg = jax_matcher.build_window_ndt(
                to_jax(lc), *map(jnp.asarray, win), jnp.float32(RANGE_MAX))
            jr = jax_matcher.match_scan(
                to_jax(lc), jg, jnp.asarray(qp), jnp.asarray(qm),
                jnp.int32(n), jnp.asarray(start), jnp.float32(RANGE_MAX))
        np.testing.assert_allclose(res.correction.numpy(),
                                   np.asarray(jr.correction), rtol=0,
                                   atol=1e-6)
        assert float(res.score) == pytest.approx(float(jr.score), rel=1e-5)
