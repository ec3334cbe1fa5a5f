"""The port's NDT grid (K1's and K3's plain twins) against ndt_2d_tpu.ndt.grid.

Inputs are made from a seed with numpy and fed to both packages.  The JAX
grid functions are called as its own tests call them: eagerly, one
float32 rounding per operation, which is the rounding the port's twins and
its kernels (built with -fmad=false) implement.  Tolerances: counts exact;
float fields rtol 1e-5; information rtol 1e-4 on scorable cells, where the
eigenvalue floor amplifies float32 sum-order differences.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu.config import ScanMatcherConfig
from ndt_2d_tpu.matching import matcher as jax_matcher
from ndt_2d_tpu.ndt import grid as jax_grid
from ndt_2d_tpu_torch.kernels import ndt_build, score_points
from ndt_2d_tpu_torch.ndt import grid as ndt_grid

torch.set_num_threads(2)

W = H = 96
CELL = 0.25
RANGE_MAX = 15.0


def random_window(seed, S=6, P=256, heading=False):
    """Poses near (12, 12) and robot-frame points within +-8 m, with some
    masked points and one masked scan.

    Headings are 0 unless ``heading``: float32 cos/sin of the two
    libraries differ by an ulp at some angles, and the covariance's
    (corr - mean^2) cancellation turns that into large relative
    differences, so the build is compared on identical world points and
    the rotation separately (test_transform_points_within_a_few_ulp)."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, (S, 1)) if heading else np.zeros((S, 1))
    poses = np.concatenate([rng.uniform(11.0, 13.0, (S, 2)), th], -1)
    # Clustered points, so that many cells hold >= 5 of them.
    centers = rng.uniform(-8.0, 8.0, (S, 24, 2))
    pts = (centers[:, rng.integers(0, 24, P)]
           + rng.normal(0.0, 0.08, (S, P, 2)))
    pmask = rng.random((S, P)) < 0.9
    wmask = np.ones(S, bool)
    wmask[seed % S] = False
    return (poses.astype(np.float32), pts.astype(np.float32), pmask, wmask)


def jax_window_grid(poses, pts, pmask, wmask):
    origin = jax_matcher.window_origin(
        ScanMatcherConfig(grid_cells_x=W, grid_cells_y=H), jnp.asarray(poses),
        jnp.asarray(wmask), jnp.float32(RANGE_MAX))
    mask = jnp.asarray(pmask) & jnp.asarray(wmask)[:, None]
    return jax_grid.build_ndt_from_scans(jnp.asarray(poses), jnp.asarray(pts),
                                         mask, origin, CELL, W, H)


def assert_grid_close(port: ndt_grid.NDTGrid, ref):
    np.testing.assert_array_equal(port.count.numpy(), np.asarray(ref.count))
    np.testing.assert_allclose(port.origin.numpy(), np.asarray(ref.origin),
                               rtol=1e-5)
    np.testing.assert_allclose(port.mean.numpy(), np.asarray(ref.mean),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(port.covariance.numpy(),
                               np.asarray(ref.covariance), rtol=1e-5, atol=0)
    scorable = np.asarray(ref.count) >= 5
    np.testing.assert_allclose(port.information.numpy()[scorable],
                               np.asarray(ref.information)[scorable],
                               rtol=1e-4, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_build_matches_jax(seed):
    poses, pts, pmask, wmask = random_window(seed)
    grid, table = ndt_build.build_window(
        torch.from_numpy(poses), torch.from_numpy(pts),
        torch.from_numpy(pmask), torch.from_numpy(wmask), RANGE_MAX, CELL, W,
        H)
    ref = jax_window_grid(poses, pts, pmask, wmask)
    assert int((np.asarray(ref.count) >= 5).sum()) > 50
    assert_grid_close(grid, ref)
    np.testing.assert_allclose(
        table.numpy(), np.asarray(jax_grid.packed_patch_table(ref, W)),
        rtol=1e-4, atol=0)


def test_transform_points_within_a_few_ulp():
    """One ulp of cos/sin times a point's range (<= 12 m) moves the result
    by up to a few ulp of the world coordinate."""
    from ndt_2d_tpu.core import pose as jax_pose
    from ndt_2d_tpu_torch.core import pose as pose_ops
    poses, pts, _, _ = random_window(4, heading=True)
    port = pose_ops.transform_points(torch.from_numpy(poses),
                                     torch.from_numpy(pts)).numpy()
    ref = np.asarray(jax_pose.transform_points(jnp.asarray(poses),
                                               jnp.asarray(pts)))
    ulp = np.spacing(np.abs(ref).astype(np.float32))
    assert np.all(np.abs(port - ref) <= 4 * ulp)
    for fn in ("compose", "relative"):
        a = getattr(pose_ops, fn)(torch.from_numpy(poses[:3]),
                                  torch.from_numpy(poses[3:]))
        b = getattr(jax_pose, fn)(jnp.asarray(poses[:3]),
                                  jnp.asarray(poses[3:]))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    inv = pose_ops.inverse(torch.from_numpy(poses)).numpy()
    np.testing.assert_allclose(
        inv, np.asarray(jax_pose.inverse(jnp.asarray(poses))), rtol=1e-6,
        atol=1e-6)
    th = torch.linspace(-10.0, 10.0, 101)
    np.testing.assert_allclose(
        pose_ops.normalize_angle(th).numpy(),
        np.asarray(jax_pose.normalize_angle(jnp.asarray(th.numpy()))),
        atol=1e-6)


def test_packed_patch_table_equal():
    """The patch table laid out from one grid is identical in both."""
    poses, pts, pmask, wmask = random_window(3)
    ref = jax_window_grid(poses, pts, pmask, wmask)
    port = ndt_grid.NDTGrid(
        origin=torch.tensor(np.asarray(ref.origin)),
        cell_size=float(ref.cell_size),
        mean=torch.tensor(np.asarray(ref.mean)),
        information=torch.tensor(np.asarray(ref.information)),
        count=torch.tensor(np.asarray(ref.count)),
        covariance=torch.tensor(np.asarray(ref.covariance)))
    np.testing.assert_array_equal(
        ndt_grid.packed_patch_table(port, W).numpy(),
        np.asarray(jax_grid.packed_patch_table(ref, W)))
    np.testing.assert_array_equal(
        ndt_grid.packed_cell_table(port).numpy(),
        np.asarray(jax_grid.packed_cell_table(ref)))


def test_build_ndt_and_score_points_match_jax():
    rng = np.random.default_rng(7)
    pts = (rng.normal(0.0, 0.3, (600, 2)) + rng.uniform(-3, 3, (1, 2))
           ).astype(np.float32)
    mask = rng.random(600) < 0.95
    origin = np.asarray([-4.0, -4.0], np.float32)
    port = ndt_grid.build_ndt(torch.from_numpy(pts), torch.from_numpy(mask),
                              torch.from_numpy(origin), 0.5, 16, 16)
    ref = jax_grid.build_ndt(jnp.asarray(pts), jnp.asarray(mask),
                             jnp.asarray(origin), 0.5, 16, 16)
    assert_grid_close(port, ref)
    q = (rng.normal(0.0, 0.5, (200, 2)) + pts[:1]).astype(np.float32)
    qm = rng.random(200) < 0.9
    np.testing.assert_allclose(
        ndt_grid.score_points(port, torch.from_numpy(q),
                              torch.from_numpy(qm), 16, 16).numpy(),
        np.asarray(jax_grid.score_points(ref, jnp.asarray(q),
                                         jnp.asarray(qm), 16, 16)),
        rtol=1e-5, atol=1e-7)


def test_segment_sum_in_order_is_sequential():
    """Each segment sums from 0 in index order, like a plain loop."""
    rng = np.random.default_rng(11)
    seg = rng.integers(0, 7, 300)
    vals = rng.normal(0.0, 100.0, (300, 3)).astype(np.float32)
    expect = np.zeros((7, 3), np.float32)
    for s, v in zip(seg, vals):
        expect[s] = expect[s] + v
    got = ndt_grid.segment_sum_in_order(torch.from_numpy(seg),
                                        torch.from_numpy(vals), 7)
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("seed", [0, 1])
def test_score_at_pose_matches_jax(seed):
    """K3's twin against the jitted reference score_points_at_pose."""
    poses, pts, pmask, wmask = random_window(seed)
    poses[:, 2] = 0.0
    cfg = ScanMatcherConfig(grid_cells_x=W, grid_cells_y=H)
    grid, _ = ndt_build.build_window(
        torch.from_numpy(poses), torch.from_numpy(pts),
        torch.from_numpy(pmask), torch.from_numpy(wmask), RANGE_MAX, CELL, W,
        H)
    ref = jax_window_grid(poses, pts, pmask, wmask)
    s = (seed + 1) % poses.shape[0]
    pose = (poses[s] + [0.03, -0.02, 0.0]).astype(np.float32)
    n = int(pmask[s].sum())
    port = score_points.score_at_pose(
        grid, W, H, 100, torch.from_numpy(pts[s]), torch.from_numpy(pmask[s]),
        n, torch.from_numpy(pose))
    want = jax_matcher.score_points_at_pose(
        cfg, ref, jnp.asarray(pts[s]), jnp.asarray(pmask[s]), jnp.int32(n),
        jnp.asarray(pose))
    assert float(port) < -0.05
    assert float(port) == pytest.approx(float(want), abs=1e-6)


def _single_cell(points, width=1, height=1, origin=(0.0, 0.0),
                 cell_size=100.0):
    pts = torch.tensor(points, dtype=torch.float32)
    return ndt_grid.build_ndt(pts, torch.ones(len(points), dtype=torch.bool),
                              torch.tensor(origin, dtype=torch.float32),
                              cell_size, width, height)


def _cell_score(grid, p, width=1, height=1):
    s = ndt_grid.score_points(grid, torch.tensor([p], dtype=torch.float32),
                              torch.ones(1, dtype=torch.bool), width, height)
    return float(s[0])


@pytest.mark.parametrize("point,expect", [
    ((3.5, 3.5), 1.0),
    ((3.5 + math.sqrt(0.008), 3.5), 0.6065),
    ((3.5 + 2 * math.sqrt(0.008), 3.5), 0.1353),
    ((3.5, 3.5 + math.sqrt(0.002)), 0.6065),
    ((3.5, 3.5 + 2 * math.sqrt(0.002)), 0.1353),
    ((0.0, 0.0), 0.0),
])
def test_reference_cell_goldens(point, expect):
    """ndt_model_tests.cpp: scores at the mean, 1 and 2 sigma."""
    g = _single_cell([(3.5, 3.5), (3.5, 3.5), (3.4, 3.45), (3.6, 3.55),
                      (3.6, 3.45), (3.4, 3.55)])
    c00, c01, c11 = g.covariance[0].tolist()
    assert (c00, c01, c11) == pytest.approx((0.008, 0.0, 0.002), abs=1e-3)
    assert _cell_score(g, point) == pytest.approx(expect, abs=1e-3)


def test_reference_grid_likelihood_golden():
    """ndt_model_tests.cpp:229: the 11x11 1 m grid fixture scores 0.7659."""
    pts = torch.tensor([(3.5, 3.5), (3.45, 3.4), (3.55, 3.6), (3.45, 3.6),
                        (3.45, 3.6)], dtype=torch.float32)
    g = ndt_grid.build_ndt(pts, torch.ones(5, dtype=torch.bool),
                           torch.tensor([-5.0, -5.0]), 1.0, 11, 11)
    score = ndt_grid.likelihood(g, torch.tensor([[3.5, 3.5]]),
                                torch.ones(1, dtype=torch.bool), 11, 11)
    assert float(score) == pytest.approx(0.7659, abs=1e-3)


def test_eigenvalue_floor_and_four_point_gate():
    """Fewer than 5 points score 0; a degenerate axis floors at 0.001x."""
    g4 = _single_cell([(3.5, 3.5), (3.5, 3.5), (3.4, 3.45), (3.6, 3.55)])
    assert _cell_score(g4, (3.5, 3.5)) == pytest.approx(0.0, abs=1e-3)
    g = _single_cell([(3.5, 3.5), (3.5, 3.45), (3.5, 3.45), (3.5, 3.55),
                      (3.5, 3.55)])
    i00, i01, i11 = g.information[0].tolist()
    assert i00 == pytest.approx(400000.0, rel=1e-3)
    assert i01 == pytest.approx(0.0, abs=1e-3)
