"""The port's scan matcher (K1 + K2 + K3 twins) against ndt_2d_tpu's.

Fixtures are the JAX package's own: ``__graft_entry__.entry()`` (a 128^2
grid over a 3-scan box-world window) and origin-shifted grids whose scans
straddle the grid edge (the analogue of test_paths_agree_at_grid_edges).
The jitted JAX matcher fuses elementwise chains, and XLA:CPU contracts
a*b+c into one rounding; the port's twins and kernels round once per
operation.  Per-candidate comparisons therefore run the JAX functions op by
op (``jax.disable_jit``); decisions are also held against the jitted path.

K2 tolerances: candidate scores rtol/atol 1e-5; the same argmin wherever
the best two scores are more than 1e-4 |best| apart; covariance within
1e-4 of sqrt(cov_ii cov_jj) (the off-diagonals sum to near zero over the
symmetric lattice, so their rounding noise is relative to the diagonal).
Candidate scores are compared at the lattice angles where the two
libraries' float32 cos and sin agree bitwise (all but a few of the 80):
at the others an ulp of rotation can carry a noise-free beam across a
cell edge, which changes its term by design, not by error.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from ndt_2d_tpu import config as jax_config
from ndt_2d_tpu.config import ScanMatcherConfig
from ndt_2d_tpu.matching import matcher as jax_matcher
from ndt_2d_tpu.utils import sim
from ndt_2d_tpu_torch import convert
from ndt_2d_tpu_torch.kernels import candidate_scores as k2
from ndt_2d_tpu_torch.matching import matcher, registry

torch.set_num_threads(2)

CFG = ScanMatcherConfig(grid_cells_x=128, grid_cells_y=128)
RANGE_MAX = 15.0


def entry_inputs():
    """The entry fixture as numpy: window (poses, points, point mask,
    window mask) and query (points, mask, num_points, start pose)."""
    _, args = __graft_entry__.entry()
    return [np.asarray(a) for a in args]


def T(x):
    return torch.from_numpy(np.array(x))


def port_grid(poses, wp, wpm, wm):
    return matcher.build_window_ndt(CFG, T(poses), T(wp), T(wpm), T(wm),
                                    RANGE_MAX)


def assert_match_close(res, ref):
    assert float(res.score) == pytest.approx(float(ref.score), rel=1e-5,
                                             abs=1e-5)
    np.testing.assert_array_equal(res.correction.numpy(),
                                  np.asarray(ref.correction))
    cov, want = res.covariance.numpy(), np.asarray(ref.covariance)
    d = np.sqrt(np.abs(np.diag(want)))
    assert np.all(np.abs(cov - want) <= 1e-4 * np.outer(d, d))


def same_trig(theta0):
    """[A] lattice angles whose float32 cos and sin agree in both."""
    th = (np.float32(theta0)
          + np.asarray(jax_matcher._search_offsets(CFG)[0])).astype(
              np.float32)
    tt = torch.from_numpy(th)
    return ((np.asarray(jnp.cos(th)) == torch.cos(tt).numpy())
            & (np.asarray(jnp.sin(th)) == torch.sin(tt).numpy()))


def assert_scores_close(cand, ref, theta0):
    cand, ref = cand.numpy(), np.asarray(ref)
    ok = same_trig(theta0)
    assert ok.sum() >= 70
    np.testing.assert_allclose(cand[ok], ref[ok], rtol=1e-5, atol=1e-5)
    top2 = np.sort(ref[ok].ravel())[:2]
    if top2[1] - top2[0] > 1e-4 * abs(top2[0]):
        assert np.argmin(cand[ok]) == np.argmin(ref[ok])


def test_entry_match_score_and_candidates():
    poses, wp, wpm, wm, qp, qm, qn, pose = entry_inputs()
    grid, table = port_grid(poses, wp, wpm, wm)
    out, cand = k2.match(CFG, grid, table, T(qp), T(qm), int(qn), T(pose),
                         *matcher._search_offsets(CFG, torch.device("cpu")),
                         with_scores=True)
    res = k2.MatchResult(*(f[0] for f in k2.unpack(out)))
    unc = matcher.score_points_at_pose(CFG, grid, T(qp), T(qm), int(qn),
                                       T(pose))
    jargs = (jnp.asarray(qp), jnp.asarray(qm), jnp.int32(qn),
             jnp.asarray(pose))
    with jax.disable_jit():
        jgrid = jax_matcher.build_window_ndt(
            CFG, jnp.asarray(poses), jnp.asarray(wp), jnp.asarray(wpm),
            jnp.asarray(wm), jnp.float32(RANGE_MAX))
        ref = jax_matcher.match_scan(CFG, jgrid, *jargs,
                                     jnp.float32(RANGE_MAX))
        spts, smask, _ = jax_matcher.subsample(*jargs[:3],
                                               CFG.laser_max_beams)
        dths, dls = jax_matcher._search_offsets(CFG)
        ref_cand = jax_matcher._candidate_scores_local(
            CFG, jgrid, spts, smask, jargs[3], dths, dls)
        ref_unc = jax_matcher.score_points_at_pose(CFG, jgrid, *jargs)
    assert float(res.score) < -0.5
    assert_scores_close(cand, ref_cand, pose[2])
    assert_match_close(res, ref)
    assert float(unc) == pytest.approx(float(ref_unc), abs=1e-6)
    # The production (jitted) reference reaches the same decision.
    jit_ref = jax_matcher.match_scan(
        CFG, jax_matcher.build_window_ndt(
            CFG, jnp.asarray(poses), jnp.asarray(wp), jnp.asarray(wpm),
            jnp.asarray(wm), jnp.float32(RANGE_MAX)), *jargs,
        jnp.float32(RANGE_MAX))
    assert_same_lattice_point(res.correction, jit_ref.correction)


def assert_same_lattice_point(corr, ref):
    """Equal up to the jitted lattice's own last-bit rounding (XLA fuses
    -size + i * res into one FMA), far below a 0.0025 lattice step."""
    np.testing.assert_allclose(corr.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("shift", [(7.45, 0.0), (0.0, 7.45), (7.4, 7.4),
                                   (-12.3, 0.0)])
def test_grid_edge_candidates_match_gather_oracle(shift):
    """Scans straddling the grid boundary: the clipped patch base plus the
    candidate-level bounds mask agree with the reference's direct
    per-candidate gather path and its local path."""
    world = sim.make_box_world(10.0, 8.0)
    pose = np.asarray([5.0, 4.0, 0.0], np.float32)
    msg = sim.scan_at_pose(world, pose, n_beams=360, range_max=RANGE_MAX)
    pts, mask = sim.project_scan(msg, 512)
    n = int(mask.sum())
    grid, _ = port_grid(pose[None], pts[None], mask[None], np.ones(1, bool))
    grid.origin = grid.origin + torch.tensor(shift, dtype=torch.float32)
    jgrid = convert.grid_to_numpy(grid)
    jgrid = jax_matcher.ndt_grid.NDTGrid(
        **{k: jnp.asarray(v) for k, v in jgrid.items()})
    spts, smask, _ = matcher.subsample(T(pts), T(mask), n,
                                       CFG.laser_max_beams)
    dths, dls = matcher._search_offsets(CFG, torch.device("cpu"))
    table = matcher.ndt_grid.packed_patch_table(grid, CFG.grid_cells_x)
    cand = matcher._candidate_scores_local(CFG, grid, spts, smask, T(pose),
                                           dths, dls, table)
    with jax.disable_jit():
        args = (CFG, jgrid, jnp.asarray(spts.numpy()),
                jnp.asarray(smask.numpy()), jnp.asarray(pose),
                *jax_matcher._search_offsets(CFG))
        gather = jax_matcher._candidate_scores_gather(*args)
        local = jax_matcher._candidate_scores_local(*args)
    assert_scores_close(cand, gather, pose[2])
    assert_scores_close(cand, local, pose[2])


def test_rolling_window_matches_jax():
    """match_scan_rolling over a partly filled window, and window_append,
    against the reference's."""
    poses, wp, wpm, _, qp, qm, qn, pose = entry_inputs()
    D = 4
    jwin = jax_matcher.make_window(D, wp.shape[1])
    win = matcher.make_window(D, wp.shape[1], device="cpu")
    for s in range(poses.shape[0]):
        jwin = jax_matcher.window_append(jwin, jnp.asarray(poses[s]),
                                         jnp.asarray(wp[s]),
                                         jnp.asarray(wpm[s]))
        assert matcher.window_append(win, T(poses[s]), T(wp[s]),
                                     T(wpm[s])) is win
    got = convert.window_to_numpy(win)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jwin, k)))
    unc, score, corr, cov = matcher.match_scan_rolling(
        CFG, win, RANGE_MAX, T(qp), T(qm), int(qn), T(pose))
    with jax.disable_jit():
        ref = jax_matcher.match_scan_rolling(
            CFG, jwin, jnp.float32(RANGE_MAX), jnp.asarray(qp),
            jnp.asarray(qm), jnp.int32(qn), jnp.asarray(pose))
    assert float(unc) == pytest.approx(float(ref[0]), abs=1e-6)
    assert_match_close(k2.MatchResult(score, corr, cov),
                       jax_matcher.MatchResult(*ref[1:]))


def test_matcher_interface_and_registry():
    poses, wp, wpm, wm, qp, qm, qn, pose = entry_inputs()
    for name in ("ndt", "ndt_2d::ScanMatcherNDT"):
        m = registry.create(name, CFG, RANGE_MAX, device="cpu")
        res = m.match_scan(qp, qm, qn, pose)
        assert float(res.score) == 0.0  # no scans added yet
        m.add_scans(poses, wp, wpm)
        res = m.match_scan(qp, qm, qn, pose)
        ref = jax_matcher.match_scan(
            CFG, jax_matcher.build_window_ndt(
                CFG, jnp.asarray(poses), jnp.asarray(wp), jnp.asarray(wpm),
                jnp.ones(3, bool), jnp.float32(RANGE_MAX)),
            jnp.asarray(qp), jnp.asarray(qm), jnp.int32(qn),
            jnp.asarray(pose), jnp.float32(RANGE_MAX))
        assert_same_lattice_point(res.correction, ref.correction)
        assert float(m.score_points(qp, qm, qn, pose)) < -0.05
        m.reset()
        assert m.grid is None
    with pytest.raises(KeyError):
        registry.create("no_such_matcher", CFG, RANGE_MAX, device="cpu")
    assert type(registry.create("correlative", CFG, RANGE_MAX,
                                device="cpu")).__name__ == (
        "CorrelativeScanMatcher")
    small = dataclasses.replace(CFG, grid_cells_x=32, grid_cells_y=32)
    with pytest.raises(ValueError):
        registry.create("ndt", small, RANGE_MAX, device="cpu").add_scans(
            poses, wp, wpm)


def test_empty_window_falls_back_to_weak_covariance():
    """s == 0 (no candidate scored a point): zero correction, zero score and
    the weak isotropic covariance, as in the reference's finalize_match."""
    poses, wp, wpm, _, qp, qm, qn, pose = entry_inputs()
    empty = np.zeros(3, bool)
    grid, table = port_grid(poses, wp, wpm, empty)
    res = matcher.match_scan(CFG, grid, T(qp), T(qm), int(qn), T(pose),
                             packed_table=table)
    ref = jax_matcher.match_scan(
        CFG, jax_matcher.build_window_ndt(
            CFG, jnp.asarray(poses), jnp.asarray(wp), jnp.asarray(wpm),
            jnp.asarray(empty), jnp.float32(RANGE_MAX)),
        jnp.asarray(qp), jnp.asarray(qm), jnp.int32(qn), jnp.asarray(pose),
        jnp.float32(RANGE_MAX))
    np.testing.assert_array_equal(res.covariance.numpy(),
                                  np.diag([1.0, 1.0, 0.25]))
    np.testing.assert_array_equal(res.covariance.numpy(),
                                  np.asarray(ref.covariance))
    np.testing.assert_array_equal(res.correction.numpy(), np.zeros(3))
    assert float(res.score) == float(ref.score) == 0.0


@pytest.mark.parametrize("change", [
    dict(search_linear_size=0.2, search_linear_resolution=0.02),
    dict(overlapping_grids=True),
    dict(refine_iterations=4),
])
def test_matcher_options_match_op_by_op_jax(change):
    """Every matcher option is ported: a lattice wider than a cell (kernel
    K6), overlapping grids (K8) and the Newton polish (K7) match op-by-op
    JAX (the jitted reference contracts FMAs in the covariance of
    near-degenerate cells, which moves its overlapping score by 0.3% on
    this window)."""
    cfg = dataclasses.replace(CFG, **change)
    poses, wp, wpm, wm, qp, qm, qn, pose = entry_inputs()
    assert matcher.search_kernel(cfg).__name__.endswith(
        "candidate_gather" if "search_linear_size" in change
        else "candidate_scores")
    m = registry.create("ndt", cfg, RANGE_MAX, device="cpu")
    m.add_scans(poses, wp, wpm, wm)
    res = m.match_scan(qp, qm, qn, pose)
    jcfg = jax_config.ScanMatcherConfig(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    with jax.disable_jit():
        ref = jax_matcher.match_scan(
            jcfg, jax_matcher.build_window_ndt(
                jcfg, jnp.asarray(poses), jnp.asarray(wp), jnp.asarray(wpm),
                jnp.asarray(wm), jnp.float32(RANGE_MAX)),
            jnp.asarray(qp), jnp.asarray(qm), jnp.int32(qn),
            jnp.asarray(pose), jnp.float32(RANGE_MAX))
    np.testing.assert_allclose(res.correction.numpy(),
                               np.asarray(ref.correction), rtol=0, atol=1e-6)
    assert float(res.score) == pytest.approx(float(ref.score), rel=1e-5)


def warp_tree_sum(terms):
    """The kernel's reduction lane by lane in numpy float32: per angle,
    32-lane warps (dead lanes 0) reduced by ``__shfl_down_sync`` steps
    (lane i adds lane i + off, or itself past lane 31), lane 0's sums of
    the warps added in order, then the angles in order."""
    A, T, K = terms.shape
    lanes = np.arange(32)
    total = None
    for a in range(A):
        acc = None
        for w in range(0, T, 32):
            v = np.zeros((32, K), np.float32)
            v[:min(32, T - w)] = terms[a, w:w + 32]
            for off in (16, 8, 4, 2, 1):
                v = v + v[np.where(lanes + off < 32, lanes + off, lanes)]
            acc = v[0] if acc is None else acc + v[0]
        total = acc if total is None else total + acc
    return total


@pytest.mark.parametrize("angles,cands", [(80, 441), (40, 900), (3, 7)])
def test_twin_sums_in_the_kernels_order(angles, cands):
    terms = np.random.default_rng(cands).normal(
        size=(angles, cands, 10)).astype(np.float32)
    np.testing.assert_array_equal(
        k2._sum_as_kernel(torch.from_numpy(terms)).numpy(),
        warp_tree_sum(terms))
