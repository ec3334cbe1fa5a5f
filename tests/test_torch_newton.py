"""The port's Newton refinement (K7's twin, ``matching/newton.py``) against
ndt_2d_tpu's ``matching/newton.py`` (tests/test_newton.py's semantics), its
place in the confirmation rows, the ``office`` recipe levers on the office
ring, and ``cli run --recipe``.

Tolerances: against op-by-op JAX (``jax.disable_jit``) the refined pose
agrees within 1e-6 and best_f within 1e-5 relative, at G = 1 and at G = 4.
The port solves the damped 3x3 system by its own LU with partial pivoting
where JAX calls LAPACK, so the last bits of a step may differ; 1e-6 is a
few float32 ulps of a pose near 5 m.  The analytic gradient and Hessian
agree with ``torch.autograd`` in float64 (rtol 1e-6 on the gradient; the
Hessian omits the second derivative of the exponent clamp and the cell
binning, so tests/test_newton.py's rtol 2e-2, atol 0.3 applies).  On the
office ring the ``office`` levers reach the JAX mapper's accept/reject
decisions on the same graph.
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu.mapping.mapper import Mapper as JaxMapper
from ndt_2d_tpu.matching import matcher as jax_matcher
from ndt_2d_tpu.matching import newton as jax_newton
from ndt_2d_tpu_torch import cli
from ndt_2d_tpu_torch.config import (
    MapperConfig, ScanMatcherConfig, SolverConfig)
from ndt_2d_tpu_torch.mapping.mapper import Mapper
from ndt_2d_tpu_torch.matching import matcher, newton, registry
from ndt_2d_tpu_torch.ndt import grid as ndt_grid
from ndt_2d_tpu_torch.utils import sim
from port_configs import to_jax

torch.set_num_threads(2)

CFG = ScanMatcherConfig(grid_cells_x=128, grid_cells_y=128)
RCFG = dataclasses.replace(CFG, refine_iterations=10)
RANGE_MAX = 15.0
WORLD = sim.make_box_world(10.0, 8.0)
WINDOW = np.asarray([[4.8, 3.9, 0.0], [5.0, 4.0, 0.05], [5.2, 4.1, -0.05]],
                    np.float32)


def T(x):
    return torch.from_numpy(np.array(x))


def make_scan(pose, n_beams=360, max_points=512):
    msg = sim.scan_at_pose(WORLD, np.asarray(pose, float), n_beams=n_beams,
                           range_max=RANGE_MAX)
    pts, mask = sim.project_scan(msg, max_points)
    return pts, mask, int(mask.sum())


def window_arrays():
    scans = [make_scan(p) for p in WINDOW]
    return (WINDOW, np.stack([s[0] for s in scans]),
            np.stack([s[1] for s in scans]), np.ones(3, bool))


def fixture(cfg):
    m = registry.create("ndt", cfg, RANGE_MAX, device="cpu")
    poses, pts, msk, _ = window_arrays()
    m.add_scans(poses, pts, msk)
    return m


def beams(pose):
    pts, mask, n = make_scan(pose)
    return matcher.subsample(T(pts), T(mask), n, CFG.laser_max_beams)[:2]


def lattice_starts(cfg, grid, count=8):
    """Seeded scans near the window and their lattice winners from an
    off-lattice start, as match_scan chains them: [(beams, mask, start)]."""
    rng = np.random.default_rng(1)
    out = []
    for _ in range(count):
        pose = (np.asarray([5.0, 4.0, 0.0])
                + rng.normal(0, [0.2, 0.2, 0.05])).astype(np.float32)
        pts, mask, n = make_scan(pose)
        off = T((pose + rng.uniform(-0.02, 0.02, 3) * [1, 1, 0.3]).astype(
            np.float32))
        start = off + matcher.match_scan(cfg, grid, T(pts), T(mask), n,
                                         off).correction
        out.append((*matcher.subsample(T(pts), T(mask), n, 100)[:2], start))
    return out


@pytest.mark.parametrize("overlapping", [False, True])
def test_refine_pose_matches_jax(overlapping):
    """From seeded lattice winners: the first the polish moves and one it
    keeps (the damped step leaves a non-convex patch uphill, and the
    best pose seen is the start)."""
    cfg = dataclasses.replace(CFG, overlapping_grids=overlapping)
    poses, pts, msk, wm = window_arrays()
    grid, _ = matcher.build_window_ndt(cfg, T(poses), T(pts), T(msk), T(wm),
                                       RANGE_MAX)
    runs = [(s, m, st, *newton.refine_pose(cfg, grid, s, m, st, 10))
            for s, m, st in lattice_starts(cfg, grid)]
    moved = [r for r in runs if not torch.equal(r[2], r[3])]
    kept = [r for r in runs if torch.equal(r[2], r[3])]
    assert moved and kept
    with jax.disable_jit():
        jgrid = jax_matcher.build_window_ndt(
            to_jax(cfg), *map(jnp.asarray, (poses, pts, msk, wm)),
            jnp.float32(RANGE_MAX))
        for spts, smask, start, best, best_f in moved[:1] + kept[:1]:
            jbest, jf = jax_newton.refine_pose(
                to_jax(cfg), jgrid, jnp.asarray(spts.numpy()),
                jnp.asarray(smask.numpy()), jnp.asarray(start.numpy()), 10)
            np.testing.assert_allclose(best.numpy(), np.asarray(jbest),
                                       rtol=0, atol=1e-6)
            assert float(best_f) == pytest.approx(float(jf), rel=1e-5)
            assert float(best_f) < -10.0


def test_sub_lattice_recovery():
    """An off-lattice true offset is recovered beyond lattice precision
    through the matcher interface (K2, then K7's twin)."""
    m = fixture(CFG)
    true_pose = np.asarray([5.0, 4.0, 0.0], np.float32)
    pts, mask, n = make_scan(true_pose)
    offset = np.asarray([0.0131, -0.0072, 0.0033], np.float32)
    lattice = m.match_scan(pts, mask, n, true_pose + offset)
    mr = registry.create("ndt_newton", CFG, RANGE_MAX, device="cpu")
    mr.grid, mr.packed_table = m.grid, m.packed_table
    refined = mr.match_scan(pts, mask, n, true_pose + offset)
    lat_err = np.abs(lattice.correction.numpy() + offset)
    ref_err = np.abs(refined.correction.numpy() + offset)
    assert ref_err[:2].max() < 0.0025
    assert ref_err[2] < 0.00125
    assert ref_err.sum() < lat_err.sum()
    assert float(refined.score) <= float(lattice.score) + 1e-6
    assert torch.equal(refined.covariance, lattice.covariance)


def test_refine_never_degrades():
    m = fixture(RCFG)
    true_pose = T(np.asarray([5.0, 4.0, 0.0], np.float32))
    spts, smask = beams(true_pose.numpy())
    f_start = newton.objective_grad_hess(m.grid, 128, 128, spts, smask,
                                         true_pose)[0]
    best, best_f = newton.refine_pose(RCFG, m.grid, spts, smask, true_pose,
                                      10)
    assert float(best_f) <= float(f_start) + 1e-6
    assert float((best - true_pose).abs().max()) < 0.01


def test_empty_grid_is_a_noop():
    """All-zero scores: gradient zero, pose unchanged, no NaNs."""
    g = ndt_grid.build_ndt(torch.zeros(4, 2), torch.zeros(4, dtype=bool),
                           torch.zeros(2), 0.25, 32, 32)
    spts = T(np.random.default_rng(0).uniform(0, 4, (16, 2)).astype(
        np.float32))
    pose = T(np.asarray([1.0, 1.0, 0.1], np.float32))
    cfg = dataclasses.replace(CFG, grid_cells_x=32, grid_cells_y=32)
    best, best_f = newton.refine_pose(cfg, g, spts, torch.ones(16, dtype=bool),
                                      pose, 5)
    assert float(best_f) == 0.0
    assert torch.equal(best, pose)


def test_registry_plugin_enables_refinement():
    m = registry.create("ndt_newton", CFG, RANGE_MAX, device="cpu")
    assert m.config.refine_iterations == 10
    m2 = registry.create("ndt_newton",
                         dataclasses.replace(CFG, refine_iterations=3),
                         RANGE_MAX, device="cpu")
    assert m2.config.refine_iterations == 3


@pytest.mark.parametrize("overlapping", [False, True])
def test_gradient_matches_autograd(overlapping):
    """The analytic gradient and Hessian against torch.autograd, float64."""
    cfg = dataclasses.replace(CFG, overlapping_grids=overlapping)
    m = fixture(cfg)
    g = m.grid
    g64 = ndt_grid.NDTGrid(origin=g.origin.double(), cell_size=g.cell_size,
                           mean=g.mean.double(),
                           information=g.information.double(),
                           count=g.count, covariance=g.covariance.double())
    spts, smask = beams([5.0, 4.0, 0.0])
    spts = spts.double()
    pose = torch.tensor([5.01, 3.99, 0.004], dtype=torch.float64)

    def f(p):
        return newton.objective_grad_hess(g64, 128, 128, spts, smask, p)[0]
    _, grad, hess = newton.objective_grad_hess(g64, 128, 128, spts, smask,
                                               pose)
    np.testing.assert_allclose(
        torch.autograd.functional.jacobian(f, pose).numpy(), grad.numpy(),
        rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(
        torch.autograd.functional.hessian(f, pose).numpy(), hess.numpy(),
        rtol=2e-2, atol=0.3)


def test_solve3_matches_a_dense_solve():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(64, 3, 3))
    a[:8, 0, 0] = 0.0  # forces a pivot
    b = rng.normal(size=(64, 3))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    x = torch.stack(newton.solve3([[at[:, i, j] for j in range(3)]
                                   for i in range(3)],
                                  [bt[:, i] for i in range(3)]), 1)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a, b[..., None])
                               [..., 0], rtol=1e-9, atol=1e-9)


def confirmation_rows():
    """Six confirmation rows over box-world windows (one all-False window,
    a padding row) with their own queries and start poses."""
    poses, pts, msk, _ = window_arrays()
    rows = []
    for r, (q, off) in enumerate([([5.0, 4.0, 0.0], [0.013, -0.007, 0.003]),
                                  ([4.9, 3.95, 0.02], [-0.02, 0.01, 0.0]),
                                  ([5.1, 4.05, -0.03], [0.0, 0.0, 0.0]),
                                  ([5.0, 4.1, 0.0], [0.03, 0.02, -0.01]),
                                  ([5.0, 4.0, 0.0], [0.0, 0.0, 0.0]),
                                  ([4.95, 3.9, 0.01], [0.01, 0.0, 0.004])]):
        qp, qm, n = make_scan(q)
        wm = np.asarray([r != 4, True, r % 2 == 0]) & (r != 4)
        rows.append((poses, pts, msk, wm, qp, qm, np.int32(n),
                     (np.asarray(q) + off).astype(np.float32)))
    return [T(np.stack(c)) for c in zip(*rows)]


@pytest.mark.parametrize("overlapping", [False, True])
def test_confirmation_rows_refine_row_by_row(overlapping):
    """match_scan_batch_multi with refine_iterations: every row bitwise the
    single-window match (K1, K2, K7 at R = 1, which the corridor replay of
    test_torch_overlapping.py holds against JAX), rows independent of R and
    of padding (pad 4 against pad 16), the all-False row a no-op."""
    cfg = dataclasses.replace(RCFG, overlapping_grids=overlapping,
                              refine_iterations=8)
    rows = confirmation_rows()
    win, query = rows[:4], rows[4:]
    full = matcher.match_scan_batch_multi(cfg, *win, RANGE_MAX, *query)
    for r in range(6):
        grid, tab = matcher.build_window_ndt(cfg, *[t[r] for t in win],
                                             RANGE_MAX)
        one = matcher.match_scan(cfg, grid, query[0][r], query[1][r],
                                 int(query[2][r]), query[3][r],
                                 packed_table=tab)
        assert all(torch.equal(a[r], b) for a, b in zip(full, one)), r
    for pad in (4, 16):
        p = [torch.cat([t[:3], torch.zeros((pad - 3,) + t.shape[1:],
                                           dtype=t.dtype)]) for t in rows]
        out = matcher.match_scan_batch_multi(cfg, *p[:4], RANGE_MAX, *p[4:])
        assert all(torch.equal(a[:3], b[:3]) for a, b in zip(full, out))
        assert bool((out[0][3:] == 0).all())
    assert float(full[0][4]) == 0.0
    assert torch.equal(full[1][4], torch.zeros(3))


# --- The office levers on the office ring -----------------------------------

RING_RANGE = 12.0
RING_GLOBAL = ScanMatcherConfig(
    ndt_resolution=0.35, search_linear_size=0.15,
    search_linear_resolution=0.01, search_angular_size=0.05,
    grid_cells_x=160, grid_cells_y=160)
RING = MapperConfig(
    local_scan_matcher=ScanMatcherConfig(grid_cells_x=160,
                                         grid_cells_y=160),
    global_scan_matcher=RING_GLOBAL, max_points_per_scan=512,
    loop_closure_every=10**9, global_search_size=4.0,
    optimization_node_limit=10**9, loop_closure_region_size=3)
# The cli's ``office`` recipe (gate 0.85, region 3, both search positions,
# Geman-McClure, global refine_iterations 8).
OFFICE = dataclasses.replace(
    RING, loop_closure_gate_scale=0.85, loop_search_positions="both",
    solver=SolverConfig(robust_loss="geman_mcclure"),
    global_scan_matcher=dataclasses.replace(RING_GLOBAL,
                                            refine_iterations=8))


def office_ring():
    """The office-ring drive of tests/test_torch_loop_closure.py."""
    world = sim.make_office_world(16.0)
    waypoints = [(2.0, 2.0, 0.0), (14.0, 2.0, np.pi / 2),
                 (14.0, 14.0, np.pi), (2.0, 14.0, -np.pi / 2),
                 (2.0, 2.6, 0.0), (8.0, 2.6, 0.0)]
    traj = []
    for a, b in zip(waypoints[:-1], waypoints[1:]):
        a, b = np.asarray(a, float), np.asarray(b, float)
        steps = max(int(np.hypot(*(b[:2] - a[:2])) / 0.35), 1)
        heading = np.arctan2(b[1] - a[1], b[0] - a[0])
        for s in range(steps):
            f = s / steps
            traj.append([a[0] + f * (b[0] - a[0]), a[1] + f * (b[1] - a[1]),
                         heading])
    truth = np.asarray(traj)
    odom = sim.drift_odometry(truth, trans_noise=0.006, rot_noise=0.002,
                              seed=11)
    msgs = [sim.scan_at_pose(world, truth[t], n_beams=600,
                             range_max=RING_RANGE, noise=0.01,
                             rng=np.random.default_rng(t))
            for t in range(len(truth))]
    return msgs, odom


def with_state(mapper, src):
    """``mapper`` holding ``src``'s graph and tracking state (the JAX
    mapper's or the port's)."""
    mapper._ensure_matchers(RING_RANGE)
    mapper.graph = copy.deepcopy(src.graph)
    mapper.typical_matcher_response = src.typical_matcher_response
    mapper.prev_robot_pose = src.prev_robot_pose.copy()
    mapper.prev_odom_pose = src.prev_odom_pose.copy()
    return mapper


def test_office_levers_reach_jax_decisions():
    """The JAX mapper maps the ring; a JAX and a port pass with the office
    levers then decide on the same graph.  The pass searches scans 100 on
    within a 0.5 m^2 radius (the revisit of the first corner and its
    neighbours), which keeps the CPU twins' pass short."""
    mapped = JaxMapper(to_jax(RING))
    for msg, o in zip(*office_ring()):
        mapped.process_scan(msg, o)
    cfg = dataclasses.replace(OFFICE, global_search_size=0.5)
    jm = with_state(JaxMapper(to_jax(cfg)), mapped)
    pm = with_state(Mapper(cfg, device="cpu"), mapped)
    for m in (jm, pm):
        m.global_scans_processed = 100
        m.loop_closure()
    assert any(d[0] >= 130 and d[1] <= 2 for d in pm.lc_log["decisions"])
    assert jm.stats.loop_closures_accepted >= 1
    for attr in ("loop_closures_accepted", "loop_closures_rejected"):
        assert getattr(pm.stats, attr) == getattr(jm.stats, attr), attr
    for f in ("constraint_begin", "constraint_end", "constraint_switchable"):
        np.testing.assert_array_equal(getattr(pm.graph, f),
                                      getattr(jm.graph, f))
    ours = [d[:2] + d[4:] for d in pm.lc_log["decisions"]]
    assert ours == [d[:2] + d[4:] for d in jm.lc_log["decisions"]]


def test_cli_run_with_the_office_recipe(tmp_path, capsys):
    bag = str(tmp_path / "bag.npz")
    assert cli.main(["simulate", "--world", "box", "--scans", "24",
                     "--beams", "180", "--out", bag]) == 0
    capsys.readouterr()
    args = ["run", "--bag", bag, "--device", "cpu", "--recipe", "office",
            "--max-points-per-scan", "256", "--loop-closure-every", "12",
            "--local_scan_matcher.grid_cells", "160",
            "--global_scan_matcher.grid_cells", "160"]
    cfg = cli._mapper_config(cli._build_parser().parse_args(args))
    assert cfg.global_scan_matcher.refine_iterations == 8
    assert cfg.loop_closure_gate_scale == 0.85
    assert cfg.loop_search_positions == "both"
    assert cfg.solver.robust_loss == "geman_mcclure"
    # An explicit flag overrides its preset value.
    over = cli._mapper_config(cli._build_parser().parse_args(
        args + ["--global_scan_matcher.refine_iterations", "3",
                "--loop-closure-gate-scale", "1.0"]))
    assert over.global_scan_matcher.refine_iterations == 3
    assert over.loop_closure_gate_scale == 1.0
    assert cli.main(args) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["scans_accepted"] == 24
    assert stats["ate_rmse_m"] < 0.2
    # The descriptor presets are ported too: each builds its configuration
    # and maps the bag.
    for recipe, search in (("office-descriptor", "descriptor"),
                           ("drift", "both")):
        rargs = ["run", "--bag", bag, "--device", "cpu", "--recipe", recipe,
                 "--max-points-per-scan", "256", "--loop-closure-every", "12",
                 "--local_scan_matcher.grid_cells", "160",
                 "--global_scan_matcher.grid_cells", "160"]
        rcfg = cli._mapper_config(cli._build_parser().parse_args(rargs))
        assert rcfg.loop_search == search
        assert rcfg.loop_closure_max_far_rows == 16
        assert rcfg.loop_closure_accept == "best"
        assert cli.main(rargs) == 0
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert stats["scans_accepted"] == 24
