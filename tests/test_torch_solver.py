"""The port's pose-graph solver (K4 twins) against ndt_2d_tpu's.

Graphs come from numpy seeds and the tests/test_graph.py fixtures.  The
per-constraint blocks and per-node sums are held against the JAX functions
run op by op (``jax.disable_jit``) at rtol 1e-6 (float32 rounding of sums
taken in another order; entries that cancel to near zero are held to
1e-6 of the field's largest magnitude instead).  Solves are held against
the jitted JAX solve: the same ``success`` and poses within 1e-4 (both run
float32 LM to the same optimum; their rounding differs in the last bits),
except one flat-valley graph whose case states its own bound and reason.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu.config import SolverConfig
from ndt_2d_tpu.graph import solver as jax_solver
from ndt_2d_tpu_torch import convert
from ndt_2d_tpu_torch.graph import solver
from ndt_2d_tpu_torch.kernels import normal_blocks as k4

torch.set_num_threads(2)

_spec = importlib.util.spec_from_file_location(
    "graph_fixtures", os.path.join(os.path.dirname(__file__),
                                   "test_graph.py"))
graph_fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(graph_fixtures)
chain_with_loop = graph_fixtures._chain_with_loop


def random_graph(seed=0, n=40, c=90):
    """Random poses, constraints (some masked, some robust) and SPD
    information matrices."""
    rng = np.random.default_rng(seed)
    begin = rng.integers(0, n, c).astype(np.int32)
    end = ((begin + rng.integers(1, 7, c)) % n).astype(np.int32)
    poses = np.c_[rng.uniform(0, 20, (n, 2)),
                  rng.uniform(-3, 3, n)].astype(np.float32)
    transform = rng.normal(0, 1, (c, 3)).astype(np.float32)
    a = rng.normal(0, 1, (c, 3, 3))
    info = (a @ a.transpose(0, 2, 1) + 3 * np.eye(3)) * 30
    return dict(poses=poses, begin=begin, end=end, transform=transform,
                information=info.astype(np.float32),
                constraint_mask=rng.random(c) < 0.9,
                node_mask=np.ones(n, bool),
                robust_mask=rng.random(c) < 0.4)


def assert_close(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("loss", ["none", "huber", "geman_mcclure"])
def test_normal_blocks_match_op_by_op_jax(loss):
    g = random_graph()
    n = g["poses"].shape[0]
    cfg = SolverConfig(robust_loss=loss, huber_delta=1.0)
    t = convert.solve_inputs_to_port("cpu", **g)
    args = (t["poses"], t["begin"], t["end"], t["transform"])
    w = solver.robust_weights(cfg, *args, t["information"], t["robust_mask"])
    info_eff = t["information"] * w[:, None, None]
    blocks = solver._normal_blocks(*args, info_eff, t["constraint_mask"])
    gd = solver._gather_gradient_and_diag(n, t["begin"], t["end"], *blocks)
    j = {k: jnp.asarray(v) for k, v in g.items()}
    jargs = (j["poses"], j["begin"], j["end"], j["transform"])
    with jax.disable_jit():
        jw = jax_solver.robust_weights(cfg, *jargs, j["information"],
                                       j["robust_mask"])
        jblocks = jax_solver._normal_blocks(
            *jargs, j["information"] * jw[:, None, None],
            j["constraint_mask"])
        jgd = jax_solver._gather_gradient_and_diag(n, j["begin"], j["end"],
                                                   *jblocks)
    assert_close(w, jw)
    for ours, ref in zip(blocks + gd, jblocks + jgd):
        assert_close(ours, ref)
    # K4's fused entry (robust weight + blocks + node sums over the live
    # incidence lists) equals the two halves.
    inc = k4.incidence(t["begin"], t["end"], t["constraint_mask"], n)
    fused = k4.normal_blocks(*args, t["information"], t["constraint_mask"],
                             t["robust_mask"], loss, 1.0, inc)
    for ours, ref in zip(fused, blocks + gd):
        assert torch.equal(ours, ref)


@pytest.mark.parametrize("loss", ["none", "huber", "geman_mcclure"])
def test_residuals_jacobians_and_costs_match_op_by_op_jax(loss):
    g = random_graph(seed=3)
    cfg = SolverConfig(robust_loss=loss, huber_delta=1.0)
    t = convert.solve_inputs_to_port("cpu", **g)
    j = {k: jnp.asarray(v) for k, v in g.items()}
    args = (t["poses"], t["begin"], t["end"])
    jargs = (j["poses"], j["begin"], j["end"])
    with jax.disable_jit():
        ref = [jax_solver.residuals(*jargs, j["transform"]),
               *jax_solver._jacobian_blocks(*jargs),
               jax_solver._cost(*jargs, j["transform"], j["information"],
                                j["constraint_mask"]),
               jax_solver._robust_cost(cfg, *jargs, j["transform"],
                                       j["information"],
                                       j["constraint_mask"],
                                       j["robust_mask"])]
    ours = [solver.residuals(*args, t["transform"]),
            *solver._jacobian_blocks(*args),
            solver._cost(*args, t["transform"], t["information"],
                         t["constraint_mask"]),
            solver._robust_cost(cfg, *args, t["transform"],
                                t["information"], t["constraint_mask"],
                                t["robust_mask"])]
    for o, r in zip(ours, ref):
        assert_close(o, r)


def test_solve_state_round_trips_to_jax():
    g = random_graph(seed=4)
    t = convert.solve_inputs_to_port("cpu", **g)
    assert t["begin"].dtype == torch.int32 and t["poses"].dtype == (
        torch.float32)
    back = convert.solve_inputs_to_numpy(t)
    for k, v in g.items():
        np.testing.assert_array_equal(back[k], v)
    ref = jax_solver.solve(SolverConfig(max_iterations=2),
                           **{k: jnp.asarray(v) for k, v in back.items()})
    ported = convert.solve_result_to_port(jax.device_get(ref), "cpu")
    assert isinstance(ported, solver.SolveResult)
    again = convert.solve_result_to_numpy(ported)
    for f in jax_solver.SolveResult._fields:
        np.testing.assert_array_equal(again[f], np.asarray(getattr(ref, f)))


def test_incidence_lists_keep_constraint_order():
    begin = torch.tensor([3, 1, 3, 0, 3, 1], dtype=torch.int32)
    end = torch.tensor([0, 2, 1, 3, 2, 0], dtype=torch.int32)
    live = torch.tensor([True, True, True, False, True, True])
    inc = k4.incidence(begin, end, live, 4)
    assert inc.b_ptr.tolist() == [0, 0, 2, 2, 5]
    assert inc.b_idx.tolist() == [1, 5, 0, 2, 4]
    assert inc.e_ptr.tolist() == [0, 2, 3, 5, 5]
    assert inc.e_idx.tolist() == [0, 5, 2, 1, 4]
    assert inc.b_mat[3].tolist() == [0, 2, 4]
    assert inc.b_ok.sum() == inc.e_ok.sum() == 5


def test_pcg_matvec_matches_reference_matvec():
    """K4's matvec twin against the reference's expression, on blocks of a
    random graph, with the gauge node masked out."""
    g = random_graph(seed=1)
    n = g["poses"].shape[0]
    t = convert.solve_inputs_to_port("cpu", **g)
    inc = k4.incidence(t["begin"], t["end"], t["constraint_mask"], n)
    baa, bab, bbb, _, _, _, d = k4.normal_blocks(
        t["poses"], t["begin"], t["end"], t["transform"], t["information"],
        t["constraint_mask"], t["robust_mask"], "huber", 1.0, inc)
    rng = np.random.default_rng(2)
    v = torch.tensor(rng.normal(0, 1, (n, 3)), dtype=torch.float32)
    fm = (torch.arange(n) != 0).float()
    lam = torch.tensor(0.01)
    out = k4.pcg_matvec(t["begin"], t["end"], baa, bab, bbb, d, lam, fm, v,
                        inc)
    vm = (v * fm[:, None]).numpy()
    b, e = g["begin"], g["end"]
    ya = (np.einsum("cij,cj->ci", baa.numpy(), vm[b])
          + np.einsum("cij,cj->ci", bab.numpy(), vm[e]))
    yb = (np.einsum("cji,cj->ci", bab.numpy(), vm[b])
          + np.einsum("cij,cj->ci", bbb.numpy(), vm[e]))
    ref = np.zeros((n, 3))
    np.add.at(ref, b, ya)
    np.add.at(ref, e, yb)
    ref = (ref + 0.01 * np.diagonal(d.numpy(), axis1=1, axis2=2) * vm)
    ref *= fm.numpy()[:, None]
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


def _both_solve_graph(graph_fn, cfg):
    g, truth = graph_fn()
    ours = solver.solve_graph(g, cfg)
    g_ref, _ = graph_fn()
    ref = jax_solver.solve_graph(g_ref, cfg)
    return ours, ref, g, g_ref, truth


def test_empty_graph_returns_false():
    assert solver.solve_graph(graph_fixtures._make_graph(),
                              SolverConfig()) is False


def test_zero_residual_graph_unchanged():
    def make():
        g, truth = chain_with_loop(drift=0.0)
        g.set_poses(truth.copy())
        return g, truth
    ours, ref, g, g_ref, truth = _both_solve_graph(make, SolverConfig())
    assert ours is ref is True
    np.testing.assert_allclose(g.poses, truth, atol=1e-4)
    np.testing.assert_allclose(g.poses, g_ref.poses, atol=1e-4)


def test_recovers_ground_truth():
    ours, ref, g, g_ref, truth = _both_solve_graph(
        lambda: chain_with_loop(n=12, drift=0.05), SolverConfig())
    assert ours is ref is True
    np.testing.assert_allclose(g.poses, g_ref.poses, atol=1e-4)
    assert np.abs(g.poses - truth).max() < 1e-3
    np.testing.assert_allclose(g.poses[0], truth[0], atol=1e-6)


def _solve_args(g, n=None, c=None):
    """solve() inputs of a Graph, padded to n nodes / c constraints."""
    n = n or g.num_scans
    c = c or g.num_constraints
    k, m = g.num_scans, g.num_constraints
    arrays = dict(poses=np.zeros((n, 3), np.float32),
                  begin=np.zeros(c, np.int32), end=np.zeros(c, np.int32),
                  transform=np.zeros((c, 3), np.float32),
                  information=np.zeros((c, 3, 3), np.float32),
                  constraint_mask=np.arange(c) < m,
                  node_mask=np.arange(n) < k,
                  robust_mask=np.zeros(c, bool))
    arrays["poses"][:k] = g.poses
    arrays["begin"][:m] = g.constraint_begin
    arrays["end"][:m] = g.constraint_end
    arrays["transform"][:m] = g.constraint_transform
    arrays["information"][:m] = g.constraint_information
    arrays["robust_mask"][:m] = g.constraint_switchable
    return arrays


def _jax_solve(cfg, arrays, use_dense):
    return jax_solver.solve(cfg, **{k: jnp.asarray(v)
                                    for k, v in arrays.items()},
                            use_dense=use_dense)


def test_pcg_matches_dense_and_jax():
    g, truth = chain_with_loop(n=16, drift=0.04, seed=7)
    cfg = SolverConfig()
    arrays = _solve_args(g)
    t = convert.solve_inputs_to_port("cpu", **arrays)
    dense = solver.solve(cfg, **t, use_dense=True)
    pcg = solver.solve(cfg, **t, use_dense=False)
    assert bool(dense.success) and bool(pcg.success)
    np.testing.assert_allclose(dense.poses.numpy(), pcg.poses.numpy(),
                               atol=5e-3)
    np.testing.assert_allclose(dense.poses.numpy(), truth, atol=2e-3)
    for ours, use_dense in ((dense, True), (pcg, False)):
        ref = _jax_solve(cfg, arrays, use_dense)
        assert bool(ref.success)
        np.testing.assert_allclose(ours.poses.numpy(), np.asarray(ref.poses),
                                   atol=1e-4)


def test_padded_nodes_and_constraints_ignored():
    g, truth = chain_with_loop(n=12, drift=0.05)
    arrays = _solve_args(g, n=g.num_scans + 6, c=g.num_constraints + 9)
    res = solver.solve(SolverConfig(),
                       **convert.solve_inputs_to_port("cpu", **arrays))
    ref = _jax_solve(SolverConfig(), arrays, True)
    assert bool(res.success) and bool(ref.success)
    poses = res.poses.numpy()
    np.testing.assert_allclose(poses[:12], truth, atol=2e-3)
    np.testing.assert_allclose(poses[12:], 0.0, atol=1e-6)
    np.testing.assert_allclose(poses, np.asarray(ref.poses), atol=1e-4)
    back = convert.solve_result_to_numpy(res)
    assert jax_solver.SolveResult(**back).poses.shape == (18, 3)


def test_failed_solve_keeps_poses():
    g, _ = chain_with_loop()
    g.constraint_information[0] = np.nan
    before = g.poses.copy()
    assert solver.solve_graph(g, SolverConfig()) is False
    np.testing.assert_array_equal(g.poses, before)
    g_ref, _ = chain_with_loop()
    g_ref.constraint_information[0] = np.nan
    assert jax_solver.solve_graph(g_ref, SolverConfig()) is False


def _false_closure():
    g, truth = chain_with_loop(n=12, drift=0.02, seed=5)
    info = np.linalg.inv(np.diag([0.01, 0.01, 0.005]))
    g.add_constraint(3, 8, [0.0, 0.0, 0.0], info, switchable=True)
    return g, truth


@pytest.mark.parametrize("loss,bound,atol", [
    # The plain loss ends in a flat valley: its last LM steps move poses by
    # ~1e-4 at equal float32 cost, and whether one is accepted is decided
    # by the cost's last ulp, which sums in another order in each library
    # (the port stops one iteration before JAX on this graph).
    ("none", None, 1e-3),
    ("huber", 0.25, 1e-4),
    ("geman_mcclure", 0.05, 1e-4)])
def test_robust_losses_with_false_closure(loss, bound, atol):
    cfg = SolverConfig(robust_loss=loss, huber_delta=1.0)
    ours, ref, g, g_ref, truth = _both_solve_graph(_false_closure, cfg)
    assert ours is ref is True
    np.testing.assert_allclose(g.poses, g_ref.poses, atol=atol)
    err = np.abs(g.poses[:, :2] - truth[:, :2]).max()
    if bound is None:
        assert err > 0.3  # the plain loss is distorted by the alias
    else:
        assert err < bound


def test_loop_grid_takes_pcg_like_jax():
    """A 33 x 33 = 1089-node grid pads to 2048 nodes: 3 * 2048 exceeds
    dense_size_limit, so solve_graph takes PCG in both packages."""
    rng = np.random.default_rng(0)
    side = 33
    n = side * side
    xs, ys = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    truth = np.stack([xs.ravel(), ys.ravel(), np.zeros(n)], -1).astype(float)
    init = truth + rng.normal(0, 0.08, truth.shape)
    init[0] = truth[0]

    def make():
        g = graph_fixtures._make_graph()
        pts, mask = graph_fixtures._pad_points([])
        for k in range(n):
            g.add_scan(init[k], pts, mask)
        info = np.eye(3) * 100.0
        for i in range(side):
            for j in range(side):
                k = i * side + j
                for m in ([k + 1] if j + 1 < side else []) + (
                        [k + side] if i + 1 < side else []):
                    g.add_constraint(k, m, truth[m] - truth[k], info)
        return g, truth
    # CG runs to its tolerance: an iterate cut at 250 steps carries each
    # library's float32 rounding (~2e-4 apart on this grid).
    cfg = SolverConfig(max_iterations=30, cg_max_iterations=1000)
    assert 3 * 2048 > cfg.dense_size_limit
    ours, ref, g, g_ref, _ = _both_solve_graph(make, cfg)
    assert ours is ref is True
    np.testing.assert_allclose(g.poses, g_ref.poses, atol=1e-4)
    assert np.abs(g.poses[:, :2] - truth[:, :2]).max() < 0.02


def test_solve_runs_without_tf32(monkeypatch):
    """The solve turns TF32 off (the reference forces precision="highest")
    and restores the caller's setting afterwards."""
    seen = []
    real = solver._dense_solve

    def spy(*a, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return real(*a, **kw)
    monkeypatch.setattr(solver, "_dense_solve", spy)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        g, _ = chain_with_loop()
        assert solver.solve_graph(g, SolverConfig())
        assert seen and all(s == (False, False) for s in seen)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("loss,max_iterations", [
    ("none", 100), ("huber", 100), ("geman_mcclure", 100), ("none", 3)])
def test_lm_stops_at_the_reference_iteration(loss, max_iterations):
    """The host LM loop stops where the reference's while_loop does
    (stall < 3, it < max_iterations).  The graph carries a false closure,
    so its optimum cost is far above float32 noise (on a zero-residual
    graph the last accepts are decided by rounding alone)."""
    g, _ = _false_closure()
    cfg = SolverConfig(robust_loss=loss, max_iterations=max_iterations)
    arrays = _solve_args(g)
    ours = solver.solve(cfg, **convert.solve_inputs_to_port("cpu", **arrays))
    ref = _jax_solve(cfg, arrays, True)
    assert int(ours.iterations) == int(ref.iterations)
    if max_iterations == 3:
        assert int(ours.iterations) == 3
