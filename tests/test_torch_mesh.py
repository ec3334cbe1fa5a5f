"""The port's multi-device mesh path (K12) on the CPU, step by step.

Ranks of a gloo mesh (2 and 4 processes spawned by the test, one torch
thread each, ``tests/torch_mesh_ranks.py``) run every sharded device step
on small box inputs: the rolling match (one grid, and four grids with
Newton), the global match, near and coarse-to-fine confirmation rows, the
filter's measurement, the descriptor search and the occupancy counts.
Each must equal the single-device port bitwise on every rank, on meshes
(space, batch) = (2, 1), (1, 2) and (2, 2).  The sharded solves of the
noisy ring of tests/test_mesh_mapper.py:150-197, the mapper's (dense at
this size) and JAX's always-PCG ``solve_multichip``, must be within 5e-3
of the single-device solve and of JAX's ``solve_graph_multichip`` on the
8-device CPU mesh, bitwise the same on every rank and from run to run;
with the constraints unsplit, bitwise the single-device solve.
In-process: K12's split search (partials of angle blocks, then the
finalize) against the one-launch twin, the rank sum's order, the mesh
factoring against JAX's, and the CLI's ``--mesh``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from ndt_2d_tpu.config import SolverConfig as JaxSolverConfig
from ndt_2d_tpu.graph import pose_graph as jax_pose_graph
from ndt_2d_tpu.parallel import mesh as jax_mesh
from ndt_2d_tpu.parallel import runtime as jax_runtime
from ndt_2d_tpu_torch import cli
from ndt_2d_tpu_torch.graph import solver
from ndt_2d_tpu_torch.io.bag import record_synthetic
from ndt_2d_tpu_torch.kernels import candidate_gather as k6
from ndt_2d_tpu_torch.kernels import candidate_scores as k2
from ndt_2d_tpu_torch.kernels import ndt_build as k1
from ndt_2d_tpu_torch.kernels import shard_combine
from ndt_2d_tpu_torch.parallel import matcher as pmatcher
from ndt_2d_tpu_torch.parallel import mesh as mesh_mod
from ndt_2d_tpu_torch.parallel import solver as psolver

import torch_mesh_ranks as ranks

torch.set_num_threads(2)

SHAPES = [(2, 1), (1, 2), (2, 2)]
STEPS = ["rolling", "rolling_g4", "global", "rows_near", "rows_far",
         "measure", "pf_weights", "search_idx", "search_scores",
         "occupancy"]


@pytest.fixture(scope="module")
def single():
    return ranks.kernel_results(None)


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    """Each shape's per-rank results, run once."""
    cache = {}

    def get(shape):
        if shape not in cache:
            out = str(tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}"))
            cache[shape] = ranks.run_ranks("kernels", out, *shape)
        return cache[shape]
    return get


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("step", STEPS)
def test_sharded_step_equals_single_device(single, meshed, shape, step):
    for r, res in enumerate(meshed(shape)):
        np.testing.assert_array_equal(res[step], single[step],
                                      err_msg=f"rank {r}")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_solve_is_replicated_and_near_single(single, meshed, shape):
    runs = meshed(shape)
    for res in runs:
        assert res["solve_ok0"] and res["solve_ok1"]
        np.testing.assert_array_equal(res["solve0"], runs[0]["solve0"])
        np.testing.assert_array_equal(res["solve1"], res["solve0"])
    np.testing.assert_allclose(runs[0]["solve0"], single["solve0"], rtol=0,
                               atol=5e-3)
    _, truth = ranks.ring_graph()
    assert ranks.metrics.ate_rmse(runs[0]["solve0"], truth) < 0.05


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_pcg_is_replicated_and_near_single(single, meshed, shape):
    runs = meshed(shape)
    for res in runs:
        assert res["pcg_ok"]
        np.testing.assert_array_equal(res["pcg"], runs[0]["pcg"])
    for ref in ("pcg", "solve0"):
        np.testing.assert_allclose(runs[0]["pcg"], single[ref], rtol=0,
                                   atol=5e-3)
    _, truth = ranks.ring_graph()
    assert ranks.metrics.ate_rmse(runs[0]["pcg"], truth) < 0.05


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ranks_import_neither_jax_nor_the_reference(meshed, shape):
    assert not any(bool(res["imported_reference"]) for res in meshed(shape))


def test_sharded_solve_matches_jax_mesh(meshed):
    """tests/test_mesh_mapper.py:150-197's ring on JAX's 8-device mesh and
    on the port's (2, 2) mesh: poses within 5e-3."""
    port, truth = ranks.ring_graph()
    g = jax_pose_graph.Graph(max_points_per_scan=4)
    for p in port.poses:
        g.add_scan(p, np.zeros((4, 2), np.float32), np.zeros(4, bool))
    for c in range(port.num_constraints):
        g.add_constraint(int(port.constraint_begin[c]),
                         int(port.constraint_end[c]),
                         port.constraint_transform[c],
                         port.constraint_information[c],
                         bool(port.constraint_switchable[c]))
    mesh = jax_mesh.make_mesh(jax.device_count())
    assert jax_runtime.solve_graph_multichip(
        g, JaxSolverConfig(max_iterations=50), mesh)
    for key in ("solve0", "pcg"):
        np.testing.assert_allclose(meshed((2, 2))[0][key], g.poses, rtol=0,
                                   atol=5e-3)
    assert ranks.metrics.ate_rmse(g.poses, truth) < 0.05


def _rows(cfg, n_rows=3):
    """Three confirmation rows of box windows for the twins."""
    pts, msk, truth = ranks.box_scans(8)
    R = n_rows
    wp = torch.tensor(np.stack([truth[i:i + 3] for i in range(R)]),
                      dtype=torch.float32)
    wpts = torch.tensor(np.stack([pts[i:i + 3] for i in range(R)]))
    wm = torch.tensor(np.stack([msk[i:i + 3] for i in range(R)]))
    grid, tables = k1.build_windows(
        wp, wpts, wm, torch.ones(R, 3, dtype=torch.bool), ranks.RANGE_MAX,
        cfg.ndt_resolution, cfg.grid_cells_x, cfg.grid_cells_y, 1)
    q = torch.tensor(pts[5:5 + R])
    qm = torch.tensor(msk[5:5 + R])
    qn = qm.sum(1).to(torch.int32)
    st = torch.tensor(truth[5:5 + R] + [0.03, -0.02, 0.01],
                      dtype=torch.float32)
    return grid, tables, q, qm, qn, st


@pytest.mark.parametrize("shards", [2, 3, 4])
@pytest.mark.parametrize("kern,cfg", [(k2, ranks.GLOBAL), (k6, ranks.COARSE)],
                         ids=["k2", "k6"])
def test_split_search_equals_one_launch(kern, cfg, shards):
    """K12's partials over contiguous angle blocks, concatenated in block
    order and finalized, equal the one-launch search bitwise (the twins;
    the card holds the kernels to them)."""
    grid, tables, q, qm, qn, st = _rows(cfg)
    dths, dls = k2.search_offsets(cfg, "cpu")
    full = kern.match_rows(cfg, grid, tables, q, qm, qn, st, dths, dls)
    A = dths.shape[0]
    parts = []
    for s in range(shards):
        a0, n = pmatcher.angle_block(A, shards, s)
        if n:
            p = kern.partial_rows(cfg, grid, tables, q, qm, qn, st, dths,
                                  dls, a0, n)
            assert p.shape == (3, n * kern.blocks_per_angle(dls), 12)
            parts.append(p)
    out = kern.finalize_rows(cfg, torch.cat(parts, 1), qn, dths, dls)
    assert torch.equal(out, full)


def test_angle_blocks_cover_the_lattice_in_order():
    for A in (1, 7, 21, 80):
        for S in (1, 2, 3, 4, 8):
            blocks = [pmatcher.angle_block(A, S, s) for s in range(S)]
            covered = [a for a0, n in blocks for a in range(a0, a0 + n)]
            assert covered == list(range(A)), (A, S)


def test_rank_sum_adds_in_rank_order():
    x = np.random.default_rng(0).normal(size=(4, 9, 3)).astype(np.float32)
    x[1] *= 1e7
    expect = ((x[0] + x[1]) + x[2]) + x[3]
    got = shard_combine.rank_sum(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), expect)
    assert not np.array_equal(expect, ((x[3] + x[2]) + x[1]) + x[0])


def test_mesh_factors_like_jax():
    for n in range(1, 17):
        assert mesh_mod._factor(n) == jax_mesh._factor(n)


def test_pad_constraints_masks_the_padding():
    b = np.arange(5, dtype=np.int32)
    t = np.ones((5, 3), np.float32)
    info = np.ones((5, 3, 3), np.float32)
    out = psolver.pad_constraints(b, b + 1, t, info, np.ones(5, bool), 4)
    assert out[0].shape == (8,) and out[4].tolist() == [True] * 5 + [False] * 3


def _cli_bag(tmp_path):
    bag = str(tmp_path / "box.npz")
    from ndt_2d_tpu_torch.io.bag import save_bag
    save_bag(record_synthetic("box", 16, n_beams=180, seed=0), bag)
    return bag


def test_cli_mesh_writes_the_single_device_map(tmp_path, capfd):
    """``run --mesh 2 --device cpu`` starts two gloo ranks; rank 0 writes
    the map, grid and trajectory, equal to the single-device run's."""
    bag = _cli_bag(tmp_path)
    flags = ["--device", "cpu", "--max-points-per-scan", "256",
             "--local_scan_matcher.grid_cells", "160",
             "--loop-closure-every", "1000000000"]
    outs = {}
    for name, extra in (("single", []), ("mesh", ["--mesh", "2"])):
        paths = {k: str(tmp_path / f"{name}_{k}") for k in
                 ("map.npz", "grid.npz", "traj.tum")}
        assert cli.main(["run", "--bag", bag, *flags, *extra,
                         "--map-out", paths["map.npz"],
                         "--grid-out", paths["grid.npz"],
                         "--traj-out", paths["traj.tum"]]) == 0
        lines = [ln for ln in capfd.readouterr().out.splitlines()
                 if ln.startswith("{")]
        assert len(lines) == 1, lines  # rank 0 alone prints its stats
        outs[name] = (json.loads(lines[0]), paths)
    (s1, p1), (s2, p2) = outs["single"], outs["mesh"]
    assert s1["scans_accepted"] == s2["scans_accepted"] == 16
    assert s1["ate_rmse_m"] == s2["ate_rmse_m"]
    for key in ("map.npz", "grid.npz"):
        with np.load(p1[key]) as a, np.load(p2[key]) as b:
            assert a.files == b.files
            for f in a.files:
                np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    with open(p1["traj.tum"]) as a, open(p2["traj.tum"]) as b:
        assert a.read() == b.read()


def test_cli_mesh_on_cuda_needs_a_device_per_rank(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        cli.main(["run", "--bag", str(tmp_path / "none.npz"), "--mesh", "2"])
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        cli.main(["localize", "--bag", str(tmp_path / "none.npz"),
                  "--mesh", "2"])


def test_unsharded_mesh_solve_is_the_single_device_pcg(meshed):
    """On a (2, 1) mesh the constraints are not split: each rank's
    ``solve_multichip`` is the single-device PCG solve (K4's host loop
    ``pcg_loop`` and a one-rank sum) on the same buckets, bitwise."""
    ref = solver.solve(ranks.SolverConfig(max_iterations=50),
                       use_dense=False, **ranks.ring_solve_inputs())
    assert bool(ref.success)
    for res in meshed((2, 1)):
        np.testing.assert_array_equal(
            res["pcg"], ref.poses[:ranks.RING].numpy().astype(np.float64))


def test_unsharded_mesh_solve_graph_is_the_single_device_one(meshed):
    """The mapper's solve on a (2, 1) mesh (dense at the ring's size, the
    one-device rule) is the single-device ``solve_graph``, bitwise, on one
    torch thread as each rank runs (the CPU's Cholesky rounds by its
    thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        g, _ = ranks.ring_graph()
        assert solver.solve_graph(g, ranks.SolverConfig(max_iterations=50))
    finally:
        torch.set_num_threads(threads)
    for res in meshed((2, 1)):
        np.testing.assert_array_equal(res["solve0"], g.poses)
