"""The port's rolling-mapping slice end to end, against ndt_2d_tpu's.

The slice is the rolling local mapping configuration of
benchmarks/run_benchmarks.py (config 2: 192^2 grids, 512 points per scan,
no loop closure, 600-beam corridor), cut to 30 scans.  The JAX mapper runs
as it runs in production (jitted); its last-bit rounding differs from the
port's (see test_torch_matcher.py), so decisions are compared: equal
accept and constraint counts, every correction within one lattice step
(0.005 m, 0.0025 rad) and >= 90% within 1e-6, ATE within 0.005 m, and
>= 99.5% of occupancy cells equal.  Also: state conversion round trips,
the CLI, the jax-free import boundary, and the configurations the port
refuses.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from ndt_2d_tpu.config import MapperConfig, ScanMatcherConfig
from ndt_2d_tpu.io import bag as bag_mod
from ndt_2d_tpu.mapping import runtime as jax_runtime
from ndt_2d_tpu.mapping.mapper import Mapper as JaxMapper
from ndt_2d_tpu.matching import matcher as jax_matcher
from ndt_2d_tpu.ndt import grid as jax_grid
from ndt_2d_tpu_torch import cli, convert
from ndt_2d_tpu_torch.kernels import _build
from ndt_2d_tpu_torch.mapping import runtime
from ndt_2d_tpu_torch.mapping.mapper import Mapper
from ndt_2d_tpu_torch.utils import sim

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M192 = ScanMatcherConfig(grid_cells_x=192, grid_cells_y=192)
CONFIG2 = MapperConfig(local_scan_matcher=M192, global_scan_matcher=M192,
                       max_points_per_scan=512, loop_closure_every=10**9)


def _session(mapper_cls, rt, bag, **kw):
    corrections = []

    def progress(t, res):
        corrections.append(res.correction)

    mapper = mapper_cls(CONFIG2, **kw)
    stats = rt.run_bag(mapper, bag, progress=progress)
    return stats, np.asarray(corrections), mapper.render_map()


def test_config2_corridor_matches_jax():
    bag = bag_mod.record_synthetic("corridor", 30, n_beams=600, seed=0)
    ours, corr, grid = _session(Mapper, runtime, bag, device="cpu")
    ref, ref_corr, ref_grid = _session(JaxMapper, jax_runtime, bag)
    assert ours["scans_accepted"] == ref["scans_accepted"] == 30
    assert ours["graph_constraints"] == ref["graph_constraints"] == 29
    assert ours["loop_closures"] == 0
    assert ours["session"]["timing"]["local_match"]["count"] == 29
    d = np.abs(corr - ref_corr)
    assert np.all(d <= [0.005, 0.005, 0.0025])
    assert np.mean(np.all(d < 1e-6, axis=1)) >= 0.9
    assert abs(ours["ate_rmse_m"] - ref["ate_rmse_m"]) <= 0.005
    assert ours["odom_ate_rmse_m"] == ref["odom_ate_rmse_m"]
    assert grid.data.shape == ref_grid.data.shape
    np.testing.assert_array_equal(grid.origin, ref_grid.origin)
    assert np.mean(grid.data == ref_grid.data) >= 0.995
    assert (grid.data == 100).sum() > 100


def test_convert_round_trip():
    rng = np.random.default_rng(0)
    poses = np.concatenate([rng.uniform(4, 6, (3, 2)), np.zeros((3, 1))],
                           -1).astype(np.float32)
    pts = rng.normal(0.0, 3.0, (3, 64, 2)).astype(np.float32)
    pmask = rng.random((3, 64)) < 0.9
    cfg = ScanMatcherConfig(grid_cells_x=64, grid_cells_y=64)
    jgrid = jax.device_get(jax_matcher.build_window_ndt(
        cfg, poses, pts, pmask, np.ones(3, bool), np.float32(15.0)))
    grid = convert.grid_to_port(jgrid, "cpu")
    back = jax_grid.NDTGrid(**convert.grid_to_numpy(grid))
    for f in jax_grid.NDTGrid._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(jgrid, f)))
    table = jax.device_get(jax_grid.packed_patch_table(jgrid, 64))
    np.testing.assert_array_equal(
        convert.table_to_numpy(convert.table_to_port(table, "cpu")), table)
    jwin = jax.device_get(jax_matcher.window_append(
        jax_matcher.make_window(4, 64), poses[0], pts[0], pmask[0]))
    back = jax_matcher.RollingWindow(**convert.window_to_numpy(
        convert.window_to_port(jwin, "cpu")))
    for f in jax_matcher.RollingWindow._fields:
        np.testing.assert_array_equal(getattr(back, f), getattr(jwin, f))
    jres = jax_matcher.MatchResult(np.float32(-0.5),
                                   np.asarray([0.01, -0.02, 0.0025],
                                              np.float32),
                                   np.eye(3, dtype=np.float32))
    back = jax_matcher.MatchResult(**convert.match_to_numpy(
        convert.match_to_port(jres, "cpu")))
    for f in jax_matcher.MatchResult._fields:
        np.testing.assert_array_equal(getattr(back, f), getattr(jres, f))


def test_cli_simulate_and_run(tmp_path, capsys):
    bag = str(tmp_path / "bag.npz")
    assert cli.main(["simulate", "--world", "box", "--scans", "8",
                     "--beams", "180", "--out", bag]) == 0
    capsys.readouterr()
    out = {k: str(tmp_path / f"{k}.npz") for k in ("grid", "map")}
    traj = str(tmp_path / "traj.tum")
    assert cli.main(["run", "--bag", bag, "--device", "cpu",
                     "--grid-out", out["grid"], "--map-out", out["map"],
                     "--traj-out", traj, "--loop-closure-every",
                     "1000000000", "--max-points-per-scan", "256",
                     "--local_scan_matcher.grid_cells", "160"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["scans_accepted"] == 8
    assert stats["graph_constraints"] == 7
    assert stats["ate_rmse_m"] < 0.2
    g = np.load(out["grid"])
    assert (g["data"] == 100).sum() > 50
    assert np.load(out["map"])["poses"].shape == (8, 3)
    assert len(open(traj).read().strip().splitlines()) == 8


def test_cli_localize_particle_filter(tmp_path, capsys):
    """``localize --particle-filter`` on a small box bag against the map its
    own ``run`` saved (the analogue of tests/test_cli.py::
    test_localize_against_map), and scan-match ``localize``."""
    bag = str(tmp_path / "bag.npz")
    assert cli.main(["simulate", "--world", "box", "--scans", "16",
                     "--beams", "180", "--range-max", "14.0", "--out",
                     bag]) == 0
    map_out = str(tmp_path / "map.npz")
    assert cli.main(["run", "--bag", bag, "--device", "cpu", "--map-out",
                     map_out, "--local_scan_matcher.grid_cells", "160",
                     "--loop-closure-every", "1000000"]) == 0
    capsys.readouterr()
    for extra in (["--particle-filter", "--pf.max_particles", "400",
                   "--pf.min_particles", "100"], []):
        assert cli.main(["localize", "--bag", bag, "--map", map_out,
                         "--device", "cpu",
                         "--global_scan_matcher.grid_cells", "192",
                         *extra]) == 0
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        # localization never grows the graph
        assert stats["graph_scans"] == stats["graph_constraints"] + 1
        assert stats["scans_accepted"] >= 8
        # The CLI seeds the filter with sigma 0.5 m (the JAX CLI's PF reads
        # ATE 0.26 m on such a bag); scan matching tracks to centimetres.
        assert stats["ate_rmse_m"] < (0.6 if extra else 0.05)
        key = "pf_step" if extra else "global_match"
        assert stats["session"]["timing"][key]["count"] >= 8
    assert cli.main(["localize", "--bag", bag, "--device", "cpu",
                     "--global-init"]) == 1


def test_port_never_imports_jax():
    code = textwrap.dedent("""
        import sys
        import ndt_2d_tpu_torch.cli
        import ndt_2d_tpu_torch.convert
        from ndt_2d_tpu_torch.graph import solver
        from ndt_2d_tpu_torch.mapping import runtime
        from ndt_2d_tpu_torch.mapping.mapper import Mapper
        from ndt_2d_tpu_torch.config import MapperConfig, ScanMatcherConfig
        from ndt_2d_tpu_torch.io.bag import record_synthetic
        b = record_synthetic("box", 24, n_beams=90)
        m = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
        cfg = MapperConfig(local_scan_matcher=m, global_scan_matcher=m,
                           max_points_per_scan=128, loop_closure_every=12)
        mapper = Mapper(cfg, device="cpu")
        st = runtime.run_bag(mapper, b)
        assert st["scans_accepted"] == 24, st
        assert len(mapper.lc_log["decisions"]) >= 1, "no row confirmed"
        assert solver.solve_graph(mapper.graph, cfg.solver)
        import dataclasses
        from ndt_2d_tpu_torch.config import ParticleFilterConfig
        pf = ParticleFilterConfig(min_particles=50, max_particles=200)
        loc = Mapper(dataclasses.replace(cfg, use_particle_filter=True,
                                         particle_filter=pf),
                     graph=mapper.graph, device="cpu")
        assert loc.global_localize(b.odom[0])
        assert runtime.run_bag(loc, b)["scans_accepted"] >= 12
        assert "jax" not in sys.modules, "jax imported"
        reached = [m for m in sys.modules
                   if m == "ndt_2d_tpu" or m.startswith("ndt_2d_tpu.")]
        assert not reached, reached
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_kernel_sources_found_from_package_path():
    names = {os.path.basename(p) for p in _build.sources()}
    assert {"ndt_build.cu", "candidate_scores.cu", "score_points.cu",
            "raymarch.cu", "normal_blocks.cu", "particle_filter.cu",
            "newton.cu", "common.cuh"} <= names
    assert all(p.startswith(_build.CSRC) for p in _build.sources())
    assert _build.BUILD_DIR.startswith(os.path.dirname(_build.CSRC))
    # The build is lazy: importing the kernel modules compiled nothing.
    assert _build.build_info()["path"] == ""


@pytest.mark.parametrize("change", [
    dict(use_particle_filter=True, max_inflight=4),
    dict(enable_mapping=False, max_inflight=4),
    dict(max_inflight=8),
    dict(loop_search="descriptor"),
    dict(loop_search="both"),
])
def test_unported_mapper_modes_raise(change):
    with pytest.raises(NotImplementedError):
        Mapper(dataclasses.replace(CONFIG2, **change), device="cpu")


@pytest.mark.parametrize("change", [
    dict(search_linear_size=0.2, search_linear_resolution=0.02),
    dict(refine_iterations=8),
    dict(overlapping_grids=True),
])
def test_unported_global_matcher_fails_at_construction(change):
    """An unported global lattice (kernel K6) is refused by Mapper(...), not
    at the first loop-closure pass; the Newton polish (K7) and overlapping
    grids (K8) are ported: the mapper builds and one global match runs."""
    cfg = dataclasses.replace(
        CONFIG2, global_scan_matcher=dataclasses.replace(M192, **change))
    if "search_linear_size" in change:
        with pytest.raises(NotImplementedError):
            Mapper(cfg, device="cpu")
        return
    mapper = Mapper(cfg, device="cpu")
    mapper._ensure_matchers(15.0)
    world = sim.make_box_world(10.0, 8.0)
    pose = np.asarray([5.0, 4.0, 0.0], np.float32)
    pts, mask = sim.project_scan(sim.scan_at_pose(world, pose, 1440), 1440)
    m = mapper.global_matcher
    m.add_scans(pose[None], pts[None], mask[None])
    res = m.match_scan(pts, mask, int(mask.sum()), pose + [0.01, 0.0, 0.0])
    assert float(res.score) < -0.5
    assert abs(float(res.correction[0]) + 0.01) < 0.006


def test_mesh_and_configure_actions_raise(tmp_path):
    """A mesh is refused; LOAD_FROM_FILE of a missing map raises."""
    with pytest.raises(NotImplementedError):
        Mapper(CONFIG2, mesh=object(), device="cpu")
    with pytest.raises(FileNotFoundError):
        Mapper(CONFIG2, device="cpu").configure(4, str(tmp_path / "no.npz"))


def test_cuda_requested_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        Mapper(CONFIG2)


def test_window_mirrors_graph_tail_and_grid_grows():
    """The device window and its host mirror hold the graph's newest
    rolling_depth scans after in-place appends, and a window that outgrows
    the static grid rebuilds the matcher at a larger extent (or raises
    with auto_grow_grids off)."""
    bag = bag_mod.record_synthetic("corridor", 14, n_beams=90, seed=1)
    small = ScanMatcherConfig(grid_cells_x=128, grid_cells_y=128)
    cfg = MapperConfig(local_scan_matcher=small, global_scan_matcher=small,
                       max_points_per_scan=128, loop_closure_every=10**9)
    mapper = Mapper(cfg, device="cpu")
    runtime.run_bag(mapper, bag)
    grown = mapper.local_matcher.config
    assert grown.grid_cells_x > 128 and grown.grid_cells_x % 32 == 0
    g, D = mapper.graph, cfg.rolling_depth
    tail = g.poses[-D:].astype(np.float32)
    np.testing.assert_array_equal(mapper._window_poses_host, tail)
    np.testing.assert_array_equal(mapper._window.poses.numpy(), tail)
    np.testing.assert_array_equal(mapper._window.points.numpy(),
                                  g.points[-D:])
    assert bool(mapper._window.mask.all())
    strict = dataclasses.replace(cfg, auto_grow_grids=False)
    with pytest.raises(ValueError):
        runtime.run_bag(Mapper(strict, device="cpu"), bag)


def test_proposed_loop_closure_raises():
    """A revisit's proposed radius-search candidates raise confirmation
    rows: the pass confirms each one on the global matcher and gates it."""
    bag = bag_mod.record_synthetic("box", 30, n_beams=180, seed=0)
    m = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
    cfg = MapperConfig(local_scan_matcher=m, global_scan_matcher=m,
                       max_points_per_scan=256, loop_closure_every=10**9)
    mapper = Mapper(cfg, device="cpu")
    runtime.run_bag(mapper, bag)
    proposed = sum(len(c[1]) for c in mapper.lc_log["candidates"])
    st = mapper.stats
    assert proposed >= 1
    assert st.loop_closures_accepted + st.loop_closures_rejected >= 1
    assert len(mapper.lc_log["decisions"]) == (st.loop_closures_accepted
                                              + st.loop_closures_rejected)
