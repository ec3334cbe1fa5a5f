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
from ndt_2d_tpu_torch.kernels import candidate_gather as k6
from ndt_2d_tpu_torch.kernels import candidate_scores as k2
from ndt_2d_tpu_torch.mapping import runtime
from ndt_2d_tpu_torch.mapping.mapper import Mapper
from ndt_2d_tpu_torch.matching import matcher
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
        import ndt_2d_tpu_torch.mapping.merge
        import ndt_2d_tpu_torch.parallel.loop_search
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
            "newton.cu", "candidate_gather.cu", "descriptors.cu",
            "descriptor_search.cu", "pose_chain.cu", "correlative.cu",
            "common.cuh", "lattice.cuh"} <= names
    assert all(p.startswith(_build.CSRC) for p in _build.sources())
    assert _build.BUILD_DIR.startswith(os.path.dirname(_build.CSRC))
    # The build is lazy: importing the kernel modules compiled nothing.
    assert _build.build_info()["path"] == ""


@pytest.mark.parametrize("change", [
    dict(use_particle_filter=True, max_inflight=4),
    dict(enable_mapping=False, max_inflight=4),
    dict(max_inflight=8),
])
def test_pipelined_mapper_builds_and_runs(change, tmp_path):
    """Every pipelined mode (max_inflight > 0) builds and runs: mapping,
    and localizing by scan matching or the particle filter in a map of the
    same corridor, dispatch scans with their poses in flight, which the
    flush drains into the graph and the pose estimate."""
    bag = bag_mod.record_synthetic("corridor", 40, n_beams=120, seed=0)
    cfg = dataclasses.replace(CONFIG2, **change)
    if change.get("use_particle_filter") or "enable_mapping" in change:
        path = str(tmp_path / "map.npz")
        source = Mapper(CONFIG2, device="cpu")
        for t in range(5):
            source.process_scan(*bag[t])
        source.configure(8, path)  # SAVE_TO_FILE
        cfg = dataclasses.replace(cfg, particle_filter=dataclasses.replace(
            cfg.particle_filter, min_particles=50, max_particles=200))
        mapper = Mapper(cfg, device="cpu")
        mapper.configure(4, path)  # LOAD_FROM_FILE
        mapper.set_initial_pose(np.zeros(3), np.diag([0.01, 0.01, 0.005]),
                                bag.odom[0])
        results = [mapper.process_scan(*bag[t]) for t in range(1, 5)]
        assert all(r.accepted and r.pose is None for r in results)
        assert len(mapper._pending) == 4
        mapper.flush()
        assert not mapper._pending
        np.testing.assert_array_equal(results[-1].pose_future.result(),
                                      mapper.prev_robot_pose)
        assert np.isfinite(mapper.prev_robot_pose).all()
        if not change.get("use_particle_filter"):  # the filter's 200
            # particles stay spread along the featureless corridor
            assert np.hypot(*(mapper.prev_robot_pose[:2]
                              - source.graph.poses[4, :2])) < 0.3
        return
    mapper = Mapper(cfg, device="cpu")
    results = [mapper.process_scan(*bag[t]) for t in range(5)]
    assert all(r.accepted for r in results)
    assert results[0].pose is not None
    assert all(r.pose is None and r.pose_future is not None
               for r in results[1:])
    assert len(mapper._pending) == 4
    mapper.flush()
    assert not mapper._pending
    assert mapper.graph.num_constraints == 4
    for r, pose in zip(results[1:], mapper.graph.poses[1:]):
        np.testing.assert_array_equal(r.pose_future.result(), pose)


@pytest.mark.parametrize("change", [
    dict(loop_search="descriptor"),
    dict(loop_search="both"),
])
def test_descriptor_modes_build_their_coarse_matcher(change):
    """The descriptor modes build, and their matchers include the
    wide-lattice coarse one (kernel K6)."""
    cfg = dataclasses.replace(CONFIG2, **change)
    mapper = Mapper(cfg, device="cpu")
    mapper._ensure_matchers(15.0)
    assert mapper.coarse_matcher.config == cfg.coarse_scan_matcher
    assert matcher.search_kernel(cfg.coarse_scan_matcher) is k6
    assert matcher.search_kernel(cfg.global_scan_matcher) is k2


@pytest.mark.parametrize("change", [
    dict(search_linear_size=0.2, search_linear_resolution=0.02),
    dict(refine_iterations=8),
    dict(overlapping_grids=True),
])
def test_global_matcher_options_build_and_match(change):
    """Every global matcher option is ported: a lattice wider than a cell
    (kernel K6), the Newton polish (K7) and overlapping grids (K8); the
    mapper builds and one global match runs."""
    cfg = dataclasses.replace(
        CONFIG2, global_scan_matcher=dataclasses.replace(M192, **change))
    mapper = Mapper(cfg, device="cpu")
    mapper._ensure_matchers(15.0)
    world = sim.make_box_world(10.0, 8.0)
    pose = np.asarray([5.0, 4.0, 0.0], np.float32)
    pts, mask = sim.project_scan(sim.scan_at_pose(world, pose, 1440), 1440)
    m = mapper.global_matcher
    m.add_scans(pose[None], pts[None], mask[None])
    res = m.match_scan(pts, mask, int(mask.sum()), pose + [0.01, 0.0, 0.0])
    assert float(res.score) < -0.5
    if "search_linear_size" not in change:
        assert abs(float(res.correction[0]) + 0.01) < 0.006
        return
    # The +-0.2 m lattice finds the noise-free box's other optimum: hold
    # it to the JAX matcher's on the same window (1e-6: the jitted lattice
    # offsets contract an FMA).
    jcfg = ScanMatcherConfig(**dataclasses.asdict(m.config))
    start = pose + np.float32([0.01, 0.0, 0.0])
    ref = jax_matcher.match_scan(
        jcfg, jax_matcher.build_window_ndt(
            jcfg, pose[None], pts[None], mask[None], np.ones(1, bool), 15.0),
        pts, mask, np.int32(mask.sum()), start, 15.0)
    np.testing.assert_allclose(res.correction.numpy(),
                               np.asarray(ref.correction), rtol=0, atol=1e-6)
    assert float(res.score) == pytest.approx(float(ref.score), rel=1e-5)


def test_mesh_is_accepted(tmp_path):
    """A device mesh runs the session: a one-rank gloo mesh in this process
    maps the corridor to the single-device graph bitwise."""
    import torch.distributed as dist

    from ndt_2d_tpu_torch.io.bag import record_synthetic
    from ndt_2d_tpu_torch.parallel import distributed, mesh as mesh_mod
    bag = record_synthetic("corridor", 8, n_beams=120, seed=0)
    single = Mapper(CONFIG2, device="cpu")
    runtime.run_bag(single, bag)
    distributed.initialize("cpu", init_method="file://" + str(
        tmp_path / "rendezvous"), world_size=1, rank=0)
    try:
        meshed = []
        for mesh in (mesh_mod.make_mesh(), mesh_mod.single_axis_mesh()):
            meshed.append(Mapper(CONFIG2, device="cpu", mesh=mesh))
            runtime.run_bag(meshed[-1], bag)
    finally:
        dist.destroy_process_group()
    for m in meshed:
        assert m.graph.num_scans == single.graph.num_scans == 8
        np.testing.assert_array_equal(m.graph.poses, single.graph.poses)


def test_mesh_and_configure_actions_raise(tmp_path):
    """A mesh that is not a DeviceMesh raises; LOAD_FROM_FILE of a missing
    map raises."""
    with pytest.raises(TypeError):
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


def test_proposed_loop_closure_is_confirmed_and_gated():
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
