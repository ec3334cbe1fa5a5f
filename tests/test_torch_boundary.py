"""The port's boundary: it imports nothing of the JAX package, and its own
copies of that package's numpy modules (configuration, pose graph, bag and
map I/O, the CARMEN importer, scan projection, simulator, metrics, session
statistics) behave exactly as the originals do: equal fields and defaults,
bitwise-equal arrays on seeded inputs, and files that load in either
package.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest

from ndt_2d_tpu import config as jax_config
from ndt_2d_tpu.graph import pose_graph as jax_pose_graph
from ndt_2d_tpu.io import bag as jax_bag
from ndt_2d_tpu.io import carmen as jax_carmen
from ndt_2d_tpu.io import serialization as jax_serialization
from ndt_2d_tpu.mapping import laser as jax_laser
from ndt_2d_tpu.utils import metrics as jax_metrics
from ndt_2d_tpu.utils import profiling as jax_profiling
from ndt_2d_tpu.utils import sim as jax_sim
from ndt_2d_tpu_torch import config
from ndt_2d_tpu_torch.graph import pose_graph
from ndt_2d_tpu_torch.io import bag, carmen, native, serialization
from ndt_2d_tpu_torch.mapping import laser
from ndt_2d_tpu_torch.utils import metrics, profiling, sim
from port_configs import to_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_sources():
    # chip_smoke.py and the mesh tests' rank bodies run without the
    # reference too.
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "tests", "torch_mesh_ranks.py"),
           os.path.join(ROOT, "tests", "torch_blocks_ranks.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "ndt_2d_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def imported_roots(path):
    """(module, line) of every import in ``path``, those inside functions
    included."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, node.lineno


@pytest.mark.parametrize("banned", ["ndt_2d_tpu", "jax"])
def test_no_port_module_imports_the_reference(banned):
    files = port_sources()
    assert len(files) > 30
    found = [(os.path.relpath(p, ROOT), line)
             for p in files for mod, line in imported_roots(p)
             if mod == banned or mod.startswith(banned + ".")]
    assert not found, found


@pytest.mark.parametrize("name", ["ScanMatcherConfig", "ParticleFilterConfig",
                                  "SolverConfig", "MapperConfig"])
def test_config_dataclasses_equal_the_reference(name):
    ours, ref = getattr(config, name), getattr(jax_config, name)
    assert ([f.name for f in dataclasses.fields(ours)]
            == [f.name for f in dataclasses.fields(ref)])
    assert to_jax(ours()) == ref()
    assert ours.__dataclass_params__.frozen == ref.__dataclass_params__.frozen


@pytest.mark.parametrize("change", [
    {}, dict(search_angular_size=0.05, search_linear_size=0.15,
             search_linear_resolution=0.01, ndt_resolution=0.35),
    dict(search_angular_resolution=0.003, search_linear_resolution=0.007,
         grid_cells_x=96, grid_cells_y=160)])
def test_matcher_config_derived_sizes_equal_the_reference(change):
    ours = config.ScanMatcherConfig(**change)
    ref = jax_config.ScanMatcherConfig(**change)
    for p in ("num_angles", "num_linear", "num_candidates", "num_cells"):
        assert getattr(ours, p) == getattr(ref, p), p
    for size, res in ((0.1, 0.0025), (0.05, 0.005), (0.15, 0.01),
                      (1.0, 0.03)):
        assert config._num_steps(size, res) == jax_config._num_steps(size,
                                                                     res)


def test_project_scan_equals_the_reference():
    rng = np.random.default_rng(0)
    for k in range(4):
        ranges = rng.uniform(0.2, 14.0, 360).astype(np.float32)
        ranges[rng.random(360) < 0.1] = np.nan
        kw = dict(ranges=ranges, angle_min=-np.pi,
                  angle_increment=2 * np.pi / 360, time_increment=1e-4,
                  range_max=12.0)
        args = (10.0, rng.normal(0, 0.1, 3), bool(k % 2),
                rng.normal(0, 0.05, 3) if k > 1 else None, 256)
        ours = laser.project_scan(sim.LaserScanMsg(**kw), *args)
        ref = jax_laser.project_scan(jax_sim.LaserScanMsg(**kw), *args)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", ["corridor", "box", "office"])
def test_record_synthetic_equals_the_reference(world):
    ours = bag.record_synthetic(world, 12, n_beams=120, seed=3)
    ref = jax_bag.record_synthetic(world, 12, n_beams=120, seed=3)
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)


def test_graph_equals_the_reference_after_the_same_adds():
    rng = np.random.default_rng(1)
    graphs = [pose_graph.Graph(64), jax_pose_graph.Graph(64)]
    make = [pose_graph.make_constraint_np, jax_pose_graph.make_constraint_np]
    for i in range(80):  # past the first capacity doubling
        pose = rng.normal(0, 3.0, 3)
        pts = rng.normal(0, 2.0, (64, 2)).astype(np.float32)
        mask = rng.random(64) < 0.8
        cov = np.diag(rng.uniform(0.01, 0.1, 3))
        for g, mk in zip(graphs, make):
            g.add_scan(pose, pts, mask)
            if i:
                mk(g, i - 1, i, cov, switchable=bool(i % 7 == 0))
    for g in graphs:
        g.set_poses(g.poses + 0.01)
    ours, ref = graphs
    for f in ("poses", "points", "point_mask", "constraint_begin",
              "constraint_end", "constraint_transform",
              "constraint_information", "constraint_switchable",
              "points_padded", "point_mask_padded"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
    np.testing.assert_array_equal(ours.barycenters(), ref.barycenters())
    np.testing.assert_array_equal(ours.barycenter(7), ref.barycenter(7))
    for q in rng.normal(0, 3.0, (5, 2)):
        np.testing.assert_array_equal(ours.find_nearest(q, 4.0),
                                      ref.find_nearest(q, 4.0))


def test_metrics_equal_the_reference():
    rng = np.random.default_rng(2)
    truth = np.cumsum(rng.normal(0, 0.3, (50, 3)), 0)
    est = truth + rng.normal(0, 0.05, truth.shape)
    np.testing.assert_array_equal(metrics.relative_to_first(est),
                                  jax_metrics.relative_to_first(est))
    for fn in ("ate_rmse", "ate_rmse_aligned"):
        assert getattr(metrics, fn)(est, truth) == getattr(jax_metrics, fn)(
            est, truth)


def test_session_stats_summary_equals_the_reference():
    stats = [profiling.SessionStats(), jax_profiling.SessionStats()]
    for s in stats:
        for k, score in enumerate([None, -0.4, -0.7, None]):
            s.record_scan(k != 3, score)
        s.loop_closures_accepted = 2
        s.timer.total["local_match"] = 0.5
        s.timer.count["local_match"] = 4
    assert stats[0].summary() == stats[1].summary()


@pytest.mark.parametrize("saver", ["port", "reference"])
def test_maps_load_in_either_package(tmp_path, saver):
    rng = np.random.default_rng(4)
    g = (pose_graph.Graph if saver == "port" else jax_pose_graph.Graph)(32)
    for i in range(6):
        g.add_scan(rng.normal(0, 1, 3),
                   rng.normal(0, 1, (32, 2)).astype(np.float32),
                   rng.random(32) < 0.7)
        if i:
            g.add_constraint(i - 1, i, rng.normal(0, 0.1, 3),
                             np.eye(3) * 100.0, False)
    path = str(tmp_path / "map.npz")
    save, load = ((serialization.save_graph, jax_serialization.load_graph)
                  if saver == "port" else
                  (jax_serialization.save_graph, serialization.load_graph))
    save(g, path)
    back = load(path, 48)
    assert back.max_points == 48
    np.testing.assert_array_equal(back.points[:, :32], g.points)
    for f in ("poses", "constraint_begin", "constraint_end",
              "constraint_transform", "constraint_information"):
        np.testing.assert_array_equal(getattr(back, f), getattr(g, f))
    times = np.arange(6) * 0.1
    serialization.save_tum(str(tmp_path / "a.tum"), times, g.poses)
    jax_serialization.save_tum(str(tmp_path / "b.tum"), times, g.poses)
    assert (open(tmp_path / "a.tum").read()
            == open(tmp_path / "b.tum").read())
    for a, b in zip(serialization.load_tum(str(tmp_path / "a.tum")),
                    jax_serialization.load_tum(str(tmp_path / "a.tum"))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("suffix", [".npz", ".ndtbag"])
def test_bags_round_trip(tmp_path, suffix):
    """npz bags load in either package; the port's own build of the native
    codec reads back what it wrote (the JAX package's loader is not run
    here: it builds into the directory its own tests use)."""
    b = bag.record_synthetic("box", 6, n_beams=90, seed=5)
    path = str(tmp_path / ("bag" + suffix))
    bag.save_bag(b, path)
    loads = [bag.load_bag]
    if suffix == ".npz":
        loads.append(jax_bag.load_bag)
    else:
        assert native.build().startswith(native.BUILD_DIR)
    for load in loads:
        back = load(path)
        for f in ("ranges", "odom", "truth"):
            np.testing.assert_array_equal(getattr(back, f), getattr(b, f))
        assert back.angle_increment == b.angle_increment


def _rl1_line(ranges, pose, ts, n_rem=0):
    """A ROBOTLASER1 line over a 180-degree field of view
    (tests/test_carmen.py's format)."""
    n = len(ranges)
    vals = " ".join(f"{v:.3f}" for v in ranges)
    rem = " ".join(["0.0"] * n_rem)
    x, y, th = pose
    return (f"ROBOTLASER1 0 {-np.pi / 2:.6f} {np.pi:.6f} "
            f"{np.pi / max(n - 1, 1):.6f} 81.90 0.01 0 {n} {vals} "
            f"{n_rem}{' ' if n_rem else ''}{rem} {x:.6f} {y:.6f} {th:.6f} "
            f"{x:.6f} {y:.6f} {th:.6f} 0.1 0.0 0.5 0.3 0.2 {ts:.6f} host "
            f"{ts:.6f}\n")


def _carmen_log(tmp_path, kind):
    """The log files of tests/test_carmen.py: (path, load_carmen keyword
    arguments)."""
    path = str(tmp_path / f"{kind}.clf")
    rng = np.random.default_rng(0)
    lines = []
    if kind == "flaser":
        ref = jax_bag.record_synthetic("box", 12, n_beams=181, seed=4)
        ref = dataclasses.replace(ref, angle_min=-np.pi / 2,
                                  angle_increment=np.pi / 180)
        jax_carmen.save_carmen(ref, path)
        return path, dict(fov_degrees=180.0)
    if kind == "out_of_range":
        vals = " ".join(["2.0"] * 5 + ["81.91"] + ["2.0"] * 5)
        lines = [f"FLASER 11 {vals} 0 0 0 0 0 0 0.0 host 0.0\n",
                 "ODOM 0 0 0 0 0 0 0.0 host 0.0\n"]
    elif kind == "robotlaser1":
        lines = ["# comment line\n", "PARAM robot_frontlaser_offset 0.08\n"]
        lines += [_rl1_line(rng.uniform(1.0, 9.0, 91), (0.1 * t, 0.0, 0.0),
                            100.0 + 0.2 * t, n_rem=3) for t in range(8)]
    elif kind == "mixed":
        for t in range(10):
            lines.append(_rl1_line(rng.uniform(1, 9, 181), (0.1 * t, 0, 0),
                                   10.0 + 0.1 * t))
            if t % 2 == 0:
                lines.append(_rl1_line(rng.uniform(1, 9, 61),
                                       (0.1 * t, 0, 0), 10.05 + 0.1 * t))
        lines.append("FLASER 3 1.0 2.0\n")
    elif kind == "timestamps":
        vals = " ".join(["5.0"] * 7)
        lines = [f"FLASER 7 {vals} {0.1*t} 0 0 {0.1*t} 0 0 "
                 f"{50.0 + 0.25 * t} host {50.0 + 0.25 * t}\n"
                 for t in range(5)]
        with open(path, "w") as f:
            f.writelines(lines)
        return path, dict(time_increment=1e-3, use_laser_pose=False)
    with open(path, "w") as f:
        f.writelines(lines)
    return path, {}


def _assert_bags_equal(ours, ref):
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if b is None:
            assert a is None, f.name
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("kind", ["flaser", "out_of_range", "robotlaser1",
                                  "mixed", "timestamps"])
def test_carmen_import_equals_the_reference(tmp_path, kind):
    """The port's CARMEN importer gives the JAX importer's bag bitwise, and
    the same report, on the log fixtures of tests/test_carmen.py."""
    path, kw = _carmen_log(tmp_path, kind)
    reports = [carmen.CarmenReport(), jax_carmen.CarmenReport()]
    ours = carmen.load_carmen(path, report=reports[0], **kw)
    ref = jax_carmen.load_carmen(path, report=reports[1], **kw)
    _assert_bags_equal(ours, ref)
    assert (dataclasses.asdict(reports[0])
            == dataclasses.asdict(reports[1]))


def test_carmen_simlab_log_equals_the_reference():
    """datasets/simlab.clf.gz (BASELINE config 9) imports bitwise equal."""
    log = os.path.join(ROOT, "datasets", "simlab.clf.gz")
    ours = carmen.load_carmen(log, range_max=10.0)
    ref = jax_carmen.load_carmen(log, range_max=10.0)
    assert len(ours) > 1500
    _assert_bags_equal(ours, ref)


def test_carmen_writer_equals_the_reference(tmp_path):
    """save_carmen writes the JAX writer's bytes, and its log reads back."""
    b = bag.record_synthetic("corridor", 6, n_beams=91, seed=2)
    carmen.save_carmen(b, str(tmp_path / "a.clf"))
    jax_carmen.save_carmen(jax_bag.record_synthetic("corridor", 6,
                                                    n_beams=91, seed=2),
                           str(tmp_path / "b.clf"))
    assert (open(tmp_path / "a.clf").read()
            == open(tmp_path / "b.clf").read())
    back = carmen.load_carmen(str(tmp_path / "a.clf"), fov_degrees=360.0)
    assert back.ranges.shape == b.ranges.shape
