"""The port's pipelined paths (max_inflight > 0) against ndt_2d_tpu's.

K13's twin (the device pose chain) against op-by-op JAX
``mapping_step_async`` / ``localization_step_async`` (new pose within
1e-6, equal correction) and across the +-pi wrap; the port's pipelined
mapper against the JAX pipelined mapper and against its own synchronous
mapper on the scenarios of tests/test_mapper_e2e.py:555-707, cut to 10-16
scans, with those tests' bounds: equal scan and constraint counts, poses
within 0.03 m (0.1 m for the particle filter), EWMA within 0.02.  The
pipelined chain dead-reckons in float32 on the device and the synchronous
one in float64 on the host, so the two meet at the bounds, not bitwise.
The filter's ``step_async`` / ``resolve_async`` equal ``step`` bitwise
with the same seed and controls.  Also: drains before consumers and
grids that grow, map_to_odom without a drain, run_bag's deferred poses,
and the CLI's ``import-carmen`` and ``--max-inflight``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu.filter import particle_filter as jax_pf
from ndt_2d_tpu.mapping.mapper import (LOAD_FROM_FILE as JAX_LOAD,
                                       Mapper as JaxMapper)
from ndt_2d_tpu.matching import matcher as jax_matcher
from ndt_2d_tpu_torch import cli
from ndt_2d_tpu_torch.config import MapperConfig, ScanMatcherConfig
from ndt_2d_tpu_torch.filter.particle_filter import ParticleFilter
from ndt_2d_tpu_torch.io import carmen
from ndt_2d_tpu_torch.io.bag import record_synthetic
from ndt_2d_tpu_torch.kernels import pose_chain as k13
from ndt_2d_tpu_torch.kernels import score_points as k3
from ndt_2d_tpu_torch.mapping import runtime
from ndt_2d_tpu_torch.mapping.mapper import (LOAD_FROM_FILE, SAVE_TO_FILE,
                                             Mapper)
from ndt_2d_tpu_torch.matching import matcher
from ndt_2d_tpu_torch.utils import metrics, sim
from port_configs import to_jax

torch.set_num_threads(2)

MCFG = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
CFG = MapperConfig(local_scan_matcher=MCFG, global_scan_matcher=MCFG,
                   max_points_per_scan=512, loop_closure_every=10**9)
# A small lattice for the op-by-op JAX comparisons: 9 x 11 x 11 x 40.
SMALL = ScanMatcherConfig(grid_cells_x=96, grid_cells_y=96,
                          search_angular_size=0.02,
                          search_angular_resolution=0.005,
                          search_linear_size=0.05,
                          search_linear_resolution=0.01, laser_max_beams=40)


def corridor_trajectory(n, step=0.18):
    """tests/test_mapper_e2e.py's straight drive with a gentle weave."""
    xs = 2.0 + step * np.arange(n)
    ys = 1.5 + 0.2 * np.sin(np.linspace(0, 2 * np.pi, n))
    ths = np.zeros(n)
    ths[1:] = np.arctan2(np.diff(ys), np.diff(xs))
    return np.stack([xs, ys, ths], axis=-1)


WORLD = sim.make_corridor_world(40.0, 3.0)


def scan(truth, t, seed):
    return sim.scan_at_pose(WORLD, truth[t], n_beams=240, range_max=12.0,
                            noise=0.01, rng=np.random.default_rng(seed))


def map_session(mapper, truth, odom):
    for t in range(len(truth)):
        mapper.process_scan(scan(truth, t, t), odom[t])
    mapper.flush()
    g = mapper.graph
    return dict(poses=g.poses.copy(), n=g.num_scans, c=g.num_constraints,
                ewma=mapper.typical_matcher_response)


# --- K13's twin against op-by-op JAX ------------------------------------

def window_inputs(seed):
    """A 3-scan box window, a query scan and a start pose, from ``seed``."""
    rng = np.random.default_rng(seed)
    world = sim.make_box_world(10.0, 8.0)
    poses = np.asarray([[4.8, 3.9, 0.0], [5.0, 4.0, 0.05],
                        [5.2, 4.1, -0.05]], np.float32)
    pts, msk = zip(*[sim.project_scan(sim.scan_at_pose(
        world, p, 180, rng=rng, noise=0.01), 256) for p in poses])
    q = np.asarray([5.3, 4.05, 0.02])
    qp, qm = sim.project_scan(sim.scan_at_pose(world, q, 180, rng=rng,
                                               noise=0.01), 256)
    prev = (q - [0.2, 0.05, 0.01] + rng.normal(0, 0.01, 3)).astype(
        np.float32)
    delta = np.asarray([0.2, 0.05, 0.01], np.float32)
    return (poses, np.stack(pts), np.stack(msk), qp, qm, int(qm.sum()),
            prev, delta)


@pytest.mark.parametrize("seed", [0, 1])
def test_mapping_step_matches_op_by_op_jax(seed):
    poses, pts, msk, qp, qm, qn, prev, delta = window_inputs(seed)
    win = matcher.RollingWindow(torch.tensor(poses), torch.tensor(pts),
                                torch.tensor(msk), torch.ones(3, dtype=bool))
    window, new_pose, out, copy = matcher.mapping_step_async(
        SMALL, win, torch.tensor(prev), 15.0, torch.tensor(qp),
        torch.tensor(qm), qn, torch.tensor(delta))
    with jax.disable_jit():
        jwin = jax_matcher.RollingWindow(
            jnp.asarray(poses), jnp.asarray(pts), jnp.asarray(msk),
            jnp.ones(3, bool))
        _, jpose, jout = jax_matcher.mapping_step_async(
            to_jax(SMALL), jwin, jnp.asarray(prev), jnp.float32(15.0),
            jnp.asarray(qp), jnp.asarray(qm), jnp.int32(qn),
            jnp.asarray(delta))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(jout[2]))
    np.testing.assert_allclose(new_pose.numpy(), np.asarray(jpose),
                               rtol=0, atol=1e-6)
    assert float(out[1]) == pytest.approx(float(jout[1]), rel=1e-5)
    # The window shifted and took the corrected pose in its newest slot;
    # the host copy holds (unc, score, correction, covariance, pose).
    np.testing.assert_array_equal(window.poses[-1].numpy(),
                                  new_pose.numpy())
    np.testing.assert_array_equal(window.poses[:2].numpy(), poses[1:])
    np.testing.assert_array_equal(window.points[-1].numpy(), qp)
    host = copy.wait()
    np.testing.assert_array_equal(host[14:17], new_pose.numpy())
    np.testing.assert_array_equal(host[2:5], out[2].numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_localization_step_matches_op_by_op_jax(seed):
    poses, pts, msk, qp, qm, qn, prev, delta = window_inputs(seed)
    grid, table = matcher.build_window_ndt(
        SMALL, torch.tensor(poses), torch.tensor(pts), torch.tensor(msk),
        torch.ones(3, dtype=bool), 15.0)
    new_pose, out, copy = matcher.localization_step_async(
        SMALL, grid, torch.tensor(prev), torch.tensor(qp), torch.tensor(qm),
        qn, torch.tensor(delta), table)
    with jax.disable_jit():
        jgrid = jax_matcher.build_window_ndt(
            to_jax(SMALL), jnp.asarray(poses), jnp.asarray(pts),
            jnp.asarray(msk), jnp.ones(3, bool), jnp.float32(15.0))
        jpose, jout = jax_matcher.localization_step_async(
            to_jax(SMALL), jgrid, jnp.asarray(prev), jnp.asarray(qp),
            jnp.asarray(qm), jnp.int32(qn), jnp.asarray(delta))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(jout[2]))
    np.testing.assert_allclose(new_pose.numpy(), np.asarray(jpose),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(copy.wait()[5:8], new_pose.numpy())


@pytest.mark.parametrize("theta", [3.13, -3.13, np.pi, -np.pi])
def test_compose_wraps_at_pi(theta):
    """The start pose K3's composed entry dead-reckons (its twin) against
    the JAX step's float32 expression, op by op, where the heading crosses
    +-pi."""
    prev = np.asarray([1.0, -2.0, theta], np.float32)
    delta = np.asarray([0.1, 0.02, 0.03 if theta > 0 else -0.03],
                       np.float32)
    poses, pts, msk, qp, qm, qn, _, _ = window_inputs(0)
    grid, _ = matcher.build_window_ndt(
        SMALL, torch.tensor(poses), torch.tensor(pts), torch.tensor(msk),
        torch.ones(3, dtype=bool), 15.0)
    _, pose = k3.score_composed(grid, SMALL.grid_cells_x,
                                SMALL.grid_cells_y, SMALL.laser_max_beams,
                                torch.tensor(qp), torch.tensor(qm), qn,
                                torch.tensor(prev), torch.tensor(delta))
    ours = pose.numpy()
    with jax.disable_jit():
        p, d = jnp.asarray(prev), jnp.asarray(delta)
        c, s = jnp.cos(p[2]), jnp.sin(p[2])
        th = p[2] + d[2]
        ref = np.asarray(jnp.stack([p[0] + c * d[0] - s * d[1],
                                    p[1] + s * d[0] + c * d[1],
                                    jnp.arctan2(jnp.sin(th), jnp.cos(th))]))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    assert -np.pi <= ours[2] <= np.pi
    assert abs(ours[2] - theta) > np.pi  # it wrapped


def test_apply_writes_the_window_slot():
    """K13's window append with a correction: the corrected pose comes
    back and fills the newest slot; without a window it is the pose
    alone."""
    pose = torch.tensor([1.0, 2.0, 0.5])
    corr = torch.tensor([0.01, -0.02, 0.003])
    win = matcher.make_window(4, 8, device="cpu")
    pts = torch.ones(8, 2)
    new = k13.window_append(pose, corr, win, pts,
                            torch.ones(8, dtype=torch.bool))
    np.testing.assert_array_equal(new.numpy(), (pose + corr).numpy())
    np.testing.assert_array_equal(win.poses[-1].numpy(), new.numpy())
    assert not win.poses[:-1].any()
    assert torch.equal(win.points[-1], pts) and bool(win.mask[-1])
    assert torch.equal(k13.window_append(pose, corr), new)


# --- mapping: port pipelined vs JAX pipelined vs port synchronous --------

@pytest.fixture(scope="module")
def corridor():
    """tests/test_mapper_e2e.py::test_matches_synchronous_path, 12 scans:
    the port synchronous and at max_inflight 8, the JAX mapper at 8."""
    truth = corridor_trajectory(12)
    odom = sim.drift_odometry(truth, trans_noise=0.008, rot_noise=0.002,
                              seed=5)
    pipe = dataclasses.replace(CFG, max_inflight=8)
    return dict(
        sync=map_session(Mapper(CFG, device="cpu"), truth, odom),
        pipe=map_session(Mapper(pipe, device="cpu"), truth, odom),
        jax=map_session(JaxMapper(to_jax(pipe)), truth, odom))


@pytest.mark.parametrize("other", ["sync", "jax"])
def test_pipelined_mapping_counts(corridor, other):
    assert corridor["pipe"]["n"] == corridor[other]["n"] == 12
    assert corridor["pipe"]["c"] == corridor[other]["c"] == 11


@pytest.mark.parametrize("other", ["sync", "jax"])
def test_pipelined_mapping_poses(corridor, other):
    np.testing.assert_allclose(corridor["pipe"]["poses"],
                               corridor[other]["poses"], atol=0.03)


@pytest.mark.parametrize("other", ["sync", "jax"])
def test_pipelined_mapping_ewma(corridor, other):
    assert abs(corridor["pipe"]["ewma"] - corridor[other]["ewma"]) < 0.02


def test_deferred_results_and_drain_order():
    """Mapping scans after the first defer their pose; the drain fills the
    graph in dispatch order with the futures' poses; at most max_inflight
    steps stay in flight."""
    truth = corridor_trajectory(8)
    mapper = Mapper(dataclasses.replace(CFG, max_inflight=3), device="cpu")
    results = []
    for t in range(len(truth)):
        results.append(mapper.process_scan(scan(truth, t, t), truth[t]))
        assert len(mapper._pending) <= 3
    assert results[0].pose is not None and results[0].pose_future is None
    assert all(r.pose is None for r in results[1:])
    mapper.flush()
    g = mapper.graph
    for t, r in enumerate(results[1:], 1):
        np.testing.assert_array_equal(r.pose_future.result(), g.poses[t])
        assert r.score_future.result() < 0.0
    assert mapper.stats.summary()["scans_accepted"] == 8


def test_consumers_force_drain():
    """render_map, graph_snapshot and map_to_odom see a drained graph
    (test_mapper_e2e.py::test_consumers_force_drain), as the JAX mapper's
    do."""
    truth = corridor_trajectory(10)
    cfg = dataclasses.replace(CFG, max_inflight=32)  # never auto-drains
    out = {}
    for name, mapper in (("port", Mapper(cfg, device="cpu")),
                         ("jax", JaxMapper(to_jax(cfg)))):
        for t in range(len(truth)):
            mapper.process_scan(scan(truth, t, t), truth[t].copy())
        assert mapper._pending
        grid = mapper.render_map()
        assert not mapper._pending
        assert mapper.graph.num_constraints == mapper.graph.num_scans - 1
        assert (grid.data == 100).sum() > 0
        assert np.isfinite(mapper.graph.poses).all()
        assert np.isfinite(mapper.map_to_odom()).all()
        out[name] = mapper.graph.poses.copy()
    np.testing.assert_allclose(out["port"], out["jax"], atol=0.03)
    mapper = Mapper(cfg, device="cpu")
    mapper.process_scan(scan(truth, 0, 0), truth[0])
    mapper.process_scan(scan(truth, 1, 1), truth[1])
    assert mapper._pending
    snap = mapper.graph_snapshot()
    assert not mapper._pending and snap["edges"].shape == (1, 2)


def test_map_to_odom_undrained_consistent():
    """map_to_odom(drain=False) mid-pipeline pairs the odometry-composed
    estimate with the newest odometry
    (test_mapper_e2e.py::test_map_to_odom_undrained_consistent)."""
    truth = corridor_trajectory(12)
    odom = sim.drift_odometry(truth, trans_noise=0.005, rot_noise=0.001,
                              seed=7)
    mapper = Mapper(dataclasses.replace(CFG, max_inflight=8), device="cpu")
    for t in range(len(truth)):
        mapper.process_scan(scan(truth, t, t), odom[t])
    assert mapper._pending
    fast = mapper.map_to_odom(drain=False)
    assert mapper._pending
    exact = mapper.map_to_odom()
    assert not mapper._pending
    assert float(np.hypot(*(fast[:2] - exact[:2]))) < 0.25


def test_grow_mid_pipeline_drains_first():
    """A window that outgrows the static grid rebuilds the local matcher
    only after every in-flight step has drained; the window's host mirror
    takes the same approximate pose as the host chain."""
    bag = record_synthetic("corridor", 5, n_beams=120, seed=0)
    mapper = Mapper(dataclasses.replace(CFG, max_inflight=8), device="cpu")
    pending_at_grow = []
    grow = mapper._grow_matcher

    def recording(attr, grown):
        grow(attr, grown)
        pending_at_grow.append(len(mapper._pending))
    mapper._grow_matcher = recording
    results = []
    for t, (msg, odom) in enumerate(bag):
        results.append(mapper.process_scan(msg, odom))
        if t:  # the first scan maps synchronously
            np.testing.assert_array_equal(
                mapper._window_poses_host[-1],
                mapper._approx_pose.astype(np.float32))
    assert pending_at_grow and not any(pending_at_grow)
    assert mapper.local_matcher.config.grid_cells_x > 160
    mapper.flush()
    assert mapper.graph.num_constraints == 4
    for t, r in enumerate(results[1:], 1):
        np.testing.assert_array_equal(r.pose_future.result(),
                                      mapper.graph.poses[t])


def test_run_bag_resolves_deferred_poses():
    bag = record_synthetic("corridor", 40, n_beams=120, seed=1)
    bag = dataclasses.replace(
        bag, ranges=bag.ranges[:10], odom=bag.odom[:10],
        truth=bag.truth[:10])
    mapper = Mapper(dataclasses.replace(CFG, max_inflight=4), device="cpu")
    stats = runtime.run_bag(mapper, bag)
    assert stats["scans_accepted"] == 10
    np.testing.assert_array_equal(stats["_est_t"], np.arange(10))
    np.testing.assert_array_equal(stats["_est"], mapper.graph.poses)
    assert stats["ate_rmse_m"] < stats["odom_ate_rmse_m"]


# --- localization: scan matching and the particle filter -----------------

@pytest.fixture(scope="module")
def saved_map(tmp_path_factory):
    truth = corridor_trajectory(16)
    mapper = Mapper(CFG, device="cpu")
    for t in range(len(truth)):
        mapper.process_scan(scan(truth, t, t), truth[t])
    path = str(tmp_path_factory.mktemp("pipe") / "map.npz")
    mapper.configure(SAVE_TO_FILE, path)
    return truth, path


def localize(mapper, load, path, truth, odom, seed0, init_cov):
    """Load the map at ``path``, start at the first true pose and track
    ``truth``'s scans; returns the final pose estimate."""
    mapper.configure(load, path)
    rel = metrics.relative_to_first(truth)
    mapper.set_initial_pose(rel[0], init_cov, odom[0])
    for t in range(1, len(truth)):
        mapper.process_scan(scan(truth, t, seed0 + t), odom[t])
    mapper.flush()
    return mapper.prev_robot_pose.copy()


@pytest.fixture(scope="module")
def localization(saved_map):
    """test_localization_matches_synchronous: scan-match localization of a
    drifting odometry along the first 10 scans of the saved 16-scan map,
    port synchronous and pipelined, JAX pipelined."""
    truth, path = saved_map
    truth = truth[:10]
    odom = sim.drift_odometry(truth, trans_noise=0.006, rot_noise=0.002,
                              seed=9)
    cov = np.diag([0.01, 0.01, 0.005])
    loc = dataclasses.replace(CFG, enable_mapping=False)
    pipe = dataclasses.replace(loc, max_inflight=8)
    return dict(
        truth=truth,
        sync=localize(Mapper(loc, device="cpu"), LOAD_FROM_FILE, path,
                      truth, odom, 500, cov),
        pipe=localize(Mapper(pipe, device="cpu"), LOAD_FROM_FILE, path,
                      truth, odom, 500, cov),
        jax=localize(JaxMapper(to_jax(pipe)), JAX_LOAD, path, truth, odom,
                     500, cov))


@pytest.mark.parametrize("other", ["sync", "jax"])
def test_pipelined_localization_matches(localization, other):
    np.testing.assert_allclose(localization["pipe"], localization[other],
                               atol=0.03)


def test_pipelined_localization_tracks_truth(localization):
    rel = metrics.relative_to_first(localization["truth"])
    np.testing.assert_allclose(localization["pipe"][:2], rel[-1][:2],
                               atol=0.3)


PF = dataclasses.replace(MapperConfig().particle_filter, min_particles=100,
                         max_particles=400, odom_alpha1=0.05,
                         odom_alpha2=0.05, odom_alpha3=0.05,
                         odom_alpha4=0.05)


@pytest.fixture(scope="module")
def filtering(saved_map):
    """test_particle_filter_pipelined, 16 scans: the filter synchronous
    and at max_inflight 4 (port, same seed), and JAX's at 4."""
    truth, path = saved_map
    truth16 = truth
    odom = sim.drift_odometry(truth16, trans_noise=0.004, rot_noise=0.001,
                              seed=3)
    cov = np.diag([0.02, 0.02, 0.01])
    pf = dataclasses.replace(CFG, use_particle_filter=True,
                             particle_filter=PF)
    pipe = dataclasses.replace(pf, max_inflight=4)
    return dict(
        truth=truth16,
        sync=localize(Mapper(pf, seed=11, device="cpu"), LOAD_FROM_FILE,
                      path, truth16, odom, 700, cov),
        pipe=localize(Mapper(pipe, seed=11, device="cpu"), LOAD_FROM_FILE,
                      path, truth16, odom, 700, cov),
        jax=localize(JaxMapper(to_jax(pipe), seed=11), JAX_LOAD, path,
                     truth16, odom, 700, cov))


@pytest.mark.parametrize("arm", ["sync", "pipe", "jax"])
def test_filter_tracks_truth(filtering, arm):
    rel = metrics.relative_to_first(filtering["truth"])
    assert np.hypot(*(filtering[arm][:2] - rel[-1][:2])) < 0.4


@pytest.mark.parametrize("other", ["sync", "jax"])
def test_pipelined_filter_matches(filtering, other):
    np.testing.assert_allclose(filtering["pipe"], filtering[other], atol=0.1)


@pytest.mark.parametrize("inflight", [0, 4])
def test_global_localize_after_steps_seeds_every_particle(saved_map,
                                                          inflight):
    """Filter steps leave their active count on the device; a global
    relocalization after them spreads all max_particles over the free
    space, and its statistics are op-by-op JAX's over that whole cloud."""
    truth, path = saved_map
    truth = truth[:5]
    # A looser KLD bound, so the tracked cloud needs fewer particles.
    pf = dataclasses.replace(PF, kld_err=0.05)
    cfg = dataclasses.replace(CFG, use_particle_filter=True,
                              particle_filter=pf, max_inflight=inflight)
    mapper = Mapper(cfg, seed=11, device="cpu")
    localize(mapper, LOAD_FROM_FILE, path, truth, truth, 700,
             np.diag([0.02, 0.02, 0.01]))
    f = mapper.filter
    assert f.n_active < PF.max_particles  # the steps shrank the cloud
    assert mapper.global_localize(truth[-1])
    assert f.n_active == PF.max_particles
    m = PF.max_particles
    with jax.disable_jit():
        _, jmean, jcov = jax_pf.update_statistics(
            jnp.asarray(f.particles.numpy()), jnp.full((m,), 1.0 / m),
            jnp.arange(m) < m)
    np.testing.assert_allclose(f.get_mean(), np.asarray(jmean), rtol=1e-6,
                               atol=1e-6)
    scale = (1.0 + np.abs(np.asarray(jmean)[:2]).max()) ** 2
    np.testing.assert_allclose(f.get_covariance(), np.asarray(jcov), rtol=0,
                               atol=1e-6 * scale)


def test_step_async_equals_step_bitwise(saved_map):
    """The same seed and controls through step() and through step_async
    (three in flight) then resolve_async: the same particles, weights and
    n_active, bit for bit."""
    truth, path = saved_map
    m = Mapper(dataclasses.replace(CFG, enable_mapping=False), device="cpu")
    m.configure(LOAD_FROM_FILE, path)
    m._ensure_matchers(12.0)
    grid_matcher = m.global_matcher
    rel = metrics.relative_to_first(truth)
    scans = [sim.project_scan(scan(truth, t, 900 + t), 512)
             for t in range(1, 4)]
    controls = [np.asarray([0.18, 0.01, 0.02]), np.asarray([0.17, 0.0, 0.0]),
                np.asarray([0.19, -0.01, -0.02])]
    filters = [ParticleFilter(PF, seed=5, device="cpu") for _ in range(2)]
    for f in filters:
        f.init(*rel[0], 0.05, 0.05, 0.02)
    means = [filters[0].step(grid_matcher, c, p, k, int(k.sum()))
             for c, (p, k) in zip(controls, scans)]
    handles = [filters[1].step_async(grid_matcher, c, p, k, int(k.sum()))
               for c, (p, k) in zip(controls, scans)]
    assert filters[1].n_active == PF.min_particles  # nothing read yet
    resolved = [filters[1].resolve_async(h) for h in handles]
    np.testing.assert_array_equal(resolved[-1], means[-1])
    for a, b in ((filters[0].particles, filters[1].particles),
                 (filters[0].weights, filters[1].weights)):
        assert torch.equal(a, b)
    assert filters[0].n_active == filters[1].n_active


# --- the CLI --------------------------------------------------------------

def test_cli_import_carmen_then_pipelined_run_and_localize(tmp_path,
                                                          capsys):
    """``import-carmen`` turns a CARMEN log into a bag, which ``run`` and
    ``localize`` replay with ``--max-inflight``: the pipelined run keeps
    the synchronous run's scans and constraints and writes every pose."""
    bag = record_synthetic("corridor", 40, n_beams=120, seed=2)
    bag = dataclasses.replace(bag, ranges=bag.ranges[:10],
                              odom=bag.odom[:10], truth=None)
    log, path = str(tmp_path / "log.clf"), str(tmp_path / "bag.npz")
    carmen.save_carmen(bag, log)
    assert cli.main(["import-carmen", "--log", log, "--out", path,
                     "--fov-degrees", "360"]) == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["scans"] == 10 and info["beams"] == 120
    map_out = str(tmp_path / "map.npz")
    common = ["--bag", path, "--device", "cpu",
              "--local_scan_matcher.grid_cells", "192",
              "--global_scan_matcher.grid_cells", "192",
              "--loop-closure-every", "1000000000"]
    stats = []
    for argv in (["run", *common],
                 ["run", *common, "--max-inflight", "4", "--map-out",
                  map_out, "--traj-out", str(tmp_path / "t.tum")],
                 ["localize", *common, "--map", map_out, "--max-inflight",
                  "4"]):
        assert cli.main(argv) == 0
        stats.append(json.loads(capsys.readouterr().out.strip()
                                .splitlines()[-1]))
    sync, pipe = stats[:2]
    assert pipe["scans_accepted"] == sync["scans_accepted"] == 10
    assert pipe["graph_constraints"] == sync["graph_constraints"] == 9
    assert len(open(tmp_path / "t.tum").read().splitlines()) == 10
    assert stats[2]["scans_accepted"] >= 8
