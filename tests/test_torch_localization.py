"""The port's localization sessions against ndt_2d_tpu's, on the CPU twins.

Analogues of tests/test_mapper_e2e.py's localization cases with the JAX
tests' bounds: scan-match tracking in a saved box map (mean error < 0.12
m, and the same corrections as the JAX mapper within one lattice step),
the global grid auto-sized to the map, global relocalization over the
free space (6000 particles, last three errors < 0.5 m), the particle
filter tracking (mean < 0.35 m, no divergence), and recovery arming
lazily from the loaded map.  Also: the localized gate, the Configure
actions, map_to_odom and run_bag on a localization session.  The filter's
random numbers are torch's, so PF sessions are held to the bounds, not to
the JAX filter's poses.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ndt_2d_tpu.config import MapperConfig, ScanMatcherConfig
from ndt_2d_tpu.graph.pose_graph import Graph
from ndt_2d_tpu.mapping.mapper import Mapper as JaxMapper
from ndt_2d_tpu.utils import metrics, sim
from ndt_2d_tpu_torch.mapping import runtime
from ndt_2d_tpu_torch.mapping.mapper import (
    DISABLE_MAPPING, ENABLE_MAPPING, LOAD_FROM_FILE, SAVE_TO_FILE, Mapper)
from ndt_2d_tpu_torch.shared import record_synthetic

torch.set_num_threads(2)

MCFG = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
CFG = MapperConfig(local_scan_matcher=MCFG, global_scan_matcher=MCFG,
                   max_points_per_scan=512, loop_closure_every=10**9)
PF = dataclasses.replace(MapperConfig().particle_filter, min_particles=80,
                         max_particles=300, odom_alpha1=0.05,
                         odom_alpha2=0.05, odom_alpha3=0.05,
                         odom_alpha4=0.05)


def scan(world, pose, seed=None, n_beams=240):
    rng = None if seed is None else np.random.default_rng(seed)
    return sim.scan_at_pose(world, pose, n_beams=n_beams, range_max=14.0,
                            noise=0.0 if seed is None else 0.01, rng=rng)


def map_file(tmp_path_factory, world, truth, name):
    """Map ``truth`` with the port (noise-free odometry) and save it."""
    mapper = Mapper(CFG, device="cpu")
    for t in range(len(truth)):
        mapper.process_scan(scan(world, truth[t], seed=t), truth[t])
    path = str(tmp_path_factory.mktemp(name) / "map.npz")
    mapper.configure(SAVE_TO_FILE, path)
    return path


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    world = sim.make_box_world(10.0, 8.0)
    truth = np.stack([np.linspace(3.0, 7.0, 14), np.full(14, 4.0),
                      np.zeros(14)], axis=-1)
    return world, truth, map_file(tmp_path_factory, world, truth, "box")


def localizer(cfg, path, seed=3, mapper_cls=Mapper, **kw):
    loc = mapper_cls(cfg, seed=seed, **kw)
    loc.configure(LOAD_FROM_FILE, path)
    return loc


def track(loc, world, truth, odom, seed0):
    rel = metrics.relative_to_first(truth)
    errs, corr = [], []
    for t in range(1, len(truth)):
        res = loc.process_scan(scan(world, truth[t], seed=seed0 + t),
                               odom[t])
        if res.accepted:
            errs.append(float(np.hypot(*(res.pose[:2] - rel[t][:2]))))
            corr.append(res.correction)
    return np.asarray(errs), corr


def test_scan_match_localization(box):
    """test_mapper_e2e.py::TestLocalization::test_scan_match_localization,
    beside the JAX mapper on the same saved map and scans."""
    world, truth, path = box
    cfg = dataclasses.replace(CFG, enable_mapping=False)
    rel = metrics.relative_to_first(truth)
    odom = sim.drift_odometry(truth, 0.01, 0.003, seed=9)
    runs = []
    for cls, kw in ((Mapper, dict(device="cpu")), (JaxMapper, {})):
        loc = localizer(cfg, path, mapper_cls=cls, **kw)
        assert loc.graph.num_scans == 14
        # A loaded map needs a pose first (ndt_mapper.cpp:316-320).
        assert not loc.process_scan(scan(world, truth[0]),
                                    truth[0]).accepted
        loc.set_initial_pose(rel[0], np.diag([0.05, 0.05, 0.02]), truth[0])
        errs, corr = track(loc, world, truth, odom, 100)
        assert loc.graph.num_scans == 14  # localization never adds scans
        runs.append((errs, np.asarray(corr)))
    (errs, corr), (jerrs, jcorr) = runs
    assert len(errs) > 5 and len(errs) == len(jerrs)
    assert np.mean(errs) < 0.12
    assert np.all(np.abs(corr - jcorr) <= [0.005, 0.005, 0.0025])
    assert abs(np.mean(errs) - np.mean(jerrs)) < 0.005


def test_global_grid_autosizes_to_loaded_map():
    """test_mapper_e2e.py::TestLocalization::
    test_global_grid_autosizes_to_loaded_map."""
    g = Graph(max_points_per_scan=8)
    pts = np.zeros((8, 2), np.float32)
    for x in (0.0, 60.0):
        g.add_scan(np.asarray([x, 0.0, 0.0]), pts, np.ones(8, bool))
    cfg = dataclasses.replace(CFG, enable_mapping=False, max_range=12.0)
    loc = Mapper(cfg, graph=g, device="cpu")
    loc._ensure_matchers(12.0)
    gx = loc.global_matcher.config.grid_cells_x
    gy = loc.global_matcher.config.grid_cells_y
    assert gx >= (60 + 24) / 0.25 and gx % 32 == 0
    assert gy == 160  # never shrinks below the configured extent
    assert loc.global_matcher.grid is not None
    m = Mapper(CFG, device="cpu")
    m._ensure_matchers(12.0)
    assert m.global_matcher.config.grid_cells_x == 160


def test_particle_filter_tracks(box):
    """test_mapper_e2e.py::TestParticleFilterLocalization::
    test_particle_filter_tracks."""
    world, truth, path = box
    loc = localizer(dataclasses.replace(CFG, use_particle_filter=True,
                                        particle_filter=PF), path,
                    device="cpu")
    rel = metrics.relative_to_first(truth)
    loc.set_initial_pose(rel[0], np.diag([0.04, 0.04, 0.01]), truth[0])
    odom = sim.drift_odometry(truth, 0.01, 0.003, seed=21)
    errs, _ = track(loc, world, truth, odom, 300)
    assert loc.graph.num_scans == 14  # the filter never adds scans
    assert len(errs) > 5
    assert np.mean(errs) < 0.35
    half = len(errs) // 2
    assert np.mean(errs[half:]) < np.mean(errs[:half]) + 0.15
    assert loc.stats.timer.summary()["pf_step"]["count"] == len(errs)
    assert loc.filter.cloud().shape == (loc.filter.n_active, 3)
    assert np.isfinite(loc.map_to_odom()).all()


def test_recovery_arms_lazily_from_loaded_map(box):
    """test_mapper_e2e.py::TestParticleFilterLocalization::
    test_recovery_arms_lazily_from_loaded_map."""
    world, truth, path = box
    pf = dataclasses.replace(PF, odom_alpha1=0.2, odom_alpha2=0.2,
                             odom_alpha3=0.2, odom_alpha4=0.2,
                             recovery_alpha_slow=0.05,
                             recovery_alpha_fast=0.5)
    loc = localizer(dataclasses.replace(CFG, use_particle_filter=True,
                                        particle_filter=pf), path,
                    device="cpu")
    rel = metrics.relative_to_first(truth)
    loc.set_initial_pose(rel[0], np.diag([0.04, 0.04, 0.01]), truth[0])
    assert loc.filter.free_xy is None  # not armed before the first scan
    for t in range(1, 4):
        loc.process_scan(scan(world, truth[t], seed=40 + t), truth[t])
    assert loc.filter.recovery_enabled
    assert len(loc.filter.free_xy) > 100
    assert loc.filter.w_slow > 0.0 and loc.filter.w_fast > 0.0


def test_global_init_converges(tmp_path_factory):
    """test_mapper_e2e.py::TestGlobalRelocalization::
    test_global_init_converges: 6000 particles over the free space of the
    symmetry-broken office, no initial pose.  Whether 15 scans converge
    depends on the draws: over filter seeds 0-5, 2 runs of the JAX mapper
    and 3 of the port end within 0.5 m.  The JAX test holds the bound at
    its seed 7, this one at seed 5."""
    world = np.concatenate([sim.make_office_world(16.0),
                            np.asarray([[[1.0, 13.0], [3.0, 15.0]]])],
                           axis=0)
    n = 16
    truth = np.stack([np.linspace(2.0, 10.0, n), np.full(n, 2.0),
                      np.zeros(n)], axis=-1)
    path = map_file(tmp_path_factory, world, truth, "office")
    pf = dataclasses.replace(PF, min_particles=100, max_particles=6000)
    loc = localizer(dataclasses.replace(CFG, use_particle_filter=True,
                                        particle_filter=pf), path, seed=5,
                    device="cpu")
    assert loc.global_localize(truth[0])
    assert loc.filter.get_covariance()[0, 0] > 1.0  # meters of spread
    odom = sim.drift_odometry(truth, 0.01, 0.003, seed=31)
    errs, _ = track(loc, world, truth, odom, 900)
    assert len(errs) > 8
    assert np.mean(errs[-3:]) < 0.5


def test_global_localize_requires_pf_and_map():
    """test_mapper_e2e.py::TestGlobalRelocalization::
    test_global_localize_requires_pf_and_map."""
    assert not Mapper(CFG, device="cpu").global_localize(np.zeros(3))
    pf_cfg = dataclasses.replace(CFG, use_particle_filter=True)
    assert not Mapper(pf_cfg, device="cpu").global_localize(np.zeros(3))


def test_configure_actions_and_localization_session(box, tmp_path):
    """The Configure actions (srv/Configure.srv): DISABLE_MAPPING needs a
    new pose, ENABLE_MAPPING maps again; run_bag replays a localization
    session (its final loop_closure is a no-op) and leaves the map as it
    was."""
    world, truth, path = box
    m = Mapper(CFG, device="cpu")
    assert m.prev_odom_pose_is_initialized
    m.configure(DISABLE_MAPPING | LOAD_FROM_FILE, path)
    assert not m.enable_mapping and not m.prev_odom_pose_is_initialized
    assert m.map_update_available and m.graph.num_scans == 14
    m.configure(ENABLE_MAPPING)
    assert m.enable_mapping
    loc = localizer(dataclasses.replace(CFG, enable_mapping=False), path,
                    device="cpu")
    bag = record_synthetic("box", 12, n_beams=240, range_max=14.0, seed=4)
    # The box bag starts elsewhere in the room: place it in the map frame.
    start = bag.truth[0] - np.asarray([truth[0][0], truth[0][1], 0.0])
    loc.set_initial_pose(start, np.diag([0.01, 0.01, 0.01]), bag.odom[0])
    st = runtime.run_bag(loc, bag)
    assert st["scans_accepted"] >= 6
    assert st["graph_scans"] == 14 and st["loop_closures"] == 0
    assert loc.loop_closure() == 0
    assert np.isfinite(loc.map_to_odom()).all()
    assert st["ate_rmse_m"] < 0.1
    out = str(tmp_path / "again.npz")
    loc.configure(SAVE_TO_FILE, out)
    assert np.load(out)["poses"].shape == (14, 3)
