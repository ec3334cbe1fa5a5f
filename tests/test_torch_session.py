"""Session checkpoints, the control channel and the session verbs of the
port's CLI (``io/serialization.py``, ``mapping/runtime.py``, ``cli.py``),
on the CPU.

A session split by ``save_session`` / ``load_session`` goes on as the
continuous one does, synchronous and pipelined, mapping and with the
particle filter (bitwise: the rolling window rebuilt from the graph holds
the float32 poses the window's appends wrote, and the filter's next step
reads the particles and its generator's state, not the renormalized
weights).  Sessions cross between the two packages in both directions, key
for key; the control channel and its four verbs drive a running session;
``run --session-out`` / ``run --resume`` on two halves of a bag equal one
``run``."""

import dataclasses
import json
import socket
import time

import numpy as np
import pytest

from ndt_2d_tpu import cli as jax_cli
from ndt_2d_tpu.io import serialization as jax_serialization
from ndt_2d_tpu.mapping.mapper import Mapper as JaxMapper
from ndt_2d_tpu_torch import cli
from ndt_2d_tpu_torch.config import (
    MapperConfig, ParticleFilterConfig, ScanMatcherConfig)
from ndt_2d_tpu_torch.io import bag as bag_mod
from ndt_2d_tpu_torch.io import serialization
from ndt_2d_tpu_torch.mapping import runtime
from ndt_2d_tpu_torch.mapping.mapper import Mapper
from ndt_2d_tpu_torch.utils import sim
from port_configs import to_jax

N = 16
HALF = 8
MCFG = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
CFG = MapperConfig(local_scan_matcher=MCFG, global_scan_matcher=MCFG,
                   max_points_per_scan=512, loop_closure_every=10**9)
PF_CFG = dataclasses.replace(
    CFG, enable_mapping=False, use_particle_filter=True,
    particle_filter=ParticleFilterConfig(min_particles=100,
                                         max_particles=400))
GRAPH_ARRAYS = ("poses", "points", "point_mask", "constraint_begin",
                "constraint_end", "constraint_transform",
                "constraint_information", "constraint_switchable")
STATE = ("prev_odom_pose", "prev_robot_pose", "prev_odom_pose_is_initialized",
         "typical_matcher_response", "global_scans_processed",
         "optimization_last", "enable_mapping")


def _box():
    """The box scenario of tests/test_cli.py:123-160: 16 scans along a
    3 m line, drifting odometry."""
    world = sim.make_box_world(10.0, 8.0)
    truth = np.stack([np.linspace(3.0, 6.0, N), np.full(N, 4.0),
                      np.zeros(N)], -1)
    odom = sim.drift_odometry(truth, 0.01, 0.003, seed=2)
    scans = [sim.scan_at_pose(world, truth[t], n_beams=240, range_max=12.0,
                              noise=0.01, rng=np.random.default_rng(t))
             for t in range(N)]
    return scans, odom, truth


SCANS, ODOM, TRUTH = _box()


def _feed(mapper, ts):
    return [mapper.process_scan(SCANS[t], ODOM[t]) for t in ts]


def _same_graph(a, b):
    assert (a.num_scans, a.num_constraints) == (b.num_scans,
                                                b.num_constraints)
    for name in GRAPH_ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)),
                                      err_msg=name)


def _same_state(a, b):
    for name in STATE:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)),
                                      err_msg=name)


@pytest.fixture(scope="module")
def box_map(tmp_path_factory):
    """The box scenario mapped by the port, saved as a map file."""
    path = str(tmp_path_factory.mktemp("map") / "box_map.npz")
    mapper = Mapper(CFG, device="cpu")
    _feed(mapper, range(N))
    serialization.save_graph(mapper.graph, path)
    return path


def _localizer(cfg, map_path, seed=3):
    graph = serialization.load_graph(map_path, cfg.max_points_per_scan)
    loc = Mapper(cfg, graph=graph, seed=seed, device="cpu")
    loc.set_initial_pose(np.zeros(3), np.diag([0.01, 0.01, 0.003]), ODOM[0])
    return loc


# ---------------------------------------------------------------------------
# (a) mapping: split equals continuous
@pytest.mark.parametrize("inflight", [0, 8])
def test_split_mapping_session_equals_continuous(tmp_path, inflight):
    cfg = dataclasses.replace(CFG, max_inflight=inflight)
    cont = Mapper(cfg, device="cpu")
    _feed(cont, range(N))
    cont.flush()
    half = Mapper(cfg, device="cpu")
    _feed(half, range(HALF))
    ckpt = str(tmp_path / "session.npz")
    serialization.save_session(half, ckpt)
    resumed = serialization.load_session(ckpt, cfg, device="cpu")
    assert resumed.prev_odom_pose_is_initialized
    assert resumed._window_synced == -1 and resumed._pose_dev is None
    res = _feed(resumed, range(HALF, N))
    resumed.flush()
    assert all(r.accepted for r in res)
    assert all((r.pose is None) == bool(inflight) for r in res)
    _same_graph(resumed.graph, cont.graph)
    assert resumed.typical_matcher_response == cont.typical_matcher_response
    _same_state(resumed, cont)


# ---------------------------------------------------------------------------
# (b) sessions cross between the packages
@pytest.fixture(scope="module")
def jax_half(tmp_path_factory):
    """A JAX mapping session of the first half, saved."""
    path = str(tmp_path_factory.mktemp("jax") / "session.npz")
    m = JaxMapper(to_jax(CFG))
    _feed(m, range(HALF))
    jax_serialization.save_session(m, path)
    return path


def test_jax_session_loads_in_the_port(jax_half):
    ours = serialization.load_session(jax_half, CFG, device="cpu")
    theirs = jax_serialization.load_session(jax_half, to_jax(CFG))
    _same_graph(ours.graph, theirs.graph)
    _same_state(ours, theirs)
    assert ours.graph.num_scans == HALF and ours.filter is None


def test_jax_session_resumes_in_the_port_as_in_jax(jax_half):
    """Both packages resume the JAX checkpoint; the port's decisions equal
    JAX's and its corrections stay within one lattice step
    (tests/test_torch_slice.py:69-72)."""
    ours = serialization.load_session(jax_half, CFG, device="cpu")
    theirs = jax_serialization.load_session(jax_half, to_jax(CFG))
    ro, rt = _feed(ours, range(HALF, N)), _feed(theirs, range(HALF, N))
    assert [r.accepted for r in ro] == [r.accepted for r in rt]
    assert ours.graph.num_constraints == theirs.graph.num_constraints
    d = np.abs(np.stack([r.correction for r in ro])
               - np.stack([np.asarray(r.correction) for r in rt]))
    assert np.all(d <= [0.005, 0.005, 0.0025])
    assert np.mean(np.all(d < 1e-6, axis=1)) >= 0.9
    assert np.abs(ours.graph.poses - theirs.graph.poses).max() <= 0.01


@pytest.mark.parametrize("inflight", [0, 8])
def test_port_filter_session_loads_in_jax(tmp_path, box_map, inflight):
    """A port session carrying a filter loads in the unchanged JAX
    ``load_session``, field by field; its ``pf_key`` is
    ``jax.random.PRNGKey(seed)``."""
    import jax
    cfg = dataclasses.replace(PF_CFG, max_inflight=inflight)
    loc = _localizer(cfg, box_map, seed=3)
    _feed(loc, range(1, HALF))
    ckpt = str(tmp_path / "pf_session.npz")
    serialization.save_session(loc, ckpt)
    theirs = jax_serialization.load_session(ckpt, to_jax(cfg), seed=11)
    _same_graph(loc.graph, theirs.graph)
    _same_state(loc, theirs)
    f, g = loc.filter, theirs.filter
    np.testing.assert_array_equal(np.asarray(g.particles),
                                  f.particles.numpy())
    assert g.n_active == f.n_active
    np.testing.assert_allclose(np.asarray(g.weights), f.weights.numpy(),
                               rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(g._key),
                                  np.asarray(jax.random.PRNGKey(3)))
    np.testing.assert_allclose(g.get_mean(), f.get_mean(), atol=1e-5)


@pytest.mark.parametrize("with_filter", [False, True])
def test_session_keys_are_the_reference_schema(tmp_path, box_map,
                                               with_filter):
    """Every key JAX writes, with its dtype and shape; the port adds only
    its generator's state and device."""
    if with_filter:
        ours = _localizer(PF_CFG, box_map)
        theirs = JaxMapper(to_jax(PF_CFG), seed=3,
                           graph=jax_serialization.load_graph(
                               box_map, PF_CFG.max_points_per_scan))
        theirs.set_initial_pose(np.zeros(3), np.diag([0.01, 0.01, 0.003]),
                                ODOM[0])
    else:
        ours, theirs = Mapper(CFG, device="cpu"), JaxMapper(to_jax(CFG))
        _feed(ours, range(3))
        _feed(theirs, range(3))
    a, b = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    serialization.save_session(ours, a)
    jax_serialization.save_session(theirs, b)
    with np.load(a) as za, np.load(b) as zb:
        extra = set(za.files) - set(zb.files)
        assert extra == ({"pf_generator_state", "pf_generator_device"}
                         if with_filter else set())
        for k in zb.files:
            assert (za[k].dtype, za[k].shape) == (zb[k].dtype,
                                                  zb[k].shape), k


# ---------------------------------------------------------------------------
# (c) the filter
def torch_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


@pytest.mark.parametrize("inflight", [0, 8])
def test_split_filter_session_equals_continuous(tmp_path, box_map, inflight):
    cfg = dataclasses.replace(PF_CFG, max_inflight=inflight)
    cont = _localizer(cfg, box_map)
    _feed(cont, range(1, N))
    cont.flush()
    half = _localizer(cfg, box_map)
    _feed(half, range(1, HALF))
    ckpt = str(tmp_path / "pf.npz")
    serialization.save_session(half, ckpt)
    resumed = serialization.load_session(ckpt, cfg, seed=99, device="cpu")
    assert torch_equal(resumed.filter.gen.get_state(),
                       half.filter.gen.get_state())
    _feed(resumed, range(HALF, N))
    resumed.flush()
    np.testing.assert_array_equal(resumed.filter.particles.numpy(),
                                  cont.filter.particles.numpy())
    assert resumed.filter.n_active == cont.filter.n_active
    np.testing.assert_array_equal(resumed.prev_robot_pose,
                                  cont.prev_robot_pose)


def test_jax_filter_session_seeds_the_generator(tmp_path, box_map):
    import torch
    theirs = JaxMapper(to_jax(PF_CFG), seed=3,
                       graph=jax_serialization.load_graph(
                           box_map, PF_CFG.max_points_per_scan))
    theirs.set_initial_pose(np.zeros(3), np.diag([0.01, 0.01, 0.003]),
                            ODOM[0])
    ckpt = str(tmp_path / "jax_pf.npz")
    jax_serialization.save_session(theirs, ckpt)
    ours = serialization.load_session(ckpt, PF_CFG, seed=5, device="cpu")
    expect = torch.Generator().manual_seed(5).get_state()
    assert torch_equal(ours.filter.gen.get_state(), expect)
    np.testing.assert_array_equal(ours.filter.particles.numpy(),
                                  np.asarray(theirs.filter.particles))
    assert ours.filter.n_active == theirs.filter.n_active
    assert ours.filter.seed == 5


def test_generator_state_of_another_device_type_raises(tmp_path, box_map):
    loc = _localizer(PF_CFG, box_map)
    ckpt = str(tmp_path / "pf.npz")
    serialization.save_session(loc, ckpt)
    with np.load(ckpt) as z:
        fields = dict(z)
    assert str(fields["pf_generator_device"]) == "cpu"
    assert fields["pf_generator_state"].shape == (5056,)
    fields["pf_generator_device"] = np.str_("cuda")
    fields["pf_generator_state"] = np.zeros(16, np.uint8)
    moved = str(tmp_path / "moved.npz")
    np.savez_compressed(moved, **fields)
    with pytest.raises(ValueError, match="saved on cuda.*resume on cpu"):
        serialization.load_session(moved, PF_CFG, device="cpu")


def test_map_file_rejected_as_session(tmp_path, box_map):
    with pytest.raises(ValueError, match="session"):
        serialization.load_session(box_map, CFG, device="cpu")


# ---------------------------------------------------------------------------
# (d) the control channel.  Sockets are bound by a path relative to the
# test's directory: a UNIX socket's path is limited to 108 bytes.
def _small_mapper():
    cfg = MapperConfig(
        local_scan_matcher=ScanMatcherConfig(grid_cells_x=64,
                                             grid_cells_y=64),
        max_points_per_scan=64)
    return Mapper(cfg, device="cpu")


def test_configure_roundtrip(tmp_path, monkeypatch):
    """tests/test_cli.py:85-116 on the port."""
    mapper = _small_mapper()
    monkeypatch.chdir(tmp_path)
    sock = "ctl.sock"
    server = runtime.ControlServer(mapper, sock)
    try:
        time.sleep(0.05)
        assert runtime.send_configure(sock, 2)["ok"]
        assert mapper.enable_mapping is False
        assert runtime.send_configure(sock, 1)["ok"]
        assert mapper.enable_mapping is True
        mapper.graph.add_scan([1.0, 2.0, 0.1], np.zeros((64, 2), np.float32),
                              np.zeros(64, bool))
        map_path = str(tmp_path / "m.npz")
        assert runtime.send_configure(sock, 8, map_path)["ok"]
        assert runtime.send_configure(sock, 4, map_path)["ok"]
        assert mapper.graph.num_scans == 1
        assert mapper.prev_odom_pose_is_initialized is False
        out = runtime.send_configure(sock, 4, str(tmp_path / "none.npz"))
        assert out["ok"] is False and "none.npz" in out["error"]
    finally:
        server.close()


@pytest.mark.parametrize("verb", ["enable-mapping", "disable-mapping",
                                  "save-map", "load-map"])
def test_configure_verbs(tmp_path, monkeypatch, capsys, verb):
    mapper = _small_mapper()
    mapper.graph.add_scan([1.0, 2.0, 0.1], np.zeros((64, 2), np.float32),
                          np.zeros(64, bool))
    map_path = str(tmp_path / "m.npz")
    monkeypatch.chdir(tmp_path)
    sock = "c.sock"
    server = runtime.ControlServer(mapper, sock)
    try:
        argv = [verb, "--socket", sock]
        if verb == "load-map":
            serialization.save_graph(mapper.graph, map_path)
            mapper.graph.add_scan([2.0, 2.0, 0.1],
                                  np.zeros((64, 2), np.float32),
                                  np.zeros(64, bool))
        if verb in ("save-map", "load-map"):
            argv += ["--filename", map_path]
        if verb == "enable-mapping":
            mapper.enable_mapping = False
        assert cli.main(argv) == 0
        assert json.loads(capsys.readouterr().out) == {"ok": True}
        if verb == "enable-mapping":
            assert mapper.enable_mapping is True
        elif verb == "disable-mapping":
            assert mapper.enable_mapping is False
            assert not mapper.prev_odom_pose_is_initialized
        elif verb == "save-map":
            g = serialization.load_graph(map_path, 64)
            _same_graph(g, mapper.graph)
        else:
            assert mapper.graph.num_scans == 1
            assert not mapper.prev_odom_pose_is_initialized
    finally:
        server.close()


def test_run_bag_applies_actions_between_scans(tmp_path, monkeypatch):
    """An action sent from the progress callback lands before the next
    scan: mapping off at scan 5 rejects the scans after it, a save then
    holds the graph as it stood."""
    bag = bag_mod.record_synthetic("box", 10, n_beams=240, seed=4)
    mapper = Mapper(CFG, device="cpu")
    monkeypatch.chdir(tmp_path)
    sock = "r.sock"
    map_path = str(tmp_path / "mid.npz")
    control = runtime.ControlServer(mapper, sock)
    seen = {}

    def progress(t, res):
        if t == 5:
            assert runtime.send_configure(sock, 2)["ok"]
            assert runtime.send_configure(sock, 8, map_path)["ok"]
            seen["scans"] = mapper.graph.num_scans
    try:
        stats = runtime.run_bag(mapper, bag, progress=progress,
                                control=control)
    finally:
        control.close()
    assert stats["graph_scans"] == seen["scans"]
    assert stats["scans_accepted"] == seen["scans"]
    assert serialization.load_graph(map_path, 512).num_scans == seen["scans"]


# ---------------------------------------------------------------------------
# (g) the CLI
@pytest.fixture(scope="module")
def bags(tmp_path_factory):
    """A 16-scan box bag (time_increment 0: no de-skew, so a split bag
    loses nothing at its last scan) and its two halves."""
    d = tmp_path_factory.mktemp("bags")
    whole = str(d / "whole.npz")
    assert cli.main(["simulate", "--world", "box", "--scans", str(N),
                     "--beams", "180", "--range-max", "14.0",
                     "--out", whole]) == 0
    bag = bag_mod.load_bag(whole)
    assert bag.time_increment == 0.0
    out = [whole]
    for name, sl in (("a", slice(0, HALF)), ("b", slice(HALF, N))):
        part = bag_mod.ScanBag(
            ranges=bag.ranges[sl], angle_min=bag.angle_min,
            angle_increment=bag.angle_increment,
            time_increment=bag.time_increment, range_max=bag.range_max,
            odom=bag.odom[sl], truth=bag.truth[sl])
        path = str(d / f"{name}.npz")
        bag_mod.save_bag(part, path)
        out.append(path)
    return out


RUN = ["--device", "cpu", "--local_scan_matcher.grid_cells", "160",
       "--loop-closure-every", "1000000"]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_resume_equals_one_run(tmp_path, capsys, bags):
    whole, a, b = bags
    one, split = str(tmp_path / "one.npz"), str(tmp_path / "split.npz")
    session = str(tmp_path / "s.npz")
    assert cli.main(["run", "--bag", whole, "--map-out", one, *RUN]) == 0
    s_one = _last_json(capsys)
    assert cli.main(["run", "--bag", a, "--session-out", session,
                     *RUN]) == 0
    s_a = _last_json(capsys)
    assert s_a["session_out"] == session
    assert cli.main(["run", "--bag", b, "--resume", session, "--map-out",
                     split, *RUN]) == 0
    s_b = _last_json(capsys)
    assert s_a["scans_accepted"] + s_b["scans_accepted"] == \
        s_one["scans_accepted"]
    assert s_b["graph_scans"] == s_one["graph_scans"]
    _same_graph(serialization.load_graph(split, 512),
                serialization.load_graph(one, 512))


def test_cli_run_from_a_map(tmp_path, capsys, bags):
    """``run --map`` seeds the pose at the bag's first true pose, joins the
    map with one constraint and maps on."""
    whole, a, b = bags
    map_a = str(tmp_path / "a.npz")
    assert cli.main(["run", "--bag", a, "--map-out", map_a, *RUN]) == 0
    n_map = _last_json(capsys)["graph_scans"]
    out = str(tmp_path / "ab.npz")
    assert cli.main(["run", "--bag", b, "--map", map_a, "--map-out", out,
                     *RUN]) == 0
    stats = _last_json(capsys)
    assert stats["graph_scans"] == n_map + 1 + stats["scans_accepted"]
    g = serialization.load_graph(out, 512)
    assert g.num_constraints == stats["graph_scans"] - 1
    assert stats["ate_rmse_m"] < 0.15


def test_cli_localize_resume_equals_one_localize(tmp_path, capsys, bags):
    whole, a, b = bags
    map_path = str(tmp_path / "m.npz")
    assert cli.main(["run", "--bag", whole, "--map-out", map_path,
                     *RUN]) == 0
    capsys.readouterr()
    loc = ["--map", map_path, "--particle-filter", "--pf.max_particles",
           "300", "--global_scan_matcher.grid_cells", "160", "--device",
           "cpu"]
    one, second = str(tmp_path / "one.tum"), str(tmp_path / "b.tum")
    session = str(tmp_path / "s.npz")
    assert cli.main(["localize", "--bag", whole, "--traj-out", one,
                     *loc]) == 0
    capsys.readouterr()
    assert cli.main(["localize", "--bag", a, "--session-out", session,
                     *loc]) == 0
    capsys.readouterr()
    assert cli.main(["localize", "--bag", b, "--resume", session,
                     "--traj-out", second, *loc]) == 0
    stats = _last_json(capsys)
    assert stats["graph_scans"] == stats["graph_constraints"] + 1
    with open(one) as f:
        rows_one = f.read().splitlines()
    with open(second) as f:
        rows_b = f.read().splitlines()
    # The trajectory's rows are stamped by scan index within each bag.
    assert [r.split(" ", 1)[1] for r in rows_b] == \
        [r.split(" ", 1)[1] for r in rows_one[-len(rows_b):]]


@pytest.mark.parametrize("case", ["resume", "no_map"])
def test_global_init_refused(tmp_path, capsys, bags, case):
    whole, a, _ = bags
    if case == "resume":
        session = str(tmp_path / "s.npz")
        assert cli.main(["run", "--bag", a, "--session-out", session,
                         *RUN]) == 0
        capsys.readouterr()
        argv = ["localize", "--bag", whole, "--resume", session,
                "--particle-filter", "--global-init", "--device", "cpu"]
    else:
        argv = ["run", "--bag", whole, "--particle-filter", "--global-init",
                "--device", "cpu"]
    assert cli.main(argv) == 1
    assert "--global-init requires a map" in _last_json(capsys)["error"]


def test_socket_with_mesh_serves_the_verbs(tmp_path, monkeypatch, capsys,
                                          bags):
    """``run --mesh 2 --socket``: rank 0 serves the channel while the two
    gloo ranks replay the bag; saves sent from a client thread are each
    written once, at a scan boundary, and the run exits 0.  The first save
    may land at the boundary before scan 0; the second, sent after the
    first's reply, lands at a later boundary, after at least one scan."""
    import threading
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # a torch thread a rank
    sock = "mesh.sock"
    first, out = str(tmp_path / "first.npz"), str(tmp_path / "mesh_map.npz")
    box = {}

    def client():
        t0 = time.monotonic()
        while time.monotonic() - t0 < 120:
            try:
                box["first"] = runtime.send_configure(sock, 8, first)
                break
            except (FileNotFoundError, ConnectionRefusedError):
                time.sleep(0.002)
        box["out"] = runtime.send_configure(sock, 8, out)
    c = threading.Thread(target=client)
    c.start()
    try:
        assert cli.main(["run", "--bag", bags[0], "--mesh", "2", "--socket",
                         sock, *RUN]) == 0
    finally:
        c.join()
    capsys.readouterr()
    assert box["first"] == {"ok": True}
    assert box["out"] == {"ok": True}
    early = serialization.load_graph(first, 512)
    saved = serialization.load_graph(out, 512)
    assert early.num_scans <= saved.num_scans
    assert 1 <= saved.num_scans <= N


def test_run_with_socket_serves_the_verbs(tmp_path, monkeypatch, capsys,
                                         bags):
    """``run --socket``: the channel is open while the session runs and
    closed after it."""
    monkeypatch.chdir(tmp_path)
    sock = "run.sock"
    box = {}

    def call(t, res):
        if t == 3:
            box["out"] = runtime.send_configure(sock, 8,
                                                str(tmp_path / "m3.npz"))
    real = runtime.run_bag

    def run_bag(mapper, bag, progress=None, control=None):
        assert control is not None and control.path == sock
        return real(mapper, bag, progress=call, control=control)
    runtime.run_bag = run_bag
    try:
        assert cli.main(["run", "--bag", bags[1], "--socket", sock,
                         *RUN]) == 0
    finally:
        runtime.run_bag = real
    capsys.readouterr()
    assert box["out"] == {"ok": True}
    assert serialization.load_graph(str(tmp_path / "m3.npz"),
                                    512).num_scans >= 1
    with pytest.raises((FileNotFoundError, ConnectionRefusedError)):
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.connect(sock)


def _verbs(parser):
    return parser._subparsers._group_actions[0].choices


JAX_VERBS = sorted(_verbs(jax_cli._build_parser()))


@pytest.mark.parametrize("verb", JAX_VERBS)
def test_every_reference_verb_and_flag(verb):
    """Each verb of ``python -m ndt_2d_tpu.cli`` exists in the port's CLI
    with every one of its flags."""
    from ndt_2d_tpu import cli as jax_cli

    def flags(p):
        return {o for a in p._actions for o in a.option_strings}
    ours = _verbs(cli._build_parser())
    assert verb in ours
    assert flags(_verbs(jax_cli._build_parser())[verb]) <= flags(ours[verb])


def test_write_outputs_writes_session_grid_and_picture(tmp_path, capsys):
    """``write_outputs`` writes every requested output of a session,
    rendering the grid once for both the grid file and the picture."""
    mapper = Mapper(CFG, device="cpu")
    bag = bag_mod.record_synthetic("box", 6, n_beams=180, seed=1)
    stats = runtime.run_bag(mapper, bag)
    out = {k: str(tmp_path / f"{k}.{ext}") for k, ext in (
        ("traj", "tum"), ("map", "npz"), ("grid", "npz"), ("session", "npz"),
        ("viz", "png"))}
    renders = []
    real = mapper.render_map
    mapper.render_map = lambda: renders.append(1) or real()
    stats = runtime.write_outputs(mapper, stats, out["traj"], out["map"],
                                  out["grid"], out["session"], out["viz"],
                                  truth=bag.truth)
    assert renders == [1]
    assert json.loads(capsys.readouterr().out) == stats
    assert "_est" not in stats and stats["session_out"] == out["session"]
    resumed = serialization.load_session(out["session"], CFG, device="cpu")
    _same_graph(resumed.graph, mapper.graph)
    assert (np.load(out["grid"])["data"] == 100).sum() > 10
    with open(out["viz"], "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
