"""K11's point score in the lattice's launch and KB2 on the particle
launch's record read, on the CPU twins.

* ``match_scan_with_score`` (``matching/correlative.py``): its score is
  ``score_points_field``'s bitwise and op-by-op JAX's ``score_points_field``
  (``jax.disable_jit``) within 1e-6 (tests/test_torch_correlative.py's
  tolerance: the field adds in another order than XLA's convolution), and
  its match is ``match_scan_field``'s bitwise, across seeds and start poses,
  a pose whose beams leave the field and a scan of fewer points than
  ``laser_max_beams``; ``match_rows(..., with_unc=True)`` at R = 1, 3, 8 is
  R one-row calls; the launch block (laid out as the source's) carries an
  ``unc`` pointer beside the rows (a recorded C call).
* The mapper with ``scan_matcher_type="correlative"``: the box drive's
  accepts, poses, ``uncorrected_score`` and ``matched_score`` bitwise the
  parent's two calls (``score_points`` then ``match_scan``), mapping and
  localizing, and the jitted JAX mapper's at the decision level (accepts
  equal, poses within one lattice step: XLA contracts FMAs).
* KB2: ``records_twin`` at a stripe's ``row0`` is the SoA
  ``stripe_poses_twin`` bitwise at 2 and 4 stripes, with beams on the
  stripes' edges and cells of too few points; the particle plan of a
  stripe; ``block_order_sum`` (the one-pose block's additions) is
  ``lane_tree_sum`` at the world points' slot counts.
* ``score_points_sharded`` and ``score_particles_sharded_map`` on a
  one-rank gloo mesh: the dense twins bitwise, op-by-op JAX within
  tests/test_torch_ndt_blocks.py's tolerances.
"""

import ctypes
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu.mapping.mapper import Mapper as JaxMapper
from ndt_2d_tpu.matching import correlative as jax_correlative
from ndt_2d_tpu.matching import matcher as jax_matcher
from ndt_2d_tpu.ndt import grid as jax_grid
from ndt_2d_tpu_torch.config import MapperConfig, ScanMatcherConfig
from ndt_2d_tpu_torch.kernels import _build
from ndt_2d_tpu_torch.kernels import correlative as k11
from ndt_2d_tpu_torch.kernels import score_points as k3
from ndt_2d_tpu_torch.mapping.mapper import (LOAD_FROM_FILE, SAVE_TO_FILE,
                                             Mapper)
from ndt_2d_tpu_torch.matching import correlative
from ndt_2d_tpu_torch.matching.matcher import _search_offsets
from ndt_2d_tpu_torch.ndt import grid as ndt_grid
from ndt_2d_tpu_torch.parallel import distributed, ndt_blocks
from ndt_2d_tpu_torch.parallel import mesh as mesh_mod
from ndt_2d_tpu_torch.utils import metrics, sim
from port_configs import to_jax

import torch_blocks_ranks as ranks

torch.set_num_threads(2)

CSRC = k11.__file__.replace("kernels/correlative.py", "csrc/")
# 11 x 11 x 11 candidates x 60 beams: op-by-op JAX stays quick.
SMALL = ScanMatcherConfig(grid_cells_x=128, grid_cells_y=128,
                          search_angular_size=0.05,
                          search_angular_resolution=0.01,
                          search_linear_size=0.05,
                          search_linear_resolution=0.01, laser_max_beams=60)
WORLD = sim.make_box_world(10.0, 8.0)


def make_scan(pose, n_beams=360, rng=None):
    msg = sim.scan_at_pose(WORLD, np.asarray(pose, float), n_beams=n_beams,
                           range_max=15.0, noise=0.0 if rng is None else 0.01,
                           rng=rng)
    pts, mask = sim.project_scan(msg, 512)
    return torch.tensor(pts), torch.tensor(mask), int(mask.sum())


def window_field(cfg, seed):
    rng = None if seed is None else np.random.default_rng(seed)
    poses = np.asarray([[4.8, 3.9, 0.0], [5.0, 4.0, 0.05],
                        [5.2, 4.1, -0.05]], np.float32)
    scans = [make_scan(p, rng=rng) for p in poses]
    return correlative.build_field(
        cfg, torch.tensor(poses), torch.stack([s[0] for s in scans]),
        torch.stack([s[1] for s in scans]),
        torch.ones(len(poses), dtype=torch.bool), 15.0)


# --- (a) the fused score --------------------------------------------------
CASES = [(None, [5.0, 4.0, 0.0], 360), (0, [5.0, 4.0, 0.0], 360),
         (1, [5.0, 4.0, 0.0], 360), (0, [5.1, 3.9, 0.03], 360),
         (1, [4.93, 4.06, -0.04], 360),
         # beams past the field's far edges (the field spans ~32 m)
         (0, [16.0, 15.0, 0.8], 360), (None, [-9.0, -10.5, 2.5], 360),
         # fewer points than laser_max_beams (60)
         (0, [5.0, 4.0, 0.0], 40), (1, [5.02, 3.97, 0.01], 24)]


@pytest.mark.parametrize("seed,pose,beams", CASES)
def test_fused_score_is_the_point_score(seed, pose, beams):
    f, o = window_field(SMALL, seed)
    rng = None if seed is None else np.random.default_rng(100 + seed)
    qp, qm, qn = make_scan([5.0, 4.0, 0.0], n_beams=beams, rng=rng)
    pose = torch.tensor(pose, dtype=torch.float32)
    if beams < SMALL.laser_max_beams:
        assert qn < SMALL.laser_max_beams
    unc, res = correlative.match_scan_with_score(SMALL, f, o, qp, qm, qn,
                                                 pose)
    want = correlative.score_points_field(SMALL, f, o, qp, qm, qn, pose)
    match = correlative.match_scan_field(SMALL, f, o, qp, qm, qn, pose)
    assert unc.shape == () and torch.equal(unc, want)
    for got, ref in zip(res, match):
        assert torch.equal(got, ref)
    with jax.disable_jit():
        ref = jax_correlative.score_points_field(
            to_jax(SMALL), jnp.asarray(f.numpy()), jnp.asarray(o.numpy()),
            jnp.asarray(qp.numpy()), jnp.asarray(qm.numpy()), jnp.int32(qn),
            jnp.asarray(pose.numpy()))
    assert float(unc) == pytest.approx(float(ref), rel=0, abs=1e-6)


@pytest.mark.parametrize("R", [1, 3, 8])
def test_rows_with_unc_are_one_row_calls(R):
    dths, dls = _search_offsets(SMALL, torch.device("cpu"))
    fields, origins, qps, qms, qns, starts = [], [], [], [], [], []
    for r in range(R):
        f, o = window_field(SMALL, r % 3)
        qp, qm, qn = make_scan([5.0, 4.0, 0.0], n_beams=(360, 40)[r % 2],
                               rng=np.random.default_rng(r))
        fields.append(f)
        origins.append(o)
        qps.append(qp)
        qms.append(qm)
        qns.append(qn)
        starts.append(torch.tensor([5.02, 3.99 + 0.3 * (r == 5),
                                    0.01 * r]))
    rows, scores, unc = k11.match_rows(
        SMALL, torch.stack(fields), torch.stack(origins), torch.stack(qps),
        torch.stack(qms), torch.tensor(qns, dtype=torch.int32),
        torch.stack(starts), dths, dls, with_scores=True, with_unc=True)
    assert unc.shape == (R,)
    for r in range(R):
        one, u = k11.match(SMALL, fields[r], origins[r], qps[r], qms[r],
                           qns[r], starts[r], dths, dls, with_unc=True)
        _, s = k11.match(SMALL, fields[r], origins[r], qps[r], qms[r],
                         qns[r], starts[r], dths, dls, with_scores=True)
        assert torch.equal(rows[r:r + 1], one)
        assert torch.equal(unc[r:r + 1], u)
        assert torch.equal(scores[r], s)
        assert torch.equal(u, k11.score_batch(
            SMALL, fields[r], origins[r], qps[r], qms[r], qns[r],
            starts[r][None]))


class _Recorder:
    """A stand-in for a C entry: records its arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def _source_struct(name):
    """(type, field) of ``struct name`` in csrc/correlative.cu."""
    src = open(CSRC + "correlative.cu").read()
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for line in body.split(";"):
        line = line.replace("const ", "").strip()
        if line:
            kind, names = re.match(r"(\w+\*?)\s*(.*)", line, re.S).groups()
            fields += [(kind + "*" * f.strip().startswith("*"),
                        f.strip().lstrip("*")) for f in names.split(",")]
    return fields


def test_launch_block_matches_the_source_layout():
    """csrc/correlative.cu::LatticeTables and LatticeLaunch, field for
    field, with unc between out and ticket."""
    kinds = {"float": ctypes.c_float, "int": ctypes.c_int}
    for name, mirror in (("LatticeTables", k11._LatticeTables),
                         ("LatticeLaunch", k11._LatticeLaunch)):
        src = _source_struct(name)
        assert [f for _, f in src] == [f for f, _ in mirror._fields_]
        for (kind, field), (_, t) in zip(src, mirror._fields_):
            want = (ctypes.c_void_p if kind.endswith("*")
                    else kinds.get(kind, k11._LatticeTables))
            assert t is want, field
    names = [f for f, _ in k11._LatticeTables._fields_]
    assert names[-5:] == ["partial", "scores", "out", "unc", "ticket"]
    assert ctypes.sizeof(k11._LatticeTables) == 176
    assert ctypes.sizeof(k11._LatticeLaunch) == 192


@pytest.mark.parametrize("with_unc", [False, True])
def test_launch_hands_unc_in_the_block(monkeypatch, with_unc):
    """The launch block carries the [R] point scores' pointer (null
    without ``with_unc``); partials, rows and point scores are views of
    one allocation."""
    calls = []

    def function(name, argtypes):
        if name == "ndt2d_correlative_lattice_launch_size":
            return lambda: ctypes.sizeof(k11._LatticeLaunch)
        return lambda *args: calls.append(args) or 0
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream_reader", lambda dev: lambda: 4321)
    monkeypatch.setattr(_build, "sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(k11, "_TICKETS", {})
    monkeypatch.setattr(k11, "_LATTICE_LAUNCHERS", {})
    f, o = window_field(SMALL, 0)
    qp, qm, qn = make_scan([5.0, 4.0, 0.0])
    dths, dls = _search_offsets(SMALL, torch.device("cpu"))
    R = 3
    rows = [x[None].expand(R, *x.shape).contiguous()
            for x in (f, o, qp, qm, torch.tensor([5.0, 4.0, 0.0]))]
    nums = torch.full((R,), qn, dtype=torch.int32)
    out, scores, unc = k11._launch_match(SMALL, *rows[:4], nums, 0, rows[4],
                                         dths, dls, False, with_unc)
    launcher, = k11._LATTICE_LAUNCHERS.values()
    a = launcher.launch.a
    assert calls == [(launcher.address, 4321)]
    assert scores is None and out.shape == (R, 13)
    tiles = -(-dls.numel() ** 2 // k11.TILE)
    assert a.out == out.data_ptr() == a.partial + R * dths.numel() * tiles \
        * 12 * 4
    if with_unc:
        assert unc.shape == (R,)
        assert a.unc == unc.data_ptr() == out.data_ptr() + R * 13 * 4
    else:
        assert unc is None and a.unc is None
    assert launcher.plan == k11.lattice_plan(
        dths.numel(), dls.numel(), R, SMALL.laser_max_beams, 132,
        SMALL.search_linear_resolution / SMALL.ndt_resolution, with_unc)


@pytest.mark.parametrize("A,L,R,spills", [
    (80, 40, 1, False), (80, 21, 1, False), (80, 40, 64, False),
    (66, 21, 2, True), (132, 21, 1, True), (33, 40, 4, True)])
def test_plan_counts_the_score_block(A, L, R, spills):
    """With the point score, a row's grid has one block more, and the plan
    keeps a one-wave shape only where those blocks fit the SMs too: the
    box's and config 2's shapes (one row) keep theirs."""
    sms = 132
    plain = k11.lattice_plan(A, L, R, 100, sms, 0.03)
    scored = k11.lattice_plan(A, L, R, 100, sms, 0.03, score=True)
    assert (plain != scored) == spills
    if spills:
        # The plain plan's one wave, which its score blocks would pass.
        assert R * A * plain.groups <= sms < R * (A * plain.groups + 1)


def test_matcher_before_any_scan_returns_zeros():
    m = correlative.CorrelativeScanMatcher(SMALL, 15.0, device="cpu")
    unc, res = m.match_scan_with_score(np.zeros((8, 2), np.float32),
                                       np.zeros(8, bool), 0,
                                       np.zeros(3, np.float32))
    assert float(unc) == 0.0 and float(res.score) == 0.0
    assert not bool(res.correction.any())


# --- (c) the mapper -------------------------------------------------------
BOX = dataclasses.replace(ScanMatcherConfig(grid_cells_x=160,
                                            grid_cells_y=160),
                          search_linear_size=0.15,
                          search_linear_resolution=0.0075)


def box_config(**kw):
    return MapperConfig(scan_matcher_type="correlative",
                        local_scan_matcher=BOX,
                        global_scan_matcher=ScanMatcherConfig(
                            grid_cells_x=128, grid_cells_y=128),
                        max_points_per_scan=512, loop_closure_every=10**9,
                        **kw)


def box_drive():
    """tests/test_correlative.py::test_end_to_end_mapping's 14 scans."""
    truth = np.stack([np.linspace(3.0, 6.5, 14), np.full(14, 4.0),
                      np.zeros(14)], -1)
    odom = sim.drift_odometry(truth, 0.04, 0.012, seed=3)
    scans = [sim.scan_at_pose(WORLD, truth[t], n_beams=360, range_max=12.0,
                              noise=0.01, rng=np.random.default_rng(t))
             for t in range(len(truth))]
    return scans, odom, truth


def drive(mapper, scans, odom):
    out = []
    for msg, od in zip(scans, odom):
        r = mapper.process_scan(msg, od)
        out.append((r.accepted, None if r.pose is None else r.pose.copy(),
                    r.uncorrected_score, r.matched_score))
    return out


@pytest.fixture(scope="module")
def box():
    scans, odom, truth = box_drive()
    return scans, odom, truth, drive(Mapper(box_config(), device="cpu"),
                                     scans, odom)


def two_calls(monkeypatch):
    """The parent's generic surface: a matcher without the fused call."""
    monkeypatch.delattr(correlative.CorrelativeScanMatcher,
                        "match_scan_with_score")


def test_mapper_box_drive_equals_the_two_calls(box, monkeypatch):
    scans, odom, truth, fused = box
    two_calls(monkeypatch)
    parent = drive(Mapper(box_config(), device="cpu"), scans, odom)
    assert sum(a for a, *_ in fused) >= 12
    assert any(u != 0.0 for _, _, u, _ in fused)
    for (a, p, u, s), (a2, p2, u2, s2) in zip(fused, parent):
        assert a == a2 and u == u2 and s == s2
        np.testing.assert_array_equal(p, p2)
    est = np.asarray([p for a, p, *_ in fused if a])
    ate = metrics.ate_rmse(est, truth[[a for a, *_ in fused]])
    assert ate < 0.15


def test_localization_branch_equals_the_two_calls(box, tmp_path,
                                                  monkeypatch):
    """The scan-match localization branch's generic surface in a saved
    correlative map: poses and both scores bitwise the two calls'."""
    scans, odom, truth, _ = box
    mapper = Mapper(box_config(), device="cpu")
    drive(mapper, scans[:8], truth[:8])
    path = str(tmp_path / "map.npz")
    mapper.configure(SAVE_TO_FILE, path)

    def localize():
        loc = Mapper(dataclasses.replace(box_config(), enable_mapping=False),
                     device="cpu")
        loc.configure(LOAD_FROM_FILE, path)
        rel = metrics.relative_to_first(truth)
        loc.set_initial_pose(rel[0], np.diag([0.01, 0.01, 0.005]), odom[0])
        return drive(loc, scans[1:8], odom[1:8])
    fused = localize()
    two_calls(monkeypatch)
    parent = localize()
    assert all(a for a, *_ in fused)
    for (a, p, u, s), (a2, p2, u2, s2) in zip(fused, parent):
        assert a == a2 and u == u2 and s == s2
        np.testing.assert_array_equal(p, p2)


def test_mapper_box_drive_decisions_match_jax(box):
    scans, odom, _, fused = box
    jm = JaxMapper(to_jax(box_config()))
    ref = []
    for msg, od in zip(scans, odom):
        r = jm.process_scan(msg, od)
        ref.append((r.accepted, np.asarray(r.pose), float(r.uncorrected_score),
                    float(r.matched_score)))
    assert [a for a, *_ in fused] == [a for a, *_ in ref]
    for (_, p, u, s), (_, p2, u2, s2) in zip(fused, ref):
        np.testing.assert_allclose(p[:2], p2[:2], atol=0.0075)
        np.testing.assert_allclose(p[2], p2[2], atol=0.0025)
        assert u == pytest.approx(u2, abs=2e-3)
        assert s == pytest.approx(s2, abs=2e-3)


# --- (d) KB2's records twin -----------------------------------------------
CFG = ranks.CFG
W, H = CFG.grid_cells_x, CFG.grid_cells_y


@pytest.fixture(scope="module")
def blocks():
    x = ranks.blocks_inputs()
    t = ranks.t
    g = ndt_grid.build_ndt_from_scans(
        t(x["poses"]), t(x["points"]), t(x["pmask"]) & t(x["wmask"])[:, None],
        t(x["origin"]), CFG.ndt_resolution, W, H)
    return x, g, ndt_grid.packed_patch_table(g, W)


def stripe(g, table, S, s):
    h = H // S
    rows = slice(s * h * W, (s + 1) * h * W)
    sg = ndt_grid.NDTGrid(origin=g.origin, cell_size=g.cell_size,
                          mean=g.mean[rows], information=g.information[rows],
                          count=g.count[rows], covariance=g.covariance[rows])
    return sg, table[rows].contiguous(), s * h, h


def edge_poses(x, g, S, s):
    """The fixture's particles, then poses that put beams exactly on the
    stripe's lower and upper edges (a beam's world y a multiple of the
    cell at row0 and row0 + h) and into cells of fewer than 5 points."""
    h, cell = H // S, CFG.ndt_resolution
    oy = float(g.origin[1])
    qp = x["pf_points"]
    first = int(np.flatnonzero(x["pf_mask"])[0])
    extra = []
    for row in (s * h, (s + 1) * h, (s + 1) * h - 1):
        y = oy + row * cell - float(qp[first, 1])
        extra.append([5.0, y, 0.0])
    sparse = np.flatnonzero((g.count.numpy() > 0) & (g.count.numpy() < 5))
    assert sparse.size
    iy, ix = divmod(int(sparse[0]), W)
    cx = float(g.origin[0]) + (ix + 0.5) * cell - float(qp[first, 0])
    cy = oy + (iy + 0.5) * cell - float(qp[first, 1])
    extra.append([cx, cy, 0.0])
    return torch.cat([torch.tensor(x["particles"]),
                      torch.tensor(extra, dtype=torch.float32)])


@pytest.mark.parametrize("S,s", [(2, 0), (2, 1), (4, 0), (4, 1), (4, 2)])
def test_records_twin_at_a_stripe_is_the_soa_twin(blocks, S, s):
    x, g, table = blocks
    sg, tab, row0, h = stripe(g, table, S, s)
    poses = edge_poses(x, g, S, s)
    qp, qm = torch.tensor(x["pf_points"]), torch.tensor(x["pf_mask"])
    n = int(qm.sum())
    soa = k3.stripe_poses_twin(sg, W, row0, h, CFG.laser_max_beams, qp, qm,
                               n, poses)
    rec = k3.records_twin(sg, tab, W, h, CFG.laser_max_beams, qp, qm, n,
                          poses, row0, True)
    assert torch.equal(rec, soa)
    assert torch.equal(k3.stripe_poses(sg, tab, W, row0, h,
                                       CFG.laser_max_beams, qp, qm, n,
                                       poses), soa)
    # A stripe holding scorable cells scored some beam (4 stripes' first
    # holds none: every beam there reads an empty cell or none).
    assert bool((soa != 0).any()) == bool((sg.count >= 5).any())
    divided = k3.records_twin(sg, tab, W, h, CFG.laser_max_beams, qp, qm, n,
                              poses, row0)
    used = min(CFG.laser_max_beams, n)
    assert torch.equal(divided, rec / ndt_grid.f32(used, qp.device))


def test_stripes_add_to_the_dense_records(blocks):
    """At one stripe the records twin is the dense score_records twin; the
    4 stripes' raw sums add to the dense raw sum within float rounding."""
    x, g, table = blocks
    qp, qm = torch.tensor(x["pf_points"]), torch.tensor(x["pf_mask"])
    n = int(qm.sum())
    poses = torch.tensor(x["particles"])
    dense = k3.records_twin(g, table, W, H, CFG.laser_max_beams, qp, qm, n,
                            poses)
    assert torch.equal(dense, k3.score_batch_twin(
        g, W, H, CFG.laser_max_beams, qp, qm, n, poses))
    parts = sum(k3.records_twin(*stripe(g, table, 4, s)[:2], W, H // 4,
                                CFG.laser_max_beams, qp, qm, n, poses,
                                s * (H // 4), True) for s in range(4))
    used = min(CFG.laser_max_beams, n)
    np.testing.assert_allclose((parts / used).numpy(), dense.numpy(),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("S,s", [(2, 1), (4, 2)])
def test_world_points_on_a_stripe(blocks, S, s):
    """stripe_points on the CPU, the identity-pose records twin (the
    kernel's one-pose block) and the SoA twin: the same bits."""
    x, g, table = blocks
    sg, tab, row0, h = stripe(g, table, S, s)
    pts = torch.tensor(x["score_points"])
    msk = torch.tensor(x["score_mask"])
    P = pts.shape[0]
    soa = k3.stripe_points_twin(sg, W, row0, h, pts, msk)
    rec = -k3.records_twin(sg, tab, W, h, P, pts, msk, P,
                           torch.zeros(1, 3), row0, True)
    assert torch.equal(rec, soa)
    assert torch.equal(k3.stripe_points(sg, tab, W, row0, h, pts, msk), soa)


def test_stripe_plan_carries_the_rows(blocks):
    x, g, table = blocks
    sg, tab, row0, h = stripe(g, table, 4, 2)
    qp = torch.tensor(x["pf_points"])
    poses = torch.tensor(x["particles"])
    M = poses.shape[0]
    plan = k3.particle_plan(sg, tab, W, h, 100, qp, M, False, row0, True)
    assert k3.particle_plan(sg, tab, W, h, 100, qp, M, False, row0,
                            True) is plan
    assert k3.particle_plan(sg, tab, W, h, 100, qp, M, False, 0,
                            True) is not plan
    a = plan.args
    assert (a.W, a.row0, a.h, a.stride, a.M, a.motion, a.raw) == (
        W, row0, h, 32, M, 0, 1)
    shapes = {name: shape for name, _, shape in plan.map_expect + plan.expect}
    assert shapes["table"] == (h * W, 32) and shapes["origin"] == (2,)
    plan._fn, plan._stream = _Recorder(), (lambda: 99)
    qm = torch.tensor(x["pf_mask"])
    _, out = plan.run(qp, qm, 7, sg.origin, tab, poses)
    L = plan.launch
    assert plan._fn.calls == [(plan.address, 99)]
    assert (L.table, L.poses, L.out, L.num_points) == (
        tab.data_ptr(), poses.data_ptr(), out.data_ptr(), 7)
    assert ctypes.addressof(plan.launch) == plan.address


@pytest.mark.parametrize("slots", [360, 384, 96])
def test_one_pose_block_adds_in_lane_order(slots):
    """The one-pose block's additions (``block_order_sum`` at
    ``pose_plan``'s threads) are the warp-per-pose lane order's bits."""
    terms = torch.tensor(np.random.default_rng(slots).random(
        -(-slots // 32) * 32, np.float32) * 1e3)
    _, threads = k3.pose_plan(slots)
    assert torch.equal(k3.block_order_sum(terms, threads),
                       k3.lane_tree_sum(terms[None])[0])


# --- (e) the sharded entries on a one-rank mesh ---------------------------
def test_sharded_scores_on_a_one_rank_mesh(blocks, tmp_path):
    x, g, _ = blocks
    t = ranks.t
    distributed.initialize("cpu", init_method="file://" + str(
        tmp_path / "rendezvous"), world_size=1, rank=0)
    try:
        mesh = mesh_mod.make_mesh()
        sg = ndt_blocks.build_ndt_sharded(
            mesh, t(x["poses"]), t(x["points"]), t(x["pmask"]),
            t(x["wmask"]), t(x["origin"]), CFG.ndt_resolution, W, H)
        score = ndt_blocks.score_points_sharded(
            mesh, sg, t(x["score_points"]), t(x["score_mask"]))
        n = int(x["pf_mask"].sum())
        weights = ndt_blocks.score_particles_sharded_map(
            CFG, mesh, sg, t(x["pf_points"]), t(x["pf_mask"]), n,
            t(x["particles"]))
    finally:
        torch.distributed.destroy_process_group()
    sc = ndt_grid.score_points(g, t(x["score_points"]), t(x["score_mask"]),
                               W, H)
    assert torch.equal(score, k3.lane_tree_sum(k3._pad32(sc[None]))[0])
    assert torch.equal(weights, k3.score_batch_twin(
        g, W, H, CFG.laser_max_beams, t(x["pf_points"]), t(x["pf_mask"]), n,
        t(x["particles"])))
    with jax.disable_jit():
        jg = jax_grid.build_ndt_from_scans(
            jnp.asarray(x["poses"]), jnp.asarray(x["points"]),
            jnp.asarray(x["pmask"]) & jnp.asarray(x["wmask"])[:, None],
            jnp.asarray(x["origin"]), jnp.float32(CFG.ndt_resolution), W, H)
        jscore = jnp.sum(jax_grid.score_points(
            jg, jnp.asarray(x["score_points"]), jnp.asarray(x["score_mask"]),
            W, H))
        jweights = jax_matcher.score_points_batch(
            to_jax(CFG), jg, jnp.asarray(x["pf_points"]),
            jnp.asarray(x["pf_mask"]), jnp.int32(n),
            jnp.asarray(x["particles"]))
    assert float(score) > 1.0
    np.testing.assert_allclose(float(score), float(jscore), rtol=1e-5)
    np.testing.assert_allclose(weights.numpy(), np.asarray(jweights),
                               rtol=1e-5, atol=1e-6)
