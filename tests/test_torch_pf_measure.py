"""The particle filter's measurement launch: K9's motion sample folded into
K3's particle launch, which reads one cell record a beam, under a plan.

``score_points.motion_score`` is the motion sample of every particle and its
score at the moved pose (JAX's ``pf_step`` before the resample:
``motion_model.sample``, then ``matcher.score_points_batch``), one launch on
the card; ``score_points.score_records`` is the same launch with the motion off
(the mesh's sharded measurement).  On the CPU both run their twins:
``motion_twin``, then ``records_twin``, which reads each cell from its record
(the first 8 floats of a patch-table row, or a ``packed_cell_table`` row) where
``score_batch_twin`` reads the SoA arrays.  What the CPU can hold of the launch
itself: its plan (made once a shape, the launch block laid out as the source's
``ParticleArgs`` and ``ParticleLaunch``, the map's tensors checked when they
change, the step's pointers and scalars written into the block, one call with
its address and the stream, through a stand-in function) and the step's
dispatch (one device: one particle launch and no motion launch; ``update``
keeps K9's own motion launch).

Tolerances.  Against JAX (run op by op, ``jax.disable_jit``, fed the port's
normals): moved particles bitwise where the first heading (theta + rot1 + noise
sigma_rot1) has the same float32 cos and sin in both libraries, within 1e-6
relative elsewhere (``test_torch_particle.py::
test_motion_sample_matches_jax``'s tolerance); scores within 1e-6 absolute at
the particles whose heading has the same float32 cos and sin in both libraries
and 1e-3 relative at the others, as
``test_torch_particle.py::test_score_points_batch_rows_equal_single_pose``
holds K3's batch.  Within the port: every comparison is bitwise.
"""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu.config import ScanMatcherConfig
from ndt_2d_tpu.filter import motion_model as jax_motion
from ndt_2d_tpu.matching import matcher as jax_matcher
from ndt_2d_tpu.matching import registry as jax_registry
from ndt_2d_tpu.utils import sim
from ndt_2d_tpu_torch import convert
from ndt_2d_tpu_torch.filter import motion_model
from ndt_2d_tpu_torch.filter import particle_filter as pf
from ndt_2d_tpu_torch.kernels import ndt_build as k1
from ndt_2d_tpu_torch.kernels import particle_filter as k9
from ndt_2d_tpu_torch.kernels import score_points as k3
from ndt_2d_tpu_torch.ndt import grid as ndt_grid

torch.set_num_threads(2)

W = H = 64
CELL = 0.25
P = 300
MCFG = ScanMatcherConfig(grid_cells_x=128, grid_cells_y=128)
CONTROL = (0.05, 0.01, 0.02)
ALPHAS = (0.05,) * 4
SRC = os.path.join(os.path.dirname(k3.__file__), os.pardir, "csrc",
                   "score_points.cu")


def T(x):
    return torch.from_numpy(np.array(x))


def cloud(seed, m, center=(5.0, 4.0, 0.1), sigma=(0.3, 0.3, 0.1)):
    rng = np.random.default_rng(seed)
    return rng.normal(center, sigma, (m, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def box():
    """A 3-scan box window (64 x 64 cells of 0.25 m) built by K1's twin at
    G = 1 and G = 4, and a 300-point query scan.  The walls' end cells
    and the cells a wall only grazes hold fewer than 5 points."""
    rng = np.random.default_rng(21)
    world = sim.make_box_world(10.0, 8.0)
    poses = np.asarray([[4.8, 3.9, 0.0], [5.0, 4.0, 0.05],
                        [5.2, 4.1, -0.05]], np.float32)
    pts, msk = zip(*[sim.project_scan(sim.scan_at_pose(
        world, p, 300, rng=rng, noise=0.01, range_max=12.0), P)
        for p in poses])
    qp, qm = sim.project_scan(sim.scan_at_pose(
        world, np.asarray([5.1, 4.0, 0.05]), 250, rng=rng, noise=0.01,
        range_max=12.0), P)
    args = (T(poses), T(np.stack(pts)), T(np.stack(msk)),
            torch.ones(3, dtype=torch.bool))
    built = {G: k1.build_window(*args, 12.0, CELL, W, H, G) for G in (1, 4)}
    return built, T(qp), T(qm), int(qm.sum())


def scan_case(box, kind, G=1):
    """(grid, table, points, mask, num_points, max_beams) of a case:
    ``below`` 200 of the scan's points into 250 beams, ``above`` all of
    them into 100, ``masked`` a third of the points masked out."""
    built, qp, qm, n = box
    grid, table = built[G]
    if kind == "below":
        return grid, table, qp, qm, 200, 250
    if kind == "masked":
        qm = qm.clone()
        qm[::3] = False
        return grid, table, qp, qm, n, 100
    return grid, table, qp, qm, n, 100


def particles_for(kind, M):
    c = cloud(M, M, center=(5.1, 4.0, 0.05), sigma=(0.1, 0.1, 0.03))
    if kind == "off_grid":  # every other particle leaves the 16 m grid
        c[1::2, 0] += 20.0
    return T(c)


def noise_for(M, seed=3):
    return torch.randn(M, 3, generator=torch.Generator().manual_seed(seed))


# --- against JAX ------------------------------------------------------------
def jax_box():
    world = np.concatenate([sim.make_box_world(10.0, 8.0),
                            np.asarray([[[3.0, 0.0], [3.0, 3.0]]])], axis=0)
    m = jax_registry.create("ndt", MCFG, 12.0)
    poses = np.asarray([[x, y, 0.0] for x in (3.0, 7.0) for y in (3.0, 5.0)],
                       np.float32)
    pts, msk = zip(*[sim.project_scan(sim.scan_at_pose(
        world, p, n_beams=240, range_max=12.0, noise=0.005,
        rng=np.random.default_rng(i)), 512) for i, p in enumerate(poses)])
    m.add_scans(poses, np.stack(pts), np.stack(msk))
    q, qm = sim.project_scan(sim.scan_at_pose(
        world, np.asarray([5.0, 4.0, 0.1]), n_beams=240, range_max=12.0,
        noise=0.005, rng=np.random.default_rng(11)), 512)
    return m, q, qm


def same_trig(theta):
    th = np.array(theta, np.float32)
    t = torch.from_numpy(th)
    return ((np.asarray(jnp.cos(th)) == torch.cos(t).numpy())
            & (np.asarray(jnp.sin(th)) == torch.sin(t).numpy()))


def test_fused_entry_matches_jax_sample_then_score():
    m, q, qm = jax_box()
    grid = convert.grid_to_port(jax.device_get(m.grid), "cpu")
    table = convert.table_to_port(jax.device_get(m.packed_table), "cpu")
    M = 256
    parts = cloud(8, M)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, (M, 3), jnp.float32))
    n = int(qm.sum())
    moved, scores = k3.motion_score(
        grid, table, MCFG.grid_cells_x, MCFG.grid_cells_y,
        MCFG.laser_max_beams, T(q), T(qm), n, T(parts), T(noise),
        motion_model.motion_scalars(*CONTROL, *ALPHAS))
    with jax.disable_jit():
        jp = jax_motion.sample(key, jnp.asarray(parts), *CONTROL, *ALPHAS)
        js = np.asarray(jax_matcher.score_points_batch(
            MCFG, m.grid, jnp.asarray(q), jnp.asarray(qm), jnp.int32(n),
            jp))
    # Bitwise where the first heading's cos and sin agree in the two
    # libraries; one ulp of either may move x or y elsewhere.
    r1 = np.float32(motion_model.motion_scalars(*CONTROL, *ALPHAS)[0])
    s1 = np.float32(motion_model.motion_scalars(*CONTROL, *ALPHAS)[3])
    a = parts[:, 2] + (r1 + noise[:, 0] * s1)
    agree = same_trig(a)
    assert agree.mean() > 0.5
    np.testing.assert_array_equal(moved.numpy()[agree], np.asarray(jp)[agree])
    np.testing.assert_allclose(moved.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)
    ok = same_trig(np.asarray(jp)[:, 2])
    assert ok.mean() > 0.5
    np.testing.assert_allclose(scores.numpy()[ok], js[ok], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(scores.numpy(), js, rtol=1e-3, atol=1e-6)
    assert float(scores.min()) < -0.05


# --- within the port: the fused entry, the record read -----------------------
@pytest.mark.parametrize("kind", ["below", "above", "masked", "off_grid"])
@pytest.mark.parametrize("M", [2, 33, 257])
def test_fused_equals_motion_then_score_batch(box, M, kind):
    grid, table, qp, qm, n, beams = scan_case(box, kind)
    parts, noise = particles_for(kind, M), noise_for(M)
    scal = motion_model.motion_scalars(0.1, -0.02, 0.05, *ALPHAS)
    moved, scores = k3.motion_score(grid, table, W, H, beams, qp, qm, n,
                                    parts, noise, scal)
    want_p = k9.motion(parts, noise, scal)
    want = k3.score_batch(grid, W, H, beams, qp, qm, n, want_p)
    assert moved.shape == (M, 3) and scores.shape == (M,)
    assert torch.equal(moved, want_p)
    assert torch.equal(scores, want)
    assert bool((scores < 0).any())
    if kind == "off_grid":
        assert bool((scores == 0).any())
    else:
        assert float((scores < 0).float().mean()) > 0.5


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("layout", ["patch", "cell"])
def test_record_twin_equals_soa_twin(box, layout, G):
    built, qp, qm, n = box
    grid, patch = built[G]
    if layout == "cell":
        grids = ndt_grid.split_grids(grid) if G > 1 else [grid]
        tables = [ndt_grid.packed_cell_table(g) for g in grids]
        table = torch.stack(tables) if G > 1 else tables[0]
    else:
        table = patch
    poses = particles_for("near", 65)
    got = k3.score_records(grid, table, W, H, 100, qp, qm, n, poses)
    want = k3.score_batch_twin(grid, W, H, 100, qp, qm, n, poses)
    assert torch.equal(got, want)
    # The beams reach cells that hold fewer than 5 points, which score 0.
    spts, smask, _ = k3.subsample(qp, qm, n, 100)
    g0 = ndt_grid.split_grids(grid)[0] if G > 1 else grid
    c, s = torch.cos(poses[:, 2:3]), torch.sin(poses[:, 2:3])
    w = torch.stack([c * spts[:, 0] - s * spts[:, 1] + poses[:, 0:1],
                     s * spts[:, 0] + c * spts[:, 1] + poses[:, 1:2]], -1)
    flat, valid = ndt_grid.cell_index(g0.origin, ndt_grid.f32(CELL, "cpu"),
                                      W, H, w)
    counts = g0.count[flat[valid & smask]]
    assert bool(((counts > 0) & (counts < 5)).any())


def test_score_records_at_one_pose_equals_score_at_pose(box):
    grid, table, qp, qm, n, beams = scan_case(box, "above")
    poses = particles_for("near", 9)
    got = k3.score_records(grid, table, W, H, beams, qp, qm, n, poses)
    for i in range(poses.shape[0]):
        one = k3.score_at_pose(grid, W, H, beams, qp, qm, n, poses[i])
        assert torch.equal(got[i], one), i


def test_pf_step_with_the_table_equals_without(box):
    grid, table, qp, qm, n, _ = scan_case(box, "above")
    mcfg = ScanMatcherConfig(grid_cells_x=W, grid_cells_y=H,
                             ndt_resolution=CELL)
    M = 128
    draws = pf.Draws(noise_for(M, 5), torch.rand(
        M, generator=torch.Generator().manual_seed(6)))
    args = (draws, particles_for("near", M), M, CONTROL, mcfg, grid, qp, qm,
            n, ALPHAS, 0.01, 2.3, (0.5, 0.5, 0.2671), 20)
    a = pf.pf_step(*args, packed_table=table)
    b = pf.pf_step(*args)
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)


def test_one_device_step_launches_no_motion(box, monkeypatch):
    """pf_step on one device: one particle launch (the motion folded in),
    no K9 motion launch and no other scoring; ``update`` keeps K9's motion
    launch."""
    grid, table, qp, qm, n, _ = scan_case(box, "above")
    mcfg = ScanMatcherConfig(grid_cells_x=W, grid_cells_y=H,
                             ndt_resolution=CELL)
    calls = []
    for mod, name in ((k3, "motion_score"), (k3, "score_records"),
                      (k3, "score_batch"), (k9, "motion")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    M = 64
    draws = pf.Draws(noise_for(M, 7), torch.rand(M))
    pf.pf_step(draws, particles_for("near", M), M, CONTROL, mcfg, grid, qp,
               qm, n, ALPHAS, 0.01, 2.3, (0.5, 0.5, 0.2671), 20,
               packed_table=table)
    assert calls == ["motion_score"]
    calls.clear()
    motion_model.sample(particles_for("near", M), draws.motion, *CONTROL,
                        *ALPHAS)
    assert calls == ["motion"]


# --- the plan ----------------------------------------------------------------
def _source_struct(name):
    src = open(SRC).read()
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    fields = []
    for line in body.split(";"):
        line = line.replace("const ", "").strip()
        if line:
            kind, names = re.match(r"(\w+\*?)\s+(.*)", line, re.S).groups()
            fields += [(kind, f.strip()) for f in names.split(",")]
    return fields


def test_args_block_matches_the_source_layout():
    """csrc/score_points.cu::ParticleArgs: ten ints, then the cell."""
    src = _source_struct("ParticleArgs")
    names = [f for f, _ in k3._ParticleArgs._fields_]
    assert names == [f for _, f in src]
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    assert [kinds[k] for k, _ in src] == [t for _, t in
                                          k3._ParticleArgs._fields_]
    assert ctypes.sizeof(k3._ParticleArgs) == 44
    assert k3._ParticleArgs.cell.offset == 40


def test_launch_block_matches_the_source_layout():
    """csrc/score_points.cu::ParticleLaunch: the constants, eight
    pointers, the six motion scalars and the point count; the entry takes
    the block's address and the stream."""
    src = _source_struct("ParticleLaunch")
    assert [f for _, f in src] == [f for f, _ in
                                   k3._ParticleLaunch._fields_]
    kinds = {"ParticleArgs": k3._ParticleArgs, "float": ctypes.c_float,
             "int": ctypes.c_int}
    for (kind, name), (_, t) in zip(src, k3._ParticleLaunch._fields_):
        want = ctypes.c_void_p if kind.endswith("*") else kinds[kind]
        assert t is want, name
    assert k3._ParticleLaunch.poses.offset == 48  # after 44 bytes, aligned
    assert k3._ParticleLaunch.rot1.offset == 48 + 8 * 8
    assert ctypes.sizeof(k3._ParticleLaunch) == 144
    sig = re.search(r"NDT2D_API int ndt2d_particle_scores\((.*?)\)\s*\{",
                    open(SRC).read(), re.S).group(1)
    assert [a.split()[-1] for a in sig.split(",")] == ["launch", "stream"]
    assert k3._PARTICLE_ARGS == [ctypes.c_void_p] * 2


def test_plan_is_made_once_a_shape(box):
    grid, table, qp, *_ = scan_case(box, "above")
    a = k3.particle_plan(grid, table, W, H, 100, qp, 257, True)
    assert k3.particle_plan(grid, table, W, H, 100, qp, 257, True) is a
    assert k3.particle_plan(grid, table, W, H, 100, qp, 256, True) is not a
    assert k3.particle_plan(grid, table, W, H, 100, qp, 257, False) is not a
    assert k3.particle_plan(grid, table, W, H, 99, qp, 257, True) is not a
    assert ctypes.addressof(a.args) == a.address
    assert (a.args.P, a.args.max_beams, a.args.G, a.args.W, a.args.row0,
            a.args.h, a.args.stride, a.args.M, a.args.motion,
            a.args.raw) == (P, 100, 1, W, 0, H, 32, 257, 1, 0)
    assert a.args.cell == CELL
    shapes = {name: shape for name, _, shape in a.map_expect + a.expect}
    assert shapes == {"origin": (2,), "table": (W * H, 32),
                      "points": (P, 2), "point_mask": (P,),
                      "poses": (257, 3), "noise": (257, 3)}
    with pytest.raises(ValueError, match="table"):
        k3.ParticlePlan(P, 100, (W * H, 16), W, H, CELL, 8, True,
                        qp.device)


class _Recorder:
    """A stand-in for the C entry: records its arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def test_plan_checks_the_map_once_and_fills_the_block(box, monkeypatch):
    grid, table, qp, qm, n, _ = scan_case(box, "above")
    M = 16
    plan = k3.ParticlePlan(P, 100, tuple(table.shape), W, H, CELL, M, True,
                           qp.device)
    plan._fn, plan._stream = _Recorder(), (lambda: 1234)
    checks = []
    real = plan._check_map
    monkeypatch.setattr(plan, "_check_map",
                        lambda o, t: (checks.append(t), real(o, t)))
    parts, noise = particles_for("near", M), noise_for(M)
    scal = motion_model.motion_scalars(*CONTROL, *ALPHAS)
    moved, out = plan.run(qp, qm, n, grid.origin, table, parts, noise, scal)
    L = plan.launch
    assert plan._fn.calls == [(plan.address, 1234)]
    assert (L.poses, L.noise, L.points, L.pmask) == (
        parts.data_ptr(), noise.data_ptr(), qp.data_ptr(), qm.data_ptr())
    assert (L.origin, L.table) == (grid.origin.data_ptr(), table.data_ptr())
    assert (L.moved, L.out, L.num_points) == (moved.data_ptr(),
                                              out.data_ptr(), n)
    f32 = [float(np.float32(v)) for v in scal]
    assert [L.rot1, L.trans, L.rot2, L.s_rot1, L.s_trans, L.s_rot2] == f32
    assert moved.shape == (M, 3) and out.shape == (M,)
    plan.run(qp, qm, n, grid.origin, table, parts, noise, scal)
    assert len(checks) == 1
    other = table.clone()
    plan.run(qp, qm, n, grid.origin, other, parts, noise, scal)
    assert len(checks) == 2 and L.table == other.data_ptr()
    assert len(plan._fn.calls) == 3
    with pytest.raises(ValueError, match="noise"):
        plan.run(qp, qm, n, grid.origin, table, parts, noise[:8], scal)
    with pytest.raises(ValueError, match="aligned"):
        plan.run(qp, qm, n, grid.origin, _misaligned(table), parts, noise,
                 scal)


def _misaligned(table):
    """``table``'s values in a tensor whose storage starts 4 bytes past a
    16-byte boundary."""
    flat = torch.empty(table.numel() + 4)
    view = flat[1:1 + table.numel()].view(table.shape)
    view.copy_(table)
    return view


def test_motion_plan_is_made_once_and_marshals_in_order():
    """K9's own motion launch (the mesh's step, ``update``) goes through a
    plan of M particles too: one ctypes call of ``ndt2d_pf_motion``."""
    M = 12
    dev = torch.device("cpu")
    plan = k9.motion_plan(M, dev)
    assert k9.motion_plan(M, dev) is plan
    assert k9.motion_plan(M + 1, dev) is not plan
    fresh = k9.MotionPlan(M, dev)
    fresh._fn, fresh._stream = _Recorder(), (lambda: 77)
    parts, noise = particles_for("near", M), noise_for(M)
    scal = motion_model.motion_scalars(*CONTROL, *ALPHAS)
    out = fresh.run(parts, noise, scal)
    args = fresh._fn.calls[0]
    assert len(args) == len(k9._MOTION_ARGS)
    assert args == (parts.data_ptr(), noise.data_ptr(), M, *scal,
                    out.data_ptr(), 77)
    assert out.shape == (M, 3)
    with pytest.raises(ValueError, match="particles"):
        fresh.run(parts[:5], noise, scal)
