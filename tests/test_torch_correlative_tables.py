"""K11's lattice with per-angle index tables (``kernels/correlative.py``:
``beam_tables``, ``lattice_scores_tables``, ``lattice_plan`` and the
launch's marshalling) on the CPU.

The CUDA launch runs only on the card, where ``chip_smoke.py`` holds it
bitwise against its twin and the parent kernel.  Here:

* the tables twin is ``lattice_scores`` (a division a term) bit for bit,
  with beams exactly on cell edges, outside the grid and unused, at L =
  21, 40 and 41 (A L^2 not a multiple of 256);
* a model of the kernel's blocks (``lattice_plan``'s runs of tiles, each
  block's column table from its first dx, beams in chunks, each beam's
  field window, or the field where its cells do not fit) gives the same
  scores bit for bit at every tiles-a-block choice, a chunk that splits
  the beams, and windows too small for some beams with shuffled offsets;
* the plan covers every tile once, sizes the column table to the widest
  block, a beam's window to its offsets' span, and fits 48 KB with the
  kernel's static shared memory (which the sources declare as counted);
* the matcher's decisions equal op-by-op JAX's (the correction equal, the
  score within 1e-5 relative, as tests/test_torch_correlative.py holds
  them), here on a wider lattice;
* rows are their own R = 1 searches, and a launch hands the C entry its
  shape's launch block, the plan's ints packed once, and a zeroed ticket
  row kept a (device, stream).
"""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu.matching import correlative as jax_correlative
from ndt_2d_tpu_torch.config import ScanMatcherConfig
from ndt_2d_tpu_torch.kernels import _build
from ndt_2d_tpu_torch.kernels import correlative as k11
from ndt_2d_tpu_torch.kernels.candidate_gather import TILE
from ndt_2d_tpu_torch.kernels.score_points import subsample
from ndt_2d_tpu_torch.matching import correlative
from ndt_2d_tpu_torch.utils import sim
from port_configs import to_jax

torch.set_num_threads(2)

CELL = 0.25
WORLD = sim.make_box_world(10.0, 8.0)


CFG = ScanMatcherConfig(grid_cells_x=40, grid_cells_y=32,
                        ndt_resolution=CELL, laser_max_beams=64)


def lattice(L: int, A: int):
    """A angles 0.01 rad apart and L offsets 0.005 m apart, each centred
    on an exact 0."""
    dths = (torch.arange(A) - A // 2).to(torch.float32) * 0.01
    dls = (torch.arange(L) - L // 2).to(torch.float32) * 0.005
    return dths, dls


def edge_case(L: int, A: int = 3, seed: int = 0):
    """A field, its origin and one scan whose beams include ones exactly on
    cell edges (heading 0, dx = 0 at the lattice's centre), ones off the
    grid, and unused ones (masked points), and ``lattice(L, A)``."""
    cfg = CFG
    rng = np.random.default_rng(seed)
    W, H = cfg.grid_cells_x, cfg.grid_cells_y
    field = torch.from_numpy(rng.random((H, W)).astype(np.float32))
    origin = torch.tensor([-1.0, -2.0])
    P = 80
    pts = rng.uniform(-3.0, 3.0, (P, 2)).astype(np.float32)
    # On the edges: world x = origin + k cell at heading 0, dx = 0.
    pts[:16, 0] = (-1.0 + 0.25 * np.arange(4, 20) - 4.0).astype(np.float32)
    pts[:16, 1] = (-2.0 + 0.25 * np.arange(16) - 3.0).astype(np.float32)
    pts[16:24] *= 10.0                                  # off the grid
    mask = np.ones(P, bool)
    mask[30:40] = False                                 # unused
    pose = torch.tensor([4.0, 3.0, 0.0])
    dths, dls = lattice(L, A)
    return (cfg, field, origin, torch.from_numpy(pts),
            torch.from_numpy(mask), pose, dths, dls)


def subsampled(cfg, pts, mask):
    spts, smask, _ = subsample(pts, mask, int(mask.sum()),
                               cfg.laser_max_beams)
    return spts, smask


@pytest.mark.parametrize("L", [21, 40, 41])
def test_tables_twin_is_lattice_scores(L):
    cfg, field, origin, pts, mask, pose, dths, dls = edge_case(L)
    assert (dths.numel() * L * L) % TILE != 0
    spts, smask = subsampled(cfg, pts, mask)
    assert not bool(smask.all())
    ref = k11.lattice_scores(cfg, field, origin, spts, smask, pose, dths,
                             dls)
    got = k11.lattice_scores_tables(cfg, field, origin, spts, smask, pose,
                                    dths, dls)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    xs, ys = k11.beam_tables(cfg, origin, spts, smask, pose, dths, dls)
    # At heading 0 and dx = 0 the edge beams' (x - ox) / cell is an exact
    # integer k: they bin into the cell above the edge, column k; and every
    # kind of sentinel occurs.
    k = (spts[:, 0] + 5.0) / CELL
    on = (k == torch.floor(k)) & (k >= 4) & (k < 20) & smask
    assert int(on.sum()) >= 12
    assert torch.equal(xs[dths.numel() // 2, on, L // 2], k[on].long())
    assert bool((xs == k11.OFF).any()) and bool((ys == k11.OFF).any())
    assert bool((xs[:, ~smask] == k11.OFF).all())


def kernel_model(cfg, field, origin, spts, smask, pose, dths, dls,
                 per: int, chunk: int, cx: int, cy: int):
    """The scores [A, L, L] as ``lattice_tables`` forms them, in torch's
    float32 ops: a block a run of ``per`` tiles of one angle; per chunk of
    ``chunk`` beams its column table from its first dx and its row table;
    each beam's window of the cells its valid entries reach, where they
    fit cx x cy, the table entries then window offsets (a sentinel into a
    zero column or row), else field offsets; each candidate's beams added
    in order from +0 from the window or the field.  A beam's window spans
    its first and last entries (clamped to the grid), which holds all its
    valid ones where the offsets ascend; else no beam takes one."""
    A, L, B = dths.numel(), dls.numel(), spts.shape[0]
    W, H = cfg.grid_cells_x, cfg.grid_cells_y
    LL = L * L
    tiles = -(-LL // TILE)
    xs_all, ys_all = k11.beam_tables(cfg, origin, spts, smask, pose, dths,
                                     dls)
    # The rotated beams plus each offset: the entries' numerators.
    cell_size = torch.tensor(cfg.ndt_resolution, dtype=torch.float32)
    th = pose[2] + dths
    c, s = torch.cos(th)[:, None], torch.sin(th)[:, None]
    rx = c * spts[:, 0][None, :] - s * spts[:, 1][None, :] + pose[0]
    ry = s * spts[:, 0][None, :] + c * spts[:, 1][None, :] + pose[1]
    xs_raw = rx[:, :, None] + dls
    ys_raw = ry[:, :, None] + dls
    flat_field = field.reshape(-1)
    cw, words = cx + 1, (cx + 1) * (cy + 1)
    windows = bool((dls[1:] >= dls[:-1]).all()) and cx > 0 and cy > 0
    out = torch.empty(A, LL)
    fits = []
    for a in range(A):
        for j in range(-(-tiles // per)):
            f0, f1 = j * per * TILE, min((j + 1) * per * TILE, LL)
            t = torch.arange(f0, f1)
            lx0 = f0 // L
            nxb = (f1 - 1) // L - lx0 + 1
            xo, yo = t // L - lx0, t % L
            acc = torch.zeros(f1 - f0)
            for base in range(0, B, chunk):
                nb = min(chunk, B - base)
                for jj in range(nb):
                    b = base + jj
                    # Raw entries: column ix and row iy, or OFF.
                    xr = xs_all[a, b, lx0:lx0 + nxb]
                    yr = torch.where(ys_all[a, b] == k11.OFF, k11.OFF,
                                     ys_all[a, b] // W)
                    rawx = torch.floor((xs_raw[a, b, lx0:lx0 + nxb]
                                        - origin[0]) / cell_size)
                    rawy = torch.floor((ys_raw[a, b] - origin[1])
                                       / cell_size)
                    lo = max(int(rawx[0]), 0)
                    hi = min(int(rawx[-1]), W - 1)
                    ylo = max(int(rawy[0]), 0)
                    yhi = min(int(rawy[-1]), H - 1)
                    fit = windows and (not bool(smask[b]) or hi - lo < cx) \
                        and yhi - ylo < cy
                    fits.append(fit)
                    if fit:
                        win = torch.zeros(words)
                        for k in range(words):
                            gx, gy = lo + k % cw, ylo + k // cw
                            if k % cw < cx and k // cw < cy and gx < W \
                                    and gy < H:
                                win[k] = flat_field[gy * W + gx]
                        x = torch.where(xr == k11.OFF, cx, xr - lo)
                        y = torch.where(yr == k11.OFF, cy, yr - ylo) * cw
                        acc = acc + win[x[xo] + y[yo]]
                    else:
                        y = torch.where(yr == k11.OFF, k11.OFF, yr * W)
                        cell = xr[xo] + y[yo]
                        v = flat_field[torch.clamp(cell, min=0)]
                        acc = acc + torch.where(cell >= 0, v,
                                                torch.zeros(()))
            out[a, f0:f1] = -acc
    return out.reshape(A, L, L), fits


@pytest.mark.parametrize("per", [1, 2, 4, 8])
@pytest.mark.parametrize("L", [21, 41])
def test_kernel_model_is_lattice_scores(L, per):
    cfg, field, origin, pts, mask, pose, dths, dls = edge_case(L, A=5,
                                                               seed=L)
    spts, smask = subsampled(cfg, pts, mask)
    ref = k11.lattice_scores(cfg, field, origin, spts, smask, pose, dths,
                             dls)
    plan = k11.lattice_plan(5, L, 1, cfg.laser_max_beams, 132,
                            0.005 / CELL)
    got, fits = kernel_model(cfg, field, origin, spts, smask, pose, dths,
                             dls, per, 7, plan.cx, plan.cy)
    assert all(fits)  # the plan's windows hold every beam's cells
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("cx,cy,shuffled", [(1, 1, False), (1, 3, False),
                                             (2, 3, True), (0, 0, False)])
def test_kernel_model_with_beams_past_their_window(cx, cy, shuffled):
    """Offsets 0.1 m apart, so that beams span cells: windows too small for
    some beams (those read the field, the others their windows), offsets
    that do not ascend (every beam reads the field) and no windows at all;
    the same bits."""
    cfg, field, origin, pts, mask, pose, dths, dls = edge_case(21, A=3,
                                                               seed=9)
    dls = dls * 20.0
    if shuffled:
        dls = dls[torch.randperm(
            21, generator=torch.Generator().manual_seed(0))]
    spts, smask = subsampled(cfg, pts, mask)
    ref = k11.lattice_scores(cfg, field, origin, spts, smask, pose, dths,
                             dls)
    got, fits = kernel_model(cfg, field, origin, spts, smask, pose, dths,
                             dls, 2, 16, cx, cy)
    assert not all(fits)
    assert any(fits) == (not shuffled and cx > 0)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("A,L,R,beams,step", [
    (80, 40, 1, 100, 0.03), (80, 21, 1, 100, 0.02), (80, 40, 64, 100, 0.03),
    (40, 30, 64, 100, 0.29), (3, 41, 1, 60, 0.02), (126, 41, 1, 600, 0.2),
    (1, 1, 1, 1, 0.0), (80, 41, 1, 100, 0.08), (40, 57, 1, 100, 0.05)])
def test_plan_covers_every_tile_once(A, L, R, beams, step):
    plan = k11.lattice_plan(A, L, R, beams, 132, step)
    LL = L * L
    assert plan.tiles == -(-LL // TILE)
    assert (plan.threads, plan.per) in k11.SHAPES
    span = plan.threads // TILE * plan.per  # tiles a block
    assert span < 2 * plan.tiles + 1
    covered = []
    spans = []
    for j in range(plan.groups):
        first = j * span
        run = list(range(first, min(first + span, plan.tiles)))
        assert run, "a block without a tile"
        covered += run
        f0, f1 = first * TILE, min((first + span) * TILE, LL)
        spans.append((f1 - 1) // L - f0 // L + 1)
    assert covered == list(range(plan.tiles))
    assert plan.nx == max(spans) and plan.nx <= L
    assert plan.chunk < beams + 4
    window = (plan.cx + 1) * (plan.cy + 1)
    assert window <= k11.WINDOW_WORDS
    assert plan.chunk % 4 == 0 and plan.chunk >= min(beams, 4)
    assert plan.stride >= plan.chunk and plan.stride % 32 == 4
    words = (k11.BEAM_WORDS * plan.chunk
             + (plan.nx + L + window) * plan.stride)
    static = k11.static_words(plan.threads)
    assert words <= k11.TABLE_WORDS - static
    assert plan.stage == min(A * plan.tiles,
                             max(words // 12 - 1, k11.FOLD_STAGE))
    fold = 12 * (plan.stage + 1)
    assert plan.smem == 4 * max(words, fold)
    assert plan.smem + 4 * static <= 48 * 1024
    # One wave of blocks, else blocks of 256 with the most tiles a thread
    # that still gives two blocks an SM.
    blocks = A * R * plan.groups
    if blocks > 132:
        assert plan.threads == TILE
        assert plan.per == 1 or blocks >= 2 * 132


@pytest.mark.parametrize("threads", sorted({t for t, _ in k11.SHAPES}))
def test_plan_leaves_room_for_the_static_shared_memory(threads):
    """``static_words`` counts what the kernel declares beside its dynamic
    tables: ``reduce_tiles``' warp sums (a partial a warp) and the fold's
    flag; a lattice whose tables fill the budget (40 x 57 x 57, offsets
    0.05 cell apart) and the one that passed 48 KB before the static part
    was counted (80 x 41 x 41, 0.08 cell) fit with it."""
    root = Path(__file__).resolve().parents[1] / "ndt_2d_tpu_torch" / "csrc"
    lattice = (root / "lattice.cuh").read_text()
    body = (root / "correlative.cu").read_text().split(
        "lattice_tables(\n    const LatticeTables a) {")[1].split(
        "\n}\n")[0]
    assert "__shared__ float warp_sums[kG][kWarps][kPartial];" in lattice
    assert re.findall(r"__shared__[^;]*;", body) == [
        "__shared__ __align__(16) int tab[];", "__shared__ bool last;"]
    sums = threads // 32 * k11.PARTIAL_WORDS  # kG * kWarps * kPartial
    assert k11.static_words(threads) * 4 >= 4 * sums + 1
    assert k11.static_words(threads) * 4 <= 4 * sums + 16
    full = k11.lattice_plan(40, 57, 1, 100, 132, 0.05)
    words = k11.BEAM_WORDS * full.chunk + (
        full.nx + 57 + (full.cx + 1) * (full.cy + 1)) * full.stride
    assert words == k11.TABLE_WORDS - k11.static_words(full.threads)
    for plan in (full, k11.lattice_plan(80, 41, 1, 100, 132, 0.08)):
        assert plan.smem + 4 * k11.static_words(plan.threads) <= 48 * 1024


def test_plan_shapes_of_the_main_path():
    """The box drive's lattice (80 x 40 x 40) at R = 1: an angle a block
    of 1024 threads, two tiles a thread (80 blocks, one wave); config 2's
    (80 x 21 x 21): an angle a block of 512; 64 box rows: blocks of 256,
    a whole angle a block."""
    box = k11.lattice_plan(80, 40, 1, 100, 132, 0.0075 / 0.25)
    assert (box.threads, box.per, box.groups, box.nx, box.cx, box.cy,
            box.chunk, box.stride, box.stage) == (1024, 2, 1, 40, 3, 3, 100,
                                                  100, 560)
    c2 = k11.lattice_plan(80, 21, 1, 100, 132, 0.02)
    rows = k11.lattice_plan(80, 40, 64, 100, 132, 0.03)
    assert ((c2.threads, c2.per, c2.groups), (rows.threads, rows.per)) == (
        (512, 1, 1), (256, 8))
    # Offsets a cell apart or more: no windows, every beam reads the field.
    wide = k11.lattice_plan(40, 30, 64, 100, 132, 0.1 / 0.35)
    assert (wide.cx, wide.cy) == (0, 0)
    with pytest.raises(ValueError):
        k11.lattice_plan(80, 40, 1, 0, 132)


WIDE = ScanMatcherConfig(grid_cells_x=128, grid_cells_y=128,
                         search_angular_size=0.02,
                         search_angular_resolution=0.01,
                         search_linear_size=0.1001,
                         search_linear_resolution=0.005,
                         laser_max_beams=60)


def window(seed):
    rng = None if seed is None else np.random.default_rng(seed)
    poses = np.asarray([[4.8, 3.9, 0.0], [5.0, 4.0, 0.05],
                        [5.2, 4.1, -0.05]], np.float32)
    scans = []
    for p in list(poses) + [np.asarray([5.0, 4.0, 0.0])]:
        msg = sim.scan_at_pose(WORLD, np.asarray(p, float), n_beams=360,
                               range_max=15.0,
                               noise=0.0 if rng is None else 0.01, rng=rng)
        scans.append(sim.project_scan(msg, 512))
    pts = np.stack([s[0] for s in scans[:3]])
    msk = np.stack([s[1] for s in scans[:3]])
    return poses, pts, msk, scans[3]


@pytest.mark.parametrize("seed,start", [
    (None, [5.03, 3.98, 0.0]), (0, [4.96, 4.04, 0.01]),
    (2, [5.06, 3.95, -0.01])])
def test_match_scan_field_decisions_match_op_by_op_jax(seed, start):
    assert WIDE.num_linear == 41
    poses, pts, msk, (qp, qm) = window(seed)
    f, o = correlative.build_field(
        WIDE, torch.tensor(poses), torch.tensor(pts), torch.tensor(msk),
        torch.ones(3, dtype=torch.bool), 15.0)
    start = np.asarray(start, np.float32)
    qn = int(qm.sum())
    res = correlative.match_scan_field(WIDE, f, o, torch.tensor(qp),
                                       torch.tensor(qm), qn,
                                       torch.tensor(start))
    with jax.disable_jit():
        ref = jax_correlative.match_scan_field(
            to_jax(WIDE), jnp.asarray(f.numpy()), jnp.asarray(o.numpy()),
            jnp.asarray(qp), jnp.asarray(qm), jnp.int32(qn),
            jnp.asarray(start))
    np.testing.assert_array_equal(res.correction.numpy(),
                                  np.asarray(ref.correction))
    assert float(res.score) == pytest.approx(float(ref.score), rel=1e-5)


def test_rows_are_their_own_searches():
    """Each row of ``match_rows`` is its own R = 1 search, whatever rows
    stand beside it."""
    cases = [edge_case(21, A=3, seed=s) for s in range(3)]
    cfg, _, _, _, _, _, dths, dls = cases[0]
    fields = torch.stack([c[1] for c in cases])
    origins = torch.stack([c[2] for c in cases])
    pts = torch.stack([c[3] for c in cases])
    msk = torch.stack([c[4] for c in cases])
    nums = msk.sum(1).to(torch.int32)
    poses = torch.stack([c[5] + 0.01 * i for i, c in enumerate(cases)])
    rows = k11.match_rows(cfg, fields, origins, pts, msk, nums, poses, dths,
                          dls)
    two = k11.match_rows(cfg, fields[1:], origins[1:], pts[1:], msk[1:],
                         nums[1:], poses[1:], dths, dls)
    for r in range(3):
        one = k11.match(cfg, fields[r], origins[r], pts[r], msk[r],
                        int(nums[r]), poses[r], dths, dls)
        assert torch.equal(rows[r:r + 1], one)
    assert torch.equal(rows[1:], two)


class _Recorder:
    """A stand-in for a C entry: records its arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("R", [1, 3])
def test_launch_hands_the_plan_and_a_kept_ticket_row(monkeypatch, R):
    """A search shape's launcher packs lattice_plan's ints into its launch
    block once; each launch is one C call with the block's address and
    the stream, the block holding the rows' pointers and a zeroed ticket
    row kept a (device, stream)."""
    cfg, field, origin, pts, mask, pose, dths, dls = edge_case(40, A=80)
    rec = {}

    def function(name, argtypes):
        if name == "ndt2d_correlative_lattice_launch_size":
            return lambda: ctypes.sizeof(k11._LatticeLaunch)
        rec.setdefault(name, (_Recorder(), argtypes))
        return rec[name][0]
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream_reader", lambda dev: lambda: 4321)
    monkeypatch.setattr(_build, "sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(k11, "_TICKETS", {})
    monkeypatch.setattr(k11, "_LATTICE_LAUNCHERS", {})
    before = k11.match_launches
    rows = [x[None].expand(R, *x.shape).contiguous()
            for x in (field, origin, pts, mask, pose)]
    nums = torch.full((R,), int(mask.sum()), dtype=torch.int32)
    outs = [k11._launch_match(cfg, *rows[:4], nums, 0, rows[4], dths, dls,
                              False)[0] for _ in range(2)]
    fn, argtypes = rec["ndt2d_correlative_match_planned"]
    launcher, = k11._LATTICE_LAUNCHERS.values()
    assert len(fn.calls) == 2 and k11.match_launches == before + 2
    assert fn.calls == [(launcher.address, 4321)] * 2
    assert len(argtypes) == 2
    plan = k11.lattice_plan(80, 40, R, cfg.laser_max_beams, 132,
                            cfg.search_linear_resolution / CELL)
    L, a = launcher.launch, launcher.launch.a
    assert (L.threads, L.per, L.R) == (plan.threads, plan.per, R)
    assert (a.tiles, a.groups, a.nx, a.cx, a.cy, a.chunk, a.stride,
            a.stage) == (plan.tiles, plan.groups, plan.nx, plan.cx, plan.cy,
                         plan.chunk, plan.stride, plan.stage)
    assert (a.W, a.H, a.A, a.L, a.max_beams) == (
        cfg.grid_cells_x, cfg.grid_cells_y, 80, 40, cfg.laser_max_beams)
    assert (a.field, a.points, a.nums, a.pose) == (
        rows[0].data_ptr(), rows[2].data_ptr(), nums.data_ptr(),
        rows[4].data_ptr())
    assert a.out == outs[1].data_ptr() and a.scores is None
    ticket = k11._TICKETS[(None, 4321)]
    assert a.ticket == ticket.data_ptr()
    assert ticket.numel() >= R and not bool(ticket.any())
