"""K6's launch plan (``kernels/candidate_gather.py::plan``) and what its
block design reads, which the CPU can check.  The kernel runs only on the
card, where ``chip_smoke.py`` holds it bitwise against its unchanged twins
(``match_twin`` / ``match_rows_twin``, ``stripe_field_twin`` and the
partials' ``block_partials``); here numpy models of what the kernel does
with a plan are held to the twin's per-term expressions
(``candidate_scores_gather``):

* the staged entries: per (beam, dx) the shifted x and its cell's column
  in the beam's window of records, per (beam, dy) the same in y (minus
  the stripe's first row); a term's cell, x and y are the twin's bits,
  and a record is staged (on the grid) exactly where the twin's term lies
  on the grid;
* the -inf fold: an invalid term's exponent is -inf, its clamp -inf, its
  exp +0, and adding +0 to a sum of non-negative terms changes no bit -
  the twin's select, term for term and sum for sum;
* the plan: one of the kernel's tiles; threads, passes and tiles cover
  every offset of the coarse (21 x 40 x 40 and 41 x 41), merge (126 x 40
  x 40) and stripe (80 x 21 x 21) lattices exactly once, a warp's lanes
  hold a compact patch of offsets, and a block's shared memory fits.

Tolerances: none; every comparison is bitwise.
"""

import numpy as np
import pytest
import torch

from ndt_2d_tpu_torch.kernels import candidate_gather as k6

torch.set_num_threads(2)

# Offsets an axis of the lattices K6 runs: the coarse stage (0.1 m over
# +-2 m, both roundings of the count), the stripe field (80 x 21 x 21), a
# narrow one-cell lattice, lattices too wide to fold in shared memory and
# one with more offsets an axis than a block has threads.
LATTICES = [40, 41, 21, 11, 1, 81, 241, 301]


def window_entries(beam, dls, o, cell, n, win, row0=0):
    """gather_lattice's entries of one axis: w = beam + d, i =
    (int)floorf((w - o) / cell) - row0; the window starts at the first
    offset's cell i0 and the entry holds i - i0 (clamped into the window);
    ``inside``: every offset of the beam lands in its window of ``win``
    cells, else the beam gathers from the table.  float32 throughout."""
    w = (beam[:, None] + dls[None, :]).astype(np.float32)
    i = np.floor((w - o) / cell).astype(np.int32) - row0
    i0 = i[:, :1]
    inside = ((i - i0 >= 0) & (i - i0 < win)).all(axis=1)
    return w, i0[:, 0], np.clip(i - i0, 0, win - 1), inside


def beams_and_grid(seed):
    rng = np.random.default_rng(seed)
    # Rotated beams near the grid's edges and on cell boundaries.
    rx = rng.uniform(-1.0, 25.0, 100).astype(np.float32)
    ry = rng.uniform(-1.0, 25.0, 100).astype(np.float32)
    rx[:10] = np.float32(0.5) * rng.integers(0, 48, 10)
    ry[10:20] = np.float32(0.5) * rng.integers(0, 48, 10)
    dls = (np.float32(-2.0) + np.arange(41, dtype=np.float32)
           * np.float32(0.1)).astype(np.float32)
    origin = np.array([0.25, -0.5], np.float32)
    return rx, ry, dls, origin, np.float32(0.5)


class Cfg:
    search_linear_resolution = 0.1


@pytest.mark.parametrize("row0", [0, 16])
def test_window_entries_are_the_terms_cells(row0):
    """The twin's per-term wx, wy and cell (ix, iy) (candidate_scores_
    gather's expressions over [B, L(dx), L(dy)]) against the kernel's
    entries read back by (beam, dx) and (beam, dy): the window's cell (ix0
    + column, iy0 + row) is the twin's, on the grid exactly where the
    twin's is, for every beam of the coarse lattice (0.1 m offsets on 0.5 m
    cells) in the plan's window."""
    W, H = 48, 24
    rx, ry, dls, origin, cell = beams_and_grid(row0)
    L = dls.shape[0]
    pl = k6.plan(L, True, k6.span_cells(Cfg, float(cell), L))
    wx, ix0, col, in_x = window_entries(rx, dls, origin[0], cell, W,
                                        pl.winx)
    wy, iy0, row, in_y = window_entries(ry, dls, origin[1], cell, H,
                                        pl.winy, row0)
    assert in_x.all() and in_y.all()
    t = torch.from_numpy
    twx = t(rx)[:, None, None] + t(dls)[None, :, None]
    twy = t(ry)[:, None, None] + t(dls)[None, None, :]
    tix = torch.floor((twx - float(origin[0])) / float(cell)).to(torch.int32)
    tiy = (torch.floor((twy - float(origin[1])) / float(cell)).to(torch.int32)
           - row0)
    inb = (tix >= 0) & (tiy >= 0) & (tix < W) & (tiy < H)   # [B, L, L]
    assert wx.tobytes() == twx[:, :, 0].numpy().tobytes()
    assert wy.tobytes() == twy[:, 0, :].numpy().tobytes()
    kx = (ix0[:, None] + col)[:, :, None] + 0 * row[:, None, :]
    ky = (iy0[:, None] + row)[:, None, :] + 0 * col[:, :, None]
    assert np.array_equal(kx, np.broadcast_to(tix.numpy(), kx.shape))
    assert np.array_equal(ky, np.broadcast_to(tiy.numpy(), ky.shape))
    on = (kx >= 0) & (kx < W) & (ky >= 0) & (ky < H)  # a record staged
    assert np.array_equal(on, inb.numpy())
    assert int(inb.sum()) > 0 and int((~inb).sum()) > 0
    # A lattice wider than the plan's window: its beams gather instead.
    wide = (dls * np.float32(4.0)).astype(np.float32)
    assert not window_entries(rx, wide, origin[0], cell, W, pl.winx)[3].any()


def test_minus_inf_fold_is_the_select():
    """Per term: the kernel's exponent v = scorable ? e : -inf, where a
    cell off the grid is staged as a zero record (not scorable), then
    exp(min(v, 0)); the twin's where(valid, exp(min(e, 0)), 0).  The same
    clamp where valid, -inf where not; exp(-inf) is +0; and a running sum
    of such terms from +0 (the kernel skips a masked beam's +0 terms) has
    the twin's bits."""
    rng = np.random.default_rng(5)
    n = 4096
    e = (-rng.exponential(3.0, n)).astype(np.float32)
    e[:16] = np.float32(-0.0)
    e[16:32] = np.float32(0.0)
    inb = rng.random(n) < 0.8
    scorable = rng.random(n) < 0.7
    used = rng.random(n) < 0.9
    valid = inb & scorable & used
    staged = np.where(inb, scorable, False)   # a zero record off the grid
    v = np.where(staged, e, np.float32(-np.inf))
    clamp_k = np.minimum(v, np.float32(0.0))
    clamp_t = np.minimum(e, np.float32(0.0))
    live = valid
    assert np.all(np.isneginf(clamp_k[~(inb & scorable)]))
    assert clamp_k[live].tobytes() == clamp_t[live].tobytes()
    term_k = torch.exp(torch.from_numpy(clamp_k)).numpy()
    term_t = torch.where(torch.from_numpy(valid),
                         torch.exp(torch.from_numpy(clamp_t)),
                         torch.tensor(0.0)).numpy()
    term_k = np.where(used, term_k, np.float32(0.0))  # skipped: never added
    assert term_k.tobytes() == term_t.tobytes()
    acc_k = np.float32(0.0)
    acc_t = np.float32(0.0)
    for j in range(n):
        if used[j]:
            acc_k = np.float32(acc_k + term_k[j])
        acc_t = np.float32(acc_t + term_t[j])
    assert np.float32(acc_k).tobytes() == np.float32(acc_t).tobytes()
    assert np.float32(-acc_k).tobytes() == np.float32(-acc_t).tobytes()


def cover(L, pl):
    """The (lx, ly) each of the TILE threads scores, pass by pass."""
    seen = np.zeros((L, L), np.int64)
    for t in range(k6.TILE):
        tx, ty = divmod(t, pl.nyg)
        if tx >= pl.nxg:
            continue
        for p in range(pl.passes):
            x0 = p * pl.nxg * pl.kx
            for i in range(pl.kx):
                for j in range(pl.ky):
                    lx, ly = x0 + tx + i * pl.nxg, ty + j * pl.nyg
                    if lx < L and ly < L:
                        seen[lx, ly] += 1
    return seen


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("L", LATTICES)
def test_plan_covers_every_offset_once(L, fold):
    pl = k6.plan(L, fold)
    assert pl.nxg * pl.nyg <= k6.TILE and pl.nyg * pl.ky >= L
    assert (pl.kx, pl.ky) in k6.TILES
    assert pl.passes * pl.nxg * pl.kx >= L
    if pl.fused:  # one block an (angle, row): one pass
        assert pl.passes == 1 and pl.nxg == -(-L // pl.kx)
    if fold and L <= 42:
        assert pl.fused
    if not fold:  # a block a pass: a candidate a thread where L fits
        assert not pl.fused
        assert (pl.kx, pl.ky) == ((1, 1) if L <= k6.TILE else k6.TILES[-1])
    assert np.array_equal(cover(L, pl), np.ones((L, L), np.int64))
    # The reduction's tiles: 256 consecutive flat offsets each, every
    # offset in one.
    tiles = k6.blocks_per_angle(torch.zeros(L))
    flats = np.concatenate([np.arange(k * k6.TILE,
                                      min((k + 1) * k6.TILE, L * L))
                            for k in range(tiles)])
    assert np.array_equal(flats, np.arange(L * L))


@pytest.mark.parametrize("L", [40, 41, 10])
def test_warp_lanes_hold_a_compact_patch(L):
    """At the searches' lattices (the coarse stage and the merge, 40 and 41
    offsets; the one-cell check's 10) a warp's lanes hold, at one term
    (i, j), at most 11 consecutive dy and 6 consecutive dx, a compact patch
    of offsets whose records sit in few window cells (one lane a dy would
    span 32)."""
    pl = k6.plan(L)
    assert pl.nyg <= 11
    for w in range(k6.TILE // 32):
        lanes = [divmod(t, pl.nyg) for t in range(32 * w, 32 * w + 32)]
        lanes = [(tx, ty) for tx, ty in lanes if tx < pl.nxg]
        if not lanes:
            continue
        xs = {tx for tx, _ in lanes}
        ys = {ty for _, ty in lanes}
        assert max(ys) - min(ys) < 11 and max(xs) - min(xs) < 6


@pytest.mark.parametrize("L", LATTICES)
def test_shared_memory_fits(L):
    for fold in (True, False):
        for cells in (0.0, (L - 1) * 0.2, (L - 1) * 0.1 / 0.5 * 40):
            pl = k6.plan(L, fold, cells)
            stage = 24 * pl.winx * pl.winy + 8 * (pl.nxg * pl.kx + L)
            assert k6.stage_bytes(pl, L) == -(-pl.chunk * stage // 16) * 16
            smem = k6.plan_smem(pl, L)
            assert smem == max(2 * k6.stage_bytes(pl, L)
                               + 12 * (5 * pl.chunk + 1),
                               4 * L * L if pl.fused else 0)
            assert smem + k6.SMEM_STATIC <= k6.SMEM_LIMIT
            assert pl.chunk <= k6.MAX_CHUNK
            assert pl.chunk == 1 or pl.chunk * stage <= k6.STAGE_BYTES
            if pl.winy:  # a window holds the span and a cell to spare
                assert pl.winy >= cells + 2 and pl.winx * pl.winy <= k6.TILE
    # The main path's lattices stage windows and fold their scores with
    # two blocks an SM.
    for L, cells in ((40, 7.8), (41, 8.0), (21, 4.0)):
        for fold in (True, False):
            pl = k6.plan(L, fold, cells)
            assert pl.fused == fold and pl.winx * pl.winy > 0
            assert 2 * (k6.plan_smem(pl, L) + k6.SMEM_STATIC) <= k6.SMEM_LIMIT
    assert not k6.plan(241).fused
    assert k6.plan(301).ky == k6.TILES[-1][1]  # the widest tile, by passes
    for L in (0, k6.TILES[-1][1] * k6.TILE + 1):
        with pytest.raises(ValueError):
            k6.plan(L)
