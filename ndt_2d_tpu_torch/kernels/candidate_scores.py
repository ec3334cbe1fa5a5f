"""K2: exhaustive candidate scoring + its reduction (CUDA
``csrc/candidate_scores.cu``) and the plain-PyTorch twin.

Replaces the local fast path of ``ndt_2d_tpu/matching/matcher.py``
(``prepare_neighborhood`` -> ``_candidate_scores_local`` ->
``reduce_candidates`` -> ``finalize_match``), which the retired Pallas
kernels ``candidate_scores_pallas`` / ``_gather`` also computed.  The
kernel covers lattices no wider than one NDT cell
(2 * search_linear_size <= ndt_resolution), where each (angle, beam) meets
one 2x2 cell patch; the matcher sends wider ones to K6
(``kernels/candidate_gather.py``), which shares this module's reduction,
row packing and launch plumbing.

``match_rows`` takes a row axis (R confirmation rows, the ``jax.vmap`` of
``match_scan_batch_multi``); ``match`` is the same launch at R = 1.  Both
return the kernel's [R, 13] output rows, which K7 refines in place and
``unpack`` reads.  A grid with a grid axis (the four overlapping grids of
K1 with ``grids=4``: origin [4, 2], tables [4, C, 32] per row) is scored
as the mean over its grids (matcher.py:194-202); without one, the launch
is the single-grid search.

The twin adds in the kernel's order (each candidate's beams from 0, the
Olson sums through the kernel's warp tree, warps and angles in order), so
on the same CUDA inputs kernel and twin agree bitwise.  ``tile_plan`` says
how a launch spreads an angle's candidates over a block's threads.

For a device mesh (K12, ``ndt_2d_tpu/parallel/matcher.py::
match_scan_multichip``) the launch splits in two: ``partial_rows`` scores
one rank's block of angles into per-angle partials (best, first flat
index, the 10 Olson sums) and ``finalize_rows`` folds the partials of all
angles, gathered in rank order, in angle order.  The fold is the one the
one-launch search makes, so the split search equals it bitwise; the twin's
``reduce_candidates`` is the same two steps.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ndt_2d_tpu_torch.kernels import _build
from ndt_2d_tpu_torch.kernels import slam_step as kb4
from ndt_2d_tpu_torch.kernels.score_points import subsample
from ndt_2d_tpu_torch.ndt import grid as ndt_grid

launches = 0
# K12: launches of the split search's two entries.
partial_launches = 0
finalize_launches = 0

_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_float]
         + [ctypes.c_int] * 2
         + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
         + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
         + [ctypes.c_void_p] + [ctypes.c_int] + [ctypes.c_void_p] * 4)
_PARTIAL_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_float]
                 + [ctypes.c_int] * 2
                 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                 + [ctypes.c_void_p] + [ctypes.c_int] * 2
                 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                 + [ctypes.c_void_p] + [ctypes.c_int] + [ctypes.c_void_p] * 2)


def _with_plan(args: list, ints: int, field: bool = False) -> list:
    """The signatures above with a launch plan's ``ints`` ints before the
    stream (K2's tile plan, K6's plan), and K6's partials entry's field
    pointer before them."""
    return (args[:-1] + [ctypes.c_void_p] * field + [ctypes.c_int] * ints
            + args[-1:])


_FINALIZE_ARGS = ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                  + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4)
# Per-angle partial of the kernel: best, best index, 10 Olson sums.
_PARTIAL = 12
# The thread tiles (KX dx rows x KY dy columns) the kernel is built for:
# 2 x 4 for launches that fill the card, one candidate a thread otherwise.
TILES = ((2, 4), (1, 1))


class TilePlan(NamedTuple):
    """How one K2 block covers an (angle, row)'s L x L candidates: thread
    t = tx * nyg + ty (tx < nxg) of ``threads`` takes the dx rows tx + i *
    nxg (i < kx) and the dy columns ty + j * nyg (j < ky), those below
    L."""
    kx: int
    ky: int
    nxg: int
    nyg: int
    threads: int


@functools.lru_cache(maxsize=None)
def tile_plan(A: int, L: int, R: int, sms: int, tile=None) -> TilePlan:
    """The K2 launch plan for A angles x L x L candidates over R rows on a
    card of ``sms`` SMs.  A launch of fewer (angle, row) blocks than SMs is
    bound by each candidate's chain of beam adds, so it takes one
    candidate a thread (thread t is flat index t); a larger one 2 x 4.
    ``tile`` (kx, ky) forces a tile."""
    if not 1 <= L <= 32 or A < 1 or R < 1:
        raise ValueError(f"lattice {A}x{L}x{L} over {R} rows is outside the "
                         "kernel's range")
    if tile is not None and tuple(tile) not in TILES:
        raise ValueError(f"tile {tile}: the kernel is built for {TILES}")
    kx, ky = tile if tile is not None else (1, 1) if A * R < sms else (2, 4)
    nxg, nyg = -(-L // kx), -(-L // ky)
    return TilePlan(kx, ky, nxg, nyg, -(-nxg * nyg // 32) * 32)


class MatchResult(NamedTuple):
    score: torch.Tensor        # best candidate score / beams used
    correction: torch.Tensor   # [3] (dx, dy, dtheta) to add to the pose
    covariance: torch.Tensor   # [3, 3] Olson covariance of the search


def search_offsets(config, device):
    """The candidate lattice: angles [A], linear offsets [L] (both axes)."""
    a = (-config.search_angular_size
         + torch.arange(config.num_angles, dtype=torch.float32, device=device)
         * config.search_angular_resolution)
    l = (-config.search_linear_size
         + torch.arange(config.num_linear, dtype=torch.float32, device=device)
         * config.search_linear_resolution)
    return a, l


def prepare_neighborhood(config, grid: ndt_grid.NDTGrid, spts, smask, pose,
                         dths, dls, table):
    """Per-(angle, beam) operands from ONE patch-row gather: rotated beam
    (bx, by), crossing lines (cross_x, cross_y) [A, B], the 2x2 patch
    [A, B, 2(y), 2(x), 6] of (mean_x, mean_y, i00, i01, i11, ok), and the
    grid bounds (x_lo, x_hi, y_lo, y_hi) as 0-d tensors."""
    W, H = config.grid_cells_x, config.grid_cells_y
    cell = ndt_grid.f32(grid.cell_size, spts.device)
    th = pose[2] + dths
    c, s = torch.cos(th)[:, None], torch.sin(th)[:, None]
    px, py = spts[:, 0][None, :], spts[:, 1][None, :]
    bx = c * px - s * py + pose[0]
    by = s * px + c * py + pose[1]

    ix0 = torch.floor((bx + dls[0] - grid.origin[0]) / cell).to(torch.int32)
    iy0 = torch.floor((by + dls[0] - grid.origin[1]) / cell).to(torch.int32)
    ixc = torch.clamp(ix0, 0, W - 2)
    iyc = torch.clamp(iy0, 0, H - 2)
    cross_x = grid.origin[0] + (ixc.to(bx.dtype) + 1.0) * cell
    cross_y = grid.origin[1] + (iyc.to(by.dtype) + 1.0) * cell

    flat = (iyc * W + ixc).to(torch.int64)
    nb = table[flat].reshape(flat.shape[0], flat.shape[1], 2, 2, 8)
    ok = (nb[..., 5] > 0.5) & smask[None, :, None, None]
    pack = torch.cat([nb[..., :5], ok[..., None].to(nb.dtype)], dim=-1)
    bounds = (grid.origin[0], grid.origin[0] + W * cell,
              grid.origin[1], grid.origin[1] + H * cell)
    return bx, by, cross_x, cross_y, pack, bounds


def candidate_scores_local(config, grid: ndt_grid.NDTGrid, spts, smask,
                           pose, dths, dls, table):
    """[A, L(dx), L(dy)] candidate scores: -sum over beams of the clamped
    Gaussian of the patch cell each shifted beam lands in (masked by the
    grid bounds at candidate level)."""
    bx, by, cross_x, cross_y, pack, bounds = prepare_neighborhood(
        config, grid, spts, smask, pose, dths, dls, table)
    wxc = bx[:, None, :] + dls[None, :, None]             # [A, Lx, B]
    wyc = by[:, None, :] + dls[None, :, None]             # [A, Ly, B]
    jx = (wxc >= cross_x[:, None, :])[:, :, None, :]       # [A, Lx, 1, B]
    jy = (wyc >= cross_y[:, None, :])[:, None, :, :]       # [A, 1, Ly, B]
    x_lo, x_hi, y_lo, y_hi = bounds
    in_gx = ((wxc >= x_lo) & (wxc < x_hi))[:, :, None, :]
    in_gy = ((wyc >= y_lo) & (wyc < y_hi))[:, None, :, :]

    def sel(f):
        """Field f of the selected patch cell, [A, Lx, Ly, B]."""
        v = pack[..., f][:, None, None]                    # [A,1,1,B,2,2]
        lo = torch.where(jx, v[..., 0, 1], v[..., 0, 0])
        hi = torch.where(jx, v[..., 1, 1], v[..., 1, 0])
        return torch.where(jy, hi, lo)

    valid = (sel(5) > 0.5) & in_gx & in_gy
    qx = wxc[:, :, None, :] - sel(0)
    qy = wyc[:, None, :, :] - sel(1)
    e = -0.5 * (sel(2) * qx * qx + 2.0 * sel(3) * qx * qy
                + sel(4) * qy * qy)
    pt = torch.exp(torch.clamp(e, max=0.0))
    terms = torch.where(valid, pt, torch.zeros_like(pt))
    # The beams in order from 0, as each of the kernel's threads sums them.
    acc = torch.zeros_like(terms[..., 0])
    for b in range(terms.shape[-1]):
        acc = acc + terms[..., b]
    return -acc


def candidate_scores(config, grid: ndt_grid.NDTGrid, spts, smask, pose,
                     dths, dls, table, one=candidate_scores_local):
    """[A, L, L] candidate scores; a stacked grid (origin [G, 2], table
    [G, C, 32]) scores the mean over its grids, summed from 0 in grid order
    as Python's ``sum`` does (matcher.py:194-202).  ``one`` scores one
    grid (K6 passes its per-candidate gather)."""
    if table.dim() == 2:
        return one(config, grid, spts, smask, pose, dths, dls, table)
    per = [one(
        config, ndt_grid.NDTGrid(origin=grid.origin[g],
                                 cell_size=grid.cell_size, mean=None,
                                 information=None, count=None,
                                 covariance=None),
        spts, smask, pose, dths, dls, table[g])
        for g in range(table.shape[0])]
    return sum(per) / ndt_grid.f32(len(per), spts.device)


def _block_sums(terms, tile=None):
    """terms [A, T, K] summed per block in the kernel's order: per angle
    its T candidates as zero-padded 32-lane warps, each folded in halves
    (the shuffle tree), the warps added in order.  With ``tile`` (K6's
    block size) each angle's candidates are first cut into zero-padded
    tiles of that many, and the (angle, tile) blocks take the angles'
    place.  Returns [blocks, K]."""
    if tile is not None:
        A, T, K = terms.shape
        nt = -(-T // tile)
        terms = torch.nn.functional.pad(terms, (0, 0, 0, nt * tile - T))
        terms = terms.reshape(A * nt, tile, K)
    A, T, K = terms.shape
    nw = -(-T // 32)
    x = torch.nn.functional.pad(terms, (0, 0, 0, nw * 32 - T))
    x = x.reshape(A, nw, 32, K)
    for h in (16, 8, 4, 2, 1):
        x = x[:, :, :h] + x[:, :, h:2 * h]
    acc = x[:, 0, 0]
    for w in range(1, nw):
        acc = acc + x[:, w, 0]
    return acc


def _fold_sums(acc):
    """[blocks, K] block sums added in block order from the first."""
    total = acc[0]
    for a in range(1, acc.shape[0]):
        total = total + acc[a]
    return total


def _sum_as_kernel(terms, tile=None):
    """terms [A, T, K] summed in the kernel's order: each block's sum
    (``_block_sums``), then the blocks in order."""
    return _fold_sums(_block_sums(terms, tile))


def block_partials(cand, dths, dls, a0: int = 0, tile=None):
    """The kernel's partials of candidate scores ``cand`` [n, L, L], the
    angles a0 .. a0 + n - 1 of the lattice ``dths``: per angle (with
    ``tile``, per (angle, tile) block) the lowest score, its first flat
    index in the whole lattice (int32 bits stored as float32) and the 10
    Olson sums.  Returns [blocks, 12] float32."""
    n, L = cand.shape[0], cand.shape[1]
    LL = L * L
    bd = dths[a0:a0 + n]
    x = torch.stack([dls[None, :, None].expand(n, L, L),
                     dls[None, None, :].expand(n, L, L),
                     bd[:, None, None].expand(n, L, L)], dim=-1)
    sw = cand[..., None]
    i, j = [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]
    terms = torch.cat([sw, x * sw, x[..., i] * x[..., j] * sw], dim=-1)
    sums = _block_sums(terms.reshape(n, LL, 10), tile)
    size = LL if tile is None else tile
    nb = -(-LL // size)
    flat = torch.nn.functional.pad(cand.reshape(n, LL),
                                   (0, nb * size - LL), value=math.inf)
    best, arg = torch.min(flat.reshape(n * nb, size), dim=1)
    base = ((a0 + torch.arange(n, device=cand.device))[:, None] * LL
            + torch.arange(nb, device=cand.device)[None, :] * size)
    index = (base.reshape(-1) + arg).to(torch.int32)
    return torch.cat([best[:, None], index.view(torch.float32)[:, None],
                      sums], dim=1)


def fold_partials(partials, dths, dls):
    """(best, correction [3], K [3, 3], u [3], s) from the partials [N, 12]
    of a whole lattice in order, as the kernel's finalize folds them: the
    lowest score with the earliest index (strictly lower scores replace
    it), the sums added from the first partial on; the correction applies
    only when best < 0."""
    L = dls.shape[0]
    bi = int(torch.argmin(partials[:, 0]))  # the first of equal lows
    best = partials[bi, 0]
    idx = int(partials[bi, 1:2].view(torch.int32))
    total = _fold_sums(partials[:, 2:])
    ai, xi, yi = idx // (L * L), (idx // L) % L, idx % L
    correction = torch.where(best < 0.0,
                             torch.stack([dls[xi], dls[yi], dths[ai]]),
                             torch.zeros(3, dtype=best.dtype,
                                         device=best.device))
    k = total[[4, 5, 6, 5, 7, 8, 6, 8, 9]].reshape(3, 3)
    return best, correction, k, total[1:4], total[0]


def reduce_candidates(cand, dths, dls, tile=None):
    """(best, correction [3], K [3, 3], u [3], s): first-index argmin in
    (angle, dx, dy) order, correction applied only when best < 0, and the
    raw Olson accumulators over every candidate, summed in the kernel's
    order (K2's, or with ``tile`` K6's): the partials of every angle,
    folded."""
    return fold_partials(block_partials(cand, dths, dls, 0, tile), dths,
                         dls)


def finalize_match(best, correction, k, u, s, used: int) -> MatchResult:
    """cov = K/s + u u^T / s^2 and score / max(used, 1); when s == 0 (no
    candidate scored any point) a weak isotropic covariance
    diag(1, 1, 0.25) instead of the reference's inf/NaN."""
    dev = best.device
    ok = s < 0.0
    safe = torch.where(ok, s, ndt_grid.f32(-1.0, dev))
    covariance = k / safe + (u[:, None] * u[None, :]) / (safe * safe)
    fallback = torch.diag(torch.tensor([1.0, 1.0, 0.25], dtype=best.dtype,
                                       device=dev))
    covariance = torch.where(ok, covariance, fallback)
    return MatchResult(score=best / ndt_grid.f32(max(used, 1), dev),
                       correction=correction, covariance=covariance)


def match_twin(config, grid: ndt_grid.NDTGrid, table, points, point_mask,
               num_points: int, pose, dths, dls):
    """Plain-PyTorch K2: (MatchResult, scores [A, L, L]).  table [C, 32],
    or [G, C, 32] with grid.origin [G, 2]."""
    spts, smask, used = subsample(points, point_mask, num_points,
                                  config.laser_max_beams)
    cand = candidate_scores(config, grid, spts, smask, pose, dths, dls,
                            table)
    best, correction, k, u, s = reduce_candidates(cand, dths, dls)
    return finalize_match(best, correction, k, u, s, used), cand


def match_rows_twin(config, grid: ndt_grid.NDTGrid, tables, points,
                    point_mask, num_points, poses, dths, dls,
                    match=match_twin):
    """Plain-PyTorch K2 over a row axis, one row at a time: (MatchResult
    of [R], [R, 3], [R, 3, 3] tensors, scores [R, A, L, L]).  ``match`` is
    the one-row twin (K6 passes its own)."""
    res, cand = [], []
    for r in range(points.shape[0]):
        g = ndt_grid.NDTGrid(origin=grid.origin[r], cell_size=grid.cell_size,
                             mean=None, information=None, count=None,
                             covariance=None)
        m, c = match(config, g, tables[r], points[r], point_mask[r],
                     int(num_points[r]), poses[r], dths, dls)
        res.append(m)
        cand.append(c)
    return (MatchResult(*[torch.stack([getattr(m, f) for m in res])
                          for f in MatchResult._fields]),
            torch.stack(cand))


def pack(res: MatchResult) -> torch.Tensor:
    """A MatchResult of R rows as the kernel's [R, 13] output rows (score,
    correction, row-major covariance)."""
    return torch.cat([res.score[:, None], res.correction,
                      res.covariance.reshape(-1, 9)], 1)


def unpack(out) -> MatchResult:
    """[R, 13] output rows as a MatchResult of views into them."""
    return MatchResult(score=out[:, 0], correction=out[:, 1:4],
                       covariance=out[:, 4:13].reshape(-1, 3, 3))


def launch_rows(symbol: str, slots: int, config, origin, cell_size: float,
                tables, points, point_mask, nums, num: int, poses, dths,
                dls, with_scores: bool, plan=()):
    """Check the arguments and launch the lattice search ``symbol`` (K2's
    or K6's C entry, which share their signature up to their ``plan``
    ints before the stream) over R rows, with a scratch of ``slots``
    partials a row (tables [R, (G,) C, 32], origin [R, (G,) 2]); returns
    (out [R, 13], scores or None).  The caller counts the launch."""
    dev = points.device
    W, H = config.grid_cells_x, config.grid_cells_y
    R, P = points.shape[0], points.shape[1]
    A, L = dths.shape[0], dls.shape[0]
    if tables.dim() == 3:  # no grid axis: G = 1
        tables, origin = tables[:, None], origin[:, None]
    G = tables.shape[1]
    _build.require(tables, "tables", torch.float32, (R, G, W * H, 32), dev)
    _build.require(origin, "origin", torch.float32, (R, G, 2), dev)
    _build.require(points, "points", torch.float32, (R, P, 2), dev)
    _build.require(point_mask, "point_mask", torch.bool, (R, P), dev)
    if nums is not None:
        _build.require(nums, "num_points", torch.int32, (R,), dev)
    _build.require(poses, "poses", torch.float32, (R, 3), dev)
    _build.require(dths, "dths", torch.float32, (A,), dev)
    _build.require(dls, "dls", torch.float32, (L,), dev)
    partial = torch.empty(R, slots, _PARTIAL, dtype=torch.float32,
                          device=dev)
    out = torch.empty(R, 13, dtype=torch.float32, device=dev)
    scores = (torch.empty(R, A, L, L, dtype=torch.float32, device=dev)
              if with_scores else None)
    p = _build.ptr
    err = _build.function(symbol, _with_plan(_ARGS, len(plan)))(
        p(tables), p(origin), G, float(cell_size), W, H, p(points),
        p(point_mask), R, P, None if nums is None else p(nums), int(num),
        int(config.laser_max_beams), p(poses), p(dths), A, p(dls), L,
        p(partial), p(out), None if scores is None else p(scores), *plan,
        _build.stream_ptr(dev))
    _build.check(err, symbol)
    return out, scores


def _tiles(tables, points, dls, A: int):
    """K2's launch plan for these operands (and its range checks): the
    patch rows are copied 16 bytes at a time, so the tables must be
    16-byte aligned."""
    if tables.data_ptr() % 16:
        raise ValueError("tables: not 16-byte aligned")
    return tile_plan(A, dls.shape[0], points.shape[0],
                     _build.sm_count(points.device.index))


def _launch(config, origin, cell_size: float, tables, points, point_mask,
            nums, num: int, poses, dths, dls, with_scores: bool):
    """One K2 launch over R rows; returns (out [R, 13], scores or None)."""
    global launches
    W, H = config.grid_cells_x, config.grid_cells_y
    A, L = dths.shape[0], dls.shape[0]
    if L * L > 1024 or A > 512 or W < 2 or H < 2:
        raise ValueError(f"lattice {A}x{L}x{L} on a {W}x{H} grid is outside "
                         "the kernel's range")
    out, scores = launch_rows("ndt2d_candidate_scores", A, config, origin,
                              cell_size, tables, points, point_mask, nums,
                              num, poses, dths, dls, with_scores,
                              _tiles(tables, points, dls, A))
    launches += 1
    return out, scores


def match_rows(config, grid: ndt_grid.NDTGrid, tables, points, point_mask,
               num_points, poses, dths, dls, with_scores: bool = False):
    """K2 over R rows in one launch.  grid.origin [R, (G,) 2] f32 (the
    other grid fields are not read), tables [R, (G,) H*W, 32] f32 (K1's),
    points [R, P, 2] f32, point_mask [R, P] bool, num_points [R] int32,
    poses [R, 3] f32, dths [A] / dls [L] f32.  Returns the [R, 13] output
    rows (``unpack`` reads them; K7 refines them in place), or (rows,
    scores [R, A, L, L]) with ``with_scores``.  CPU tensors run the twin;
    CUDA tensors launch the kernel."""
    if points.device.type == "cpu":
        res, cand = match_rows_twin(config, grid, tables, points, point_mask,
                                    num_points, poses, dths, dls)
        return (pack(res), cand) if with_scores else pack(res)
    out, scores = _launch(config, grid.origin, grid.cell_size, tables,
                          points, point_mask, num_points, 0, poses, dths,
                          dls, with_scores)
    return (out, scores) if with_scores else out


def match(config, grid: ndt_grid.NDTGrid, table, points, point_mask,
          num_points: int, pose, dths, dls, with_scores: bool = False):
    """K2 of one scan: ``match_rows``' launch at R = 1.  table [(G,) H*W,
    32] f32 (K1's, with grid.origin [(G,) 2]), points [P, 2] f32,
    point_mask [P] bool, pose [3] f32, dths [A] / dls [L] f32.  Returns its
    [1, 13] output row, or (row, scores [A, L, L]) with ``with_scores``,
    which makes the kernel also write its per-candidate scores (a check of
    the kernel; the match itself never stores them).  CPU tensors run the
    twin; CUDA tensors launch the kernel."""
    if points.device.type == "cpu":
        res, cand = match_twin(config, grid, table, points, point_mask,
                               num_points, pose, dths, dls)
        out = pack(MatchResult(*[x[None] for x in res]))
        return (out, cand) if with_scores else out
    out, scores = _launch(config, grid.origin[None], grid.cell_size,
                          table[None], points[None], point_mask[None], None,
                          num_points, pose[None], dths, dls, with_scores)
    return (out, scores[0]) if with_scores else out


# --- K12: the split search of a device mesh -------------------------------
def blocks_per_angle(dls) -> int:
    """Partials an angle: K2 reduces each angle in one block."""
    del dls
    return 1


def _row_nums(num_points, R: int):
    """Per-row beam counts as ints: ``num_points`` is an int32 [R] tensor or
    one int for every row."""
    if isinstance(num_points, torch.Tensor):
        return [int(v) for v in num_points.tolist()]
    return [int(num_points)] * R


def partial_rows_twin(config, grid: ndt_grid.NDTGrid, tables, points,
                      point_mask, num_points, poses, dths, dls, a0: int,
                      n: int, tile=None, one=candidate_scores_local):
    """Plain-PyTorch ``partial_rows``: [R, blocks, 12] (``tile``, ``one``:
    K6's block size and per-candidate gather)."""
    R = points.shape[0]
    nums = _row_nums(num_points, R)
    out = []
    for r in range(R):
        g = ndt_grid.NDTGrid(origin=grid.origin[r], cell_size=grid.cell_size,
                             mean=None, information=None, count=None,
                             covariance=None)
        spts, smask, _ = subsample(points[r], point_mask[r], nums[r],
                                   config.laser_max_beams)
        cand = candidate_scores(config, g, spts, smask, poses[r],
                                dths[a0:a0 + n], dls, tables[r], one)
        out.append(block_partials(cand, dths, dls, a0, tile))
    return torch.stack(out)


def finalize_rows_twin(config, partials, num_points, dths, dls):
    """Plain-PyTorch ``finalize_rows``: [R, 13]."""
    R = partials.shape[0]
    rows = []
    for r, num in enumerate(_row_nums(num_points, R)):
        best, correction, k, u, s = fold_partials(partials[r], dths, dls)
        rows.append(finalize_match(best, correction, k, u, s,
                                   min(config.laser_max_beams, num)))
    return pack(MatchResult(*[torch.stack([getattr(m, f) for m in rows])
                              for f in MatchResult._fields]))


def launch_partials(symbol: str, config, origin, cell_size: float, tables,
                    points, point_mask, num_points, poses, dths, dls,
                    a0: int, n: int, per_angle: int, plan=(),
                    field=None, out=None):
    """Check the arguments and launch the partials entry ``symbol`` (K2's
    or K6's, each taking its ``plan`` ints before the stream) over R rows
    for angles a0 .. a0 + n - 1; returns the partials [R, n * per_angle,
    12], written into ``out`` when given.  ``field`` (K6's entry, which
    takes a field pointer): whether it needs a scratch field [R, n, L, L]
    (else the pointer is null).  The caller counts the launch."""
    dev = points.device
    W, H = config.grid_cells_x, config.grid_cells_y
    R, P = points.shape[0], points.shape[1]
    A, L = dths.shape[0], dls.shape[0]
    if not 0 <= a0 <= a0 + n <= A or n < 1:
        raise ValueError(f"angle block {a0} + {n} outside the lattice's {A}")
    if tables.dim() == 3:  # no grid axis: G = 1
        tables, origin = tables[:, None], origin[:, None]
    G = tables.shape[1]
    _build.require(tables, "tables", torch.float32, (R, G, W * H, 32), dev)
    _build.require(origin, "origin", torch.float32, (R, G, 2), dev)
    _build.require(points, "points", torch.float32, (R, P, 2), dev)
    _build.require(point_mask, "point_mask", torch.bool, (R, P), dev)
    nums, num = (num_points, 0) if isinstance(num_points, torch.Tensor) \
        else (None, int(num_points))
    if nums is not None:
        _build.require(nums, "num_points", torch.int32, (R,), dev)
    _build.require(poses, "poses", torch.float32, (R, 3), dev)
    _build.require(dths, "dths", torch.float32, (A,), dev)
    _build.require(dls, "dls", torch.float32, (L,), dev)
    if out is None:
        partial = torch.empty(R, n * per_angle, _PARTIAL,
                              dtype=torch.float32, device=dev)
    else:
        _build.require(out, "out", torch.float32, (R, n * per_angle,
                                                   _PARTIAL), dev)
        partial = out
    p = _build.ptr
    scratch = []  # K6's field pointer, held until the launch
    if field is not None:
        buf = (torch.empty(R, n, L, L, dtype=torch.float32, device=dev)
               if field else None)
        scratch = [None if buf is None else p(buf)]
    err = _build.function(symbol, _with_plan(_PARTIAL_ARGS, len(plan),
                                             field is not None))(
        p(tables), p(origin), G, float(cell_size), W, H, p(points),
        p(point_mask), R, P, None if nums is None else p(nums), num,
        int(config.laser_max_beams), p(poses), p(dths), int(a0), int(n),
        p(dls), L, p(partial), *scratch, *plan, _build.stream_ptr(dev))
    _build.check(err, symbol)
    return partial


def launch_finalize(symbol: str, config, partials, num_points, dths, dls,
                    per_angle: int):
    """Check the arguments and launch the finalize entry ``symbol`` over
    the partials [R, A * per_angle, 12] of all A angles; returns [R, 13].
    The caller counts the launch."""
    dev = partials.device
    R, A, L = partials.shape[0], dths.shape[0], dls.shape[0]
    _build.require(partials, "partials", torch.float32,
                   (R, A * per_angle, _PARTIAL), dev)
    nums, num = (num_points, 0) if isinstance(num_points, torch.Tensor) \
        else (None, int(num_points))
    if nums is not None:
        _build.require(nums, "num_points", torch.int32, (R,), dev)
    _build.require(dths, "dths", torch.float32, (A,), dev)
    _build.require(dls, "dls", torch.float32, (L,), dev)
    out = torch.empty(R, 13, dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _build.function(symbol, _FINALIZE_ARGS)(
        p(partials), R, A, L, None if nums is None else p(nums), num,
        int(config.laser_max_beams), p(dths), p(dls), p(out),
        _build.stream_ptr(dev))
    _build.check(err, symbol)
    return out


def partial_rows(config, grid: ndt_grid.NDTGrid, tables, points, point_mask,
                 num_points, poses, dths, dls, a0: int, n: int, out=None):
    """K12's first half on K2: the per-angle partials [R, n, 12] of angles
    a0 .. a0 + n - 1 of the lattice ``dths`` (one rank's block), flat
    indices global, written into ``out`` when given (a split plan's send
    buffer, ``SplitPlan.head``).  Arguments as ``match_rows``;
    ``num_points`` an int32 [R] tensor or one int.  CPU tensors run the
    twin; CUDA tensors launch the kernel."""
    global partial_launches
    if points.device.type == "cpu":
        rows = partial_rows_twin(config, grid, tables, points, point_mask,
                                 num_points, poses, dths, dls, a0, n)
        return rows if out is None else out.copy_(rows)
    out = launch_partials("ndt2d_candidate_partials", config, grid.origin,
                          grid.cell_size, tables, points, point_mask,
                          num_points, poses, dths, dls, a0, n, 1,
                          _tiles(tables, points, dls, n), out=out)
    partial_launches += 1
    return out


def finalize_rows(config, partials, num_points, dths, dls):
    """K12's second half on K2: the [R, 13] output rows from the partials
    [R, A, 12] of every angle in angle order (gathered from the ranks in
    rank order).  Bitwise the one-launch ``match_rows``.  CPU tensors run
    the twin; CUDA tensors launch the kernel."""
    global finalize_launches
    if partials.device.type == "cpu":
        return finalize_rows_twin(config, partials, num_points, dths, dls)
    out = launch_finalize("ndt2d_candidate_finalize", config, partials,
                          num_points, dths, dls, 1)
    finalize_launches += 1
    return out


# --- K12: the split search's finalize, planned ----------------------------
# Launches of the fused SLAM step's finalize with KB4's append in it.
finalize_append_launches = 0
# Launches of K6's planned finalize (a plan of more than one partial an
# angle; the same kernel as K2's).
gather_finalize_launches = 0

_PLANNED_FINALIZE_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                          + [ctypes.c_void_p] * 2)
_FINALIZE_APPEND_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                         + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                         + [ctypes.c_void_p] * 4)


def gathered_rows(gathered, A: int):
    """The partials [R, A * per, 12] of all A angles in (angle, tile)
    order, read from a split search's gathered send buffers [S, R, blk *
    per, 12] (blk = ceil(A / S); K2 one partial an angle, K6 ``per``) by
    the finalize's rule: rank s's [R, n_s * per, 12] block (n_s = min(blk,
    A - s * blk) angles, none past the lattice's end) starts its buffer,
    whose tail is never read."""
    S, R, width = gathered.shape[:3]
    blk = -(-A // S)
    if width % blk:
        raise ValueError(f"{S} blocks of {width} partials do not split {A} "
                         "angles")
    per = width // blk
    flat = gathered.reshape(S, -1)
    parts = [flat[s, :R * n * per * _PARTIAL].view(R, n * per, _PARTIAL)
             for s, n in ((s, min(blk, A - s * blk)) for s in range(S))
             if n > 0]
    return torch.cat(parts, 1)


def finalize_gathered_twin(config, gathered, num_points, dths, dls):
    """Plain-PyTorch ``SplitPlan.finalize``: [R, 13] from the gathered send
    buffers [S, R, blk * per, 12] read in place (``gathered_rows``), folded
    as ``finalize_rows_twin`` folds them."""
    return finalize_rows_twin(config, gathered_rows(gathered, dths.shape[0]),
                              num_points, dths, dls)


def finalize_append_twin(config, gathered, num_points, dths, dls, append):
    """Plain-PyTorch ``SplitPlan.finalize`` with the fused step's append
    (``append``, a ``kernels.slam_step.Append`` at R = 1): the finalize's
    [1, 13] row, then KB4's twin from its correction and covariance."""
    out = finalize_gathered_twin(config, gathered, num_points, dths, dls)
    kb4.append_twin(append.plan.state, append.est_pose, out[0, 1:4],
                    out[0, 4:13].view(3, 3), append.scan_points,
                    append.scan_mask, append.i, append.j, append.has_prior)
    return out


class _SplitFinalize(ctypes.Structure):
    """``struct SplitFinalize`` (``csrc/candidate_scores.cu``)."""

    _fields_ = ([(f, ctypes.c_void_p) for f in ("gathered", "dths", "dls")]
                + [(f, ctypes.c_int) for f in ("R", "A", "L", "blk", "per",
                                               "max_beams")])


@functools.lru_cache(maxsize=None)
def _planned_functions():
    """The planned finalize's two entries, after checking that
    ``_SplitFinalize`` has the C structure's size."""
    theirs = _build.function("ndt2d_split_plan_size", [])()
    if ctypes.sizeof(_SplitFinalize) != theirs:
        raise RuntimeError(f"SplitFinalize of {ctypes.sizeof(_SplitFinalize)}"
                           f" bytes, the kernels' {theirs}")
    return (_build.function("ndt2d_candidate_finalize_planned",
                            _PLANNED_FINALIZE_ARGS),
            _build.function("ndt2d_candidate_finalize_append",
                            _FINALIZE_APPEND_ARGS))


class SplitPlan:
    """K12's split search of R rows on one rank of a ``space`` line of S
    ranks, planned once for (device, S, R, A, L, the form of
    ``num_points``, ``per``): K2's (one partial an angle, ``per`` = 1) or
    K6's (``per`` = ``candidate_gather.blocks_per_angle``, a partial a tile
    of an angle's offsets).  The rank's send buffer of R x blk x per
    partials (blk = ceil(A / S)), whose head [R, n * per, 12] the partials
    launch writes (``head``), the stack [S, R x blk x per x 12] the
    all-gather writes, and the finalize's arguments packed into two
    ``SplitFinalize`` structures, one reading the stack and one reading the
    send buffer (a group of one rank gathers nothing: the send buffer is
    the stack), with the lattice and ``max_beams`` (checked and packed
    again when they change: the matcher's lattice is cached,
    ``_search_offsets``).  ``finalize`` reads the stack in place, with no
    reordering copy, and makes one ctypes call with the structure, the row
    counts, the output and the stream; it allocates the [R, 13] output a
    call (a caller may keep a search's rows while the next search runs).
    Plans are kept (``split_plan``); every launch of a plan's buffers runs
    on the current stream, in issue order.  ``finalize`` refuses a buffer
    that is not the plan's and ``num_points`` not in the planned form; on
    CPU tensors it then runs ``finalize_gathered_twin`` (with an append,
    ``finalize_append_twin``)."""

    def __init__(self, device, shards: int, R: int, A: int, L: int,
                 nums: bool, per: int = 1):
        if A < 1 or L < 1 or shards < 1 or R < 1 or per < 1:
            raise ValueError(f"a split of {A}x{L}x{L} candidates over "
                             f"{shards} ranks, {R} rows, {per} partials an "
                             "angle, is outside the kernel's range")
        self.device = torch.device(device)
        self.eager = self.device.type == "cpu"
        self.shards, self.R, self.A, self.L, self.per = shards, R, A, L, per
        self.blk = blk = -(-A // shards)
        n = R * blk * per * _PARTIAL
        buf = torch.empty((shards + 1) * n, dtype=torch.float32,
                          device=self.device)
        self.send = buf[:n]
        self.stack = buf[n:].view(shards, n)
        self._heads = {}
        f32 = torch.float32
        self._lattice_expect = (("dths", f32, (A,)), ("dls", f32, (L,)))
        self._nums_expect = (("num_points", torch.int32, (R,)),)
        self._nums = nums
        self._lattice = (None, None, None)  # (dths, dls, max_beams) packed
        self._out_shape = (R, 13)
        self._structs = {t.data_ptr(): _SplitFinalize(t.data_ptr(), None,
                                                      None, R, A, L, blk,
                                                      per, 0)
                         for t in (self.send, self.stack)}
        self._at = {k: ctypes.addressof(v) for k, v in self._structs.items()}
        self._sizes = {t.data_ptr(): t.numel() for t in (self.send,
                                                         self.stack)}

    def head(self, n: int):
        """The send buffer's head [R, n * per, 12], where a block of n
        angles' partials go."""
        view = self._heads.get(n)
        if view is None:
            if not 0 < n <= self.blk:
                raise ValueError(f"{n} angles: a block holds {self.blk}")
            m = n * self.per
            view = self._heads[n] = self.send[:self.R * m * _PARTIAL].view(
                self.R, m, _PARTIAL)
        return view

    def _pack(self, dths, dls, max_beams: int) -> None:
        """Check the lattice and pack it and ``max_beams`` into both
        structures."""
        _build.require_all(self.device, (dths, dls), self._lattice_expect)
        for st in self._structs.values():
            st.dths, st.dls, st.max_beams = (dths.data_ptr(), dls.data_ptr(),
                                             max_beams)
        self._lattice = (dths, dls, max_beams)

    def finalize(self, config, gathered, num_points, dths, dls, append=None):
        """[R, 13] output rows from ``gathered``, the send buffer (a group
        of one) or the stack after the all-gather; bitwise the one-launch
        search's.  ``num_points`` an int32 [R] tensor or one int, as
        planned.  ``append`` (a ``kernels.slam_step.Append``, R = 1): the
        fused step's KB4 in the same launch."""
        global finalize_launches, finalize_append_launches, \
            gather_finalize_launches
        ptr = gathered.data_ptr()
        at = self._at.get(ptr)
        if at is None or gathered.numel() != self._sizes[ptr]:
            raise ValueError("gathered: not this plan's send buffer or "
                             "stack")
        if isinstance(num_points, torch.Tensor) != self._nums:
            raise TypeError("num_points: not in the planned form")
        if self.eager:
            g = gathered.view(-1, self.R, self.blk * self.per, _PARTIAL)
            if append is None:
                return finalize_gathered_twin(config, g, num_points, dths,
                                              dls)
            _append_check(self, append)
            return finalize_append_twin(config, g, num_points, dths, dls,
                                        append)
        last = self._lattice
        if (dths is not last[0] or dls is not last[1]
                or config.laser_max_beams != last[2]):
            self._pack(dths, dls, int(config.laser_max_beams))
        if self._nums:
            _build.require_all(self.device, (num_points,), self._nums_expect)
            nums, num = num_points.data_ptr(), 0
        else:
            nums, num = None, int(num_points)
        out = self.send.new_empty(self._out_shape)
        plain, folded = _planned_functions()
        st = _build.stream_ptr(self.device)
        if append is None:
            _build.check(plain(at, nums, num, out.data_ptr(), st),
                         "candidate_finalize")
            if self.per == 1:
                finalize_launches += 1
            else:
                gather_finalize_launches += 1
            return out
        _append_check(self, append)
        a = append
        i, j = int(a.i), int(a.j)
        _build.check(folded(
            at, nums, num, out.data_ptr(), a.plan.address,
            int(bool(a.has_prior)), i, j, max(i - 1, 0),
            a.est_pose.data_ptr(), a.scan_points.data_ptr(),
            a.scan_mask.data_ptr(), st), "candidate_finalize_append")
        finalize_append_launches += 1
        return out


def _append_check(plan: SplitPlan, append) -> None:
    """Raise unless ``append`` fits a one-row K2 plan on its device."""
    if plan.per != 1:
        raise ValueError("only K2's split search carries the append")
    if plan.R != 1:
        raise ValueError(f"the append rides in a one-row finalize, not "
                         f"{plan.R} rows")
    if append.plan.device != plan.device:
        raise ValueError(f"the state is on {append.plan.device}, the search "
                         f"on {plan.device}")
    append.plan.check_fold(append.est_pose, append.scan_points,
                           append.scan_mask, append.i, append.j)


_SPLIT_PLANS = {}


def split_plan(device, shards: int, R: int, A: int, L: int,
               nums: bool, per: int = 1) -> SplitPlan:
    """The kept ``SplitPlan`` of this key (``nums``: whether the searches
    pass ``num_points`` as an int32 [R] tensor; ``per``: the partials an
    angle, 1 for K2), made at its first use."""
    key = (device, shards, R, A, L, nums, per)
    plan = _SPLIT_PLANS.get(key)
    if plan is None:
        plan = _SPLIT_PLANS[key] = SplitPlan(device, shards, R, A, L, nums,
                                             per)
    return plan
