"""K6: exhaustive candidate scoring over a lattice wider than one NDT cell,
with its reduction (CUDA ``csrc/candidate_gather.cu``), and the
plain-PyTorch twin.

Replaces the general path of ``ndt_2d_tpu/matching/matcher.py``
(``_candidate_scores_gather`` -> ``reduce_candidates`` ->
``finalize_match``), which ``candidate_scores`` picks when
2 * search_linear_size > ndt_resolution: every (candidate, beam) looks up
the cell the shifted beam itself falls in.  It is the coarse stage of the
coarse-to-fine loop-closure confirmation and of the map merge.

The interface is K2's (``kernels/candidate_scores.py``): ``match_rows``
over R rows, ``match`` at R = 1, both returning the [R, 13] output rows
that K7 refines and ``unpack`` reads; a grid axis (G = 4) scores the mean
over the grids.  The cell records are the first 8 floats of each row of
K1's [C, 32] patch table (the cell's own ``packed_cell_table`` record), so
K6 reads the same table K2 does.

The twin adds in the kernel's order (each candidate's beams from 0; the
Olson sums per 256-offset tile through the warp tree, warps, tiles and
angles in order), so on the same CUDA inputs kernel and twin agree
bitwise.  For a device mesh (K12) the launch splits in two as K2's does:
``partial_rows`` over one rank's block of angles, then K2's finalize over
the (angle, tile) partials of all angles gathered in rank order, read in
place under a ``candidate_scores.SplitPlan`` (``per`` =
``blocks_per_angle``); ``finalize_rows`` folds one [R, A * tiles, 12]
buffer, an entry no path launches, kept to hold the planned folds against.

KB3 (``ndt_2d_tpu/parallel/ndt_blocks.py::match_scan_sharded_map``):
``stripe_field`` scores the lattice against one y-stripe of a sharded map
into the raw [A, L, L] field (a ``FieldPlan``'s send buffer), and
``field_match`` turns the stripes' fields, gathered in rank order into the
plan's stack, into the [13] row in one launch: the rank-ordered sum, the
reduction and the fold (``field_match_twin`` composes the three).

Each launch follows ``plan``: the threads' tile of candidates, the beams
staged at a time and the window of cell records staged a beam (from the
lattice's span in cells, ``span_cells``); ``tests/test_torch_gather_plan.py``
holds it on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ndt_2d_tpu_torch.kernels import _build
from ndt_2d_tpu_torch.kernels import candidate_scores as k2
from ndt_2d_tpu_torch.kernels.candidate_scores import MatchResult
from ndt_2d_tpu_torch.kernels.score_points import subsample
from ndt_2d_tpu_torch.ndt import grid as ndt_grid

launches = 0
# K12: launches of the split search's two entries.
partial_launches = 0
finalize_launches = 0
# KB3: launches of the stripe field and of the match of the gathered
# fields.
field_launches = 0
field_match_launches = 0

_FIELD_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_float] + [ctypes.c_int] * 3
               + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
               + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p]
               + [ctypes.c_int] + [ctypes.c_void_p] + [ctypes.c_int] * 9
               + [ctypes.c_void_p])
_FIELD_MATCH_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p]

# Threads a block of the kernel; offsets a tile of the reduction.
TILE = 256
# The thread tiles (kx dx rows x ky dy columns) the kernel is built for:
# one pass of TILE threads covers L <= 16 and 42 offsets an axis.
TILES = ((1, 1), (1, 7))
STAGE_BYTES = 24576  # one stage of a chunk's windows and entries
MAX_CHUNK = 16  # beams a chunk, at most
SMEM_LIMIT = 232448  # shared memory a block may use on an H100 (227 KB)
SMEM_STATIC = 384  # the kernel's static shared memory (reduce_tile's)


class GatherPlan(NamedTuple):
    """How K6 covers an (angle, row)'s L x L candidates: thread t = tx *
    nyg + ty (tx < nxg) of TILE takes, in pass p, the dx rows p * nxg * kx
    + tx + i * nxg (i < kx) and the dy columns ty + j * nyg (j < ky), those
    below L; ``chunk`` beams are staged at a time, each with a window of
    winx x winy cell records.  ``fused``: one block an (angle, row) runs
    its one pass and folds the scores from shared memory; else a block a
    pass writes its scores to the field (in device memory) that a second
    launch folds."""
    kx: int
    ky: int
    nxg: int
    nyg: int
    passes: int
    chunk: int
    fused: int
    winx: int
    winy: int


def stage_bytes(pl: GatherPlan, L: int) -> int:
    """One stage (csrc ``stage_bytes``): per beam its window's records (16
    + 8 bytes) and its (beam, dx) and (beam, dy) entries (8 bytes), padded
    to 16 bytes."""
    b = pl.chunk * (24 * pl.winx * pl.winy + 8 * (pl.nxg * pl.kx + L))
    return -(-b // 16) * 16


def plan_smem(pl: GatherPlan, L: int) -> int:
    """The kernel's dynamic shared memory (csrc ``smem_bytes``): two
    stages and three chunks of beams (5 words a beam, 1 a chunk); fused,
    the angle's L * L scores in the same bytes once the last chunk is
    scored."""
    return max(2 * stage_bytes(pl, L) + 12 * (5 * pl.chunk + 1),
               4 * L * L if pl.fused else 0)


@functools.lru_cache(maxsize=None)
def plan(L: int, fold: bool = True, cells: float = 0.0) -> GatherPlan:
    """The K6 launch plan for an L x L lattice spanning ``cells`` cells an
    axis ((L - 1) * resolution / cell size).  ``fold`` (a search): one
    block an (angle, row) that folds its scores - the tile of TILES with
    the fewest candidates a thread (the most threads at work) that covers
    the lattice in one pass, the least padding among equals.  Else (KB3's
    field, which nothing folds): one candidate a thread, a block a pass of
    TILE // L dx rows, so that a launch of a few angles still fills the
    card, the scores into the field.  A lattice that no tile
    covers in one pass, or whose scores do not fit in shared memory, also
    goes through the field.  A beam's window holds the cells its offsets
    reach, with a cell to spare for rounding, at most TILE cells (a thread
    stages one); a chunk with an offset outside its beam's window (a
    lattice wider than ``cells`` says), or a window that would not fit,
    gathers from the table."""
    wide = TILES[-1]
    if not 1 <= L <= TILE * wide[1]:
        raise ValueError(f"{L} offsets an axis is outside the kernel's "
                         "range")
    one = None
    if fold:
        for kx, ky in TILES:
            nxg, nyg = -(-L // kx), -(-L // ky)
            key = (kx * ky, nxg * kx * nyg * ky)
            if nxg * nyg <= TILE and (one is None or key < one[0]):
                one = (key, GatherPlan(kx, ky, nxg, nyg, 1, 1, 1, 0, 0))
    if one is not None:
        pl = one[1]
    elif L <= TILE:  # a dy column a thread
        pl = GatherPlan(1, 1, TILE // L, L, -(-L // (TILE // L)), 1, 0, 0, 0)
    else:  # more offsets than threads: the widest tile
        kx, ky = wide
        nyg = -(-L // ky)
        nxg = TILE // nyg
        pl = GatherPlan(kx, ky, nxg, nyg, -(-L // (nxg * kx)), 1, 0, 0, 0)
    xw = min(pl.nxg * pl.kx, L)
    per = max(L - 1, 1)
    winy = int(math.floor(cells)) + 3
    winx = int(math.floor(cells * (xw - 1) / per)) + 3
    if winx * winy > TILE:  # a thread stages a cell: gather instead
        winx = winy = 0
    pl = pl._replace(winx=winx, winy=winy)
    chunk = max(1, min(MAX_CHUNK, STAGE_BYTES // (stage_bytes(pl, L) or 1)))
    pl = pl._replace(chunk=chunk)
    if pl.fused and plan_smem(pl, L) > SMEM_LIMIT - SMEM_STATIC:
        return plan(L, False, cells)
    return pl


def span_cells(config, cell_size: float, L: int) -> float:
    """The span of an L-offset lattice of ``config`` in cells of
    ``cell_size``: the window ``plan`` stages a beam."""
    return (L - 1) * float(config.search_linear_resolution) / float(cell_size)


def candidate_scores_gather(config, grid: ndt_grid.NDTGrid, spts, smask,
                            pose, dths, dls, table, row0: int = 0,
                            rows=None):
    """[A, L(dx), L(dy)] candidate scores of one grid: -sum over beams of
    the clamped Gaussian of the cell each rotated, shifted beam falls in
    (0 where that cell is outside the grid, holds < 5 points or the beam
    is unused).  One beam at a time, so the [A, L, L, B] terms of the
    reference are never held and each candidate sums its beams from 0.
    With ``rows`` the table holds only the grid rows [row0, row0 + rows)
    (KB3's stripe field): a beam counts where its bin lies in them."""
    W, H = config.grid_cells_x, config.grid_cells_y if rows is None else rows
    cell = ndt_grid.f32(grid.cell_size, spts.device)
    th = pose[2] + dths
    c, s = torch.cos(th)[:, None], torch.sin(th)[:, None]
    px, py = spts[:, 0][None, :], spts[:, 1][None, :]
    rx = c * px - s * py + pose[0]                         # [A, B]
    ry = s * px + c * py + pose[1]
    rec = table[:, :8]
    A, L = dths.shape[0], dls.shape[0]
    acc = torch.zeros(A, L, L, dtype=spts.dtype, device=spts.device)
    for b in range(spts.shape[0]):
        wx = rx[:, b, None, None] + dls[None, :, None]     # [A, L, 1]
        wy = ry[:, b, None, None] + dls[None, None, :]     # [A, 1, L]
        ix = torch.floor((wx - grid.origin[0]) / cell).to(torch.int32)
        iy = (torch.floor((wy - grid.origin[1]) / cell).to(torch.int32)
              - row0)
        inb = (ix >= 0) & (iy >= 0) & (ix < W) & (iy < H)  # [A, L, L]
        flat = torch.where(
            inb, torch.clamp(iy, 0, H - 1) * W + torch.clamp(ix, 0, W - 1),
            torch.zeros_like(ix))
        r = rec[flat.to(torch.int64)]                      # [A, L, L, 8]
        qx = wx - r[..., 0]
        qy = wy - r[..., 1]
        e = -0.5 * (r[..., 2] * qx * qx + 2.0 * r[..., 3] * qx * qy
                    + r[..., 4] * qy * qy)
        pt = torch.exp(torch.clamp(e, max=0.0))
        valid = inb & (r[..., 5] > 0.5) & smask[b]
        acc = acc + torch.where(valid, pt, torch.zeros_like(pt))
    return -acc


def match_twin(config, grid: ndt_grid.NDTGrid, table, points, point_mask,
               num_points: int, pose, dths, dls):
    """Plain-PyTorch K6: (MatchResult, scores [A, L, L]).  table [C, 32],
    or [G, C, 32] with grid.origin [G, 2]."""
    spts, smask, used = subsample(points, point_mask, num_points,
                                  config.laser_max_beams)
    cand = k2.candidate_scores(config, grid, spts, smask, pose, dths, dls,
                               table, one=candidate_scores_gather)
    best, correction, k, u, s = k2.reduce_candidates(cand, dths, dls, TILE)
    return k2.finalize_match(best, correction, k, u, s, used), cand


def match_rows_twin(config, grid: ndt_grid.NDTGrid, tables, points,
                    point_mask, num_points, poses, dths, dls):
    """Plain-PyTorch K6 over a row axis, one row at a time: (MatchResult
    of [R], [R, 3], [R, 3, 3] tensors, scores [R, A, L, L])."""
    return k2.match_rows_twin(config, grid, tables, points, point_mask,
                              num_points, poses, dths, dls, match=match_twin)


def _launch(config, origin, cell_size: float, tables, points, point_mask,
            nums, num: int, poses, dths, dls, with_scores: bool):
    """One K6 launch over R rows; returns (out [R, 13], scores or None)."""
    global launches
    A, L = dths.shape[0], dls.shape[0]
    if points.shape[0] > 65535 or A > 65535:
        raise ValueError(f"{points.shape[0]} rows x {A} angles is outside "
                         "the kernel's launch range")
    pl = plan(L, True, span_cells(config, cell_size, L))
    out, scores = k2.launch_rows(
        "ndt2d_candidate_gather", A * (-(-L * L // TILE)), config, origin,
        cell_size, tables, points, point_mask, nums, num, poses, dths, dls,
        with_scores or not pl.fused, pl)
    launches += 1
    return out, scores if with_scores else None


def match_rows(config, grid: ndt_grid.NDTGrid, tables, points, point_mask,
               num_points, poses, dths, dls, with_scores: bool = False):
    """K6 over R rows in one launch; arguments and results as K2's
    ``match_rows``: grid.origin [R, (G,) 2] f32, tables [R, (G,) H*W, 32]
    f32 (K1's), points [R, P, 2] f32, point_mask [R, P] bool, num_points
    [R] int32, poses [R, 3] f32 (a device tensor: the coarse-to-fine chain
    never reads it back), dths [A] / dls [L] f32.  Returns the [R, 13]
    output rows, or (rows, scores [R, A, L, L]) with ``with_scores``.  CPU
    tensors run the twin; CUDA tensors launch the kernel."""
    if points.device.type == "cpu":
        res, cand = match_rows_twin(config, grid, tables, points, point_mask,
                                    num_points, poses, dths, dls)
        return (k2.pack(res), cand) if with_scores else k2.pack(res)
    out, scores = _launch(config, grid.origin, grid.cell_size, tables,
                          points, point_mask, num_points, 0, poses, dths,
                          dls, with_scores)
    return (out, scores) if with_scores else out


def match(config, grid: ndt_grid.NDTGrid, table, points, point_mask,
          num_points: int, pose, dths, dls, with_scores: bool = False):
    """K6 of one scan: ``match_rows``' launch at R = 1 (arguments as K2's
    ``match``).  Returns its [1, 13] output row, or (row, scores
    [A, L, L]) with ``with_scores``.  CPU tensors run the twin; CUDA
    tensors launch the kernel."""
    if points.device.type == "cpu":
        res, cand = match_twin(config, grid, table, points, point_mask,
                               num_points, pose, dths, dls)
        out = k2.pack(MatchResult(*[x[None] for x in res]))
        return (out, cand) if with_scores else out
    out, scores = _launch(config, grid.origin[None], grid.cell_size,
                          table[None], points[None], point_mask[None], None,
                          num_points, pose[None], dths, dls, with_scores)
    return (out, scores[0]) if with_scores else out


# --- K12: the split search of a device mesh -------------------------------
def blocks_per_angle(dls) -> int:
    """Partials an angle: one per tile of TILE offsets."""
    return -(-dls.shape[0] ** 2 // TILE)


def partial_rows(config, grid: ndt_grid.NDTGrid, tables, points, point_mask,
                 num_points, poses, dths, dls, a0: int, n: int, out=None):
    """K12's first half on K6: the (angle, tile) partials [R, n * tiles,
    12] of angles a0 .. a0 + n - 1 (one rank's block), flat indices global,
    written into ``out`` when given (a split plan's send buffer,
    ``SplitPlan.head``); arguments as K2's ``partial_rows``.  CPU tensors
    run the twin; CUDA tensors launch the kernel."""
    global partial_launches
    if points.device.type == "cpu":
        rows = k2.partial_rows_twin(config, grid, tables, points, point_mask,
                                    num_points, poses, dths, dls, a0, n,
                                    TILE, candidate_scores_gather)
        return rows if out is None else out.copy_(rows)
    L = dls.shape[0]
    pl = plan(L, True, span_cells(config, grid.cell_size, L))
    out = k2.launch_partials("ndt2d_candidate_gather_partials", config,
                             grid.origin, grid.cell_size, tables, points,
                             point_mask, num_points, poses, dths, dls, a0, n,
                             blocks_per_angle(dls), pl, not pl.fused,
                             out=out)
    partial_launches += 1
    return out


def finalize_rows(config, partials, num_points, dths, dls):
    """K2's finalize launch on K6's partials, unplanned: [R, 13] from the
    partials [R, A * tiles, 12] of every angle in (angle, tile) order
    (16-byte aligned).  Bitwise the one-launch ``match_rows``.  No path of
    the package launches it: a split search folds its gathered stack in
    place (``candidate_scores.SplitPlan`` at ``per`` =
    ``blocks_per_angle``) and KB3's match folds in its own launch
    (``field_match``).  It stays as the plain entry of the fold that the
    planned fold and ``field_match`` are held bitwise against on the card.
    CPU tensors run the twin; CUDA tensors launch the kernel."""
    global finalize_launches
    if partials.device.type == "cpu":
        return k2.finalize_rows_twin(config, partials, num_points, dths, dls)
    out = k2.launch_finalize("ndt2d_candidate_gather_finalize", config,
                             partials, num_points, dths, dls,
                             blocks_per_angle(dls))
    finalize_launches += 1
    return out


# --- KB3: the lattice against one y-stripe of a sharded map ---------------
def stripe_field_twin(config, stripe: ndt_grid.NDTGrid, table, row0: int,
                      rows: int, points, point_mask, num_points: int, pose,
                      dths, dls):
    """Plain-PyTorch KB3 field: [A, L, L], each candidate's -sum over the
    subsampled beams whose global bin lies in the stripe's rows."""
    spts, smask, _ = subsample(points, point_mask, num_points,
                               config.laser_max_beams)
    return candidate_scores_gather(config, stripe, spts, smask, pose, dths,
                                   dls, table, row0, rows)


def stripe_field(config, stripe: ndt_grid.NDTGrid, table, row0: int,
                 rows: int, points, point_mask, num_points: int, pose, dths,
                 dls, out=None):
    """KB3: the raw [A, L, L] candidate field of one scan against the
    stripe of grid rows [row0, row0 + rows) (``stripe`` and ``table``
    [rows * W, 32] KB1's, origin the map's), K6's per-candidate gather with
    only the stripe's beams counted, written into ``out`` [A, L, L] when
    given (a ``FieldPlan``'s send buffer).  points [P, 2] f32, point_mask
    [P] bool, pose [3] f32, dths [A] / dls [L] f32.  CPU tensors run the
    twin; CUDA tensors launch the kernel."""
    global field_launches
    dev = points.device
    A, L = dths.shape[0], dls.shape[0]
    if out is not None:
        _build.require(out, "out", torch.float32, (A, L, L), dev)
    if dev.type == "cpu":
        field = stripe_field_twin(config, stripe, table, row0, rows, points,
                                  point_mask, num_points, pose, dths, dls)
        return field if out is None else out.copy_(field)
    W, P = config.grid_cells_x, points.shape[0]
    if A > 65535:
        raise ValueError(f"{A} angles is outside the kernel's launch range")
    _build.require(table, "table", torch.float32, (rows * W, 32), dev)
    _build.require(stripe.origin, "origin", torch.float32, (2,), dev)
    _build.require(points, "points", torch.float32, (P, 2), dev)
    _build.require(point_mask, "point_mask", torch.bool, (P,), dev)
    _build.require(pose, "pose", torch.float32, (3,), dev)
    _build.require(dths, "dths", torch.float32, (A,), dev)
    _build.require(dls, "dls", torch.float32, (L,), dev)
    field = (torch.empty(A, L, L, dtype=torch.float32, device=dev)
             if out is None else out)
    p = _build.ptr
    err = _build.function("ndt2d_stripe_field", _FIELD_ARGS)(
        p(table), p(stripe.origin), float(stripe.cell_size), W, int(row0),
        int(rows), p(points), p(point_mask), P, int(num_points),
        int(config.laser_max_beams), p(pose), p(dths), A, p(dls), L,
        p(field), *plan(L, False, span_cells(config, stripe.cell_size, L)),
        _build.stream_ptr(dev))
    _build.check(err, "stripe_field")
    field_launches += 1
    return field




# --- KB3: the match of the stripes' gathered fields -----------------------
def field_match_twin(config, gathered, num_points: int, dths, dls):
    """Plain-PyTorch ``field_match``: [13] from the stripes' fields
    ``gathered`` [S, A * L * L] (any view of S rows), composed of the three
    steps the launch folds: the rows added in rank order from row 0's
    (``shard_combine.rank_sum_twin``), the reduction's (angle, tile)
    partials (``candidate_scores.block_partials`` at ``TILE``) and K2's
    fold (``finalize_rows_twin``)."""
    A, L = dths.shape[0], dls.shape[0]
    rows = gathered.reshape(-1, A, L, L)
    total = rows[0].clone()
    for r in range(1, rows.shape[0]):
        total = total + rows[r]
    partials = k2.block_partials(total, dths, dls, 0, TILE)
    return k2.finalize_rows_twin(config, partials[None], num_points, dths,
                                 dls)[0]


class _FieldMatch(ctypes.Structure):
    """``struct FieldMatch`` (``csrc/candidate_gather.cu``)."""

    _fields_ = ([(f, ctypes.c_void_p) for f in ("stack", "dths", "dls",
                                                "partial", "ticket")]
                + [(f, ctypes.c_int) for f in ("S", "A", "L", "max_beams")])


class FieldPlan:
    """KB3's match on one rank of a ``space`` line of S ranks, planned once
    for (device, S, A, L) (``field_plan``): the rank's send buffer ``send``
    [A, L, L], which ``stripe_field(..., out=send)`` writes, the stack
    ``stack`` [S, A * L * L], which the all-gather writes
    (``distributed.gather(send, group, out=stack.view(S, A, L, L))``; on a
    group of one rank the send buffer is the stack), the partials' scratch
    and the ticket (zeroed once; the launch's last block resets it), and
    the launch's arguments packed once into a ``_FieldMatch`` block, the
    lattice and ``max_beams`` packed again when they change.  A match is
    one ctypes call (``field_match``); it allocates only its [13] row.
    Every launch of a plan's buffers runs on the current stream, in the
    order the calls enqueue them."""

    def __init__(self, device, shards: int, A: int, L: int):
        if shards < 1 or A < 1 or L < 1 or A > 65535 \
                or shards * A * L * L >= 2 ** 31:
            raise ValueError(f"a match of {A}x{L}x{L} candidates over "
                             f"{shards} stripes is outside the kernel's "
                             "range")
        self.device = torch.device(device)
        self.eager = self.device.type == "cpu"
        self.shards, self.A, self.L = shards, A, L
        f32 = torch.float32
        self.send = torch.empty(A, L, L, dtype=f32, device=self.device)
        n = A * L * L
        self.stack = (self.send.view(1, n) if shards == 1 else
                      torch.empty(shards, n, dtype=f32, device=self.device))
        tiles = -(-L * L // TILE)
        self._partial = torch.empty(A * tiles, k2._PARTIAL, dtype=f32,
                                    device=self.device)
        self._ticket = torch.zeros(1, dtype=torch.int32, device=self.device)
        self._expect = (("dths", f32, (A,)), ("dls", f32, (L,)))
        self._args = _FieldMatch(self.stack.data_ptr(), None, None,
                                 self._partial.data_ptr(),
                                 self._ticket.data_ptr(), shards, A, L, 0)
        self.address = ctypes.addressof(self._args)
        self._lattice = (None, None, None)  # (dths, dls, max_beams) packed

    def check(self, gathered, dths, dls) -> None:
        """Raise unless ``gathered`` is this plan's stack (any view of it)
        and the lattice has the plan's shape on its device."""
        if (gathered.data_ptr() != self.stack.data_ptr()
                or gathered.numel() != self.stack.numel()
                or not gathered.is_contiguous()):
            raise ValueError("gathered: not this plan's stack")
        _build.require_all(self.device, (dths, dls), self._expect)

    def pack(self, dths, dls, max_beams: int) -> None:
        """The lattice and ``max_beams`` into the launch's block, where
        they changed (the matcher's lattice is cached)."""
        last = self._lattice
        if dths is last[0] and dls is last[1] and max_beams == last[2]:
            return
        self._args.dths, self._args.dls = dths.data_ptr(), dls.data_ptr()
        self._args.max_beams = max_beams
        self._lattice = (dths, dls, max_beams)


_FIELD_PLANS: dict = {}


def field_plan(device, shards: int, A: int, L: int) -> FieldPlan:
    """The kept ``FieldPlan`` of this key, made at its first use."""
    key = (torch.device(device), shards, A, L)
    plan = _FIELD_PLANS.get(key)
    if plan is None:
        plan = _FIELD_PLANS[key] = FieldPlan(device, shards, A, L)
    return plan


@functools.lru_cache(maxsize=None)
def _field_match_function():
    """``ndt2d_field_match``, after checking that ``_FieldMatch`` has the C
    block's size."""
    theirs = _build.function("ndt2d_field_match_plan_size", [])()
    if ctypes.sizeof(_FieldMatch) != theirs:
        raise RuntimeError(f"FieldMatch of {ctypes.sizeof(_FieldMatch)} "
                           f"bytes, the kernels' {theirs}")
    return _build.function("ndt2d_field_match", _FIELD_MATCH_ARGS)


def field_match(config, plan: FieldPlan, gathered, num_points: int, dths,
                dls):
    """KB3's match: the [13] row (score, correction, covariance) of the
    stripes' fields ``gathered``, the plan's stack after the all-gather,
    read in place: the fields added in rank order, reduced and folded in
    one launch (``ndt2d_field_match``), bitwise the rank-ordered sum, the
    reduction and K2's fold of the sum.  Raises on a buffer that is not
    the plan's.  CPU tensors run ``field_match_twin``; CUDA tensors launch
    the kernel."""
    global field_match_launches
    plan.check(gathered, dths, dls)
    if plan.eager:
        return field_match_twin(config, gathered, int(num_points), dths, dls)
    plan.pack(dths, dls, int(config.laser_max_beams))
    out = torch.empty(13, dtype=torch.float32, device=plan.device)
    _build.check(_field_match_function()(
        plan.address, int(num_points), out.data_ptr(),
        _build.stream_ptr(plan.device)), "field_match")
    field_match_launches += 1
    return out
