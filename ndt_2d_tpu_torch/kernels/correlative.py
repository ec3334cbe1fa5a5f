"""K11: the correlative matcher's field build, lattice search and point
score (CUDA ``csrc/correlative.cu``) and their plain-PyTorch twins.

Replaces ``ndt_2d_tpu/matching/correlative.py``'s ``build_field`` (:38),
``match_scan_field`` (:76) and ``score_points_field`` (:108).  The field is
a blurred hit count of the window's points, normalized to a peak of 1; a
candidate pose scores minus the field values under its subsampled beams.
The field is one launch of a thread-block cluster whose CTAs each hold a
stripe of rows in shared memory (``field_plan``; the seven-step form
through device memory where the stripes do not fit 16 CTAs).

The lattice search has K6's interface (``kernels/candidate_gather.py``):
``match_rows`` over R rows, ``match`` at R = 1, both returning the [R, 13]
output rows ``candidate_scores.unpack`` reads, reduced by K6's tiles.  It
is one launch (``lattice_tables``): a block scores ``lattice_plan``'s run
of 256-offset tiles of one (angle, row) from per-beam tables of cell
columns and row offsets it computes once (``beam_tables``), and the row's
last block folds the row's partials; a shape's launch is a
``LatticeLauncher`` (its argument block packed once, one ctypes call a
search).  With ``with_unc`` the same launch
also writes each row's point score at its pose (one more block a row, a
warp of which runs the point score's body): a matched scan is two device
operations, the field and the lattice.  The twins add in the kernels'
orders (the blur's 7 taps in index order, each candidate's beams
from 0 and the Olson sums per 256-offset tile, each pose's beams lane by
lane then halving), so on the same CUDA inputs kernel and twin agree
bitwise; ``lattice_scores_tables`` (the tables, then the beams) is bitwise
``lattice_scores`` (a division a term).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch

from ndt_2d_tpu_torch.core import pose as pose_ops
from ndt_2d_tpu_torch.kernels import _build
from ndt_2d_tpu_torch.kernels import candidate_scores as k2
from ndt_2d_tpu_torch.kernels.candidate_gather import TILE
from ndt_2d_tpu_torch.kernels.candidate_scores import MatchResult
from ndt_2d_tpu_torch.kernels.ndt_build import window_origin
from ndt_2d_tpu_torch.kernels.score_points import lane_tree_sum, subsample
from ndt_2d_tpu_torch.ndt.grid import f32

field_launches = 0
match_launches = 0
score_launches = 0

RADIUS = 3  # blur taps: sigma 1 cell, 2 * RADIUS + 1 of them
# The index tables' sentinel (kOff of csrc/correlative.cu): a column or row
# offset off the grid, or an unused beam's column.
OFF = -(1 << 30)
# A lattice block's (threads, tiles a thread) in the order the plan tries
# them for one wave of blocks, then the tiles a thread of a block of 256
# may take (together the kernel's instantiations, SHAPES); the 4-byte words
# of shared memory a block may hold (48 KB, static and dynamic together;
# ``static_words`` is the static part), the words a beam of a table
# chunk takes beside its tables and window (kBeamWords of
# csrc/correlative.cu), the most words a beam's field window may take, the
# words of a partial (lattice.cuh's kPartial) and the fewest partials the
# fold stages at a time (its kStage).
WAVE_SHAPES = ((256, 1), (512, 1), (1024, 1), (1024, 2))
PER_CHOICES = (8, 4, 2, 1)
SHAPES = WAVE_SHAPES + tuple((256, p) for p in PER_CHOICES if p > 1)
TABLE_WORDS = 12 * 1024
BEAM_WORDS = 6
WINDOW_WORDS = 64
PARTIAL_WORDS = 12
FOLD_STAGE = 256


@functools.lru_cache(maxsize=4)
def blur_taps(device: torch.device) -> torch.Tensor:
    """The normalized Gaussian taps exp(-x^2 / 2) / sum, x = -3 .. 3,
    computed once per device by torch (correlative.py:57-60)."""
    x = torch.arange(-RADIUS, RADIUS + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * x * x)
    return k / torch.sum(k)


def cell_ids(poses, points, point_mask, window_mask, origin, cell_size,
             width: int, height: int):
    """The flat cell id of every window point that lands in the grid
    ([N] int64), in point order."""
    world = pose_ops.transform_points(poses, points).reshape(-1, 2)
    mask = (point_mask & window_mask[:, None]).reshape(-1)
    cell = f32(cell_size, poses.device)
    ix = torch.floor((world[:, 0] - origin[0]) / cell).to(torch.int64)
    iy = torch.floor((world[:, 1] - origin[1]) / cell).to(torch.int64)
    ok = mask & (ix >= 0) & (iy >= 0) & (ix < width) & (iy < height)
    return (iy * width + ix)[ok]


def _blur(plane, taps, dim: int):
    """One blur pass along ``dim`` of [H, W]: the 7 taps added in index
    order from 0, zero past the edges."""
    n = plane.shape[dim]
    pad = [0, 0, 0, 0]
    pad[2 * (1 - dim)] = pad[2 * (1 - dim) + 1] = RADIUS
    padded = torch.nn.functional.pad(plane, pad)
    acc = torch.zeros_like(plane)
    for k in range(2 * RADIUS + 1):
        acc = acc + taps[k] * padded.narrow(dim, k, n)
    return acc


def build_field_twin(poses, points, point_mask, window_mask,
                     range_max: float, cell_size: float, width: int,
                     height: int):
    """Plain-PyTorch build: (field [H, W] f32, origin [2])."""
    origin = window_origin(poses, window_mask, range_max)
    ids = cell_ids(poses, points, point_mask, window_mask, origin, cell_size,
                   width, height)
    hits = torch.bincount(ids, minlength=width * height).reshape(
        height, width).to(torch.float32)
    taps = blur_taps(poses.device)
    f = _blur(_blur(hits, taps, 1), taps, 0)
    peak = torch.maximum(torch.max(f), f32(1e-6, poses.device))
    return f / peak, origin


@dataclasses.dataclass(frozen=True)
class FieldPlan:
    """How one grid shape's field is built (``field_plan``): ``n`` CTAs of
    ``threads`` in one thread-block cluster, CTA k holding rows [k h, k h +
    h) of the [height, width] plane in ``smem`` dynamic bytes of shared
    memory (with the RADIUS rows above and below); ``n`` = 0 is the
    seven-step form (a memset and six launches through device memory)."""
    width: int
    height: int
    n: int
    h: int
    threads: int
    smem: int

    @property
    def cluster(self) -> bool:
        return self.n > 0


# The cluster form's CTA (kFieldThreads of csrc/correlative.cu), the
# cluster sizes Hopper launches (8 portable, 16 with the non-portable
# attribute), and the dynamic shared memory a CTA may take: the H100's 227
# KB opt-in, less 1 KB for the kernel's static part.  The plan takes the
# largest cluster: every CTA transforms every window point whatever n is,
# and more CTAs share the blurs (PERF.md: the device time by n).
FIELD_THREADS = 1024
FIELD_PORTABLE = 8
FIELD_POINTS = 1 << 23  # a cell's count converts exactly below 2^23
FIELD_CLUSTER_MAX = 16
FIELD_SHARED = 232448 - 1024


def field_shared(width: int, h: int, scans: int = 0) -> int:
    """Dynamic shared bytes of a stripe of ``h`` rows: each window scan's
    pose, cos and sin (16 bytes) and flag (4, the flags padded to 16
    bytes), then the int hit window and the x-blurred float window, the
    stripe and the RADIUS rows above and below it, 4 bytes a cell each."""
    return 16 * scans + 16 * -(-scans // 4) + 8 * (h + 2 * RADIUS) * width


def field_stripes(width: int, height: int, n: int,
                  scans: int = 0) -> Optional[FieldPlan]:
    """The cluster form of ``n`` CTAs: stripes of h = ceil(height / n)
    rows, n then cut to ceil(height / h) so that no CTA is empty; None
    where the stripes do not fit ``FIELD_SHARED`` or n is outside 1 ..
    ``FIELD_CLUSTER_MAX``."""
    if not 1 <= n <= FIELD_CLUSTER_MAX:
        return None
    h = -(-height // n)
    smem = field_shared(width, h, scans)
    if smem > FIELD_SHARED:
        return None
    return FieldPlan(width, height, -(-height // h), h, FIELD_THREADS, smem)


def field_plan(width: int, height: int, sms: int = 132, scans: int = 0,
               points: int = 0) -> FieldPlan:
    """The build of a [height, width] field from a window of ``scans``
    scans and ``points`` points in all: one cluster of min(16, sms,
    height) CTAs (``field_stripes``); the seven-step form where those
    stripes do not fit or the window holds ``FIELD_POINTS`` points or
    more."""
    if width < 1 or height < 1:
        raise ValueError(f"field of {width} x {height} cells")
    plan = (field_stripes(width, height,
                          min(FIELD_CLUSTER_MAX, sms, height), scans)
            if points < FIELD_POINTS else None)
    return plan or FieldPlan(width, height, 0, 0, 0, 0)


class _FieldLaunch(ctypes.Structure):
    """One field build (``csrc/correlative.cu::FieldLaunch``): the tensors'
    pointers, the shape and the plan."""
    _fields_ = ([(f, ctypes.c_void_p) for f in
                 ("poses", "points", "pmask", "wmask", "taps", "origin",
                  "field", "hits", "tmp", "peak")]
                + [(f, ctypes.c_int) for f in
                   ("S", "P", "W", "H", "n", "h", "threads", "smem")]
                + [("range_max", ctypes.c_float), ("cell", ctypes.c_float)])


class FieldLauncher:
    """One build shape's launch: its ``_FieldLaunch`` block packed once
    (the plan, the shape, the taps), the C function bound once and the
    stream reader.  ``run`` checks the window's tensors in one pass,
    allocates origin and field (callers keep both: the matcher across
    matches, a comparison two builds), in the seven-step form its scratch
    too, writes the pointers and makes one ctypes call.  The cluster
    form's plan is readied on the card (``clusters``) at the first run."""

    def __init__(self, plan: FieldPlan, S: int, P: int, range_max: float,
                 cell_size: float, dev):
        self.plan, self.device = plan, dev
        self.taps = blur_taps(dev)  # kept: the block holds its address
        self.launch = _FieldLaunch(
            taps=self.taps.data_ptr(), S=S, P=P, W=plan.width,
            H=plan.height, n=plan.n, h=plan.h, threads=plan.threads,
            smem=plan.smem, range_max=range_max, cell=cell_size)
        self.address = ctypes.addressof(self.launch)
        f32 = torch.float32
        self.expect = (("poses", f32, (S, 3)), ("points", f32, (S, P, 2)),
                       ("point_mask", torch.bool, (S, P)),
                       ("window_mask", torch.bool, (S,)))
        self._fn = None
        self._stream = None

    def clusters(self) -> int:
        """Readies the cluster form's kernel for this plan and returns how
        many such clusters the card holds at once (0: none)."""
        size = _build.function("ndt2d_correlative_field_launch_size", [])()
        if size != ctypes.sizeof(_FieldLaunch):
            raise RuntimeError(f"FieldLaunch is {size} bytes in C, "
                               f"{ctypes.sizeof(_FieldLaunch)} here")
        count = ctypes.c_int(0)
        _build.check(_build.function(
            "ndt2d_correlative_field_setup",
            [ctypes.c_void_p, ctypes.c_void_p])(
                self.address, ctypes.addressof(count)),
            "correlative_field setup")
        return count.value

    def run(self, poses, points, point_mask, window_mask):
        global field_launches
        _build.require_all(self.device,
                           (poses, points, point_mask, window_mask),
                           self.expect)
        if points.data_ptr() % 8:
            raise ValueError("points: must start 8-byte aligned")
        if self.plan.cluster and points.shape[0] * points.shape[1] \
                >= FIELD_POINTS:
            raise ValueError(f"{tuple(points.shape[:2])} points: the "
                             "cluster form counts fewer than 2^23")
        if self._fn is None:
            if self.plan.cluster and self.clusters() < 1:
                raise RuntimeError(f"{self.plan}: the card holds no such "
                                   "cluster")
            self._fn = _build.function("ndt2d_correlative_field_planned",
                                       [ctypes.c_void_p, ctypes.c_void_p])
            self._stream = _build.stream_reader(self.device)
        L = self.launch
        origin = poses.new_empty(2)
        field = poses.new_empty(self.plan.height, self.plan.width)
        L.poses, L.points = poses.data_ptr(), points.data_ptr()
        L.pmask, L.wmask = point_mask.data_ptr(), window_mask.data_ptr()
        L.origin, L.field = origin.data_ptr(), field.data_ptr()
        if not self.plan.cluster:
            C = self.plan.width * self.plan.height
            hits = torch.empty(C, dtype=torch.int32, device=self.device)
            tmp, peak = poses.new_empty(C), poses.new_empty(1)
            L.hits, L.tmp, L.peak = (hits.data_ptr(), tmp.data_ptr(),
                                     peak.data_ptr())
        _build.check(self._fn(self.address, self._stream()),
                     "correlative_field")
        field_launches += 1
        return field, origin


_FIELD_LAUNCHERS: dict = {}


def field_launcher(S: int, P: int, range_max: float, cell_size: float,
                   width: int, height: int, dev) -> FieldLauncher:
    """The launcher of this build shape, made at its first build: the plan
    is ``field_plan``'s on the card's SMs, with the portable cluster of
    ``FIELD_PORTABLE`` (or the seven-step form) where the card holds no
    larger one."""
    key = (S, P, float(range_max), float(cell_size), width, height, dev)
    launcher = _FIELD_LAUNCHERS.get(key)
    if launcher is None:
        args = (S, P, float(range_max), float(cell_size), dev)
        sms = _build.sm_count(dev.index if dev.index is not None
                              else torch.cuda.current_device())
        launcher = FieldLauncher(field_plan(width, height, sms, S, S * P),
                                 *args)
        if launcher.plan.n > FIELD_PORTABLE and launcher.clusters() < 1:
            plan = field_stripes(width, height,
                                 min(FIELD_PORTABLE, sms, height), S)
            launcher = FieldLauncher(
                plan or FieldPlan(width, height, 0, 0, 0, 0), *args)
        _FIELD_LAUNCHERS[key] = launcher
    return launcher


def build_field(poses, points, point_mask, window_mask, range_max: float,
                cell_size: float, width: int, height: int):
    """The window's blurred, normalized hit field and its origin.  poses
    [S, 3] f32, points [S, P, 2] f32, point_mask [S, P] bool, window_mask
    [S] bool.  Returns (field [H, W] f32, origin [2] f32).  CPU tensors run
    the twin; CUDA tensors launch the kernel in ``field_launcher``'s
    form."""
    if poses.device.type == "cpu":
        return build_field_twin(poses, points, point_mask, window_mask,
                                range_max, cell_size, width, height)
    S, P = points.shape[0], points.shape[1]
    return field_launcher(S, P, range_max, cell_size, width, height,
                          poses.device).run(poses, points, point_mask,
                                            window_mask)


def lattice_scores(config, field, origin, spts, smask, pose, dths, dls):
    """[A, L(dx), L(dy)] candidate scores: minus the sum over the beams of
    the field value of the cell each rotated, shifted beam falls in (0
    outside the grid or for an unused beam), one beam at a time from 0."""
    W, H = config.grid_cells_x, config.grid_cells_y
    cell = f32(config.ndt_resolution, spts.device)
    th = pose[2] + dths
    c, s = torch.cos(th)[:, None], torch.sin(th)[:, None]
    px, py = spts[:, 0][None, :], spts[:, 1][None, :]
    rx = c * px - s * py + pose[0]                         # [A, B]
    ry = s * px + c * py + pose[1]
    flat_field = field.reshape(-1)
    A, L = dths.shape[0], dls.shape[0]
    acc = torch.zeros(A, L, L, dtype=spts.dtype, device=spts.device)
    for b in range(spts.shape[0]):
        wx = rx[:, b, None, None] + dls[None, :, None]     # [A, L, 1]
        wy = ry[:, b, None, None] + dls[None, None, :]     # [A, 1, L]
        ix = torch.floor((wx - origin[0]) / cell).to(torch.int64)
        iy = torch.floor((wy - origin[1]) / cell).to(torch.int64)
        inb = (ix >= 0) & (iy >= 0) & (ix < W) & (iy < H)  # [A, L, L]
        flat = torch.where(inb, iy * W + ix, torch.zeros_like(ix))
        valid = inb & smask[b]
        acc = acc + torch.where(valid, flat_field[flat],
                                torch.zeros((), device=spts.device))
    return -acc


def beam_tables(config, origin, spts, smask, pose, dths, dls):
    """The lattice kernel's per-angle tables: (xs, ys) [A, B, L] int64,
    xs[a, b, i] the cell column of beam b at angle a shifted by dls[i] and
    ys[a, b, i] its row offset iy W at dls[i], each ``OFF`` off the grid
    (xs also for an unused beam), in ``lattice_scores``' expressions."""
    W, H = config.grid_cells_x, config.grid_cells_y
    cell = f32(config.ndt_resolution, spts.device)
    th = pose[2] + dths
    c, s = torch.cos(th)[:, None], torch.sin(th)[:, None]
    px, py = spts[:, 0][None, :], spts[:, 1][None, :]
    rx = c * px - s * py + pose[0]                         # [A, B]
    ry = s * px + c * py + pose[1]
    ix = torch.floor((rx[:, :, None] + dls - origin[0]) / cell).to(
        torch.int64)
    iy = torch.floor((ry[:, :, None] + dls - origin[1]) / cell).to(
        torch.int64)
    off = torch.full((), OFF, dtype=torch.int64, device=spts.device)
    xs = torch.where(smask[None, :, None] & (ix >= 0) & (ix < W), ix, off)
    ys = torch.where((iy >= 0) & (iy < H), iy * W, off)
    return xs, ys


def lattice_scores_tables(config, field, origin, spts, smask, pose, dths,
                          dls):
    """``lattice_scores`` as the kernel forms it: the tables of
    ``beam_tables``, then for each beam in order from 0 the field value at
    column + row offset (0 where either is a sentinel).  Bitwise
    ``lattice_scores``."""
    xs, ys = beam_tables(config, origin, spts, smask, pose, dths, dls)
    flat_field = field.reshape(-1)
    A, L = dths.shape[0], dls.shape[0]
    zero = torch.zeros((), dtype=spts.dtype, device=spts.device)
    acc = torch.zeros(A, L, L, dtype=spts.dtype, device=spts.device)
    for b in range(spts.shape[0]):
        cell = xs[:, b, :, None] + ys[:, b, None, :]      # [A, L, L]
        acc = acc + torch.where(cell >= 0,
                                flat_field[torch.clamp(cell, min=0)], zero)
    return -acc


@dataclasses.dataclass(frozen=True)
class LatticePlan:
    """A lattice launch's shape: blocks of ``threads`` (groups of 256, a
    candidate of a tile of 256 flat offsets a thread), ``per`` tiles a
    thread (``groups`` blocks an angle of ``tiles``), the column table's rows
    ``nx`` (the most dx values a block's offsets span), a beam's field
    window of ``cx`` x ``cy`` cells, ``chunk`` beams a table chunk (a
    multiple of 4; the tables' row ``stride``, 4 mod 32), the partials the
    fold stages at a time and the block's dynamic shared memory in bytes.
    """

    threads: int
    per: int
    tiles: int
    groups: int
    nx: int
    cx: int
    cy: int
    chunk: int
    stride: int
    stage: int
    smem: int


@functools.lru_cache(maxsize=64)
def lattice_plan(A: int, L: int, R: int, max_beams: int, sms: int,
                 step_cells: float = 0.0, score: bool = False) -> LatticePlan:
    """The lattice launch's shape: the first of ``WAVE_SHAPES`` whose blocks
    fit one wave (one block an SM), else blocks of 256 with the most tiles a
    thread (of ``PER_CHOICES``, at most the next power of two of an angle's
    tiles) that still gives ``2 sms`` blocks, else one (with ``score``, each
    row's point-score block counts among the blocks); a beam's field
    window of
    the cells its offsets span, ``step_cells`` (the offsets' step over the
    cell size) apart (floor(span) + 2 a side: a beam whose cells do not fit
    reads the field itself; none at all past ``WINDOW_WORDS``); the tables
    and windows of as many beams as fit ``TABLE_WORDS`` words beside the
    block's ``static_words``.  The shape changes which block forms a
    partial, never a bit."""
    LL = L * L
    tiles = -(-LL // TILE)
    extra = int(score)  # the point score's block a row
    shape = next((sh for sh in WAVE_SHAPES
                  if R * (A * -(-tiles // (sh[0] // TILE * sh[1])) + extra)
                  <= sms), None)
    if shape is None:
        shape = (TILE, 1)
        for p in PER_CHOICES:
            if p < 2 * tiles and R * (A * -(-tiles // p) + extra) >= 2 * sms:
                shape = (TILE, p)
                break
    threads, per = shape
    span = threads // TILE * per  # tiles a block
    groups = -(-tiles // span)
    nx = 0
    for j in range(groups):
        f0, f1 = j * span * TILE, min((j + 1) * span * TILE, LL)
        nx = max(nx, (f1 - 1) // L - f0 // L + 1)
    cx = int(math.floor((nx - 1) * step_cells)) + 2
    cy = int(math.floor((L - 1) * step_cells)) + 2
    if (cx + 1) * (cy + 1) > WINDOW_WORDS:
        cx = cy = 0
    rows = nx + L + (cx + 1) * (cy + 1)  # table rows of a beam each
    budget = TABLE_WORDS - static_words(threads)
    chunk = -(-max(max_beams, 1) // 4) * 4
    while chunk >= 4 and (BEAM_WORDS * chunk + rows * stride_of(chunk)
                          > budget):
        chunk -= 4
    if chunk < 4 or max_beams < 1:
        raise ValueError(f"a lattice of {L} offsets a side or {max_beams} "
                         "beams is outside the kernel's tables")
    stride = stride_of(chunk)
    words = BEAM_WORDS * chunk + rows * stride
    # The fold stages every partial of a row where they fit the block's
    # shared memory (and one partial more), else as many as fit, at least
    # FOLD_STAGE.
    stage = min(A * tiles, max(words // PARTIAL_WORDS - 1, FOLD_STAGE))
    fold = PARTIAL_WORDS * (stage + 1)
    return LatticePlan(threads, per, tiles, groups, nx, cx, cy, chunk,
                       stride, stage, 4 * max(words, fold))


def static_words(threads: int) -> int:
    """A lattice block's static shared memory in 4-byte words: the warp
    sums of ``lattice.cuh::reduce_tiles`` (a partial a warp) and the fold's
    flag, rounded up to 16 bytes.  The C entry refuses a launch whose
    dynamic and static shared memory together pass 48 KB."""
    return threads // 32 * PARTIAL_WORDS + 4


def stride_of(chunk: int) -> int:
    """The tables' row stride for ``chunk`` beams: the least >= chunk
    that is 4 mod 32."""
    return chunk + (4 - chunk) % 32


# The lattice launch's tickets, [R] uint32 a (device, stream), zeroed once
# (each launch leaves them 0).
_TICKETS: dict = {}


def _tickets(dev, stream: int, R: int) -> torch.Tensor:
    key = (dev.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < R:
        t = torch.zeros(max(R, 64), dtype=torch.int32, device=dev)
        _TICKETS[key] = t
    return t


def match_twin(config, field, origin, points, point_mask, num_points: int,
               pose, dths, dls):
    """Plain-PyTorch lattice search of one scan: (MatchResult, scores
    [A, L, L])."""
    spts, smask, used = subsample(points, point_mask, num_points,
                                  config.laser_max_beams)
    cand = lattice_scores_tables(config, field, origin, spts, smask, pose,
                                 dths, dls)
    best, correction, k, u, s = k2.reduce_candidates(cand, dths, dls, TILE)
    return k2.finalize_match(best, correction, k, u, s, used), cand


def match_rows_twin(config, fields, origins, points, point_mask, num_points,
                    poses, dths, dls):
    """Plain-PyTorch search over a row axis, one row at a time: (MatchResult
    of [R], [R, 3], [R, 3, 3] tensors, scores [R, A, L, L])."""
    res, cand = [], []
    for r in range(points.shape[0]):
        m, c = match_twin(config, fields[r], origins[r], points[r],
                          point_mask[r], int(num_points[r]), poses[r], dths,
                          dls)
        res.append(m)
        cand.append(c)
    return (MatchResult(*[torch.stack([getattr(m, f) for m in res])
                          for f in MatchResult._fields]),
            torch.stack(cand))


class _LatticeTables(ctypes.Structure):
    """The lattice kernel's arguments (``csrc/correlative.cu::
    LatticeTables``, field for field)."""
    _fields_ = ([("field", ctypes.c_void_p), ("origin", ctypes.c_void_p),
                 ("cell", ctypes.c_float), ("W", ctypes.c_int),
                 ("H", ctypes.c_int), ("points", ctypes.c_void_p),
                 ("pmask", ctypes.c_void_p), ("P", ctypes.c_int),
                 ("nums", ctypes.c_void_p), ("num", ctypes.c_int),
                 ("max_beams", ctypes.c_int), ("pose", ctypes.c_void_p),
                 ("dths", ctypes.c_void_p), ("dls", ctypes.c_void_p)]
                + [(f, ctypes.c_int) for f in
                   ("A", "L", "tiles", "groups", "nx", "cx", "cy", "chunk",
                    "stride", "stage")]
                + [(f, ctypes.c_void_p) for f in
                   ("partial", "scores", "out", "unc", "ticket")])


class _LatticeLaunch(ctypes.Structure):
    """One lattice launch (``csrc/correlative.cu::LatticeLaunch``): the
    kernel's arguments, the block's threads, tiles a thread and the rows."""
    _fields_ = [("a", _LatticeTables), ("threads", ctypes.c_int),
                ("per", ctypes.c_int), ("R", ctypes.c_int)]


class LatticeLauncher:
    """One lattice search shape's launch (``lattice_launcher``): its
    ``_LatticeLaunch`` block packed once (the grid, the beams, the plan,
    the rows), the C function bound once and the stream reader.  ``run``
    checks the rows' tensors in one pass, allocates the partials' scratch,
    the rows and the point scores as views of one tensor (and the scores),
    writes the pointers, the ticket row of the stream and the point count
    into the block and makes one ctypes call with its address."""

    def __init__(self, config, A: int, L: int, R: int, P: int, dev,
                 with_unc: bool = False):
        W, H = config.grid_cells_x, config.grid_cells_y
        if R > 65535 or A > 65535:
            raise ValueError(f"{R} rows x {A} angles is outside the "
                             "kernel's launch range")
        beams = int(config.laser_max_beams)
        plan = lattice_plan(A, L, R, beams,
                            _build.sm_count(dev.index if dev.index is not None
                                            else torch.cuda.current_device()),
                            config.search_linear_resolution
                            / config.ndt_resolution, with_unc)
        self.plan, self.device, self.R = plan, dev, R
        self.n_partial = R * A * plan.tiles * 12
        self.scores_shape = (R, A, L, L)
        self.launch = _LatticeLaunch(
            _LatticeTables(cell=float(config.ndt_resolution), W=W, H=H, P=P,
                           max_beams=beams, A=A, L=L, tiles=plan.tiles,
                           groups=plan.groups, nx=plan.nx, cx=plan.cx,
                           cy=plan.cy, chunk=plan.chunk, stride=plan.stride,
                           stage=plan.stage),
            threads=plan.threads, per=plan.per, R=R)
        self.address = ctypes.addressof(self.launch)
        f32 = torch.float32
        self.expect = (("fields", f32, (R, H, W)), ("origins", f32, (R, 2)),
                       ("points", f32, (R, P, 2)),
                       ("point_mask", torch.bool, (R, P)),
                       ("poses", f32, (R, 3)), ("dths", f32, (A,)),
                       ("dls", f32, (L,)))
        self.nums = (("num_points", torch.int32, (R,)),)
        self._fn = None
        self._stream = None

    def run(self, fields, origins, points, point_mask, nums, num: int,
            poses, dths, dls, with_scores: bool = False,
            with_unc: bool = False):
        """(out [R, 13], scores [R, A, L, L] or None, unc [R] or None) of
        one launch; ``nums`` [R] int32, or None with ``num`` points every
        row."""
        global match_launches
        dev, R = self.device, self.R
        _build.require_all(dev, (fields, origins, points, point_mask, poses,
                                 dths, dls), self.expect)
        if nums is not None:
            _build.require_all(dev, (nums,), self.nums)
        if self._fn is None:
            size = _build.function("ndt2d_correlative_lattice_launch_size",
                                   [])()
            if size != ctypes.sizeof(_LatticeLaunch):
                raise RuntimeError(f"LatticeLaunch is {size} bytes in C, "
                                   f"{ctypes.sizeof(_LatticeLaunch)} here")
            self._fn = _build.function("ndt2d_correlative_match_planned",
                                       [ctypes.c_void_p, ctypes.c_void_p])
            self._stream = _build.stream_reader(dev)
        n = self.n_partial
        buf = torch.empty(n + R * (14 if with_unc else 13),
                          dtype=torch.float32, device=dev)
        out = buf[n:n + R * 13].view(R, 13)
        unc = buf[n + R * 13:] if with_unc else None
        scores = (torch.empty(self.scores_shape, dtype=torch.float32,
                              device=dev) if with_scores else None)
        stream = self._stream()
        a = self.launch.a
        a.field, a.origin = fields.data_ptr(), origins.data_ptr()
        a.points, a.pmask = points.data_ptr(), point_mask.data_ptr()
        a.nums = None if nums is None else nums.data_ptr()
        a.num = num
        a.pose, a.dths, a.dls = poses.data_ptr(), dths.data_ptr(), \
            dls.data_ptr()
        a.partial = buf.data_ptr()
        a.out = out.data_ptr()
        a.scores = None if scores is None else scores.data_ptr()
        a.unc = None if unc is None else unc.data_ptr()
        a.ticket = _tickets(dev, stream, R).data_ptr()
        _build.check(self._fn(self.address, stream), "correlative_match")
        match_launches += 1
        return out, scores, unc


_LATTICE_LAUNCHERS: dict = {}


def lattice_launcher(config, A: int, L: int, R: int, P: int, dev,
                     with_unc: bool = False) -> LatticeLauncher:
    """The launcher of this search shape, with or without the point score,
    made at its first launch."""
    key = (config.grid_cells_x, config.grid_cells_y,
           float(config.ndt_resolution), int(config.laser_max_beams),
           float(config.search_linear_resolution), A, L, R, P, dev,
           with_unc)
    launcher = _LATTICE_LAUNCHERS.get(key)
    if launcher is None:
        launcher = _LATTICE_LAUNCHERS[key] = LatticeLauncher(
            config, A, L, R, P, dev, with_unc)
    return launcher


def _launch_match(config, fields, origins, points, point_mask, nums,
                  num: int, poses, dths, dls, with_scores: bool,
                  with_unc: bool = False):
    """One lattice launch over R rows through its shape's launcher: (out
    [R, 13], scores or None, unc [R] or None)."""
    return lattice_launcher(config, dths.shape[0], dls.shape[0],
                            points.shape[0], points.shape[1],
                            points.device, with_unc).run(
        fields, origins, points, point_mask, nums, int(num), poses, dths,
        dls, with_scores, with_unc)


def _returns(out, scores, unc, with_scores: bool, with_unc: bool):
    """A search's return: the rows, then the scores and the point scores
    each where asked for."""
    extra = ((scores,) if with_scores else ()) + ((unc,) if with_unc else ())
    return (out, *extra) if extra else out


def match_rows(config, fields, origins, points, point_mask, num_points,
               poses, dths, dls, with_scores: bool = False,
               with_unc: bool = False):
    """The lattice search over R rows in one launch: fields [R, H, W] f32,
    origins [R, 2] f32, points [R, P, 2] f32, point_mask [R, P] bool,
    num_points [R] int32, poses [R, 3] f32, dths [A] / dls [L] f32.
    Returns the [R, 13] output rows; with ``with_scores`` also the scores
    [R, A, L, L], with ``with_unc`` also each row's point score at its pose
    ([R], ``score_batch``'s bits), in that order.  CPU tensors run the
    twin; CUDA tensors launch the kernel."""
    if points.device.type == "cpu":
        res, cand = match_rows_twin(config, fields, origins, points,
                                    point_mask, num_points, poses, dths, dls)
        unc = (torch.cat([score_batch_twin(
            config, fields[r], origins[r], points[r], point_mask[r],
            int(num_points[r]), poses[r:r + 1])
            for r in range(points.shape[0])]) if with_unc else None)
        return _returns(k2.pack(res), cand, unc, with_scores, with_unc)
    out, scores, unc = _launch_match(config, fields, origins, points,
                                     point_mask, num_points, 0, poses, dths,
                                     dls, with_scores, with_unc)
    return _returns(out, scores, unc, with_scores, with_unc)


def match(config, field, origin, points, point_mask, num_points: int, pose,
          dths, dls, with_scores: bool = False, with_unc: bool = False):
    """The lattice search of one scan: ``match_rows``' launch at R = 1.
    field [H, W], origin [2], points [P, 2], point_mask [P], pose [3].
    Returns its [1, 13] output row; with ``with_scores`` also the scores
    [A, L, L], with ``with_unc`` also the point score at ``pose`` ([1]),
    in that order.  CPU tensors run the twin; CUDA tensors launch the
    kernel."""
    if points.device.type == "cpu":
        res, cand = match_twin(config, field, origin, points, point_mask,
                               num_points, pose, dths, dls)
        out = k2.pack(MatchResult(*[x[None] for x in res]))
        unc = (score_batch_twin(config, field, origin, points, point_mask,
                                num_points, pose[None])
               if with_unc else None)
        return _returns(out, cand, unc, with_scores, with_unc)
    out, scores, unc = _launch_match(config, field[None], origin[None],
                                     points[None], point_mask[None], None,
                                     num_points, pose[None], dths, dls,
                                     with_scores, with_unc)
    return _returns(out, None if scores is None else scores[0], unc,
                    with_scores, with_unc)


def score_batch_twin(config, field, origin, points, point_mask,
                     num_points: int, poses):
    """Plain-PyTorch point score at poses [M, 3]: [M] minus the mean field
    value under the used beams, summed in the kernel's lane order."""
    W, H = config.grid_cells_x, config.grid_cells_y
    dev = points.device
    B = config.laser_max_beams
    spts, smask, used = subsample(points, point_mask, num_points, B)
    c, s = torch.cos(poses[:, 2:3]), torch.sin(poses[:, 2:3])
    wx = c * spts[:, 0] - s * spts[:, 1] + poses[:, 0:1]
    wy = s * spts[:, 0] + c * spts[:, 1] + poses[:, 1:2]
    cell = f32(config.ndt_resolution, dev)
    ix = torch.floor((wx - origin[0]) / cell).to(torch.int64)
    iy = torch.floor((wy - origin[1]) / cell).to(torch.int64)
    inb = (ix >= 0) & (iy >= 0) & (ix < W) & (iy < H) & smask
    flat = torch.where(inb, iy * W + ix, torch.zeros_like(ix))
    vals = torch.where(inb, field.reshape(-1)[flat],
                       torch.zeros((), device=dev))
    slots = -(-B // 32) * 32
    vals = torch.nn.functional.pad(vals, (0, slots - B))
    return -lane_tree_sum(vals) / f32(max(used, 1), dev)


def score_batch(config, field, origin, points, point_mask, num_points: int,
                poses):
    """Minus the mean field value under a scan's used beams at poses
    [M, 3] f32 (points [P, 2] f32, point_mask [P] bool); returns [M] f32.
    CPU tensors run the twin; CUDA tensors launch the kernel."""
    global score_launches
    if points.device.type == "cpu":
        return score_batch_twin(config, field, origin, points, point_mask,
                                num_points, poses)
    dev = points.device
    W, H = config.grid_cells_x, config.grid_cells_y
    P, M = points.shape[0], poses.shape[0]
    if M < 1:
        raise ValueError("score_batch needs at least one pose")
    _build.require(field, "field", torch.float32, (H, W), dev)
    _build.require(origin, "origin", torch.float32, (2,), dev)
    _build.require(points, "points", torch.float32, (P, 2), dev)
    _build.require(point_mask, "point_mask", torch.bool, (P,), dev)
    _build.require(poses, "poses", torch.float32, (M, 3), dev)
    out = torch.empty(M, dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _build.function(
        "ndt2d_correlative_score",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p])(
        p(field), p(origin), float(config.ndt_resolution), W, H, p(points),
        p(point_mask), P, int(num_points), int(config.laser_max_beams),
        p(poses), M, p(out), _build.stream_ptr(dev))
    _build.check(err, "correlative_score")
    score_launches += 1
    return out
