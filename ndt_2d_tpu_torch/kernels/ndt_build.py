"""K1: the window NDT build (CUDA ``csrc/ndt_build.cu``) and its twin.

Replaces ``ndt_2d_tpu/matching/matcher.py::window_origin`` +
``build_window_ndt`` (single grid) -> ``ndt_2d_tpu/ndt/grid.py::
build_ndt_from_scans`` / ``build_ndt_binned`` + ``packed_patch_table``.
One launch bins the windows' points, sorts each window's points by cell
(a stable radix sort), sums each cell's run of points in point-index order
(no float atomics), finalizes every cell and writes the [C, 32] patch
table K2 reads; the source's header says what bounds it.  ``build_plan``
sizes the scratch and the passes of a launch.

``build_windows`` takes a row axis (R windows, the ``jax.vmap`` of the
loop-closure confirmation); ``build_window`` is the same launch at R = 1.
With ``grids=4`` every window gets the four overlapping grids of
``build_window_ndt(overlapping_grids)`` (matcher.py:95-103): grid g's origin
is the window origin minus offs[g], offs = (0,0), (h,0), (0,h), (h,h),
h = 0.5 * cell_size in float32, and every field gains a grid axis after the
row axis ([R, 4, ...], or [4, ...] for one window).  With ``grids=1`` there
is no grid axis, and the launch is the single-grid build.

KB1, ``build_stripe``: one y-stripe of a sharded map
(``ndt_2d_tpu/parallel/ndt_blocks.py::build_ndt_sharded``), the points
binned against the map's given origin and K1's sort and cell passes over
the stripe's cells, which are bitwise those rows of the dense build.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ndt_2d_tpu_torch.core import pose as pose_ops
from ndt_2d_tpu_torch.kernels import _build
from ndt_2d_tpu_torch.ndt import grid as ndt_grid

launches = 0
# KB1: launches of the stripe build.
stripe_launches = 0

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
         + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 15)
_GRID_FIELDS = ("origin", "mean", "information", "count", "covariance")
_STRIPE_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
                + [ctypes.c_float] + [ctypes.c_int] * 7
                + [ctypes.c_void_p] * 14)

# The kernels' fixed geometry (csrc/ndt_build.cu): the sort's block of
# SORT_THREADS threads ranks a tile of SORT_THREADS * SORT_ITEMS points a
# round (each warp 32 * SORT_ITEMS consecutive points, 32 at a time), in
# RADIX_BITS-bit digits; a block of the binning takes BLOCK_THREADS points
# (or cells to clear), a block of the cell pass BLOCK_THREADS cells.
SORT_THREADS = 512
SORT_ITEMS = 8
RADIX_BITS = 8
MAX_DIGITS = 4
BLOCK_THREADS = 256
# The int32 scratch regions of a launch, in order: the two (key, x, y)
# buffers of the sort, [rows, N] each, then the runs [rows, C] each.
SCRATCH = ("key0", "x0", "y0", "key1", "x1", "y1", "run_start", "run_end")


class BuildPlan(NamedTuple):
    digits: int       # LSD passes: keys 0..C (C: off the grid) in 8-bit digits
    tile: int         # points a sort round
    bin_blocks: int   # 256-thread blocks over max(N, C) a row
    cell_blocks: int  # 256-cell blocks a row
    offsets: tuple    # element offset of each SCRATCH region
    scratch: int      # int32 elements of scratch in all


@functools.lru_cache(maxsize=None)
def build_plan(points: int, cells: int, rows: int) -> BuildPlan:
    """The passes and scratch of one K1 (or KB1) launch over ``rows``
    virtual rows of ``points`` points and ``cells`` cells each."""
    if cells < 1 or points < 0 or rows < 1:
        raise ValueError(f"{rows} rows of {points} points on {cells} cells")
    digits = max(1, -(-cells.bit_length() // RADIX_BITS))
    if digits > MAX_DIGITS:
        raise ValueError(f"{cells} cells is outside the kernel's range")
    sizes = [rows * points] * 6 + [rows * cells] * 2
    offsets = tuple(sum(sizes[:i]) for i in range(len(sizes)))
    return BuildPlan(digits=digits, tile=SORT_THREADS * SORT_ITEMS,
                     bin_blocks=-(-max(points, cells) // BLOCK_THREADS),
                     cell_blocks=-(-cells // BLOCK_THREADS),
                     offsets=offsets, scratch=max(1, sum(sizes)))


def _launch_plan(points: int, cells: int, rows: int, dev):
    """(plan ints for the C entry, scratch pointers) of one launch."""
    plan = build_plan(points, cells, rows)
    scratch = torch.empty(plan.scratch, dtype=torch.int32, device=dev)
    base = scratch.data_ptr()
    return ((plan.digits, plan.tile, plan.bin_blocks, plan.cell_blocks),
            [base + 4 * o for o in plan.offsets], scratch)


def window_origin(poses, window_mask, range_max: float):
    """Grid origin of a window: min over its poses - range_max per axis."""
    big = torch.finfo(poses.dtype).max
    xy = torch.where(window_mask[:, None], poses[:, :2],
                     torch.full_like(poses[:, :2], big))
    return torch.amin(xy, dim=0) - range_max


def grid_offsets(cell_size: float, device) -> torch.Tensor:
    """The overlapping grids' origin offsets [4, 2] (matcher.py:96-98)."""
    h = 0.5 * cell_size
    return torch.tensor([[0.0, 0.0], [h, 0.0], [0.0, h], [h, h]],
                        dtype=torch.float32, device=device)


def stack_grids(grids, cell_size: float) -> ndt_grid.NDTGrid:
    """One NDTGrid whose fields stack ``grids``' along a new leading axis."""
    return ndt_grid.NDTGrid(
        cell_size=float(cell_size),
        **{f: torch.stack([getattr(g, f) for g in grids])
           for f in _GRID_FIELDS})


def build_window_twin(poses, points, point_mask, window_mask,
                      range_max: float, cell_size: float, width: int,
                      height: int, grids: int = 1):
    """Plain-PyTorch K1 of one window: (NDTGrid, packed patch table
    [C, 32]), or with ``grids=4`` the four overlapping grids ([4, ...]
    fields, tables [4, C, 32])."""
    origin = window_origin(poses, window_mask, range_max)
    mask = point_mask & window_mask[:, None]

    def one(o):
        g = ndt_grid.build_ndt_from_scans(poses, points, mask, o, cell_size,
                                          width, height)
        return g, ndt_grid.packed_patch_table(g, width)
    if grids == 1:
        return one(origin)
    origins = origin[None, :] - grid_offsets(cell_size, poses.device)
    built = [one(o) for o in origins]
    return (stack_grids([g for g, _ in built], cell_size),
            torch.stack([t for _, t in built]))


def build_windows_twin(poses, points, point_mask, window_mask,
                       range_max: float, cell_size: float, width: int,
                       height: int, grids: int = 1):
    """Plain-PyTorch K1 over a row axis, one window at a time: (NDTGrid
    whose fields carry a leading [R] axis, tables [R, (4,) C, 32])."""
    rows = [build_window_twin(poses[r], points[r], point_mask[r],
                              window_mask[r], range_max, cell_size, width,
                              height, grids)
            for r in range(poses.shape[0])]
    return (stack_grids([g for g, _ in rows], cell_size),
            torch.stack([t for _, t in rows]))


def build_windows(poses, points, point_mask, window_mask, range_max: float,
                  cell_size: float, width: int, height: int,
                  grids: int = 1):
    """R window NDTs + patch tables in one launch.  poses [R, S, 3] f32,
    points [R, S, P, 2] f32, point_mask [R, S, P] bool, window_mask [R, S]
    bool; ``grids`` 1 or 4 (overlapping).  Returns (NDTGrid with a leading
    [R] axis on every field, then a [4] grid axis when grids=4; tables
    [R, (4,) C, 32]).  CPU tensors run the twin; CUDA tensors launch the
    kernel."""
    global launches
    if grids not in (1, 4):
        raise ValueError(f"grids={grids}: 1 or 4 (overlapping)")
    if poses.device.type == "cpu":
        return build_windows_twin(poses, points, point_mask, window_mask,
                                  range_max, cell_size, width, height, grids)
    dev = poses.device
    R, S, P = points.shape[0], points.shape[1], points.shape[2]
    _build.require(poses, "poses", torch.float32, (R, S, 3), dev)
    _build.require(points, "points", torch.float32, (R, S, P, 2), dev)
    _build.require(point_mask, "point_mask", torch.bool, (R, S, P), dev)
    _build.require(window_mask, "window_mask", torch.bool, (R, S), dev)
    C, G = width * height, grids
    lead = (R,) if G == 1 else (R, G)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(*lead, *shape, dtype=dtype, device=dev)
    plan, regions, scratch = _launch_plan(S * P, C, R * G, dev)
    origin, mean, info, cov = empty(2), empty(C, 2), empty(C, 3), \
        empty(C, 3)
    count, table = empty(C, dtype=torch.int32), empty(C, 32)
    p = _build.ptr
    err = _build.function("ndt2d_ndt_build", _ARGS)(
        p(poses), p(points), p(point_mask), p(window_mask), R, S, P, G,
        0.5 * float(cell_size), float(range_max), float(cell_size), width,
        height, *plan, *regions, p(origin), p(mean), p(info), p(cov),
        p(count), p(table), _build.stream_ptr(dev))
    del scratch  # the allocator reuses it in stream order
    _build.check(err, "ndt_build")
    launches += 1
    grid = ndt_grid.NDTGrid(origin=origin, cell_size=float(cell_size),
                            mean=mean, information=info, count=count,
                            covariance=cov)
    return grid, table


def build_window(poses, points, point_mask, window_mask, range_max: float,
                 cell_size: float, width: int, height: int, grids: int = 1):
    """One window NDT + patch table: ``build_windows`` at R = 1.  poses
    [S, 3] f32, points [S, P, 2] f32, point_mask [S, P] bool, window_mask
    [S] bool."""
    if poses.device.type == "cpu":
        return build_window_twin(poses, points, point_mask, window_mask,
                                 range_max, cell_size, width, height, grids)
    grid, table = build_windows(poses[None], points[None], point_mask[None],
                                window_mask[None], range_max, cell_size,
                                width, height, grids)
    return row_grid(grid, 0), table[0]


def row_grid(grid: ndt_grid.NDTGrid, r: int) -> ndt_grid.NDTGrid:
    """Row ``r`` of a grid with a leading row axis."""
    return ndt_grid.NDTGrid(
        origin=grid.origin[r], cell_size=grid.cell_size, mean=grid.mean[r],
        information=grid.information[r], count=grid.count[r],
        covariance=grid.covariance[r])


# --- KB1: one y-stripe of a sharded map (parallel/ndt_blocks.py) ---------
def build_stripe_twin(poses, points, point_mask, window_mask, origin,
                      cell_size: float, width: int, row0: int, rows: int):
    """Plain-PyTorch KB1: (NDTGrid of the stripe's rows * width cells with
    the global origin, patch table [rows * width, 32])."""
    world = pose_ops.transform_points(poses, points).reshape(-1, 2)
    mask = (point_mask & window_mask[:, None]).reshape(-1)
    flat, valid = ndt_grid.stripe_cells(origin, cell_size, width, row0,
                                        rows, world)
    g = ndt_grid.build_ndt_binned(world, valid & mask, flat, origin,
                                  cell_size, rows * width)
    return g, ndt_grid.packed_patch_table(g, width)


def build_stripe(poses, points, point_mask, window_mask, origin,
                 cell_size: float, width: int, row0: int, rows: int):
    """KB1: the NDT of the grid rows [row0, row0 + rows) of the window's
    points binned against ``origin`` [2] f32 (the whole map's), and its
    patch table.  poses [S, 3] f32, points [S, P, 2] f32, point_mask
    [S, P] bool, window_mask [S] bool.  The cells are bitwise those rows
    of the dense K1 build at that origin.  CPU tensors run the twin; CUDA
    tensors launch the kernel."""
    global stripe_launches
    if poses.device.type == "cpu":
        return build_stripe_twin(poses, points, point_mask, window_mask,
                                 origin, cell_size, width, row0, rows)
    dev = poses.device
    S, P = points.shape[0], points.shape[1]
    _build.require(poses, "poses", torch.float32, (S, 3), dev)
    _build.require(points, "points", torch.float32, (S, P, 2), dev)
    _build.require(point_mask, "point_mask", torch.bool, (S, P), dev)
    _build.require(window_mask, "window_mask", torch.bool, (S,), dev)
    _build.require(origin, "origin", torch.float32, (2,), dev)
    C = width * rows

    def empty(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device=dev)
    plan, regions, scratch = _launch_plan(S * P, C, 1, dev)
    mean, info, cov = empty(C, 2), empty(C, 3), empty(C, 3)
    count, table = empty(C, dtype=torch.int32), empty(C, 32)
    p = _build.ptr
    err = _build.function("ndt2d_ndt_build_stripe", _STRIPE_ARGS)(
        p(poses), p(points), p(point_mask), p(window_mask), S, P, p(origin),
        float(cell_size), width, int(row0), int(rows), *plan, *regions,
        p(mean), p(info), p(cov), p(count), p(table), _build.stream_ptr(dev))
    del scratch  # the allocator reuses it in stream order
    _build.check(err, "ndt_build_stripe")
    stripe_launches += 1
    grid = ndt_grid.NDTGrid(origin=origin.clone(), cell_size=float(cell_size),
                            mean=mean, information=info, count=count,
                            covariance=cov)
    return grid, table
