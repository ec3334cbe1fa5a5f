"""K10: the keyframe descriptors (CUDA ``csrc/descriptors.cu``) and their
plain-PyTorch twins.

Two kernels replace ``ndt_2d_tpu/parallel/loop_search.py::descriptors``.
``bin_points`` is its segment sums (``binned_sum`` over the sector, ring x
sector and range-bin ids) with the range, angle and bin indices they are
taken over: per scan, one pass over its masked points gives the points per
angular sector, the sum of their ranges per sector, the points per (ring,
sector), the points per range bin and the points of the scan.  ``spectra``
turns these tables into the descriptors: the mean-range profile and the
ring occupancy profiles through |DFT| over the sectors, the mean-centred
range histogram, and the joint L2 norm, a warp a scan (``spectra_plan``
picks the scans a block and whether the DFT tables fit in its shared
memory).

The counts are exact in any order.  Every float sum (a sector's ranges over
its points, a DFT term over the sectors, the histogram's mean, the norm)
adds in index order from 0, in the kernels and in the twins, so on the same
CUDA inputs they agree bitwise.  The kernel forms a sector's range sum
from a stable counting sort of the scan's points by sector (``bins_plan``
picks its block), so no thread walks every point.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ndt_2d_tpu_torch.kernels import _build
from ndt_2d_tpu_torch.ndt import grid as ndt_grid

launches = 0           # bin_points
spectra_launches = 0

_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_float]
         + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6)
_SPECTRA_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_float]
                 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)


class Bins(NamedTuple):
    sector_count: torch.Tensor   # [S, n_sectors] points per sector
    sector_range: torch.Tensor   # [S, n_sectors] sum of ranges per sector
    ring_count: torch.Tensor     # [S, n_rings * n_sectors], ring-major
    hist: torch.Tensor           # [S, n_bins] points per range bin
    total: torch.Tensor          # [S] masked points of the scan


def bin_indices(points, range_max: float, n_sectors: int, n_rings: int,
                n_bins: int):
    """(r, sector, ring, range bin) of [..., 2] robot-frame points, as the
    kernel computes them: float32, one rounding per operation, the
    constants as device tensors so that every division is a division."""
    dev = points.device
    x, y = points[..., 0], points[..., 1]
    r = torch.sqrt(x * x + y * y)
    ang = torch.atan2(y, x)

    def clipped(v, n):
        return torch.clamp((v * ndt_grid.f32(n, dev)).to(torch.int32), 0,
                           n - 1)
    sec = clipped((ang + ndt_grid.f32(math.pi, dev))
                  / ndt_grid.f32(2.0 * math.pi, dev), n_sectors)
    rel = r / ndt_grid.f32(range_max, dev)
    return r, sec, clipped(rel, n_rings), clipped(rel, n_bins)


def bin_twin(points, point_mask, range_max: float, n_sectors: int = 64,
             n_rings: int = 4, n_bins: int = 32) -> Bins:
    """Plain-PyTorch K10: the five tables of points [S, P, 2] under
    point_mask [S, P]."""
    S = points.shape[0]
    r, sec, ring, b = bin_indices(points, range_max, n_sectors, n_rings,
                                  n_bins)
    keep = torch.nonzero(point_mask.reshape(-1)).squeeze(1)
    scan = (keep // points.shape[1]).to(torch.int64)

    def count(ids, n):
        seg = scan * n + ids.reshape(-1)[keep].to(torch.int64)
        return torch.bincount(seg, minlength=S * n).reshape(S, n).to(
            torch.float32)
    seg = scan * n_sectors + sec.reshape(-1)[keep].to(torch.int64)
    sector_range = ndt_grid.segment_sum_in_order(
        seg, r.reshape(-1)[keep][:, None], S * n_sectors).reshape(
            S, n_sectors)
    return Bins(count(sec, n_sectors), sector_range,
                count(ring * n_sectors + sec, n_rings * n_sectors),
                count(b, n_bins),
                point_mask.sum(dim=1).to(torch.float32))


class BinsPlan(NamedTuple):
    threads: int   # a block's threads, one block a scan: 128 or 256
    smem: int      # its dynamic shared bytes


# A bins block's shapes (the kernel's instantiations), the most threads an
# SM runs at once, and the shared memory a block may take: the H100's 227
# KB opt-in (the entry opts a block past the default 48 KB in; a card with
# less refuses the launch).  It holds scans of up to ~18,900 points.
BIN_THREADS = (128, 256)
SM_THREADS = 2048
BIN_SHARED = 232448


def bins_shared(P: int, n_sectors: int, n_rings: int, n_bins: int,
                threads: int) -> int:
    """Dynamic shared bytes of a bins block (``bins_shared`` of
    csrc/descriptors.cu): r and the sorted ranges (4 bytes each), the
    sector and the rank (2 each) of every point, the integer counters, a
    count and a base per (warp, sector) and a run start per sector."""
    n_counts = n_sectors * (1 + n_rings) + n_bins
    return 12 * P + 4 * (n_counts + (threads // 16 + 1) * n_sectors)


def bins_plan(S: int, P: int, n_sectors: int = 64, n_rings: int = 4,
              n_bins: int = 32, sms: int = 132) -> BinsPlan:
    """The bins launch of S scans of P points: blocks of 256 threads where
    every block of the launch is resident at once (S <= sms x 2048 / 256),
    else of 128; raises where a block's shared memory passes
    ``BIN_SHARED``."""
    threads = 256 if S * 256 <= sms * SM_THREADS else 128
    smem = bins_shared(P, n_sectors, n_rings, n_bins, threads)
    if (min(n_sectors, n_rings, n_bins) < 1 or n_sectors >= 32768
            or smem > BIN_SHARED):
        raise ValueError(f"{P} points x {n_sectors} sectors x {n_rings} "
                         f"rings, {n_bins} bins is outside the kernel's "
                         "range")
    return BinsPlan(threads, smem)


def bin_points(points, point_mask, range_max: float, n_sectors: int = 64,
               n_rings: int = 4, n_bins: int = 32) -> Bins:
    """K10 over S scans in one launch: points [S, P, 2] f32 robot frame,
    point_mask [S, P] bool, blocks as ``bins_plan`` says.  CPU tensors run
    the twin; CUDA tensors launch the kernel."""
    global launches
    if points.device.type == "cpu":
        return bin_twin(points, point_mask, range_max, n_sectors, n_rings,
                        n_bins)
    dev = points.device
    S, P = points.shape[0], points.shape[1]
    _build.require(points, "points", torch.float32, (S, P, 2), dev)
    _build.require(point_mask, "point_mask", torch.bool, (S, P), dev)
    if points.data_ptr() % 8:
        raise ValueError("points: must start 8-byte aligned")
    plan = bins_plan(S, P, n_sectors, n_rings, n_bins, _build.sm_count(
        dev.index if dev.index is not None else torch.cuda.current_device()))

    def empty(*shape):
        return torch.empty(*shape, dtype=torch.float32, device=dev)
    out = Bins(empty(S, n_sectors), empty(S, n_sectors),
               empty(S, n_rings * n_sectors), empty(S, n_bins), empty(S))
    p = _build.ptr
    err = _build.function("ndt2d_descriptor_bins", _ARGS)(
        p(points), p(point_mask), S, P, float(range_max), n_sectors,
        n_rings, n_bins, plan.threads, *[p(t) for t in out],
        _build.stream_ptr(dev))
    _build.check(err, "descriptor_bins")
    launches += 1
    return out


@functools.lru_cache(maxsize=None)
def dft_tables(n_sectors: int, device):
    """cos and sin of 2 pi a k / n_sectors, [n_sectors, n_sectors / 2], at
    the frequencies k = 1 .. n_sectors / 2 (the DC term is dropped); made
    once per size and device."""
    k = torch.arange(1, n_sectors // 2 + 1, dtype=torch.float32,
                     device=device)
    a = torch.arange(n_sectors, dtype=torch.float32, device=device)
    w = (ndt_grid.f32(2.0 * math.pi, device) * a[:, None] * k[None, :]
         / ndt_grid.f32(n_sectors, device))
    return torch.cos(w).contiguous(), torch.sin(w).contiguous()


def _sum_in_order(x):
    """Sum over the last axis, adding from index 0."""
    acc = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def spectra_twin(bins: Bins, range_max: float, n_sectors: int = 64,
                 n_rings: int = 4, n_bins: int = 32):
    """Plain-PyTorch ``spectra``: descriptors [S, D] of the bin tables."""
    dev = bins.total.device
    S = bins.total.shape[0]
    one = ndt_grid.f32(1.0, dev)
    total = torch.maximum(bins.total[:, None], one)
    prof = (bins.sector_range / torch.maximum(bins.sector_count, one)
            / ndt_grid.f32(range_max, dev))
    profs = torch.cat([prof[:, None],
                       (bins.ring_count / total).reshape(S, n_rings,
                                                         n_sectors)], 1)
    cos_t, sin_t = dft_tables(n_sectors, dev)
    re = torch.zeros(S, 1 + n_rings, n_sectors // 2, device=dev)
    im = torch.zeros_like(re)
    for a in range(n_sectors):
        re = re + profs[:, :, a, None] * cos_t[a]
        im = im + profs[:, :, a, None] * sin_t[a]
    spec = torch.sqrt(re * re + im * im).reshape(S, -1)
    hist = bins.hist / total
    mean = _sum_in_order(hist) / ndt_grid.f32(n_bins, dev)
    d = torch.cat([spec, hist - mean[:, None]], 1)
    norm = torch.sqrt(_sum_in_order(d * d))
    out = d / torch.maximum(norm, ndt_grid.f32(1e-12, dev))[:, None]
    return torch.where(bins.total[:, None] > 0, out, torch.zeros_like(out))


class SpectraPlan(NamedTuple):
    warps: int    # scans a block, a warp each: 1, 2, 4 or 8
    staged: int   # 1: the block stages the cos/sin tables in shared memory
    smem: int     # its dynamic shared bytes


SPECTRA_SHARED = 48 * 1024  # a block's dynamic shared memory, the default


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def spectra_shared(n_sectors: int, n_rings: int, n_bins: int, warps: int,
                   staged: int) -> int:
    """Dynamic shared bytes of a spectra block (``spectra_shared`` of
    csrc/descriptors.cu): the cos and sin tables where staged, then a warp's
    profiles (its squares later) and its descriptor, each rounded up to 16
    bytes."""
    half, prof = n_sectors // 2, (1 + n_rings) * n_sectors
    D = (1 + n_rings) * half + n_bins
    region = _round4(max(prof, D)) + _round4(D)
    return 4 * ((_round4(2 * n_sectors * half) if staged else 0)
                + warps * region)


@functools.lru_cache(maxsize=None)
def spectra_plan(S: int, n_sectors: int = 64, n_rings: int = 4,
                 n_bins: int = 32, sms: int = 132) -> SpectraPlan:
    """The spectra launch of S scans: blocks of 8 warps where that still
    gives every SM a block (S >= 8 sms), else 4, fewer where a block's
    warps do not fit in the default 48 KB of shared memory; the tables
    staged where they fit beside them.  Raises where one warp's part does
    not fit."""
    if min(n_sectors // 2, n_rings, n_bins) < 1:
        raise ValueError(f"{n_sectors} sectors x {n_rings} rings, {n_bins} "
                         "bins is outside the kernel's range")
    warps = 8 if S >= 8 * sms else 4
    while (warps > 1 and spectra_shared(n_sectors, n_rings, n_bins, warps,
                                        0) > SPECTRA_SHARED):
        warps //= 2
    smem = spectra_shared(n_sectors, n_rings, n_bins, warps, 1)
    if smem <= SPECTRA_SHARED:
        return SpectraPlan(warps, 1, smem)
    smem = spectra_shared(n_sectors, n_rings, n_bins, warps, 0)
    if smem > SPECTRA_SHARED:
        raise ValueError(f"{n_sectors} sectors x {n_rings} rings, {n_bins} "
                         "bins is outside the kernel's range")
    return SpectraPlan(warps, 0, smem)


def spectra(bins: Bins, range_max: float, n_sectors: int = 64,
            n_rings: int = 4, n_bins: int = 32):
    """The L2-normalized descriptors [S, (1 + n_rings) * n_sectors / 2 +
    n_bins] of K10's bin tables, in one launch (``spectra_plan``).  CPU
    tensors run the twin; CUDA tensors launch the kernel."""
    global spectra_launches
    dev = bins.total.device
    if dev.type == "cpu":
        return spectra_twin(bins, range_max, n_sectors, n_rings, n_bins)
    S = bins.total.shape[0]
    for t, name, width in zip(bins, Bins._fields,
                              (n_sectors, n_sectors, n_rings * n_sectors,
                               n_bins)):
        _build.require(t, name, torch.float32, (S, width), dev)
    _build.require(bins.total, "total", torch.float32, (S,), dev)
    plan = spectra_plan(S, n_sectors, n_rings, n_bins, _build.sm_count(
        dev.index if dev.index is not None else torch.cuda.current_device()))
    cos_t, sin_t = dft_tables(n_sectors, dev)
    out = torch.empty(S, (1 + n_rings) * (n_sectors // 2) + n_bins,
                      dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _build.function("ndt2d_descriptor_spectra", _SPECTRA_ARGS)(
        *[p(t) for t in bins], p(cos_t), p(sin_t), S, float(range_max),
        n_sectors, n_rings, n_bins, plan.warps, plan.staged, p(out),
        _build.stream_ptr(dev))
    _build.check(err, "descriptor_spectra")
    spectra_launches += 1
    return out
