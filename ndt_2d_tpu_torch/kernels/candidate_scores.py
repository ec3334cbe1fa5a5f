"""K2: exhaustive candidate scoring + its reduction (CUDA
``csrc/candidate_scores.cu``) and the plain-PyTorch twin.

Replaces the local fast path of ``ndt_2d_tpu/matching/matcher.py``
(``prepare_neighborhood`` -> ``_candidate_scores_local`` ->
``reduce_candidates`` -> ``finalize_match``), which the retired Pallas
kernels ``candidate_scores_pallas`` / ``_gather`` also computed.  The
kernel covers lattices no wider than one NDT cell
(2 * search_linear_size <= ndt_resolution), where each (angle, beam) meets
one 2x2 cell patch; the matcher raises for wider ones.

``match_rows`` takes a row axis (R confirmation rows, the ``jax.vmap`` of
``match_scan_batch_multi``); ``match`` is the same launch at R = 1.  Both
return the kernel's [R, 13] output rows, which K7 refines in place and
``unpack`` reads.  A grid with a grid axis (the four overlapping grids of
K1 with ``grids=4``: origin [4, 2], tables [4, C, 32] per row) is scored
as the mean over its grids (matcher.py:194-202); without one, the launch
is the single-grid search.

The twin adds in the kernel's order (each candidate's beams from 0, the
Olson sums through the kernel's warp tree, warps and angles in order), so
on the same CUDA inputs kernel and twin agree bitwise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ndt_2d_tpu_torch.kernels import _build
from ndt_2d_tpu_torch.kernels.score_points import subsample
from ndt_2d_tpu_torch.ndt import grid as ndt_grid

launches = 0

_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_float]
         + [ctypes.c_int] * 2
         + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
         + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
         + [ctypes.c_void_p] + [ctypes.c_int] + [ctypes.c_void_p] * 4)
# Per-angle partial of the kernel: best, best index, 10 Olson sums.
_PARTIAL = 12


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
                     dths, dls, table):
    """[A, L, L] candidate scores; a stacked grid (origin [G, 2], table
    [G, C, 32]) scores the mean over its grids, summed from 0 in grid order
    as Python's ``sum`` does (matcher.py:194-202)."""
    if table.dim() == 2:
        return candidate_scores_local(config, grid, spts, smask, pose, dths,
                                      dls, table)
    per = [candidate_scores_local(
        config, ndt_grid.NDTGrid(origin=grid.origin[g],
                                 cell_size=grid.cell_size, mean=None,
                                 information=None, count=None,
                                 covariance=None),
        spts, smask, pose, dths, dls, table[g])
        for g in range(table.shape[0])]
    return sum(per) / ndt_grid.f32(len(per), spts.device)


def _sum_as_kernel(terms):
    """terms [A, T, K] summed in the kernel's order: per angle its T
    candidates as zero-padded 32-lane warps, each folded in halves (the
    shuffle tree), the warps added in order, then the angles in order."""
    A, T, K = terms.shape
    nw = -(-T // 32)
    x = torch.nn.functional.pad(terms, (0, 0, 0, nw * 32 - T))
    x = x.reshape(A, nw, 32, K)
    for h in (16, 8, 4, 2, 1):
        x = x[:, :, :h] + x[:, :, h:2 * h]
    acc = x[:, 0, 0]
    for w in range(1, nw):
        acc = acc + x[:, w, 0]
    total = acc[0]
    for a in range(1, A):
        total = total + acc[a]
    return total


def reduce_candidates(cand, dths, dls):
    """(best, correction [3], K [3, 3], u [3], s): first-index argmin in
    (angle, dx, dy) order, correction applied only when best < 0, and the
    raw Olson accumulators over every candidate, summed in the kernel's
    order."""
    A, L = cand.shape[0], cand.shape[1]
    flat = cand.reshape(-1)
    best_idx = torch.argmin(flat)
    best = flat[best_idx]
    ai, xi, yi = best_idx // (L * L), (best_idx // L) % L, best_idx % L
    correction = torch.where(best < 0.0,
                             torch.stack([dls[xi], dls[yi], dths[ai]]),
                             torch.zeros(3, dtype=cand.dtype,
                                         device=cand.device))
    x = torch.stack([dls[None, :, None].expand(A, L, L),
                     dls[None, None, :].expand(A, L, L),
                     dths[:, None, None].expand(A, L, L)], dim=-1)
    sw = cand[..., None]
    i, j = [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]
    terms = torch.cat([sw, x * sw, x[..., i] * x[..., j] * sw], dim=-1)
    total = _sum_as_kernel(terms.reshape(A, L * L, 10))
    k = total[[4, 5, 6, 5, 7, 8, 6, 8, 9]].reshape(3, 3)
    return best, correction, k, total[1:4], total[0]


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
                    point_mask, num_points, poses, dths, dls):
    """Plain-PyTorch K2 over a row axis, one row at a time: (MatchResult
    of [R], [R, 3], [R, 3, 3] tensors, scores [R, A, L, L])."""
    res, cand = [], []
    for r in range(points.shape[0]):
        g = ndt_grid.NDTGrid(origin=grid.origin[r], cell_size=grid.cell_size,
                             mean=None, information=None, count=None,
                             covariance=None)
        m, c = match_twin(config, g, tables[r], points[r], point_mask[r],
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


def _launch(config, origin, cell_size: float, tables, points, point_mask,
            nums, num: int, poses, dths, dls, with_scores: bool):
    """One K2 launch over R rows (tables [R, (G,) C, 32], origin
    [R, (G,) 2]); returns (out [R, 13], scores or None)."""
    global launches
    dev = points.device
    W, H = config.grid_cells_x, config.grid_cells_y
    R, P = points.shape[0], points.shape[1]
    A, L = dths.shape[0], dls.shape[0]
    if L * L > 1024 or A > 512 or W < 2 or H < 2:
        raise ValueError(f"lattice {A}x{L}x{L} on a {W}x{H} grid is outside "
                         "the kernel's range")
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
    partial = torch.empty(R, A, _PARTIAL, dtype=torch.float32, device=dev)
    out = torch.empty(R, 13, dtype=torch.float32, device=dev)
    scores = (torch.empty(R, A, L, L, dtype=torch.float32, device=dev)
              if with_scores else None)
    p = _build.ptr
    err = _build.function("ndt2d_candidate_scores", _ARGS)(
        p(tables), p(origin), G, float(cell_size), W, H, p(points),
        p(point_mask), R, P, None if nums is None else p(nums), int(num),
        int(config.laser_max_beams), p(poses), p(dths), A, p(dls), L,
        p(partial), p(out), None if scores is None else p(scores),
        _build.stream_ptr(dev))
    _build.check(err, "candidate_scores")
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
