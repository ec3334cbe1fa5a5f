"""Newton refinement of a pose on the NDT score surface, in plain PyTorch.

Port of ``ndt_2d_tpu/matching/newton.py``.  These functions are the twin of
kernel K7 (``kernels/newton.py``, ``csrc/newton.cu``): they write the
kernel's operations in the kernel's order, over a row axis R, so that on the
same inputs the two agree bitwise.  The objective of a pose (x, y, th) is

  f = -sum_b s_b,  s_b = exp(min(-q^T L q / 2, 0)),  q = R(th) p_b + t - mu,

over the beams in an in-grid cell with >= 5 points; its gradient and
Hessian are the reference's closed forms (newton.py:12-21).  Each sum over
beams is taken in the kernel's lane order (``score_points.lane_tree_sum``);
a stacked grid (the four overlapping grids) contributes the mean of its
grids' (f, gradient, Hessian), summed from 0 in grid order (newton.py:52-58).
The 3x3 Newton system is solved by LU with partial pivoting spelled out step
by step (``solve3``), never ``torch.linalg.solve``.

Grids here carry a row and a grid axis: fields [R, G, ...].
"""

from __future__ import annotations

import torch

from ndt_2d_tpu_torch.kernels.score_points import lane_tree_sum
from ndt_2d_tpu_torch.ndt import grid as ndt_grid

# Order of the ten sums: f (negated sum of scores), gradient (3), Hessian
# entries h11, h12, h13, h22, h23, h33.
NUM_SUMS = 10


def _grid_sums(origin, mean, info, count, cell, W: int, H: int, spts, smask,
               p, c, s):
    """The ten per-row sums (sum of scores, gradient, Hessian) of one grid
    at poses p [R, 3]: a list of [R] tensors.  origin [R, 2], mean
    [R, C, 2], info [R, C, 3], count [R, C]; spts [R, B, 2], smask [R, B];
    c, s: cos and sin of p's headings, [R, 1]."""
    R = spts.shape[0]
    px, py = spts[..., 0], spts[..., 1]
    rx = c * px - s * py                                   # R p
    ry = s * px + c * py
    wx = rx + p[:, 0:1]
    wy = ry + p[:, 1:2]
    # ndt/grid.py::cell_index
    ix = torch.floor((wx - origin[:, 0:1]) / cell).to(torch.int32)
    iy = torch.floor((wy - origin[:, 1:2]) / cell).to(torch.int32)
    valid = (ix >= 0) & (iy >= 0) & (ix < W) & (iy < H)
    flat = torch.clamp(iy, 0, H - 1) * W + torch.clamp(ix, 0, W - 1)
    safe = torch.where(valid, flat, torch.zeros_like(flat)).to(torch.int64)
    rows = torch.arange(R, device=spts.device)[:, None]
    m, inf, cnt = mean[rows, safe], info[rows, safe], count[rows, safe]
    i00, i01, i11 = inf[..., 0], inf[..., 1], inf[..., 2]
    ok = valid & smask & (cnt >= 5)
    qx = wx - m[..., 0]
    qy = wy - m[..., 1]
    lqx = i00 * qx + i01 * qy                              # L q
    lqy = i01 * qx + i11 * qy
    e = -0.5 * (qx * lqx + qy * lqy)
    sc = torch.exp(torch.clamp(e, max=0.0))
    sc = torch.where(ok, sc, torch.zeros_like(sc))
    j3x = -s * px - c * py                                 # dR/dth p
    j3y = c * px - s * py
    a3 = lqx * j3x + lqy * j3y
    lj3x = i00 * j3x + i01 * j3y                           # L J_3
    lj3y = i01 * j3x + i11 * j3y
    j33 = j3x * lj3x + j3y * lj3y
    hq = -(lqx * rx + lqy * ry)                            # q^T L d2q/dth2
    terms = torch.stack([
        sc, sc * lqx, sc * lqy, sc * a3,
        sc * (-lqx * lqx + i00), sc * (-lqx * lqy + i01),
        sc * (-lqx * a3 + lj3x), sc * (-lqy * lqy + i11),
        sc * (-lqy * a3 + lj3y), sc * (-a3 * a3 + j33 + hq)])  # [10, R, B]
    B = terms.shape[-1]
    slots = -(-B // 32) * 32
    padded = torch.nn.functional.pad(terms.reshape(NUM_SUMS * R, B),
                                     (0, slots - B))
    return list(lane_tree_sum(padded).reshape(NUM_SUMS, R))


def objective_sums(grid: ndt_grid.NDTGrid, W: int, H: int, spts, smask, p):
    """(f, g0, g1, g2, h11, h12, h13, h22, h23, h33) at poses p [R, 3],
    each an [R] tensor; grid fields [R, G, ...]."""
    dt, dev = spts.dtype, spts.device
    cell = torch.tensor(grid.cell_size, dtype=torch.float32,
                        device=dev).to(dt)
    c, s = torch.cos(p[:, 2:3]), torch.sin(p[:, 2:3])
    G = grid.mean.shape[1]
    tot = None
    for g in range(G):
        part = _grid_sums(grid.origin[:, g], grid.mean[:, g],
                          grid.information[:, g], grid.count[:, g], cell, W,
                          H, spts, smask, p, c, s)
        part[0] = -part[0]
        if G == 1:
            tot = part
        else:  # sum(parts) from 0, as newton.py:58
            tot = [(0.0 if g == 0 else t) + q
                   for t, q in zip(tot or part, part)]
    if G > 1:
        n = torch.tensor(float(G), dtype=dt, device=dev)
        tot = [t / n for t in tot]
    return tot


def objective_grad_hess(grid: ndt_grid.NDTGrid, W: int, H: int, spts,
                        smask, pose):
    """newton.py::_objective_grad_hess at one pose [3]: (f, grad [3],
    hess [3, 3]).  grid fields [G, ...] or [...]; spts [B, 2], smask [B]."""
    g = with_row_grid_axes(grid, rows_axis=False)
    t = objective_sums(g, W, H, spts[None], smask[None], pose[None])
    t = [x[0] for x in t]
    hess = torch.stack([torch.stack([t[4], t[5], t[6]]),
                        torch.stack([t[5], t[7], t[8]]),
                        torch.stack([t[6], t[8], t[9]])])
    return t[0], torch.stack(t[1:4]), hess


def _swap(cond, x, y):
    return torch.where(cond, y, x), torch.where(cond, x, y)


def solve3(a, b):
    """x = A^-1 b for R systems at once, as the kernel's ``solve3``: LU
    with partial pivoting (the first largest |pivot|), forward elimination,
    then back substitution column by column.  a: 3 rows of 3 [R] tensors,
    b: 3 [R] tensors; returns x as 3 [R] tensors."""
    a = [list(row) for row in a]
    b = list(b)
    p1 = torch.abs(a[1][0]) > torch.abs(a[0][0])
    top = torch.where(p1, torch.abs(a[1][0]), torch.abs(a[0][0]))
    p2 = torch.abs(a[2][0]) > top
    # Swap row 0 with the pivot row: 2 if p2, else 1 if p1.
    s1 = p1 & ~p2
    for k in range(3):
        a[0][k], a[1][k] = _swap(s1, a[0][k], a[1][k])
        a[0][k], a[2][k] = _swap(p2, a[0][k], a[2][k])
    b[0], b[1] = _swap(s1, b[0], b[1])
    b[0], b[2] = _swap(p2, b[0], b[2])
    l1 = a[1][0] / a[0][0]
    l2 = a[2][0] / a[0][0]
    a[1][1] = a[1][1] - l1 * a[0][1]
    a[1][2] = a[1][2] - l1 * a[0][2]
    b[1] = b[1] - l1 * b[0]
    a[2][1] = a[2][1] - l2 * a[0][1]
    a[2][2] = a[2][2] - l2 * a[0][2]
    b[2] = b[2] - l2 * b[0]
    q = torch.abs(a[2][1]) > torch.abs(a[1][1])
    for k in range(1, 3):
        a[1][k], a[2][k] = _swap(q, a[1][k], a[2][k])
    b[1], b[2] = _swap(q, b[1], b[2])
    l = a[2][1] / a[1][1]
    a[2][2] = a[2][2] - l * a[1][2]
    b[2] = b[2] - l * b[1]
    x2 = b[2] / a[2][2]
    b0 = b[0] - x2 * a[0][2]
    b1 = b[1] - x2 * a[1][2]
    x1 = b1 / a[1][1]
    b0 = b0 - x1 * a[0][1]
    return [b0 / a[0][0], x1, x2]


def refine_beams(config, grid: ndt_grid.NDTGrid, spts, smask, start,
                 iterations: int):
    """newton.py::refine_pose over R rows: ``iterations`` damped Newton
    steps from start [R, 3] on subsampled beams spts [R, B, 2], smask
    [R, B]; grid fields [R, G, ...].  Returns (best poses [R, 3], best_f
    [R]): never worse than the start and never further from it than one
    lattice step per axis."""
    dev = spts.device
    W, H = config.grid_cells_x, config.grid_cells_y

    def f32(x):
        return ndt_grid.f32(x, dev)
    trust = torch.tensor([config.search_linear_resolution,
                          config.search_linear_resolution,
                          config.search_angular_resolution],
                         dtype=torch.float32, device=dev)
    cur = best = start
    best_f = torch.full_like(start[:, 0], float("inf"))
    for _ in range(iterations):
        t = objective_sums(grid, W, H, spts, smask, cur)
        # Levenberg damping (newton.py:147-148); jnp.maximum keeps a NaN.
        lam = f32(1e-3) * (((t[4] + t[7]) + t[9]) / f32(3.0)) + f32(1e-6)
        d = torch.where(lam < f32(1e-6), f32(1e-6), lam)
        x = solve3([[t[4] + d, t[5], t[6]], [t[5], t[7] + d, t[8]],
                    [t[6], t[8], t[9] + d]], [t[1], t[2], t[3]])
        step = -torch.stack(x, dim=1)
        step = torch.where(torch.isfinite(step), step,
                           torch.zeros_like(step))
        # Trust region around the start: one lattice step per axis.
        nxt = start + torch.minimum(torch.maximum((cur + step) - start,
                                                  -trust), trust)
        better = t[0] < best_f
        best = torch.where(better[:, None], cur, best)
        best_f = torch.where(better, t[0], best_f)
        cur = nxt
    # The last iterate was stepped to but not evaluated in the loop.
    f = objective_sums(grid, W, H, spts, smask, cur)[0]
    better = f < best_f
    return (torch.where(better[:, None], cur, best),
            torch.where(better, f, best_f))


def refine_pose(config, grid: ndt_grid.NDTGrid, spts, smask, pose,
                iterations: int):
    """newton.py::refine_pose at one pose [3] on beams spts [B, 2], smask
    [B]; grid fields [G, ...] or [...].  Returns (best pose [3], best_f)."""
    g = with_row_grid_axes(grid, rows_axis=False)
    best, best_f = refine_beams(config, g, spts[None], smask[None],
                                pose[None], iterations)
    return best[0], best_f[0]


def with_row_grid_axes(grid: ndt_grid.NDTGrid,
                       rows_axis: bool) -> ndt_grid.NDTGrid:
    """``grid``'s fields as [R, G, ...] views, adding the grid axis a
    single grid lacks and, unless ``rows_axis``, a row axis of 1."""
    single = grid.mean.dim() == (3 if rows_axis else 2)

    def f(t):
        if single:
            t = t.unsqueeze(1 if rows_axis else 0)
        return t if rows_axis else t[None]
    return ndt_grid.NDTGrid(origin=f(grid.origin), cell_size=grid.cell_size,
                            mean=f(grid.mean),
                            information=f(grid.information),
                            count=f(grid.count),
                            covariance=f(grid.covariance))
