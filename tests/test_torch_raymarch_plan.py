"""K5's ray-march design (``csrc/raymarch.cu``) as a numpy model, held
bitwise against the kernel's twin ``raymarch_counts_twin``.

The kernel finds each crossed cell of a ray once instead of walking all K
samples: along a ray each axis's cell index is monotone in the sample
index, so a thread jumps from one change of ix (or iy) to the next. It
estimates the sample of the next cell edge, then settles it by evaluating
the twin's float32 expression ``clamp(floor((s + d * t_k - o) / res))`` at
two candidate samples a round (the estimate and the one before it, then
the next two past the side it missed on, then thirds of the bracket)
until the first changed sample is bracketed. Each step advances the axis
whose change comes first. A ray's samples are cut into ``SEGMENTS`` runs,
a thread each; a run's first cell counts unless the sample before the run
lies in it. A block of ``BLOCK_RAYS`` consecutive rays counts into a
shared window of ``WINDOW`` x ``WINDOW`` cells around its first ray's
start (an empty and a hit count packed into a word) and flushes one
global atomic a touched count; cells outside the window go straight to
global memory.

The model runs the same search over all (ray, run) threads at once (one
numpy step a round) with the same float32 operations, so its counts, its
samples evaluated and its global atomics are the kernel's. Tolerance:
none; the counts are integers.

``python tests/test_torch_raymarch_plan.py`` prints the model's global
atomics, axis evaluations and longest warp chain at config 2's export
shape (the 200-scan corridor, 102,400 rays x 640 samples), beside the
one-thread-a-ray design's.
"""

import os
import sys

import numpy as np
import pytest
import torch

from ndt_2d_tpu_torch.kernels import raymarch

torch.set_num_threads(2)

F = np.float32


def axis_cells(s, d, o, res, n, j, K):
    """clamp(floor((s + d * t_j - o) / res), 0, n - 1) in float32, t_j =
    float(j) / float(K - 1) and t_{K-1} = 1: the twin's cell of sample j
    along one axis."""
    t = np.where(j == K - 1, F(1), j.astype(F) / F(K - 1)).astype(F)
    u = ((s + d * t) - o) / res
    return np.minimum(np.maximum(np.floor(u), F(0)),
                      np.asarray(n - 1).astype(F)).astype(np.int64)


def point_cells(p, o, res, n):
    """clamp(floor((p - o) / res), 0, n - 1) in float32: the twin's
    cell_of along one axis."""
    u = (np.asarray(p, F) - o) / res
    return np.minimum(np.maximum(np.floor(u), F(0)), F(n - 1)).astype(
        np.int64)


def next_change(s, d, o, res, n, scale, lo, cur, end, K):
    """For each item, the first sample j in (lo, end) whose axis cell
    differs from ``cur`` (the cell at lo), or ``end`` where none does, with
    that cell, the samples evaluated and the rounds taken (two samples a
    round, evaluated together).  ``scale`` = (K - 1) / d in float32.
    Rounds: the estimate c and c - 1; then the next two samples past the
    bracket's side the estimate missed on; then thirds of the bracket."""
    o = np.broadcast_to(np.asarray(o, F), lo.shape)
    n = np.broadcast_to(np.asarray(n, np.int64), lo.shape)
    hi = end.copy()
    vhi = cur.copy()
    probes = np.zeros(lo.shape, np.int64)
    rounds = np.zeros(lo.shape, np.int64)
    # A monotone index clamped into [0, n) cannot leave the edge it moves
    # towards, and d = 0 keeps it; no sample lies between lo and end.
    none = ((d == 0) | ((d > 0) & (cur >= n - 1)) | ((d < 0) & (cur <= 0))
            | (lo >= end - 1))
    edge = np.where(d > 0, cur + 1, cur).astype(F)
    with np.errstate(invalid="ignore"):
        est = (((o + edge * res) - s) * scale).astype(F)
    c = np.fmin(np.fmax(np.ceil(est), (lo + 1).astype(F)),
                (end - 1).astype(F))
    c = np.where(np.isfinite(c), c, F(0)).astype(np.int64)
    lo = lo.copy()
    active = ~none
    step = 0
    while active.any():
        i = np.nonzero(active)[0]
        L, Hh = lo[i], hi[i]
        if step < 2:
            j2 = np.minimum(np.maximum(c[i], L + 1), Hh - 1)
            j1 = np.maximum(j2 - 1, L + 1)
        else:
            j1 = L + (Hh - L) // 3
            j2 = L + 2 * (Hh - L) // 3
            j1 = np.minimum(np.maximum(j1, L + 1), Hh - 1)
            j2 = np.minimum(np.maximum(j2, j1), Hh - 1)
        v1 = axis_cells(s[i], d[i], o[i], res, n[i], j1, K)
        v2 = axis_cells(s[i], d[i], o[i], res, n[i], j2, K)
        m1, m2 = v1 != cur[i], v2 != cur[i]
        hi[i] = np.where(m1, j1, np.where(m2, j2, Hh))
        vhi[i] = np.where(m1, v1, np.where(m2, v2, vhi[i]))
        lo[i] = np.where(m1, L, np.where(m2, j1, j2))
        c[i] = np.where(m1, j1 - 1, j2 + 2)
        probes[i] += np.where(j1 == j2, 1, 2)
        rounds[i] += 1
        step += 1
        active[i] = hi[i] - lo[i] > 1
    return hi, vhi, probes, rounds


def march(starts, ends, mask, origin, res, W, H, K,
          segments=raymarch.SEGMENTS):
    """The crossed cells of every unmasked ray in order, each ray's samples
    cut into ``segments`` runs of about K / segments (a thread each):
    (ray, cell) int64 arrays, the end cells [R], the axis evaluations
    [R] (samples evaluated, one axis each; a segment's start and the
    sample before it, and the end's, two each included) and each thread's
    rounds and loop steps [R, segments] (its chain of dependent
    evaluations)."""
    starts = np.asarray(starts, F)
    ends = np.asarray(ends, F)
    ox, oy = F(origin[0]), F(origin[1])
    res = F(res)
    R = starts.shape[0]
    S = segments
    rays = np.nonzero(np.asarray(mask, bool))[0]
    end_cell = np.zeros(R, np.int64)
    end_cell[rays] = (point_cells(ends[rays, 0], ox, res, W)
                      + W * point_cells(ends[rays, 1], oy, res, H))
    evals = np.zeros(R, np.int64)
    chain = np.zeros((R, S), np.int64)
    ray = np.repeat(rays, S)
    seg = np.tile(np.arange(S), rays.size)
    k0 = seg * K // S
    k1 = (seg + 1) * K // S
    keep = k0 < k1
    ray, seg, k0, k1 = ray[keep], seg[keep], k0[keep], k1[keep]
    sx, sy = starts[ray, 0], starts[ray, 1]
    dx, dy = ends[ray, 0] - sx, ends[ray, 1] - sy
    with np.errstate(divide="ignore", invalid="ignore"):
        scx = (F(K - 1) / dx).astype(F)
        scy = (F(K - 1) / dy).astype(F)
    ix = axis_cells(sx, dx, ox, res, W, k0, K)
    iy = axis_cells(sy, dy, oy, res, H, k0, K)
    # A segment's first run continues the previous segment's where the
    # sample before it lies in the same cell.
    back = np.maximum(k0 - 1, 0)
    fresh = ((k0 == 0) | (axis_cells(sx, dx, ox, res, W, back, K) != ix)
             | (axis_cells(sy, dy, oy, res, H, back, K) != iy))
    np.add.at(evals, ray, np.where(k0 == 0, 4, 6))
    kx, vx, px, rx = next_change(sx, dx, ox, res, W, scx, k0, ix, k1, K)
    ky, vy, py, ry = next_change(sy, dy, oy, res, H, scy, k0, iy, k1, K)
    np.add.at(evals, ray, px + py)
    steps = rx + ry + 2
    out_r = [ray[fresh]]
    out_c = [(iy * W + ix)[fresh]]
    alive = np.ones(ray.shape, bool)
    while alive.any():
        a = np.nonzero(alive)[0]
        use_x = kx[a] <= ky[a]
        k = np.where(use_x, kx[a], ky[a])
        go = k < k1[a]
        alive[a] = go
        a, k, use_x = a[go], k[go], use_x[go]
        cur = np.where(use_x, vx[a], vy[a])
        kn, v, p, r = next_change(
            np.where(use_x, sx[a], sy[a]), np.where(use_x, dx[a], dy[a]),
            np.where(use_x, ox, oy), res, np.where(use_x, W, H),
            np.where(use_x, scx[a], scy[a]), k, cur, k1[a], K)
        ax, ay = a[use_x], a[~use_x]
        ix[ax], kx[ax], vx[ax] = cur[use_x], kn[use_x], v[use_x]
        iy[ay], ky[ay], vy[ay] = cur[~use_x], kn[~use_x], v[~use_x]
        np.add.at(evals, ray[a], p)
        steps[a] += r + 1
        done = np.minimum(kx[a], ky[a]) > k
        out_r.append(ray[a[done]])
        out_c.append((iy * W + ix)[a[done]])
    chain[ray, seg] = steps
    out_ray = np.concatenate(out_r)
    out_cell = np.concatenate(out_c)
    order = np.argsort(out_ray, kind="stable")
    return out_ray[order], out_cell[order], end_cell, evals, chain


def model_counts(starts, ends, mask, origin, res, W, H, K):
    """(hit, empty) int32 [H * W] of the model."""
    ray, cell, end_cell, _, _ = march(starts, ends, mask, origin, res, W,
                                      H, K)
    keep = cell != end_cell[ray]
    empty = np.bincount(cell[keep], minlength=W * H).astype(np.int32)
    m = np.asarray(mask, bool)
    hit = np.bincount(end_cell[m], minlength=W * H).astype(np.int32)
    return hit, empty


def global_atomics(starts, ends, mask, origin, res, W, H, K,
                   block=raymarch.BLOCK_RAYS, window=raymarch.WINDOW):
    """Global atomics of the kernel: per block of ``block`` rays, one per
    touched count (empty or hit) of a window cell, one per count outside
    the window.  Also the one-thread-a-ray design's (one per count)."""
    ray, cell, end_cell, evals, chain = march(starts, ends, mask, origin,
                                              res, W, H, K)
    m = np.asarray(mask, bool)
    keep = cell != end_cell[ray]
    kind = np.concatenate([np.zeros(int(keep.sum()), np.int64),
                           np.ones(int(m.sum()), np.int64)])
    cells = np.concatenate([cell[keep], end_cell[m]])
    rays = np.concatenate([ray[keep], np.nonzero(m)[0]])
    blk = rays // block
    s = np.asarray(starts, F)
    r0 = np.minimum(blk * block, s.shape[0] - 1)
    wx0 = point_cells(s[r0, 0], F(origin[0]), F(res), W) - window // 2
    wy0 = point_cells(s[r0, 1], F(origin[1]), F(res), H) - window // 2
    cx, cy = cells % W, cells // W
    inside = ((cx - wx0 >= 0) & (cx - wx0 < window) & (cy - wy0 >= 0)
              & (cy - wy0 < window))
    touched = np.unique(np.stack([blk[inside], kind[inside],
                                  cells[inside]]), axis=1).shape[1]
    # A warp's chain: its longest thread's (lanes are consecutive (ray,
    # segment) items).
    lanes = chain.reshape(-1)
    lanes = np.concatenate([lanes, np.zeros(-lanes.size % 32, np.int64)])
    return dict(window=int(touched + (~inside).sum()),
                per_count=int(cells.shape[0]), evals=int(evals.sum()),
                parent_evals=int(2 * K * m.sum() + 2 * m.sum()),
                longest_warp_chain=int(lanes.reshape(-1, 32).max(1).max()))


def twin_counts(starts, ends, mask, origin, res, W, H, K):
    t = torch.from_numpy
    hit, empty = raymarch.raymarch_counts_twin(
        t(np.ascontiguousarray(starts, F)), t(np.ascontiguousarray(ends, F)),
        t(np.asarray(mask, bool)), t(np.asarray(origin, F)), res, W, H, K)
    return hit.numpy(), empty.numpy()


def assert_model_is_twin(starts, ends, mask, origin, res, W, H, K):
    hit, empty = model_counts(starts, ends, mask, origin, res, W, H, K)
    th, te = twin_counts(starts, ends, mask, origin, res, W, H, K)
    np.testing.assert_array_equal(hit, th)
    np.testing.assert_array_equal(empty, te)
    return hit, empty


# --- Rays ---------------------------------------------------------------

ORIGIN = np.asarray([-3.2, -2.45], F)
W, H, RES = 128, 96, 0.05


def random_rays(seed, R=600, spread=6.0, length=4.0):
    rng = np.random.default_rng(seed)
    starts = rng.uniform(-2.0, spread - 2.0, (R, 2)).astype(F)
    ends = (starts + rng.uniform(-length, length, (R, 2))).astype(F)
    return starts, ends, rng.random(R) < 0.9


def axis_rays():
    """Rays with dx = 0 or dy = 0, in both directions, on and off cell
    edges, and zero-length rays."""
    s, e = [], []
    for x0 in (0.0, 0.025, 0.05, -1.3, 2.7):
        for dl in (1.7, -1.7, 0.05, -0.05, 3.1e-3):
            s += [(x0, 0.3), (0.3, x0)]
            e += [(x0 + dl, 0.3), (0.3, x0 + dl)]
    s += [(0.5, 0.5), (0.05, 0.1), (-3.2, -2.45)]
    e += [(0.5, 0.5), (0.05, 0.1), (-3.2, -2.45)]
    return np.asarray(s, F), np.asarray(e, F)


def edge_rays():
    """Rays clipped at every grid edge: out through each side and corner,
    starting outside the grid and crossing it, and lying wholly outside."""
    x_lo, y_lo = float(ORIGIN[0]), float(ORIGIN[1])
    x_hi, y_hi = x_lo + W * RES, y_lo + H * RES
    cx, cy = (x_lo + x_hi) / 2, (y_lo + y_hi) / 2
    s, e = [], []
    for tx, ty in ((x_lo - 1, cy), (x_hi + 1, cy), (cx, y_lo - 1),
                   (cx, y_hi + 1), (x_lo - 1, y_lo - 1), (x_hi + 1, y_hi + 1),
                   (x_lo - 1, y_hi + 1), (x_hi + 1, y_lo - 1)):
        s.append((cx, cy))
        e.append((tx, ty))
        s.append((tx, ty))
        e.append((cx + 0.3, cy - 0.2))
    s += [(x_lo - 2, y_lo - 1), (x_hi + 0.5, cy), (cx, y_hi + 3)]
    e += [(x_lo - 0.5, y_lo - 3), (x_hi + 2.5, cy + 1), (cx - 4, y_hi + 0.1)]
    return np.asarray(s, F), np.asarray(e, F)


def rounded_end_rays(count=6, seed=3):
    """Rays whose last sample, s + (e - s) * 1, lands in another cell than
    the end point itself: e on a cell edge, s chosen so the rounding of
    e - s and of s + (e - s) moves the sum across it."""
    rng = np.random.default_rng(seed)
    s, e = [], []
    while len(s) < count:
        m = rng.integers(5, W - 5)
        ex = F(ORIGIN[0] + F(m) * F(RES))
        sx = F(rng.uniform(-3.0, 3.0))
        back = F(sx + F(ex - sx))
        cell = np.floor((back - ORIGIN[0]) / F(RES))
        if cell != np.floor((ex - ORIGIN[0]) / F(RES)):
            sy = F(rng.uniform(-1.0, 1.0))
            s.append((sx, sy))
            e.append((ex, F(sy + F(0.37))))
    return np.asarray(s, F), np.asarray(e, F)


def config2_rays():
    """Config 2's export rays (chip_smoke.py::inputs): the 200-scan,
    600-beam corridor, 512 points a scan."""
    from ndt_2d_tpu_torch.config import MapperConfig, ScanMatcherConfig
    from ndt_2d_tpu_torch.io.bag import record_synthetic
    from ndt_2d_tpu_torch.mapping import laser, occupancy
    bag = record_synthetic("corridor", 200, n_beams=600, seed=0)
    m = ScanMatcherConfig(grid_cells_x=192, grid_cells_y=192)
    cfg = MapperConfig(local_scan_matcher=m, global_scan_matcher=m,
                       max_points_per_scan=512, loop_closure_every=10**9)
    pts, msk = zip(*[laser.project_scan(bag[t][0], bag.range_max,
                                        np.zeros(3), False, None,
                                        cfg.max_points_per_scan)
                     for t in range(200)])
    rays = occupancy.ray_batch(bag.odom, np.stack(pts), np.stack(msk),
                               cfg.resolution)
    return rays, cfg.resolution


@pytest.fixture(scope="module")
def config2():
    return config2_rays()


# --- Tests --------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_rays(seed):
    s, e, m = random_rays(seed)
    assert_model_is_twin(s, e, m, ORIGIN, RES, W, H, 256)


@pytest.mark.parametrize("K", [2, 3, 5, 64, 128, 640])
def test_sample_counts(K):
    s, e, m = random_rays(7, R=300)
    assert_model_is_twin(s, e, m, ORIGIN, RES, W, H, K)


def test_axis_aligned_and_zero_length_rays():
    s, e = axis_rays()
    hit, empty = assert_model_is_twin(s, e, np.ones(len(s), bool), ORIGIN,
                                      RES, W, H, 192)
    assert int(hit.sum()) == len(s)


def test_rays_clipped_at_every_edge():
    s, e = edge_rays()
    assert_model_is_twin(s, e, np.ones(len(s), bool), ORIGIN, RES, W, H, 512)


def test_masked_rays_count_nothing():
    s, e, _ = random_rays(4, R=200)
    m = np.zeros(200, bool)
    hit, empty = assert_model_is_twin(s, e, m, ORIGIN, RES, W, H, 128)
    assert hit.sum() == 0 and empty.sum() == 0
    m[::7] = True
    assert_model_is_twin(s, e, m, ORIGIN, RES, W, H, 128)


def test_rays_starting_outside_the_window():
    """Blocks whose rays start far from the block's first ray (outside its
    window), and far apart from each other."""
    rng = np.random.default_rng(5)
    R = 3 * raymarch.BLOCK_RAYS
    starts = rng.uniform(-3.0, 3.0, (R, 2)).astype(F)
    starts[::2] = [-3.0, -2.4]
    ends = (starts + rng.uniform(-3.0, 3.0, (R, 2))).astype(F)
    m = np.ones(R, bool)
    assert_model_is_twin(starts, ends, m, ORIGIN, RES, W, H, 256)
    a = global_atomics(starts, ends, m, ORIGIN, RES, W, H, 256)
    assert a["window"] <= a["per_count"]


def test_last_sample_cell_differs_from_the_end_cell():
    s, e = rounded_end_rays()
    K = 64
    t = np.float32(1)
    last = np.floor((s[:, 0] + (e[:, 0] - s[:, 0]) * t - ORIGIN[0])
                    / F(RES))
    end = np.floor((e[:, 0] - ORIGIN[0]) / F(RES))
    assert (last != end).all()
    assert_model_is_twin(s, e, np.ones(len(s), bool), ORIGIN, RES, W, H, K)


def test_config2_slice(config2):
    rays, res = config2
    sl = slice(40 * 512, 48 * 512)
    hit, empty = assert_model_is_twin(
        rays.starts[sl], rays.ends[sl], rays.mask[sl], rays.origin, res,
        rays.width, rays.height, rays.num_samples)
    assert rays.num_samples == 640 and empty.sum() > 0


@pytest.mark.parametrize("cut", [(0, 1), (1, 700), (255, 1537), (700, 2048)])
def test_contiguous_subsets(config2, cut):
    """Any contiguous run of rays (a mesh rank's shard) counts as the twin
    counts that run, and two runs add up to their union."""
    rays, res = config2
    base = 30 * 512
    a, b = cut
    args = (rays.origin, res, rays.width, rays.height, rays.num_samples)
    part = [slice(base + a, base + b), slice(base + b, base + 2048)]
    got = [assert_model_is_twin(rays.starts[p], rays.ends[p],
                                rays.mask[p], *args) for p in part]
    whole = twin_counts(rays.starts[base + a:base + 2048],
                        rays.ends[base + a:base + 2048],
                        rays.mask[base + a:base + 2048], *args)
    for k in (0, 1):
        np.testing.assert_array_equal(got[0][k] + got[1][k], whole[k])


def test_monotone_cells_visit_each_cell_once(config2):
    """The premise: along every ray each distinct cell comes in one run,
    so the twin's consecutive dedupe counts it once."""
    rays, res = config2
    sl = slice(100 * 512, 102 * 512)
    ray, cell, _, _, _ = march(rays.starts[sl], rays.ends[sl],
                               rays.mask[sl], rays.origin, res, rays.width,
                               rays.height, rays.num_samples)
    pairs = ray * (rays.width * rays.height) + cell
    assert np.unique(pairs).size == pairs.size


def test_atomics_and_evaluations_fall(config2):
    rays, res = config2
    sl = slice(0, 8 * 512)
    a = global_atomics(rays.starts[sl], rays.ends[sl], rays.mask[sl],
                       rays.origin, res, rays.width, rays.height,
                       rays.num_samples)
    assert a["window"] < a["per_count"] / 2
    assert a["evals"] < a["parent_evals"] / 4


def main() -> int:
    rays, res = config2_rays()
    args = (rays.starts, rays.ends, rays.mask, rays.origin, res, rays.width,
            rays.height, rays.num_samples)
    assert_model_is_twin(*args)
    a = global_atomics(*args)
    print(f"config 2 export, {rays.starts.shape[0]} rays x "
          f"{rays.num_samples} samples on {rays.width} x {rays.height}: "
          f"global atomics {a['window']} (blocks of {raymarch.BLOCK_RAYS} "
          f"rays, {raymarch.WINDOW}^2 windows) against {a['per_count']} "
          f"(one a count); axis evaluations {a['evals']} against "
          f"{a['parent_evals']} (two a sample); the longest warp's chain "
          f"{a['longest_warp_chain']} rounds and steps "
          f"({raymarch.SEGMENTS} threads a ray)")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main())
