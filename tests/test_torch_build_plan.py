"""The launch plans of K1 (the window NDT build) and K2 (the lattice
search), which the CPU can check: K1's ``build_plan`` and the placement of
its radix sort, K2's ``tile_plan`` and the order in which its reduction
folds an angle's candidates.  The kernels run only on the card, where
``chip_smoke.py`` holds each bitwise against its twin; here numpy models
of what the kernels do with a plan are held to ``torch.sort(stable=True)``
and to the twin's ``_block_sums`` / ``block_partials``.

Tolerances: none.  The placement is integer arithmetic, and the folded
candidate scores and lattice offsets are small integers in float32, so
every sum is exact and every comparison is bitwise.
"""

import numpy as np
import pytest
import torch

from ndt_2d_tpu_torch.kernels import candidate_scores as k2
from ndt_2d_tpu_torch.kernels import ndt_build as k1

torch.set_num_threads(2)


# --- K1 -------------------------------------------------------------------
def place(keys, plan):
    """numpy model of csrc/ndt_build.cu::sort_cells: the sorted position of
    every point, pass by pass.  A pass takes tiles of ``plan.tile`` points
    in order; warp w of a tile ranks its 32 * SORT_ITEMS points 32 at a
    time, each point after the earlier points of its digit in the warp
    (a running count, then the lower lanes); the warps' counts are added
    in warp order to the digit's base, which carries from tile to tile.
    Returns order [N]: order[s] = the index of the point sorted to s."""
    n = keys.shape[0]
    warps = k1.SORT_THREADS // 32
    seg = 32 * k1.SORT_ITEMS
    order = np.arange(n)
    k = keys.copy()
    for p in range(plan.digits):
        d = (k >> (k1.RADIX_BITS * p)) & ((1 << k1.RADIX_BITS) - 1)
        counts = np.bincount(d, minlength=256)
        base = np.concatenate([[0], np.cumsum(counts)[:-1]])
        dst = np.empty(n, np.int64)
        for t0 in range(0, n, plan.tile):
            wcnt = np.zeros((warps, 256), np.int64)
            rank = {}
            for w in range(warps):
                for m in range(k1.SORT_ITEMS):
                    lanes = np.arange(t0 + w * seg + m * 32,
                                      t0 + w * seg + m * 32 + 32)
                    lanes = lanes[lanes < n]
                    dd = d[lanes]
                    for j, i in enumerate(lanes):
                        same = int((dd[:j] == dd[j]).sum())
                        rank[i] = wcnt[w, dd[j]] + same
                    np.add.at(wcnt[w], dd, 1)
            prefix = np.cumsum(wcnt, axis=0) - wcnt
            for i, r in rank.items():
                w = (i - t0) // seg
                dst[i] = base[d[i]] + prefix[w, d[i]] + r
            base = base + wcnt.sum(axis=0)
        assert sorted(dst.tolist()) == list(range(n))
        inv = np.empty(n, np.int64)
        inv[dst] = np.arange(n)
        order, k = order[inv], k[inv]
    return order


def window_keys(kind, n, cells, seed):
    """Cell keys as the binning writes them: 0..cells - 1, or ``cells``
    for a point off the grid."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, cells + 1, size=n)
    if kind == "clustered":  # a scan's points: runs in few cells
        return np.minimum(cells, rng.integers(0, 40, size=n) * 97
                          + rng.integers(0, 3, size=n))
    if kind == "one cell":  # every valid point in one cell
        return np.where(rng.random(n) < 0.9, cells // 2, cells)
    return np.full(n, cells)  # no valid point


@pytest.mark.parametrize("kind,n,cells", [
    ("random", 5120, 36864), ("random", 4277, 25600),
    ("random", 9000, 70000), ("random", 700, 200),
    ("clustered", 8193, 36864), ("one cell", 38400, 18432),
    ("none", 4097, 36864), ("random", 0, 36864)])
def test_k1_placement_is_the_stable_sort(kind, n, cells):
    """The model's order is ``torch.sort(stable=True)``'s element by
    element: each cell's points in point-index order, the points off the
    grid (key C) last.  N runs over multiples of the tile and not; C
    over one, two and three digits."""
    plan = k1.build_plan(n, cells, 1)
    assert plan.digits * k1.RADIX_BITS >= cells.bit_length()
    keys = window_keys(kind, n, cells, seed=n + cells)
    order = place(keys, plan)
    want = torch.sort(torch.from_numpy(keys), stable=True).indices.numpy()
    np.testing.assert_array_equal(order, want)


@pytest.mark.parametrize("n,cells,rows", [
    (5120, 36864, 1), (5120, 25600, 64), (5120, 36864, 4),
    (38400, 18432, 1), (0, 4, 1), (37, 70000, 3)])
def test_k1_plan_covers_points_and_cells(n, cells, rows):
    """Every launch grid covers its points and cells, and the scratch
    regions are disjoint and hold rows x N (the sort's two buffers) and
    rows x C (the runs) elements each."""
    plan = k1.build_plan(n, cells, rows)
    assert plan.bin_blocks * k1.BLOCK_THREADS >= max(n, cells)
    assert (plan.bin_blocks - 1) * k1.BLOCK_THREADS < max(n, cells, 1)
    assert plan.cell_blocks * k1.BLOCK_THREADS >= cells
    assert plan.tile == k1.SORT_THREADS * k1.SORT_ITEMS
    assert 1 <= plan.digits <= k1.MAX_DIGITS
    assert (1 << (k1.RADIX_BITS * plan.digits)) > cells  # keys 0..C
    need = [rows * n] * 6 + [rows * cells] * 2
    ends = list(plan.offsets[1:]) + [plan.scratch]
    for name, start, end, size in zip(k1.SCRATCH, plan.offsets, ends,
                                      need):
        assert end - start >= size, name
    assert plan.offsets[0] == 0 and plan.scratch >= sum(need)


# --- K2 -------------------------------------------------------------------
def candidates_of(plan, L):
    """[(thread, lx, ly)] of every live candidate slot of the plan's block
    (csrc/candidate_scores.cu::score_angles): thread t = tx * nyg + ty
    takes dx rows tx + i * nxg and dy columns ty + j * nyg below L."""
    out = []
    for t in range(plan.threads):
        tx, ty = divmod(t, plan.nyg)
        for i in range(plan.kx):
            lx = tx + i * plan.nxg
            if tx >= plan.nxg or lx >= L:
                continue
            for j in range(plan.ky):
                ly = ty + j * plan.nyg
                if ly < L:
                    out.append((t, lx, ly))
    return out


def launch_bound(kx, ky):
    """csrc/candidate_scores.cu::tile_threads: a KX x KY block's most
    threads, the kernel's __launch_bounds__."""
    return ((31 + kx) // kx * ((31 + ky) // ky) + 31) // 32 * 32


SHAPES = [(80, 21, 1, 132), (40, 30, 64, 132), (20, 30, 64, 132),
          (40, 21, 1, 132), (512, 32, 1, 132), (512, 32, 64, 132),
          (80, 21, 4, 132), (126, 21, 1, 132), (3, 1, 1, 132),
          (7, 5, 2, 4), (1, 32, 1, 132), (5, 17, 3, 1)]


@pytest.mark.parametrize("A,L,R,sms", SHAPES)
def test_k2_tile_plan_covers_each_candidate_once(A, L, R, sms):
    """Every (dx, dy) of an angle is taken by exactly one (thread, slot)
    of its block, the block fits the kernel's launch bound, and a launch
    of fewer blocks than SMs takes one candidate a thread."""
    plan = k2.tile_plan(A, L, R, sms)
    assert (plan.kx, plan.ky) in k2.TILES
    assert plan.threads % 32 == 0
    assert plan.threads <= launch_bound(plan.kx, plan.ky)
    assert plan.nxg * plan.nyg <= plan.threads
    hits = np.zeros((L, L), np.int64)
    for _, lx, ly in candidates_of(plan, L):
        hits[lx, ly] += 1
    assert (hits == 1).all()
    if A * R < sms:
        assert (plan.kx, plan.ky) == (1, 1)


@pytest.mark.parametrize("tile", k2.TILES)
def test_k2_forced_tiles_cover_each_candidate_once(tile):
    """Each tile the kernel is built for covers config 2's, config 3's and
    the range edge's lattices exactly once, within its launch bound."""
    for A, L, R in ((40, 30, 64), (80, 21, 1), (512, 32, 1), (9, 1, 1)):
        plan = k2.tile_plan(A, L, R, 132, tile)
        assert plan.threads <= launch_bound(*tile)
        hits = np.zeros((L, L), np.int64)
        for _, lx, ly in candidates_of(plan, L):
            hits[lx, ly] += 1
        assert (hits == 1).all(), (tile, A, L, R)


@pytest.mark.parametrize("A,L,R,sms", [(80, 21, 1, 132), (40, 30, 1, 132),
                                       (512, 32, 1, 1024), (3, 1, 1, 132)])
def test_k2_one_candidate_plan_is_the_flat_layout(A, L, R, sms):
    """A launch of fewer blocks than SMs takes one candidate a thread, and
    thread t holds flat index t (nyg = L): the kernel folds those warps
    from registers, so a warp's lanes must be 32 consecutive flat
    indices, every live index below the block's thread count."""
    plan = k2.tile_plan(A, L, R, sms)
    assert (plan.kx, plan.ky, plan.nyg) == (1, 1, L)
    assert plan.threads >= L * L > plan.threads - 32
    for t, lx, ly in candidates_of(plan, L):
        assert lx * L + ly == t


def fold_angle(cand_s, L, ag, dls, dth):
    """numpy model of the reduction of one angle by its block:
    virtual warp w holds flat indices 32 w .. 32 w + 31 in lane order and
    is folded by the shuffle tree (lane l adds lane l + off, off = 16 ..
    1; the lower of equal scores keeps the lower index), then the warps in
    order.  Returns the partial [12] (best, index bits, 10 Olson sums)."""
    LL = L * L
    nw = -(-LL // 32)
    parts = []
    for w in range(nw):
        f = w * 32 + np.arange(32)
        live = f < LL
        v0 = np.where(live, cand_s[np.minimum(f, LL - 1)], np.float32(0))
        x0 = dls[np.where(live, f // L, 0)]
        x1 = dls[np.where(live, f % L, 0)]
        x2 = np.full(32, dth, np.float32)
        v = np.stack([v0, x0 * v0, x1 * v0, x2 * v0, x0 * x0 * v0,
                      x0 * x1 * v0, x0 * x2 * v0, x1 * x1 * v0,
                      x1 * x2 * v0, x2 * x2 * v0]).astype(np.float32)
        v[:, ~live] = 0
        best = np.where(live, v0, np.float32(np.inf)).astype(np.float32)
        idx = np.where(live, ag * LL + f, 2 ** 31 - 1)
        for off in (16, 8, 4, 2, 1):
            ob = np.concatenate([best[off:], best[32 - off:]])
            oi = np.concatenate([idx[off:], idx[32 - off:]])
            take = (ob < best) | ((ob == best) & (oi < idx))
            best, idx = np.where(take, ob, best), np.where(take, oi, idx)
            v = v + np.concatenate([v[:, off:], v[:, 32 - off:]], axis=1)
        parts.append((best[0], idx[0], v[:, 0]))
    b, i, s = parts[0]
    for pb, pi, ps in parts[1:]:
        if pb < b:
            b, i = pb, pi
        s = s + ps
    return np.concatenate([[b], np.array([i], np.int32).view(np.float32),
                           s]).astype(np.float32)


@pytest.mark.parametrize("A,L,R,sms", [(6, 21, 1, 132), (3, 30, 64, 132),
                                       (2, 32, 1, 132), (5, 7, 1, 4),
                                       (3, 1, 1, 132)])
def test_k2_fold_in_the_plan_layout_equals_block_sums(A, L, R, sms):
    """Integer-valued scores written by the plan's threads into the block's
    [L * L] layout and folded as the kernel folds them give the twin's
    ``block_partials`` (and so ``_block_sums``) bitwise, best and index
    included; a fold of a wrongly placed score would weigh it by another
    (dx, dy)."""
    rng = np.random.default_rng(A * 100 + L)
    plan = k2.tile_plan(A, L, R, sms)
    cand = -rng.integers(0, 60, size=(A, L, L)).astype(np.float32)
    cand[:, L // 2, L // 3] = -61.0  # the lowest, repeated across angles
    dls = (np.arange(L) - L // 2).astype(np.float32)
    dths = (np.arange(A) - A // 2).astype(np.float32)
    got = []
    for a in range(A):
        cand_s = np.full(L * L, np.nan, np.float32)
        for _, lx, ly in candidates_of(plan, L):
            cand_s[lx * L + ly] = cand[a, lx, ly]
        assert not np.isnan(cand_s).any()
        got.append(fold_angle(cand_s, L, a, dls, dths[a]))
    want = k2.block_partials(torch.from_numpy(cand), torch.from_numpy(dths),
                             torch.from_numpy(dls))
    np.testing.assert_array_equal(np.stack(got).view(np.int32),
                                  want.numpy().view(np.int32))
