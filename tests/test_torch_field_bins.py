"""K11's field plan and cluster build, and K10's sorted bins, on the CPU.

The cluster field (``csrc/correlative.cu::field_cluster``) and the bins'
counting sort (``csrc/descriptors.cu::bin_scans``) run only on the card.
Here numpy models of their blocks are held bitwise to the twins the
kernels are held to on the card: the field's stripes (each CTA's rows
with the RADIUS rows above and below, the x and y blurs in tap order, the
peak over the stripes' maxima, a zero cell kept as itself) against
``build_field_twin``, with points on the stripes' edges and off the grid;
the bins' ranks (each warp's run of points, 32 lanes at a time, sector
groups in lane order after the warps before) and each sector's chain from
+0 against ``bin_twin``.  ``field_plan`` and ``bins_plan`` are checked
exactly.  Against the JAX package op by op (``jax.disable_jit``): the
field within 1e-6 at the plan's shapes (the blur adds in another order
than XLA's convolution, as in test_torch_correlative.py) and the
descriptors of a table with a one-sector scan and an empty scan within
1e-5 (as in test_torch_loop_search.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu.matching import correlative as jax_correlative
from ndt_2d_tpu.parallel import loop_search as jax_search
from ndt_2d_tpu_torch.config import ScanMatcherConfig
from ndt_2d_tpu_torch.core import pose as pose_ops
from ndt_2d_tpu_torch.kernels import correlative as k11
from ndt_2d_tpu_torch.kernels import descriptors as k10
from ndt_2d_tpu_torch.parallel import loop_search
from ndt_2d_tpu_torch.utils import sim
from port_configs import to_jax

torch.set_num_threads(2)

RANGE, CELL = 4.0, 0.25
F32 = np.float32


def T(x):
    return torch.from_numpy(np.array(x))


# --- K11: the plan --------------------------------------------------------

@pytest.mark.parametrize("width,height,n,h", [
    (128, 128, 16, 8), (160, 160, 16, 10), (192, 192, 16, 12),
    (200, 150, 15, 10), (96, 40, 14, 3), (64, 3, 3, 1)])
def test_field_plan_takes_the_largest_cluster(width, height, n, h):
    """n = min(16, H) CTAs of ceil(H / n) rows, cut so that none is empty;
    the shared bytes are the staged scans and two windows of h + 6 rows."""
    plan = k11.field_plan(width, height, 132, scans=10)
    assert (plan.n, plan.h, plan.threads) == (n, h, k11.FIELD_THREADS)
    assert plan.smem == 16 * 10 + 16 * 3 + 8 * (h + 2 * k11.RADIUS) * width
    assert plan.n * plan.h >= height > (plan.n - 1) * plan.h
    assert plan.smem <= k11.FIELD_SHARED and plan.cluster


def test_field_plan_non_square_remainder():
    """H = 150 over 16 CTAs: stripes of 10 rows, 15 CTAs, H % n != 0 for
    the first choice; the last stripe full."""
    plan = k11.field_plan(200, 150, 132)
    assert 150 % 16 and (plan.n, plan.h) == (15, 10)
    plan = k11.field_stripes(200, 150, 8)
    assert 150 % 8 and (plan.n, plan.h) == (8, 19)
    assert 150 - 7 * 19 == 17


def test_field_plan_seven_step_past_shared_memory():
    """A stripe of 16 past the opt-in shared memory keeps the seven-step
    form; so does a window of 2^23 points; a cluster size that does not
    fit, or past 16, has no stripes."""
    last = k11.field_plan(1024, 352, 132)
    assert (last.n, last.h, last.smem) == (16, 22, 229376)
    assert last.smem <= k11.FIELD_SHARED < k11.field_shared(1024, 23)
    past = k11.field_plan(1024, 353, 132)
    assert not past.cluster and (past.n, past.smem) == (0, 0)
    assert not k11.field_plan(1024, 1024, 132).cluster
    assert not k11.field_plan(160, 160, 132, 10, k11.FIELD_POINTS).cluster
    assert k11.field_plan(160, 160, 132, 10, k11.FIELD_POINTS - 1).cluster
    assert k11.field_stripes(160, 160, k11.FIELD_PORTABLE).n == 8
    assert k11.field_plan(160, 160, 4).n == 4
    assert k11.field_stripes(1024, 1024, 16) is None
    assert k11.field_stripes(160, 160, 17) is None
    assert k11.field_stripes(160, 160, 0) is None
    with pytest.raises(ValueError):
        k11.field_plan(0, 16, 132)


# --- K11: a numpy model of the cluster's stripes ----------------------------

def window_points(width, height, seed):
    """Three poses (one at heading 0 with points exactly on row edges of
    the grid, two turned) and their points: on the stripes' edges, off the
    grid on every side, and random, some masked."""
    rng = np.random.default_rng(seed)
    poses = np.asarray([[0.0, 0.0, 0.0], [0.6, 0.4, 0.3],
                        [0.3, 0.9, -0.7]], F32)
    P = 256
    pts = np.zeros((3, P, 2), F32)
    # Heading 0 at (0, 0): world = robot frame, origin (-RANGE, -RANGE),
    # so y = -RANGE + r CELL lies exactly on row r's lower edge.
    rows = np.arange(height + 4) - 2
    pts[0, :len(rows), 1] = -RANGE + rows * CELL
    pts[0, :len(rows), 0] = rng.uniform(-RANGE - 1, -RANGE + width * CELL
                                        + 1, len(rows))
    pts[0, len(rows):, :] = rng.uniform(-RANGE - 1, -RANGE
                                        + max(width, height) * CELL + 1,
                                        (P - len(rows), 2))
    pts[1:] = rng.uniform(-RANGE, RANGE, (2, P, 2))
    mask = rng.random((3, P)) > 0.1
    return poses, pts, mask


def fmin(a, b):
    """The card's fminf: the smaller, -0 below +0."""
    zeros = (a == 0) & (b == 0)
    return np.where(zeros, np.where(np.signbit(a), a, b), np.minimum(a, b))


def model_origin(poses, wmask, range_max):
    """Each warp's shuffle tree of the lanes' minima over every 32nd live
    pose; a zero minimum folded again in scan order."""
    lanes = np.full((32, 2), np.finfo(F32).max, F32)
    for s in range(len(poses)):
        if wmask[s]:
            lanes[s % 32] = fmin(lanes[s % 32], poses[s, :2])
    off = 16
    while off:
        lanes = fmin(lanes, lanes[np.arange(32) ^ off])
        off //= 2
    m = lanes[0]
    if (m == 0).any():
        m = np.full(2, np.finfo(F32).max, F32)
        for s in range(len(poses)):
            if wmask[s]:
                m = fmin(m, poses[s, :2])
    return (m - F32(range_max)).astype(F32)


def model_cluster(plan, poses, pts, mask, wmask, range_max, cell):
    """The field and origin of ``field_cluster`` under ``plan``: CTA k
    counts the points of its window (rows [k h - 3, k h + rows + 3), those
    on the plane) after the multiplication prefilter, blurs along x over the
    window and along y over its stripe, each cell's 7 taps in index order
    from 0; the peak is the maximum of the stripes' maxima."""
    W, H, R = plan.width, plan.height, k11.RADIUS
    taps = k11.blur_taps(torch.device("cpu")).numpy()
    origin = model_origin(poses, wmask, range_max)
    w = pose_ops.transform_points(T(poses), T(pts)).numpy().reshape(-1, 2)
    live = (mask & wmask[:, None]).reshape(-1)
    d = (w - origin).astype(F32)
    iy_all = np.floor(d[:, 1] / F32(cell)).astype(np.int64)
    ix_all = np.floor(d[:, 0] / F32(cell)).astype(np.int64)
    fy = (d[:, 1] * (F32(1) / F32(cell))).astype(F32)
    stripes, maxima = [], []
    for k in range(plan.n):
        row0 = k * plan.h
        rows = max(0, min(plan.h, H - row0))
        lo, hi = max(row0 - R, 0), min(row0 + rows + R, H)
        inwin = live & (iy_all >= lo) & (iy_all < hi)
        passed = (fy >= lo - 1) & (fy < hi + 1)
        assert passed[inwin].all(), "the prefilter dropped a window point"
        ok = inwin & (ix_all >= 0) & (ix_all < W)
        hits = np.zeros((rows + 2 * R, W), np.int64)
        np.add.at(hits, (iy_all[ok] - row0 + R, ix_all[ok]), 1)
        v = np.pad(hits.astype(F32), ((0, 0), (R, R)))
        xb = np.zeros(hits.shape, F32)
        for q in range(2 * R + 1):
            xb = (xb + (taps[q] * v[:, q:q + W]).astype(F32)).astype(F32)
        yb = np.zeros((rows, W), F32)
        for q in range(2 * R + 1):
            yb = (yb + (taps[q] * xb[q:q + rows]).astype(F32)).astype(F32)
        stripes.append(yb)
        maxima.append(yb.max(initial=F32(0)))
    peak = np.maximum(F32(max(maxima)), F32(1e-6))
    field = np.concatenate(stripes)
    out = np.where(field == 0, field, (field / peak).astype(F32))
    return out.astype(F32), origin


@pytest.mark.parametrize("width,height,n", [
    (128, 128, None), (160, 160, None), (192, 192, None), (200, 150, None),
    (200, 150, 8), (40, 36, 16), (64, 3, None)])
def test_cluster_model_matches_the_twin(width, height, n):
    plan = (k11.field_plan(width, height, 132, scans=3) if n is None
            else k11.field_stripes(width, height, n, 3))
    poses, pts, mask = window_points(width, height, width + height)
    wmask = np.array([True, True, False])
    got, org = model_cluster(plan, poses, pts, mask, wmask, RANGE, CELL)
    want, worg = k11.build_field_twin(T(poses), T(pts), T(mask), T(wmask),
                                      RANGE, CELL, width, height)
    np.testing.assert_array_equal(org, worg.numpy())
    assert got.shape == (height, width)
    assert np.array_equal(got.view(np.uint32), want.numpy().view(np.uint32))
    assert float(want.max()) == 1.0


def test_field_launcher_keeps_its_taps():
    """The launch block holds the taps' address, so the launcher keeps the
    tensor: evicting it from ``blur_taps``' cache frees nothing the block
    points at."""
    cpu = torch.device("cpu")
    launcher = k11.FieldLauncher(k11.field_plan(64, 48, 132, 3, 3 * 8), 3,
                                 8, RANGE, CELL, cpu)
    k11.blur_taps.cache_clear()
    assert launcher.launch.taps == launcher.taps.data_ptr()
    assert torch.equal(launcher.taps, k11.blur_taps(cpu))
    assert launcher.taps is not k11.blur_taps(cpu)


def test_cluster_model_empty_window():
    """No live point: every stripe 0, the peak 1e-6, the field 0."""
    plan = k11.field_plan(64, 48, 132, scans=3)
    poses, pts, mask = window_points(64, 48, 1)
    got, _ = model_cluster(plan, poses, pts, np.zeros_like(mask),
                           np.ones(3, bool), RANGE, CELL)
    want, _ = k11.build_field_twin(T(poses), T(pts),
                                   torch.zeros(mask.shape, dtype=torch.bool),
                                   torch.ones(3, dtype=torch.bool), RANGE,
                                   CELL, 64, 48)
    assert not got.any() and not want.any()


@pytest.mark.parametrize("first", [True, False])
def test_zero_origin_sign_is_the_sequential_folds(first):
    """Poses at +0 and -0 with range_max 0: the warps' tree and its fold
    in scan order give field_origin's sequential fminf, -0 in either
    order; the twin's torch.amin takes the sign from the order."""
    zp = np.zeros((40, 3), F32)
    zp[0 if first else -1, :2] = -0.0
    org = model_origin(zp, np.ones(40, bool), 0.0)
    seq = np.full(2, np.finfo(F32).max, F32)
    for s in range(40):
        seq = fmin(seq, zp[s, :2])
    assert np.signbit(org).all() and np.signbit(seq).all()
    np.testing.assert_array_equal(org.view(np.uint32), seq.view(np.uint32))


# --- K10: a numpy model of the sorted bins ----------------------------------

def model_sector_ranges(points, point_mask, range_max, threads, n_sectors=64,
                        n_rings=4, n_bins=32):
    """[S, n_sectors] range sums as ``bin_scans`` forms them: warp w's
    points [w Q, w Q + Q), per-warp sector counts, each warp's base in a
    sector after the sectors before and the warps before, ranks 32 lanes
    at a time (a sector's lanes in lane order), then each sector's run
    added in order from +0."""
    r, sec, _, _ = k10.bin_indices(T(points), range_max, n_sectors, n_rings,
                                   n_bins)
    r, sec = r.numpy(), sec.numpy()
    S, P = point_mask.shape
    warps = threads // 32
    Q = -(-P // (32 * warps)) * 32
    out = np.zeros((S, n_sectors), F32)
    for s in range(S):
        secs = np.where(point_mask[s], sec[s], -1)
        counts = np.zeros((warps, n_sectors), np.int64)
        for w in range(warps):
            part = secs[w * Q:(w + 1) * Q]
            counts[w] = np.bincount(part[part >= 0], minlength=n_sectors)
        start = np.concatenate([[0], np.cumsum(counts.sum(0))[:-1]])
        base = start + np.cumsum(counts, 0) - counts
        sorted_r = np.zeros(int(counts.sum()), F32)
        for w in range(warps):
            for j in range(0, Q, 32):
                for lane in range(32):
                    p = w * Q + j + lane
                    if p < P and secs[p] >= 0:
                        a = secs[p]
                        sorted_r[base[w, a]] = r[s, p]
                        base[w, a] += 1
        for a in range(n_sectors):
            acc = F32(0)
            for v in sorted_r[start[a]:start[a] + counts[:, a].sum()]:
                acc = F32(acc + v)
            out[s, a] = acc
    return out


def office_scans(P, n=3):
    world = sim.make_office_world(16.0)
    rng = np.random.default_rng(7)
    scans = [sim.project_scan(sim.scan_at_pose(
        world, np.asarray([2.0 + 4 * i, 2.0 + 3 * i, 0.5 * i]), n_beams=360,
        range_max=12.0, noise=0.01, rng=rng), P) for i in range(n)]
    return (np.stack([s[0] for s in scans]).astype(F32),
            np.stack([s[1] for s in scans]))


def table_with_edges(P=512):
    """Three office scans, a scan with every point in one sector (the
    longest chain) and an all-masked scan."""
    pts, msk = office_scans(P)
    one = np.zeros((1, P, 2), F32)
    one[0, :, 0] = np.linspace(0.5, 11.5, P, dtype=F32)
    one[0, :, 1] = F32(0.1) * one[0, :, 0]
    empty = np.asarray(pts[:1]).copy()
    return (np.concatenate([pts, one, empty]),
            np.concatenate([msk, np.ones((1, P), bool),
                            np.zeros((1, P), bool)]))


@pytest.mark.parametrize("threads", k10.BIN_THREADS)
@pytest.mark.parametrize("P", [512, 200])
def test_sorted_bins_model_matches_the_twin(threads, P):
    pts, msk = table_with_edges(P)
    got = model_sector_ranges(pts, msk, 12.0, threads)
    want = k10.bin_twin(T(pts), T(msk), 12.0)
    assert np.array_equal(got.view(np.uint32),
                          want.sector_range.numpy().view(np.uint32))
    assert float(want.sector_count[3].max()) == P
    assert float(want.sector_range[4].abs().sum()) == 0.0
    assert float(want.total[4]) == 0.0


@pytest.mark.parametrize("S,threads", [(512, 256), (1056, 256), (1057, 128),
                                       (2048, 128)])
def test_bins_plan(S, threads):
    """Blocks of 256 while every block of the launch is resident at once
    (S x 256 <= 132 x 2048), else 128; the shared bytes as the kernel's."""
    plan = k10.bins_plan(S, 512)
    assert plan.threads == threads
    assert plan.smem == 12 * 512 + 4 * (64 * 5 + 32
                                        + (2 * threads // 32 + 1) * 64)


# The parent kernel's largest scan: 6 bytes a point and 353 counters
# within the default 48 KB of shared memory.
PARENT_MAX_POINTS = (48 * 1024 - 4 * (64 * 5 + 32 + 1)) // 6


@pytest.mark.parametrize("S", [512, 2048])
@pytest.mark.parametrize("P", [4096, 7000, PARENT_MAX_POINTS])
def test_bins_plan_takes_the_parents_scans(S, P):
    """Scans up to the parent's largest (7956 points) plan within the
    opt-in shared memory, past the default 48 KB from ~3,600 points on."""
    plan = k10.bins_plan(S, P)
    threads = 256 if S == 512 else 128
    assert plan.threads == threads
    assert plan.smem == 12 * P + 4 * (64 * 5 + 32
                                      + (2 * threads // 32 + 1) * 64)
    assert 48 * 1024 < plan.smem <= k10.BIN_SHARED


def test_bins_plan_refuses_past_shared_memory():
    assert k10.bins_plan(512, 18890).smem <= k10.BIN_SHARED
    with pytest.raises(ValueError):
        k10.bins_plan(512, 18891)
    with pytest.raises(ValueError):
        k10.bins_plan(2048, 19062)
    with pytest.raises(ValueError):
        k10.bins_plan(512, 512, n_sectors=0)


# --- Against the JAX package, op by op --------------------------------------

@pytest.mark.parametrize("width,height", [(128, 128), (160, 160),
                                          (192, 192), (200, 150)])
def test_field_twin_matches_op_by_op_jax(width, height):
    poses, pts, mask = window_points(width, height, 3)
    wmask = np.ones(3, bool)
    cfg = ScanMatcherConfig(grid_cells_x=width, grid_cells_y=height,
                            ndt_resolution=CELL)
    f, o = k11.build_field_twin(T(poses), T(pts), T(mask), T(wmask), RANGE,
                                CELL, width, height)
    with jax.disable_jit():
        jf, jo = jax_correlative.build_field(
            to_jax(cfg), jnp.asarray(poses), jnp.asarray(pts),
            jnp.asarray(mask), jnp.asarray(wmask), jnp.float32(RANGE))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0, atol=1e-6)


def test_descriptors_with_edge_scans_match_op_by_op_jax():
    pts, msk = table_with_edges(512)
    ours = loop_search.descriptors(T(pts), T(msk), 12.0).numpy()
    with jax.disable_jit():
        ref = np.asarray(jax_search.descriptors(pts, msk, np.float32(12.0)))
    assert ours.shape == ref.shape == (5, 32 + 4 * 32 + 32)
    assert np.abs(ours - ref).max() <= 1e-5
    assert not ours[4].any()
