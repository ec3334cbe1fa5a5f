"""K6's plain-PyTorch twin (kernels/candidate_gather.py) against the JAX
package's general scoring path, ``_candidate_scores_gather`` +
``reduce_candidates`` + ``finalize_match``.

Fixture: a 3-scan window of the office world (256-point scans with 1 cm
range noise, which keeps beams off the cell edges), a 64 x 64 grid of
0.5 m cells and a lattice of about 5 x 9 x 9 candidates over +-0.4 m, wider
than a cell, scored with 32 beams.

Tolerances.  Per-candidate scores against op-by-op JAX
(``jax.disable_jit``): 1e-6 relative with a 1e-6 floor (the twin adds a
candidate's beams in order from 0, XLA in its own order: a few ulps of the
sum), at the lattice angles where both libraries' float32 cos and sin agree
bitwise; equal argmin; correction and covariance within 1e-5.  Against the
jitted search (which contracts FMAs) on an NDT built op by op: equal
decisions, the correction within 1e-6 and the score within 1e-5 relative.  On a one-cell lattice K6's
twin and K2's compute the same function: equal argmin and corrections,
scores within 1e-5.  Inside the port, a row is bitwise the same at pad 4,
pad 16 and R = 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu.matching import matcher as jax_matcher
from ndt_2d_tpu.utils import sim
from ndt_2d_tpu_torch.config import ScanMatcherConfig
from ndt_2d_tpu_torch.kernels import candidate_gather as k6
from ndt_2d_tpu_torch.kernels import candidate_scores as k2
from ndt_2d_tpu_torch.kernels import ndt_build as k1
from ndt_2d_tpu_torch.matching import matcher
from port_configs import to_jax

torch.set_num_threads(2)

RANGE_MAX = 12.0
P = 256
WIDE = ScanMatcherConfig(
    ndt_resolution=0.5, search_linear_size=0.4, search_linear_resolution=0.1,
    search_angular_size=0.1, search_angular_resolution=0.05,
    grid_cells_x=64, grid_cells_y=64, laser_max_beams=32)
CPU = torch.device("cpu")


def T(x):
    return torch.from_numpy(np.array(x))


def scan(world, pose, seed):
    msg = sim.scan_at_pose(world, pose, n_beams=200, range_max=RANGE_MAX,
                           noise=0.01, rng=np.random.default_rng(seed))
    return sim.project_scan(msg, P)


@pytest.fixture(scope="module")
def window():
    """(poses [3, 3], points [3, P, 2], masks [3, P], window mask [3])
    and the query (points, mask, count) taken 0.5 m further on."""
    world = sim.make_office_world(16.0)
    poses = np.asarray([[5.0, 5.0, 0.1], [5.3, 5.1, 0.12], [5.6, 5.2, 0.15]],
                       np.float32)
    scans = [scan(world, p, i) for i, p in enumerate(poses)]
    q, qm = scan(world, [5.9, 4.7, 0.3], 9)
    return (poses, np.stack([s[0] for s in scans]),
            np.stack([s[1] for s in scans]), np.ones(3, bool),
            q, qm, int(qm.sum()))


STARTS = [(5.7, 4.9, 0.25), (6.1, 4.6, 0.33), (5.9, 4.7, 0.3)]


def port_match(cfg, window, start):
    poses, pts, msk, wm, q, qm, qn = window
    grid, table = matcher.build_window_ndt(cfg, T(poses), T(pts), T(msk),
                                           T(wm), RANGE_MAX)
    dths, dls = matcher._search_offsets(cfg, CPU)
    return k6.match_twin(cfg, grid, table, T(q), T(qm), qn,
                         torch.tensor(start, dtype=torch.float32), dths, dls)


def jax_grid(cfg, window):
    poses, pts, msk, wm = window[:4]
    return jax_matcher.build_window_ndt(to_jax(cfg), poses, pts, msk, wm,
                                        RANGE_MAX)


def same_trig(cfg, theta0):
    """[A] lattice angles whose float32 cos and sin agree in both."""
    th = (np.float32(theta0) + np.asarray(
        jax_matcher._search_offsets(to_jax(cfg))[0])).astype(np.float32)
    tt = torch.from_numpy(th)
    return ((np.asarray(jnp.cos(th)) == torch.cos(tt).numpy())
            & (np.asarray(jnp.sin(th)) == torch.sin(tt).numpy()))


@pytest.mark.parametrize("start", STARTS)
def test_scores_and_reduction_match_op_by_op_jax(window, start):
    res, cand = port_match(WIDE, window, start)
    jc = to_jax(WIDE)
    q, qm, qn = window[4:]
    pose = np.asarray(start, np.float32)
    with jax.disable_jit():
        grid = jax_grid(WIDE, window)
        spts, smask, used = jax_matcher.subsample(q, qm, jnp.int32(qn), 32)
        dths, dls = jax_matcher._search_offsets(jc)
        ref = np.asarray(jax_matcher._candidate_scores_gather(
            jc, grid, spts, smask, jnp.asarray(pose), dths, dls))
        best, corr, k, u, s = jax_matcher.reduce_candidates(
            jnp.asarray(ref), dths, dls)
        want = jax_matcher.finalize_match(best, corr, k, u, s, used)
    assert cand.shape == ref.shape == (WIDE.num_angles, WIDE.num_linear,
                                       WIDE.num_linear)
    assert ref.min() < -3.0          # the window explains the query
    ok = same_trig(WIDE, start[2])
    assert ok.sum() >= len(ok) - 1
    np.testing.assert_allclose(cand.numpy()[ok], ref[ok], rtol=1e-6,
                               atol=1e-6)
    assert int(cand.argmin()) == int(ref.argmin())
    np.testing.assert_allclose(res.correction.numpy(),
                               np.asarray(want.correction), rtol=0, atol=1e-5)
    np.testing.assert_allclose(res.covariance.numpy(),
                               np.asarray(want.covariance), rtol=0, atol=1e-5)
    assert float(res.score) == pytest.approx(float(want.score), rel=1e-6,
                                             abs=1e-6)


@pytest.mark.parametrize("start", STARTS)
def test_match_scan_agrees_with_jitted_jax(window, start):
    """``match_scan`` picks K6 for the wide lattice and decides as the
    jitted reference does."""
    poses, pts, msk, wm, q, qm, qn = window
    assert matcher.search_kernel(WIDE) is k6
    grid, table = matcher.build_window_ndt(WIDE, T(poses), T(pts), T(msk),
                                           T(wm), RANGE_MAX)
    res = matcher.match_scan(WIDE, grid, T(q), T(qm), qn,
                             torch.tensor(start, dtype=torch.float32),
                             packed_table=table)
    # The window NDT built op by op: the jitted build contracts FMAs in
    # the covariance of near-degenerate cells, which moves this score by
    # 0.7% before any search runs.
    with jax.disable_jit():
        jgrid = jax_grid(WIDE, window)
    ref = jax_matcher.match_scan(
        to_jax(WIDE), jgrid, q, qm, jnp.int32(qn),
        jnp.asarray(start, jnp.float32), RANGE_MAX)
    np.testing.assert_allclose(res.correction.numpy(),
                               np.asarray(ref.correction), rtol=0, atol=1e-6)
    assert float(res.score) == pytest.approx(float(ref.score), rel=1e-5)
    d = np.sqrt(np.abs(np.diag(np.asarray(ref.covariance))))
    assert np.all(np.abs(res.covariance.numpy() - np.asarray(ref.covariance))
                  <= 1e-4 * np.outer(d, d))


@pytest.mark.parametrize("grids", [1, 4])
def test_gather_equals_local_on_a_one_cell_lattice(window, grids):
    """Where 2 * search_linear_size <= ndt_resolution K6 and K2 compute
    the same function (matcher.py:222-223), with and without the grid
    axis."""
    cfg = dataclasses.replace(WIDE, search_linear_size=0.2,
                              search_linear_resolution=0.05,
                              overlapping_grids=grids == 4)
    assert matcher.search_kernel(cfg) is k2
    poses, pts, msk, wm, q, qm, qn = window
    grid, table = matcher.build_window_ndt(cfg, T(poses), T(pts), T(msk),
                                           T(wm), RANGE_MAX)
    assert table.dim() == (3 if grids == 4 else 2)
    dths, dls = matcher._search_offsets(cfg, CPU)
    args = (cfg, grid, table, T(q), T(qm), qn,
            torch.tensor(STARTS[0], dtype=torch.float32), dths, dls)
    a, ca = k6.match_twin(*args)
    b, cb = k2.match_twin(*args)
    np.testing.assert_allclose(ca.numpy(), cb.numpy(), rtol=0, atol=1e-5)
    assert int(ca.argmin()) == int(cb.argmin())
    assert torch.equal(a.correction, b.correction)
    np.testing.assert_allclose(a.covariance.numpy(), b.covariance.numpy(),
                               rtol=0, atol=1e-6)


def test_grid_axis_scores_the_mean_over_four_grids(window):
    """With overlapping grids the candidate score is the mean over the
    four grids, as op-by-op JAX's ``candidate_scores``; grid 0 alone gives
    the single-grid scores bitwise."""
    cfg = dataclasses.replace(WIDE, overlapping_grids=True)
    res, cand = port_match(cfg, window, STARTS[0])
    jc = to_jax(cfg)
    q, qm, qn = window[4:]
    with jax.disable_jit():
        grid = jax_grid(cfg, window)
        spts, smask, _ = jax_matcher.subsample(q, qm, jnp.int32(qn), 32)
        dths, dls = jax_matcher._search_offsets(jc)
        ref = np.asarray(jax_matcher.candidate_scores(
            jc, grid, spts, smask, jnp.asarray(STARTS[0], jnp.float32), dths,
            dls))
    ok = same_trig(cfg, STARTS[0][2])
    np.testing.assert_allclose(cand.numpy()[ok], ref[ok], rtol=1e-6,
                               atol=1e-6)
    assert int(cand.argmin()) == int(ref.argmin())
    # Grid 0 of the stacked build is the single grid.
    poses, pts, msk, wm = window[:4]
    g4, t4 = matcher.build_window_ndt(cfg, T(poses), T(pts), T(msk), T(wm),
                                      RANGE_MAX)
    _, single = port_match(WIDE, window, STARTS[0])
    spts, smask, _ = k2.subsample(T(q), T(qm), qn, 32)
    d, l = matcher._search_offsets(cfg, CPU)
    g0 = dataclasses.replace(g4, origin=g4.origin[0])
    first = k6.candidate_scores_gather(
        cfg, g0, spts, smask, torch.tensor(STARTS[0], dtype=torch.float32),
        d, l, t4[0])
    assert torch.equal(first, single)


def rows_of(window, n):
    """``n`` confirmation rows over the window: the same region, the query
    from a different start each."""
    poses, pts, msk, wm, q, qm, qn = window
    starts = np.asarray([STARTS[r % 3] for r in range(n)], np.float32)
    starts[:, 0] += 0.03 * np.arange(n)
    return [np.stack([a] * n) for a in (poses, pts, msk, wm, q, qm)] + [
        np.full(n, qn, np.int32), starts]


def padded(arrays, pad):
    out = []
    for a in arrays:
        p = np.zeros((pad,) + a.shape[1:], a.dtype)
        p[:a.shape[0]] = a
        out.append(p)
    return out


def batch(cfg, arrays):
    t = [torch.from_numpy(a) for a in arrays]
    return matcher.match_scan_batch_multi(cfg, *t[:4], RANGE_MAX, *t[4:])


@pytest.mark.parametrize("refine", [0, 4])
def test_rows_are_independent_of_padding_and_batch(window, refine):
    """Through ``match_scan_batch_multi`` (K1, K6 and, with refinement,
    K7's twins): a row's bits at pad 4, pad 16 and alone, and empty
    padding rows that score 0 with no correction and the weak isotropic
    covariance."""
    cfg = dataclasses.replace(WIDE, refine_iterations=refine)
    arrays = rows_of(window, 3)
    at4, at16 = batch(cfg, padded(arrays, 4)), batch(cfg, padded(arrays, 16))
    for a, b in zip(at4, at16):
        assert torch.equal(a[:3], b[:3])
    for r in range(3):
        one = batch(cfg, [a[r:r + 1] for a in arrays])
        for a, b in zip(at16, one):
            assert torch.equal(a[r], b[0])
    sc, co, cv = at16
    assert float(sc[:3].max()) < -0.05
    assert bool((sc[3:] == 0).all()) and bool((co[3:] == 0).all())
    for r in range(3, 16):
        np.testing.assert_array_equal(cv[r].numpy(), np.diag([1, 1, 0.25]))


def tiled_tree_sum(terms, tile):
    """K6's reduction lane by lane in numpy float32: per angle its
    candidates in zero-padded tiles; per tile 32-lane warps reduced by
    ``__shfl_down_sync`` steps, lane 0's sums of the warps added in order;
    then every (angle, tile) partial in order."""
    A, T_, K = terms.shape
    lanes = np.arange(32)
    total = None
    for a in range(A):
        for t0 in range(0, T_, tile):
            acc = None
            for w in range(t0, t0 + tile, 32):
                v = np.zeros((32, K), np.float32)
                n = max(0, min(32, T_ - w))
                v[:n] = terms[a, w:w + n]
                for off in (16, 8, 4, 2, 1):
                    v = v + v[np.where(lanes + off < 32, lanes + off, lanes)]
                acc = v[0] if acc is None else acc + v[0]
            total = acc if total is None else total + acc
    return total


@pytest.mark.parametrize("angles,cands", [(21, 1681), (5, 81), (3, 257)])
def test_twin_sums_in_the_kernels_order(angles, cands):
    terms = np.random.default_rng(cands).normal(
        size=(angles, cands, 10)).astype(np.float32)
    np.testing.assert_array_equal(
        k2._sum_as_kernel(torch.from_numpy(terms), k6.TILE).numpy(),
        tiled_tree_sum(terms, k6.TILE))


def test_wrapper_takes_the_twin_only_on_the_cpu(window):
    """On CPU tensors ``match`` and ``match_rows`` run the twin and count
    no launch; they return K2's [R, 13] rows."""
    poses, pts, msk, wm, q, qm, qn = window
    grid, table = matcher.build_window_ndt(WIDE, T(poses), T(pts), T(msk),
                                           T(wm), RANGE_MAX)
    dths, dls = matcher._search_offsets(WIDE, CPU)
    start = torch.tensor(STARTS[0], dtype=torch.float32)
    before = k6.launches
    out, cand = k6.match(WIDE, grid, table, T(q), T(qm), qn, start, dths,
                         dls, with_scores=True)
    res, want = k6.match_twin(WIDE, grid, table, T(q), T(qm), qn, start,
                              dths, dls)
    assert k6.launches == before
    assert out.shape == (1, 13) and torch.equal(cand, want)
    got = k2.unpack(out)
    assert torch.equal(got.score[0], res.score)
    assert torch.equal(got.correction[0], res.correction)
    assert torch.equal(got.covariance[0], res.covariance)
    grids, tables = k1.build_windows(T(poses)[None], T(pts)[None],
                                     T(msk)[None], T(wm)[None], RANGE_MAX,
                                     WIDE.ndt_resolution, 64, 64)
    rows = k6.match_rows(WIDE, grids, tables, T(q)[None], T(qm)[None],
                         torch.tensor([qn], dtype=torch.int32), start[None],
                         dths, dls)
    assert torch.equal(rows, out)
