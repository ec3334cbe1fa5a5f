"""The port's descriptor loop search (parallel/loop_search.py on K10's
twins) against ndt_2d_tpu's, and the analogues of tests/test_loop_search.py
on the port (all but the sharded search, which waits for the multi-device
slice).

Tolerances against the JAX package.  Bin indices (sector, ring, range bin)
are compared with the reference's own expressions run op by op: an ulp of
atan2 or of the norm moves a point across a bin edge, so at most
MAX_FLIPS of the fixture's points may change a bin, and every other
point's bins are equal; the five bin tables then differ by at most that
many counts.  Descriptors: cosine >= 0.9999 with the reference's and max
|difference| <= 1e-5, the reference again op by op: simulated beams sit at
regular angles, many of them on sector edges, and the jitted reference
rounds ``(atan2 + pi) / 2 pi * 64`` otherwise there (its descriptors fall
to cosine 0.92 against its own op-by-op ones on this fixture).  Searches: equal indices wherever the
neighbouring similarities differ by more than 1e-5, scores within 1e-5.
Ties go to the lower index, as ``jax.lax.top_k`` returns them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu.parallel import loop_search as jax_search
from ndt_2d_tpu.utils import sim
from ndt_2d_tpu_torch.config import MapperConfig, ScanMatcherConfig
from ndt_2d_tpu_torch.kernels import descriptor_search
from ndt_2d_tpu_torch.kernels import descriptors as k10
from ndt_2d_tpu_torch.mapping.mapper import Mapper
from ndt_2d_tpu_torch.parallel import loop_search

torch.set_num_threads(2)

# Points of the 13 x 256 fixture allowed to change a bin against JAX.
MAX_FLIPS = 4


def T(x):
    return torch.from_numpy(np.array(x))


def _scan_points(world, pose, n=256, range_max=12.0, seed=0):
    msg = sim.scan_at_pose(world, pose, n_beams=n, range_max=range_max,
                           noise=0.01, rng=np.random.default_rng(seed))
    return sim.project_scan(msg, 256)


LOOP = [[2.0, 2.0, 0.0], [6.0, 2.0, 0.0], [10.0, 2.0, 0.0],
        [14.0, 2.0, 1.5], [14.0, 6.0, 1.5], [14.0, 10.0, 1.5],
        [14.0, 14.0, 3.1], [10.0, 14.0, 3.1], [6.0, 14.0, 3.1],
        [2.0, 14.0, -1.5], [2.0, 10.0, -1.5], [2.0, 6.0, -1.5],
        [2.0, 2.2, 0.0]]  # index 12 revisits index 0


@pytest.fixture(scope="module")
def loop_scans():
    """Keyframes along a loop of the office: points [13, 256, 2], masks."""
    world = sim.make_office_world(16.0)
    scans = [_scan_points(world, p, seed=i) for i, p in enumerate(LOOP)]
    return np.stack([s[0] for s in scans]), np.stack([s[1] for s in scans])


@pytest.fixture(scope="module")
def loop_table(loop_scans):
    pts, msk = loop_scans
    return loop_search.descriptors(T(pts), T(msk), 12.0)


class TestDescriptors:
    def test_rotation_invariance(self):
        world = sim.make_office_world(16.0)
        p1, m1 = _scan_points(world, [5.0, 5.0, 0.0])
        p2, m2 = _scan_points(world, [5.0, 5.0, 2.1])  # same place, rotated
        d = loop_search.descriptors(T(np.stack([p1, p2])),
                                    T(np.stack([m1, m2])), 12.0)
        sim_ = float(d[0] @ d[1])
        assert sim_ > 0.98, f"rotated same-place similarity {sim_}"

    def test_distinct_places_differ(self):
        world = sim.make_office_world(16.0)
        scans = [_scan_points(world, pose) for pose in
                 ([2.0, 2.0, 0.0], [8.0, 8.0, 0.5], [8.0, 2.3, 3.0])]
        d = loop_search.descriptors(T(np.stack([s[0] for s in scans])),
                                    T(np.stack([s[1] for s in scans])),
                                    12.0).numpy()
        assert np.allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)
        s = d @ d.T
        assert s[0, 1] < 0.95 and s[0, 2] < 0.95 and s[1, 2] < 0.95

    def test_empty_scan_zero(self):
        d = loop_search.descriptors(torch.zeros(1, 16, 2),
                                    torch.zeros(1, 16, dtype=torch.bool),
                                    10.0)
        assert float(d.abs().sum()) == 0.0


class TestSearch:
    def test_dense_finds_revisit(self, loop_table):
        idx, scores = loop_search.search_dense(
            loop_table, torch.ones(13, dtype=torch.bool), 12, k=3,
            rolling_exclude=5)
        assert int(idx[0]) == 0, f"top candidate {idx[0]} (scores {scores})"
        assert float(scores[0]) > 0.97

    def test_rolling_window_excluded(self, loop_table):
        idx, scores = loop_search.search_dense(
            loop_table, torch.ones(13, dtype=torch.bool), 12, k=3,
            rolling_exclude=5)
        assert bool((idx[torch.isfinite(scores)] <= 7).all())


def random_table(seed=3, n=24, width=16, invalid_from=20):
    rng = np.random.default_rng(seed)
    desc = rng.normal(size=(n, width)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    valid = np.ones(n, bool)
    valid[invalid_from:] = False
    return desc, valid


class TestAllPairs:
    def test_matches_search_dense_per_row(self):
        """The one-launch all-pairs search reproduces the per-query search
        to the bit: every similarity adds in one order whatever the
        launch."""
        desc, valid = random_table()
        idx_all, score_all = loop_search.search_all_pairs(
            T(desc), T(valid), k=4, rolling_exclude=5)
        for q in range(24):
            idx_q, score_q = loop_search.search_dense(
                T(desc), T(valid), q, k=4, rolling_exclude=5)
            assert torch.equal(score_q, score_all[q])
            assert torch.equal(idx_q, idx_all[q])


class TestSearchKernelTwin:
    """``kernels/descriptor_search.py`` on the CPU (its twin)."""

    def test_top_k_against_brute_force(self):
        rng = np.random.default_rng(11)
        query = rng.normal(size=(7, 19)).astype(np.float32)
        keys = rng.normal(size=(40, 19)).astype(np.float32)
        keys[5] = keys[17] = keys[30]                  # exact ties
        valid = rng.random(40) > 0.2
        valid[[5, 17, 30]] = True
        limit = np.array([39, 30, 17, 4, 0, -1, 25], np.int32)
        idx, sc = descriptor_search.top_k(T(query), T(keys), T(valid),
                                          T(limit), 6)
        assert idx.dtype == torch.int64 and idx.shape == sc.shape == (7, 6)
        sims = query.astype(np.float64) @ keys.astype(np.float64).T
        for q in range(7):
            ok = valid & (np.arange(40) <= limit[q])
            ranked = sorted(np.nonzero(ok)[0],
                            key=lambda j: (-np.float32(sims[q, j]), j))
            n = min(len(ranked), 6)
            got = idx[q].numpy()
            assert np.isfinite(sc[q].numpy()).sum() == n
            np.testing.assert_allclose(sc[q].numpy()[:n],
                                       sims[q, got[:n]], atol=2e-6)
            assert set(got[:n]) <= set(np.nonzero(ok)[0])
            # Clear gaps give the brute-force order; the three copies come
            # out in ascending index.
            for a, b in zip(got[:n], ranked[:n]):
                if a != b:
                    assert abs(sims[q, a] - sims[q, b]) < 2e-6
            tied = [j for j in got[:n] if j in (5, 17, 30)]
            assert tied == sorted(tied)

    def test_similarities_add_in_index_order(self):
        query = np.array([[1e8, 1.0, -1e8, 1.0]], np.float32)
        keys = np.ones((1, 4), np.float32)
        got = descriptor_search.similarities_twin(T(query), T(keys))
        # ((1e8 + 1) - 1e8) + 1 in float32: the first 1 is absorbed.
        assert float(got[0, 0]) == 1.0

    @pytest.mark.parametrize("k", [0, 5])
    def test_k_outside_the_table_raises(self, k):
        desc, valid = random_table(n=4)
        with pytest.raises(ValueError, match="outside"):
            descriptor_search.top_k(T(desc), T(desc), T(valid),
                                    T(np.zeros(4, np.int32)), k)

    def test_searches_cap_k_at_the_table(self):
        desc, valid = random_table(n=4, invalid_from=4)
        idx, sc = loop_search.search_all_pairs(T(desc), T(valid), k=8,
                                               rolling_exclude=1)
        assert idx.shape == sc.shape == (4, 4)
        assert int(torch.isfinite(sc[3]).sum()) == 3


def test_spectra_twin_against_a_plain_dft(loop_scans):
    """``spectra`` (the twin, on the CPU) against the same formulas in
    float64 with numpy's FFT, within 5e-6: the float32 cos/sin tables take
    arguments up to 200 rad."""
    pts, msk = loop_scans
    bins = k10.bin_points(T(pts), T(msk), 12.0)
    ours = k10.spectra(bins, 12.0).numpy()
    b = [t.numpy().astype(np.float64) for t in bins]
    total = np.maximum(b[4], 1.0)[:, None]
    prof = b[1] / np.maximum(b[0], 1.0) / 12.0
    ring = (b[2] / total).reshape(-1, 4, 64)
    spec = np.abs(np.fft.fft(prof, axis=-1))[:, 1:33]
    ring_spec = np.abs(np.fft.fft(ring, axis=-1))[:, :, 1:33].reshape(
        len(prof), -1)
    hist = b[3] / total
    d = np.concatenate([spec, ring_spec,
                        hist - hist.mean(-1, keepdims=True)], -1)
    want = d / np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(ours, want, atol=5e-6)


# --- the port against the JAX package -------------------------------------

def jax_bin_indices(pts, range_max, n_sectors=64, n_rings=4, n_bins=32):
    """The reference's range and bin expressions
    (ndt_2d_tpu/parallel/loop_search.py:71, :86-88, :105-106, :119) op by
    op."""
    with jax.disable_jit():
        points = jnp.asarray(pts)
        r = jnp.linalg.norm(points, axis=-1)
        ang = jnp.arctan2(points[..., 1], points[..., 0])
        sec = jnp.clip(((ang + jnp.pi) / (2.0 * jnp.pi) * n_sectors)
                       .astype(jnp.int32), 0, n_sectors - 1)
        ring = jnp.clip((r / range_max * n_rings).astype(jnp.int32), 0,
                        n_rings - 1)
        b = jnp.clip((r / range_max * n_bins).astype(jnp.int32), 0,
                     n_bins - 1)
    return tuple(np.asarray(x) for x in (r, sec, ring, b))


def test_bin_indices_and_tables_match_jax(loop_scans):
    pts, msk = loop_scans
    rm = np.float32(12.0)
    r, sec, ring, b = k10.bin_indices(T(pts), 12.0, 64, 4, 32)
    jr, jsec, jring, jb = jax_bin_indices(pts, rm)
    np.testing.assert_allclose(r.numpy(), jr, rtol=3e-7, atol=0)
    flipped = ((sec.numpy() != jsec) | (ring.numpy() != jring)
               | (b.numpy() != jb)) & msk
    assert int(flipped.sum()) <= MAX_FLIPS
    # A flipped point lands in a neighbouring bin (sectors wrap).
    for ours, ref, n in ((sec.numpy(), jsec, 64), (ring.numpy(), jring, 0),
                         (b.numpy(), jb, 0)):
        d = np.abs(ours - ref)[flipped]
        assert np.all((d <= 1) | (d == n - 1))
    # The tables are those indices counted (and the ranges summed).
    bins = k10.bin_points(T(pts), T(msk), 12.0)
    S = pts.shape[0]
    want_sec = np.zeros((S, 64), np.float32)
    want_ring = np.zeros((S, 256), np.float32)
    want_hist = np.zeros((S, 32), np.float32)
    want_range = np.zeros((S, 64), np.float32)
    for s in range(S):
        for p in np.nonzero(msk[s])[0]:
            want_sec[s, jsec[s, p]] += 1
            want_ring[s, jring[s, p] * 64 + jsec[s, p]] += 1
            want_hist[s, jb[s, p]] += 1
            want_range[s, jsec[s, p]] += jr[s, p]
    n_flip = int(flipped.sum())
    assert np.abs(bins.sector_count.numpy() - want_sec).sum() <= 2 * n_flip
    assert np.abs(bins.ring_count.numpy() - want_ring).sum() <= 2 * n_flip
    assert np.abs(bins.hist.numpy() - want_hist).sum() <= 2 * n_flip
    np.testing.assert_array_equal(bins.total.numpy(), msk.sum(1))
    quiet = ~flipped.any(axis=1)
    np.testing.assert_allclose(bins.sector_range.numpy()[quiet],
                               want_range[quiet], rtol=1e-6, atol=1e-5)


def test_bin_twin_counts_masked_points_only():
    """Masked points count nowhere; points beyond range_max clip into the
    last ring and bin; the range sum adds in point order."""
    pts = np.zeros((2, 8, 2), np.float32)
    pts[0, :, 0] = [1.0, 2.0, 3.0, 50.0, 1.5, 0.0, 0.0, 0.0]
    pts[1, :, 1] = -1.0
    msk = np.zeros((2, 8), bool)
    msk[0, :5] = True
    bins = k10.bin_twin(T(pts), T(msk), 10.0, n_sectors=8, n_rings=2,
                        n_bins=4)
    assert bins.total.tolist() == [5.0, 0.0]
    assert float(bins.sector_count.sum()) == 5.0 == float(bins.hist.sum())
    assert float(bins.ring_count.sum()) == 5.0
    assert bins.sector_count[0, 4] == 5.0        # +x axis: sector n / 2
    want = np.float32(0)
    for v in (1.0, 2.0, 3.0, 50.0, 1.5):
        want = np.float32(want + np.float32(v))
    assert float(bins.sector_range[0, 4]) == float(want)
    assert bins.hist[0].tolist() == [3.0, 1.0, 0.0, 1.0]
    assert bins.ring_count[0, 8 + 4] == 1.0      # the 50 m point: ring 1
    assert float(bins.sector_range[1].abs().sum()) == 0.0


def test_descriptors_match_jax(loop_scans, loop_table):
    pts, msk = loop_scans
    with jax.disable_jit():
        ref = np.asarray(jax_search.descriptors(pts, msk, np.float32(12.0)))
    ours = loop_table.numpy()
    assert ours.shape == ref.shape == (13, 32 + 4 * 32 + 32)
    cos = (ours * ref).sum(1)
    assert cos.min() >= 0.9999
    assert np.abs(ours - ref).max() <= 1e-5
    # The padded capacity rows of a graph (no points) stay zero.
    padded = np.concatenate([pts, np.zeros((3, 256, 2), np.float32)])
    pmask = np.concatenate([msk, np.zeros((3, 256), bool)])
    d = loop_search.descriptors(T(padded), T(pmask), 12.0)
    assert torch.equal(d[:13], loop_table)
    assert float(d[13:].abs().sum()) == 0.0


def assert_same_ranking(idx, scores, ref_idx, ref_scores):
    """Equal scores within 1e-5 and equal indices wherever a slot's
    neighbours in the ranking are more than 1e-5 away."""
    idx, scores = np.asarray(idx), np.asarray(scores)
    ref_idx, ref_scores = np.asarray(ref_idx), np.asarray(ref_scores)
    finite = np.isfinite(ref_scores)
    np.testing.assert_array_equal(np.isfinite(scores), finite)
    np.testing.assert_allclose(scores[finite], ref_scores[finite], rtol=0,
                               atol=1e-5)
    gaps = np.abs(np.diff(ref_scores[finite]))
    clear = np.ones(int(finite.sum()), bool)
    clear[1:] &= gaps > 1e-5
    clear[:-1] &= gaps > 1e-5
    np.testing.assert_array_equal(idx[finite][clear], ref_idx[finite][clear])
    return int(clear.sum())


def test_searches_match_jax(loop_table):
    desc = loop_table.numpy()
    valid = np.ones(13, bool)
    valid[12:] = True
    ja_idx, ja_sc = jax_search.search_all_pairs(jnp.asarray(desc),
                                                jnp.asarray(valid), k=3,
                                                rolling_exclude=5)
    idx, sc = loop_search.search_all_pairs(T(desc), T(valid), k=3,
                                           rolling_exclude=5)
    compared = 0
    for q in range(13):
        compared += assert_same_ranking(idx[q], sc[q], ja_idx[q], ja_sc[q])
        jd_idx, jd_sc = jax_search.search_dense(
            jnp.asarray(desc), jnp.asarray(valid), q, k=3, rolling_exclude=5)
        d_idx, d_sc = loop_search.search_dense(T(desc), T(valid), q, k=3,
                                               rolling_exclude=5)
        assert_same_ranking(d_idx, d_sc, jd_idx, jd_sc)
    assert compared >= 15
    rdesc, rvalid = random_table()
    r_idx, r_sc = loop_search.search_all_pairs(T(rdesc), T(rvalid), k=4,
                                               rolling_exclude=5)
    j_idx, j_sc = jax_search.search_all_pairs(
        jnp.asarray(rdesc), jnp.asarray(rvalid), k=4, rolling_exclude=5)
    for q in range(24):
        assert_same_ranking(r_idx[q], r_sc[q], j_idx[q], j_sc[q])


def test_top_k_ties_go_to_the_lower_index():
    """Repeated scans and empty scans tie exactly: both searches return the
    lower index first, as ``jax.lax.top_k`` does."""
    desc = np.zeros((12, 4), np.float32)
    desc[[0, 3, 5, 11]] = [1.0, 0.0, 0.0, 0.0]    # four copies of one scan
    desc[[1, 2]] = [0.0, 1.0, 0.0, 0.0]
    valid = np.ones(12, bool)
    idx, sc = loop_search.search_dense(T(desc), T(valid), 11, k=4,
                                       rolling_exclude=2)
    j_idx, j_sc = jax_search.search_dense(jnp.asarray(desc),
                                          jnp.asarray(valid), 11, k=4,
                                          rolling_exclude=2)
    assert idx.tolist() == [0, 3, 5, 1] == np.asarray(j_idx).tolist()
    np.testing.assert_array_equal(sc.numpy(), np.asarray(j_sc))
    a_idx, a_sc = loop_search.search_all_pairs(T(desc), T(valid), k=4,
                                               rolling_exclude=2)
    ja_idx, ja_sc = jax_search.search_all_pairs(
        jnp.asarray(desc), jnp.asarray(valid), k=4, rolling_exclude=2)
    np.testing.assert_array_equal(a_sc.numpy(), np.asarray(ja_sc))
    finite = np.isfinite(np.asarray(ja_sc))
    np.testing.assert_array_equal(a_idx.numpy()[finite],
                                  np.asarray(ja_idx)[finite])
    assert a_idx[11].tolist() == [0, 3, 5, 1]


# --- union mode through the port's mapper (TestUnionMode) -----------------

def populated_mapper(mode):
    """A ring of keyframes whose tail revisits the start: radius finds the
    geometric neighbours, the permissive similarity threshold lets the
    descriptors propose as well."""
    world = sim.make_office_world(16.0)
    m160 = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
    cfg = MapperConfig(
        local_scan_matcher=m160, global_scan_matcher=m160,
        max_points_per_scan=512, loop_closure_every=10**9,
        global_search_size=4.0, global_search_limit=3,
        loop_search=mode, descriptor_min_similarity=0.5)
    mapper = Mapper(cfg, device="cpu")
    mapper.range_max = 12.0
    ang = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    poses = np.stack([8.0 + 3.0 * np.cos(ang), 8.0 + 3.0 * np.sin(ang),
                      ang + np.pi / 2], -1)
    poses = np.concatenate([poses, poses[:2]])  # revisit
    for t, p in enumerate(poses):
        msg = sim.scan_at_pose(world, p, n_beams=240, range_max=12.0,
                               noise=0.01, rng=np.random.default_rng(t))
        pts, msk = sim.project_scan(msg, 512)
        mapper.graph.add_scan(p, pts, msk)
    return mapper


def candidates(mapper, idx):
    g = mapper.graph
    table = valid = None
    if mapper.config.loop_search in ("descriptor", "both"):
        table = loop_search.descriptors(
            T(g.points_padded), T(g.point_mask_padded), mapper.range_max,
            mapper.config.descriptor_bins)
        valid = torch.arange(table.shape[0]) < g.num_scans
    return mapper._loop_candidates(idx, table, valid)


class TestUnionMode:
    def test_union_dedup_and_order(self):
        idx = 25  # revisit keyframe
        radius = candidates(populated_mapper("radius"), idx)
        desc = candidates(populated_mapper("descriptor"), idx)
        both = candidates(populated_mapper("both"), idx)
        assert radius, "radius source must propose (geometric revisit)"
        assert desc, "descriptor source must propose (permissive threshold)"
        assert both[:len(radius)] == radius
        assert set(both) == set(radius) | set(desc)
        assert len(both) == len(set(both))

    def test_union_covers_drifted_revisit(self):
        """With the pose estimate dragged outside the radius reach, the
        union still proposes the true revisit through the descriptor
        arm."""
        mapper = populated_mapper("both")
        g = mapper.graph
        idx = 25
        poses = g.poses.copy()
        poses[idx, :2] += 5.0  # > sqrt(global_search_size) = 2 m of drift
        g.set_poses(poses)
        both = candidates(mapper, idx)
        true_revisits = {idx - 24, (idx - 24) % 24 + 1}
        assert set(both) & true_revisits, (
            f"union missed the true revisit under drift: {both}")


@pytest.mark.parametrize("mode", ["radius", "descriptor", "both"])
def test_candidate_lists_match_the_jax_mapper(mode):
    """The same ring through both mappers' ``_loop_candidates``: equal
    lists for every query, in every mode (the JAX mapper is handed its
    descriptors computed op by op, see the module docstring)."""
    from ndt_2d_tpu.mapping.mapper import Mapper as JaxMapper
    from port_configs import to_jax
    ours = populated_mapper(mode)
    theirs = JaxMapper(to_jax(ours.config))
    theirs.range_max = 12.0
    g = ours.graph
    for i in range(g.num_scans):
        theirs.graph.add_scan(g.poses[i], g.points[i], g.point_mask[i])
    table = valid = None
    if mode != "radius":
        with jax.disable_jit():
            table = jax_search.descriptors(
                g.points_padded, g.point_mask_padded, np.float32(12.0),
                ours.config.descriptor_bins)
        valid = np.arange(g.points_padded.shape[0]) < g.num_scans
    for idx in range(ours.config.rolling_depth + 1, g.num_scans):
        assert (candidates(ours, idx)
                == theirs._loop_candidates(idx, table, valid)), idx
    if mode != "radius":
        assert ours._desc_sim.keys() == theirs._desc_sim.keys()
        for key, v in ours._desc_sim.items():
            assert v == pytest.approx(theirs._desc_sim[key], abs=1e-5)
