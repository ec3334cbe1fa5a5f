"""Far-candidate pruning of the port's mapper
(config.loop_closure_far_dedup / loop_closure_reject_cache_margin /
loop_closure_max_far_rows): the analogues of tests/test_far_pruning.py, the
per-pass spatial dedup, the similarity-ranked cap and the cross-pass
negative cache at the mechanism level.  The pruning is host code; every
scenario also runs through the JAX mapper, and the two must return the same
rows and counts.
"""

import numpy as np
import pytest
import torch

from ndt_2d_tpu.mapping.mapper import Mapper as JaxMapper
from ndt_2d_tpu_torch.config import MapperConfig, ScanMatcherConfig
from ndt_2d_tpu_torch.graph import pose_graph
from ndt_2d_tpu_torch.mapping.mapper import Mapper
from port_configs import to_jax

torch.set_num_threads(2)

MCFG = ScanMatcherConfig(grid_cells_x=96, grid_cells_y=96)


def line_config(**over):
    return MapperConfig(local_scan_matcher=MCFG, global_scan_matcher=MCFG,
                        max_points_per_scan=64, loop_search="descriptor",
                        global_search_size=1.0, loop_closure_every=10**9,
                        **over)


def fill_line(mapper):
    """40 keyframes on a line at 1 m spacing."""
    mapper.range_max = 10.0
    mapper._ensure_matchers(10.0)
    g = mapper.graph
    pts = np.zeros((64, 2), np.float32)
    mask = np.zeros(64, bool)
    mask[:8] = True
    for k in range(40):
        g.add_scan(np.asarray([float(k), 0.0, 0.0]), pts, mask)
        if k:
            pose_graph.make_constraint_np(g, k - 1, k,
                                          np.diag([1e-3, 1e-3, 1e-4]))
    return mapper


def make_mappers(**over):
    """(port mapper, JAX mapper) over the same line of keyframes."""
    cfg = line_config(**over)
    return (fill_line(Mapper(cfg, device="cpu")),
            fill_line(JaxMapper(to_jax(cfg))))


def make_mapper(**over):
    return fill_line(Mapper(line_config(**over), device="cpu"))


# (config change, pending rows, similarities, surviving rows, rows pruned)
PRUNE_CASES = {
    "off_by_default": (
        {}, [(30, [2, 3]), (31, [2])],
        {(30, 2): 0.9, (30, 3): 0.9, (31, 2): 0.9},
        [(30, [2, 3]), (31, [2])], 0),
    # Queries 30/31 (1 m apart) both propose candidates 2/3 (1 m apart):
    # one site pair, one surviving row, the most similar one.
    "dedup_keeps_one_row_per_site_pair": (
        dict(loop_closure_far_dedup=1.5), [(30, [2, 3]), (31, [2])],
        {(30, 2): 0.90, (30, 3): 0.95, (31, 2): 0.85}, [(30, [3])], 2),
    # Candidate 29 is within sqrt(global_search_size) = 1 m of query 30: a
    # near row, untouched by the far dedup.
    "near_rows_always_survive": (
        dict(loop_closure_far_dedup=1.5), [(30, [29, 2]), (31, [2])],
        {(30, 2): 0.9, (31, 2): 0.95}, [(30, [29]), (31, [2])], 1),
    # Distinct candidate sites: the cap keeps the most similar row.
    "cap_ranks_by_similarity": (
        dict(loop_closure_max_far_rows=1), [(30, [2, 20])],
        {(30, 2): 0.80, (30, 20): 0.99}, [(30, [20])], 1),
    # Candidates 2 and 20 are 18 m apart: both survive the dedup.
    "distinct_sites_survive_dedup": (
        dict(loop_closure_far_dedup=1.5), [(30, [2, 20])],
        {(30, 2): 0.9, (30, 20): 0.9}, [(30, [2, 20])], 0),
    # A far row without a similarity (radius-sourced) ranks first.
    "radius_far_rows_rank_first_in_prune": (
        dict(loop_closure_max_far_rows=1), [(30, [2]), (31, [3])],
        {(31, 3): 0.99}, [(30, [2])], 1),
}


@pytest.mark.parametrize("case", sorted(PRUNE_CASES))
def test_prune_far_pass(case):
    over, pending, sims, want, pruned = PRUNE_CASES[case]
    ours, theirs = make_mappers(**over)
    for m in (ours, theirs):
        m._desc_sim.update(sims)
    out = ours._prune_far_pass(pending)
    assert out == want
    assert ours.stats.far_rows_pruned == pruned
    assert theirs._prune_far_pass(pending) == out
    assert theirs.stats.far_rows_pruned == pruned


def test_prune_counts_each_row_once_across_restarts():
    mapper = make_mapper(loop_closure_max_far_rows=1)
    pending = [(30, [2]), (31, [3])]
    mapper._desc_sim[(30, 2)] = 0.9
    mapper._desc_sim[(31, 3)] = 0.8
    mapper._prune_far_pass(pending)
    first = mapper.stats.far_rows_pruned
    assert first == 1
    # A pass restart prunes the same rows again: no double count.
    mapper._prune_far_pass(pending)
    assert mapper.stats.far_rows_pruned == first


class TestRejectCache:
    def test_clear_rejection_populates_and_accept_clears(self):
        ours, theirs = make_mappers(loop_closure_reject_cache_margin=0.05)
        for mapper in (ours, theirs):
            g = mapper.graph
            idx, far_i = g.num_scans - 1, 2
            start = g.poses[idx].copy()
            # Clear rejection: score far above the (negative) gate.
            assert not mapper._apply_gate(idx, far_i, start, -0.01,
                                          np.zeros(3), np.eye(3) * 1e-3)
            assert mapper._far_key(idx, far_i) in mapper._reject_cache
            # A near rejection does not populate: only far rows are cached.
            assert not mapper._apply_gate(idx, idx - 1, start, -0.01,
                                          np.zeros(3), np.eye(3) * 1e-3)
            assert len(mapper._reject_cache) == 1
            # An acceptance invalidates the cache (the graph moved).
            assert mapper._apply_gate(idx, 3, start, -10.0,
                                      np.zeros(3), np.eye(3) * 1e-3)
            assert not mapper._reject_cache
        assert (list(ours.lc_log["decisions"])
                == list(theirs.lc_log["decisions"]))

    def test_borderline_rejection_not_cached(self):
        mapper = make_mapper(loop_closure_reject_cache_margin=0.10)
        g = mapper.graph
        idx = g.num_scans - 1
        gate = mapper.typical_matcher_response  # gate_scale = 1.0
        # Missed the gate by less than 10% of |gate|: not a clear miss.
        score = gate + 0.05 * abs(gate)
        assert not mapper._apply_gate(idx, 2, g.poses[idx].copy(), score,
                                      np.zeros(3), np.eye(3) * 1e-3)
        assert not mapper._reject_cache

    def test_cached_site_skipped_in_candidates(self):
        import jax.numpy as jnp
        ours, theirs = make_mappers(loop_closure_reject_cache_margin=0.05,
                                    descriptor_min_similarity=0.0)
        g = ours.graph
        idx = g.num_scans - 1
        # A descriptor table where candidate 2 would rank first.
        desc = np.zeros((g.points_padded.shape[0], 8), np.float32)
        desc[idx] = 1.0
        desc[2] = 1.0
        desc[20, 0] = 1.0
        valid = np.arange(len(desc)) < g.num_scans
        outs = []
        for mapper, table in ((ours, (torch.from_numpy(desc),
                                      torch.from_numpy(valid))),
                              (theirs, (jnp.asarray(desc),
                                        jnp.asarray(valid)))):
            assert 2 in mapper._loop_candidates(idx, *table)
            mapper._reject_cache[mapper._far_key(idx, 2)] = -0.01
            before = mapper.stats.far_rows_cache_skipped
            out = mapper._loop_candidates(idx, *table)
            assert 2 not in out
            assert mapper.stats.far_rows_cache_skipped == before + 1
            outs.append(out)
        assert outs[0] == outs[1]


def test_radius_candidates_consult_reject_cache():
    """A cached clearly rejected far site is skipped when the radius arm
    proposes it again.  The radius arm proposes a far row in the
    facing-each-other geometry: barycenters meet in the middle while the
    poses are far apart."""
    cfg = MapperConfig(local_scan_matcher=MCFG, global_scan_matcher=MCFG,
                       max_points_per_scan=64, loop_search="both",
                       global_search_size=25.0,    # squared: 5 m
                       loop_closure_every=10**9, global_search_limit=40,
                       loop_closure_reject_cache_margin=0.05)
    outs = []
    for mapper in (Mapper(cfg, device="cpu"), JaxMapper(to_jax(cfg))):
        mapper.range_max = 30.0
        mapper._ensure_matchers(30.0)
        g = mapper.graph
        fwd = np.zeros((64, 2), np.float32)
        fwd[:8] = [20.0, 0.0]          # beams 20 m ahead in the scan frame
        mask = np.zeros(64, bool)
        mask[:8] = True
        empty = np.zeros((64, 2), np.float32)
        # Candidate 0 at x = 2 facing +x: barycenter at x = 22.
        g.add_scan(np.asarray([2.0, 0.0, 0.0]), fwd, mask)
        # Filler keyframes far away in y (outside every search).
        for k in range(1, 12):
            g.add_scan(np.asarray([100.0 + k, 50.0, 0.0]), empty, mask)
        # Query at x = 39 facing -x: barycenter at x = 19 (3 m from the
        # candidate's; pose distance 37 m, a far row).
        g.add_scan(np.asarray([39.0, 0.0, np.pi]), fwd, mask)
        idx = g.num_scans - 1
        assert mapper._is_far(idx, 0)
        assert 0 in mapper._loop_candidates(idx, None, None)
        mapper._reject_cache[mapper._far_key(idx, 0)] = -0.01
        before = mapper.stats.far_rows_cache_skipped
        out = mapper._loop_candidates(idx, None, None)
        assert 0 not in out
        assert mapper.stats.far_rows_cache_skipped > before
        outs.append(out)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("positions,expect", [("barycenter", False),
                                              ("pose", True)])
def test_pose_mode_searches_pose_space(positions, expect):
    """Two scans whose barycenters are far apart but whose poses are
    adjacent: positions="pose" finds the candidate, barycenter mode does
    not."""
    cfg = MapperConfig(local_scan_matcher=MCFG, global_scan_matcher=MCFG,
                       max_points_per_scan=64,
                       global_search_size=4.0,   # squared: 2 m
                       loop_closure_every=10**9, rolling_depth=2,
                       loop_search_positions=positions)
    mapper = Mapper(cfg, device="cpu")
    mapper.range_max = 30.0
    mapper._ensure_matchers(30.0)
    g = mapper.graph
    pts = np.zeros((64, 2), np.float32)
    pts[:8] = [20.0, 0.0]    # beams 20 m ahead
    mask = np.zeros(64, bool)
    mask[:8] = True
    # The candidate faces +x, the query (a much later scan) -x from nearly
    # the same position: pose distance 0.5 m, barycenter distance 40 m.
    g.add_scan(np.asarray([0.0, 0.0, 0.0]), pts, mask)
    for k in range(1, 8):
        g.add_scan(np.asarray([100.0 + k, 50.0, 0.0]), pts, mask)
    g.add_scan(np.asarray([0.5, 0.0, np.pi]), pts, mask)
    idx = g.num_scans - 1
    out = mapper._loop_candidates(idx, None, None)
    assert (0 in out) == expect, (positions, out)
