"""Descriptor-mode and union-mode loop-closure passes of the port's mapper
against ndt_2d_tpu's, and the coarse-to-fine confirmation rows.

Scenario: the revisiting office ring of tests/test_mapper_e2e.py and
tests/test_loop_search.py::TestMapperIntegration (151 keyframes, 600 beams,
the 0.35 m global matcher), mapped once by the JAX mapper; its graph then
goes to a JAX and a port loop-closure pass under two configurations:

* ``descriptor``: appearance search only, with the levers of the
  ``office-descriptor`` recipe (gate 0.85, best-accept, 1.5 m separation,
  far dedup 2.5 m, reject-cache margin 0.10, at most 16 far rows a pass):
  without the cap the office's aliases make ~300 far rows, minutes on the
  CPU twins;
* ``union``: ``loop_search="both"`` with the ``drift`` recipe's levers
  (similarity floor 0.80) and 4 candidates an arm.

``optimization_node_limit=10**9`` keeps the chaotic LM solve out of the
comparison, as in tests/test_torch_loop_closure.py.

The office is 4-fold symmetric: a query's aliases tie in similarity within
1e-7, so the order of its top-k differs between the two packages' last
bits, and with it which alias the dedup keeps.  Both mappers are therefore
handed one top-k table, the port's (held to the reference's in
tests/test_torch_loop_search.py); everything downstream is each mapper's
own: candidate lists, the near/far split, pruning, coarse-to-fine and fine
confirmation, gates.

Tolerances: candidate lists, pruned and cache-skipped counts and
accept/reject decisions are equal; the scores of accepted rows within 3%
(an ulp between the two libraries' float32 cos and sin of a window pose
carries points across cell edges and changes the region NDT itself, and
the jitted reference builds it with contracted FMAs: 2.3% on one near row
here, where op-by-op JAX sits between the two; rejected alias rows sit on
flat score surfaces and differ by up to 4%); poses within 1e-4 m.  Coarse-to-fine rows against the jitted
reference: fine starts within 1e-5, scores within 5% or 0.005 (which rows
the pass takes depends on the last bits of tied similarities, and a weak
alias row scoring -0.04 moves by 0.003), equal gate decisions.
"""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu.mapping.mapper import Mapper as JaxMapper
from ndt_2d_tpu.matching import matcher as jax_matcher
from ndt_2d_tpu.parallel import loop_search as jax_search
from ndt_2d_tpu_torch.config import MapperConfig
from ndt_2d_tpu_torch.kernels import candidate_gather as k6
from ndt_2d_tpu_torch.matching import matcher
from ndt_2d_tpu_torch.parallel import loop_search
from port_configs import to_jax
from test_torch_loop_closure import (
    GLOBAL, LOCAL, RANGE_MAX, office_ring, outcome, port_from, scans)

torch.set_num_threads(2)

BASE = MapperConfig(
    local_scan_matcher=LOCAL, global_scan_matcher=GLOBAL,
    max_points_per_scan=512, loop_closure_every=10**9,
    global_search_size=4.0, optimization_node_limit=10**9,
    loop_closure_region_size=3)
PRUNING = dict(loop_closure_accept="best", loop_closure_max_separation=1.5,
               loop_closure_far_dedup=2.5,
               loop_closure_reject_cache_margin=0.10,
               loop_closure_max_far_rows=16)
CONFIGS = {
    "descriptor": dataclasses.replace(
        BASE, loop_search="descriptor", loop_closure_gate_scale=0.85,
        **PRUNING),
    "union": dataclasses.replace(
        BASE, loop_search="both", global_search_limit=4,
        descriptor_min_similarity=0.80, **PRUNING),
}


@pytest.fixture(scope="module")
def mapped():
    """The JAX mapper after mapping the ring (no pass run yet)."""
    world, truth, odom = office_ring()
    jm = JaxMapper(to_jax(BASE))
    for msg, o in zip(scans(world, truth), odom):
        jm.process_scan(msg, o)
    return jm


def port_top_k(graph, cfg):
    """The port's all-pairs top-k over ``graph``, as numpy."""
    table = loop_search.descriptors(
        torch.from_numpy(graph.points_padded),
        torch.from_numpy(graph.point_mask_padded), RANGE_MAX,
        cfg.descriptor_bins)
    valid = torch.arange(table.shape[0]) < graph.num_scans
    idx, sims = loop_search.search_all_pairs(
        table, valid, k=cfg.global_search_limit,
        rolling_exclude=cfg.rolling_depth + 1)
    return idx.numpy(), sims.numpy()


@pytest.fixture(scope="module")
def passes(mapped):
    """{mode: (JAX mapper, port mapper)} after one loop-closure pass each
    from the same graph."""
    out = {}
    for mode, cfg in CONFIGS.items():
        jm = copy.deepcopy(mapped)
        jm.config = to_jax(cfg)
        jm.local_matcher = None          # rebuild the matchers: the coarse
        jm._ensure_matchers(RANGE_MAX)   # one exists only in these modes
        top_k = port_top_k(jm.graph, cfg)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_search, "search_all_pairs",
                       lambda *a, **k: top_k)
            jm.loop_closure()
        pm = port_from(mapped, cfg)
        pm.loop_closure()
        np.testing.assert_array_equal(pm._desc_topk[0], top_k[0])
        out[mode] = (jm, pm)
    return out


@pytest.mark.parametrize("mode", sorted(CONFIGS))
def test_candidates_and_pruning_match_jax(passes, mode):
    jm, pm = passes[mode]
    ours = [c[:2] for c in pm.lc_log["candidates"]]
    assert ours == [c[:2] for c in jm.lc_log["candidates"]]
    assert any(len(c[1]) for c in ours)
    assert pm.stats.far_rows_pruned == jm.stats.far_rows_pruned > 0
    assert (pm.stats.far_rows_cache_skipped
            == jm.stats.far_rows_cache_skipped)
    assert pm.stats.confirm_rows_reused == jm.stats.confirm_rows_reused


@pytest.mark.parametrize("mode", sorted(CONFIGS))
def test_decisions_and_poses_match_jax(passes, mode):
    jm, pm = passes[mode]
    theirs, ours = outcome(jm), outcome(pm)
    assert ours["accepted"] == theirs["accepted"] >= 1
    assert ours["rejected"] == theirs["rejected"]
    # Per query the candidates face the gate in score order; rejected
    # near-tied rows may swap places, so compare the rows, not their order.
    assert (sorted(d[:2] + d[4:] for d in ours["decisions"])
            == sorted(d[:2] + d[4:] for d in theirs["decisions"]))
    for f in ("begin", "end", "switchable"):
        np.testing.assert_array_equal(ours[f], theirs[f])
    np.testing.assert_allclose(
        sorted(d[:3] for d in ours["decisions"] if d[4]),
        sorted(d[:3] for d in theirs["decisions"] if d[4]), rtol=3e-2,
        atol=0)
    np.testing.assert_allclose(ours["poses"], theirs["poses"], rtol=0,
                               atol=1e-4)
    # Both drift classes were confirmed: near rows on the fine lattice,
    # far rows coarse-to-fine.
    far = [pm._is_far(d[0], d[1]) for d in sorted(ours["decisions"])]
    assert any(far) and not all(far)
    assert far == [jm._is_far(d[0], d[1])
                   for d in sorted(theirs["decisions"])]


def test_descriptor_loop_closure_e2e(passes):
    """The office loop closes under loop_search="descriptor", and an
    accepted closure marks the device rolling window stale."""
    _, pm = passes["descriptor"]
    assert int(pm.graph.constraint_switchable.sum()) >= 1
    assert pm._window_synced == -1
    assert matcher.search_kernel(pm.coarse_matcher.config) is k6


@pytest.mark.parametrize("path", ["batched", "sequential"])
def test_confirmation_paths_agree(mapped, passes, path):
    """The per-query batched and the sequential (one window at a time,
    coarse matcher then global matcher) paths decide as the pipelined pass
    does, from bitwise-equal scores."""
    change = (dict(pipeline_loop_closure=False) if path == "batched"
              else dict(batch_loop_closure=False))
    cfg = dataclasses.replace(CONFIGS["descriptor"], **change)
    m = port_from(mapped, cfg)
    # Without the pipelined pass there is no per-pass pruning: confirm only
    # the rows the pipelined pass confirmed.
    pipe = outcome(passes["descriptor"][1])
    rows = {}
    for d in pipe["decisions"]:
        rows.setdefault(d[0], []).append(d[1])
    first = min(rows)
    m._ensure_matchers(RANGE_MAX)
    before = len(m.lc_log["decisions"])
    m._confirm_candidates(first, rows[first])
    got = list(m.lc_log["decisions"])[before:]
    want = [d for d in pipe["decisions"] if d[0] == first][:len(got)]
    assert got == want


def far_rows(pm, n):
    """Inputs of the first ``n`` far rows the port's pass decided, built by
    the port mapper's own window code at the pre-pass graph."""
    rows = [d[:2] for d in pm.lc_log["decisions"] if pm._is_far(d[0], d[1])]
    return rows[:n]


def test_coarse_fine_rows_match_jax(mapped, passes):
    cfg = CONFIGS["descriptor"]
    m = port_from(mapped, cfg)
    rows = far_rows(passes["descriptor"][1], 6)
    assert len(rows) == 6
    g = m.graph
    cols = [[] for _ in range(8)]
    for j, i in rows:
        start, coarse = m._candidate_start(j, i, True)
        assert coarse
        for c, v in zip(cols, m._candidate_window(
                i, j - cfg.rolling_depth) + (
                g.points[j], g.point_mask[j],
                np.int32(g.point_mask[j].sum()), start.astype(np.float32))):
            c.append(v)
    arrays = []
    for c in cols:
        a = np.stack(c)
        p = np.zeros((8,) + a.shape[1:], a.dtype)
        p[:6] = a
        arrays.append(p)
    t = [torch.from_numpy(a) for a in arrays]
    before = k6.launches
    fst, sc, co, cv = matcher.match_scan_batch_multi_coarse_fine(
        cfg.coarse_scan_matcher, GLOBAL, *t[:4], RANGE_MAX, *t[4:])
    assert k6.launches == before          # CPU tensors: the twins
    jfst, jsc, jco, jcv = (np.asarray(x) for x in
                           jax_matcher.match_scan_batch_multi_coarse_fine(
        to_jax(cfg.coarse_scan_matcher), to_jax(GLOBAL),
        *map(jnp.asarray, arrays[:4]), jnp.float32(RANGE_MAX),
        *map(jnp.asarray, arrays[4:])))
    np.testing.assert_allclose(fst.numpy(), jfst, rtol=0, atol=1e-5)
    # The coarse stage moved the far starts, by whole lattice steps.
    moved = np.abs(fst.numpy()[:6] - arrays[7][:6])
    assert moved.max() > 0.09
    # Rejected alias rows on NDTs the jitted reference builds with
    # contracted FMAs: the scores agree to 5% or, on the weakest rows
    # (scores near -0.04, a fifth of the gate), to 0.005; the decisions are
    # equal.
    np.testing.assert_allclose(sc.numpy(), jsc, rtol=5e-2, atol=5e-3)
    gate = m.typical_matcher_response * cfg.loop_closure_gate_scale
    np.testing.assert_array_equal(sc.numpy() < gate, jsc < gate)
    # Padding rows: score 0, start unchanged, the weak covariance.
    assert bool((sc[6:] == 0).all()) and torch.equal(fst[6:], t[7][6:])
    np.testing.assert_array_equal(cv[7].numpy(), np.diag([1, 1, 0.25]))
    # A row alone gives the same bits as in the batch.
    one = matcher.match_scan_batch_multi_coarse_fine(
        cfg.coarse_scan_matcher, GLOBAL, *[x[2:3] for x in t[:4]],
        RANGE_MAX, *[x[2:3] for x in t[4:]])
    for a, b in zip((fst, sc, co, cv), one):
        assert torch.equal(a[2], b[0])
