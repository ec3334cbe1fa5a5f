"""The port's loop-closure confirmation and mapper pass against ndt_2d_tpu's.

Scenario: the revisiting office ring of tests/test_mapper_e2e.py (151
keyframes, 600 beams), restated here, with the 0.35 m global matcher,
``loop_closure_region_size=3`` and ``optimization_node_limit=10**9`` (the
setting the JAX package's own equivalence tests use to keep gate coin
flips and the chaotic LM solve out of a decision comparison).  The JAX
mapper maps the ring once; its graph then goes to a JAX and a port
loop-closure pass, so both decide on identical graph states.

Tolerances: decisions (accepted and rejected counts, constraint
begin/end/switchable) are equal.  Confirmation scores agree with op-by-op
JAX within 1e-5 (relative, with a 1e-5 floor) where both libraries'
float32 trig agrees, and corrections with op-by-op and jitted JAX (which
contracts FMAs) to 1e-6, the jitted lattice's own rounding, wherever a
row's best two candidates are more than 1e-4 |best| apart.  Inside the port, the three confirmation
paths and every padding of a row are bitwise equal.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu.config import MapperConfig, ScanMatcherConfig
from ndt_2d_tpu.mapping.mapper import Mapper as JaxMapper
from ndt_2d_tpu.matching import matcher as jax_matcher
from ndt_2d_tpu.utils import sim
from ndt_2d_tpu_torch.kernels import candidate_scores as k2
from ndt_2d_tpu_torch.kernels import ndt_build as k1
from ndt_2d_tpu_torch.mapping.mapper import Mapper
from ndt_2d_tpu_torch.matching import matcher

torch.set_num_threads(2)

RANGE_MAX = 12.0
GLOBAL = ScanMatcherConfig(
    ndt_resolution=0.35, search_linear_size=0.15,
    search_linear_resolution=0.01, search_angular_size=0.05,
    grid_cells_x=160, grid_cells_y=160)
LOCAL = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
CFG = MapperConfig(
    local_scan_matcher=LOCAL, global_scan_matcher=GLOBAL,
    max_points_per_scan=512, loop_closure_every=10**9,
    global_search_size=4.0, optimization_node_limit=10**9,
    loop_closure_region_size=3)


def office_ring(trans_noise=0.006, rot_noise=0.002):
    """The office-ring drive of tests/test_mapper_e2e.py: around the ring
    and past the first corner again."""
    world = sim.make_office_world(16.0)
    waypoints = [(2.0, 2.0, 0.0), (14.0, 2.0, np.pi / 2),
                 (14.0, 14.0, np.pi), (2.0, 14.0, -np.pi / 2),
                 (2.0, 2.6, 0.0), (8.0, 2.6, 0.0)]
    traj = []
    for a, b in zip(waypoints[:-1], waypoints[1:]):
        a, b = np.asarray(a, float), np.asarray(b, float)
        steps = max(int(np.hypot(*(b[:2] - a[:2])) / 0.35), 1)
        heading = np.arctan2(b[1] - a[1], b[0] - a[0])
        for s in range(steps):
            f = s / steps
            traj.append([a[0] + f * (b[0] - a[0]), a[1] + f * (b[1] - a[1]),
                         heading])
    truth = np.asarray(traj)
    odom = sim.drift_odometry(truth, trans_noise=trans_noise,
                              rot_noise=rot_noise, seed=11)
    return world, truth, odom


def scans(world, truth, n_beams=600):
    return [sim.scan_at_pose(world, truth[t], n_beams=n_beams,
                             range_max=RANGE_MAX, noise=0.01,
                             rng=np.random.default_rng(t))
            for t in range(len(truth))]


def port_from(jax_mapper, cfg):
    """A port mapper holding the JAX mapper's graph and tracking state."""
    m = Mapper(cfg, device="cpu")
    m._ensure_matchers(RANGE_MAX)
    m.graph = copy.deepcopy(jax_mapper.graph)
    m.typical_matcher_response = jax_mapper.typical_matcher_response
    m.prev_robot_pose = jax_mapper.prev_robot_pose.copy()
    m.prev_odom_pose = jax_mapper.prev_odom_pose.copy()
    return m


def outcome(m):
    g = m.graph
    return dict(begin=g.constraint_begin.copy(), end=g.constraint_end.copy(),
                switchable=g.constraint_switchable.copy(),
                poses=g.poses.copy(),
                accepted=m.stats.loop_closures_accepted,
                rejected=m.stats.loop_closures_rejected,
                reused=m.stats.confirm_rows_reused,
                decisions=list(m.lc_log["decisions"]))


@pytest.fixture(scope="module")
def mapped():
    """The JAX mapper after mapping the ring (no pass run yet)."""
    world, truth, odom = office_ring()
    jm = JaxMapper(CFG)
    for msg, o in zip(scans(world, truth), odom):
        jm.process_scan(msg, o)
    return jm


@pytest.fixture(scope="module")
def jax_pass(mapped):
    jm = copy.deepcopy(mapped)
    jm.loop_closure()
    return outcome(jm)


@pytest.fixture(scope="module")
def port_passes(mapped):
    """One port pass per confirmation path, each from the same graph."""
    paths = {"pipelined": {},
             "batched": dict(pipeline_loop_closure=False),
             "sequential": dict(batch_loop_closure=False)}
    out = {}
    for name, change in paths.items():
        m = port_from(mapped, dataclasses.replace(CFG, **change))
        m.loop_closure()
        out[name] = outcome(m)
    return out


def test_pass_decisions_match_jax(jax_pass, port_passes):
    ours = port_passes["pipelined"]
    assert jax_pass["accepted"] >= 1
    assert ours["accepted"] == jax_pass["accepted"]
    assert ours["rejected"] == jax_pass["rejected"]
    for f in ("begin", "end", "switchable"):
        np.testing.assert_array_equal(ours[f], jax_pass[f])
    assert ([d[:2] + d[4:] for d in ours["decisions"]]
            == [d[:2] + d[4:] for d in jax_pass["decisions"]])


@pytest.mark.parametrize("path", ["batched", "sequential"])
def test_confirmation_paths_bitwise_equal(port_passes, path):
    """Sequential (one window at a time), per-query batched and pipelined
    passes make the same decisions from bitwise-equal scores."""
    pipe, other = port_passes["pipelined"], port_passes[path]
    assert other["decisions"] == pipe["decisions"]
    for f in ("begin", "end", "switchable", "poses"):
        np.testing.assert_array_equal(other[f], pipe[f])


def test_row_reuse_fires_and_is_decision_neutral(port_passes):
    """Pass restarts reuse unchanged rows; the cache-free paths (above) make
    the same decisions."""
    assert port_passes["pipelined"]["reused"] > 0
    assert port_passes["sequential"]["reused"] == 0
    assert (port_passes["pipelined"]["decisions"]
            == port_passes["sequential"]["decisions"])


def confirmation_rows(jm, n_rows):
    """Inputs of the first ``n_rows`` (query, candidate) rows the JAX pass
    confirmed, built by the port mapper's own window code."""
    m = port_from(jm, CFG)
    g = m.graph
    rows = []
    for j in range(CFG.rolling_depth + 1, g.num_scans):
        rows += [(j, i) for i in m._loop_candidates(j)]
        if len(rows) >= n_rows:
            break
    rows = rows[:n_rows]
    cols = [[] for _ in range(8)]
    for j, i in rows:
        for c, v in zip(cols, m._candidate_window(
                i, j - CFG.rolling_depth) + (
                g.points[j], g.point_mask[j],
                np.int32(g.point_mask[j].sum()),
                g.poses[j].astype(np.float32))):
            c.append(v)
    return [np.stack(c) for c in cols]


def padded(arrays, pad):
    out = []
    for a in arrays:
        p = np.zeros((pad,) + a.shape[1:], a.dtype)
        p[:a.shape[0]] = a
        out.append(p)
    return out


def port_rows(arrays, with_scores=False):
    t = [torch.from_numpy(a) for a in arrays]
    if not with_scores:
        return matcher.match_scan_batch_multi(GLOBAL, *t[:4], RANGE_MAX,
                                              *t[4:])
    grid, tables = k1.build_windows(*t[:4], RANGE_MAX, GLOBAL.ndt_resolution,
                                    GLOBAL.grid_cells_x, GLOBAL.grid_cells_y)
    out, cand = k2.match_rows(GLOBAL, grid, tables, *t[4:],
                              *matcher._search_offsets(GLOBAL,
                                                       torch.device("cpu")),
                              with_scores=True)
    return k2.unpack(out), cand


def same_trig(theta):
    """Whether both libraries' float32 cos and sin agree at every angle."""
    th = np.asarray(theta, np.float32)
    t = torch.from_numpy(th)
    return bool(np.all((np.asarray(jnp.cos(th)) == torch.cos(t).numpy())
                       & (np.asarray(jnp.sin(th)) == torch.sin(t).numpy())))


def test_batch_multi_matches_jax_at_decision_level(mapped):
    """Scores against op-by-op JAX on the rows whose window poses' cos and
    sin agree bitwise in both libraries (elsewhere an ulp of rotation moves
    window points across cell edges and changes the region NDT itself);
    corrections against op-by-op and jitted JAX wherever the row's best
    two candidates are more than 1e-4 |best| apart."""
    arrays = confirmation_rows(mapped, 8)
    res, cand = port_rows(arrays, with_scores=True)
    args = (GLOBAL, *map(jnp.asarray, arrays[:4]), jnp.float32(RANGE_MAX),
            *map(jnp.asarray, arrays[4:]))
    jit_sc, jit_co, _ = jax.device_get(
        jax_matcher.match_scan_batch_multi(*args))
    with jax.disable_jit():
        op_sc, op_co, _ = jax.device_get(
            jax_matcher.match_scan_batch_multi(*args))
    poses, wmask = arrays[0], arrays[3]
    scored = decided = 0
    for r in range(8):
        if same_trig(poses[r][wmask[r]][:, 2]):
            np.testing.assert_allclose(float(res.score[r]), op_sc[r],
                                       rtol=1e-5, atol=1e-5)
            scored += 1
        top2 = torch.topk(cand[r].reshape(-1), 2, largest=False).values
        if float(top2[1] - top2[0]) > 1e-4 * abs(float(top2[0])):
            for ref in (op_co[r], jit_co[r]):
                np.testing.assert_allclose(res.correction[r].numpy(), ref,
                                           rtol=0, atol=1e-6)
            decided += 1
    assert scored >= 6 and decided >= 6
    assert float(res.score.max()) < -0.1


def test_row_is_independent_of_padding_and_batch(mapped):
    """A row's result is bitwise the same at pad 4 and pad 16 and equals a
    single-window build + match (the sequential path's R = 1 launch)."""
    arrays = confirmation_rows(mapped, 3)
    at4 = port_rows(padded(arrays, 4))
    at16 = port_rows(padded(arrays, 16))
    for a, b in zip(at4, at16):
        assert torch.equal(a[:3], b[:3])
    poses, pts, pmask, wmask, qp, qm, qn, st = [torch.from_numpy(a)
                                                for a in arrays]
    for r in range(3):
        grid, table = matcher.build_window_ndt(GLOBAL, poses[r], pts[r],
                                               pmask[r], wmask[r], RANGE_MAX)
        one = matcher.match_scan(GLOBAL, grid, qp[r], qm[r], int(qn[r]),
                                 st[r], packed_table=table)
        for a, b in zip(at16, one):
            assert torch.equal(a[r], b)


def test_padding_rows_never_pass_the_gate(mapped):
    """All-padding rows build an empty grid: score 0, no correction and the
    weak isotropic covariance, as the JAX program gives them."""
    arrays = padded(confirmation_rows(mapped, 1), 4)
    sc, co, cv = port_rows(arrays)
    jsc, jco, jcv = jax.device_get(jax_matcher.match_scan_batch_multi(
        GLOBAL, *map(jnp.asarray, arrays[:4]), jnp.float32(RANGE_MAX),
        *map(jnp.asarray, arrays[4:])))
    for r in range(1, 4):
        assert float(sc[r]) == 0.0 == float(jsc[r])
        np.testing.assert_array_equal(co[r].numpy(), np.zeros(3))
        np.testing.assert_array_equal(cv[r].numpy(), np.diag([1, 1, 0.25]))
        np.testing.assert_array_equal(cv[r].numpy(), jcv[r])
