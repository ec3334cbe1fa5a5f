"""The port's stripe-sharded NDT map (``parallel/ndt_blocks.py``, kernels
KB1-KB3) against the JAX package's ``parallel/ndt_blocks.py``.

Fixture: tests/test_ndt_blocks.py's 4-scan box window on 128 x 128 cells,
its query scans, pose and 16 particles.  The port runs on gloo meshes of
2 and 4 ranks, (space, batch) = (2, 1), (4, 1), (1, 2) and (2, 2), spawned
once for the module (tests/torch_blocks_ranks.py, one torch thread a rank).

References and tolerances:
* the port's dense single-device build, K3 and K6 twins: every stripe is
  bitwise its rows of the dense build, the gathered stripes are the dense
  grid; at space = 1 the score, the particle weights and the match are the
  dense K3 / K6 results bitwise; every rank holds the same bits;
* JAX's stripe math run op by op (``jax.disable_jit``; the bodies of
  ndt_blocks.py's shard_maps for each stripe index, ``psum`` as a sum over
  the stripes), at tests/test_ndt_blocks.py's tolerances: the build's
  counts equal, means within 1e-5, information within rtol 2e-4 /
  atol 1e-3; the score within rtol 1e-5; the weights within rtol 1e-5 /
  atol 1e-6; the match's score within rtol 1e-5, correction within 1e-6,
  covariance within rtol 1e-4 / atol 1e-6.  JAX's eager shard_map takes
  ~40 s a mesh shape on this CPU, its op-by-op bodies a few seconds;
* JAX's ``ndt_blocks`` functions themselves, jitted on a JAX mesh of the
  same shape (XLA contracts FMAs, so the fixture's noise-free beams may
  bin otherwise): equal match decisions, the score within 2e-3 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu.config import ScanMatcherConfig as JaxScanMatcherConfig
from ndt_2d_tpu.core import pose as jax_pose
from ndt_2d_tpu.matching import matcher as jax_matcher
from ndt_2d_tpu.ndt import grid as jax_grid
from ndt_2d_tpu.parallel import mesh as jax_mesh
from ndt_2d_tpu.parallel import ndt_blocks as jax_blocks
from ndt_2d_tpu_torch.kernels import candidate_gather as k6
from ndt_2d_tpu_torch.kernels import candidate_scores as k2
from ndt_2d_tpu_torch.kernels import score_points as k3
from ndt_2d_tpu_torch.ndt import grid as ndt_grid
from ndt_2d_tpu_torch.parallel import ndt_blocks

import torch_blocks_ranks as ranks

torch.set_num_threads(2)

SHAPES = [(2, 1), (4, 1), (1, 2), (2, 2)]
IDS = [f"{s}x{b}" for s, b in SHAPES]
CFG = ranks.CFG
W, H = CFG.grid_cells_x, CFG.grid_cells_y
JCFG = JaxScanMatcherConfig(grid_cells_x=W, grid_cells_y=H)
GRID_FIELDS = ("mean", "information", "count", "covariance")


@pytest.fixture(scope="module")
def x():
    return ranks.blocks_inputs()


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    """Every shape's per-rank results, run once."""
    out = {}
    for shape in SHAPES:
        d = str(tmp_path_factory.mktemp(f"blocks{shape[0]}x{shape[1]}"))
        out[shape] = ranks.run_ranks("blocks", d, *shape)
    return out


def t(a, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


@pytest.fixture(scope="module")
def dense(x):
    """The port's single-device results: the dense build (K1's twin at the
    map's origin) and its patch table, the score summed in K3's lane
    order, K3's twin over the particles and K6's twin match."""
    g = ndt_grid.build_ndt_from_scans(
        t(x["poses"]), t(x["points"]), t(x["pmask"]) & t(x["wmask"])[:, None],
        t(x["origin"]), CFG.ndt_resolution, W, H)
    table = ndt_grid.packed_patch_table(g, W)
    sc = ndt_grid.score_points(g, t(x["score_points"]), t(x["score_mask"]),
                               W, H)
    score = k3.lane_tree_sum(torch.nn.functional.pad(
        sc[None], (0, -sc.shape[0] % 32)))[0]
    weights = k3.score_batch_twin(g, W, H, CFG.laser_max_beams,
                                  t(x["pf_points"]), t(x["pf_mask"]),
                                  int(x["pf_mask"].sum()),
                                  t(x["particles"]))
    dths, dls = k2.search_offsets(CFG, torch.device("cpu"))
    res, _ = k6.match_twin(CFG, g, table, t(x["match_points"]),
                           t(x["match_mask"]), int(x["match_mask"].sum()),
                           t(x["match_pose"]), dths, dls)
    match = torch.cat([res.score.reshape(1), res.correction,
                       res.covariance.reshape(9)])
    return dict(grid=g, table=table, score=score.numpy(),
                weights=weights.numpy(), match=match.numpy())


def _jax_stripe_bodies(x, S: int) -> dict:
    """ndt_blocks.py's shard_map bodies for each of S stripes, op by op,
    the stripes' partials summed in order (JAX's psum over 'space')."""
    poses, points = jnp.asarray(x["poses"]), jnp.asarray(x["points"])
    origin = jnp.asarray(x["origin"])
    cs = jnp.asarray(CFG.ndt_resolution, jnp.float32)
    h = H // S
    world = jax_pose.transform_points(poses, points).reshape(-1, 2)
    mask = (jnp.asarray(x["pmask"])
            & jnp.asarray(x["wmask"])[:, None]).reshape(-1)
    B = CFG.laser_max_beams

    def bind(pts, extra_mask, i):
        ix, iy = jax_grid.cell_ij(origin, cs, pts)
        valid = (extra_mask & (ix >= 0) & (ix < W) & (iy >= i * h)
                 & (iy < (i + 1) * h))
        flat = (jnp.clip(iy - i * h, 0, h - 1) * W + jnp.clip(ix, 0, W - 1))
        return valid, flat

    stripes, score, weights, field = [], 0.0, 0.0, 0.0
    pf_n = jnp.int32(int(x["pf_mask"].sum()))
    sp, sm, used = jax_matcher.subsample(jnp.asarray(x["pf_points"]),
                                         jnp.asarray(x["pf_mask"]), pf_n, B)
    mq_n = jnp.int32(int(x["match_mask"].sum()))
    mp, mm, mused = jax_matcher.subsample(jnp.asarray(x["match_points"]),
                                          jnp.asarray(x["match_mask"]), mq_n,
                                          B)
    dths, dls = jax_matcher._search_offsets(JCFG, jnp.float32)
    ps = jnp.asarray(x["match_pose"])
    for i in range(S):
        valid, flat = bind(world, mask, i)
        g = jax_grid.build_ndt_binned(world, valid, flat, origin, cs, h * W)
        stripes.append(g)
        q = jnp.asarray(x["score_points"])
        valid, flat = bind(q, jnp.asarray(x["score_mask"]), i)
        score = score + jnp.sum(jax_grid.score_at_cells(
            g.mean, g.information, g.count, q, valid, flat))
        parts = jnp.asarray(x["particles"])
        c, s = jnp.cos(parts[:, 2])[:, None], jnp.sin(parts[:, 2])[:, None]
        px, py = sp[:, 0][None, :], sp[:, 1][None, :]
        pts = jnp.stack([c * px - s * py + parts[:, 0:1],
                         s * px + c * py + parts[:, 1:2]], axis=-1)
        valid, flat = bind(pts, sm[None, :], i)
        weights = weights - jnp.sum(jax_grid.score_at_cells(
            g.mean, g.information, g.count, pts, valid, flat), axis=-1)
        th = ps[2] + dths
        c_, s_ = jnp.cos(th)[:, None], jnp.sin(th)[:, None]
        px, py = mp[:, 0][None, :], mp[:, 1][None, :]
        rx = c_ * px - s_ * py + ps[0]
        ry = s_ * px + c_ * py + ps[1]
        wx = rx[:, None, None, :] + dls[None, :, None, None]
        wy = ry[:, None, None, :] + dls[None, None, :, None]
        pts = jnp.stack(jnp.broadcast_arrays(wx, wy), axis=-1)
        valid, flat = bind(pts, mm[None, None, None, :], i)
        field = field - jnp.sum(jax_grid.score_at_cells(
            g.mean, g.information, g.count, pts, valid, flat), axis=-1)
    weights = weights / jnp.maximum(used, 1).astype(jnp.float32)
    best, correction, k, u, s = jax_matcher.reduce_candidates(field, dths,
                                                              dls)
    res = jax_matcher.finalize_match(best, correction, k, u, s, mused)
    grid = {f: np.concatenate([np.asarray(getattr(g, f)) for g in stripes])
            for f in GRID_FIELDS}
    match = np.concatenate([[float(res.score)], np.asarray(res.correction),
                            np.asarray(res.covariance).reshape(9)])
    return dict(grid=grid, score=np.asarray(score),
                weights=np.asarray(weights), field=np.asarray(field),
                match=match)


@pytest.fixture(scope="module")
def jax_ops(x):
    """JAX's stripe math op by op at S = 1, 2, 4."""
    with jax.disable_jit():
        return {S: _jax_stripe_bodies(x, S) for S in (1, 2, 4)}


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_stripes_are_dense_rows_bitwise(meshed, dense, shape):
    g = dense["grid"]
    for r, res in enumerate(meshed[shape]):
        row0, h = int(res["local_row0"]), H // shape[0]
        assert row0 == (r // shape[1]) * h
        rows = slice(row0 * W, (row0 + h) * W)
        for f in GRID_FIELDS:
            np.testing.assert_array_equal(res[f"local_stripe_{f}"],
                                          getattr(g, f)[rows].numpy(),
                                          err_msg=f"rank {r} {f}")
            np.testing.assert_array_equal(res[f"grid_{f}"],
                                          getattr(g, f).numpy())
        # A stripe table row's first 8 floats are its own cell's record.
        np.testing.assert_array_equal(res["local_stripe_table"][:, :8],
                                      dense["table"][rows, :8].numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_build_matches_jax(meshed, jax_ops, shape):
    want = jax_ops[shape[0]]["grid"]
    got = meshed[shape][0]
    np.testing.assert_array_equal(got["grid_count"], want["count"])
    np.testing.assert_allclose(got["grid_mean"], want["mean"], atol=1e-5)
    np.testing.assert_allclose(got["grid_information"], want["information"],
                               rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_score_matches_jax(meshed, jax_ops, shape):
    got = float(meshed[shape][0]["score"])
    assert got > 1.0  # fixture sanity: something scored
    np.testing.assert_allclose(got, float(jax_ops[shape[0]]["score"]),
                               rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_particles_match_jax(meshed, jax_ops, shape):
    got = meshed[shape][0]["weights"]
    np.testing.assert_allclose(got, jax_ops[shape[0]]["weights"], rtol=1e-5,
                               atol=1e-6)
    assert (got <= 0).all() and got.min() < got.mean()


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_match_matches_jax(meshed, jax_ops, shape):
    got, want = meshed[shape][0]["match"], jax_ops[shape[0]]["match"]
    assert got[0] < -0.2
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:4], want[1:4], atol=1e-6)
    np.testing.assert_allclose(got[4:], want[4:], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_ranks_bitwise_equal(meshed, shape):
    runs = meshed[shape]
    for res in runs[1:]:
        for k in ("score", "weights", "match", "grid_mean",
                  "grid_information", "grid_count"):
            np.testing.assert_array_equal(res[k], runs[0][k], err_msg=k)
    assert not any(bool(res["imported_reference"]) for res in runs)


def test_space_one_is_dense_bitwise(meshed, dense):
    """(1, 2): one stripe, the particles over 'batch'."""
    for res in meshed[(1, 2)]:
        np.testing.assert_array_equal(res["score"], dense["score"])
        np.testing.assert_array_equal(res["weights"], dense["weights"])
        np.testing.assert_array_equal(res["match"], dense["match"])


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_height_must_divide(meshed, shape):
    with pytest.raises(ValueError):
        ndt_blocks._stripe_params(129, 2)
    assert all(bool(res["odd_height_raised"]) for res in meshed[shape])


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_jitted_jax_blocks_make_the_same_decision(meshed, x, shape):
    """JAX's own functions on a JAX mesh of the same shape."""
    mesh = jax_mesh.make_mesh(shape[0] * shape[1], shape=shape)
    n = jnp.int32(int(x["match_mask"].sum()))

    @jax.jit
    def run(poses, points, pmask, wmask, origin, qp, qm, pose):
        g = jax_blocks.build_ndt_sharded(mesh, poses, points, pmask, wmask,
                                         origin, CFG.ndt_resolution, W, H)
        return jax_blocks.match_scan_sharded_map(JCFG, mesh, g, qp, qm, n,
                                                 pose)
    res = run(*[jnp.asarray(x[k]) for k in (
        "poses", "points", "pmask", "wmask", "origin", "match_points",
        "match_mask", "match_pose")])
    got = meshed[shape][0]["match"]
    np.testing.assert_allclose(got[1:4], np.asarray(res.correction),
                               atol=1e-6)
    np.testing.assert_allclose(got[0], float(res.score), rtol=2e-3)


# --- the kernels' twins against op-by-op JAX ------------------------------
def _stripes(dense, S: int):
    """The dense grid's S stripes and their patch tables."""
    g, h = dense["grid"], H // S
    out = []
    for i in range(S):
        rows = slice(i * h * W, (i + 1) * h * W)
        stripe = ndt_grid.NDTGrid(origin=g.origin, cell_size=g.cell_size,
                                  mean=g.mean[rows],
                                  information=g.information[rows],
                                  count=g.count[rows],
                                  covariance=g.covariance[rows])
        out.append((stripe, ndt_grid.packed_patch_table(stripe, W), i * h,
                    h))
    return out


def _field_args(x):
    return (t(x["match_points"]), t(x["match_mask"]),
            int(x["match_mask"].sum()), t(x["match_pose"]))


@pytest.fixture(scope="module")
def fields(x, dense):
    """KB3's twin fields of the match scan on each of S stripes, S = 1, 2,
    4."""
    dths, dls = k2.search_offsets(CFG, torch.device("cpu"))
    return {S: [k6.stripe_field(CFG, *st, *_field_args(x), dths, dls)
                for st in _stripes(dense, S)] for S in (1, 2, 4)}


@pytest.mark.parametrize("S", [1, 2, 4])
def test_stripe_field_twin_matches_jax(x, dense, jax_ops, fields, S):
    """KB3's twin: the fields of the S stripes, added in order, against
    JAX's psum of its stripes' fields; at S = 1 it is K6's scores, and the
    match of the stripes' fields is the dense K6 row."""
    dths, dls = k2.search_offsets(CFG, torch.device("cpu"))
    total = fields[S][0]
    for f in fields[S][1:]:
        total = total + f
    # At the angles where torch's and XLA's float32 cos and sin agree
    # bitwise (noise-free beams sit on cell edges; an ulp moves them).
    th = x["match_pose"][2] + dths
    jth = jnp.asarray(x["match_pose"])[2] + jnp.asarray(dths.numpy())
    same = ((torch.cos(th).numpy() == np.asarray(jnp.cos(jth)))
            & (torch.sin(th).numpy() == np.asarray(jnp.sin(jth))))
    assert same.sum() >= 40
    np.testing.assert_allclose(total.numpy()[same],
                               jax_ops[S]["field"][same], rtol=1e-5,
                               atol=1e-6)
    plan = k6.FieldPlan("cpu", S, dths.numel(), dls.numel())
    plan.stack.copy_(torch.stack(fields[S]).reshape(S, -1))
    out = k6.field_match(CFG, plan, plan.stack, int(x["match_mask"].sum()),
                         dths, dls)
    if S == 1:
        np.testing.assert_array_equal(out.numpy(), dense["match"])


def _old_chain(stack, num_points, dths, dls):
    """KB3 before its one launch: the rank-ordered sum (K12's rank_sum),
    the reduction's partials and K2's fold of them."""
    from ndt_2d_tpu_torch.kernels import shard_combine
    total = shard_combine.rank_sum(stack)
    partials = k2.block_partials(total, dths, dls, 0, k6.TILE)
    return k2.finalize_rows_twin(CFG, partials[None], num_points, dths,
                                 dls)[0]


@pytest.mark.parametrize("S", [1, 2, 4])
def test_field_match_is_the_old_chain(x, fields, S):
    """``field_match`` over a plan's stack, filled by ``stripe_field``
    through the send buffer as a rank's gather would, is bitwise the
    rank-ordered sum, the reduction and the fold; so is its twin."""
    dths, dls = k2.search_offsets(CFG, torch.device("cpu"))
    A, L = dths.numel(), dls.numel()
    plan = k6.FieldPlan("cpu", S, A, L)
    for s, f in enumerate(fields[S]):
        plan.stack[s].copy_(f.reshape(-1))
    n = int(x["match_mask"].sum())
    stack = torch.stack(fields[S])
    want = _old_chain(stack, n, dths, dls)
    got = k6.field_match(CFG, plan, plan.stack.view(S, A, L, L), n, dths,
                         dls)
    assert got.shape == (13,)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        k6.field_match_twin(CFG, stack, n, dths, dls).numpy(), want.numpy())


@pytest.mark.parametrize("S", [1, 2, 4])
def test_stripe_field_writes_the_plans_send_buffer(x, dense, fields, S):
    """``stripe_field(..., out=plan.send)`` writes the send buffer in
    place; at S = 1 the send buffer is the stack."""
    dths, dls = k2.search_offsets(CFG, torch.device("cpu"))
    plan = k6.FieldPlan("cpu", S, dths.numel(), dls.numel())
    st = _stripes(dense, S)[-1]
    got = k6.stripe_field(CFG, *st, *_field_args(x), dths, dls,
                          out=plan.send)
    assert got is plan.send
    np.testing.assert_array_equal(got.numpy(), fields[S][-1].numpy())
    assert (plan.stack.data_ptr() == plan.send.data_ptr()) == (S == 1)


@pytest.mark.parametrize("case", ["foreign", "short", "lattice", "send"])
def test_field_plan_refuses(x, dense, case):
    """A buffer that is not the plan's stack, a part of it, a lattice of
    another shape and a send buffer of another shape are refused."""
    dths, dls = k2.search_offsets(CFG, torch.device("cpu"))
    A, L = dths.numel(), dls.numel()
    plan = k6.FieldPlan("cpu", 2, A, L)
    n = int(x["match_mask"].sum())
    with pytest.raises(ValueError):
        if case == "foreign":
            k6.field_match(CFG, plan, torch.zeros_like(plan.stack), n, dths,
                           dls)
        elif case == "short":
            k6.field_match(CFG, plan, plan.stack[:1], n, dths, dls)
        elif case == "lattice":
            k6.field_match(CFG, plan, plan.stack, n, dths[:-1], dls)
        else:
            k6.stripe_field(CFG, *_stripes(dense, 2)[0], *_field_args(x),
                            dths, dls, out=plan.stack)


def test_field_plans_are_kept():
    a = k6.field_plan("cpu", 2, 5, 7)
    assert k6.field_plan(torch.device("cpu"), 2, 5, 7) is a
    assert k6.field_plan("cpu", 4, 5, 7) is not a
    with pytest.raises(ValueError):
        k6.FieldPlan("cpu", 0, 5, 7)
