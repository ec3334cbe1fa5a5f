"""K4's dense LM step: the dense system (``dense_system_twin`` and its pair
table ``pair_table``) and the LM step
(``robust_cost_twin``, ``lm_step_twin`` and ``lm_plan``) against
ndt_2d_tpu's ``graph/solver.py``.  The kernels run only on the card, where
``chip_smoke.py`` holds them bitwise against these twins.

* The system against op-by-op JAX ``_dense_solve`` (``jax.disable_jit``;
  its ``jax.scipy.linalg.solve`` is replaced by one that keeps the matrix
  and right-hand side it is handed) and against a float64 numpy assembly,
  on graphs with duplicate node pairs, constraints in both directions,
  live self-loops, masked constraints and padded nodes, at lam 1e-12, 1e-6
  and 1e8.  Tolerance: 1e-6 relative on the main diagonal and 1e-6 of the
  largest off-diagonal magnitude elsewhere.  JAX scatters Baa and Bbb into
  the diagonal blocks one constraint at a time where the port adds the
  pair sums to K4's D, so a diagonal block's sum is taken in another order;
  the off-diagonal blocks sum in the same order.
* A numpy model of the kernel (a block a node row: the slot table, then
  each element whole, float4 groups where 3N divides by 4) bitwise against
  the twin.
* The cost against op-by-op JAX ``_robust_cost`` at 1e-6 relative (JAX adds
  in XLA's order, the port in constraint order); bitwise the same at
  C_pad 64 and 1024.
* The step against JAX's own ``lm_step`` (the body of its ``while_loop``,
  run op by op on states chosen here, both fed the same step): accept, lam
  and stall equal, poses at 1e-6, cost at 1e-5 relative.  Near the
  optimum a residual is a difference of terms ~1e3 times its size, so the
  ulp by which XLA's float32 cos/sin and torch's differ at some angles
  moves the cost by up to ~3e-6 relative there.
"""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import jax.scipy.linalg  # noqa: F401  (the module the tests patch)
import numpy as np
import pytest
import torch

from ndt_2d_tpu.config import SolverConfig as JaxSolverConfig
from ndt_2d_tpu.graph import solver as jax_solver
from ndt_2d_tpu_torch.config import SolverConfig
from ndt_2d_tpu_torch.kernels import normal_blocks as k4
from ndt_2d_tpu_torch.kernels import shard_combine

torch.set_num_threads(2)


def special_graph(seed, n=24, live=20, c_pad=64):
    """solve() inputs (numpy): ``live`` of ``n`` nodes (the rest padded),
    a chain, loop closures, a duplicate and a reversed pair, two live
    self-loops, masked constraints, and masked padding to ``c_pad``."""
    rng = np.random.default_rng(seed)
    pairs = [(k, k + 1) for k in range(live - 1)]
    loops = [(int(a), int(min(a + rng.integers(3, 9), live - 1)))
             for a in rng.integers(0, live - 4, 6)]
    pairs += loops + [loops[0], loops[1][::-1], loops[2][::-1], (3, 3),
                      (7, 7)]
    C = len(pairs)
    begin = np.zeros(c_pad, np.int32)
    end = np.zeros(c_pad, np.int32)
    begin[:C] = [p[0] for p in pairs]
    end[:C] = [p[1] for p in pairs]
    poses = np.zeros((n, 3), np.float32)
    poses[:live] = np.c_[rng.uniform(0, 10, (live, 2)),
                         rng.uniform(-3, 3, live)]
    transform = np.zeros((c_pad, 3), np.float32)
    transform[:C] = rng.normal(0, 1, (C, 3))
    a = rng.normal(0, 1, (c_pad, 3, 3))
    info = ((a @ a.transpose(0, 2, 1) + 3 * np.eye(3)) * 30).astype(
        np.float32)
    cmask = np.arange(c_pad) < C
    cmask[rng.choice(live - 1, 2, replace=False)] = False
    return dict(poses=poses, begin=begin, end=end, transform=transform,
                information=info, constraint_mask=cmask,
                node_mask=np.arange(n) < live,
                robust_mask=(np.arange(c_pad) >= live - 1) & cmask)


def near_graph(seed):
    """``special_graph`` with each live constraint's transform the relative
    pose of its nodes plus noise, and the poses then perturbed: an LM step
    from there lowers the cost."""
    g = special_graph(seed)
    rng = np.random.default_rng(seed + 100)
    p = g["poses"].astype(np.float64)
    b, e = g["begin"], g["end"]
    c, s = np.cos(p[b, 2]), np.sin(p[b, 2])
    d = p[e, :2] - p[b, :2]
    rel = np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1],
                    p[e, 2] - p[b, 2]], -1)
    g["transform"] = (rel + rng.normal(0, 0.01, rel.shape)).astype(
        np.float32)
    live = g["node_mask"]
    g["poses"][live] += rng.normal(0, 0.05, (int(live.sum()), 3)).astype(
        np.float32)
    return g


def torch_inputs(g):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in g.items()}
    for k in ("begin", "end"):
        t[k] = t[k].to(torch.int32)
    return t


def blocks_of(t, loss="huber"):
    """K4's twin blocks at the graph's poses: (baa, bab, bbb, g, diag)."""
    n = t["poses"].shape[0]
    inc = k4.incidence(t["begin"], t["end"], t["constraint_mask"], n)
    baa, bab, bbb, _, _, g, diag = k4.normal_blocks_twin(
        t["poses"], t["begin"], t["end"], t["transform"], t["information"],
        t["constraint_mask"], t["robust_mask"], loss, 1.0, inc)
    return baa, bab, bbb, g, diag


def free_mask(t):
    n = t["poses"].shape[0]
    return t["node_mask"] & (torch.arange(n) != 0)


def port_system(t, lam, combine=None):
    baa, bab, bbb, g, diag = blocks_of(t)
    n = t["poses"].shape[0]
    pairs = k4.pair_table(t["begin"], t["end"], t["constraint_mask"], n)
    return k4.dense_system_twin(pairs, bab, g, diag,
                                torch.tensor(lam, dtype=torch.float32),
                                free_mask(t).float(), combine)


def jax_system(t, lam):
    """The (hm, rhs) op-by-op JAX ``_dense_solve`` hands its solve."""
    baa, bab, bbb, g, diag = blocks_of(t)
    n = t["poses"].shape[0]
    seen = {}

    def keep(a, b, **kw):
        seen["hm"], seen["rhs"] = np.asarray(a), np.asarray(b)
        return jnp.zeros_like(b)
    j = [jnp.asarray(x.numpy()) for x in (t["begin"], t["end"], baa, bab,
                                          bbb, g, diag)]
    with mock.patch.object(jax.scipy.linalg, "solve", keep), \
            jax.disable_jit():
        jax_solver._dense_solve(n, *j, jnp.asarray(lam, jnp.float32),
                                jnp.asarray(free_mask(t).numpy()))
    return seen["hm"], seen["rhs"]


def f64_system(t, lam):
    """The damped system assembled in float64 from the float32 blocks."""
    baa, bab, bbb, g, diag = (x.double().numpy() for x in blocks_of(t))
    n = t["poses"].shape[0]
    fm = free_mask(t).double().numpy()
    h = np.zeros((n, n, 3, 3))
    for k in np.nonzero(t["constraint_mask"].numpy())[0]:
        b, e = int(t["begin"][k]), int(t["end"][k])
        h[b, b] += baa[k]
        h[e, e] += bbb[k]
        h[b, e] += bab[k]
        h[e, b] += bab[k].T
    eye = np.eye(3)
    for i in range(n):
        h[i, i] += lam * (diag[i] * eye + 1e-12 * eye)
    h = h * fm[:, None, None, None] * fm[None, :, None, None]
    for i in range(n):
        h[i, i] += (1.0 - fm[i]) * eye
    return (h.transpose(0, 2, 1, 3).reshape(3 * n, 3 * n),
            (-g * fm[:, None]).reshape(-1))


def assert_system_close(hm, rhs, ref_hm, ref_rhs):
    hm, ref_hm = np.asarray(hm, np.float64), np.asarray(ref_hm, np.float64)
    d = np.eye(hm.shape[0], dtype=bool)
    np.testing.assert_allclose(hm[d], ref_hm[d], rtol=1e-6)
    scale = np.abs(ref_hm[~d]).max()
    np.testing.assert_allclose(hm[~d], ref_hm[~d], rtol=1e-6,
                               atol=1e-6 * scale)
    rhs, ref_rhs = np.asarray(rhs, np.float64), np.asarray(ref_rhs)
    np.testing.assert_allclose(rhs, ref_rhs, rtol=1e-6,
                               atol=1e-6 * np.abs(ref_rhs).max())


@pytest.mark.parametrize("lam", [1e-12, 1e-6, 1e8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_system_matches_jax_and_float64(seed, lam):
    t = torch_inputs(special_graph(seed))
    hm, rhs = port_system(t, lam)
    assert_system_close(hm, rhs, *jax_system(t, lam))
    assert_system_close(hm, rhs, *f64_system(t, lam))
    # Gauge and padded nodes: identity rows and columns, zero rhs.
    n = t["poses"].shape[0]
    fixed = np.nonzero(~free_mask(t).numpy())[0]
    rows = np.concatenate([3 * fixed + a for a in range(3)])
    m = hm.numpy()
    np.testing.assert_array_equal(m[rows][:, rows], np.eye(len(rows)))
    others = np.setdiff1d(np.arange(3 * n), rows)
    assert not m[rows][:, others].any() and not m[others][:, rows].any()
    assert not rhs.numpy()[rows].any()


def old_rounds(begin, end, cmask, n):
    """The (slot, entry) rounds of the solver's original pair scatter:
    live entries Bab (begin, end) then Bab^T (end, begin), stably sorted,
    the d-th entry of every slot in round d."""
    live = np.nonzero(cmask)[0]
    keys = np.concatenate([begin[live] * n + end[live],
                           end[live] * n + begin[live]]).astype(np.int64)
    src = np.concatenate([live, live + len(begin)])
    order = np.argsort(keys, kind="stable")
    keys, src = keys[order], src[order]
    rank = np.arange(len(keys)) - np.searchsorted(keys, keys)
    return [(keys[rank == d], src[rank == d])
            for d in range(rank.max() + 1 if len(keys) else 0)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pair_table_is_the_solvers_pair_scatter(seed):
    rng = np.random.default_rng(seed)
    n, C = 17, 80
    begin = rng.integers(0, n, C).astype(np.int32)
    end = np.where(rng.random(C) < 0.1, begin,
                   rng.integers(0, n, C)).astype(np.int32)
    cmask = rng.random(C) < 0.85
    pairs = k4.pair_table(torch.from_numpy(begin), torch.from_numpy(end),
                          torch.from_numpy(cmask), n)
    ref = old_rounds(begin, end, cmask, n)
    got = pairs.rounds()
    assert len(got) == len(ref) > 1
    for (k, s), (rk, rs) in zip(got, ref):
        np.testing.assert_array_equal(k.numpy(), rk)
        np.testing.assert_array_equal(s.numpy(), rs)
    # The kernel's form: row i's entries in keys[row_ptr[i]:row_ptr[i+1]],
    # every slot of row i in [i n, (i + 1) n), masked entries past the end.
    keys, ptr = pairs.keys.numpy(), pairs.row_ptr.numpy()
    live = 2 * int(cmask.sum())
    assert ptr[0] == 0 and ptr[-1] == live and (np.diff(ptr) >= 0).all()
    for i in range(n):
        row = keys[ptr[i]:ptr[i + 1]]
        assert ((row >= i * n) & (row < (i + 1) * n)).all()
    assert (keys[live:] == n * n).all()
    flat = np.concatenate([s for _, s in ref])
    np.testing.assert_array_equal(np.sort(pairs.src.numpy()[:live]),
                                  np.sort(flat))


def kernel_model(pairs, bab, g, diag, lam, fm):
    """numpy float32 model of the dense-system kernel (phase 0): per row
    block i the slot table (column node -> first sorted entry of its
    slot), then every element whole, in the kernel's store groups."""
    f = np.float32
    n, C = pairs.n, pairs.c
    keys, src = pairs.keys.numpy(), pairs.src.numpy()
    ptr = pairs.row_ptr.numpy()
    bab, g, diag, fm = bab.numpy(), g.numpy(), diag.numpy(), fm.numpy()
    lam = f(lam)
    w = 3 * n
    vec = 4 if w % 4 == 0 else 1  # float4 stores where rows stay aligned
    hm = np.full((w, w), np.nan, f)
    rhs = np.full(w, np.nan, f)
    for i in range(n):
        lo, hi = ptr[i], ptr[i + 1]
        slot = np.full(n, -1)
        for p in range(lo, hi):
            if p == lo or keys[p] != keys[p - 1]:
                slot[keys[p] - i * n] = p
        fi = fm[i]
        for q in range(3 * w // vec):
            for e in range(vec * q, vec * q + vec):
                ai, c = divmod(e, w)
                j, b = divmod(c, 3)
                v = f(0.0)
                p = slot[j]
                while p >= 0 and p < hi and keys[p] == keys[slot[j]]:
                    s = src[p]
                    v = f(v + (bab[s, ai, b] if s < C
                               else bab[s - C, b, ai]))
                    p += 1
                if j != i:
                    v = f(f(v * fi) * fm[j])
                else:
                    d, one = diag[i, ai, b], f(ai == b)
                    v = f(v + d)
                    v = f(v + f(lam * f(f(d * one) + f(f(1e-12) * one))))
                    v = f(f(v * fi) * fi)
                    v = f(v + f(f(f(1.0) - fi) * one))
                hm[3 * i + ai, c] = v
        rhs[3 * i:3 * i + 3] = f(-g[i]) * fi
    return hm, rhs


@pytest.mark.parametrize("n,live", [(24, 20), (23, 21)])
def test_kernel_model_is_the_twin_bitwise(n, live):
    t = torch_inputs(special_graph(5, n=n, live=live))
    _, bab, _, g, diag = blocks_of(t)
    pairs = k4.pair_table(t["begin"], t["end"], t["constraint_mask"], n)
    fm = free_mask(t).float()
    for lam in (1e-12, 1e8):
        hm, rhs = k4.dense_system_twin(pairs, bab, g, diag,
                                       torch.tensor(lam), fm)
        mh, mr = kernel_model(pairs, bab, g, diag, lam, fm)
        np.testing.assert_array_equal(hm.numpy().view(np.int32),
                                      mh.view(np.int32))
        np.testing.assert_array_equal(rhs.numpy().view(np.int32),
                                      mr.view(np.int32))
    assert (hm.numpy().view(np.int32) == np.int32(-2 ** 31)).any()


@pytest.mark.parametrize("shards", [1, 2])
def test_dense_system_combines_pair_sums_over_ranks(shards):
    """A mesh's system: each rank's pair sums, added in rank order by the
    combine, then the diagonal, damping and mask; one rank is the single
    device's bitwise, two agree with the float64 assembly."""
    t = torch_inputs(special_graph(7))
    n = t["poses"].shape[0]
    _, bab, _, g, diag = blocks_of(t)
    fm, lam = free_mask(t).float(), torch.tensor(1e-6)
    C = bab.shape[0]
    parts, cut = [], C // shards
    for s in range(shards):
        keep = torch.zeros(C, dtype=torch.bool)
        keep[s * cut:(s + 1) * cut] = True
        pairs = k4.pair_table(t["begin"], t["end"],
                              t["constraint_mask"] & keep, n)
        got = []
        k4.dense_system_twin(pairs, bab, g, diag, lam, fm,
                             lambda h: got.append(h.clone()) or h)
        parts.append((pairs, got[0]))

    def combine(h):
        return shard_combine.rank_sum_twin(
            torch.stack([h] + [p for _, p in parts[1:]]))
    hm, rhs = k4.dense_system_twin(parts[0][0], bab, g, diag, lam, fm,
                                   combine)
    if shards == 1:
        whole = k4.pair_table(t["begin"], t["end"], t["constraint_mask"], n)
        one, one_rhs = k4.dense_system_twin(whole, bab, g, diag, lam, fm)
        assert torch.equal(hm, one) and torch.equal(rhs, one_rhs)
    assert_system_close(hm, rhs, *f64_system(t, 1e-6))


@pytest.mark.parametrize("C,N,fits,blocks", [
    (586, 512, 1056, 3), (64, 64, 1056, 1), (0, 1, 1056, 1),
    (100_000, 50_000, 1056, 391), (400_000, 50_000, 1056, 1056),
    (1, 1, 1, 1)])
def test_lm_plan(C, N, fits, blocks):
    assert k4.lm_plan(C, N, fits) == blocks
    # Every constraint and node has a thread in some pass of the grid.
    assert blocks * k4.THREADS * -(-max(C, N) // (blocks * k4.THREADS)) \
        >= max(C, N)


def test_lm_plan_refuses_a_card_without_room():
    with pytest.raises(RuntimeError):
        k4.lm_plan(64, 64, 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ordered_sum_is_index_order(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1, 300) * 10.0 ** rng.integers(-4, 5, 300)).astype(
        np.float32)
    x[rng.random(300) < 0.1] = np.float32(-0.0)
    acc = np.float32(0.0)
    for v in x:
        acc = np.float32(acc + v)
    got = k4.ordered_sum_twin(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == ()
    assert np.float32(got.item()).view(np.int32) == acc.view(np.int32)
    assert k4.ordered_sum_twin(torch.full((5,), -0.0)).item() == 0.0
    assert np.signbit(np.float32(k4.ordered_sum_twin(
        torch.full((5,), -0.0)).item())) == np.False_


def cost_args(t, loss):
    return (t["begin"], t["end"], t["transform"], t["information"],
            t["constraint_mask"], t["robust_mask"], loss, 1.0)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("loss", ["none", "huber", "geman_mcclure"])
def test_cost_matches_op_by_op_jax(loss, seed):
    g = special_graph(seed)
    t = torch_inputs(g)
    ours = k4.robust_cost_twin(t["poses"], None, None, *cost_args(t, loss))
    with jax.disable_jit():
        ref = jax_solver._robust_cost(
            JaxSolverConfig(robust_loss=loss, huber_delta=1.0),
            *[jnp.asarray(g[k]) for k in ("poses", "begin", "end",
                                          "transform", "information",
                                          "constraint_mask",
                                          "robust_mask")])
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


@pytest.mark.parametrize("loss", ["none", "huber", "geman_mcclure"])
def test_cost_does_not_depend_on_the_padding(loss):
    g = special_graph(4, c_pad=64)
    small = torch_inputs(g)
    big = {}
    for k, v in g.items():
        if k in ("poses", "node_mask"):
            big[k] = v
            continue
        big[k] = np.zeros((1024,) + v.shape[1:], v.dtype)
        big[k][:64] = v
    big["information"][64:] = np.nan  # masked: never added into the sum
    big = torch_inputs(big)
    delta = torch.from_numpy(np.random.default_rng(4).normal(
        0, 0.01, (24, 3)).astype(np.float32))
    a = k4.robust_cost_twin(small["poses"], delta, None,
                            *cost_args(small, loss))
    b = k4.robust_cost_twin(big["poses"], delta, None, *cost_args(big, loss))
    assert np.float32(a.item()).view(np.int32) == \
        np.float32(b.item()).view(np.int32)


def jax_lm_step(g, cfg, step):
    """JAX's ``lm_step`` (op by op) and its state at ``g``'s poses: the
    body of ``_solve_impl``'s while_loop, with its dense solve returning
    ``step`` [N, 3]."""
    seen = {}

    def keep_loop(cond, body, init):
        seen["body"], seen["init"] = body, init
        return init
    flat = jnp.asarray(np.asarray(step, np.float32).reshape(-1))
    with mock.patch.object(jax.lax, "while_loop", keep_loop), \
            mock.patch.object(jax.scipy.linalg, "solve",
                              lambda a, b, **kw: flat), jax.disable_jit():
        jax_solver.solve(cfg, **{k: jnp.asarray(v) for k, v in g.items()})
        yield seen["body"], seen["init"]


CASES = {
    # name: (step scale, NaN step, start stall, tolerance)
    "accept": (1.0, False, 0, 1e-9),
    "reject": (100.0, False, 0, 1e-9),
    "NaN step": (1.0, True, 1, 1e-9),
    "stall to 3": (100.0, False, 2, 1e-9),
    "accept, not improved": (0.01, False, 1, 0.5),
}


@pytest.mark.parametrize("loss", ["none", "geman_mcclure"])
@pytest.mark.parametrize("case", list(CASES))
def test_lm_step_matches_jax(case, loss):
    scale, nan, stall, tol = CASES[case]
    g = near_graph(6)
    t = torch_inputs(g)
    n = t["poses"].shape[0]
    _, bab, _, gr, diag = blocks_of(t, loss)
    pairs = k4.pair_table(t["begin"], t["end"], t["constraint_mask"], n)
    hm, rhs = k4.dense_system_twin(pairs, bab, gr, diag, torch.tensor(1e-6),
                                   free_mask(t).float())
    chol, info = torch.linalg.cholesky_ex(hm)
    delta = torch.cholesky_solve(rhs.reshape(-1, 1), chol).reshape(n, 3)
    delta = delta * scale
    if nan:
        info = torch.ones_like(info)
    jax_step = np.full((n, 3), np.nan, np.float32) if nan else delta.numpy()
    jcfg = JaxSolverConfig(robust_loss=loss, huber_delta=1.0, tolerance=tol)
    cfg = SolverConfig(robust_loss=loss, huber_delta=1.0, tolerance=tol)
    args = cost_args(t, loss)
    cost0 = k4.robust_cost_twin(t["poses"], None, None, *args)
    state = k4.lm_state(t["poses"], cfg.lm_lambda_init, cost0,
                        t["begin"].shape[0])
    state.stall.fill_(stall)
    k4.lm_step_twin(state, delta, info, *args, cfg.lm_lambda_down,
                    cfg.lm_lambda_up, cfg.tolerance)
    for body, init in jax_lm_step(g, jcfg, jax_step):
        poses, lam, jcost, it, _ = init
        with jax.disable_jit():
            out = body((poses, lam, jcost, it, jnp.int32(stall)))
    j_poses, j_lam, j_cost, _, j_stall = (np.asarray(x) for x in out)
    accept = bool(state.flags[0])
    assert accept == (float(j_lam) == np.float32(1e-6) * np.float32(0.5))
    assert accept == (case.startswith("accept"))
    assert state.lam.item() == float(j_lam)
    assert int(state.stall) == int(j_stall)
    assert int(state.stall) == (0 if case == "accept" else stall + 1)
    np.testing.assert_allclose(state.cost.item(), float(j_cost), rtol=1e-5)
    np.testing.assert_allclose(state.poses.numpy(), j_poses, atol=1e-6)
    if not accept:
        assert torch.equal(state.poses, t["poses"])
