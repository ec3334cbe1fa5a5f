"""K4's dense normal system (``dense_normal_system``: the blocks, the node
sums and the assembly of one device's dense LM iteration in one launch)
against its twin and ndt_2d_tpu's ``graph/solver.py``.  The kernel runs
only on the card, where ``chip_smoke.py`` holds it bitwise against its
twin and against the three launches it replaces.

* A numpy model of the kernel's plan (a block a node row: its three rows
  zero-filled; its begin list, then its end list, staged ``k4.DENSE_STAGE``
  constraints a chunk, each of the 12 components of each list added in
  list order from +0 across chunks; D = d0 + d1, g = g0 + g1; a thread a
  slot head adding its run of Bab entries from +0, transposed past C;
  thread 0's diagonal block from +0 where the row has no self-loop slot;
  rhs = -g fm) bitwise, -0 included, against ``normal_blocks_twin`` then
  ``dense_system_twin``.  Graphs: test_torch_lm_step's ``special_graph``
  (duplicate, reversed, self-loop and masked constraints, padded nodes)
  and a hub whose lists span two staging chunks; every loss; lam 1e-12,
  1e-6 and 1e8.  The model takes each constraint's blocks from
  ``constraint_blocks_twin``: the kernel forms them with the one device
  function (``constraint_terms``) that ``normal_blocks``' kernel calls.
* The twin against op-by-op JAX (``robust_weights``, ``_normal_blocks``,
  ``_gather_gradient_and_diag`` and ``_dense_solve``'s assembly, whose
  ``jax.scipy.linalg.solve`` is replaced by one that keeps the system),
  at test_torch_lm_step's tolerance for the system.
* The solver's dispatch: one device's dense path calls
  ``dense_normal_system`` once an LM iteration and ``normal_blocks`` and
  ``dense_system`` never; PCG and a mesh's combine still call
  ``normal_blocks`` (and, dense, ``dense_system``), and the combine's
  dense path on one rank ends at the fused path's poses bitwise.
"""

import collections
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
from ndt_2d_tpu_torch.graph import solver
from ndt_2d_tpu_torch.kernels import normal_blocks as k4
from test_torch_lm_step import (
    assert_system_close, free_mask, near_graph, special_graph, torch_inputs)

torch.set_num_threads(2)

f32 = np.float32
LOSSES = ["none", "huber", "geman_mcclure"]
LAMS = [1e-12, 1e-6, 1e8]


def hub_graph(seed=11, n=48, live=40, hub=20, spokes=150, c_pad=256):
    """``special_graph``'s kind of inputs around a hub: a chain of ``live``
    nodes, ``spokes`` constraints between node ``hub`` and others (about
    half leaving it, half entering it, some node pairs twice), a live
    self-loop on the hub and a masked spoke; the hub's begin and end lists
    together span two staging chunks."""
    rng = np.random.default_rng(seed)
    others = rng.choice(np.setdiff1d(np.arange(live), [hub]), spokes)
    out = rng.random(spokes) < 0.5
    pairs = [(k, k + 1) for k in range(live - 1)]
    pairs += [(hub, int(o)) if a else (int(o), hub)
              for o, a in zip(others, out)]
    pairs += [(hub, hub)]
    C = len(pairs)
    assert C <= c_pad and spokes + 3 > k4.DENSE_STAGE
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
    cmask[live + 7] = False
    return dict(poses=poses, begin=begin, end=end, transform=transform,
                information=info, constraint_mask=cmask,
                node_mask=np.arange(n) < live,
                robust_mask=(np.arange(c_pad) >= live - 1) & cmask)


GRAPHS = {"special 0": lambda: special_graph(0),
          "special 1, odd width": lambda: special_graph(1, n=23, live=21),
          "hub": hub_graph}


def system_args(t, loss, lam):
    """``dense_normal_system``'s arguments at the graph's poses."""
    n = t["poses"].shape[0]
    inc = k4.incidence(t["begin"], t["end"], t["constraint_mask"], n)
    pairs = k4.pair_table(t["begin"], t["end"], t["constraint_mask"], n)
    return (t["poses"], t["begin"], t["end"], t["transform"],
            t["information"], t["constraint_mask"], t["robust_mask"], loss,
            1.0, inc, pairs, torch.tensor(lam, dtype=torch.float32),
            free_mask(t).float())


def finish(v, diag, e, d, fi, fj, lam):
    """csrc/normal_blocks.cu::finish_element in float32."""
    if not diag:
        return f32(f32(v * fi) * fj)
    ef = f32(e)
    v = f32(v + d)
    v = f32(v + f32(lam * f32(f32(d * ef) + f32(f32(1e-12) * ef))))
    v = f32(f32(v * fi) * fi)
    return f32(v + f32(f32(f32(1.0) - fi) * ef))


def fused_model(args, chunk=k4.DENSE_STAGE):
    """numpy float32 model of the fused kernel's plan (module docstring):
    (hm [3N, 3N], rhs [3N])."""
    (poses, begin, end, transform, information, cmask, robust_mask, loss,
     delta, inc, pairs, lam, fm) = args
    baa, bab, bbb, ga, gb = (x.numpy() for x in k4.constraint_blocks_twin(
        poses, begin, end, transform, information, cmask, robust_mask, loss,
        delta))
    side = {True: np.concatenate([baa.reshape(-1, 9), ga], 1),
            False: np.concatenate([bbb.reshape(-1, 9), gb], 1)}
    n, C = pairs.n, pairs.c
    keys, src = pairs.keys.numpy(), pairs.src.numpy()
    row_ptr = pairs.row_ptr.numpy()
    b_ptr, b_idx = inc.b_ptr.numpy(), inc.b_idx.numpy()
    e_ptr, e_idx = inc.e_ptr.numpy(), inc.e_idx.numpy()
    fm, lam = fm.numpy(), f32(lam)
    w = 3 * n
    hm = np.full((w, w), np.nan, f32)
    rhs = np.full(w, np.nan, f32)

    def write_block(i, j, v, part):
        diag = j == i
        fi = fm[i]
        fj = fi if diag else fm[j]
        for e in range(9):
            ai, b = divmod(e, 3)
            d = f32(part[e] + part[12 + e]) if diag else f32(0.0)
            hm[3 * i + ai, 3 * j + b] = finish(v[e], diag, ai == b, d, fi,
                                               fj, lam)

    for i in range(n):
        hm[3 * i:3 * i + 3] = f32(0.0)
        items = ([(int(k), True) for k in b_idx[b_ptr[i]:b_ptr[i + 1]]]
                 + [(int(k), False) for k in e_idx[e_ptr[i]:e_ptr[i + 1]]])
        nb = b_ptr[i + 1] - b_ptr[i]
        part = np.zeros(24, f32)
        for c0 in range(0, len(items), chunk):
            m = min(chunk, len(items) - c0)
            staged = [side[at][k] for k, at in items[c0:c0 + m]]
            for p in range(0, min(nb - c0, m)):
                part[:12] = part[:12] + staged[p]
            for p in range(max(nb - c0, 0), m):
                part[12:] = part[12:] + staged[p]
        lo, hi = row_ptr[i], row_ptr[i + 1]
        for p in range(lo, hi):
            if p != lo and keys[p - 1] == keys[p]:
                continue
            v = np.zeros(9, f32)
            q = p
            while q < hi and keys[q] == keys[p]:
                s = src[q]
                blk = bab[s] if s < C else bab[s - C].T
                v = v + blk.reshape(-1)
                q += 1
            write_block(i, int(keys[p] - i * n), v, part)
        if i * n + i not in keys[lo:hi]:
            write_block(i, i, np.zeros(9, f32), part)
        rhs[3 * i:3 * i + 3] = -(part[9:12] + part[21:24]) * fm[i]
    return hm, rhs


def same_bits(a, b):
    np.testing.assert_array_equal(np.asarray(a, f32).view(np.int32),
                                  np.asarray(b, f32).view(np.int32))


@pytest.mark.parametrize("lam", LAMS)
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_kernel_model_is_the_three_launch_twin_bitwise(graph, loss, lam):
    args = system_args(torch_inputs(GRAPHS[graph]()), loss, lam)
    hm, rhs = k4.dense_normal_system_twin(*args)
    ref_hm, ref_rhs = k4.dense_system_twin(
        args[10], *[x for i, x in enumerate(k4.normal_blocks_twin(
            *args[:10])) if i in (1, 5, 6)], args[11], args[12])
    same_bits(hm, ref_hm)
    same_bits(rhs, ref_rhs)
    mh, mr = fused_model(args)
    same_bits(mh, hm.numpy())
    same_bits(mr, rhs.numpy())
    # The CPU wrapper is the twin.
    hw, rw = k4.dense_normal_system(*args)
    same_bits(hw, hm)
    same_bits(rw, rhs)
    if lam == 1e8:
        assert (hm.numpy().view(np.int32) == np.int32(-2 ** 31)).any()


@pytest.mark.parametrize("chunk", [1, 3, 256])
def test_kernel_model_does_not_depend_on_the_chunk(chunk):
    """The staging chunk splits a list's in-order sums, never reorders
    them: the hub's system is the same bits at any chunk."""
    args = system_args(torch_inputs(hub_graph()), "huber", 1e-6)
    hm, rhs = k4.dense_normal_system_twin(*args)
    mh, mr = fused_model(args, chunk)
    same_bits(mh, hm.numpy())
    same_bits(mr, rhs.numpy())


def jax_system(g, loss, lam):
    """The (hm, rhs) op-by-op JAX hands its solve: robust weights, blocks,
    node sums, then ``_dense_solve``'s assembly."""
    cfg = JaxSolverConfig(robust_loss=loss, huber_delta=1.0)
    j = {k: jnp.asarray(v) for k, v in g.items()}
    n = g["poses"].shape[0]
    free = j["node_mask"] & (jnp.arange(n) != 0)
    seen = {}

    def keep(a, b, **kw):
        seen["hm"], seen["rhs"] = np.asarray(a), np.asarray(b)
        return jnp.zeros_like(b)
    terms = (j["poses"], j["begin"], j["end"], j["transform"])
    with mock.patch.object(jax.scipy.linalg, "solve", keep), \
            jax.disable_jit():
        rw = jax_solver.robust_weights(cfg, *terms, j["information"],
                                       j["robust_mask"])
        info = j["information"] * rw[:, None, None]
        baa, bab, bbb, ga, gb = jax_solver._normal_blocks(
            *terms, info, j["constraint_mask"])
        grad, diag = jax_solver._gather_gradient_and_diag(
            n, j["begin"], j["end"], baa, bab, bbb, ga, gb)
        jax_solver._dense_solve(n, j["begin"], j["end"], baa, bab, bbb, grad,
                                diag, jnp.asarray(lam, jnp.float32), free)
    return seen["hm"], seen["rhs"]


@pytest.mark.parametrize("lam", LAMS)
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("graph", ["special 0", "hub"])
def test_twin_matches_op_by_op_jax(graph, loss, lam):
    g = GRAPHS[graph]()
    hm, rhs = k4.dense_normal_system_twin(
        *system_args(torch_inputs(g), loss, lam))
    assert_system_close(hm, rhs, *jax_system(g, loss, lam))


class Counted:
    """Counts the calls of K4's wrappers the LM loop may take."""

    NAMES = ("dense_normal_system", "normal_blocks", "dense_system",
             "pcg_normal_system", "pcg_solve", "lm_step")

    def __init__(self, monkeypatch):
        self.calls = collections.Counter()
        for name in self.NAMES:
            monkeypatch.setattr(k4, name, self.wrap(name, getattr(k4, name)))

    def wrap(self, name, real):
        def call(*args, **kwargs):
            self.calls[name] += 1
            return real(*args, **kwargs)
        return call

    def take(self):
        out = {k: v for k, v in self.calls.items() if v}
        self.calls.clear()
        return out


@pytest.mark.parametrize("loss", ["none", "geman_mcclure"])
def test_one_device_dense_iteration_is_one_fused_call(monkeypatch, loss):
    t = torch_inputs(near_graph(6))
    cfg = SolverConfig(robust_loss=loss)
    counted = Counted(monkeypatch)
    dense = solver.solve(cfg, **t, use_dense=True)
    it = int(dense.iterations)
    assert it >= 2 and bool(dense.success)
    assert counted.take() == {"dense_normal_system": it, "lm_step": it}
    pcg = solver.solve(cfg, **t, use_dense=False)
    it = int(pcg.iterations)
    assert counted.take() == {"pcg_normal_system": it, "pcg_solve": it,
                              "lm_step": it}
    # A mesh of one rank: the combine's path, the identity as the sum.
    monkeypatch.setattr(solver, "_constraint_shard",
                        lambda mesh, arrays: (list(arrays), lambda x: x))
    mesh = solver.solve(cfg, **t, use_dense=True, mesh=object())
    it = int(mesh.iterations)
    assert counted.take() == {"normal_blocks": it, "dense_system": it,
                              "lm_step": it}
    assert int(mesh.iterations) == int(dense.iterations)
    assert torch.equal(mesh.poses, dense.poses)
    assert torch.equal(mesh.cost, dense.cost)
