"""K4's LM step as one block and one device's dense solve on a plan
(``kernels/normal_blocks.py``: ``lm_one_block``, ``lm_blocks``,
``DensePlan``; ``graph/solver.py``).  The kernels run only on the card,
where ``chip_smoke.py`` holds both LM-step launches and planned solves
bitwise against the twins.

* A numpy model of the one-block step (the costs formed a thread a
  constraint, thread 0 adding the row in index order from +0 in float4
  groups, the accept, the damping, the stall count, the poses) and of the
  cooperative grid's (the costs over blocks x 256 threads, the row staged
  4096 floats at a time) held bitwise (``view(np.int32)``) against
  ``robust_cost_twin`` and ``lm_step_twin``: every loss, accepted,
  rejected and NaN steps, masked and padded constraints, the cost, step
  and update modes.  Both use ``torch.cos`` / ``torch.sin`` for the
  angle, as the twin does; the rest is numpy float32.
* The launch shape: one block whenever the C + 1 costs fit the default
  48 KB of shared memory, else the cooperative plan; the plan's
  structures laid out as their C counterparts, its checks raising on a
  wrong tensor, and a plan over CPU tensors running the twins.
* The solver's dispatch: one device's dense solve builds one plan a solve
  and calls its two launches once an iteration (on the CPU they run the
  twins); PCG and a mesh's combine keep the wrappers.  Planned solves
  equal the parent's unplanned loop bitwise, and JAX's solve at
  test_torch_lm_step.py's step tolerances (the same iterations, poses
  within 1e-6, cost within 1e-5 relative) on test_torch_solver.py's
  false-closure graph, whose optimum is far above float32 noise (on a
  flat valley the last accepts follow rounding).  JAX's solve runs
  jitted: run op by op it gives the same iterations and poses within
  3e-7 of the jitted one on this graph, but its dispatches take ~7 s to
  compile in a fresh process; test_torch_lm_step.py holds single steps
  op by op.

Tolerance elsewhere: none.
"""

import collections
import ctypes
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu.graph import solver as jax_solver
from ndt_2d_tpu_torch.config import SolverConfig
from ndt_2d_tpu_torch.graph import solver
from ndt_2d_tpu_torch.kernels import normal_blocks as k4
from port_configs import to_jax

torch.set_num_threads(2)

F = np.float32
# An H100's co-resident cooperative LM-step blocks.
FITS = 1056


def graph(seed, n=24, live=20, c_pad=64, near=True):
    """solve() inputs (numpy): ``live`` of ``n`` nodes, a chain, loop
    closures (some robust), a duplicate and a reversed pair, two
    self-loops, two masked constraints and masked padding to ``c_pad``;
    with ``near`` the transforms are the nodes' relative poses plus noise
    and the poses perturbed, so a step lowers the cost."""
    rng = np.random.default_rng(seed)
    pairs = [(k, k + 1) for k in range(live - 1)]
    loops = [(int(a), int(min(a + rng.integers(3, 9), live - 1)))
             for a in rng.integers(0, live - 4, 6)]
    pairs += loops + [loops[0], loops[1][::-1], (3, 3), (7, 7)]
    C = len(pairs)
    b = np.zeros(c_pad, np.int32)
    e = np.zeros(c_pad, np.int32)
    b[:C] = [p[0] for p in pairs]
    e[:C] = [p[1] for p in pairs]
    p = np.zeros((n, 3), np.float64)
    p[:live] = np.c_[np.cumsum(rng.uniform(0.3, 1.0, live)),
                     np.cumsum(rng.normal(0, 0.3, live)),
                     rng.uniform(-3, 3, live)]
    c, s = np.cos(p[b, 2]), np.sin(p[b, 2])
    d = p[e, :2] - p[b, :2]
    rel = np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1],
                    p[e, 2] - p[b, 2]], -1)
    transform = np.zeros((c_pad, 3), np.float32)
    transform[:C] = (rel[:C] + rng.normal(0, 0.02, (C, 3)) if near
                     else rng.normal(0, 1, (C, 3)))
    a = rng.normal(0, 1, (c_pad, 3, 3))
    info = ((a @ a.transpose(0, 2, 1) + 3 * np.eye(3)) * 30).astype(F)
    cmask = np.arange(c_pad) < C
    cmask[rng.choice(live - 1, 2, replace=False)] = False
    poses = p.astype(F)
    if near:
        poses[1:live] += rng.normal(0, 0.05, (live - 1, 3)).astype(F)
    return dict(poses=poses, begin=b, end=e, transform=transform,
                information=info, constraint_mask=cmask,
                node_mask=np.arange(n) < live,
                robust_mask=(np.arange(c_pad) >= live - 1) & cmask)


def tensors(g):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in g.items()}


def terms_of(t, loss, hdelta=1.0):
    return (t["begin"], t["end"], t["transform"], t["information"],
            t["constraint_mask"], t["robust_mask"], loss, hdelta)


def step_of(t, terms, lam=1e-6):
    """The dense LM step (delta, info) at the graph's poses, from the
    twins."""
    n = t["poses"].shape[0]
    inc = k4.incidence(t["begin"], t["end"], t["constraint_mask"], n)
    pairs = k4.pair_table(t["begin"], t["end"], t["constraint_mask"], n)
    fm = (t["node_mask"] & (torch.arange(n) != 0)).float()
    hm, rhs = k4.dense_normal_system_twin(t["poses"], *terms, inc, pairs,
                                          torch.tensor(lam), fm)
    return solver._dense_solve(n, hm, rhs)


# --- The numpy model --------------------------------------------------------


def model_costs(poses, delta, ok, begin, end, transform, information, cmask,
                rmask, loss, hdelta, threads):
    """robust_rho of every constraint, thread i of ``threads`` forming
    constraints i, i + threads, ... (each whole): the cost row."""
    P = poses.astype(F)
    if delta is not None:
        P = P + (delta.astype(F) if ok else F(np.nan))
    C = begin.shape[0]
    row = np.zeros(C, F)
    pi, two_pi = F(np.pi), F(2 * np.pi)
    for first in range(min(threads, C)):
        k = np.arange(first, C, threads)
        pa, pb = P[begin[k]], P[end[k]]
        dx, dy = pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1]
        th = torch.from_numpy(np.ascontiguousarray(pa[:, 2]))
        c, s = torch.cos(th).numpy(), torch.sin(th).numpy()
        t = transform[k]
        r0 = (c * dx + s * dy) - t[:, 0]
        r1 = (-s * dx + c * dy) - t[:, 1]
        a = (pb[:, 2] - pa[:, 2]) - t[:, 2]
        r2 = a - two_pi * np.floor((a + pi) / two_pi)
        lam = information[k]
        lr = [(lam[:, i, 0] * r0 + lam[:, i, 1] * r1) + lam[:, i, 2] * r2
              for i in range(3)]
        s2 = (r0 * lr[0] + r1 * lr[1]) + r2 * lr[2]
        d = F(hdelta)
        if loss == "huber":
            sn = np.sqrt(np.maximum(s2, F(1e-20)))
            rho = np.where(sn > d, d * (F(2) * sn - d), s2)
        elif loss == "geman_mcclure":
            rho = s2 / (F(1) + s2 / (d * d))
        else:
            rho = s2
        rho = np.where(rmask[k], rho, s2)
        row[k] = np.where(cmask[k], rho, F(0))
    return row


def block_sum(row):
    """Thread 0 of the one-block step: float4 groups in order, one add at
    a time, then the tail."""
    acc = F(0)
    n4 = row.size // 4
    for g in row[:4 * n4].reshape(-1, 4):
        for x in g:
            acc = F(acc + x)
    for x in row[4 * n4:]:
        acc = F(acc + x)
    return acc


def grid_sum(row, chunk=4096):
    """Block 0 of the cooperative step: the row staged ``chunk`` floats at
    a time, thread 0 adding each chunk in order."""
    acc = F(0)
    for c0 in range(0, row.size, chunk):
        for x in row[c0:c0 + chunk]:
            acc = F(acc + x)
    return acc


def model_update(poses, delta, ok, cost, lam, stall, total, down, up, tol,
                 threads):
    """lm_update: the accept, the damping (torch.clamp keeps a NaN), the
    stall count and the poses, node n written by thread n % threads."""
    accept = bool(total < cost)
    new = poses.copy()
    if accept:
        step = delta.astype(F) if ok else F(np.nan)
        for first in range(min(threads, poses.shape[0])):
            new[first::threads] = poses[first::threads] + step[
                first::threads]
    lam2 = F(lam * F(down)) if accept else F(lam * F(up))
    if lam2 == lam2:
        lam2 = F(min(max(lam2, F(1e-12)), F(1e8)))
    improved = bool(abs(F(cost - total)) > F(tol) * F(cost + F(1e-12)))
    return dict(poses=new, lam=lam2, cost=F(total) if accept else F(cost),
                stall=0 if accept and improved else stall + 1,
                flags=(accept, improved))


VARIANTS = {"one block": (k4.LM_BLOCK, block_sum),
            "grid of 3": (3 * k4.THREADS, grid_sum)}


def model_step(variant, mode, poses, delta, ok, terms, state, down, up, tol,
               new_cost=None):
    threads, add = VARIANTS[variant]
    arrays = [x.numpy() for x in terms[:6]]
    if mode != "update":
        total = add(model_costs(poses, delta, ok, *arrays, terms[6],
                                terms[7], threads))
        if mode == "cost":
            return total
    else:
        total = F(new_cost)
    return model_update(poses, delta, ok, state["cost"], state["lam"],
                        state["stall"], total, down, up, tol, threads)


def bits(x):
    return np.asarray(x, F).view(np.int32)


# --- Tests -----------------------------------------------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("loss", ["none", "huber", "geman_mcclure"])
def test_model_cost_is_the_twin_bitwise(variant, loss):
    t = tensors(graph(1, near=False))
    terms = terms_of(t, loss, 0.5)
    delta, info = step_of(t, terms)
    for d, ok in ((None, True), (delta, True), (delta, False)):
        twin = k4.robust_cost_twin(
            t["poses"], d, None if ok else torch.ones_like(info), *terms)
        ours = model_step(variant, "cost", t["poses"].numpy(),
                          None if d is None else d.numpy(), ok, terms, None,
                          0.5, 10.0, 1e-9)
        if ok:
            assert bits(ours) == bits(twin.numpy())
        else:  # a NaN step: both NaN (payloads are not compared)
            assert np.isnan(ours) and np.isnan(float(twin))


STEPS = {"accepted": (1.0, False), "rejected": (100.0, False),
         "NaN step": (1.0, True)}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("loss", ["none", "huber", "geman_mcclure"])
@pytest.mark.parametrize("case", list(STEPS))
def test_model_step_is_the_twin_bitwise(variant, loss, case):
    scale, nan = STEPS[case]
    t = tensors(graph(2))
    terms = terms_of(t, loss)
    delta, info = step_of(t, terms)
    delta = delta * scale
    if nan:
        info = torch.ones_like(info)
    cost0 = k4.robust_cost_twin(t["poses"], None, None, *terms)
    state = k4.lm_state(t["poses"], 1e-6, cost0, t["begin"].shape[0])
    state.stall.fill_(1)
    before = dict(cost=cost0.numpy()[()], lam=F(1e-6), stall=1)
    k4.lm_step_twin(state, delta, info, *terms, 0.5, 10.0, 1e-9)
    ours = model_step(variant, "step", t["poses"].numpy(), delta.numpy(),
                      not nan, terms, before, 0.5, 10.0, 1e-9)
    assert ours["flags"] == tuple(bool(x) for x in state.flags)
    assert ours["flags"][0] == (case == "accepted")
    assert (bits(ours["poses"]) == bits(state.poses.numpy())).all()
    for f in ("lam", "cost"):
        assert bits(ours[f]) == bits(getattr(state, f).numpy())
    assert ours["stall"] == int(state.stall)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_model_update_mode_is_the_twins_combined_step(variant):
    """The mesh's update launch: the cost comes from the combine."""
    t = tensors(graph(3))
    terms = terms_of(t, "geman_mcclure")
    delta, info = step_of(t, terms)
    cost0 = k4.robust_cost_twin(t["poses"], None, None, *terms)
    for factor in (0.5, 2.0):
        state = k4.lm_state(t["poses"], 1e-6, cost0, t["begin"].shape[0])
        seen = []

        def combine(x):
            seen.append(x.clone())
            return x * factor
        k4.lm_step_twin(state, delta, info, *terms, 0.5, 10.0, 1e-9,
                        combine)
        given = (seen[0] * factor).numpy()[0]
        before = dict(cost=cost0.numpy()[()], lam=F(1e-6), stall=0)
        ours = model_step(variant, "update", t["poses"].numpy(),
                          delta.numpy(), True, terms, before, 0.5, 10.0, 1e-9,
                          new_cost=given)
        assert (bits(ours["poses"]) == bits(state.poses.numpy())).all()
        assert bits(ours["cost"]) == bits(state.cost.numpy())
        assert ours["flags"] == tuple(bool(x) for x in state.flags)


@pytest.mark.parametrize("C", [0, 1, 3, 4, 5, 1023, 1024, 1027, 4095, 4096,
                               4097, 9001])
def test_the_variants_add_the_same_bits(C):
    """Thread 0's float4 groups and the grid's 4096-float stages add the
    same values in the same order as one add at a time."""
    rng = np.random.default_rng(C)
    row = (rng.normal(0, 1, C) * 10.0 ** rng.integers(-6, 6, C)).astype(F)
    row[rng.random(C) < 0.1] = 0
    one = np.add.accumulate(np.r_[F(0), row].astype(F))[-1]
    assert bits(block_sum(row)) == bits(grid_sum(row)) == bits(one)
    assert bits(grid_sum(row)) == bits(
        k4.ordered_sum_twin(torch.from_numpy(row)).numpy())


@pytest.mark.parametrize("C,fits,blocks", [
    (1024, FITS, 0), (0, FITS, 0), (12287, FITS, 0), (12287, 4, 0),
    (12288, FITS, 48), (55000, FITS, 215), (58112, FITS, 227),
    (200_000, FITS, 782), (100_000, 8, 8)])
def test_launch_shape(C, fits, blocks):
    """One block up to 12287 constraints (every dense solve), the
    cooperative grid beyond (the district's PCG solve, ~55k)."""
    assert k4.lm_blocks(C, 1000, fits) == blocks
    assert k4.lm_one_block(C) == (blocks == 0)


def test_a_card_without_room_for_either_refuses():
    with pytest.raises(RuntimeError):
        k4.lm_blocks(100_000, 1000, 0)


def plan_inputs(seed=2, loss="huber"):
    t = tensors(graph(seed))
    terms = terms_of(t, loss)
    n = t["poses"].shape[0]
    inc = k4.incidence(t["begin"], t["end"], t["constraint_mask"], n)
    pairs = k4.pair_table(t["begin"], t["end"], t["constraint_mask"], n)
    fm = (t["node_mask"] & (torch.arange(n) != 0)).float()
    cost0 = k4.robust_cost_twin(t["poses"], None, None, *terms)
    state = k4.lm_state(t["poses"], 1e-6, cost0, t["begin"].shape[0])
    return t, terms, inc, pairs, fm, state


def test_plan_structures_have_the_c_layout():
    """x86-64 layout of csrc/normal_blocks.cu's Lm, LmLaunch and
    DenseNormal (pointers 8-byte aligned, a structure padded to 8)."""
    assert ctypes.sizeof(k4._Lm) == 168
    assert k4._Lm.hdelta.offset == 84 and k4._Lm.rho.offset == 96
    assert k4._Lm.tol.offset == 160
    assert ctypes.sizeof(k4._LmLaunch) == 176
    assert k4._LmLaunch.blocks.offset == 168
    assert ctypes.sizeof(k4._Graph) == 64
    assert ctypes.sizeof(k4._DenseNormal) == 160
    assert k4._DenseNormal.b_ptr.offset == 72
    assert k4._DenseNormal.rhs.offset == 152


@pytest.mark.parametrize("loss", ["huber", "geman_mcclure"])
def test_plan_packs_each_launch_once(loss):
    t, terms, inc, pairs, fm, state = plan_inputs(loss=loss)
    plan = k4.DensePlan(state, *terms, inc, pairs, fm, 0.5, 10.0, 1e-9)
    N, C = state.poses.shape[0], terms[0].shape[0]
    p = lambda x: x.data_ptr()  # noqa: E731
    g = plan.system_args.g
    assert (g.poses, g.begin, g.end, g.transform, g.information, g.cmask,
            g.robust_mask) == tuple(p(x) for x in (
                state.poses, *terms[:6]))
    assert g.loss == k4.LOSSES[loss] and g.delta == 1.0
    sa = plan.system_args
    assert (sa.C, sa.n) == (C, N)
    assert (sa.b_ptr, sa.b_idx, sa.e_ptr, sa.e_idx) == (
        p(inc.b_ptr), p(inc.b_idx), p(inc.e_ptr), p(inc.e_idx))
    assert (sa.keys, sa.src, sa.row_ptr, sa.lam, sa.fm, sa.hm, sa.rhs) == (
        p(pairs.keys), p(pairs.src), p(pairs.row_ptr), p(state.lam), p(fm),
        p(plan.hm), p(plan.rhs))
    a = plan.step_args.a
    assert a.mode == 1 and (a.C, a.N) == (C, N)
    assert (a.poses, a.delta, a.info, a.rho, a.lam, a.cost, a.stall,
            a.flags) == (p(state.poses), p(plan.delta), p(plan.info),
                         p(state.rho), p(state.lam), p(state.cost),
                         p(state.stall), p(state.flags))
    assert a.out is None and a.new_cost is None
    assert (a.down, a.up) == (0.5, 10.0) and a.tol == F(1e-9)
    # A CPU plan asks no card for a launch shape, and runs the twins.
    assert plan.eager == (k4.dense_normal_system, k4.lm_step)
    assert plan.step_args.blocks == 0
    assert plan.hm.shape == (3 * N, 3 * N) and plan.rhs.shape == (3 * N,)
    assert plan.factor.stride() == (1, 3 * N)
    assert plan.delta.shape == (N, 3) and plan.info.dtype == torch.int32


@pytest.mark.parametrize("case", list(STEPS))
def test_a_cpu_plan_runs_the_twins(case):
    """system() is dense_normal_system_twin's system; step() steps the
    state as lm_step_twin does, on the plan's delta and info."""
    scale, nan = STEPS[case]
    t, terms, inc, pairs, fm, state = plan_inputs()
    ref = k4.lm_state(t["poses"], 1e-6, state.cost, terms[0].shape[0])
    plan = k4.DensePlan(state, *terms, inc, pairs, fm, 0.5, 10.0, 1e-9)
    hm, rhs = plan.system()
    hmt, rhst = k4.dense_normal_system_twin(t["poses"], *terms, inc, pairs,
                                            state.lam, fm)
    assert torch.equal(hm.view(torch.int32), hmt.view(torch.int32))
    assert torch.equal(rhs.view(torch.int32), rhst.view(torch.int32))
    solver._dense_solve(state.poses.shape[0], hm, rhs, plan.solve_out)
    plan.delta.mul_(scale)
    if nan:
        plan.info.fill_(1)
    plan.step()
    k4.lm_step_twin(ref, plan.delta, plan.info, *terms, 0.5, 10.0, 1e-9)
    for f in ("poses", "lam", "cost", "stall", "flags"):
        assert torch.equal(getattr(state, f), getattr(ref, f)), f
    assert bool(state.flags[0]) == (case == "accepted")


@pytest.mark.parametrize("bad", ["begin dtype", "transform shape",
                                 "incidence nodes", "rho shape",
                                 "stall dtype"])
def test_plan_checks_every_tensor_when_built(bad):
    t, terms, inc, pairs, fm, state = plan_inputs()
    terms = list(terms)
    if bad == "begin dtype":
        terms[0] = terms[0].long()
    elif bad == "transform shape":
        terms[2] = terms[2][:, :2].contiguous()
    elif bad == "incidence nodes":
        inc = k4.incidence(t["begin"], t["end"], t["constraint_mask"],
                           t["poses"].shape[0] + 1)
    elif bad == "rho shape":
        state.rho = state.rho[:-1]
    else:
        state.stall = state.stall.long()
    with pytest.raises((TypeError, ValueError)):
        k4.DensePlan(state, *terms, inc, pairs, fm, 0.5, 10.0, 1e-9)


class Counted:
    """Counts the calls of K4's wrappers the LM loop may take, and the
    plans it builds (``plan``) and their two calls."""

    NAMES = ("dense_normal_system", "normal_blocks", "dense_system",
             "pcg_normal_system", "pcg_solve", "lm_step", "robust_cost")

    def __init__(self, monkeypatch):
        self.calls = collections.Counter()
        for name in self.NAMES:
            monkeypatch.setattr(k4, name, self.wrap(name, getattr(k4, name)))
        for name, method in (("plan", "__init__"), ("system", "system"),
                             ("step", "step")):
            monkeypatch.setattr(k4.DensePlan, method, self.wrap(
                name, getattr(k4.DensePlan, method)))

    def wrap(self, name, real):
        def call(*args, **kwargs):
            self.calls[name] += 1
            return real(*args, **kwargs)
        return call

    def take(self):
        out = {k: v for k, v in self.calls.items() if v}
        self.calls.clear()
        return out


@pytest.fixture
def planned(monkeypatch):
    return Counted(monkeypatch)


def unplanned_solve(cfg, t):
    """The LM loop of one device's dense solve as it ran before the plan:
    the public wrappers (``dense_normal_system``, the library's solve with
    no out buffers, ``lm_step``) called afresh every iteration.  Returns
    (poses, cost, iterations) as ``solve`` would."""
    n = t["poses"].shape[0]
    terms = (t["begin"], t["end"], t["transform"], t["information"],
             t["constraint_mask"], t["robust_mask"], cfg.robust_loss,
             cfg.huber_delta)
    inc = k4.incidence(t["begin"], t["end"], t["constraint_mask"], n)
    pairs = k4.pair_table(t["begin"], t["end"], t["constraint_mask"], n)
    fm = (t["node_mask"] & (torch.arange(n) != 0)).float()
    cost0 = k4.robust_cost(t["poses"], None, None, *terms)
    state = k4.lm_state(t["poses"], cfg.lm_lambda_init, cost0,
                        t["begin"].shape[0])
    it = 0
    while it < cfg.max_iterations and int(state.stall) < 3:
        delta, info = solver._dense_solve(n, *k4.dense_normal_system(
            state.poses, *terms, inc, pairs, state.lam, fm))
        k4.lm_step(state, delta, info, *terms, cfg.lm_lambda_down,
                   cfg.lm_lambda_up, cfg.tolerance)
        it += 1
    ok = bool(torch.isfinite(state.cost) & (state.cost <= cost0))
    return (state.poses if ok else t["poses"]), state.cost, it


@pytest.mark.parametrize("loss", ["none", "huber", "geman_mcclure"])
def test_a_dense_solve_builds_one_plan_and_launches_it(planned, loss):
    t = tensors(graph(4))
    cfg = SolverConfig(robust_loss=loss)
    res = solver.solve(cfg, **t, use_dense=True)
    it = int(res.iterations)
    assert it >= 2 and bool(res.success)
    # One cost launch before the loop, one plan, and its two calls once an
    # iteration (on the CPU through the wrappers, which run the twins).
    assert planned.take() == {"robust_cost": 1, "plan": 1, "system": it,
                              "step": it, "dense_normal_system": it,
                              "lm_step": it}
    poses, cost, plain_it = unplanned_solve(cfg, t)
    assert planned.take() == {"robust_cost": 1, "dense_normal_system": it,
                              "lm_step": it}
    assert plain_it == it
    assert torch.equal(poses.view(torch.int32), res.poses.view(torch.int32))
    assert torch.equal(cost.view(torch.int32), res.cost.view(torch.int32))


def test_pcg_and_a_mesh_keep_the_wrappers(planned, monkeypatch):
    t = tensors(graph(5))
    cfg = SolverConfig(robust_loss="geman_mcclure")
    pcg = solver.solve(cfg, **t, use_dense=False)
    it = int(pcg.iterations)
    assert planned.take() == {"robust_cost": 1, "pcg_normal_system": it,
                              "pcg_solve": it, "lm_step": it}
    monkeypatch.setattr(solver, "_constraint_shard",
                        lambda mesh, arrays: (list(arrays), lambda x: x))
    mesh = solver.solve(cfg, **t, use_dense=True, mesh=object())
    it = int(mesh.iterations)
    assert planned.take() == {"robust_cost": 1, "normal_blocks": it,
                              "dense_system": it, "lm_step": it}
    dense = solver.solve(cfg, **t, use_dense=True)
    assert planned.take()["plan"] == 1
    assert torch.equal(mesh.poses, dense.poses)


def test_twin_solves_run_the_plan_on_the_twins(planned):
    """A twin solve takes the same loop: one plan, whose calls run the
    twins (not the wrappers), bitwise the solve without ``twin``."""
    t = tensors(graph(6))
    twin = solver.solve(SolverConfig(), **t, use_dense=True, twin=True)
    it = int(twin.iterations)
    assert planned.take() == {"plan": 1, "system": it, "step": it}
    ours = solver.solve(SolverConfig(), **t, use_dense=True)
    assert torch.equal(ours.poses.view(torch.int32),
                       twin.poses.view(torch.int32))


def false_closure():
    """tests/test_graph.py's 12-node chain with a loop and a false robust
    closure (test_torch_solver.py's): its optimum cost is far above float32
    noise, so the iteration the loop stops at is decided by the step, not
    by rounding."""
    spec = importlib.util.spec_from_file_location(
        "graph_fixtures", os.path.join(os.path.dirname(__file__),
                                       "test_graph.py"))
    fixtures = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixtures)
    g, _ = fixtures._chain_with_loop(n=12, drift=0.02, seed=5)
    g.add_constraint(3, 8, [0.0, 0.0, 0.0],
                     np.linalg.inv(np.diag([0.01, 0.01, 0.005])),
                     switchable=True)
    n, c = g.num_scans, g.num_constraints
    return dict(poses=g.poses.astype(F),
                begin=g.constraint_begin.astype(np.int32),
                end=g.constraint_end.astype(np.int32),
                transform=g.constraint_transform.astype(F),
                information=g.constraint_information.astype(F),
                constraint_mask=np.ones(c, bool), node_mask=np.ones(n, bool),
                robust_mask=g.constraint_switchable.astype(bool))


@pytest.mark.parametrize("loss", ["none", "huber", "geman_mcclure"])
@pytest.mark.parametrize("max_iterations", [100, 3])
def test_planned_solve_matches_jax(planned, loss, max_iterations):
    g = false_closure()
    cfg = SolverConfig(robust_loss=loss, huber_delta=1.0,
                       max_iterations=max_iterations)
    ours = solver.solve(cfg, **tensors(g), use_dense=True)
    assert planned.calls["plan"] == 1
    ref = jax_solver.solve(to_jax(cfg), **{k: jnp.asarray(v)
                                           for k, v in g.items()},
                           use_dense=True)
    assert int(ours.iterations) == int(ref.iterations)
    assert bool(ours.success) == bool(ref.success)
    np.testing.assert_allclose(ours.poses.numpy(), np.asarray(ref.poses),
                               atol=1e-6)
    np.testing.assert_allclose(float(ours.cost), float(ref.cost), rtol=1e-5)
