"""K12's split K2 search under a plan and the fused step's KB4
(``kernels/candidate_scores.py::SplitPlan``, ``kernels/slam_step.py``,
``parallel/matcher.py::search_rows``, ``parallel/slam_step.py::
append_route``).  The kernels run only on the card, where ``chip_smoke.py``
holds each form bitwise against its twin; here:

* the finalize's in-place index rule (``finalize_gathered_twin``, and a
  numpy model of ``csrc/candidate_scores.cu::split_at``) against
  ``finalize_rows_twin`` on the permuted copy the search made before the
  plan, with NaN in every slot the rule must not read;
* ``finalize_append``'s twin (the plan's CPU path with an ``Append``)
  against ``finalize_rows_twin`` then ``append_twin``, and the planned
  KB4's twin against ``append_twin``, on every state field;
* the dispatch rule, and the search's glue: no tensor operation between
  the partials and the finalize;
* the folded step's constraint against JAX's ``make_constraint`` run op by
  op, at ``test_torch_slam_step.py::test_append_twin_matches_jax_op_by_op``'s
  tolerance (LAPACK's inverse against the port's LU).

Tolerance: none (bitwise), except against JAX.
"""

import ctypes
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ndt_2d_tpu.core import constraint as jax_constraint
from ndt_2d_tpu_torch.config import ScanMatcherConfig
from ndt_2d_tpu_torch.kernels import candidate_gather as k6
from ndt_2d_tpu_torch.kernels import candidate_scores as k2
from ndt_2d_tpu_torch.kernels import slam_step as kb4
from ndt_2d_tpu_torch.parallel import matcher as pmatcher
from ndt_2d_tpu_torch.parallel import slam_step

torch.set_num_threads(2)

L = 5
CONFIG = ScanMatcherConfig(laser_max_beams=100)


def lattice(A: int):
    dths = torch.linspace(-0.2, 0.2, A, dtype=torch.float32)
    dls = torch.linspace(-0.1, 0.1, L, dtype=torch.float32)
    return dths, dls


def partials(R: int, A: int, seed: int = 0):
    """[R, A, 12] partials like the search's: lows with ties and +-inf,
    each angle's first flat index in the lattice, Olson sums."""
    rng = np.random.default_rng(seed)
    best = rng.choice([-3.0, -2.5, -1.0, 0.0, 2.0], (R, A)).astype(np.float32)
    best[:, rng.integers(0, A, 2)] = -np.inf
    best[:, rng.integers(0, A, 2)] = np.inf
    index = (np.arange(A)[None, :] * L * L
             + rng.integers(0, L * L, (R, A))).astype(np.int32)
    sums = rng.normal(0.0, 1.0, (R, A, 10)).astype(np.float32)
    sums[..., 0] = -np.abs(sums[..., 0])
    out = np.concatenate([best[..., None], index.view(np.float32)[..., None],
                          sums], -1)
    return torch.from_numpy(out)


def blocks(rows, S: int):
    """Each rank's [R, n_s, 12] block of a lattice's partials."""
    A = rows.shape[1]
    return [rows[:, a0:a0 + n] for a0, n in
            (pmatcher.angle_block(A, S, s) for s in range(S))]


def parents_copy(rows, S: int):
    """The partials as the search reordered them before the plan: each
    block padded to ceil(A / S) with (+inf, 0) slots, stacked in rank
    order, permuted, the padding sliced off."""
    R, A = rows.shape[:2]
    blk = -(-A // S)
    mine = []
    for b in blocks(rows, S):
        pad = torch.zeros(R, blk - b.shape[1], 12)
        pad[..., 0] = math.inf
        mine.append(torch.cat([b, pad], 1))
    every = torch.stack(mine).permute(1, 0, 2, 3).reshape(R, S * blk, 12)
    return every[:, :A].contiguous()


def stacked(rows, S: int):
    """The plan's stack after the all-gather: each rank's block at the
    head of its R x blk partials, NaN everywhere the rule must not read;
    [S, R, blk, 12]."""
    R, A = rows.shape[:2]
    blk = -(-A // S)
    flat = torch.full((S, R * blk * 12), math.nan)
    for s, b in enumerate(blocks(rows, S)):
        flat[s, :b.numel()] = b.reshape(-1)
    return flat.view(S, R, blk, 12)


def split_at_model(flat, R: int, A: int, blk: int):
    """numpy model of the kernel's staging: row r's angle a read at
    (s R blk + r n_s + j) 12, s = a / blk, j = a - s blk, n_s = min(blk,
    A - s blk)."""
    out = np.empty((R, A, 12), np.float32)
    for r in range(R):
        for a in range(A):
            s, j = a // blk, a % blk
            n = min(blk, A - s * blk)
            at = (s * R * blk + r * n + j) * 12
            out[r, a] = flat[at:at + 12]
    return out


@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("A", [40, 80, 81])
def test_in_place_rule_matches_the_permuted_copy(S, A):
    R = 3
    rows = partials(R, A, seed=S * 100 + A)
    dths, dls = lattice(A)
    nums = torch.tensor([40, 100, 7], dtype=torch.int32)
    g = stacked(rows, S)
    copy = parents_copy(rows, S)
    assert torch.equal(k2.gathered_rows(g, A), copy)
    model = split_at_model(g.reshape(-1).numpy(), R, A, g.shape[2])
    assert np.array_equal(model.view(np.int32), copy.numpy().view(np.int32))
    want = k2.finalize_rows_twin(CONFIG, copy, nums, dths, dls)
    got = k2.finalize_gathered_twin(CONFIG, g, nums, dths, dls)
    assert torch.equal(got, want)
    # The plan's CPU path reads its own stack by the same rule.
    plan = k2.SplitPlan("cpu", S, R, A, L, True)
    plan.stack.copy_(g.reshape(S, -1))
    assert torch.equal(plan.finalize(CONFIG, plan.stack, nums, dths, dls),
                       want)


def test_gathered_rows_refuses_a_wrong_block():
    with pytest.raises(ValueError, match="do not split"):
        k2.gathered_rows(torch.zeros(2, 1, 30, 12), 81)


def new_state(cap=6, P=8, seed=0):
    st = slam_step.init_state(cap, P, cap, device="cpu")
    rng = np.random.default_rng(seed)
    st.prev_pose.copy_(torch.tensor([1.0, 2.0, 0.3]))
    st.poses.copy_(torch.from_numpy(rng.normal(0, 1, (cap, 3)).astype(
        np.float32)))
    return st


FIELDS = ("poses", "points", "point_mask", "c_begin", "c_end",
          "c_transform", "c_information", "prev_pose")


def step_inputs(P=8, seed=3):
    rng = np.random.default_rng(seed)
    return (torch.tensor([1.2, 2.05, 0.31]),
            torch.from_numpy(rng.normal(0, 2, (P, 2)).astype(np.float32)),
            torch.from_numpy(rng.random(P) > 0.3))


def one_row_search(A=80, S=2, seed=5):
    """A one-row stack whose winner applies (best < 0) with an Olson
    covariance (s < 0)."""
    rows = partials(1, A, seed)
    rows[0, :, 0] = torch.where(torch.isfinite(rows[0, :, 0]),
                                rows[0, :, 0], torch.tensor(-0.5))
    rows[0, :, 2] = -torch.rand(A, generator=torch.Generator().manual_seed(
        seed)) - 0.5
    return rows, stacked(rows, S)


@pytest.mark.parametrize("has_prior", [False, True])
@pytest.mark.parametrize("slot", [0, 5], ids=["first", "last"])
def test_finalize_append_twin_is_finalize_then_append(has_prior, slot):
    A, S = 80, 2
    rows, g = one_row_search(A, S)
    dths, dls = lattice(A)
    est, pts, msk = step_inputs()
    got, want = new_state(), new_state()
    plan = k2.SplitPlan("cpu", S, 1, A, L, False)
    plan.stack.copy_(g.reshape(S, -1))
    fold = kb4.Append(kb4.plan_for(got), est, pts, msk, slot, slot,
                      has_prior)
    out = plan.finalize(CONFIG, plan.stack, 60, dths, dls, fold)
    row = k2.finalize_rows_twin(CONFIG, parents_copy(rows, S), 60, dths, dls)
    kb4.append_twin(want, est, row[0, 1:4], row[0, 4:13].view(3, 3), pts,
                    msk, slot, slot, has_prior)
    assert torch.equal(out, row)
    assert bool(row[0, 0] < 0) and bool((row[0, 1:4] != 0).any())
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("has_prior", [False, True])
def test_planned_kb4_twin_matches_append_twin(has_prior):
    est, pts, msk = step_inputs()
    corr = torch.tensor([0.005, -0.01, 0.0025])
    cov = torch.tensor([[2e-4, 1e-5, 2e-6], [1e-5, 3e-4, -1e-6],
                        [2e-6, -1e-6, 4e-5]])
    got, want = new_state(), new_state()
    before = kb4.launches
    kb4.plan_for(got).append(est, corr, cov, pts, msk, 4, 3, has_prior)
    kb4.append_twin(want, est, corr, cov, pts, msk, 4, 3, has_prior)
    assert kb4.launches == before  # the twin: no launch
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_the_plan_is_kept_until_the_state_changes():
    st = new_state()
    plan = kb4.plan_for(st)
    assert kb4.plan_for(st) is plan and plan.holds(st)
    st.poses = st.poses.clone()
    assert not plan.holds(st) and kb4.plan_for(st) is not plan
    with pytest.raises(ValueError, match="outside the state's capacity"):
        kb4.plan_for(st).append(*step_inputs()[:1], torch.zeros(3),
                                torch.eye(3), *step_inputs()[1:], 6, 0,
                                True)


def test_split_plans_are_kept_by_key():
    a = k2.split_plan(torch.device("cpu"), 2, 1, 80, L, False)
    assert k2.split_plan(torch.device("cpu"), 2, 1, 80, L, False) is a
    b = k2.split_plan(torch.device("cpu"), 2, 1, 80, L, True)
    assert b is not a and b.blk == a.blk == 40
    assert a.head(40).shape == (1, 40, 12) and a.head(40) is a.head(40)
    assert a.head(39).data_ptr() == a.send.data_ptr()
    with pytest.raises(ValueError):
        a.head(41)


def test_ctypes_layouts():
    """The mirrors have the C structures' sizes on a 64-bit host
    (``ndt2d_split_plan_size`` / ``ndt2d_slam_plan_size`` check them on
    the card)."""
    assert ctypes.sizeof(k2._SplitFinalize) == 3 * 8 + 5 * 4 + 4
    assert ctypes.sizeof(kb4._StepState) == 8 * 8 + 8


MESH = object()


@pytest.mark.parametrize("mesh,search,refine,route", [
    (None, k2, 0, slam_step.PLANNED), (None, k2, 3, slam_step.PLANNED),
    (None, k6, 0, slam_step.PLANNED), (None, k6, 3, slam_step.PLANNED),
    (MESH, k2, 0, slam_step.FOLDED), (MESH, k2, 3, slam_step.PLANNED),
    (MESH, k6, 0, slam_step.PLANNED), (MESH, k6, 3, slam_step.PLANNED)])
def test_append_route(mesh, search, refine, route):
    assert slam_step.append_route(mesh, search, refine) == route


class Ops(TorchDispatchMode):
    """Records the aten operations dispatched outside the stubbed
    launches."""

    def __init__(self):
        super().__init__()
        self.events, self.depth = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.depth == 0:
            self.events.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


# Operations that launch nothing: views and allocations.
QUIET = {"empty", "new_empty", "view", "slice", "unsqueeze", "alias",
         "as_strided", "select", "detach", "reshape", "_unsafe_view"}


@pytest.mark.parametrize("S", [1, 2, 3])
def test_no_tensor_operation_between_the_partials_and_the_finalize(
        S, monkeypatch):
    """The search's glue on rank S - 1 of a ``space`` line of S ranks:
    the partials launch into the plan's send buffer, the all-gather into
    its stack (an NCCL collective, not a tensor operation), then the
    finalize; the partials and the finalize stubbed as launches."""
    A, R = 81, 2
    dths, dls = lattice(A)
    mode = Ops()

    def inside(name, fn):
        def call(*a, **kw):
            mode.events.append(name)
            mode.depth += 1
            try:
                return fn(*a, **kw)
            finally:
                mode.depth -= 1
        return call
    plan = k2.split_plan(torch.device("cpu"), S, R, A, L, True)
    monkeypatch.setattr(pmatcher, "axis_size", lambda mesh, axis: S)
    monkeypatch.setattr(pmatcher, "axis_rank", lambda mesh, axis: S - 1)
    monkeypatch.setattr(pmatcher, "axis_group", lambda mesh, axis: "line")
    monkeypatch.setattr(k2, "partial_rows", inside(
        "partials", lambda *a, out: out))
    monkeypatch.setattr(pmatcher.distributed, "gather", inside(
        "gather", lambda t, group, out: t[None] if S == 1 else out))
    monkeypatch.setattr(plan, "finalize", inside(
        "finalize", lambda *a: torch.empty(R, 13)))
    nums = torch.tensor([30, 30], dtype=torch.int32)
    points = torch.zeros(R, 4, 2)
    with mode:
        pmatcher.search_rows(k2, CONFIG, "mesh", None, None, points, None,
                             nums, None, dths, dls)
    ev = mode.events
    assert ev.index("partials") < ev.index("gather") < ev.index("finalize")
    between = ev[ev.index("partials") + 1:ev.index("finalize")]
    assert set(between) - {"gather"} <= QUIET, between
    assert not set(ev) - QUIET - {"partials", "gather", "finalize"}, ev


@pytest.mark.parametrize("has_prior", [False, True])
def test_folded_constraint_matches_jax_op_by_op(has_prior):
    """The fold's append (its twin) against slam_step.py:99-124 run op by
    op from the finalize's own correction and covariance."""
    A, S = 80, 2
    _, g = one_row_search(A, S, seed=11)
    dths, dls = lattice(A)
    est, pts, msk = step_inputs(seed=4)
    st = new_state(seed=2)
    prev = st.prev_pose.clone()
    plan = k2.SplitPlan("cpu", S, 1, A, L, False)
    plan.stack.copy_(g.reshape(S, -1))
    out = plan.finalize(CONFIG, plan.stack, 60, dths, dls,
                        kb4.Append(kb4.plan_for(st), est, pts, msk, 2, 1,
                                   has_prior))
    corr, cov = out[0, 1:4].numpy(), out[0, 4:13].reshape(3, 3).numpy()
    with jax.disable_jit():
        e = jnp.asarray(est.numpy())
        corrected = jnp.where(has_prior, e + jnp.asarray(corr), e)
        _, _, tr, info, _ = jax_constraint.make_constraint(
            1, 2, jnp.asarray(prev.numpy()), corrected, jnp.asarray(cov))
    np.testing.assert_array_equal(st.poses[2].numpy(), np.asarray(corrected))
    np.testing.assert_array_equal(st.prev_pose.numpy(),
                                  np.asarray(corrected))
    np.testing.assert_array_equal(st.points[2].numpy(), pts.numpy())
    np.testing.assert_array_equal(st.point_mask[2].numpy(), msk.numpy())
    assert (int(st.c_begin[1]), int(st.c_end[1])) == (1, 2)
    np.testing.assert_allclose(st.c_transform[1].numpy(), np.asarray(tr),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(st.c_information[1].numpy(),
                               np.asarray(info), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(info)).max())
