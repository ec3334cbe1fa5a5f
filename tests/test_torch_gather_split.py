"""K12's split K6 search under a plan (``kernels/candidate_scores.py::
SplitPlan`` at K6's partials an angle, ``parallel/matcher.py::
search_rows``).

K6's split search no longer pads, reorders and copies its gathered
blocks: the partials launch writes the head of the plan's send buffer,
the all-gather writes the plan's stack, and K2's finalize launch reads
the stack in place, ``per`` = ``candidate_gather.blocks_per_angle``
partials an angle (``csrc/candidate_scores.cu::split_at``).  The kernels
run only on the card, where ``chip_smoke.py`` holds every fold form
bitwise against its twin; here, on the CPU twins:

* the plan's eager path against the one-device ``match_rows_twin``,
  bitwise, at S = 1, 2, 3 ranks (a short and an empty last block) and
  per = 1, 2, 7 (8, 21 and 40 offsets an axis);
* a numpy model of the in-place index rule with ``per`` against
  ``gathered_rows``, NaN in every slot the rule must not read;
* the search's glue on K6: no tensor operation between the partials and
  the finalize;
* a gloo two-rank K6 search against one device, bitwise (this file is
  also the ranks' script);
* the plan's refusals: a buffer not its own, ``num_points`` in the other
  form, an append on a K6 plan.

Tolerance: none (bitwise).
"""

import math
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ndt_2d_tpu_torch.config import ScanMatcherConfig
from ndt_2d_tpu_torch.kernels import candidate_gather as k6
from ndt_2d_tpu_torch.kernels import candidate_scores as k2
from ndt_2d_tpu_torch.kernels import ndt_build as k1
from ndt_2d_tpu_torch.parallel import matcher as pmatcher

import torch_mesh_ranks as ranks

torch.set_num_threads(2)

R = 2


def config(linear: float, angular: float = 0.025) -> ScanMatcherConfig:
    """A coarse lattice on 0.5 m cells: 5 angles x L x L offsets of 5 cm,
    L = 8, 21, 40 at 0.2, 0.5, 1.0 m (1, 2, 7 partials an angle)."""
    return ScanMatcherConfig(
        ndt_resolution=0.5, search_linear_size=linear,
        search_linear_resolution=0.05, search_angular_size=angular,
        search_angular_resolution=0.01, grid_cells_x=96, grid_cells_y=96,
        laser_max_beams=40)


CONFIGS = {1: config(0.2), 2: config(0.5), 7: config(1.0)}


def search_rows_inputs(cfg, n_rows=R):
    """Confirmation rows of box windows, the queries started off."""
    pts, msk, truth = ranks.box_scans(8, beams=120)
    wp = torch.tensor(np.stack([truth[i:i + 3] for i in range(n_rows)]),
                      dtype=torch.float32)
    wpts = torch.tensor(np.stack([pts[i:i + 3] for i in range(n_rows)]))
    wm = torch.tensor(np.stack([msk[i:i + 3] for i in range(n_rows)]))
    grid, tables = k1.build_windows(
        wp, wpts, wm, torch.ones(n_rows, 3, dtype=torch.bool),
        ranks.RANGE_MAX, cfg.ndt_resolution, cfg.grid_cells_x,
        cfg.grid_cells_y, 1)
    q = torch.tensor(pts[5:5 + n_rows])
    qm = torch.tensor(msk[5:5 + n_rows])
    qn = qm.sum(1).to(torch.int32)
    st = torch.tensor(truth[5:5 + n_rows] + [0.12, -0.08, 0.015],
                      dtype=torch.float32)
    return grid, tables, q, qm, qn, st


@pytest.fixture(scope="module")
def searches():
    """Each lattice's rows, offsets and one-device twin rows."""
    out = {}
    for per, cfg in CONFIGS.items():
        rows = search_rows_inputs(cfg)
        dths, dls = k2.search_offsets(cfg, "cpu")
        assert k6.blocks_per_angle(dls) == per and dths.numel() == 5
        res, _ = k6.match_rows_twin(cfg, *rows, dths, dls)
        out[per] = (cfg, rows, dths, dls, k2.pack(res))
    return out


def planned_stack(cfg, rows, dths, dls, S: int):
    """The plan of S ranks, its stack filled as the all-gather leaves it:
    each rank's partials through ``partial_rows(..., out=plan.head(n))``,
    NaN in every slot the rule must not read."""
    A, per = dths.numel(), k6.blocks_per_angle(dls)
    plan = k2.SplitPlan("cpu", S, rows[2].shape[0], A, dls.numel(), True,
                        per)
    plan.stack.fill_(math.nan)
    for s in range(S):
        a0, n = pmatcher.angle_block(A, S, s)
        plan.send.fill_(math.nan)
        if n:
            out = k6.partial_rows(cfg, *rows, dths, dls, a0, n,
                                  out=plan.head(n))
            assert out.data_ptr() == plan.send.data_ptr()
        plan.stack[s].copy_(plan.send)
    return plan


@pytest.mark.parametrize("S", [1, 2, 3])
@pytest.mark.parametrize("per", [1, 2, 7])
def test_planned_split_equals_one_device(searches, S, per):
    """5 angles: S = 2 leaves a short last block (3, 2), S = 3 one of a
    single angle (2, 2, 1)."""
    cfg, rows, dths, dls, want = searches[per]
    plan = planned_stack(cfg, rows, dths, dls, S)
    assert plan.per == per and plan.head(plan.blk).shape == (
        R, plan.blk * per, 12)
    got = plan.finalize(cfg, plan.stack, rows[4], dths, dls)
    assert torch.equal(got, want)
    if S == 1:  # a group of one gathers nothing: the send buffer
        assert torch.equal(plan.finalize(cfg, plan.send[None], rows[4],
                                         dths, dls), want)


@pytest.mark.parametrize("per", [2, 7])
def test_planned_split_with_an_empty_last_block(searches, per):
    """4 of the 5 angles over 3 ranks: blocks of 2, 2 and none."""
    cfg, rows, dths, dls, _ = searches[per]
    dths = dths[:4].contiguous()
    res, _ = k6.match_rows_twin(cfg, *rows, dths, dls)
    plan = planned_stack(cfg, rows, dths, dls, 3)
    assert pmatcher.angle_block(4, 3, 2) == (4, 0)
    assert torch.equal(plan.finalize(cfg, plan.stack, rows[4], dths, dls),
                       k2.pack(res))


def split_at_model(flat, R: int, A: int, blk: int, per: int):
    """numpy model of the kernel's staging: row r's partial (j, t) of rank
    s at ((s R blk + r n_s) per + j per + t) 12, angle a = s blk + j,
    n_s = min(blk, A - s blk)."""
    out = np.empty((R, A * per, 12), np.float32)
    for r in range(R):
        for i in range(A * per):
            a, t = divmod(i, per)
            s, j = divmod(a, blk)
            n = min(blk, A - s * blk)
            at = ((s * R * blk + r * n) * per + j * per + t) * 12
            out[r, i] = flat[at:at + 12]
    return out


@pytest.mark.parametrize("S,A,per", [(2, 21, 7), (3, 21, 7), (4, 5, 2),
                                     (8, 21, 7)])
def test_in_place_rule_with_tiles(S, A, per):
    """The rule reads each rank's [R, n_s per, 12] block at the head of its
    buffer, in (angle, tile) order; a slot past a block is never read."""
    rng = np.random.default_rng(S * 100 + A)
    rows = torch.from_numpy(rng.normal(size=(3, A * per, 12)).astype(
        np.float32))
    blk = -(-A // S)
    flat = torch.full((S, 3 * blk * per * 12), math.nan)
    for s in range(S):
        a0, n = pmatcher.angle_block(A, S, s)
        block = rows[:, a0 * per:(a0 + n) * per]
        flat[s, :block.numel()] = block.reshape(-1)
    g = flat.view(S, 3, blk * per, 12)
    got = k2.gathered_rows(g, A)
    assert torch.equal(got, rows)
    model = split_at_model(g.reshape(-1).numpy(), 3, A, blk, per)
    assert np.array_equal(model.view(np.int32), rows.numpy().view(np.int32))


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


QUIET = {"empty", "new_empty", "view", "slice", "unsqueeze", "alias",
         "as_strided", "select", "detach", "reshape", "_unsafe_view"}


@pytest.mark.parametrize("S", [1, 2, 3])
def test_no_tensor_operation_between_k6s_partials_and_finalize(
        S, monkeypatch):
    """K6's glue on rank S - 1 of S: the partials into the plan's send
    buffer, the all-gather into its stack, the finalize; no padding, cat
    or reordering copy (the partials and the finalize stubbed as
    launches)."""
    A, L = 21, 40
    dths = torch.linspace(-0.1, 0.1, A)
    dls = torch.linspace(-1.0, 1.0, L)
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
    plan = k2.split_plan(torch.device("cpu"), S, R, A, L, True,
                         k6.blocks_per_angle(dls))
    monkeypatch.setattr(pmatcher, "axis_size", lambda mesh, axis: S)
    monkeypatch.setattr(pmatcher, "axis_rank", lambda mesh, axis: S - 1)
    monkeypatch.setattr(pmatcher, "axis_group", lambda mesh, axis: "line")
    heads = []

    def partials(*a, out):
        heads.append(out.shape)
        return out
    monkeypatch.setattr(k6, "partial_rows", inside("partials", partials))
    monkeypatch.setattr(pmatcher.distributed, "gather", inside(
        "gather", lambda t, group, out: t[None] if S == 1 else out))
    monkeypatch.setattr(plan, "finalize", inside(
        "finalize", lambda *a: torch.empty(R, 13)))
    nums = torch.tensor([30, 30], dtype=torch.int32)
    points = torch.zeros(R, 4, 2)
    with mode:
        pmatcher.search_rows(k6, CONFIGS[7], "mesh", None, None, points,
                             None, nums, None, dths, dls)
    ev = mode.events
    assert ev.index("partials") < ev.index("gather") < ev.index("finalize")
    between = ev[ev.index("partials") + 1:ev.index("finalize")]
    assert set(between) - {"gather"} <= QUIET, between
    assert not set(ev) - QUIET - {"partials", "gather", "finalize"}, ev
    n = pmatcher.angle_block(A, S, S - 1)[1]
    assert heads == [(R, n * 7, 12)]


def test_plan_refuses_a_foreign_buffer(searches):
    cfg, rows, dths, dls, _ = searches[2]
    plan = planned_stack(cfg, rows, dths, dls, 2)
    with pytest.raises(ValueError, match="not this plan's"):
        plan.finalize(cfg, plan.stack.clone(), rows[4], dths, dls)
    with pytest.raises(ValueError, match="not this plan's"):
        plan.finalize(cfg, plan.stack[:1], rows[4], dths, dls)


def test_plan_refuses_the_other_num_points_form(searches):
    cfg, rows, dths, dls, _ = searches[2]
    plan = planned_stack(cfg, rows, dths, dls, 2)
    with pytest.raises(TypeError, match="planned form"):
        plan.finalize(cfg, plan.stack, 40, dths, dls)
    scalar = k2.SplitPlan("cpu", 2, R, 5, dls.numel(), False, 2)
    with pytest.raises(TypeError, match="planned form"):
        scalar.finalize(cfg, scalar.stack, rows[4], dths, dls)


def test_k6_plans_carry_no_append(searches):
    cfg, rows, dths, dls, _ = searches[2]
    with pytest.raises(ValueError, match="only K2"):
        pmatcher.search_rows(k6, cfg, None, *rows, dths, dls,
                             append=object())


def test_split_plans_are_kept_by_partials_an_angle():
    a = k2.split_plan(torch.device("cpu"), 2, R, 21, 40, True, 7)
    assert k2.split_plan(torch.device("cpu"), 2, R, 21, 40, True, 7) is a
    b = k2.split_plan(torch.device("cpu"), 2, R, 21, 40, True)
    assert b is not a and (a.per, b.per) == (7, 1)
    assert a.send.numel() == R * 11 * 7 * 12 and a.stack.shape == (
        2, R * 11 * 7 * 12)
    with pytest.raises(ValueError):
        k2.SplitPlan("cpu", 2, R, 21, 40, True, 0)


# --- gloo: two ranks against one device -----------------------------------

def k6_split_scenario(mesh=None) -> dict:
    """K6's split search of the 7- and 2-partial lattices' rows on the
    ``space`` axis of ``mesh`` (the one-launch twins without one)."""
    out = {}
    for per in (7, 2):
        cfg = CONFIGS[per]
        rows = search_rows_inputs(cfg)
        dths, dls = k2.search_offsets(cfg, "cpu")
        if mesh is None:
            out[f"rows{per}"] = k6.match_rows(cfg, *rows, dths,
                                              dls).numpy()
        else:
            out[f"rows{per}"] = pmatcher.search_rows(
                k6, cfg, mesh, *rows, dths, dls).numpy()
    return out


def test_gloo_two_rank_k6_search_equals_one_device(tmp_path):
    got = ranks.run_ranks("k6_split", str(tmp_path), 2, 1, timeout=300,
                          script=__file__)
    want = k6_split_scenario()
    for r in got:
        for key, value in want.items():
            assert np.array_equal(r[key].view(np.int32),
                                  value.view(np.int32)), key


if __name__ == "__main__":
    sys.exit(ranks.main(sys.argv[1:], {"k6_split": k6_split_scenario}))
