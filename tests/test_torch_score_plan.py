"""K3's single-pose launch, what the CPU can check of it.

The block-per-pose kernel (``csrc/score_points.cu::score_pose_kernel``)
evaluates a pass of slots at once and lets warp 0 add them; its order
model (``score_points.block_order_sum`` over ``pose_plan``'s passes) is
held to ``lane_tree_sum``, the order of the warp-per-pose kernel and of the
twin, at beam counts around every warp and pass edge, on the terms of a
real window at G = 1 and at G = 4 (the overlapping grids).  The composed
entry (``score_composed``: K13's compose folded into the launch) is held
to ``compose_twin`` then ``score_at_pose_twin``, also where the heading
wraps at +-pi.  The launch path: ``_Args`` lays out the source's
``ScoreArgs``, plans are made once a shape, and ``_build.require_all``
raises as ``require`` does.

Tolerances: none; every comparison is bitwise (the order model and the
twins add the same float32 values in the same order).
"""

import ctypes

import numpy as np
import pytest
import torch

from ndt_2d_tpu_torch.kernels import _build
from ndt_2d_tpu_torch.kernels import ndt_build as k1
from ndt_2d_tpu_torch.kernels import pose_chain as k13
from ndt_2d_tpu_torch.kernels import score_points as k3
from ndt_2d_tpu_torch.utils import sim

torch.set_num_threads(2)

P = 1100  # points a scan: room for 1025 used beams
W = H = 64
CELL = 0.25


@pytest.fixture(scope="module")
def window():
    """A 3-scan box window of 1100-beam scans, built at G = 1 and G = 4,
    and a query scan from a nearby pose."""
    rng = np.random.default_rng(13)
    world = sim.make_box_world(10.0, 8.0)
    poses = np.asarray([[4.8, 3.9, 0.0], [5.0, 4.0, 0.05],
                        [5.2, 4.1, -0.05]], np.float32)
    pts, msk = zip(*[sim.project_scan(sim.scan_at_pose(
        world, p, P, rng=rng, noise=0.01, range_max=12.0), P)
        for p in poses])
    qp, qm = sim.project_scan(sim.scan_at_pose(
        world, np.asarray([5.3, 4.05, 0.02]), P, rng=rng, noise=0.01,
        range_max=12.0), P)
    args = (torch.tensor(poses), torch.tensor(np.stack(pts)),
            torch.tensor(np.stack(msk)), torch.ones(3, dtype=torch.bool))
    grids = {G: k1.build_window(*args, 12.0, CELL, W, H, G)[0]
             for G in (1, 4)}
    return grids, torch.tensor(qp), torch.tensor(qm), int(qm.sum())


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("beams", [1, 31, 32, 33, 100, 128, 129, 1000,
                                   1025])
def test_block_order_equals_lane_tree_sum(window, beams, G):
    grids, qp, qm, n = window
    assert n >= 1025
    pose = torch.tensor([[5.28, 4.06, 0.025]])
    terms, used = k3.beam_terms_twin(grids[G], W, H, beams, qp, qm, n, pose)
    slots, threads = k3.pose_plan(beams)
    assert terms.shape == (1, slots) and slots % 32 == 0
    assert threads % 32 == 0 and 32 <= threads <= k3.POSE_THREADS
    assert threads == min(slots, k3.POSE_THREADS)
    assert bool((terms[0] > 0).any())  # the window scores the scan
    block = k3.block_order_sum(terms[0], threads)
    lanes = k3.lane_tree_sum(terms)[0]
    assert torch.equal(block, lanes), (float(block), float(lanes))
    # And the twin's score is that sum, normalized.
    score = k3.score_at_pose_twin(grids[G], W, H, beams, qp, qm, n, pose[0])
    assert torch.equal(score, -block / torch.tensor(float(max(used, 1))))


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("theta", [0.3, 3.13, -3.13, np.pi, -np.pi])
def test_composed_equals_compose_then_score(window, theta, G):
    grids, qp, qm, n = window
    prev = torch.tensor([5.2, 4.0, theta], dtype=torch.float32)
    delta = torch.tensor([0.1, 0.05, 0.03 if theta > 0 else -0.03],
                         dtype=torch.float32)
    score, pose = k3.score_composed(grids[G], W, H, 100, qp, qm, n, prev,
                                    delta)
    want_pose = k13.compose_twin(prev, delta)
    want = k3.score_at_pose_twin(grids[G], W, H, 100, qp, qm, n, want_pose)
    assert torch.equal(pose, want_pose) and torch.equal(score, want)
    assert score.shape == () and pose.shape == (3,)
    assert -np.pi <= float(pose[2]) <= np.pi
    if abs(theta) > 3.0:
        assert abs(float(pose[2]) - theta) > np.pi  # it wrapped


def test_args_block_matches_the_source_layout():
    """csrc/score_points.cu::ScoreArgs: seven ints, then the cell size."""
    names = [f for f, _ in k3._Args._fields_]
    assert names == ["P", "max_beams", "G", "W", "row0", "h", "raw",
                     "cell"]
    assert ctypes.sizeof(k3._Args) == 32
    assert k3._Args.cell.offset == 28
    a = k3._Args(512, 100, 4, 192, 0, 192, 0, 0.25)
    assert (a.P, a.max_beams, a.G, a.W, a.h, a.cell) == (512, 100, 4, 192,
                                                        192, 0.25)


def test_plan_is_made_once_a_shape(window):
    grids, qp, qm, _ = window
    a = k3._plan(grids[4], W, 0, H, 100, qp, False)
    assert k3._plan(grids[4], W, 0, H, 100, qp, False) is a
    assert k3._plan(grids[4], W, 0, H, 101, qp, False) is not a
    assert k3._plan(grids[1], W, 0, H, 100, qp, False) is not a
    assert ctypes.addressof(a.args) == a.address
    assert (a.args.G, a.args.P, a.args.h) == (4, P, H)
    shapes = {name: shape for name, _, shape in a.compose}
    assert shapes == {"points": (P, 2), "point_mask": (P,),
                      "origin": (4, 2), "mean": (4, W * H, 2),
                      "information": (4, W * H, 3), "count": (4, W * H),
                      "prev": (3,), "delta": (3,)}
    _build.require_all(a.device, (qp, qm, grids[4].origin, grids[4].mean,
                                  grids[4].information, grids[4].count),
                       a.expect)


@pytest.mark.parametrize("bad,message", [
    (lambda t: t.double(), "dtype"),
    (lambda t: t[:, :1], "shape"),
    (lambda t: t.t().contiguous().t(), "not contiguous"),
])
def test_require_all_raises_as_require(bad, message):
    good = torch.zeros(4, 2)
    expect = (("a", torch.float32, (4, 2)), ("b", torch.float32, (4, 2)))
    dev = good.device
    _build.require_all(dev, (good, good), expect)
    with pytest.raises((TypeError, ValueError), match=message):
        _build.require_all(dev, (good, bad(good)), expect)
