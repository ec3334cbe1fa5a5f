"""K13's window append against ndt_2d_tpu's ``window_append``.

The port shifts the rolling window IN PLACE in one launch
(``kernels/pose_chain.py::window_append``; on the CPU its twin), where
JAX builds a new window by concatenation (``ndt_2d_tpu/matching/
matcher.py:485``).  Held bitwise on seeded windows of depth 1, 2 and 10,
empty and partly filled, with the pose given (the synchronous mapper) and
with a correction added (the pipelined step: JAX's ``pose + correction``,
:668-669), and the pose-only call of localization (:699); then five
pipelined mapping and localization steps chained as the mapper chains
them, against JAX's op by op (``jax.disable_jit``).

Tolerances: none for the window and the additions (the same float32
values, moved or added once).  The chained steps: the window's points and
masks bitwise, its poses and the step poses within 1e-6 (the start pose's
cos/sin/atan2 may differ between torch and XLA in the last bit, as
``test_torch_pipelined.py`` states), the corrections equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu.matching import matcher as jax_matcher
from ndt_2d_tpu_torch.config import ScanMatcherConfig
from ndt_2d_tpu_torch.kernels import pose_chain as k13
from ndt_2d_tpu_torch.matching import matcher
from ndt_2d_tpu_torch.utils import sim
from port_configs import to_jax

torch.set_num_threads(2)

P = 64
FIELDS = ("poses", "points", "point_mask", "mask")
SMALL = ScanMatcherConfig(grid_cells_x=96, grid_cells_y=96,
                          search_angular_size=0.02,
                          search_angular_resolution=0.005,
                          search_linear_size=0.05,
                          search_linear_resolution=0.01, laser_max_beams=40)


def seeded_window(depth, filled, seed):
    """Window fields (numpy) with the last ``filled`` slots in use, random
    contents elsewhere too (a shift must move every slot), and a new scan,
    pose and correction."""
    rng = np.random.default_rng(seed)
    poses = rng.normal(0, 3, (depth, 3)).astype(np.float32)
    pts = rng.normal(0, 5, (depth, P, 2)).astype(np.float32)
    pmask = rng.random((depth, P)) < 0.7
    mask = np.zeros(depth, bool)
    mask[depth - filled:] = True
    new = (rng.normal(0, 3, 3).astype(np.float32),
           rng.normal(0, 5, (P, 2)).astype(np.float32),
           rng.random(P) < 0.7, rng.uniform(-0.05, 0.05, 3).astype(
               np.float32))
    return (poses, pts, pmask, mask), new


def port_window(fields):
    return matcher.RollingWindow(*[torch.tensor(f) for f in fields])


def assert_window_equal(win, jwin):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(win, f).numpy(),
                                      np.asarray(getattr(jwin, f)))


@pytest.mark.parametrize("corrected", [False, True])
@pytest.mark.parametrize("fill", ["empty", "partial"])
@pytest.mark.parametrize("depth", [1, 2, 10])
def test_window_append_matches_jax(depth, fill, corrected):
    filled = 0 if fill == "empty" else max(depth // 2, 1)
    fields, (pose, pts, pmask, corr) = seeded_window(
        depth, filled, 100 * depth + filled)
    win = port_window(fields)
    before = [getattr(win, f).data_ptr() for f in FIELDS]
    if corrected:
        new = k13.window_append(torch.tensor(pose), torch.tensor(corr), win,
                                torch.tensor(pts), torch.tensor(pmask))
        want = jnp.asarray(pose) + jnp.asarray(corr)
        np.testing.assert_array_equal(new.numpy(), np.asarray(want))
    else:
        assert matcher.window_append(win, torch.tensor(pose),
                                     torch.tensor(pts),
                                     torch.tensor(pmask)) is win
        want = jnp.asarray(pose)
    jwin = jax_matcher.window_append(
        jax_matcher.RollingWindow(*[jnp.asarray(f) for f in fields]), want,
        jnp.asarray(pts), jnp.asarray(pmask))
    assert_window_equal(win, jwin)
    # In place: the same buffers, as the mapper's window relies on.
    assert [getattr(win, f).data_ptr() for f in FIELDS] == before
    assert int(win.mask.sum()) == min(filled + 1, depth)


def test_pose_only_append_is_the_corrected_pose():
    _, (pose, _, _, corr) = seeded_window(2, 1, 7)
    new = k13.window_append(torch.tensor(pose), torch.tensor(corr))
    np.testing.assert_array_equal(
        new.numpy(), np.asarray(jnp.asarray(pose) + jnp.asarray(corr)))
    assert k13.window_append(torch.tensor(pose)) is None


def box_drive(n, seed):
    """n + 1 scans along a gentle arc in a box, their truth poses and the
    odometry deltas between them in the robot frame."""
    rng = np.random.default_rng(seed)
    world = sim.make_box_world(10.0, 8.0)
    truth = np.stack([[4.6 + 0.12 * t, 3.8 + 0.04 * t, 0.02 * t]
                      for t in range(n + 1)])
    scans = [sim.project_scan(sim.scan_at_pose(world, p, 120, rng=rng,
                                               noise=0.01), P)
             for p in truth]
    d = truth[1:, :2] - truth[:-1, :2]
    c0, s0 = np.cos(truth[:-1, 2]), np.sin(truth[:-1, 2])
    deltas = np.stack([c0 * d[:, 0] + s0 * d[:, 1],
                       -s0 * d[:, 0] + c0 * d[:, 1],
                       np.diff(truth[:, 2])], 1).astype(np.float32)
    return truth.astype(np.float32), scans, deltas


@pytest.mark.parametrize("seed", [0, 1])
def test_five_mapping_steps_match_jax(seed):
    truth, scans, deltas = box_drive(5, seed)
    D = 4
    win = matcher.make_window(D, P, device="cpu")
    matcher.window_append(win, torch.tensor(truth[0]),
                          torch.tensor(scans[0][0]),
                          torch.tensor(scans[0][1]))
    prev = torch.tensor(truth[0])
    ours = []
    for t in range(5):
        qp, qm = scans[t + 1]
        win, prev, out, _ = matcher.mapping_step_async(
            SMALL, win, prev, 12.0, torch.tensor(qp), torch.tensor(qm),
            int(qm.sum()), torch.tensor(deltas[t]))
        ours.append((prev.numpy().copy(), out[2].numpy().copy()))
    with jax.disable_jit():
        jwin = jax_matcher.window_append(
            jax_matcher.make_window(D, P), jnp.asarray(truth[0]),
            jnp.asarray(scans[0][0]), jnp.asarray(scans[0][1]))
        jprev = jnp.asarray(truth[0])
        for t in range(5):
            qp, qm = scans[t + 1]
            jwin, jprev, jout = jax_matcher.mapping_step_async(
                to_jax(SMALL), jwin, jprev, jnp.float32(12.0),
                jnp.asarray(qp), jnp.asarray(qm), jnp.int32(qm.sum()),
                jnp.asarray(deltas[t]))
            pose, corr = ours[t]
            np.testing.assert_array_equal(corr, np.asarray(jout[2]))
            np.testing.assert_allclose(pose, np.asarray(jprev), rtol=0,
                                       atol=1e-6)
    for f in ("points", "point_mask", "mask"):
        np.testing.assert_array_equal(getattr(win, f).numpy(),
                                      np.asarray(getattr(jwin, f)))
    np.testing.assert_allclose(win.poses.numpy(), np.asarray(jwin.poses),
                               rtol=0, atol=1e-6)
    assert bool(win.mask.all())


@pytest.mark.parametrize("seed", [0, 1])
def test_five_localization_steps_match_jax(seed):
    truth, scans, deltas = box_drive(5, seed)
    stack = [torch.tensor(np.stack(x)) for x in zip(*scans[:3])]
    grid, table = matcher.build_window_ndt(
        SMALL, torch.tensor(truth[:3]), *stack,
        torch.ones(3, dtype=torch.bool), 12.0)
    prev = torch.tensor(truth[0])
    ours = []
    for t in range(5):
        qp, qm = scans[t + 1]
        prev, out, _ = matcher.localization_step_async(
            SMALL, grid, prev, torch.tensor(qp), torch.tensor(qm),
            int(qm.sum()), torch.tensor(deltas[t]), table)
        ours.append((prev.numpy().copy(), out[2].numpy().copy()))
    with jax.disable_jit():
        jgrid = jax_matcher.build_window_ndt(
            to_jax(SMALL), jnp.asarray(truth[:3]),
            *[jnp.asarray(np.stack(x)) for x in zip(*scans[:3])],
            jnp.ones(3, bool), jnp.float32(12.0))
        jprev = jnp.asarray(truth[0])
        for t in range(5):
            qp, qm = scans[t + 1]
            jprev, jout = jax_matcher.localization_step_async(
                to_jax(SMALL), jgrid, jprev, jnp.asarray(qp),
                jnp.asarray(qm), jnp.int32(qm.sum()),
                jnp.asarray(deltas[t]))
            pose, corr = ours[t]
            np.testing.assert_array_equal(corr, np.asarray(jout[2]))
            np.testing.assert_allclose(pose, np.asarray(jprev), rtol=0,
                                       atol=1e-6)
