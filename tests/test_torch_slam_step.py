"""The port's fused multichip SLAM step (``parallel/slam_step.py``, KB4 in
``kernels/slam_step.py``) and its constraint math (``core/constraint.py``)
against the JAX package's.

The drive is tests/test_sharding.py:199-225's: 6 noise-free box scans
0.15 m apart, 64 x 64 cells, optimize every 4 scans, capacity 16 scans /
16 constraints.  The port runs on gloo meshes (2, 1) and (1, 2) (ranks
spawned once for the module, tests/torch_blocks_ranks.py) and on one
device; JAX's jitted ``make_slam_step`` on its (2, 1) mesh.

JAX's mesh search (``parallel/matcher.py::_padded_angles``) forms its
angle lattice in float64 with numpy and rounds it once to float32; its
single-device search (``matcher._search_offsets``) and the port, which pins
that one, round twice.  Angle 40 is 0.0 in the first and -7.45e-9 in the
second, and the drive's noise-free wall cells make exact ties of the
search, so the two lattices break step 3's tie 0.025 m apart (ROADMAP
"Deliberate divergences").  The bounds below hold against JAX's step run
with its own single-device lattice in its mesh search: 6 scans and 5
constraints; every step's correction within one lattice step of JAX's
(0.005 m, 0.0025 rad); final poses within 0.01 m.  Against JAX's step as
it stands, the first step whose correction differs by more than a lattice
step is an exact tie: both winners score the same.

Inside the port: the (2, 1) mesh is bitwise the single-device run (the
angle split is bitwise one device's search, and one 'batch' shard solves
as one device); (1, 2) within 1e-3 m of it (the constraint-sharded solve
adds its partials in another order); every rank bitwise equal.
``make_constraint`` within 1e-5 of JAX's relative to the matrix's largest
entry (LAPACK's inverse against the port's LU); KB4's twin writes
``make_constraint``'s values bitwise and the pose update of op-by-op JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu.config import MapperConfig as JaxMapperConfig
from ndt_2d_tpu.config import ScanMatcherConfig as JaxScanMatcherConfig
from ndt_2d_tpu.core import constraint as jax_constraint
from ndt_2d_tpu.matching import matcher as jax_matcher
from ndt_2d_tpu.parallel import matcher as jax_pmatcher
from ndt_2d_tpu.parallel import mesh as jax_mesh
from ndt_2d_tpu.parallel import slam_step as jax_slam
from ndt_2d_tpu.utils import sim as jax_sim
from ndt_2d_tpu_torch.core import constraint
from ndt_2d_tpu_torch.kernels import slam_step as kb4
from ndt_2d_tpu_torch.parallel import slam_step

import torch_blocks_ranks as ranks

torch.set_num_threads(2)

SHAPES = [(2, 1), (1, 2)]
IDS = [f"{s}x{b}" for s, b in SHAPES]
STEP = np.asarray([0.005, 0.005, 0.0025])


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    out = {}
    for shape in SHAPES:
        d = str(tmp_path_factory.mktemp(f"slam{shape[0]}x{shape[1]}"))
        out[shape] = ranks.run_ranks("slam", d, *shape)
    return out


@pytest.fixture(scope="module")
def single():
    return ranks.slam_drive(None)


def _single_device_lattice(config, n_shards, dtype):
    """``_padded_angles`` with the angles of JAX's single-device search."""
    a = config.num_angles
    a_pad = -(-a // n_shards) * n_shards
    dths, _ = jax_matcher._search_offsets(config, dtype)
    return (jnp.zeros(a_pad, dtype).at[:a].set(dths),
            jnp.arange(a_pad) < a, a_pad)


def _jax_drive():
    """JAX's step on its (2, 1) mesh over the drive."""
    mesh = jax_mesh.make_mesh(2, shape=(2, 1))
    cfg = JaxMapperConfig(
        local_scan_matcher=JaxScanMatcherConfig(grid_cells_x=64,
                                                grid_cells_y=64),
        max_points_per_scan=128)
    step = jax_slam.make_slam_step(mesh, cfg, range_max=6.0,
                                   optimize_every=4)
    state = jax_slam.init_state(max_scans=16, max_points=128,
                                max_constraints=16)
    world = jax_sim.make_box_world(8.0, 6.0)
    pose = np.asarray([4.0, 3.0, 0.0])
    corrections, scores = [], []
    for k in range(ranks.SLAM_STEPS):
        msg = jax_sim.scan_at_pose(world, pose, n_beams=120, range_max=6.0)
        pts, msk = jax_sim.project_scan(msg, 128)
        delta = (np.asarray([0.15, 0.0, 0.0], np.float32) if k
                 else np.zeros(3, np.float32))
        state, res = step(state, jnp.asarray(pts), jnp.asarray(msk),
                          jnp.asarray(delta))
        corrections.append(np.asarray(res.correction))
        scores.append(float(res.score))
        pose = pose + np.asarray([0.15, 0.0, 0.0])
    return {"corrections": np.stack(corrections),
            "scores": np.asarray(scores), "poses": np.asarray(state.poses),
            "num_scans": int(state.num_scans), "c_num": int(state.c_num)}


@pytest.fixture(scope="module")
def jax_run():
    """JAX's step with its single-device angle lattice in the mesh search,
    and as it stands."""
    saved = jax_pmatcher._padded_angles
    jax_pmatcher.match_scan_multichip.clear_cache()
    jax_pmatcher._padded_angles = _single_device_lattice
    try:
        single = _jax_drive()
    finally:
        jax_pmatcher._padded_angles = saved
        jax_pmatcher.match_scan_multichip.clear_cache()
    return {"single_lattice": single, "as_is": _jax_drive()}


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_counts_match_jax(meshed, jax_run, shape):
    for run in jax_run.values():
        assert run["num_scans"] == 6 and run["c_num"] == 5
    for res in meshed[shape]:
        assert int(res["num_scans"]) == 6 and int(res["c_num"]) == 5
        np.testing.assert_array_equal(res["c_begin"][:5], np.arange(5))
        np.testing.assert_array_equal(res["c_end"][:5], np.arange(1, 6))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_corrections_within_a_lattice_step_of_jax(meshed, jax_run, shape):
    got = meshed[shape][0]["matches"][:, 1:4]
    diff = np.abs(got - jax_run["single_lattice"]["corrections"])
    assert (diff <= STEP + 1e-6).all(), diff


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_final_poses_near_jax(meshed, jax_run, shape):
    got = meshed[shape][0]["poses"][:6]
    np.testing.assert_allclose(got[:, :2],
                               jax_run["single_lattice"]["poses"][:6, :2],
                               atol=0.01)
    assert np.isfinite(got).all()
    assert got[5, 0] > got[0, 0] + 0.5  # along +x, as JAX's test asks


def test_jax_mesh_lattice_parts_an_exact_tie(meshed, jax_run):
    """Against JAX's step as it stands: up to the first step whose
    correction differs by more than a lattice step, the corrections agree;
    at that step both winners score the same."""
    port = meshed[(2, 1)][0]["matches"]
    jx = jax_run["as_is"]
    far = (np.abs(port[:, 1:4] - jx["corrections"]) > STEP + 1e-6).any(1)
    if far.any():
        k = int(np.argmax(far))
        np.testing.assert_allclose(port[k, 0], jx["scores"][k], rtol=1e-6)


def test_2x1_mesh_is_single_device_bitwise(meshed, single):
    for res in meshed[(2, 1)]:
        for k, v in single.items():
            np.testing.assert_array_equal(res[k], v, err_msg=k)


def test_1x2_mesh_near_single_device(meshed, single):
    np.testing.assert_allclose(meshed[(1, 2)][0]["poses"][:6],
                               single["poses"][:6], rtol=0, atol=1e-3)


def test_tensor_scans_without_counts_match_host_arrays(single):
    """Scans handed over as tensors with no point count (JAX's dry run's
    way) take the count from the mask: the same drive bit for bit."""
    got = ranks.slam_drive(None, tensors=True)
    for k, v in single.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_ranks_bitwise_equal(meshed, shape):
    runs = meshed[shape]
    for res in runs[1:]:
        for k in runs[0]:
            np.testing.assert_array_equal(res[k], runs[0][k], err_msg=k)
    assert not any(bool(res["imported_reference"]) for res in runs)


def _constraint_cases(n=8, seed=4):
    """Pose pairs and SPD covariances like a match's (Olson's, floored)."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        a = rng.normal([2.0, 1.0, 0.3], [1.0, 1.0, 1.0]).astype(np.float32)
        b = (a + rng.normal(0, [0.2, 0.2, 0.1])).astype(np.float32)
        m = rng.normal(0, 1, (3, 3))
        cov = (m @ m.T * 1e-4 + np.diag([1e-5, 1e-5, 1e-6])).astype(
            np.float32)
        yield a, b, cov


def test_make_constraint_matches_jax():
    for a, b, cov in _constraint_cases():
        got = constraint.make_constraint(3, 4, torch.tensor(a),
                                         torch.tensor(b), torch.tensor(cov))
        want = jax_constraint.make_constraint(3, 4, jnp.asarray(a),
                                              jnp.asarray(b),
                                              jnp.asarray(cov))
        assert int(got[0]) == 3 and int(got[1]) == 4 and not bool(got[4])
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=1e-5, atol=1e-7)
        info = np.asarray(want[3])
        np.testing.assert_allclose(got[3].numpy(), info, rtol=0,
                                   atol=1e-5 * np.abs(info).max())


def test_constraint_batch_appends_like_jax():
    a, b, cov = next(_constraint_cases())
    batch = constraint.empty_constraint_batch(4, device="cpu")
    jb = jax_constraint.empty_constraint_batch(4)
    for k in range(2):
        _, _, tr, info, _ = constraint.make_constraint(
            k, k + 1, torch.tensor(a), torch.tensor(b), torch.tensor(cov))
        batch = constraint.append_constraint(batch, k, k + 1, tr, info,
                                             bool(k))
        jb = jax_constraint.append_constraint(
            jb, k, k + 1, jnp.asarray(tr.numpy()), jnp.asarray(info.numpy()),
            bool(k))
    assert batch.num == int(jb.num) == 2
    np.testing.assert_array_equal(batch.mask.numpy(), np.asarray(jb.mask))
    for f in ("begin", "end", "transform", "information", "switchable"):
        np.testing.assert_array_equal(getattr(batch, f).numpy(),
                                      np.asarray(getattr(jb, f)))


@pytest.mark.parametrize("has_prior", [False, True])
def test_append_twin_matches_jax_op_by_op(has_prior):
    """KB4's twin against slam_step.py:99-124 run op by op."""
    a, est, cov = next(_constraint_cases(seed=9))
    corr = np.asarray([0.01, -0.02, 0.003], np.float32)
    rng = np.random.default_rng(1)
    pts = rng.normal(0, 2, (8, 2)).astype(np.float32)
    msk = rng.random(8) > 0.3
    state = slam_step.init_state(4, 8, 4, device="cpu")
    state.prev_pose.copy_(torch.tensor(a))
    kb4.append(state, torch.tensor(est), torch.tensor(corr),
               torch.tensor(cov), torch.tensor(pts), torch.tensor(msk), 2, 1,
               has_prior)
    with jax.disable_jit():
        e, p = jnp.asarray(est), jnp.asarray(a)
        corrected = jnp.where(has_prior, e + jnp.asarray(corr), e)
        _, _, tr, info, _ = jax_constraint.make_constraint(
            1, 2, p, corrected, jnp.asarray(cov))
    np.testing.assert_array_equal(state.poses[2].numpy(),
                                  np.asarray(corrected))
    np.testing.assert_array_equal(state.prev_pose.numpy(),
                                  np.asarray(corrected))
    np.testing.assert_array_equal(state.points[2].numpy(), pts)
    np.testing.assert_array_equal(state.point_mask[2].numpy(), msk)
    assert (int(state.c_begin[1]), int(state.c_end[1])) == (1, 2)
    np.testing.assert_allclose(state.c_transform[1].numpy(), np.asarray(tr),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(state.c_information[1].numpy(),
                               np.asarray(info), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(info)).max())
    # The constraint is make_constraint's, bit for bit.
    _, _, tr_p, info_p, _ = constraint.make_constraint(
        1, 2, torch.tensor(a), state.poses[2], torch.tensor(cov))
    np.testing.assert_array_equal(state.c_transform[1].numpy(),
                                  tr_p.numpy())
    np.testing.assert_array_equal(state.c_information[1].numpy(),
                                  info_p.numpy())
    # Nothing else was written.
    assert not state.point_mask[[0, 1, 3]].any()
    assert not state.c_information[[0, 2, 3]].any()
