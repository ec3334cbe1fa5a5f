"""The port's occupancy export (K5's twin) against ndt_2d_tpu's.

The ray-march counts are integers and must be bitwise equal.  The JAX
``_raymarch_counts`` runs op by op (``jax.disable_jit``): under jit, XLA:CPU
contracts start + (end - start) * t into an FMA, which can move a sample
across a cell edge; the port's twin and kernel round once per operation.
The rendered grid is also held against the jitted, production render.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu.mapping import occupancy as jax_occupancy
from ndt_2d_tpu.utils import sim
from ndt_2d_tpu_torch.kernels import raymarch
from ndt_2d_tpu_torch.mapping import occupancy

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", [0, 1])
def test_raymarch_counts_bitwise(seed):
    rng = np.random.default_rng(seed)
    R = 3000
    starts = rng.uniform(0.0, 8.0, (R, 2)).astype(np.float32)
    ends = (starts + rng.uniform(-6.0, 6.0, (R, 2))).astype(np.float32)
    mask = rng.random(R) < 0.9
    origin = np.asarray([-6.3, -6.15], np.float32)
    W, H, K, res = 448, 384, 512, 0.05
    hit, empty = raymarch.raymarch_counts(
        torch.from_numpy(starts), torch.from_numpy(ends),
        torch.from_numpy(mask), torch.from_numpy(origin), res, W, H, K)
    with jax.disable_jit():
        rh, re = jax_occupancy._raymarch_counts(
            jnp.asarray(starts), jnp.asarray(ends), jnp.asarray(mask),
            jnp.asarray(origin), jnp.float32(res), W, H, K)
    assert hit.dtype == empty.dtype == torch.int32
    np.testing.assert_array_equal(hit.numpy(), np.asarray(rh))
    np.testing.assert_array_equal(empty.numpy(), np.asarray(re))
    assert int(hit.sum()) == int(mask.sum())


def test_linspace_matches_jax():
    """float(k) / float(K - 1) is jnp.linspace's formula (op by op: under
    jit XLA may divide by multiplying with the reciprocal)."""
    for k in (4, 64, 640):
        with jax.disable_jit():
            ref = jnp.linspace(0.0, 1.0, k, dtype=jnp.float32)
        np.testing.assert_array_equal(raymarch.linspace01(k, "cpu").numpy(),
                                      np.asarray(ref))


def _scans(n=6, seed=0):
    world = sim.make_box_world(10.0, 8.0)
    rng = np.random.default_rng(seed)
    poses = np.stack([rng.uniform(2.0, 8.0, n), rng.uniform(2.0, 6.0, n),
                      rng.uniform(-np.pi, np.pi, n)], -1)
    pts, msk = [], []
    for p in poses:
        msg = sim.scan_at_pose(world, p, n_beams=180, range_max=15.0,
                               noise=0.01, rng=rng)
        a, b = sim.project_scan(msg, 256)
        pts.append(a)
        msk.append(b)
    return poses, np.stack(pts), np.stack(msk)


def test_render_occupancy_matches_jax():
    poses, pts, msk = _scans()
    grid = occupancy.render_occupancy(poses, pts, msk, 0.05, 0.25,
                                      device="cpu")
    ref = jax_occupancy.render_occupancy(poses, pts, msk, 0.05, 0.25)
    assert grid.data.shape == ref.data.shape
    np.testing.assert_array_equal(grid.origin, ref.origin)
    assert (grid.data == 100).sum() > 100
    np.testing.assert_array_equal(grid.data, ref.data)
    with jax.disable_jit():
        eager = jax_occupancy.render_occupancy(poses, pts, msk, 0.05, 0.25)
    np.testing.assert_array_equal(grid.data, eager.data)


def test_ray_batch_layout_and_bounds():
    poses, pts, msk = _scans(3, seed=1)
    rays = occupancy.ray_batch(poses, pts, msk, 0.05)
    assert rays.starts.shape == rays.ends.shape == (3 * 256, 2)
    assert rays.width % 64 == 0 and rays.height % 64 == 0
    assert rays.num_samples % 64 == 0
    world = rays.ends[rays.mask]
    mins, maxs = jax_occupancy.compute_bounds(world, np.ones(len(world),
                                                             bool), 0.05)
    np.testing.assert_array_equal(rays.origin, mins - 5 * 0.05)
    np.testing.assert_array_equal(
        occupancy.compute_bounds(world, np.ones(len(world), bool), 0.05)[1],
        maxs)
