"""The box drive of tests/test_mesh_mapper.py:99-125 (16 scans, 240
beams, 160x160 grids) mapped four ways on the CPU: the JAX reference and
the port, each synchronously and at max_inflight 4.  Shows why the port's
two arms part there while JAX's agree within 1e-4:

* the largest pose differences of the pairs of arms, with the port's
  lattice and with its offsets rounded once (-size + k * resolution as
  one fused multiply-add, which is how XLA compiles JAX's
  ``_search_offsets`` on the CPU; the port and JAX's op-by-op mode round
  the product and then the sum);
* the lattice offsets that differ between the two roundings;
* scan 14's match in JAX's synchronous arm, repeated by JAX and by the
  port from JAX's own window and start pose, each value moved by up to
  3e-8 at random (the port's drift from JAX by then): how often each
  leaves the lattice candidate of JAX's unperturbed match, and how often
  the two pick the same candidate.

Run from the repo root, it prints one JSON line per reading:

    python tests/test_torch_box_arms.py

As tests: the port's lattice is JAX's op-by-op one bitwise and differs
from the once-rounded one, and with the once-rounded lattice the port's
synchronous arm is JAX's bitwise and its two arms agree within JAX's
1e-4, so the lattice's rounding is the whole of the parting.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from ndt_2d_tpu.config import MapperConfig as JaxMapperConfig  # noqa: E402
from ndt_2d_tpu.config import ScanMatcherConfig as JaxMatcherConfig  # noqa
from ndt_2d_tpu.mapping.mapper import Mapper as JaxMapper  # noqa: E402
from ndt_2d_tpu.matching import matcher as jax_matcher  # noqa: E402
from ndt_2d_tpu.utils import sim  # noqa: E402
from ndt_2d_tpu_torch.config import (MapperConfig,  # noqa: E402
                                     ScanMatcherConfig)
from ndt_2d_tpu_torch.kernels import candidate_scores as k2  # noqa: E402
from ndt_2d_tpu_torch.mapping.mapper import Mapper  # noqa: E402
from ndt_2d_tpu_torch.matching import matcher  # noqa: E402

SCANS = 16
SCAN = 14          # the scan whose match parts the port's arms
TRIALS = 30


def drive():
    world = sim.make_box_world(10.0, 8.0)
    truth = np.stack([np.linspace(2.5, 7.0, SCANS), np.full(SCANS, 4.0),
                      np.zeros(SCANS)], axis=-1)
    odom = sim.drift_odometry(truth, 0.008, 0.002, seed=5)
    scans = [sim.scan_at_pose(world, truth[t], n_beams=240, range_max=12.0,
                              noise=0.01, rng=np.random.default_rng(t))
             for t in range(SCANS)]
    return scans, odom


def run(jax_arm: bool, inflight: int, scans, odom):
    if jax_arm:
        m = JaxMatcherConfig(grid_cells_x=160, grid_cells_y=160)
        mapper = JaxMapper(JaxMapperConfig(
            local_scan_matcher=m, global_scan_matcher=m,
            max_points_per_scan=512, loop_closure_every=10 ** 9,
            max_inflight=inflight))
    else:
        m = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
        mapper = Mapper(MapperConfig(
            local_scan_matcher=m, global_scan_matcher=m,
            max_points_per_scan=512, loop_closure_every=10 ** 9,
            max_inflight=inflight), device="cpu")
    for msg, o in zip(scans, odom):
        mapper.process_scan(msg, o)
    mapper.flush()
    return mapper.graph.poses[:mapper.graph.num_scans].copy()


def rounded_once(config, device):
    """The lattice with each offset rounded once (the float64 product and
    sum of the float32 constants are exact)."""
    def lattice(n, size, resolution):
        start, step = np.float32(-size), np.float32(resolution)
        k = np.arange(n, dtype=np.float64)
        return torch.tensor((np.float64(start) + k * np.float64(step))
                            .astype(np.float32), device=device)
    return (lattice(config.num_angles, config.search_angular_size,
                    config.search_angular_resolution),
            lattice(config.num_linear, config.search_linear_size,
                    config.search_linear_resolution))


def arms(scans, odom):
    poses = {f"{who}_{arm}": run(who == "jax", inflight, scans, odom)
             for who in ("jax", "port")
             for arm, inflight in (("sync", 0), ("pipelined", 4))}
    pairs = (("jax_sync", "jax_pipelined"), ("port_sync", "port_pipelined"),
             ("port_sync", "jax_sync"), ("port_pipelined", "jax_pipelined"))
    return {f"{a} - {b}": np.abs(poses[a] - poses[b]).max(0).tolist()
            for a, b in pairs}


def scan_inputs(scans, odom):
    """JAX's synchronous arm's inputs to the match of scan SCAN."""
    calls = []
    real = jax_matcher.match_scan_rolling

    def record(config, window, *rest):
        calls.append((config, [np.asarray(f).copy() for f in window],
                      [np.asarray(r).copy() if hasattr(r, "shape") else r
                       for r in rest]))
        return real(config, window, *rest)
    jax_matcher.match_scan_rolling = record
    try:
        run(True, 0, scans, odom)
    finally:
        jax_matcher.match_scan_rolling = real
    return calls[SCAN - 1]


def perturbed_matches(scans, odom):
    config, window, (range_max, pts, msk, num, pose) = scan_inputs(
        scans, odom)
    port_config = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)

    def by_jax(wposes, start):
        w = jax_matcher.RollingWindow(jnp.asarray(wposes),
                                      *map(jnp.asarray, window[1:]))
        out = jax_matcher.match_scan_rolling(
            config, w, range_max, jnp.asarray(pts), jnp.asarray(msk), num,
            jnp.asarray(start, jnp.float32))
        return np.asarray(out[2])

    def by_port(wposes, start):
        w = matcher.RollingWindow(torch.from_numpy(wposes),
                                  *map(torch.from_numpy, window[1:]))
        out = matcher.match_scan_rolling(
            port_config, w, float(range_max), torch.from_numpy(pts),
            torch.from_numpy(msk), int(num),
            torch.from_numpy(np.asarray(start, np.float32)))
        return out[2].numpy()

    def same(a, b):
        """The same lattice candidate (the two roundings of its offsets
        differ by an ulp)."""
        return bool(np.allclose(a, b, rtol=0, atol=1e-6))

    base = by_jax(window[0], pose)
    rng = np.random.default_rng(0)
    moved_jax = moved_port = agree = 0
    for _ in range(TRIALS):
        wp = (window[0].astype(np.float64)
              + rng.uniform(-3e-8, 3e-8, window[0].shape)).astype(np.float32)
        sp = (np.asarray(pose, np.float64)
              + rng.uniform(-3e-8, 3e-8, 3)).astype(np.float32)
        j, p = by_jax(wp, sp), by_port(wp, sp)
        moved_jax += int(not same(j, base))
        moved_port += int(not same(p, base))
        agree += int(same(j, p))
    return dict(scan=SCAN, trials=TRIALS, correction=base.tolist(),
                jax_moved=moved_jax, port_moved=moved_port, agree=agree)


@pytest.fixture
def lattice_rounded_once():
    """The port's matcher on the once-rounded lattice, for one test."""
    real = k2.search_offsets
    k2.search_offsets = rounded_once
    matcher._search_offsets.cache_clear()
    try:
        yield
    finally:
        k2.search_offsets = real
        matcher._search_offsets.cache_clear()


def test_offsets_round_as_jax_op_by_op():
    config = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
    twice = k2.search_offsets(config, "cpu")
    once = rounded_once(config, "cpu")
    with jax.disable_jit():
        ref = jax_matcher._search_offsets(JaxMatcherConfig(
            grid_cells_x=160, grid_cells_y=160))
    for mine, theirs, other in zip(twice, ref, once):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
        assert (mine != other).any()


def test_box_arms_agree_on_the_lattice_rounded_once(lattice_rounded_once):
    scans, odom = drive()
    port_sync = run(False, 0, scans, odom)
    np.testing.assert_array_equal(port_sync, run(True, 0, scans, odom))
    np.testing.assert_allclose(run(False, 4, scans, odom), port_sync,
                               rtol=0, atol=1e-4)


def main() -> int:
    torch.set_num_threads(2)
    scans, odom = drive()
    print(json.dumps({"lattice": "port", "max_abs_diff": arms(scans, odom)}))
    config = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
    twice = k2.search_offsets(config, "cpu")
    once = rounded_once(config, "cpu")
    print(json.dumps({"offsets_differing": {
        axis: [[float(a), float(b)] for a, b in zip(t, o) if a != b]
        for axis, t, o in zip(("angle", "linear"), twice, once)}}))
    real = k2.search_offsets
    k2.search_offsets = rounded_once
    matcher._search_offsets.cache_clear()
    try:
        print(json.dumps({"lattice": "rounded once",
                          "max_abs_diff": arms(scans, odom)}))
    finally:
        k2.search_offsets = real
        matcher._search_offsets.cache_clear()
    print(json.dumps({"perturbed": perturbed_matches(scans, odom)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
