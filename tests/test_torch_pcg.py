"""K4's PCG solve (``kernels/normal_blocks.py::pcg_solve``) on the CPU: its
fixed-order dot product, its twin against the solver's host loop, the stop
test's edges, and the solve against the JAX package's PCG.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
bitwise against ``pcg_solve_twin`` on the 50,000-node district.  Here:

* ``fixed_dot_twin`` against a numpy float32 model of the lane-and-tree
  order (lane l of ``DOT_LANES`` adds elements l, l + DOT_LANES, ... in
  index order from +0; a halving tree folds the lanes): bitwise.
* ``pcg_solve_twin`` against the mesh's branch of ``solver._pcg_solve``
  (K4's host loop ``pcg_loop`` over the rank's undamped matvec, combined
  here by the identity, and the fixed-order dots) on the same blocks:
  bitwise, in x and in the step count.
* The solve against jitted and op-by-op JAX (``jax.disable_jit``): poses
  within 1e-4, as tests/test_torch_solver.py holds PCG (both run float32
  LM to the same optimum; their dots add in different orders, so the last
  bits differ).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu.config import SolverConfig as JaxSolverConfig
from ndt_2d_tpu.graph import solver as jax_solver
from ndt_2d_tpu_torch import convert
from ndt_2d_tpu_torch.config import SolverConfig
from ndt_2d_tpu_torch.graph import solver
from ndt_2d_tpu_torch.kernels import normal_blocks as k4

torch.set_num_threads(2)

_spec = importlib.util.spec_from_file_location(
    "graph_fixtures", os.path.join(os.path.dirname(__file__),
                                   "test_graph.py"))
graph_fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(graph_fixtures)
chain_with_loop = graph_fixtures._chain_with_loop

L = k4.DOT_LANES


def model_dot(x, y):
    """numpy float32 model of the kernel's dot: one accumulator a lane,
    element by element in index order, then the halving tree."""
    prod = (x.astype(np.float32) * y.astype(np.float32)).reshape(-1)
    acc = np.zeros(L, np.float32)
    for e in range(prod.size):
        acc[e % L] = np.float32(acc[e % L] + prod[e])
    h = L // 2
    while h:
        acc = (acc[:h] + acc[h:2 * h]).astype(np.float32)
        h //= 2
    return acc[0]


@pytest.mark.parametrize("n", [300, L, 3 * L + 5, 12_001],
                         ids=["below", "equal", "ragged", "many-rows"])
def test_fixed_dot_twin_is_the_lane_and_tree_order(n):
    rng = np.random.default_rng(n)
    # Magnitudes over six decades and exact zeros of both signs, so that
    # another order of adds would round differently.
    x = (rng.normal(0, 1, n) * 10.0 ** rng.integers(-3, 4, n)).astype(
        np.float32)
    y = rng.normal(0, 1, n).astype(np.float32)
    x[::97] = 0.0
    y[5::89] = -0.0
    ours = k4.fixed_dot_twin(torch.from_numpy(x), torch.from_numpy(y))
    assert ours.dtype == torch.float32 and ours.dim() == 0
    assert np.float32(ours.item()).tobytes() == model_dot(x, y).tobytes()
    # And it is the dot product.
    assert np.isclose(float(ours), float(np.dot(x.astype(np.float64),
                                                 y.astype(np.float64))),
                      rtol=1e-5, atol=1e-3)


def test_fixed_dots_pairs():
    """One call takes one or two pairs, each its pair's fixed-order dot."""
    rng = np.random.default_rng(5)
    x, y, z = (torch.from_numpy(rng.normal(0, 1, (700, 3)).astype(
        np.float32)) for _ in range(3))
    one = k4.fixed_dots((x, y))
    two = k4.fixed_dots((x, y), (z, z))
    assert len(one) == 1 and len(two) == 2
    assert torch.equal(one[0], k4.fixed_dot_twin(x, y))
    assert torch.equal(two[0], one[0])
    assert torch.equal(two[1], k4.fixed_dot_twin(z, z))
    for bad in ((), ((x, y),) * 3):
        with pytest.raises(ValueError):
            k4.fixed_dots(*bad)


def serpentine(n=400, seed=0):
    """A district graph as chip_smoke.py::district_graph makes it, at n
    nodes: a serpentine survey, odometry and 10% of the column revisits as
    loop closures, noisy initial poses."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(n))
    xs = np.arange(n) % side
    ys = np.arange(n) // side
    xs = np.where(ys % 2 == 0, xs, side - 1 - xs)
    truth = np.stack([xs * 2.0, ys * 2.0, rng.uniform(-0.3, 0.3, n)], -1)
    begin = np.arange(n - 1, dtype=np.int32)
    end = begin + 1
    lc_end = np.arange(n - side, dtype=np.int32)
    lc_begin = lc_end + side
    keep = rng.random(len(lc_begin)) < 0.1
    begin = np.concatenate([begin, lc_begin[keep]])
    end = np.concatenate([end, lc_end[keep]])
    d = truth[end, :2] - truth[begin, :2]
    c, s = np.cos(truth[begin, 2]), np.sin(truth[begin, 2])
    transform = np.stack([c * d[:, 0] + s * d[:, 1],
                          -s * d[:, 0] + c * d[:, 1],
                          truth[end, 2] - truth[begin, 2]], -1)
    info = np.tile(np.eye(3) * 100.0, (len(begin), 1, 1))
    noisy = truth + rng.normal(0, [0.3, 0.3, 0.02], (n, 3))
    noisy[0] = truth[0]
    arrays = dict(poses=noisy.astype(np.float32), begin=begin, end=end,
                  transform=transform.astype(np.float32),
                  information=info.astype(np.float32),
                  constraint_mask=np.ones(len(begin), bool),
                  node_mask=np.ones(n, bool),
                  robust_mask=np.zeros(len(begin), bool))
    return arrays, truth


def chain_arrays(n, drift, seed):
    """The solve inputs of tests/test_graph.py's chain-with-loop graph,
    padded as solve_graph pads them (64 nodes, 64 constraints)."""
    g, truth = chain_with_loop(n=n, drift=drift, seed=seed)
    k, m = g.num_scans, g.num_constraints
    arrays = dict(poses=np.zeros((64, 3), np.float32),
                  begin=np.zeros(64, np.int32), end=np.zeros(64, np.int32),
                  transform=np.zeros((64, 3), np.float32),
                  information=np.zeros((64, 3, 3), np.float32),
                  constraint_mask=np.arange(64) < m,
                  node_mask=np.arange(64) < k,
                  robust_mask=np.zeros(64, bool))
    arrays["poses"][:k] = g.poses
    arrays["begin"][:m] = g.constraint_begin
    arrays["end"][:m] = g.constraint_end
    arrays["transform"][:m] = g.constraint_transform
    arrays["information"][:m] = g.constraint_information
    return arrays, truth


GRAPHS = {
    "chain-12": lambda: chain_arrays(12, 0.05, 3),
    "chain-16": lambda: chain_arrays(16, 0.04, 7),
    "serpentine-400": lambda: serpentine(),
    "serpentine-144": lambda: serpentine(144),
}


def lm_step_inputs(arrays, lam=1e-3):
    """The blocks of the first LM step at the initial poses: (begin, end,
    baa, bab, bbb, g, diag, lam, free_mask, inc)."""
    t = convert.solve_inputs_to_port("cpu", **arrays)
    n = t["poses"].shape[0]
    begin, end = t["begin"].to(torch.int32), t["end"].to(torch.int32)
    inc = k4.incidence(begin, end, t["constraint_mask"], n)
    baa, bab, bbb, _, _, g, diag = k4.normal_blocks_twin(
        t["poses"], begin, end, t["transform"], t["information"],
        t["constraint_mask"], t["robust_mask"], "none", 1.0, inc)
    free = t["node_mask"] & (torch.arange(n) != 0)
    return (begin, end, baa, bab, bbb, g, diag, torch.tensor(lam), free,
            inc)


def twin_and_host_loop(step, max_iter, tol):
    begin, end, baa, bab, bbb, g, diag, lam, free, inc = step
    fm = free.to(torch.float32)
    pinv, b = solver._preconditioner(g, diag, lam, free)
    x, it = k4.pcg_solve_twin(begin, end, baa, bab, bbb, diag, lam, fm, pinv,
                              b, max_iter, tol, inc)

    host = solver._pcg_solve(begin, end, baa, bab, bbb, diag, lam, fm, pinv,
                             b, max_iter, tol, inc, twin=False,
                             combine=lambda part: part)
    return x, int(it), host


@pytest.mark.parametrize("graph", ["chain-12", "chain-16",
                                   "serpentine-400"])
def test_pcg_solve_twin_is_the_host_loop_bitwise(graph):
    arrays, _ = GRAPHS[graph]()
    step = lm_step_inputs(arrays)
    x, it, host = twin_and_host_loop(step, 250, 1e-6)
    assert torch.equal(x, host)
    assert 0 < it <= 250
    # The wrapper on CPU tensors is the twin, and the solver's PCG step is
    # the wrapper.
    begin, end, baa, bab, bbb, g, diag, lam, free, inc = step
    fm = free.to(torch.float32)
    pinv, b = solver._preconditioner(g, diag, lam, free)
    x2, it2 = k4.pcg_solve(begin, end, baa, bab, bbb, diag, lam, fm, pinv, b,
                           250, 1e-6, inc)
    assert torch.equal(x2, x) and int(it2) == it
    x3 = solver._pcg_solve(begin, end, baa, bab, bbb, diag, lam, fm, pinv,
                           b, 250, 1e-6, inc, twin=False)
    assert torch.equal(x3, x)


def test_stop_edges():
    arrays, _ = GRAPHS["serpentine-400"]()
    step = lm_step_inputs(arrays)
    # tol already met: no step, x = 0.
    x, it, host = twin_and_host_loop(step, 250, 1e30)
    assert it == 0 and torch.equal(x, torch.zeros_like(x))
    assert torch.equal(host, x)
    # max_iter caps the loop, and a capped solve is the first steps of a
    # longer one's.
    for cap in (0, 1, 7):
        x, it, host = twin_and_host_loop(step, cap, 0.0)
        assert it == cap and torch.equal(host, x)
    longer, it_long, _ = twin_and_host_loop(step, 8, 0.0)
    assert it_long == 8 and not torch.equal(longer, x)


@pytest.mark.parametrize("graph,op_by_op", [("chain-16", True),
                                            ("serpentine-144", False)])
def test_pcg_solve_matches_jax(graph, op_by_op):
    """The LM solve on PCG to convergence against JAX's jitted solve and,
    on the chain, its op-by-op one (on the serpentine that takes about a
    minute of the CPU)."""
    arrays, truth = GRAPHS[graph]()
    t = convert.solve_inputs_to_port("cpu", **arrays)
    ours = solver.solve(SolverConfig(), **t, use_dense=False)
    assert bool(ours.success)
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    refs = [jax_solver.solve(JaxSolverConfig(), **j, use_dense=False)]
    if op_by_op:
        with jax.disable_jit():
            refs.append(jax_solver.solve(JaxSolverConfig(), **j,
                                         use_dense=False))
    for r in refs:
        assert bool(r.success)
        np.testing.assert_allclose(ours.poses.numpy(), np.asarray(r.poses),
                                   rtol=0, atol=1e-4)
    n = truth.shape[0]
    assert np.abs(ours.poses.numpy()[:n, :2] - truth[:, :2]).max() < 0.05
