"""Batched Levenberg-Marquardt pose-graph solver on kernel K4.

Port of ``ndt_2d_tpu/graph/solver.py`` (the reference's Ceres solve,
src/ceres_solver.cpp): analytic 3x3 Jacobian blocks for all constraints,
normal equations gathered per node, and either a dense Cholesky solve
(``3 N <= dense_size_limit`` on the padded node count) or matrix-free
block-Jacobi preconditioned conjugate gradients, inside a Levenberg-
Marquardt accept/reject loop.  Failed solves leave the poses untouched.

On the device: kernel K4 (``kernels/normal_blocks.py``) computes the
robust weights, the per-constraint blocks and the per-node gradient and
block diagonal (``normal_blocks``), both summing per node in constraint
order with no float atomics, and runs each LM step's whole PCG loop in one
launch (``pcg_solve``: the matvec, fixed-order dot products and the
reference's stop test on the device).  On the dense path K4's
``dense_normal_system`` forms the damped dense system straight from the
poses in one launch (per node row: the node's D and g summed over its
incidence lists, off-diagonal blocks summed in constraint order per node
pair from a per-row pair table built once per solve), which
``torch.linalg.cholesky_ex`` + ``cholesky_solve`` solve, a library call
where the reference calls ``jax.scipy.linalg.solve``.  K4's ``lm_step``
then evaluates the step's robust cost (summed in constraint order)
and accepts or rejects it, updating the poses, damping, cost and stall
count in place on the device.  An LM iteration on one device is thus
``dense_normal_system``, the library's factorization and solve, and
``lm_step`` (PCG: ``pcg_normal_system``, which also forms the block-Jacobi
preconditioner and the right-hand side, ``pcg_solve``, ``lm_step``), with
no host->device copy; the LM loop is a host loop that stops at the
reference's iteration on its one device->host read an iteration (the
stall count).  One device's dense solve is planned once
(``k4.DensePlan``: every tensor checked, the system, factor and step
allocated, and both launches' arguments packed), so on the card an
iteration's two K4 launches are a ctypes call each (on the CPU, or with
``twin``, the plan's calls run the twins); one device's PCG solve plans
its system launch likewise (``k4.PcgPlan``).  Everything runs in float32
with TF32 off (``precision="highest"`` in the reference).

On a device mesh (``mesh``; ``parallel/solver.py``) each rank holds a
contiguous block of the constraints, over the mesh's ``batch`` axis.  The
robust cost, gradient, block diagonal, the dense system's node-pair sums
and each PCG product are then the rank's partials, all-gathered and added
in rank order (K12's ``rank_sum``; the blocks come from ``normal_blocks``,
PCG's preconditioner from ``k4.preconditioner`` after the combine,
and ``dense_system`` and ``lm_step`` split into a launch before the sum
and one after), so every rank holds the same
bits and the LM and CG loops take the same path on every rank.  The mesh's
CG loop is K4's ``mesh_cg``: a plan of three launches a CG step
(``pcg_loop`` over the twins on the CPU).  A mesh chooses dense or PCG by
one device's size rule.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from ndt_2d_tpu_torch.config import SolverConfig
from ndt_2d_tpu_torch.kernels import normal_blocks as k4
from ndt_2d_tpu_torch.kernels import shard_combine
from ndt_2d_tpu_torch.parallel import distributed
from ndt_2d_tpu_torch.parallel.mesh import (
    BATCH_AXIS, axis_group, axis_rank, axis_size)


class SolveResult(NamedTuple):
    poses: torch.Tensor       # [N, 3] optimized poses
    success: torch.Tensor     # 0-d bool
    cost: torch.Tensor        # final cost
    iterations: torch.Tensor  # LM iterations executed (0-d int32)


def residuals(poses, begin, end, transform):
    """[C, 3] residuals (ceres_solver_pose.hpp:93-108)."""
    return k4.residuals_and_jacobians(poses, begin, end, transform)[0]


def _jacobian_blocks(poses, begin, end):
    """Analytic per-constraint Jacobians Ja, Jb: [C, 3, 3]."""
    zero = torch.zeros(begin.shape[0], 3, dtype=poses.dtype,
                       device=poses.device)
    return k4.residuals_and_jacobians(poses, begin, end, zero)[1:]


def _cost(poses, begin, end, transform, information, cmask):
    """The plain cost, summed in constraint order."""
    none = torch.zeros_like(cmask)
    return k4.robust_cost_twin(poses, None, None, begin, end, transform,
                               information, cmask, none, "none", 1.0)


def robust_weights(config: SolverConfig, poses, begin, end, transform,
                   information, robust_mask):
    """[C] IRLS weights of the configured robust loss on the constraints in
    ``robust_mask`` (all ones when the loss is "none")."""
    r = residuals(poses, begin, end, transform)
    return k4.robust_weight(config.robust_loss, config.huber_delta, r,
                            information, robust_mask)


def _robust_cost(config: SolverConfig, poses, begin, end, transform,
                 information, cmask, robust_mask):
    """Huber rho(s) = s^2 for s <= delta, delta (2 s - delta) beyond;
    Geman-McClure s^2 / (1 + s^2 / delta^2); plain s^2 off robust_mask;
    summed in constraint order (``k4.robust_cost_twin``)."""
    return k4.robust_cost_twin(poses, None, None, begin, end, transform,
                               information, cmask, robust_mask,
                               config.robust_loss, config.huber_delta)


def _normal_blocks(poses, begin, end, transform, information, cmask):
    """Per-constraint weighted blocks (Baa, Bab, Bbb [C, 3, 3], ga, gb
    [C, 3]) on ``information`` (already weighted), masked by cmask: the
    constraint half of K4's twin."""
    none = torch.zeros_like(cmask)
    return k4.constraint_blocks_twin(poses, begin, end, transform,
                                     information, cmask, none, "none", 1.0)


def _gather_gradient_and_diag(n, begin, end, baa, bab, bbb, ga, gb,
                              inc: Optional[k4.Incidence] = None):
    """Per-node gradient g [N, 3] and block diagonal D [N, 3, 3], each
    summed in constraint order (K4's node half; ``inc`` defaults to the
    lists of every constraint)."""
    del bab  # part of the reference's signature; unused
    if inc is None:
        inc = k4.incidence(begin, end, torch.ones_like(begin, dtype=bool), n)
    return k4.node_sums_twin(baa, bbb, ga, gb, inc)


def _dense_solve(n, hm, rhs, out=None):
    """The damped dense system (hm [3N, 3N], rhs [3N]), Cholesky-solved.
    Returns (delta [N, 3], the factorization's 0-d status): a matrix that
    is not positive definite has info != 0, and ``lm_step`` then steps by
    NaN, as the reference's Cholesky gives NaN, so the step is
    rejected.  ``out``: (factor, info, delta) to write into, a plan's
    (``k4.DensePlan.solve_out``), the same values."""
    if out is None:
        chol, info = torch.linalg.cholesky_ex(hm)
        delta = torch.cholesky_solve(rhs.reshape(-1, 1), chol).reshape(n, 3)
        return delta, info
    chol, info, delta = out
    torch.linalg.cholesky_ex(hm, out=(chol, info))
    torch.cholesky_solve(rhs.reshape(-1, 1), chol, out=delta.view(-1, 1))
    return delta, info


def _pcg_solve(begin, end, baa, bab, bbb, diag, lam, fm, pinv, b,
               max_iter: int, tol, inc: k4.Incidence, twin: bool,
               combine=None):
    """Matrix-free block-Jacobi PCG on the damped normal equations, from
    the preconditioner ``pinv`` and right-hand side ``b`` (one device's
    from ``k4.PcgPlan``'s launch, a mesh's from ``k4.preconditioner``
    after the combine).  On one device the whole loop is K4's
    ``pcg_solve`` (its twin with ``twin``).  With ``combine`` (a mesh) it
    is K4's ``mesh_cg``: the rank's undamped product is added over ranks,
    then damped as K4 damps it, a CG step three planned launches, the
    combine and one read (``pcg_loop`` over the twins on the CPU or with
    ``twin``)."""
    if combine is None:
        solve = k4.pcg_solve_twin if twin else k4.pcg_solve
        return solve(begin, end, baa, bab, bbb, diag, lam, fm, pinv, b,
                     max_iter, tol, inc)[0]
    return k4.mesh_cg(begin, end, baa, bab, bbb, diag, lam, fm, pinv, b,
                      max_iter, tol, inc, combine, twin)[0]


def _preconditioner(g, diag, lam, free_mask):
    """The block-Jacobi inverse pinv [N, 3, 3] of the damped diagonal
    blocks (identity at fixed nodes) and the right-hand side -g over the
    free nodes [N, 3]: K4's twin (``k4.preconditioner_twin``: three LU
    solves a block, no library inverse)."""
    return k4.preconditioner_twin(g, diag, lam, free_mask.to(g.dtype))


@contextlib.contextmanager
def _highest_precision():
    """Full-float32 matmuls and convolutions (no TF32) for the solve, as
    the reference's ``jax.default_matmul_precision("highest")``."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def solve(config: SolverConfig, poses, begin, end, transform, information,
          constraint_mask, node_mask, fixed_index: int = 0,
          use_dense: bool = True, robust_mask=None,
          twin: bool = False, mesh=None) -> SolveResult:
    """Optimize the pose graph with Levenberg-Marquardt.

    Args (tensors on one device, replicated over a mesh): poses [N, 3]
    f32; begin/end [C] int; transform [C, 3]; information [C, 3, 3];
    constraint_mask [C] bool; node_mask [N] bool; fixed_index: the
    gauge-fixed node; use_dense: dense Cholesky or PCG; robust_mask: [C]
    bool, the constraints under the configured robust loss (None = none);
    twin: run K4's plain-PyTorch twins even on a CUDA device (to hold the
    kernels against them); mesh: shard the constraints over its ``batch``
    axis (C a multiple of its size: ``parallel.solver.pad_constraints``).
    """
    n = poses.shape[0]
    dev = poses.device
    begin = torch.clamp(begin.to(torch.int32), 0, n - 1)
    end = torch.clamp(end.to(torch.int32), 0, n - 1)
    free_mask = node_mask & (torch.arange(n, device=dev) != fixed_index)
    if robust_mask is None:
        robust_mask = torch.zeros(begin.shape[0], dtype=torch.bool,
                                  device=dev)
    shard = (begin, end, transform, information, constraint_mask,
             robust_mask)
    combine = None
    if mesh is not None:
        shard, combine = _constraint_shard(mesh, shard)
    shard = [x.contiguous() for x in shard]
    with _highest_precision():
        return _solve_impl(config, poses.contiguous(), *shard, free_mask, n,
                           use_dense, twin, combine)


def _constraint_shard(mesh, arrays):
    """This rank's contiguous block of each [C, ...] constraint array over
    the mesh's ``batch`` axis, and the combine of a partial over that axis:
    every rank's partial, added in rank order."""
    S, s = axis_size(mesh, BATCH_AXIS), axis_rank(mesh, BATCH_AXIS)
    C = arrays[0].shape[0]
    if C % S:
        raise ValueError(f"constraint capacity {C} must divide by the "
                         f"'batch' shard count {S}; use pad_constraints()")
    block = slice(s * (C // S), (s + 1) * (C // S))
    group = axis_group(mesh, BATCH_AXIS)

    def combine(x):
        return shard_combine.rank_sum(distributed.gather(x, group))
    return [x[block] for x in arrays], combine


def _solve_impl(config, poses, begin, end, transform, information,
                constraint_mask, robust_mask, free_mask, n, use_dense, twin,
                combine=None):
    """The LM loop over the constraints given (a rank's shard on a mesh,
    where ``combine`` adds a partial over the ranks)."""
    inc = k4.incidence(begin, end, constraint_mask, n)
    pairs = (k4.pair_table(begin, end, constraint_mask, n) if use_dense
             else None)
    blocks = k4.normal_blocks_twin if twin else k4.normal_blocks
    system = k4.dense_system_twin if twin else k4.dense_system
    step = k4.lm_step_twin if twin else k4.lm_step
    precondition = k4.preconditioner_twin if twin else k4.preconditioner
    cost_of = k4.robust_cost_twin if twin else k4.robust_cost
    fm = free_mask.to(poses.dtype)
    total = combine or (lambda x: x)
    loss, hdelta = config.robust_loss, config.huber_delta
    terms = (begin, end, transform, information, constraint_mask,
             robust_mask, loss, hdelta)
    cost0 = total(cost_of(poses, None, None, *terms).reshape(1))[0]
    # The state is a copy: ``poses`` stays the start the result falls back
    # to.
    state = k4.lm_state(poses, config.lm_lambda_init, cost0,
                        begin.shape[0])
    plan = pcg = None
    if use_dense and combine is None:
        # One device: an iteration's two launches planned once a solve, the
        # system straight from the poses.
        plan = k4.DensePlan(state, *terms, inc, pairs, fm,
                            config.lm_lambda_down, config.lm_lambda_up,
                            config.tolerance, twin)
    elif combine is None:
        # One device's PCG: the blocks, D, the preconditioner and b in one
        # launch a solve planned (lam read on the device), then pcg_solve.
        pcg = k4.PcgPlan(state, *terms, inc, fm, twin)
    it = 0
    while it < config.max_iterations and int(state.stall) < 3:
        if plan is not None:
            _dense_solve(n, *plan.system(), plan.solve_out)
            plan.step()
        elif pcg is not None:
            baa, bab, bbb, diag, pinv, b = pcg.system()
            delta = _pcg_solve(begin, end, baa, bab, bbb, diag, state.lam,
                               fm, pinv, b, config.cg_max_iterations,
                               config.cg_tolerance, inc, twin)
            step(state, delta, None, *terms, config.lm_lambda_down,
                 config.lm_lambda_up, config.tolerance)
        else:
            baa, bab, bbb, _, _, g, diag = blocks(
                state.poses, begin, end, transform, information,
                constraint_mask, robust_mask, loss, hdelta, inc)
            g, diag = total(g), total(diag)
            if use_dense:
                delta, info = _dense_solve(n, *system(
                    pairs, bab, g, diag, state.lam, fm, combine))
            else:
                pinv, b = precondition(g, diag, state.lam, fm)
                delta = _pcg_solve(begin, end, baa, bab, bbb, diag,
                                   state.lam, fm, pinv, b,
                                   config.cg_max_iterations,
                                   config.cg_tolerance, inc, twin, combine)
                info = None
            step(state, delta, info, *terms, config.lm_lambda_down,
                 config.lm_lambda_up, config.tolerance, combine)
        it += 1

    cost = state.cost
    ok = torch.isfinite(cost) & (cost <= cost0)
    final = torch.where(ok, state.poses, poses)
    return SolveResult(poses=final, success=ok, cost=cost,
                       iterations=torch.tensor(it, dtype=torch.int32))


def solve_graph(graph, config: SolverConfig, fixed_index: int = 0,
                device=None, mesh=None) -> bool:
    """Optimize a ``pose_graph.Graph`` in place on ``device`` (default
    CPU), with a ``mesh`` constraint-sharded over its ``batch`` axis
    (runtime.py:398).  No-op on an empty graph; on success writes the
    optimized poses back (as float64).  Returns True on success."""
    if graph.num_scans == 0 or graph.num_constraints == 0:
        return False
    n = graph.num_scans
    c = graph.num_constraints
    # Power-of-two buckets of at least 64 (solver.py:346-347): the padded
    # node count decides dense vs PCG, as in the reference.  On a mesh the
    # constraints round up to a multiple of the shard count.
    shards = 1 if mesh is None else axis_size(mesh, BATCH_AXIS)
    np_ = max(64, 1 << (n - 1).bit_length())
    cp = max(64, 1 << (c - 1).bit_length())
    cp = -(-cp // shards) * shards
    poses = np.zeros((np_, 3), np.float32)
    poses[:n] = graph.poses
    begin = np.zeros(cp, np.int32)
    begin[:c] = graph.constraint_begin
    end = np.zeros(cp, np.int32)
    end[:c] = graph.constraint_end
    transform = np.zeros((cp, 3), np.float32)
    transform[:c] = graph.constraint_transform
    information = np.zeros((cp, 3, 3), np.float32)
    information[:c] = graph.constraint_information
    switchable = np.zeros(cp, bool)
    switchable[:c] = graph.constraint_switchable
    args = dict(poses=poses, begin=begin, end=end, transform=transform,
                information=information, constraint_mask=np.arange(cp) < c,
                node_mask=np.arange(np_) < n, robust_mask=switchable)
    use_dense = 3 * np_ <= config.dense_size_limit
    tensors = {k: torch.from_numpy(v).to(device) for k, v in args.items()}
    res = solve(config, fixed_index=fixed_index, use_dense=use_dense,
                mesh=mesh, **tensors)
    if not bool(res.success):
        return False
    graph.set_poses(res.poses[:n].cpu().numpy().astype(np.float64))
    return True
