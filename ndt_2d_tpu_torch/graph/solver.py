"""Batched Levenberg-Marquardt pose-graph solver on kernel K4.

Port of ``ndt_2d_tpu/graph/solver.py`` (the reference's Ceres solve,
src/ceres_solver.cpp): analytic 3x3 Jacobian blocks for all constraints,
normal equations gathered per node, and either a dense Cholesky solve
(``3 N <= dense_size_limit`` on the padded node count) or matrix-free
block-Jacobi preconditioned conjugate gradients, inside a Levenberg-
Marquardt accept/reject loop.  Failed solves leave the poses untouched.

On the device: kernel K4 (``kernels/normal_blocks.py``) computes the
robust weights, the per-constraint blocks and the per-node gradient and
block diagonal (``normal_blocks``) and the PCG matvec (``pcg_matvec``),
both summing per node in constraint order with no float atomics.  The
dense system is assembled deterministically (diagonal blocks from K4's D,
off-diagonal blocks summed in constraint order per node pair) and solved
by ``torch.linalg.cholesky_ex`` + ``cholesky_solve``, a library call where
the reference calls ``jax.scipy.linalg.solve``.  The LM and PCG loops are
host loops that stop at the reference's iteration (one device->host read
per iteration).  Everything runs in float32 with TF32 off
(``precision="highest"`` in the reference).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from ndt_2d_tpu_torch.kernels import normal_blocks as k4
from ndt_2d_tpu_torch.config import SolverConfig


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


def _f32(x, like):
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def _quad(r, information):
    """[C] r^T Lambda r."""
    return k4._dot3(r, k4._mv(information, r))


def _cost(poses, begin, end, transform, information, cmask):
    w = _quad(residuals(poses, begin, end, transform), information)
    return torch.sum(torch.where(cmask, w, _f32(0.0, w)))


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
    Geman-McClure s^2 / (1 + s^2 / delta^2); plain s^2 off robust_mask."""
    s2 = _quad(residuals(poses, begin, end, transform), information)
    zero = _f32(0.0, s2)
    if config.robust_loss == "none":
        return torch.sum(torch.where(cmask, s2, zero))
    delta = _f32(config.huber_delta, s2)
    if config.robust_loss == "huber":
        s = torch.sqrt(torch.clamp(s2, min=1e-20))
        rho = torch.where(s > delta, delta * (_f32(2.0, s) * s - delta), s2)
    elif config.robust_loss == "geman_mcclure":
        rho = s2 / (_f32(1.0, s2) + s2 / (delta * delta))
    else:
        raise ValueError(f"unknown robust_loss {config.robust_loss!r}")
    rho = torch.where(robust_mask, rho, s2)
    return torch.sum(torch.where(cmask, rho, zero))


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


class _Pairs:
    """Off-diagonal slots of the dense system: the Bab block of each live
    constraint goes to (begin, end) and its transpose to (end, begin); the
    entries of one slot add in that order (all Bab in constraint order,
    then all Bab^T), as the reference's two scatters do.  ``rounds`` holds,
    per rank, the (flat slot, source entry) pairs whose slots are unique
    within the round."""

    def __init__(self, begin, end, cmask, n: int):
        live = torch.nonzero(cmask).squeeze(1)
        b, e = begin[live].long(), end[live].long()
        keys = torch.cat([b * n + e, e * n + b])
        src = torch.cat([live, live + begin.shape[0]])
        order = torch.sort(keys, stable=True).indices
        keys, src = keys[order], src[order]
        first = torch.searchsorted(keys, keys)
        rank = torch.arange(keys.numel(), device=keys.device) - first
        depth = int(rank.max()) + 1 if keys.numel() else 0
        self.rounds = [(keys[rank == d], src[rank == d])
                       for d in range(depth)]


def _dense_solve(n, begin, end, baa, bab, bbb, g, diag, lam, free_mask,
                 pairs: _Pairs):
    """Assemble the [3N, 3N] damped system and Cholesky-solve it.  Diagonal
    blocks are K4's D (sum of Baa and Bbb per node) plus damping;
    off-diagonal blocks add in constraint order per node pair."""
    del begin, end, baa, bbb  # in pairs and diag already
    dev, dt = g.device, g.dtype
    eye = torch.eye(3, dtype=dt, device=dev)
    h = torch.zeros(n * n, 3, 3, dtype=dt, device=dev)
    on_diag = torch.arange(n, device=dev) * (n + 1)
    h[on_diag] = diag
    entries = torch.cat([bab, bab.transpose(-1, -2)])
    for keys, src in pairs.rounds:
        h[keys] = h[keys] + entries[src]
    # LM damping on the block diagonal (Marquardt scaling).
    h[on_diag] = h[on_diag] + lam * (diag * eye + _f32(1e-12, g) * eye)
    # Gauge fix + inactive nodes: identity rows/cols, zero rhs.
    fm = free_mask.to(dt)
    h = h.reshape(n, n, 3, 3) * fm[:, None, None, None] * fm[None, :, None,
                                                           None]
    h = h.reshape(n * n, 3, 3)
    h[on_diag] = h[on_diag] + (1.0 - fm)[:, None, None] * eye
    rhs = -g * fm[:, None]
    hm = h.reshape(n, n, 3, 3).permute(0, 2, 1, 3).reshape(3 * n, 3 * n)
    chol, info = torch.linalg.cholesky_ex(hm)
    delta = torch.cholesky_solve(rhs.reshape(-1, 1), chol).reshape(n, 3)
    # A matrix that is not positive definite gives NaN, as the reference's
    # Cholesky does, so the LM step is rejected.
    return torch.where(info == 0, delta, _f32(float("nan"), delta))


def _pcg_solve(n, begin, end, baa, bab, bbb, g, diag, lam, free_mask,
               max_iter: int, tol, inc: k4.Incidence, twin: bool = False):
    """Matrix-free block-Jacobi PCG on the damped normal equations; the
    matvec is K4's (its twin with ``twin``)."""
    dt, dev = g.dtype, g.device
    eye = torch.eye(3, dtype=dt, device=dev)
    dd = diag + lam * (diag * eye) + _f32(1e-8, g) * eye
    fm = free_mask.to(dt)
    # Block-Jacobi preconditioner: invert 3x3 diagonal blocks.
    pinv = torch.linalg.inv(dd + (1.0 - fm)[:, None, None] * eye)
    mv = k4.pcg_matvec_twin if twin else k4.pcg_matvec
    tol = _f32(tol, g)

    def matvec(v):
        return mv(begin, end, baa, bab, bbb, diag, lam, fm, v, inc)

    def prec(r):
        return k4._mv(pinv, r) * fm[:, None]

    b = -g * fm[:, None]
    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = prec(r)
    p = z
    rz = torch.sum(r * z)
    tiny = _f32(1e-30, g)
    it = 0
    while it < max_iter and bool(torch.linalg.norm(r) > tol):
        ap = matvec(p)
        alpha = rz / torch.maximum(torch.sum(p * ap), tiny)
        x = x + alpha * p
        r = r - alpha * ap
        z = prec(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.maximum(rz, tiny)
        p = z + beta * p
        rz = rz_new
        it += 1
    return x


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
          twin: bool = False) -> SolveResult:
    """Optimize the pose graph with Levenberg-Marquardt.

    Args (tensors on one device): poses [N, 3] f32; begin/end [C] int;
    transform [C, 3]; information [C, 3, 3]; constraint_mask [C] bool;
    node_mask [N] bool; fixed_index: the gauge-fixed node; use_dense:
    dense Cholesky or PCG; robust_mask: [C] bool, the constraints under
    the configured robust loss (None = none); twin: run K4's plain-PyTorch
    twins even on a CUDA device (to hold the kernels against them).
    """
    n = poses.shape[0]
    dev = poses.device
    begin = torch.clamp(begin.to(torch.int32), 0, n - 1).contiguous()
    end = torch.clamp(end.to(torch.int32), 0, n - 1).contiguous()
    free_mask = node_mask & (torch.arange(n, device=dev) != fixed_index)
    if robust_mask is None:
        robust_mask = torch.zeros(begin.shape[0], dtype=torch.bool,
                                  device=dev)
    with _highest_precision():
        return _solve_impl(config, poses.contiguous(), begin, end,
                           transform.contiguous(), information.contiguous(),
                           constraint_mask.contiguous(), free_mask,
                           robust_mask.contiguous(), n, use_dense, twin)


def _solve_impl(config, poses, begin, end, transform, information,
                constraint_mask, free_mask, robust_mask, n, use_dense, twin):
    inc = k4.incidence(begin, end, constraint_mask, n)
    pairs = _Pairs(begin, end, constraint_mask, n) if use_dense else None
    blocks = k4.normal_blocks_twin if twin else k4.normal_blocks
    cost0 = _robust_cost(config, poses, begin, end, transform, information,
                         constraint_mask, robust_mask)
    start = poses
    lam = _f32(config.lm_lambda_init, poses)
    cost = cost0
    stall = torch.zeros((), dtype=torch.int32, device=poses.device)
    it = 0
    while it < config.max_iterations and int(stall) < 3:
        baa, bab, bbb, _, _, g, diag = blocks(
            poses, begin, end, transform, information, constraint_mask,
            robust_mask, config.robust_loss, config.huber_delta, inc)
        if use_dense:
            delta = _dense_solve(n, begin, end, baa, bab, bbb, g, diag, lam,
                                 free_mask, pairs)
        else:
            delta = _pcg_solve(n, begin, end, baa, bab, bbb, g, diag, lam,
                               free_mask, config.cg_max_iterations,
                               config.cg_tolerance, inc, twin)
        new_poses = poses + delta
        new_cost = _robust_cost(config, new_poses, begin, end, transform,
                                information, constraint_mask, robust_mask)
        accept = new_cost < cost
        poses = torch.where(accept, new_poses, poses)
        lam = torch.where(accept, lam * config.lm_lambda_down,
                          lam * config.lm_lambda_up)
        lam = torch.clamp(lam, 1e-12, 1e8)
        improved = (torch.abs(cost - new_cost)
                    > config.tolerance * (cost + 1e-12))
        stall = torch.where(accept & improved, torch.zeros_like(stall),
                            stall + 1)
        cost = torch.where(accept, new_cost, cost)
        it += 1

    ok = torch.isfinite(cost) & (cost <= cost0)
    final = torch.where(ok, poses, start)
    return SolveResult(poses=final, success=ok, cost=cost,
                       iterations=torch.tensor(it, dtype=torch.int32))


def solve_graph(graph, config: SolverConfig, fixed_index: int = 0,
                device=None) -> bool:
    """Optimize a ``pose_graph.Graph`` in place on ``device`` (default
    CPU).  No-op on an empty graph; on success writes the optimized poses
    back (as float64).  Returns True on success."""
    if graph.num_scans == 0 or graph.num_constraints == 0:
        return False
    n = graph.num_scans
    c = graph.num_constraints
    # Power-of-two buckets of at least 64 (solver.py:346-347): the padded
    # node count decides dense vs PCG, as in the reference.
    np_ = max(64, 1 << (n - 1).bit_length())
    cp = max(64, 1 << (c - 1).bit_length())
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
    res = solve(config, fixed_index=fixed_index, use_dense=use_dense,
                **{k: torch.from_numpy(v).to(device)
                   for k, v in args.items()})
    if not bool(res.success):
        return False
    graph.set_poses(res.poses[:n].cpu().numpy().astype(np.float64))
    return True
