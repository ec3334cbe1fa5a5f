"""Distributed pose-graph optimization: constraints sharded over the mesh's
``batch`` axis.

Port of ``ndt_2d_tpu/parallel/solver.py`` (``solve_multichip``,
``pad_constraints``).  The LM loop is ``graph/solver.py``'s with a mesh:
each rank of a ``batch`` line holds a contiguous block of the
constraints, K4 forms its blocks and, over the shard's own incidence
lists, its per-node gradient and block diagonal; each PCG matvec is the
shard's K4 product.  Every such partial, and the robust cost, is
all-gathered and added in rank order (K12's ``rank_sum``) where JAX
``psum``s, so every rank holds the same bits.  Poses are replicated.  A
host graph small enough for the dense solve (``graph.solver.solve_graph``)
takes K4's ``dense_system`` as two launches around the combine (the
shard's node-pair sums, then the rest of the system on the combined sums)
and K4's ``lm_step`` likewise (the shard's cost, then the accept and
update from the combined cost).
"""

from __future__ import annotations

import numpy as np

from ndt_2d_tpu_torch.config import SolverConfig
from ndt_2d_tpu_torch.graph import solver as base


def pad_constraints(begin, end, transform, information, cmask, n_shards: int):
    """Constraint arrays (host numpy) padded with masked constraints to a
    multiple of the shard count (solver.py:31)."""
    c = begin.shape[0]
    c_pad = -(-c // n_shards) * n_shards
    if c_pad == c:
        return begin, end, transform, information, cmask

    def pad(x, dtype):
        out = np.zeros((c_pad,) + x.shape[1:], dtype)
        out[:c] = x
        return out

    return (pad(begin, np.int32), pad(end, np.int32),
            pad(transform, np.float32), pad(information, np.float32),
            pad(cmask, bool))


def solve_multichip(config: SolverConfig, mesh, poses, begin, end,
                    transform, information, constraint_mask, node_mask,
                    fixed_index: int = 0,
                    robust_mask=None) -> base.SolveResult:
    """Levenberg-Marquardt with constraint-sharded PCG normal equations, as
    JAX's (solver.py:52).  Tensors as ``graph.solver.solve``'s, on the
    rank's device and replicated; the constraint count must divide over
    the mesh's ``batch`` axis (``pad_constraints``).  A host ``Graph``
    goes through ``graph.solver.solve_graph`` with the mesh, which solves
    a small graph densely, as one device does."""
    return base.solve(config, poses, begin, end, transform, information,
                      constraint_mask, node_mask, fixed_index=fixed_index,
                      use_dense=False, robust_mask=robust_mask, mesh=mesh)
