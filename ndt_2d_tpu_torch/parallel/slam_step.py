"""The fused multichip SLAM step: one accepted scan's window build, sharded
match, scan and constraint append and periodic sharded solve.

Port of ``ndt_2d_tpu/parallel/slam_step.py``, the reference's
zero-round-trip core step:

  1. the rolling-window NDT build (K1) over the padded scan buffers;
  2. the lattice search with its angles over the mesh's ``space`` axis
     (``matching/matcher.py::match_scan`` with the mesh: K12's split K2
     or K6);
  3. the scan and its odometry constraint appended into the padded
     buffers (KB4, ``kernels/slam_step.py``; the constraint is
     ``core/constraint.py::make_constraint``'s): in the search's own
     finalize launch where the search is the split K2 and nothing polishes
     its winner, else in KB4's planned launch (``append_route``);
  4. every ``optimize_every`` scans, the constraint-sharded solve
     (``parallel/solver.py::solve_multichip``, constraints over
     ``batch``).

In PyTorch's idiom the scan and constraint counts are host ints: the host
issues every step, so ``jax.lax.cond`` is a host ``if`` and the window
mask comes from host ints.  Inside a step nothing is read back except by
the solve, whose LM loop is a host loop (``graph/solver.py``).  The
state's tensors are updated in place.  The product path for multichip
SLAM stays ``Mapper(mesh=...)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ndt_2d_tpu_torch.config import MapperConfig
from ndt_2d_tpu_torch.device import get_device, upload
from ndt_2d_tpu_torch.kernels import candidate_scores as k2
from ndt_2d_tpu_torch.kernels import slam_step as kb4
from ndt_2d_tpu_torch.matching import matcher
from ndt_2d_tpu_torch.parallel import solver as psolver


@dataclasses.dataclass
class SlamState:
    """Device-resident SLAM state (padded, fixed shape); ``num_scans`` and
    ``c_num`` are host ints."""

    poses: torch.Tensor          # [S, 3]
    points: torch.Tensor         # [S, P, 2]
    point_mask: torch.Tensor     # [S, P]
    num_scans: int
    c_begin: torch.Tensor        # [C] int32
    c_end: torch.Tensor          # [C] int32
    c_transform: torch.Tensor    # [C, 3]
    c_information: torch.Tensor  # [C, 3, 3]
    c_num: int
    prev_pose: torch.Tensor      # [3] the last corrected robot pose
    # KB4's plan of these tensors (``kb4.plan_for``), made at the first step.
    plan: Optional[kb4.SlamPlan] = dataclasses.field(default=None,
                                                     repr=False)


def init_state(max_scans: int, max_points: int, max_constraints: int,
               device=None) -> SlamState:
    dev = get_device(device)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(*shape, dtype=dtype, device=dev)
    return SlamState(
        poses=zeros(max_scans, 3), points=zeros(max_scans, max_points, 2),
        point_mask=zeros(max_scans, max_points, dtype=torch.bool),
        num_scans=0, c_begin=zeros(max_constraints, dtype=torch.int32),
        c_end=zeros(max_constraints, dtype=torch.int32),
        c_transform=zeros(max_constraints, 3),
        c_information=zeros(max_constraints, 3, 3), c_num=0,
        prev_pose=zeros(3))


# How a step's KB4 runs (``append_route``).
FOLDED = "folded"
PLANNED = "planned"


def append_route(mesh, search, refine_iterations: int) -> str:
    """FOLDED when the append rides in the search's finalize launch: the
    search is K2's (``search``, the kernel module of
    ``matching/matcher.py::search_kernel``) split over a ``mesh``, and no
    Newton polish runs between the search and the append; else PLANNED,
    KB4's own launch through the state's plan."""
    if mesh is not None and search is k2 and refine_iterations == 0:
        return FOLDED
    return PLANNED


def make_slam_step(mesh, config: MapperConfig, range_max: float,
                   optimize_every: int = 8):
    """The SLAM step for ``mesh`` (None: one device) and ``config``."""
    mcfg = config.local_scan_matcher
    depth = config.rolling_depth
    route = append_route(mesh, matcher.search_kernel(mcfg),
                         mcfg.refine_iterations)

    def step(state: SlamState, scan_points, scan_mask, odom_delta,
             num_points: Optional[int] = None):
        """One accepted scan: match, append, optionally optimize.

        scan_points [P, 2] robot-frame points, scan_mask [P] and odom_delta
        [3] (the dead-reckoned pose delta since the last scan, already
        heading-corrected, cf. ndt_mapper.cpp:357-364) as host arrays or
        tensors on the state's device; ``num_points`` the scan's point
        count (counted from the mask when not given, a device read for a
        CUDA mask).  Returns (state, MatchResult)."""
        dev = state.poses.device
        if num_points is None:
            num_points = (int(scan_mask.sum())
                          if isinstance(scan_mask, torch.Tensor)
                          else int(np.count_nonzero(np.asarray(scan_mask))))
        if not isinstance(scan_points, torch.Tensor):
            scan_points = upload(np.asarray(scan_points, np.float32), dev)
            scan_mask = upload(np.asarray(scan_mask, bool), dev)
            odom_delta = upload(np.asarray(odom_delta, np.float32), dev)
        est_pose = state.prev_pose + odom_delta
        i, j = state.num_scans, state.c_num
        if i >= state.poses.shape[0]:
            raise ValueError(f"the state holds {state.poses.shape[0]} scans")
        # 1. Rolling-window NDT build over the buffers' last `depth` scans.
        idx = torch.arange(state.poses.shape[0], device=dev)
        wmask = (idx < i) & (idx >= i - depth)
        grid, table = matcher.build_window_ndt(
            mcfg, state.poses, state.points, state.point_mask, wmask,
            range_max)
        # 2. The search, angles over the mesh's 'space' axis; 3. the scan +
        # odometry constraint append (KB4), folded into the search's
        # finalize or planned after it.
        has_prior = i > 0
        plan = kb4.plan_for(state)
        fold = (kb4.Append(plan, est_pose, scan_points, scan_mask, i, j,
                           has_prior) if route == FOLDED else None)
        res = matcher.match_scan(mcfg, grid, scan_points, scan_mask,
                                 num_points, est_pose, packed_table=table,
                                 mesh=mesh, append=fold)
        if fold is None:
            plan.append(est_pose, res.correction, res.covariance,
                        scan_points, scan_mask, i, j, has_prior)
        state.num_scans = i + 1
        state.c_num = j + 1 if has_prior else j
        # 4. Periodic constraint-sharded pose-graph refinement.
        if state.num_scans % optimize_every == 0 and state.c_num > 0:
            out = psolver.solve_multichip(
                config.solver, mesh, state.poses, state.c_begin,
                state.c_end, state.c_transform, state.c_information,
                torch.arange(state.c_begin.shape[0], device=dev)
                < state.c_num, idx < state.num_scans)
            state.poses.copy_(out.poses)
            state.prev_pose.copy_(out.poses[state.num_scans - 1])
        return state, res

    return step
