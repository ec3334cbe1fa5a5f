"""K3: a scan's NDT score at M poses (CUDA ``csrc/score_points.cu``) and its
twin.

Replaces ``ndt_2d_tpu/matching/matcher.py::score_points_at_pose`` ->
``ndt_2d_tpu/ndt/grid.py::score_points`` / ``score_at_cells`` (single
grid), and ``matcher.py::score_points_batch``, its ``jax.vmap`` over poses
(the particle filter's measurement): subsample, transform, cell lookup,
clamped Gaussian, then -sum / max(used, 1).  ``score_batch`` is one launch
over M poses, a warp each; ``score_at_pose`` gives its one pose a whole
block.  ``score_composed`` is ``score_at_pose`` at the pose K13's compose
dead-reckons (``matcher.py::mapping_step_async`` :660-664,
``localization_step_async`` :691-695), in the same launch, and returns
that pose too.

The beams of a pose are summed in one order whatever the launch: lane l of
a warp adds beams l, l + 32, ... from 0, then lanes combine by halving
(16, 8, 4, 2, 1).  The twin adds in that order too, so kernel and twin
agree bitwise, and a pose's score is the same bits through every entry
(``block_order_sum`` models how the block-per-pose launch keeps that
order).

The particle filter's launch (``motion_score``, ``score_records``) is a warp a
pose too, eight blocks an SM, but reads each beam's cell as one record, the
first 8 floats of a row of K1's patch table (mean x, mean y, i00, i01, i11, the
count >= 5 flag: ``ndt/grid.py::packed_cell_table``'s bits), and with motion on
first moves each particle by K9's motion sample in the same launch
(``ndt_2d_tpu/filter/particle_filter.py::pf_step``'s ``motion_model.sample``
then ``score_points_batch``), returning the moved particles with the scores.
Its twin is ``motion_twin`` then ``records_twin``, which is
``score_batch_twin`` read from the records, the same bits.  A shape's launch is
a ``ParticlePlan``, made once: its argument block packed, the C function bound,
the map's tensors checked when they change; a call checks the step's tensors,
allocates the two outputs and makes one ctypes call.

A grid with a grid axis (the four overlapping grids: origin [4, 2], mean
[4, C, 2], ...) scores each beam as the mean over its grids, summed from 0
in grid order, before the beams are summed (matcher.py:411-416).

KB2, ``stripe_points`` / ``stripe_poses``: the particle launch with the
motion off against one y-stripe of a sharded map
(``ndt_2d_tpu/parallel/ndt_blocks.py:88``, ``:116``), each beam's cell one
record of KB1's stripe table, only the points or beams whose global bin
lies in the stripe counted, as raw sums in the same lane order (the caller
adds the stripes and divides); a plan kept a stripe.  ``records_twin`` at
``row0`` / ``raw`` is its twin, bitwise the SoA ``stripe_poses_twin``.

The launch path: a launch shape's constant scalars sit in one ``_Args``
block made once a shape (``_plan``), the tensors are checked in one pass
against the shapes the plan expects, and the C call takes the block's
address, the pointers, the two counts and the stream.
"""

from __future__ import annotations

import ctypes

import torch

from ndt_2d_tpu_torch.kernels import _build
from ndt_2d_tpu_torch.kernels import particle_filter as k9
from ndt_2d_tpu_torch.kernels import pose_chain as k13
from ndt_2d_tpu_torch.ndt import grid as ndt_grid

# Launches of the single-pose entry, of the batched one and of the
# single-pose entry with the compose folded in.
launches = 0
batch_launches = 0
composed_launches = 0
# KB2: launches of the stripe scores (world points; poses).
stripe_launches = 0
# The particle launch: with the motion sample folded in; scoring given poses.
particle_launches = 0
record_launches = 0

# Slots a pass of the block-per-pose launch (the source's kPoseThreads).
POSE_THREADS = 128


class _Args(ctypes.Structure):
    """A launch shape's constants (``csrc/score_points.cu::ScoreArgs``)."""
    _fields_ = ([(f, ctypes.c_int) for f in
                 ("P", "max_beams", "G", "W", "row0", "h", "raw")]
                + [("cell", ctypes.c_float)])


# args, points, pmask, num_points, poses, M, origin, mean, info, count,
# out, prev, delta, pose_out, stream.
_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_int] + [ctypes.c_void_p] * 9)


class _Plan:
    """A launch shape's argument block (kept alive here; its address
    crosses into C), its device and the (name, dtype, shape) each tensor
    must have: the scan's and the grid's, then those of the pose entry
    and of the compose entry."""

    def __init__(self, P, max_beams, mean_shape, width, row0, rows, raw,
                 cell, dev):
        G = mean_shape[0] if len(mean_shape) == 3 else 1
        lead = () if len(mean_shape) == 2 else (G,)
        C = width * rows
        f32 = torch.float32
        self.args = _Args(P, max_beams, G, width, row0, rows, int(raw), cell)
        self.address = ctypes.addressof(self.args)
        self.device = dev
        self.expect = (("points", f32, (P, 2)),
                       ("point_mask", torch.bool, (P,)),
                       ("origin", f32, (*lead, 2)),
                       ("mean", f32, (*lead, C, 2)),
                       ("information", f32, (*lead, C, 3)),
                       ("count", torch.int32, (*lead, C)))
        self.pose = self.expect + (("pose", f32, (3,)),)
        self.compose = self.expect + (("prev", f32, (3,)),
                                      ("delta", f32, (3,)))


_PLANS: dict = {}


def _plan(grid, width, row0, rows, max_beams, points, raw) -> _Plan:
    """The plan of this launch shape, made at its first launch."""
    dev = points.device
    key = (points.shape[0], max_beams, grid.mean.shape, width, row0, rows,
           raw, grid.cell_size, dev)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = _Plan(*key)
    return plan


def subsample(points, point_mask, num_points: int, max_beams: int):
    """Stride-subsample a padded scan to ``max_beams`` slots
    (src/scan_matcher_ndt.cpp:94-101): used = min(max_beams, n),
    step = n / used, idx_i = floor(i * step).  Returns (points
    [max_beams, 2], mask [max_beams], used)."""
    dev = points.device
    used = min(int(max_beams), int(num_points))
    step = (ndt_grid.f32(num_points, dev)
            / ndt_grid.f32(max(used, 1), dev))
    i = torch.arange(max_beams, dtype=torch.float32, device=dev)
    idx = torch.clamp((i * step).to(torch.int32), max=num_points - 1)
    idx = torch.clamp(idx, 0, points.shape[0] - 1).to(torch.int64)
    mask = (torch.arange(max_beams, device=dev) < used) & point_mask[idx]
    return points[idx], mask, used


def lane_tree_sum(terms):
    """Sum [M, slots] per-beam terms (slots a multiple of 32) in the
    kernel's order: per lane l, beams l, l + 32, ... from 0; then lanes
    by halving.  Returns [M]."""
    lanes = terms.reshape(terms.shape[0], -1, 32)
    acc = torch.zeros_like(lanes[:, 0])
    for k in range(lanes.shape[1]):
        acc = acc + lanes[:, k]
    for off in (16, 8, 4, 2, 1):
        acc = acc[:, :off] + acc[:, off:2 * off]
    return acc[:, 0]


def pose_plan(max_beams: int):
    """(slots, threads) of the block-per-pose launch: the slots rounded up
    to whole warps, one thread a slot of a pass of at most POSE_THREADS
    (and at least one warp)."""
    slots = -(-max_beams // 32) * 32
    return slots, min(max(slots, 32), POSE_THREADS)


def block_order_sum(terms, threads: int):
    """The block-per-pose launch's additions, step by step, over [slots]
    terms: pass p stages slots p * threads + t; warp 0's lane l adds the
    pass's slots l, l + 32, ... to its running sum; the lanes then combine
    by halving.  Returns a 0-d tensor (equal to ``lane_tree_sum`` bitwise:
    each lane meets its slots in the same order)."""
    slots = terms.shape[0]
    acc = torch.zeros(32, dtype=terms.dtype)
    for base in range(0, slots, threads):
        staged = terms[base:base + threads]
        for lane in range(32):
            for j in range(lane, min(threads, slots - base), 32):
                acc[lane] = acc[lane] + staged[j]
    for off in (16, 8, 4, 2, 1):
        acc = acc[:off] + acc[off:2 * off]
    return acc[0]


def beam_terms_twin(grid: ndt_grid.NDTGrid, width: int, height: int,
                    max_beams: int, points, point_mask, num_points: int,
                    poses):
    """Plain-PyTorch K3's terms over poses [M, 3]: ([M, slots] per-beam
    scores, zero past max_beams up to whole warps, and the beams used)."""
    spts, smask, used = subsample(points, point_mask, num_points, max_beams)
    c, s = torch.cos(poses[:, 2:3]), torch.sin(poses[:, 2:3])
    px, py = spts[:, 0], spts[:, 1]
    wx = c * px - s * py + poses[:, 0:1]
    wy = s * px + c * py + poses[:, 1:2]
    w = torch.stack([wx, wy], dim=-1)
    wmask = smask.expand(poses.shape[0], -1)
    if grid.mean.dim() == 2:
        sc = ndt_grid.score_points(grid, w, wmask, width, height)
    else:
        grids = ndt_grid.split_grids(grid)
        sc = sum(ndt_grid.score_points(g, w, wmask, width, height)
                 for g in grids) / ndt_grid.f32(len(grids), points.device)
    slots = -(-max_beams // 32) * 32
    return torch.nn.functional.pad(sc, (0, slots - max_beams)), used


def score_batch_twin(grid: ndt_grid.NDTGrid, width: int, height: int,
                     max_beams: int, points, point_mask, num_points: int,
                     poses):
    """Plain-PyTorch K3 over poses [M, 3]: [M] mean negative likelihoods,
    as a [M, beams] expression summed in the kernel's order."""
    sc, used = beam_terms_twin(grid, width, height, max_beams, points,
                               point_mask, num_points, poses)
    return -lane_tree_sum(sc) / ndt_grid.f32(max(used, 1), points.device)


def score_at_pose_twin(grid: ndt_grid.NDTGrid, width: int, height: int,
                       max_beams: int, points, point_mask, num_points: int,
                       pose):
    """Plain-PyTorch K3 at one pose [3]: ``score_batch_twin`` at M = 1,
    returned as a 0-d tensor."""
    return score_batch_twin(grid, width, height, max_beams, points,
                            point_mask, num_points, pose[None])[0]


def score_composed_twin(grid: ndt_grid.NDTGrid, width: int, height: int,
                        max_beams: int, points, point_mask, num_points: int,
                        prev, delta):
    """Plain-PyTorch ``score_composed``: K13's ``compose_twin``, then
    ``score_at_pose_twin`` at that pose.  Returns (score, pose [3])."""
    pose = k13.compose_twin(prev, delta)
    return score_at_pose_twin(grid, width, height, max_beams, points,
                              point_mask, num_points, pose), pose


def _launch(plan: _Plan, grid, points, point_mask, num_points: int, poses,
            M: int, out, prev=None, delta=None, pose_out=None) -> None:
    """One K3 launch of ``plan``'s shape (the tensors already checked)."""
    p = _build.ptr
    err = _build.function("ndt2d_score_points", _ARGS)(
        plan.address, p(points), p(point_mask), num_points,
        None if poses is None else p(poses), M, p(grid.origin),
        p(grid.mean), p(grid.information), p(grid.count), p(out),
        None if prev is None else p(prev),
        None if delta is None else p(delta),
        None if pose_out is None else p(pose_out),
        _build.stream_ptr(plan.device))
    _build.check(err, "score_points")


def _batch(grid, width, row0, rows, max_beams, points, point_mask,
           num_points, poses, raw):
    """K3 over poses [M, 3] on the grid rows [row0, row0 + rows) (the
    whole grid at row0 = 0, rows = H); ``raw`` leaves out the division."""
    plan = _plan(grid, width, row0, rows, max_beams, points, raw)
    M = poses.shape[0]
    if M < 1:
        raise ValueError("score_points needs at least one pose")
    _build.require_all(plan.device, (points, point_mask, grid.origin,
                                     grid.mean, grid.information, grid.count,
                                     poses),
                       plan.expect + (("poses", torch.float32, (M, 3)),))
    out = points.new_empty(M)
    _launch(plan, grid, points, point_mask, int(num_points), poses, M, out)
    return out


def score_batch(grid: ndt_grid.NDTGrid, width: int, height: int,
                max_beams: int, points, point_mask, num_points: int, poses):
    """K3 over poses [M, 3] f32 (points [P, 2] f32, point_mask [P] bool);
    returns [M] float32.  CPU tensors run the twin; CUDA tensors launch
    the kernel."""
    global batch_launches
    if points.device.type == "cpu":
        return score_batch_twin(grid, width, height, max_beams, points,
                                point_mask, num_points, poses)
    out = _batch(grid, width, 0, height, max_beams, points, point_mask,
                 num_points, poses, False)
    batch_launches += 1
    return out


def score_at_pose(grid: ndt_grid.NDTGrid, width: int, height: int,
                  max_beams: int, points, point_mask, num_points: int, pose):
    """K3 at one pose [3] f32, one block; returns a 0-d float32 tensor,
    the same bits as ``score_batch``'s row at that pose.  CPU tensors run
    the twin; CUDA tensors launch the kernel."""
    global launches
    if points.device.type == "cpu":
        return score_at_pose_twin(grid, width, height, max_beams, points,
                                  point_mask, num_points, pose)
    plan = _plan(grid, width, 0, height, max_beams, points, False)
    _build.require_all(plan.device, (points, point_mask, grid.origin,
                                     grid.mean, grid.information, grid.count,
                                     pose), plan.pose)
    out = points.new_empty(())
    _launch(plan, grid, points, point_mask, int(num_points), pose, 1, out)
    launches += 1
    return out


def score_composed(grid: ndt_grid.NDTGrid, width: int, height: int,
                   max_beams: int, points, point_mask, num_points: int,
                   prev, delta):
    """K3 at the pose dead-reckoned from the previous corrected pose
    ``prev`` [3] and the odometry motion ``delta`` [3] in its robot frame
    (K13's compose), in one launch.  Returns (0-d score, pose [3]), the
    same bits as ``compose_twin`` then ``score_at_pose``.  CPU tensors run
    the twin; CUDA tensors launch the kernel."""
    global composed_launches
    if points.device.type == "cpu":
        return score_composed_twin(grid, width, height, max_beams, points,
                                   point_mask, num_points, prev, delta)
    plan = _plan(grid, width, 0, height, max_beams, points, False)
    _build.require_all(plan.device, (points, point_mask, grid.origin,
                                     grid.mean, grid.information, grid.count,
                                     prev, delta), plan.compose)
    out, pose = points.new_empty(()), points.new_empty(3)
    _launch(plan, grid, points, point_mask, int(num_points), None, 1, out,
            prev, delta, pose)
    composed_launches += 1
    return out, pose


# --- the particle filter's launch: motion sample and record read -------------
class _ParticleArgs(ctypes.Structure):
    """A particle plan's constants (``csrc/score_points.cu::ParticleArgs``):
    the grid rows [row0, row0 + h) its table holds, raw sums or divided."""
    _fields_ = ([(f, ctypes.c_int) for f in
                 ("P", "max_beams", "G", "W", "row0", "h", "stride", "M",
                  "motion", "raw")]
                + [("cell", ctypes.c_float)])


class _ParticleLaunch(ctypes.Structure):
    """One particle launch (``csrc/score_points.cu::ParticleLaunch``): the
    plan's constants, the tensors' pointers, the six motion scalars and
    the scan's point count."""
    _fields_ = ([("a", _ParticleArgs)]
                + [(f, ctypes.c_void_p) for f in
                   ("poses", "noise", "points", "pmask", "origin", "table",
                    "moved", "out")]
                + [(f, ctypes.c_float) for f in
                   ("rot1", "trans", "rot2", "s_rot1", "s_trans", "s_rot2")]
                + [("num_points", ctypes.c_int)])


# The launch block's address and the stream.
_PARTICLE_ARGS = [ctypes.c_void_p, ctypes.c_void_p]


def record_scores(origin, cell_size: float, width: int, height: int,
                  records, w, wmask, row0: int = 0):
    """Clamped Gaussian scores of world points ``w`` [..., 2] (mask
    ``wmask``) on one grid's rows [row0, row0 + height), each point's cell
    read from its record ``records`` [height * width, >= 8] (mean x, mean
    y, i00, i01, i11, scorable): ``ndt_grid.score_points``'s expression on
    the same values."""
    flat, valid = ndt_grid.stripe_cells(origin, cell_size, width, row0,
                                        height, w)
    valid = valid & wmask
    safe = torch.where(valid, flat, torch.zeros_like(flat)).to(torch.int64)
    rec = records[safe]
    q = w - rec[..., 0:2]
    qx, qy = q[..., 0], q[..., 1]
    e = -0.5 * (rec[..., 2] * qx * qx + 2.0 * rec[..., 3] * qx * qy
                + rec[..., 4] * qy * qy)
    s = torch.exp(torch.clamp(e, max=0.0))
    return torch.where(valid & (rec[..., 5] != 0), s, torch.zeros_like(s))


def records_twin(grid: ndt_grid.NDTGrid, table, width: int, height: int,
                 max_beams: int, points, point_mask, num_points: int, poses,
                 row0: int = 0, raw: bool = False):
    """Plain-PyTorch ``score_records``: ``score_batch_twin`` with each cell
    read from its record in ``table`` [(G,) C, 8 or 32] (K1's patch table
    or ``ndt_grid.packed_cell_table``), the same bits.  With ``row0`` the
    table holds the grid rows [row0, row0 + height) (KB1's stripe table)
    and only beams binned there count; ``raw`` leaves out the division
    (``stripe_poses_twin``'s bits)."""
    spts, smask, used = subsample(points, point_mask, num_points, max_beams)
    c, s = torch.cos(poses[:, 2:3]), torch.sin(poses[:, 2:3])
    px, py = spts[:, 0], spts[:, 1]
    w = torch.stack([c * px - s * py + poses[:, 0:1],
                     s * px + c * py + poses[:, 1:2]], dim=-1)
    wmask = smask.expand(poses.shape[0], -1)
    if table.dim() == 2:
        sc = record_scores(grid.origin, grid.cell_size, width, height, table,
                           w, wmask, row0)
    else:
        sc = sum(record_scores(grid.origin[k], grid.cell_size, width, height,
                               table[k], w, wmask, row0)
                 for k in range(table.shape[0])) / ndt_grid.f32(
                     table.shape[0], points.device)
    total = -lane_tree_sum(_pad32(sc))
    return total if raw else total / ndt_grid.f32(max(used, 1),
                                                  points.device)


def motion_score_twin(grid: ndt_grid.NDTGrid, table, width: int,
                      height: int, max_beams: int, points, point_mask,
                      num_points: int, particles, noise, scalars):
    """Plain-PyTorch ``motion_score``: K9's ``motion_twin``, then
    ``records_twin`` at the moved particles.  Returns (moved [M, 3],
    scores [M])."""
    moved = k9.motion_twin(particles, noise, scalars)
    return moved, records_twin(grid, table, width, height, max_beams, points,
                               point_mask, num_points, moved)


class ParticlePlan:
    """One shape of the particle launch (``particle_plan``): its
    ``_ParticleLaunch`` block, whose address crosses into C, the C function
    bound once, the (name, dtype, shape) of every tensor and the stream
    reader.  ``height`` is the rows the table holds, from ``row0`` (a
    stripe's; the whole grid: 0); ``raw`` writes -sum undivided.  The
    map's origin and table are checked, and their pointers written, when
    they change (by identity); ``run`` checks the step's
    tensors in one pass, allocates the outputs (the caller keeps them: the
    resample reads them, a replay or a comparison may hold them), writes
    the step's pointers and scalars into the block and makes one ctypes
    call with its address and the stream."""

    def __init__(self, P, max_beams, table_shape, width, height, cell, M,
                 motion, dev, row0: int = 0, raw: bool = False):
        lead = tuple(table_shape[:-2])
        if (len(lead) > 1 or table_shape[-1] not in (8, 32)
                or table_shape[-2] != width * height):
            raise ValueError(f"table {tuple(table_shape)}: expected [(G,) "
                             f"{width * height}, 8 or 32]")
        f32 = torch.float32
        self.M, self.motion, self.device = M, bool(motion), dev
        self.launch = _ParticleLaunch(_ParticleArgs(
            P, max_beams, lead[0] if lead else 1, width, row0, height,
            table_shape[-1], M, int(motion), int(raw), cell))
        self.args = self.launch.a
        self.address = ctypes.addressof(self.launch)
        self.map_expect = (("origin", f32, (*lead, 2)),
                           ("table", f32, tuple(table_shape)))
        self.expect = (("points", f32, (P, 2)),
                       ("point_mask", torch.bool, (P,)),
                       ("poses", f32, (M, 3)))
        if motion:
            self.expect += (("noise", f32, (M, 3)),)
        self._map = None  # the (origin, table) last checked
        self._fn = None
        self._stream = None

    def _check_map(self, origin, table) -> None:
        _build.require_all(self.device, (origin, table), self.map_expect)
        if table.data_ptr() % 16:
            raise ValueError("table: rows must start 16-byte aligned")
        self._map = (origin, table)
        self.launch.origin, self.launch.table = origin.data_ptr(), \
            table.data_ptr()

    def run(self, points, point_mask, num_points: int, origin, table, poses,
            noise=None, scalars=None):
        """(moved [M, 3] or None, scores [M]) of one launch; ``noise`` and
        the six ``scalars`` with the motion on."""
        m = self._map
        if m is None or m[0] is not origin or m[1] is not table:
            self._check_map(origin, table)
        _build.require_all(self.device, (points, point_mask, poses, noise),
                           self.expect)
        if self._fn is None:
            self._fn = _build.function("ndt2d_particle_scores",
                                       _PARTICLE_ARGS)
            self._stream = _build.stream_reader(self.device)
        L = self.launch
        out = poses.new_empty(self.M)
        L.out, L.poses = out.data_ptr(), poses.data_ptr()
        L.points, L.pmask = points.data_ptr(), point_mask.data_ptr()
        L.num_points = num_points
        moved = None
        if self.motion:
            moved = poses.new_empty(self.M, 3)
            L.moved, L.noise = moved.data_ptr(), noise.data_ptr()
            (L.rot1, L.trans, L.rot2, L.s_rot1, L.s_trans,
             L.s_rot2) = scalars
        _build.check(self._fn(self.address, self._stream()),
                     "particle_scores")
        return moved, out


_PARTICLE_PLANS: dict = {}


def particle_plan(grid, table, width: int, height: int, max_beams: int,
                  points, M: int, motion: bool, row0: int = 0,
                  raw: bool = False) -> ParticlePlan:
    """The particle plan of this shape, made at its first launch (a
    stripe's: the ``height`` rows from ``row0`` its table holds)."""
    dev = points.device
    key = (points.shape[0], max_beams, table.shape, width, height,
           grid.cell_size, M, motion, dev, row0, raw)
    plan = _PARTICLE_PLANS.get(key)
    if plan is None:
        plan = _PARTICLE_PLANS[key] = ParticlePlan(*key)
    return plan


def motion_score(grid: ndt_grid.NDTGrid, table, width: int, height: int,
                 max_beams: int, points, point_mask, num_points: int,
                 particles, noise, scalars):
    """K9's motion sample of particles [M, 3] f32 (standard normals noise
    [M, 3] f32, the host's six ``motion_model.motion_scalars``) and K3 at
    the moved particles, in one launch reading each cell's record from
    ``table`` (K1's patch table [(G,) C, 32] or a [(G,) C, 8] cell table
    of ``grid``).  Returns (moved [M, 3], scores [M]), the same bits as
    ``k9.motion`` then ``score_batch``.  CPU tensors run the twin; CUDA
    tensors launch the kernel."""
    global particle_launches
    if points.device.type == "cpu":
        return motion_score_twin(grid, table, width, height, max_beams,
                                 points, point_mask, num_points, particles,
                                 noise, scalars)
    plan = particle_plan(grid, table, width, height, max_beams, points,
                         particles.shape[0], True)
    out = plan.run(points, point_mask, int(num_points), grid.origin, table,
                   particles, noise, scalars)
    particle_launches += 1
    return out


def score_records(grid: ndt_grid.NDTGrid, table, width: int, height: int,
                  max_beams: int, points, point_mask, num_points: int, poses):
    """K3 over poses [M, 3] f32 through the particle launch with the motion
    off, each cell read from its record in ``table`` (as ``motion_score``);
    returns [M] float32, the same bits as ``score_batch``.  CPU tensors run
    the twin; CUDA tensors launch the kernel."""
    global record_launches
    if points.device.type == "cpu":
        return records_twin(grid, table, width, height, max_beams, points,
                            point_mask, num_points, poses)
    plan = particle_plan(grid, table, width, height, max_beams, points,
                         poses.shape[0], False)
    _, out = plan.run(points, point_mask, int(num_points), grid.origin,
                      table, poses)
    record_launches += 1
    return out


# --- KB2: scores against one y-stripe of a sharded map -------------------
def _pad32(x):
    """[M, n] padded with zeros to a multiple of 32 columns."""
    return torch.nn.functional.pad(x, (0, -(-x.shape[1] // 32) * 32
                                       - x.shape[1]))


def _stripe_at(stripe: ndt_grid.NDTGrid, width: int, row0: int, rows: int,
               w, wmask):
    """Clamped Gaussian scores of world points ``w`` [..., 2] against the
    stripe's cells (0 outside the stripe's global rows)."""
    flat, valid = ndt_grid.stripe_cells(stripe.origin, stripe.cell_size,
                                        width, row0, rows, w)
    return ndt_grid.score_at_cells(stripe.mean, stripe.information,
                                   stripe.count, w, valid & wmask, flat)


def stripe_points_twin(stripe: ndt_grid.NDTGrid, width: int, row0: int,
                       rows: int, points, mask):
    """Plain-PyTorch KB2, world points: the [1] sum of the scores of every
    masked point in the stripe, in the kernel's lane order."""
    sc = _stripe_at(stripe, width, row0, rows, points, mask)
    return lane_tree_sum(_pad32(sc[None]))


def stripe_poses_twin(stripe: ndt_grid.NDTGrid, width: int, row0: int,
                      rows: int, max_beams: int, points, point_mask,
                      num_points: int, poses):
    """Plain-PyTorch KB2, poses: [M] raw -sum over each pose's subsampled
    beams that fall in the stripe, in the kernel's lane order."""
    spts, smask, _ = subsample(points, point_mask, num_points, max_beams)
    c, s = torch.cos(poses[:, 2:3]), torch.sin(poses[:, 2:3])
    px, py = spts[:, 0], spts[:, 1]
    w = torch.stack([c * px - s * py + poses[:, 0:1],
                     s * px + c * py + poses[:, 1:2]], dim=-1)
    sc = _stripe_at(stripe, width, row0, rows, w,
                    smask.expand(poses.shape[0], -1))
    return -lane_tree_sum(_pad32(sc))


# The identity pose a device's world-point stripe scores are taken at.
_IDENTITY: dict = {}


def stripe_points(stripe: ndt_grid.NDTGrid, table, width: int, row0: int,
                  rows: int, points, mask):
    """KB2 over world points [N, 2] f32 (mask [N] bool): [1], the sum of
    the clamped Gaussian scores of the masked points whose global bin lies
    in the stripe's rows [row0, row0 + rows), each cell read from its
    record in KB1's stripe ``table`` [rows * width, 32].  ``stripe`` is
    KB1's (the map's origin, rows * width cells).  One pose, so one block
    of the particle launch at the identity.  CPU tensors run the twin;
    CUDA tensors launch the kernel."""
    global stripe_launches
    if points.device.type == "cpu":
        return stripe_points_twin(stripe, width, row0, rows, points, mask)
    dev = points.device
    identity = _IDENTITY.get(dev)
    if identity is None:
        identity = _IDENTITY[dev] = torch.zeros(1, 3, dtype=torch.float32,
                                                device=dev)
    P = points.shape[0]
    plan = particle_plan(stripe, table, width, rows, P, points, 1, False,
                         row0, True)
    _, out = plan.run(points, mask, P, stripe.origin, table, identity)
    stripe_launches += 1
    return -out


def stripe_poses(stripe: ndt_grid.NDTGrid, table, width: int, row0: int,
                 rows: int, max_beams: int, points, point_mask,
                 num_points: int, poses):
    """KB2 over poses [M, 3] f32 (points [P, 2] f32 robot frame,
    point_mask [P] bool): [M], each pose's -sum of scores over its
    subsampled beams in the stripe, not yet divided by the beams used:
    the particle launch with the motion off through the stripe's plan,
    each cell read from its record in KB1's stripe ``table``
    [rows * width, 32] (``records_twin`` at ``row0``, raw).  CPU tensors
    run the twin; CUDA tensors launch the kernel."""
    global stripe_launches
    if points.device.type == "cpu":
        return records_twin(stripe, table, width, rows, max_beams, points,
                            point_mask, num_points, poses, row0, True)
    plan = particle_plan(stripe, table, width, rows, max_beams, points,
                         poses.shape[0], False, row0, True)
    _, out = plan.run(points, point_mask, int(num_points), stripe.origin,
                      table, poses)
    stripe_launches += 1
    return out


def stripe_poses_soa(stripe: ndt_grid.NDTGrid, width: int, row0: int,
                     rows: int, max_beams: int, points, point_mask,
                     num_points: int, poses):
    """``stripe_poses`` through the SoA launch (the parent design: the
    stripe's mean, information and count arrays, a warp a pose); no
    package path calls it.  CPU tensors run its twin,
    ``stripe_poses_twin``; CUDA tensors launch the kernel."""
    if points.device.type == "cpu":
        return stripe_poses_twin(stripe, width, row0, rows, max_beams,
                                 points, point_mask, num_points, poses)
    return _batch(stripe, width, row0, rows, max_beams, points, point_mask,
                  num_points, poses, True)
