"""K4: LM normal-equation blocks, the PCG matvec and the whole PCG solve,
the dense LM system and the LM step (CUDA ``csrc/normal_blocks.cu``) and
their plain-PyTorch twins.

Replaces ``ndt_2d_tpu/graph/solver.py::robust_weights`` +
``_normal_blocks`` + ``_gather_gradient_and_diag`` (``normal_blocks``), the
matvec of ``_pcg_solve`` (``pcg_matvec``) and ``_pcg_solve``'s
``lax.while_loop`` as one cooperative launch an LM step (``pcg_solve``),
with its dot products alone as ``fixed_dots`` (an ordinary launch whose
last block folds); a mesh's loop (``mesh_cg``) as a plan an LM step
(``CgPlan``: a CG step the matvec, forming the direction, and two
``fixed_dots`` variants, the damping and the updates folded in);
``_dense_solve``'s assembly of the damped [3N, 3N] system
(``dense_system``: a block a node row writes its three rows once, from a
per-row table of node-pair slots, ``pair_table``; a mesh's), the blocks,
node sums and assembly of one device's dense LM iteration in one launch
(``dense_normal_system``: a block a node row, bitwise ``normal_blocks``
then ``dense_system``), the blocks, node sums, block-Jacobi
preconditioner and right-hand side of one device's PCG iteration in one
launch (``pcg_normal_system``, planned once a solve by ``PcgPlan``; the
preconditioner alone after a mesh's combine: ``preconditioner``; the
inverse three LU solves a node, ``matching.newton.solve3``'s); and
``_robust_cost``
with ``lm_step``'s accept and update (``lm_step``: the step's cost summed
in index order, ``ordered_sum_twin``, then the accept, the damping, the
stall count and the poses, in place, on the device; one block where the
costs fit 48 KB of shared memory, every dense solve, else a cooperative
grid, ``lm_blocks``).  One device's dense solve packs both launches once
(``DensePlan``).  The
per-node sums walk incidence lists (``Incidence``) in constraint order, and
a dot adds in a fixed lane-and-tree order (``fixed_dot_twin``), so kernel
and twin add the same float32 values in the same order and agree bitwise;
neither uses float atomics.  The twins write every 3-term dot product as
``(x0 y0 + x1 y1) + x2 y2``, the order the kernel sums in, and divide only
by tensors on the same device (PyTorch's CUDA division by a host scalar
multiplies by its reciprocal, which can round differently).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ndt_2d_tpu_torch.core.pose import normalize_angle_exact
from ndt_2d_tpu_torch.kernels import _build
from ndt_2d_tpu_torch.matching.newton import solve3

# The CG loop's launches by form: ``pcg_matvec`` (v as given) and
# ``pcg_matvec_direction`` (the direction formed in the loader),
# ``fixed_dot`` (the public dots), ``fixed_dot_damp`` and
# ``fixed_dot_update`` (the planned loop's variants (A) and (B)).
launches = {"normal_blocks": 0, "pcg_normal_system": 0, "preconditioner": 0,
            "pcg_matvec": 0, "pcg_matvec_direction": 0,
            "pcg_solve": 0, "fixed_dot": 0, "fixed_dot_damp": 0,
            "fixed_dot_update": 0, "dense_system": 0,
            "dense_normal_system": 0, "lm_step": 0}

# Lanes of a dot product: kLanes of csrc/normal_blocks.cu.
DOT_LANES = 2048

LOSSES = {"none": 0, "huber": 1, "geman_mcclure": 2}

_NB_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_float,
                                     ctypes.c_int] + [ctypes.c_void_p] * 4
            + [ctypes.c_int] + [ctypes.c_void_p] * 8)
_MV_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 9
_DOT_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
_PCG_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 10
             + [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 4)
_DENSE_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
               + [ctypes.c_void_p] * 3)
_DN_ARGS = (_NB_ARGS[:10] + [ctypes.c_void_p] * 9 + [ctypes.c_int]
            + [ctypes.c_void_p] * 3)
_LM_ARGS = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
            + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 7 + [ctypes.c_float] * 3
            + [ctypes.c_void_p])
_LM_FIT_ARGS = [ctypes.POINTER(ctypes.c_int)]
_SIZES_ARGS = [ctypes.POINTER(ctypes.c_int)] * 2
_PLANNED_ARGS = [ctypes.c_void_p] * 2
_DAMP_ARGS = [ctypes.c_void_p] * 3
_CG_SIZES_ARGS = [ctypes.POINTER(ctypes.c_int)] * 3
_PS_ARGS = (_NB_ARGS[:15] + [ctypes.c_void_p] * 9)
_PREC_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 3
_PS_SIZE_ARGS = [ctypes.POINTER(ctypes.c_int)]

# Threads of a block (kThreads of csrc/normal_blocks.cu) and the most nodes
# a dense system takes (kDenseMaxN: a block's slot table of an int a node
# in 48 KB of shared memory).
THREADS = 256
DENSE_MAX_N = 12288
# Constraints a dense-normal-system block stages at a time (kDnThreads of
# csrc/normal_blocks.cu).
DENSE_STAGE = 128
# Threads of the one-block LM step (kLmBlock of csrc/normal_blocks.cu).
LM_BLOCK = 1024

# lm_step's modes: the cost alone, the cost and the update, the update from
# a given cost (a mesh's combined one).
_COST, _STEP, _UPDATE = 0, 1, 2


@dataclasses.dataclass
class Incidence:
    """Per-node lists of the live constraints that begin (end) at each
    node, in constraint order, for N nodes.

    ``*_ptr`` [N + 1] / ``*_idx`` int32 are the kernels' (CSR) form, and
    ``*_pair`` [K, 2] int32 each list entry's constraint and other node
    (the end node of a begin list's constraint, the begin node of an end
    list's), which the CG matvec walks.  ``*_mat`` [N, D] int64 with
    ``*_ok`` [N, D] bool are the twin's (slot d of node n holds its d-th
    constraint): built at a twin's first read of them, with a read of the
    longest list a side, which a solve on the kernels never makes.  Built
    once per solve: begin, end and the mask do not change inside one."""

    n: int
    b_ptr: torch.Tensor
    b_idx: torch.Tensor
    b_pair: torch.Tensor
    b_at: torch.Tensor  # the entries' node ids, int64 (the twin's tables)
    e_ptr: torch.Tensor
    e_idx: torch.Tensor
    e_pair: torch.Tensor
    e_at: torch.Tensor
    _tables: dict = dataclasses.field(default_factory=dict, repr=False)

    def _table(self, side: str):
        if side not in self._tables:
            self._tables[side] = _slots(getattr(self, f"{side}_ptr"),
                                        getattr(self, f"{side}_idx"),
                                        getattr(self, f"{side}_at"), self.n)
        return self._tables[side]

    @property
    def b_mat(self):
        return self._table("b")[0]

    @property
    def b_ok(self):
        return self._table("b")[1]

    @property
    def e_mat(self):
        return self._table("e")[0]

    @property
    def e_ok(self):
        return self._table("e")[1]


def _lists(node, other, live, n: int):
    """(ptr, idx, pair, at) of one side: ``node`` [C] int64 the side's
    node ids, ``other`` [C] int64 the other end's, ``live`` [K] ascending
    ids of the live constraints; ``at`` [K] int64 the sorted node ids."""
    dev = node.device
    at = node[live]
    order = torch.sort(at, stable=True).indices
    idx = live[order]
    at = at[order]
    counts = torch.bincount(at, minlength=n)
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    ptr[1:] = torch.cumsum(counts, 0)
    pair = torch.stack([idx, other[idx]], 1).to(torch.int32)
    return ptr.to(torch.int32), idx.to(torch.int32), pair, at


def _slots(ptr, idx, at, n: int):
    """The twin's table of one side's lists: (mat [n, D] int64, ok [n, D]
    bool), D the longest list (one read)."""
    ptr = ptr.long()
    rank = torch.arange(idx.numel(), device=idx.device) - ptr[at]
    width = int((ptr[1:] - ptr[:-1]).max()) if idx.numel() else 0
    mat = torch.zeros(n, width, dtype=torch.int64, device=idx.device)
    ok = torch.zeros(n, width, dtype=torch.bool, device=idx.device)
    mat[at, rank] = idx.long()
    ok[at, rank] = True
    return mat, ok


def incidence(begin, end, cmask, n: int) -> Incidence:
    """Incidence lists of constraints (begin, end) [C] in [0, n), keeping
    only those in ``cmask`` [C]: a masked constraint's blocks are exact
    zeros, and an in-order sum from +0 is unchanged by adding one."""
    live = torch.nonzero(cmask).squeeze(1)
    b, e = begin.to(torch.int64), end.to(torch.int64)
    return Incidence(n, *_lists(b, e, live, n), *_lists(e, b, live, n))


def _ordered_sum(vals, mat, ok):
    """Per-node sum of ``vals`` [C, F] over the node's list slots in order,
    from 0 (``vals[mat[:, d]]`` is added only where ``ok[:, d]``; adding
    +0 to a sum that starts at +0 never changes its bits)."""
    out = torch.zeros(mat.shape[0], vals.shape[1], dtype=vals.dtype,
                      device=vals.device)
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    for d in range(mat.shape[1]):
        out = out + torch.where(ok[:, d, None], vals[mat[:, d]], zero)
    return out


def _dot3(x, y):
    """sum_j x[..., j] y[..., j] as (x0 y0 + x1 y1) + x2 y2."""
    return ((x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1])
            + x[..., 2] * y[..., 2])


def _mm(a, b):
    """[..., 3, 3] product a b, each entry a _dot3."""
    return _dot3(a[..., :, None, :], b.transpose(-1, -2)[..., None, :, :])


def _mtm(a, b):
    """[..., 3, 3] product a^T b."""
    return _mm(a.transpose(-1, -2), b)


def _mv(a, v):
    """[..., 3] product a v."""
    return _dot3(a, v[..., None, :])


def _residuals(poses, begin, end, transform):
    """(r [C, 3], dx, dy, c, s [C]) in the kernel's evaluation order."""
    pa, pb = poses[begin.long()], poses[end.long()]
    dx, dy = pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1]
    c, s = torch.cos(pa[:, 2]), torch.sin(pa[:, 2])
    r = torch.stack([(c * dx + s * dy) - transform[:, 0],
                     (-s * dx + c * dy) - transform[:, 1],
                     normalize_angle_exact((pb[:, 2] - pa[:, 2])
                                      - transform[:, 2])], -1)
    return r, dx, dy, c, s


def residuals_and_jacobians(poses, begin, end, transform):
    """(r [C, 3], Ja, Jb [C, 3, 3]) in the kernel's evaluation order."""
    r, dx, dy, c, s = _residuals(poses, begin, end, transform)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    ja = torch.stack([torch.stack([-c, -s, -s * dx + c * dy], -1),
                      torch.stack([s, -c, -c * dx - s * dy], -1),
                      torch.stack([zero, zero, -one], -1)], -2)
    jb = torch.stack([torch.stack([c, s, zero], -1),
                      torch.stack([-s, c, zero], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    return r, ja, jb


def robust_weight(loss: str, delta: float, r, information, robust_mask):
    """[C] IRLS weights (solver.py::robust_weights) from residuals r."""
    one = torch.ones((), dtype=r.dtype, device=r.device)
    if loss == "none":
        return one.expand(r.shape[0])
    s2 = _dot3(r, _mv(information, r))
    d = torch.tensor(delta, dtype=r.dtype, device=r.device)
    if loss == "huber":
        s = torch.sqrt(torch.clamp(s2, min=1e-20))
        w = torch.where(s > d, d / s, one)
    elif loss == "geman_mcclure":
        t = one + s2 / (d * d)
        w = one / (t * t)
    else:
        raise ValueError(f"unknown robust_loss {loss!r}")
    return torch.where(robust_mask, w, one)


def constraint_blocks_twin(poses, begin, end, transform, information,
                           cmask, robust_mask, loss: str, delta: float):
    """Per-constraint half of the K4 twin: (Baa, Bab, Bbb [C, 3, 3], ga,
    gb [C, 3]) on the robustly weighted, masked information."""
    r, ja, jb = residuals_and_jacobians(poses, begin, end, transform)
    w = robust_weight(loss, delta, r, information, robust_mask)
    zero = torch.zeros((), dtype=poses.dtype, device=poses.device)
    lw = torch.where(cmask[:, None, None], information * w[:, None, None],
                     zero)
    lja, ljb = _mm(lw, ja), _mm(lw, jb)
    lr = _mv(lw, r)
    return (_mtm(ja, lja), _mtm(ja, ljb), _mtm(jb, ljb),
            _mv(ja.transpose(-1, -2), lr), _mv(jb.transpose(-1, -2), lr))


def node_sums_twin(baa, bbb, ga, gb, inc: Incidence):
    """Per-node half of the K4 twin: g [N, 3] and D [N, 3, 3], each the
    begin-list sum plus the end-list sum."""
    g = (_ordered_sum(ga, inc.b_mat, inc.b_ok)
         + _ordered_sum(gb, inc.e_mat, inc.e_ok))
    d = (_ordered_sum(baa.reshape(-1, 9), inc.b_mat, inc.b_ok)
         + _ordered_sum(bbb.reshape(-1, 9), inc.e_mat, inc.e_ok))
    return g, d.reshape(-1, 3, 3)


def normal_blocks_twin(poses, begin, end, transform, information, cmask,
                       robust_mask, loss: str, delta: float,
                       inc: Incidence):
    """Plain-PyTorch K4 blocks: (Baa, Bab, Bbb [C, 3, 3], ga, gb [C, 3],
    g [N, 3], D [N, 3, 3])."""
    baa, bab, bbb, ga, gb = constraint_blocks_twin(
        poses, begin, end, transform, information, cmask, robust_mask, loss,
        delta)
    return (baa, bab, bbb, ga, gb, *node_sums_twin(baa, bbb, ga, gb, inc))


def normal_blocks(poses, begin, end, transform, information, cmask,
                  robust_mask, loss: str, delta: float, inc: Incidence):
    """K4 blocks.  poses [N, 3] f32, begin/end [C] int32 in [0, N),
    transform [C, 3], information [C, 3, 3] f32, cmask / robust_mask [C]
    bool, loss in LOSSES, inc from ``incidence``.  Returns (Baa, Bab, Bbb
    [C, 3, 3], ga, gb [C, 3], g [N, 3], D [N, 3, 3]).  CPU tensors run the
    twin; CUDA tensors launch the kernel."""
    if poses.device.type == "cpu":
        return normal_blocks_twin(poses, begin, end, transform, information,
                                  cmask, robust_mask, loss, delta, inc)
    dev = poses.device
    N, C = poses.shape[0], begin.shape[0]
    _build.require(poses, "poses", torch.float32, (N, 3), dev)
    _build.require(begin, "begin", torch.int32, (C,), dev)
    _build.require(end, "end", torch.int32, (C,), dev)
    _build.require(transform, "transform", torch.float32, (C, 3), dev)
    _build.require(information, "information", torch.float32, (C, 3, 3), dev)
    _build.require(cmask, "cmask", torch.bool, (C,), dev)
    _build.require(robust_mask, "robust_mask", torch.bool, (C,), dev)
    blocks = torch.empty(3, C, 3, 3, dtype=torch.float32, device=dev)
    grads = torch.empty(2, C, 3, dtype=torch.float32, device=dev)
    g = torch.empty(N, 3, dtype=torch.float32, device=dev)
    d = torch.empty(N, 3, 3, dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _build.function("ndt2d_normal_blocks", _NB_ARGS)(
        p(poses), p(begin), p(end), p(transform), p(information), p(cmask),
        p(robust_mask), LOSSES[loss], float(delta), C, p(inc.b_ptr),
        p(inc.b_idx), p(inc.e_ptr), p(inc.e_idx), N, p(blocks[0]),
        p(blocks[1]), p(blocks[2]), p(grads[0]), p(grads[1]), p(g), p(d),
        _build.stream_ptr(dev))
    _build.check(err, "normal_blocks")
    launches["normal_blocks"] += 1
    return blocks[0], blocks[1], blocks[2], grads[0], grads[1], g, d


# --- The PCG normal system ---------------------------------------------------


def preconditioner_twin(g, diag, lam, fm):
    """Plain-PyTorch block-Jacobi preconditioner of ``_pcg_solve``
    (solver.py:197-199): pinv [N, 3, 3], the inverse of dd = D + lam (D o
    I) + 1e-8 I (plus I at a fixed node, fm = 0) in JAX's expression
    order, by ``matching.newton.solve3`` of each unit vector (the kernel's
    LU, no library inverse: a singular or NaN block gives inf / NaN and
    raises nothing), and b = -g fm [N, 3].  fm [N] is the free-node mask
    as float."""
    eye = torch.eye(3, dtype=diag.dtype, device=diag.device)
    dd = diag + lam * (diag * eye) + 1e-8 * eye
    dd = dd + (1.0 - fm)[:, None, None] * eye
    a = [[dd[:, i, j] for j in range(3)] for i in range(3)]
    one, zero = torch.ones_like(fm), torch.zeros_like(fm)
    cols = [solve3(a, [one if i == j else zero for i in range(3)])
            for j in range(3)]
    pinv = torch.stack([torch.stack([cols[j][i] for j in range(3)], -1)
                        for i in range(3)], -2)
    return pinv, -g * fm[:, None]


def preconditioner(g, diag, lam, fm):
    """The preconditioner alone (a mesh's, after its combine summed g and
    D): g [N, 3], diag [N, 3, 3], lam 0-d, fm [N] f32.  Returns (pinv
    [N, 3, 3], b [N, 3]) as ``preconditioner_twin``.  CPU tensors run the
    twin; CUDA tensors launch the kernel (a thread a node, the fused
    launch's ``damped_inverse``)."""
    if g.device.type == "cpu":
        return preconditioner_twin(g, diag, lam, fm)
    dev = g.device
    N = g.shape[0]
    _build.require_all(dev, (g, diag, lam, fm), (
        ("g", torch.float32, (N, 3)), ("diag", torch.float32, (N, 3, 3)),
        ("lam", torch.float32, ()), ("fm", torch.float32, (N,))))
    pinv = torch.empty(N, 3, 3, dtype=torch.float32, device=dev)
    b = torch.empty(N, 3, dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _build.function("ndt2d_preconditioner", _PREC_ARGS)(
        p(g), p(diag), p(lam), p(fm), N, p(pinv), p(b),
        _build.stream_ptr(dev))
    _build.check(err, "preconditioner")
    launches["preconditioner"] += 1
    return pinv, b


def pcg_normal_system_twin(poses, begin, end, transform, information, cmask,
                           robust_mask, loss: str, delta: float,
                           inc: Incidence, lam, fm):
    """Plain-PyTorch PCG normal system: ``normal_blocks_twin``'s blocks and
    sums, then ``preconditioner_twin``.  Returns (Baa, Bab, Bbb [C, 3, 3],
    D [N, 3, 3], pinv [N, 3, 3], b [N, 3])."""
    baa, bab, bbb, _, _, g, diag = normal_blocks_twin(
        poses, begin, end, transform, information, cmask, robust_mask, loss,
        delta, inc)
    return (baa, bab, bbb, diag, *preconditioner_twin(g, diag, lam, fm))


def _pcg_system_checks(dev, N: int, C: int, tensors, inc: Incidence):
    _build.require_all(dev, tensors, (
        ("poses", torch.float32, (N, 3)), ("begin", torch.int32, (C,)),
        ("end", torch.int32, (C,)), ("transform", torch.float32, (C, 3)),
        ("information", torch.float32, (C, 3, 3)),
        ("cmask", torch.bool, (C,)), ("robust_mask", torch.bool, (C,)),
        ("b_ptr", torch.int32, (N + 1,)),
        ("b_idx", torch.int32, tuple(inc.b_idx.shape)),
        ("e_ptr", torch.int32, (N + 1,)),
        ("e_idx", torch.int32, tuple(inc.e_idx.shape)),
        ("lam", torch.float32, ()), ("fm", torch.float32, (N,))))
    if inc.n != N:
        raise ValueError(f"incidence over {inc.n} nodes, expected {N}")


def _pcg_system_out(N: int, C: int, dev) -> tuple:
    """(Baa, Bab, Bbb, D, pinv, b), allocated."""
    blocks = torch.empty(3, C, 3, 3, dtype=torch.float32, device=dev)
    node = torch.empty(2, N, 3, 3, dtype=torch.float32, device=dev)
    b = torch.empty(N, 3, dtype=torch.float32, device=dev)
    return blocks[0], blocks[1], blocks[2], node[0], node[1], b


def pcg_normal_system(poses, begin, end, transform, information, cmask,
                      robust_mask, loss: str, delta: float, inc: Incidence,
                      lam, fm):
    """What one device's PCG iteration hands ``pcg_solve``, in one launch:
    ``normal_blocks``' inputs, lam 0-d and fm [N] f32.  Returns (Baa, Bab,
    Bbb [C, 3, 3], D [N, 3, 3], pinv [N, 3, 3], b [N, 3]) as
    ``pcg_normal_system_twin``.  CPU tensors run the twin; CUDA tensors
    launch the kernel (``PcgPlan`` packs the same launch once a solve)."""
    if poses.device.type == "cpu":
        return pcg_normal_system_twin(poses, begin, end, transform,
                                      information, cmask, robust_mask, loss,
                                      delta, inc, lam, fm)
    dev = poses.device
    N, C = poses.shape[0], begin.shape[0]
    _pcg_system_checks(dev, N, C, (
        poses, begin, end, transform, information, cmask, robust_mask,
        inc.b_ptr, inc.b_idx, inc.e_ptr, inc.e_idx, lam, fm), inc)
    out = _pcg_system_out(N, C, dev)
    p = _build.ptr
    err = _build.function("ndt2d_pcg_normal_system", _PS_ARGS)(
        p(poses), p(begin), p(end), p(transform), p(information), p(cmask),
        p(robust_mask), LOSSES[loss], float(delta), C, p(inc.b_ptr),
        p(inc.b_idx), p(inc.e_ptr), p(inc.e_idx), N, p(lam), p(fm),
        *[p(t) for t in out], _build.stream_ptr(dev))
    _build.check(err, "pcg_normal_system")
    launches["pcg_normal_system"] += 1
    return out


def pcg_matvec_twin(begin, end, baa, bab, bbb, diag, lam, fm, v,
                    inc: Incidence):
    """Plain-PyTorch K4 matvec: the damped normal-equation product A v of
    _pcg_solve, [N, 3]."""
    v = v * fm[:, None]
    va, vb = v[begin.long()], v[end.long()]
    ya = _mv(baa, va) + _mv(bab, vb)
    yb = _mv(bab.transpose(-1, -2), va) + _mv(bbb, vb)
    out = (_ordered_sum(ya, inc.b_mat, inc.b_ok)
           + _ordered_sum(yb, inc.e_mat, inc.e_ok))
    dv = torch.diagonal(diag, dim1=-2, dim2=-1) * v
    return (out + lam * dv) * fm[:, None]


def pcg_matvec(begin, end, baa, bab, bbb, diag, lam, fm, v, inc: Incidence):
    """K4 matvec.  begin/end [C] int32, baa/bab/bbb [C, 3, 3], diag
    [N, 3, 3], lam 0-d, fm [N] (free-node mask as float), v [N, 3] f32;
    returns [N, 3].  CPU tensors run the twin; CUDA tensors launch the
    kernel (a thread a node over ``inc``'s pair lists; the mesh's loop
    launches it planned, ``CgPlan``)."""
    if v.device.type == "cpu":
        return pcg_matvec_twin(begin, end, baa, bab, bbb, diag, lam, fm, v,
                               inc)
    dev = v.device
    N, C = v.shape[0], begin.shape[0]
    _build.require_all(dev, (begin, end, baa, bab, bbb, diag, lam, fm, v,
                             inc.b_ptr, inc.e_ptr, inc.b_pair, inc.e_pair), (
        ("begin", torch.int32, (C,)), ("end", torch.int32, (C,)),
        ("baa", torch.float32, (C, 3, 3)), ("bab", torch.float32, (C, 3, 3)),
        ("bbb", torch.float32, (C, 3, 3)), ("diag", torch.float32, (N, 3, 3)),
        ("lam", torch.float32, ()), ("fm", torch.float32, (N,)),
        ("v", torch.float32, (N, 3)), ("b_ptr", torch.int32, (N + 1,)),
        ("e_ptr", torch.int32, (N + 1,)),
        ("b_pair", torch.int32, (inc.b_pair.shape[0], 2)),
        ("e_pair", torch.int32, (inc.e_pair.shape[0], 2))))
    out = torch.empty(N, 3, dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _build.function("ndt2d_pcg_matvec", _MV_ARGS)(
        p(inc.b_ptr), p(inc.e_ptr), p(inc.b_pair), p(inc.e_pair), N, p(baa),
        p(bab), p(bbb), p(diag), p(lam), p(fm), p(v), p(out),
        _build.stream_ptr(dev))
    _build.check(err, "pcg_matvec")
    launches["pcg_matvec"] += 1
    return out


def fixed_dot_twin(x, y):
    """0-d sum of x * y over every element, in the kernel's order: lane l
    of ``DOT_LANES`` adds the products l, l + DOT_LANES, ... of the
    flattened product in index order from +0 (a Python loop over its
    zero-padded rows; +0 leaves a lane's sum as it is, which is never -0),
    then a halving tree folds the lanes (lane i + h into lane i, h =
    DOT_LANES / 2, ..., 1)."""
    prod = (x * y).reshape(-1)
    rows = max(1, -(-prod.numel() // DOT_LANES))
    prod = torch.nn.functional.pad(prod, (0, rows * DOT_LANES - prod.numel()))
    prod = prod.reshape(rows, DOT_LANES)
    acc = torch.zeros(DOT_LANES, dtype=prod.dtype, device=prod.device)
    for k in range(rows):
        acc = acc + prod[k]
    h = DOT_LANES // 2
    while h:
        acc = acc[:h] + acc[h:2 * h]
        h //= 2
    return acc[0]


def fixed_dots_twin(*pairs):
    """``fixed_dot_twin`` of each pair (x, y), as a tuple."""
    return tuple(fixed_dot_twin(x, y) for x, y in pairs)


def fixed_dots(*pairs):
    """K4's dot products x . y of one or two pairs (x, y) of contiguous f32
    tensors, all of one shape, in ``fixed_dot_twin``'s order: a tuple of
    0-d tensors.  CPU tensors run the twin; CUDA tensors launch the kernel
    (one ordinary launch: a block a group of 32 lanes; the last block to
    finish folds the lanes of every pair).  The mesh's loop launches its
    two variants planned (``CgPlan``)."""
    D = len(pairs)
    if D not in (1, 2):
        raise ValueError(f"{D} dot products: the kernel takes 1 or 2")
    x0 = pairs[0][0]
    if x0.device.type == "cpu":
        return fixed_dots_twin(*pairs)
    dev = x0.device
    shape = x0.shape
    _build.require_all(dev, [t for pair in pairs for t in pair],
                       [(name, torch.float32, shape) for name in "xy" * D])
    out = torch.empty(D, dtype=torch.float32, device=dev)
    # The lane partials and the ticket, which the launch needs at 0.
    scratch = torch.zeros(2 * DOT_LANES + 1, dtype=torch.float32, device=dev)
    x1, y1 = pairs[-1]
    p = _build.ptr
    err = _build.function("ndt2d_fixed_dot", _DOT_ARGS)(
        p(x0), p(pairs[0][1]), p(x1), p(y1), D, x0.numel(), p(out),
        p(scratch), _build.stream_ptr(dev))
    _build.check(err, "fixed_dot")
    launches["fixed_dot"] += 1
    return out.unbind()


def pcg_loop(matvec, dots, pinv, fm, b, max_iter: int, tol):
    """Block-Jacobi PCG from x = 0 on the damped product ``matvec``, right
    hand side b [N, 3], preconditioner pinv [N, 3, 3] and free-node mask fm
    [N], with dot products ``dots`` (``fixed_dots``: p . Ap alone, r . z
    and r . r in one call); stops before a step where
    sqrt(r . r) <= tol or after max_iter steps, as the reference's
    ``lax.while_loop`` (one device->host read a step).  Returns (x [N, 3],
    steps taken)."""
    tiny = torch.tensor(1e-30, dtype=b.dtype, device=b.device)
    tol = torch.tensor(tol, dtype=b.dtype, device=b.device)

    def prec(r):
        return _mv(pinv, r) * fm[:, None]

    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = prec(r)
    p = z
    rz, rr = dots((r, z), (r, r))
    it = 0
    while it < max_iter and bool(torch.sqrt(rr) > tol):
        ap = matvec(p)
        alpha = rz / torch.maximum(dots((p, ap))[0], tiny)
        x = x + alpha * p
        r = r - alpha * ap
        z = prec(r)
        rz_new, rr = dots((r, z), (r, r))
        beta = rz_new / torch.maximum(rz, tiny)
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, it


def pcg_solve_twin(begin, end, baa, bab, bbb, diag, lam, fm, pinv, b,
                   max_iter: int, tol: float, inc: Incidence):
    """Plain-PyTorch K4 PCG solve: ``pcg_loop`` on ``pcg_matvec_twin`` and
    ``fixed_dots_twin``.  Returns (x [N, 3], steps as a 0-d int32)."""
    def matvec(v):
        return pcg_matvec_twin(begin, end, baa, bab, bbb, diag, lam, fm, v,
                               inc)
    x, it = pcg_loop(matvec, fixed_dots_twin, pinv, fm, b, max_iter, tol)
    return x, torch.tensor(it, dtype=torch.int32, device=b.device)


def pcg_solve(begin, end, baa, bab, bbb, diag, lam, fm, pinv, b,
              max_iter: int, tol: float, inc: Incidence):
    """K4's whole PCG loop of one LM step in one launch.  begin/end [C]
    int32, baa/bab/bbb [C, 3, 3], diag [N, 3, 3], lam 0-d, fm [N] (the
    free-node mask as float), pinv [N, 3, 3] (the block-Jacobi inverse),
    b [N, 3] (-g fm) f32.  Returns (x [N, 3], steps taken as a 0-d int32
    on the device).  CPU tensors run the twin; CUDA tensors launch the
    kernel, which raises where the card cannot launch it cooperatively."""
    if b.device.type == "cpu":
        return pcg_solve_twin(begin, end, baa, bab, bbb, diag, lam, fm, pinv,
                              b, max_iter, tol, inc)
    dev = b.device
    N, C = b.shape[0], begin.shape[0]
    _build.require(begin, "begin", torch.int32, (C,), dev)
    _build.require(end, "end", torch.int32, (C,), dev)
    for name, t in (("baa", baa), ("bab", bab), ("bbb", bbb)):
        _build.require(t, name, torch.float32, (C, 3, 3), dev)
    _build.require(diag, "diag", torch.float32, (N, 3, 3), dev)
    _build.require(lam, "lam", torch.float32, (), dev)
    _build.require(fm, "fm", torch.float32, (N,), dev)
    _build.require(pinv, "pinv", torch.float32, (N, 3, 3), dev)
    _build.require(b, "b", torch.float32, (N, 3), dev)
    x = torch.empty(N, 3, dtype=torch.float32, device=dev)
    work = torch.empty(15 * N + 3 * DOT_LANES, dtype=torch.float32,
                       device=dev)
    it = torch.empty((), dtype=torch.int32, device=dev)
    p = _build.ptr
    err = _build.function("ndt2d_pcg_solve", _PCG_ARGS)(
        p(inc.b_ptr), p(inc.b_idx), p(inc.e_ptr), p(inc.e_idx), N, p(begin),
        p(end), p(baa), p(bab), p(bbb), p(diag), p(lam), p(fm), p(pinv),
        p(b), int(max_iter), float(tol), p(x), p(work), p(it),
        _build.stream_ptr(dev))
    _build.check(err, "pcg_solve")
    launches["pcg_solve"] += 1
    return x, it


# --- The mesh's CG loop ------------------------------------------------------


def cg_damp_twin(part, p, diag, lam, fm, rz):
    """Plain-PyTorch variant (A) of the loop's dots: (Ap, p . Ap, alpha).
    Ap = (part + lam (D_ii (p fm))) fm from the combined undamped partial,
    as ``_pcg_solve``'s mesh branch damps it; alpha = rz / max(p . Ap,
    1e-30), as ``pcg_loop``."""
    dii = torch.diagonal(diag, dim1=-2, dim2=-1)
    ap = (part + lam * (dii * (p * fm[:, None]))) * fm[:, None]
    pap = fixed_dot_twin(p, ap)
    tiny = torch.tensor(1e-30, dtype=pap.dtype, device=pap.device)
    return ap, pap, rz / torch.maximum(pap, tiny)


def cg_update_twin(r, ap, alpha, x, p, pinv, fm, rz, tol: float,
                   first: bool):
    """Plain-PyTorch variant (B), ``pcg_loop``'s expressions: x + alpha p,
    r - alpha Ap, z = (pinv r) fm, r . z and r . r in one ``fixed_dots``,
    beta = r.z / max(rz, 1e-30) and the stop test sqrt(r . r) > tol.  The
    first of a solve takes r = b - Ap (``r`` is b) and leaves x, beta None.
    Returns (x, r, z, r.z, r.r, beta, go)."""
    tiny = torch.tensor(1e-30, dtype=ap.dtype, device=ap.device)
    beta = None
    if first:
        r = r - ap
    else:
        x = x + alpha * p
        r = r - alpha * ap
    z = _mv(pinv, r) * fm[:, None]
    rz_new, rr = fixed_dots_twin((r, z), (r, r))
    if not first:
        beta = rz_new / torch.maximum(rz, tiny)
    go = torch.sqrt(rr) > torch.tensor(tol, dtype=rr.dtype, device=rr.device)
    return x, r, z, rz_new, rr, beta, go


# The loop's scalars in ``CgPlan.sc`` (CgScalar of csrc/normal_blocks.cu).
_ALPHA, _BETA, _RZ, _RR, _PAP, _ZERO_LAM = range(6)


class _Lanes(ctypes.Structure):
    """``struct Lanes`` of csrc/normal_blocks.cu."""

    _fields_ = [("lanes", ctypes.c_void_p), ("ticket", ctypes.c_void_p),
                ("n", ctypes.c_int)]


class _CgMatvec(ctypes.Structure):
    """``struct CgMatvec``."""

    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "b_ptr", "e_ptr", "b_pair", "e_pair", "baa", "bab", "bbb", "diag",
        "lam", "fm", "v", "z", "beta", "p_out", "out")]
        + [("N", ctypes.c_int)])


class _CgDamp(ctypes.Structure):
    """``struct CgDamp``."""

    _fields_ = ([("dots", _Lanes)]
                + [(f, ctypes.c_void_p) for f in (
                    "part", "p", "diag", "fm", "lam", "ap", "sc")]
                + [("l", ctypes.c_float)])


class _CgUpdate(ctypes.Structure):
    """``struct CgUpdate``."""

    _fields_ = ([("dots", _Lanes)]
                + [(f, ctypes.c_void_p) for f in (
                    "r_in", "ap", "p", "pinv", "fm", "x", "r_out", "z",
                    "p_out", "sc", "stop")]
                + [("tol", ctypes.c_float), ("first", ctypes.c_int),
                   ("alpha", ctypes.c_float)])


@functools.lru_cache(maxsize=None)
def _cg_functions():
    """The three planned CG entries, after checking that the ctypes
    mirrors have their C structures' sizes."""
    sizes = [ctypes.c_int(0) for _ in range(3)]
    _build.function("ndt2d_cg_plan_sizes", _CG_SIZES_ARGS)(
        *(ctypes.byref(c) for c in sizes))
    mine = tuple(ctypes.sizeof(t) for t in (_CgMatvec, _CgDamp, _CgUpdate))
    theirs = tuple(c.value for c in sizes)
    if mine != theirs:
        raise RuntimeError(f"CG plan structures of {mine} bytes, the "
                           f"kernels' {theirs}")
    return (_build.function("ndt2d_cg_matvec_planned", _PLANNED_ARGS),
            _build.function("ndt2d_cg_damp_planned", _DAMP_ARGS),
            _build.function("ndt2d_cg_update_planned", _PLANNED_ARGS))


class CgPlan:
    """The CG loop of one LM step of a mesh rank, planned once:
    ``pcg_loop``'s loop as three hand launches a step, ``run``.  Phase s = 0
    starts the loop (the product at x = 0, r = b - Ap, z, p = z, r . z,
    r . r); phase s = 1, 2, ... is CG step s - 1:

    * ``pcg_matvec`` (planned): the rank's undamped partial of the
      direction's product; from step 1 on the launch forms the direction,
      p = z + beta p (into the other of two direction buffers);
    * ``combine``: the sum over the mesh's ranks;
    * ``fixed_dots`` variant (A): Ap (the combined sum damped), p . Ap and
      alpha on the device;
    * ``fixed_dots`` variant (B): x, r (two buffers), z, r . z, r . r,
      beta and the stop flag on the device;

    then one read of the stop flag, as the reference's ``lax.while_loop``
    tests sqrt(r . r) > tol before a step.  The arguments of every launch
    shape are packed once into the C structures the planned entries read,
    so a launch is one ctypes call with a pointer and the stream (read once
    a loop); the loop's buffers, scalars, lane partials and ticket are the
    plan's, allocated once; nothing is checked a launch but the combined
    partial.  The arguments as ``pcg_solve``'s; the plan keeps every tensor
    it points to.  On CUDA tensors its launches launch or raise; with
    ``twin`` or on CPU tensors they run the twins (``pcg_matvec_twin``,
    ``cg_damp_twin``, ``cg_update_twin``) into the same buffers,
    ``pcg_loop``'s bits."""

    def __init__(self, begin, end, baa, bab, bbb, diag, lam, fm, pinv, b,
                 inc: Incidence, tol: float, twin: bool = False):
        dev = b.device
        N, C = b.shape[0], begin.shape[0]
        _build.require_all(dev, (
            begin, end, baa, bab, bbb, diag, lam, fm, pinv, b, inc.b_ptr,
            inc.e_ptr, inc.b_pair, inc.e_pair), (
            ("begin", torch.int32, (C,)), ("end", torch.int32, (C,)),
            ("baa", torch.float32, (C, 3, 3)),
            ("bab", torch.float32, (C, 3, 3)),
            ("bbb", torch.float32, (C, 3, 3)),
            ("diag", torch.float32, (N, 3, 3)), ("lam", torch.float32, ()),
            ("fm", torch.float32, (N,)), ("pinv", torch.float32, (N, 3, 3)),
            ("b", torch.float32, (N, 3)), ("b_ptr", torch.int32, (N + 1,)),
            ("e_ptr", torch.int32, (N + 1,)),
            ("b_pair", torch.int32, (inc.b_pair.shape[0], 2)),
            ("e_pair", torch.int32, (inc.e_pair.shape[0], 2))))
        if inc.n != N:
            raise ValueError(f"incidence over {inc.n} nodes: expected {N}")
        self.device = dev
        self.eager = twin or dev.type == "cpu"
        self.shape = (N, 3)
        f32 = dict(dtype=torch.float32, device=dev)
        n3 = 3 * N
        # Zeroed once: x (the loop starts at 0), the scalars, the dots'
        # ticket and the stop flag.
        zero = torch.zeros(n3 + 16, **f32)
        self.x = zero[:n3].view(N, 3)
        self.sc = zero[n3:n3 + 8]
        ticket = zero[n3 + 8:n3 + 9].view(torch.int32)
        self.stop = zero[n3 + 9:n3 + 10].view(torch.int32)
        work = torch.empty(7 * n3 + 2 * DOT_LANES, **f32)
        self.r = work[:2 * n3].view(2, N, 3)
        self.p = work[2 * n3:4 * n3].view(2, N, 3)
        self.z = work[4 * n3:5 * n3].view(N, 3)
        self.ap = work[5 * n3:6 * n3].view(N, 3)
        self.part = work[6 * n3:7 * n3].view(N, 3)
        lanes = work[7 * n3:]
        self.inputs = (begin, end, baa, bab, bbb, diag, lam, fm, pinv, b)
        self.inc = inc
        self._tol = float(tol)
        self._fns = None if self.eager else _cg_functions()
        p = _build.ptr
        sc = p(self.sc)
        head = (p(inc.b_ptr), p(inc.e_ptr), p(inc.b_pair), p(inc.e_pair),
                p(baa), p(bab), p(bbb), p(diag), p(self.sc[_ZERO_LAM]), p(fm))
        P, R = self.p, self.r

        def matvec(v, prev=None, into=None):
            if prev is None:
                return _CgMatvec(*head, p(v), None, None, None, p(self.part),
                                 N)
            return _CgMatvec(*head, p(prev), p(self.z), p(self.sc[_BETA]),
                             p(into), p(self.part), N)
        dots = _Lanes(p(lanes), p(ticket), n3)

        def damp(v):
            return _CgDamp(dots, None, p(v), p(diag), p(fm), p(lam),
                           p(self.ap), sc, 0.0)

        def update(r_in, v, r_out, first):
            return _CgUpdate(dots, p(r_in), p(self.ap), p(v), p(pinv), p(fm),
                             p(self.x), p(r_out), p(self.z),
                             p(P[0]) if first else None, sc, p(self.stop),
                             self._tol, int(first), 0.0)
        # Phase s's structures: [0] at s = 0, [1] at s = 1, then they
        # alternate with the direction (P[(s - 1) % 2]) and r's buffers.
        self._args = (
            [matvec(self.x), matvec(P[0]), matvec(None, P[0], P[1]),
             matvec(None, P[1], P[0])],
            [damp(self.x), damp(P[0]), damp(P[1])],
            [update(b, self.x, R[0], True), update(R[0], P[0], R[1], False),
             update(R[1], P[1], R[0], False)])
        self._at = tuple([ctypes.addressof(a) for a in args]
                         for args in self._args)

    def run(self, combine, max_iter: int):
        """The loop from x = 0: phase 0, then a step while fewer than
        ``max_iter`` were taken and the stop flag (read once a step) says
        sqrt(r . r) > tol.  ``combine`` sums the matvec's partial over the
        mesh's ranks.  Returns (x [N, 3], the plan's buffer, and the steps
        taken)."""
        st = None if self.eager else _build.stream_ptr(self.device)
        s = 0
        while True:
            self.matvec(s, st)
            self.damp(combine(self.part), s, st)
            self.update(s, st)
            if s >= max_iter or not bool(self.stop):
                return self.x, s
            s += 1

    def _stream(self, st):
        return _build.stream_ptr(self.device) if st is None else st

    def matvec(self, s: int, st=None):
        """Phase s's ``pcg_matvec`` into ``part`` (``st``: the stream, by
        default the current one)."""
        i = s if s < 2 else 2 + s % 2
        if self.eager:
            begin, end, baa, bab, bbb, diag, _, fm, _, _ = self.inputs
            if i == 0:
                v = self.x
            elif i == 1:
                v = self.p[0]
            else:
                v = self.z + self.sc[_BETA] * self.p[s % 2]
                self.p[(s - 1) % 2].copy_(v)
            self.part.copy_(pcg_matvec_twin(begin, end, baa, bab, bbb, diag,
                                            self.sc[_ZERO_LAM], fm, v,
                                            self.inc))
            return
        _build.check(self._fns[0](self._at[0][i], self._stream(st)),
                     "pcg_matvec")
        launches["pcg_matvec" if i < 2 else "pcg_matvec_direction"] += 1

    def damp(self, part, s: int, st=None):
        """Phase s's variant (A) on the combined partial ``part``."""
        i = 0 if s == 0 else 1 + (s - 1) % 2
        if self.eager:
            diag, lam, fm = self.inputs[5:8]
            v = self.x if i == 0 else self.p[i - 1]
            ap, pap, alpha = cg_damp_twin(part, v, diag, lam, fm,
                                          self.sc[_RZ])
            self.ap.copy_(ap)
            self.sc[_PAP].copy_(pap)
            self.sc[_ALPHA].copy_(alpha)
            return
        _build.require_all(self.device, (part,), (
            ("combined partial", torch.float32, self.shape),))
        _build.check(self._fns[1](self._at[1][i], part.data_ptr(),
                                  self._stream(st)), "fixed_dot")
        launches["fixed_dot_damp"] += 1

    def update(self, s: int, st=None):
        """Phase s's variant (B)."""
        i = 0 if s == 0 else 1 + (s - 1) % 2
        if self.eager:
            fm, pinv, b = self.inputs[7:]
            first = i == 0
            r_in = b if first else self.r[i - 1]
            v = self.x if first else self.p[i - 1]
            x, r, z, rz, rr, beta, go = cg_update_twin(
                r_in, self.ap, self.sc[_ALPHA], self.x, v, pinv, fm,
                self.sc[_RZ], self._tol, first)
            if first:
                self.p[0].copy_(z)
            else:
                self.x.copy_(x)
                self.sc[_BETA].copy_(beta)
            self.r[0 if first else i % 2].copy_(r)
            self.z.copy_(z)
            self.sc[_RZ].copy_(rz)
            self.sc[_RR].copy_(rr)
            self.stop.copy_(go)
            return
        _build.check(self._fns[2](self._at[2][i], self._stream(st)),
                     "fixed_dot")
        launches["fixed_dot_update"] += 1


def mesh_cg(begin, end, baa, bab, bbb, diag, lam, fm, pinv, b,
            max_iter: int, tol: float, inc: Incidence, combine,
            twin: bool = False):
    """The CG loop of one LM step of a mesh (``_pcg_solve``'s mesh branch):
    ``pcg_solve``'s arguments and ``combine``, the sum of the rank's
    undamped matvec partial over the ranks.  On CPU tensors, or with
    ``twin``, it is ``pcg_loop`` over the twins, the oracle: each product
    the combined partial, damped as K4 damps.  On CUDA tensors it builds one ``CgPlan`` (the blocks are new
    each LM step) and runs it: a step is three hand launches, the combine
    and one read.  Returns (x [N, 3], steps taken)."""
    if twin or b.device.type == "cpu":
        zero = torch.zeros((), dtype=b.dtype, device=b.device)
        dii = torch.diagonal(diag, dim1=-2, dim2=-1)

        def matvec(v):
            part = pcg_matvec_twin(begin, end, baa, bab, bbb, diag, zero, fm,
                                   v, inc)
            return (combine(part) + lam * (dii * (v * fm[:, None]))) \
                * fm[:, None]
        return pcg_loop(matvec, fixed_dots_twin, pinv, fm, b, max_iter, tol)
    return CgPlan(begin, end, baa, bab, bbb, diag, lam, fm, pinv, b, inc,
                  tol).run(combine, max_iter)


# --- The dense LM system -----------------------------------------------------


@dataclasses.dataclass
class Pairs:
    """The node-pair slots of the dense system over N nodes, built once per
    solve on the device with no read to the host.  Entry q < C is Bab_q at
    slot (begin_q, end_q), entry C + q its transpose at (end_q, begin_q).
    ``keys`` [2C] int64 holds the entries' slots i N + j (N N for a masked
    constraint's), sorted stably; ``src`` [2C] int32 the entry at each
    sorted position; row i's entries are positions ``row_ptr[i]`` to
    ``row_ptr[i + 1]`` ([N + 1] int32), and a slot's entries, consecutive
    there, add in that order: every Bab of the pair in constraint order,
    then every Bab^T, as the reference's two scatters do."""

    n: int
    c: int
    keys: torch.Tensor
    src: torch.Tensor
    row_ptr: torch.Tensor
    _rounds: list = None

    def rounds(self):
        """The twin's form (a read of the live count and the depth, made
        once): per rank d, the (slot, entry) pairs of each slot's d-th
        entry, unique slots within a round."""
        if self._rounds is None:
            live = int(self.row_ptr[-1])
            keys, src = self.keys[:live], self.src[:live].long()
            rank = (torch.arange(live, device=keys.device)
                    - torch.searchsorted(keys, keys))
            depth = int(rank.max()) + 1 if live else 0
            self._rounds = [(keys[rank == d], src[rank == d])
                            for d in range(depth)]
        return self._rounds


def pair_table(begin, end, cmask, n: int) -> Pairs:
    """``Pairs`` of constraints (begin, end) [C] in [0, n) under ``cmask``
    [C] bool."""
    b, e = begin.long(), end.long()
    dead = torch.full_like(b, n * n)
    keys = torch.cat([torch.where(cmask, b * n + e, dead),
                      torch.where(cmask, e * n + b, dead)])
    keys, order = torch.sort(keys, stable=True)
    rows = torch.arange(n + 1, device=keys.device) * n
    return Pairs(n, begin.shape[0], keys, order.to(torch.int32),
                 torch.searchsorted(keys, rows).to(torch.int32))


def dense_system_twin(pairs: Pairs, bab, g, diag, lam, fm, combine=None):
    """Plain-PyTorch dense system (``_dense_solve``'s assembly): per node
    pair slot the sum of its entries from +0 (then ``combine``'s sum over
    ranks, on a mesh), + D on the diagonal, + lam (D o I + 1e-12 I), times
    fm_i then fm_j, + (1 - fm_i) I on the diagonal; rhs = -g fm.  Returns
    (hm [3N, 3N], hm[3i + a, 3j + b] = h[i, j, a, b]; rhs [3N])."""
    n = pairs.n
    dev, dt = g.device, g.dtype
    eye = torch.eye(3, dtype=dt, device=dev)
    h = torch.zeros(n * n, 3, 3, dtype=dt, device=dev)
    on_diag = torch.arange(n, device=dev) * (n + 1)
    entries = torch.cat([bab, bab.transpose(-1, -2)])
    for keys, src in pairs.rounds():
        h[keys] = h[keys] + entries[src]
    if combine is not None:
        h = combine(h)
    h[on_diag] = h[on_diag] + diag
    # LM damping on the block diagonal (Marquardt scaling).
    eps = torch.tensor(1e-12, dtype=dt, device=dev)
    h[on_diag] = h[on_diag] + lam * (diag * eye + eps * eye)
    # Gauge fix + inactive nodes: identity rows/cols, zero rhs.
    h = h.reshape(n, n, 3, 3) * fm[:, None, None, None] * fm[None, :, None,
                                                           None]
    h = h.reshape(n * n, 3, 3)
    h[on_diag] = h[on_diag] + (1.0 - fm)[:, None, None] * eye
    rhs = -g * fm[:, None]
    hm = h.reshape(n, n, 3, 3).permute(0, 2, 1, 3).reshape(3 * n, 3 * n)
    return hm, rhs.reshape(-1)


def dense_system(pairs: Pairs, bab, g, diag, lam, fm, combine=None):
    """The damped dense system of one LM step.  pairs from ``pair_table``
    (its C the constraints of bab), bab [C, 3, 3], g [N, 3], diag
    [N, 3, 3], lam 0-d, fm [N] (the free-node mask as float) f32;
    ``combine`` (a mesh) adds the pair sums over ranks.  Returns (hm
    [3N, 3N], rhs [3N]) as ``dense_system_twin``.  CPU tensors run the
    twin; CUDA tensors launch the kernel: a block a node row, one launch,
    or on a mesh a launch of the pair sums and, after ``combine``, one
    that finishes the combined matrix in place."""
    if g.device.type == "cpu":
        return dense_system_twin(pairs, bab, g, diag, lam, fm, combine)
    dev = g.device
    N, C = pairs.n, pairs.c
    if N > DENSE_MAX_N:
        raise ValueError(f"a dense system of {N} nodes is past the "
                         f"kernel's {DENSE_MAX_N}")
    _build.require_all(dev, (pairs.keys, pairs.src, pairs.row_ptr, bab, g,
                             diag, lam, fm), (
        ("keys", torch.int64, (2 * C,)), ("src", torch.int32, (2 * C,)),
        ("row_ptr", torch.int32, (N + 1,)),
        ("bab", torch.float32, (C, 3, 3)), ("g", torch.float32, (N, 3)),
        ("diag", torch.float32, (N, 3, 3)), ("lam", torch.float32, ()),
        ("fm", torch.float32, (N,))))
    hm = torch.empty(3 * N, 3 * N, dtype=torch.float32, device=dev)
    rhs = torch.empty(3 * N, dtype=torch.float32, device=dev)
    fn = _build.function("ndt2d_dense_system", _DENSE_ARGS)
    p = _build.ptr
    head = (p(pairs.keys), p(pairs.src), p(pairs.row_ptr), p(bab), p(diag),
            p(g), p(lam), p(fm), N, C)
    if combine is None:
        phases = ((0, hm),)
    else:
        _build.check(fn(*head, 1, p(hm), p(rhs), _build.stream_ptr(dev)),
                     "dense_system")
        launches["dense_system"] += 1
        hm = combine(hm)
        _build.require(hm, "combined hm", torch.float32, (3 * N, 3 * N), dev)
        phases = ((2, hm),)
    for phase, out in phases:
        _build.check(fn(*head, phase, p(out), p(rhs),
                        _build.stream_ptr(dev)), "dense_system")
        launches["dense_system"] += 1
    return hm, rhs


def dense_normal_system_twin(poses, begin, end, transform, information,
                             cmask, robust_mask, loss: str, delta: float,
                             inc: Incidence, pairs: Pairs, lam, fm):
    """Plain-PyTorch dense normal system: ``normal_blocks_twin`` then
    ``dense_system_twin``.  Returns (hm [3N, 3N], rhs [3N])."""
    _, bab, _, _, _, g, diag = normal_blocks_twin(
        poses, begin, end, transform, information, cmask, robust_mask, loss,
        delta, inc)
    return dense_system_twin(pairs, bab, g, diag, lam, fm)


def dense_normal_system(poses, begin, end, transform, information, cmask,
                        robust_mask, loss: str, delta: float, inc: Incidence,
                        pairs: Pairs, lam, fm):
    """The damped dense system of one device's LM iteration straight from
    the poses: ``normal_blocks``' inputs (inc from ``incidence``), pairs
    from ``pair_table`` over the same constraints, lam 0-d and fm [N] (the
    free-node mask as float) f32.  Returns (hm [3N, 3N], rhs [3N]) as
    ``dense_normal_system_twin``.  CPU tensors run the twin; CUDA tensors
    launch the kernel once (a block a node row: its rows zero-filled, its
    D and g summed from its incidence lists, its nonzero blocks written
    from its pair slots), bitwise ``normal_blocks`` then ``dense_system``.
    """
    if poses.device.type == "cpu":
        return dense_normal_system_twin(poses, begin, end, transform,
                                        information, cmask, robust_mask,
                                        loss, delta, inc, pairs, lam, fm)
    dev = poses.device
    N, C = poses.shape[0], begin.shape[0]
    _build.require_all(dev, (poses, begin, end, transform, information,
                             cmask, robust_mask, pairs.keys, pairs.src,
                             pairs.row_ptr, lam, fm), (
        ("poses", torch.float32, (N, 3)), ("begin", torch.int32, (C,)),
        ("end", torch.int32, (C,)), ("transform", torch.float32, (C, 3)),
        ("information", torch.float32, (C, 3, 3)),
        ("cmask", torch.bool, (C,)), ("robust_mask", torch.bool, (C,)),
        ("keys", torch.int64, (2 * C,)), ("src", torch.int32, (2 * C,)),
        ("row_ptr", torch.int32, (N + 1,)), ("lam", torch.float32, ()),
        ("fm", torch.float32, (N,))))
    if inc.n != N or pairs.n != N or pairs.c != C:
        raise ValueError(f"incidence over {inc.n} nodes and pairs over "
                         f"{pairs.n} nodes, {pairs.c} constraints: expected "
                         f"{N}, {C}")
    hm = torch.empty(3 * N, 3 * N, dtype=torch.float32, device=dev)
    rhs = torch.empty(3 * N, dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _build.function("ndt2d_dense_normal_system", _DN_ARGS)(
        p(poses), p(begin), p(end), p(transform), p(information), p(cmask),
        p(robust_mask), LOSSES[loss], float(delta), C, p(inc.b_ptr),
        p(inc.b_idx), p(inc.e_ptr), p(inc.e_idx), p(pairs.keys),
        p(pairs.src), p(pairs.row_ptr), p(lam), p(fm), N, p(hm), p(rhs),
        _build.stream_ptr(dev))
    _build.check(err, "dense_normal_system")
    launches["dense_normal_system"] += 1
    return hm, rhs


# --- The LM step -------------------------------------------------------------


@dataclasses.dataclass
class LMState:
    """The LM loop's state on the device, which ``lm_step`` updates in
    place: poses [N, 3], lam and cost (0-d f32), stall (0-d int32), flags
    [2] bool (the last step's accept and improved) and rho [C + 1] f32
    (the kernel's scratch: the cost a constraint, then their sum)."""

    poses: torch.Tensor
    lam: torch.Tensor
    cost: torch.Tensor
    stall: torch.Tensor
    flags: torch.Tensor
    rho: torch.Tensor


def lm_plan(C: int, N: int, fits: int) -> int:
    """Blocks of a cooperative LM-step launch over C constraints and N
    nodes: a thread a constraint (or a node, whichever are more), at most
    ``fits``, the blocks the card holds co-resident (``lm_card``).  The
    result does not depend on it: a thread forms whole constraints' costs,
    one thread adds them in order, and every block folds nothing."""
    if fits < 1:
        raise RuntimeError("the card holds no LM-step block co-resident")
    return min(fits, max(1, -(-max(C, N) // THREADS)))


# Shared memory of the one-block LM step at most (kLmBlockBytes of
# csrc/normal_blocks.cu): the default a block, no opt-in.
LM_BLOCK_BYTES = 48 * 1024


def lm_one_block(C: int) -> bool:
    """Whether the LM step over C constraints runs as one ordinary block:
    its C + 1 costs, in whole float4s, fit the default 48 KB of shared
    memory (C <= 12287: every dense solve; the district's PCG solve takes
    the cooperative grid)."""
    return 16 * ((C + 4) // 4) <= LM_BLOCK_BYTES


def lm_blocks(C: int, N: int, fits: int) -> int:
    """The launch shape ``ndt2d_lm_step`` takes: 0 for the one-block
    variant, else the cooperative grid's blocks (``lm_plan``; ``fits``,
    ``lm_card``'s)."""
    return 0 if lm_one_block(C) else lm_plan(C, N, fits)


@functools.lru_cache(maxsize=None)
def lm_card(index: int) -> int:
    """The cooperative LM-step blocks CUDA device ``index`` holds
    co-resident (0 where it cannot launch cooperatively), asked of the card
    once."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _build.function("ndt2d_lm_step_fit", _LM_FIT_ARGS)(
            ctypes.byref(blocks))
    _build.check(err, "lm_step occupancy")
    return blocks.value


def lm_state(poses, lam: float, cost, constraints: int) -> LMState:
    """A fresh state over ``constraints`` constraints: a copy of poses
    [N, 3] (the caller's stay as they are), lam, the cost 0-d (copied),
    stall 0; made with no host->device copy."""
    dev = poses.device
    return LMState(poses.clone(),
                   torch.full((), lam, dtype=torch.float32, device=dev),
                   cost.clone(),
                   torch.zeros((), dtype=torch.int32, device=dev),
                   torch.zeros(2, dtype=torch.bool, device=dev),
                   torch.empty(constraints + 1, dtype=torch.float32,
                               device=dev))


def _stepped(poses, delta, info):
    """poses + delta, delta NaN where the factorization failed (info != 0,
    as the reference's Cholesky gives NaN); poses where delta is None."""
    if delta is None:
        return poses
    if info is not None:
        nan = torch.tensor(float("nan"), dtype=delta.dtype,
                           device=delta.device)
        delta = torch.where(info == 0, delta, nan)
    return poses + delta


def ordered_sum_twin(x):
    """0-d sum of x's elements in index order from +0, one float32 add at a
    time: the kernel's order, and XLA:CPU's for the reference's cost.  A
    masked or padded element adds +0, which leaves the sum as it is (a sum
    from +0 is never -0), so the sum does not depend on the padding.  Added
    on the host (numpy's accumulate adds in order, in float32)."""
    v = x.detach().reshape(-1).cpu().numpy()
    acc = np.add.accumulate(np.concatenate([np.zeros(1, v.dtype), v]))[-1]
    return torch.tensor(acc, dtype=x.dtype).to(x.device)


def robust_cost_twin(poses, delta, info, begin, end, transform, information,
                     cmask, robust_mask, loss: str, hdelta: float):
    """Plain-PyTorch robust cost (solver.py::_robust_cost) of ``poses`` +
    ``delta`` (see ``_stepped``): per constraint s2 = r^T Lambda r, under
    ``robust_mask`` Huber rho(s) = s^2 for s <= delta, delta (2 s - delta)
    beyond, or Geman-McClure s^2 / (1 + s^2 / delta^2); 0 off ``cmask``;
    summed in index order (``ordered_sum_twin``).  0-d."""
    new = _stepped(poses, delta, info)
    r = _residuals(new, begin, end, transform)[0]
    s2 = _dot3(r, _mv(information, r))
    dev, dt = s2.device, s2.dtype
    if loss == "none":
        rho = s2
    else:
        d = torch.tensor(hdelta, dtype=dt, device=dev)
        if loss == "huber":
            s = torch.sqrt(torch.clamp(s2, min=1e-20))
            two = torch.tensor(2.0, dtype=dt, device=dev)
            rho = torch.where(s > d, d * (two * s - d), s2)
        elif loss == "geman_mcclure":
            one = torch.ones((), dtype=dt, device=dev)
            rho = s2 / (one + s2 / (d * d))
        else:
            raise ValueError(f"unknown robust_loss {loss!r}")
        rho = torch.where(robust_mask, rho, s2)
    return ordered_sum_twin(
        torch.where(cmask, rho, torch.zeros((), dtype=dt, device=dev)))


def _update_twin(state: LMState, new, new_cost, down: float, up: float,
                 tol: float):
    """lm_step's accept and update (solver.py:307-314) in place."""
    cost, lam, stall = state.cost, state.lam, state.stall
    accept = new_cost < cost
    lam_new = torch.clamp(torch.where(accept, lam * down, lam * up), 1e-12,
                          1e8)
    improved = torch.abs(cost - new_cost) > tol * (cost + 1e-12)
    stall_new = torch.where(accept & improved, torch.zeros_like(stall),
                            stall + 1)
    cost_new = torch.where(accept, new_cost, cost)
    state.poses.copy_(torch.where(accept, new, state.poses))
    state.lam.copy_(lam_new)
    state.cost.copy_(cost_new)
    state.stall.copy_(stall_new)
    state.flags.copy_(torch.stack([accept, improved]))


def lm_step_twin(state: LMState, delta, info, begin, end, transform,
                 information, cmask, robust_mask, loss: str, hdelta: float,
                 down: float, up: float, tol: float, combine=None):
    """Plain-PyTorch LM step: the robust cost of state.poses + delta
    (``robust_cost_twin``; on a mesh the rank's partial, then ``combine``'s
    sum over ranks), then the accept and update of ``state`` in place."""
    new = _stepped(state.poses, delta, info)
    new_cost = robust_cost_twin(new, None, None, begin, end, transform,
                                information, cmask, robust_mask, loss,
                                hdelta)
    if combine is not None:
        new_cost = combine(new_cost.reshape(1))[0]
    _update_twin(state, new, new_cost, down, up, tol)


def _lm_launch(mode: int, poses, delta, info, begin, end, transform,
               information, cmask, robust_mask, loss: str, hdelta: float,
               rho, out=None, new_cost=None, state=None, down=0.0, up=0.0,
               tol=0.0):
    """One launch of the LM-step kernel in ``mode`` (``_COST``, ``_STEP``,
    ``_UPDATE``) after checking its tensors."""
    dev = poses.device
    N, C = poses.shape[0], begin.shape[0]
    _build.require_all(dev, (poses, begin, end, transform, information,
                             cmask, robust_mask, rho), (
        ("poses", torch.float32, (N, 3)), ("begin", torch.int32, (C,)),
        ("end", torch.int32, (C,)), ("transform", torch.float32, (C, 3)),
        ("information", torch.float32, (C, 3, 3)),
        ("cmask", torch.bool, (C,)), ("robust_mask", torch.bool, (C,)),
        ("rho", torch.float32, (C + 1,))))
    if delta is not None:
        _build.require(delta, "delta", torch.float32, (N, 3), dev)
    if info is not None:
        _build.require(info, "info", torch.int32, (), dev)
    p = _build.ptr
    opt = (lambda t: None if t is None else t.data_ptr())
    if state is not None:
        _build.require_all(dev, (state.lam, state.cost, state.stall,
                                 state.flags), (
            ("lam", torch.float32, ()), ("cost", torch.float32, ()),
            ("stall", torch.int32, ()), ("flags", torch.bool, (2,))))
        st = (p(state.lam), p(state.cost), p(state.stall), p(state.flags))
    else:
        st = (None,) * 4
    blocks = lm_blocks(C, N, lm_card(dev.index))
    err = _build.function("ndt2d_lm_step", _LM_ARGS)(
        mode, blocks, p(poses), opt(delta), opt(info), p(begin), p(end),
        p(transform), p(information), p(cmask), p(robust_mask), LOSSES[loss],
        float(hdelta), C, N, p(rho), opt(out), opt(new_cost), *st,
        float(down), float(up), float(tol), _build.stream_ptr(dev))
    _build.check(err, "lm_step")
    launches["lm_step"] += 1


def robust_cost(poses, delta, info, begin, end, transform, information,
                cmask, robust_mask, loss: str, hdelta: float):
    """The robust cost of poses [N, 3] + delta [N, 3] (None: of poses; info
    0-d int32 or None, see ``_stepped``) over the constraints, 0-d, as
    ``robust_cost_twin``.  CPU tensors run the twin; CUDA tensors launch
    the LM-step kernel in its cost mode."""
    if poses.device.type == "cpu":
        return robust_cost_twin(poses, delta, info, begin, end, transform,
                                information, cmask, robust_mask, loss,
                                hdelta)
    dev = poses.device
    rho = torch.empty(begin.shape[0] + 1, dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    _lm_launch(_COST, poses, delta, info, begin, end, transform,
               information, cmask, robust_mask, loss, hdelta, rho, out=out)
    return out


def lm_step(state: LMState, delta, info, begin, end, transform, information,
            cmask, robust_mask, loss: str, hdelta: float, down: float,
            up: float, tol: float, combine=None):
    """One LM step's cost, accept and update of ``state`` in place, as
    ``lm_step_twin``: delta [N, 3] f32 the step, info the factorization's
    0-d int32 status (None on the PCG path).  CPU tensors run the twin;
    CUDA tensors launch the kernel once: one block where the C + 1 costs
    fit 48 KB of shared memory (the costs formed there, thread 0 adds them
    in order, the block updates the poses), else a cooperative grid (the
    cost a constraint, a grid sync, block 0 adds them in order, a grid
    sync, every block updates its poses), bitwise the same
    (``lm_blocks``); with ``combine`` (a mesh) a cost launch, ``combine``
    over ranks, then an update launch.  No host->device copy: the scalars
    are kernel arguments."""
    if state.poses.device.type == "cpu":
        return lm_step_twin(state, delta, info, begin, end, transform,
                            information, cmask, robust_mask, loss, hdelta,
                            down, up, tol, combine)
    args = (state.poses, delta, info, begin, end, transform, information,
            cmask, robust_mask, loss, hdelta, state.rho)
    if combine is None:
        _lm_launch(_STEP, *args, state=state, down=down, up=up, tol=tol)
        return
    part = torch.empty(1, dtype=torch.float32, device=state.poses.device)
    _lm_launch(_COST, *args, out=part)
    total = combine(part)
    _build.require(total, "combined cost", torch.float32, (1,),
                   state.poses.device)
    _lm_launch(_UPDATE, *args, new_cost=total, state=state, down=down, up=up,
               tol=tol)


# --- One plan a dense solve ------------------------------------------------


class _Lm(ctypes.Structure):
    """``struct Lm`` of csrc/normal_blocks.cu."""

    _fields_ = ([("mode", ctypes.c_int)]
                + [(f, ctypes.c_void_p) for f in (
                    "poses", "delta", "info", "begin", "end", "transform",
                    "information", "cmask", "robust_mask")]
                + [("loss", ctypes.c_int), ("hdelta", ctypes.c_float),
                   ("C", ctypes.c_int), ("N", ctypes.c_int)]
                + [(f, ctypes.c_void_p) for f in (
                    "rho", "out", "new_cost", "lam", "cost", "stall",
                    "flags")]
                + [(f, ctypes.c_float) for f in ("down", "up", "tol")])


class _LmLaunch(ctypes.Structure):
    """``struct LmLaunch``: an LM step's arguments and launch shape
    (``lm_blocks``)."""

    _fields_ = [("a", _Lm), ("blocks", ctypes.c_int)]


class _Graph(ctypes.Structure):
    """``struct Graph``."""

    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "poses", "begin", "end", "transform", "information", "cmask",
        "robust_mask")] + [("loss", ctypes.c_int), ("delta", ctypes.c_float)])


class _DenseNormal(ctypes.Structure):
    """``struct DenseNormal``: ``dense_normal_system``'s arguments."""

    _fields_ = ([("g", _Graph), ("C", ctypes.c_int), ("n", ctypes.c_int)]
                + [(f, ctypes.c_void_p) for f in (
                    "b_ptr", "b_idx", "e_ptr", "e_idx", "keys", "src",
                    "row_ptr", "lam", "fm", "hm", "rhs")])


@functools.lru_cache(maxsize=None)
def _planned_functions():
    """The two planned C entries, after checking that the ctypes mirrors
    have their C structures' sizes."""
    lm, dense = ctypes.c_int(0), ctypes.c_int(0)
    _build.function("ndt2d_plan_sizes", _SIZES_ARGS)(ctypes.byref(lm),
                                                      ctypes.byref(dense))
    mine = (ctypes.sizeof(_LmLaunch), ctypes.sizeof(_DenseNormal))
    if (lm.value, dense.value) != mine:
        raise RuntimeError(f"plan structures of {mine} bytes, the kernels' "
                           f"{(lm.value, dense.value)}")
    return (_build.function("ndt2d_dense_normal_system_planned",
                            _PLANNED_ARGS),
            _build.function("ndt2d_lm_step_planned", _PLANNED_ARGS))


class DensePlan:
    """One device's dense LM solve, planned once a solve: every tensor of
    an iteration's two launches checked once, the system (hm, rhs), the
    factor, the step and its status allocated once, and each launch's
    arguments packed once into the C structure its planned entry reads.
    An iteration is then ``system()`` (``dense_normal_system``: one ctypes
    call with a pointer and the stream), the library's factorization and
    solve into ``factor``, ``delta`` and ``info`` (``solve_out``), and
    ``step()`` (``lm_step`` in its step mode, one call likewise), bitwise
    the unplanned wrappers.

    ``state`` is the solve's ``lm_state`` (updated in place by the step,
    so its pointers hold); the constraint terms, ``inc``, ``pairs`` and
    ``fm`` as ``dense_normal_system``'s; down/up/tol the LM factors.  The
    plan keeps every tensor it points to.  On CUDA tensors its two calls
    launch or raise.  With ``twin`` they run the twins
    (``dense_normal_system_twin``, ``lm_step_twin``), and on CPU tensors
    the public wrappers (which run the twins there), on its delta and
    info."""

    def __init__(self, state: LMState, begin, end, transform, information,
                 cmask, robust_mask, loss: str, hdelta: float,
                 inc: Incidence, pairs: Pairs, fm, down: float, up: float,
                 tol: float, twin: bool = False):
        poses = state.poses
        dev = poses.device
        N, C = poses.shape[0], begin.shape[0]
        _build.require_all(dev, (
            poses, begin, end, transform, information, cmask, robust_mask,
            inc.b_ptr, inc.b_idx, inc.e_ptr, inc.e_idx, pairs.keys,
            pairs.src, pairs.row_ptr, fm, state.lam, state.cost, state.stall,
            state.flags, state.rho), (
            ("poses", torch.float32, (N, 3)), ("begin", torch.int32, (C,)),
            ("end", torch.int32, (C,)), ("transform", torch.float32, (C, 3)),
            ("information", torch.float32, (C, 3, 3)),
            ("cmask", torch.bool, (C,)), ("robust_mask", torch.bool, (C,)),
            ("b_ptr", torch.int32, (N + 1,)),
            ("b_idx", torch.int32, tuple(inc.b_idx.shape)),
            ("e_ptr", torch.int32, (N + 1,)),
            ("e_idx", torch.int32, tuple(inc.e_idx.shape)),
            ("keys", torch.int64, (2 * C,)), ("src", torch.int32, (2 * C,)),
            ("row_ptr", torch.int32, (N + 1,)), ("fm", torch.float32, (N,)),
            ("lam", torch.float32, ()), ("cost", torch.float32, ()),
            ("stall", torch.int32, ()), ("flags", torch.bool, (2,)),
            ("rho", torch.float32, (C + 1,))))
        if inc.n != N or pairs.n != N or pairs.c != C:
            raise ValueError(f"incidence over {inc.n} nodes and pairs over "
                             f"{pairs.n} nodes, {pairs.c} constraints: "
                             f"expected {N}, {C}")
        if inc.b_idx.dim() != 1 or inc.e_idx.dim() != 1:
            raise ValueError("incidence lists must be flat")
        M = 3 * N
        f32 = dict(dtype=torch.float32, device=dev)
        self.device = dev
        # The calls that stand in for the two launches, None on the card.
        self.eager = ((dense_normal_system_twin, lm_step_twin) if twin
                      else (dense_normal_system, lm_step)
                      if dev.type == "cpu" else None)
        self.hm = torch.empty(M, M, **f32)
        self.rhs = torch.empty(M, **f32)
        # Column-major, as the library's factorization writes it: no copy.
        self.factor = torch.empty_strided((M, M), (1, M), **f32)
        self.delta = torch.empty(N, 3, **f32)
        self.info = torch.empty((), dtype=torch.int32, device=dev)
        self.state = state
        self.terms = (begin, end, transform, information, cmask, robust_mask,
                      loss, hdelta)
        self.sums = (inc, pairs, fm)
        self.factors = (down, up, tol)
        p = _build.ptr
        self.system_args = _DenseNormal(
            _Graph(p(poses), p(begin), p(end), p(transform), p(information),
                   p(cmask), p(robust_mask), LOSSES[loss], float(hdelta)),
            C, N, p(inc.b_ptr), p(inc.b_idx), p(inc.e_ptr), p(inc.e_idx),
            p(pairs.keys), p(pairs.src), p(pairs.row_ptr), p(state.lam),
            p(fm), p(self.hm), p(self.rhs))
        self.step_args = _LmLaunch(
            _Lm(_STEP, p(poses), p(self.delta), p(self.info), p(begin),
                p(end), p(transform), p(information), p(cmask),
                p(robust_mask), LOSSES[loss], float(hdelta), C, N,
                p(state.rho), None, None, p(state.lam), p(state.cost),
                p(state.stall), p(state.flags), float(down), float(up),
                float(tol)),
            0 if self.eager else lm_blocks(C, N, lm_card(dev.index)))
        self._system_at = ctypes.addressof(self.system_args)
        self._step_at = ctypes.addressof(self.step_args)

    @property
    def solve_out(self) -> tuple:
        """The buffers the factorization and solve write: (factor, info,
        delta)."""
        return self.factor, self.info, self.delta

    def system(self):
        """One ``dense_normal_system`` launch at the state's poses and lam;
        returns (hm, rhs), the plan's buffers (the twin's result off the
        card)."""
        if self.eager:
            inc, pairs, fm = self.sums
            return self.eager[0](self.state.poses, *self.terms, inc, pairs,
                                 self.state.lam, fm)
        fn = _planned_functions()[0]
        _build.check(fn(self._system_at, _build.stream_ptr(self.device)),
                     "dense_normal_system")
        launches["dense_normal_system"] += 1
        return self.hm, self.rhs

    def step(self):
        """One ``lm_step`` launch (step mode) of ``delta`` and ``info``,
        updating the state in place."""
        if self.eager:
            self.eager[1](self.state, self.delta, self.info, *self.terms,
                          *self.factors)
            return
        fn = _planned_functions()[1]
        _build.check(fn(self._step_at, _build.stream_ptr(self.device)),
                     "lm_step")
        launches["lm_step"] += 1


# --- One plan a PCG solve ----------------------------------------------------


class _PcgSystem(ctypes.Structure):
    """``struct PcgSystem`` of csrc/normal_blocks.cu."""

    _fields_ = ([("g", _Graph), ("C", ctypes.c_int), ("N", ctypes.c_int)]
                + [(f, ctypes.c_void_p) for f in (
                    "b_ptr", "b_idx", "e_ptr", "e_idx", "lam", "fm", "baa",
                    "bab", "bbb", "d", "pinv", "b")])


@functools.lru_cache(maxsize=None)
def _pcg_planned():
    """The planned PCG system entry, after checking that the ctypes mirror
    has its C structure's size."""
    size = ctypes.c_int(0)
    _build.function("ndt2d_pcg_plan_size", _PS_SIZE_ARGS)(ctypes.byref(size))
    if size.value != ctypes.sizeof(_PcgSystem):
        raise RuntimeError(f"PcgSystem of {ctypes.sizeof(_PcgSystem)} "
                           f"bytes, the kernel's {size.value}")
    return _build.function("ndt2d_pcg_normal_system_planned", _PLANNED_ARGS)


class PcgPlan:
    """One device's PCG LM solve, planned once a solve: every tensor of
    ``pcg_normal_system`` checked once, its six outputs allocated once and
    its arguments packed once into ``struct PcgSystem``.  ``system()`` is
    then one ctypes call with a pointer and the stream, bitwise the
    unplanned wrapper, at the state's poses and lam (both read on the
    device).  The outputs are the plan's, rewritten by each call: the
    iteration's ``pcg_solve`` reads them before the next call on the
    stream, and a caller that keeps them clones them.

    ``state`` is the solve's ``lm_state`` (updated in place by the step);
    the constraint terms and ``inc`` as ``pcg_normal_system``'s; fm [N]
    f32.  On CUDA tensors the call launches or raises.  With ``twin`` it
    runs ``pcg_normal_system_twin``, and on CPU tensors the public wrapper
    (the twin there)."""

    def __init__(self, state: LMState, begin, end, transform, information,
                 cmask, robust_mask, loss: str, hdelta: float,
                 inc: Incidence, fm, twin: bool = False):
        poses = state.poses
        dev = poses.device
        N, C = poses.shape[0], begin.shape[0]
        _pcg_system_checks(dev, N, C, (
            poses, begin, end, transform, information, cmask, robust_mask,
            inc.b_ptr, inc.b_idx, inc.e_ptr, inc.e_idx, state.lam, fm), inc)
        self.device = dev
        self.state = state
        self.terms = (begin, end, transform, information, cmask, robust_mask,
                      loss, hdelta)
        self.inc, self.fm = inc, fm
        self.eager = (pcg_normal_system_twin if twin
                      else pcg_normal_system if dev.type == "cpu" else None)
        if self.eager:
            return
        self.out = _pcg_system_out(N, C, dev)
        p = _build.ptr
        self.args = _PcgSystem(
            _Graph(p(poses), p(begin), p(end), p(transform), p(information),
                   p(cmask), p(robust_mask), LOSSES[loss], float(hdelta)),
            C, N, p(inc.b_ptr), p(inc.b_idx), p(inc.e_ptr), p(inc.e_idx),
            p(state.lam), p(fm), *[p(t) for t in self.out])
        self._at = ctypes.addressof(self.args)

    def system(self):
        """One ``pcg_normal_system`` launch: (Baa, Bab, Bbb, D, pinv, b)."""
        if self.eager:
            return self.eager(self.state.poses, *self.terms, self.inc,
                              self.state.lam, self.fm)
        _build.check(_pcg_planned()(self._at,
                                    _build.stream_ptr(self.device)),
                     "pcg_normal_system")
        launches["pcg_normal_system"] += 1
        return self.out
