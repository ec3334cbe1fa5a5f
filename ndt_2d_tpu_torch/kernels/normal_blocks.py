"""K4: LM normal-equation blocks and the PCG matvec (CUDA
``csrc/normal_blocks.cu``) and their plain-PyTorch twins.

Replaces ``ndt_2d_tpu/graph/solver.py::robust_weights`` +
``_normal_blocks`` + ``_gather_gradient_and_diag`` (``normal_blocks``) and
the matvec of ``_pcg_solve`` (``pcg_matvec``).  The per-node sums walk
incidence lists (``Incidence``) in constraint order, so kernel and twin add
the same float32 values in the same order and agree bitwise; neither uses
float atomics.  The twins write every 3-term dot product as
``(x0 y0 + x1 y1) + x2 y2``, the order the kernel sums in, and divide only
by tensors on the same device (PyTorch's CUDA division by a host scalar
multiplies by its reciprocal, which can round differently).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ndt_2d_tpu_torch.kernels import _build

launches = {"normal_blocks": 0, "pcg_matvec": 0}

LOSSES = {"none": 0, "huber": 1, "geman_mcclure": 2}

_NB_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_float,
                                     ctypes.c_int] + [ctypes.c_void_p] * 4
            + [ctypes.c_int] + [ctypes.c_void_p] * 8)
_MV_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 11)


@dataclasses.dataclass
class Incidence:
    """Per-node lists of the live constraints that begin (end) at each
    node, in constraint order, for N nodes.

    ``*_ptr`` [N + 1] / ``*_idx`` int32 are the kernel's (CSR) form;
    ``*_mat`` [N, D] int64 with ``*_ok`` [N, D] bool the twin's (slot d of
    node n holds its d-th constraint).  Built once per solve: begin, end
    and the mask do not change inside one."""

    n: int
    b_ptr: torch.Tensor
    b_idx: torch.Tensor
    b_mat: torch.Tensor
    b_ok: torch.Tensor
    e_ptr: torch.Tensor
    e_idx: torch.Tensor
    e_mat: torch.Tensor
    e_ok: torch.Tensor


def _lists(node, live, n: int):
    """(ptr, idx, mat, ok) of one side: ``node`` [C] int64 node ids,
    ``live`` [K] ascending ids of the live constraints."""
    dev = node.device
    at = node[live]
    order = torch.sort(at, stable=True).indices
    idx = live[order]
    at = at[order]
    counts = torch.bincount(at, minlength=n)
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    ptr[1:] = torch.cumsum(counts, 0)
    rank = torch.arange(idx.numel(), device=dev) - ptr[at]
    width = int(counts.max()) if idx.numel() else 0
    mat = torch.zeros(n, width, dtype=torch.int64, device=dev)
    ok = torch.zeros(n, width, dtype=torch.bool, device=dev)
    mat[at, rank] = idx
    ok[at, rank] = True
    return ptr.to(torch.int32), idx.to(torch.int32), mat, ok


def incidence(begin, end, cmask, n: int) -> Incidence:
    """Incidence lists of constraints (begin, end) [C] in [0, n), keeping
    only those in ``cmask`` [C]: a masked constraint's blocks are exact
    zeros, and an in-order sum from +0 is unchanged by adding one."""
    live = torch.nonzero(cmask).squeeze(1)
    b = _lists(begin.to(torch.int64), live, n)
    e = _lists(end.to(torch.int64), live, n)
    return Incidence(n, *b, *e)


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


def _normalize_angle(t):
    """core/pose.py::normalize_angle with device-tensor constants."""
    pi = torch.tensor(torch.pi, dtype=t.dtype, device=t.device)
    two_pi = torch.tensor(2.0 * torch.pi, dtype=t.dtype, device=t.device)
    return t - two_pi * torch.floor((t + pi) / two_pi)


def residuals_and_jacobians(poses, begin, end, transform):
    """(r [C, 3], Ja, Jb [C, 3, 3]) in the kernel's evaluation order."""
    pa, pb = poses[begin.long()], poses[end.long()]
    dx, dy = pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1]
    c, s = torch.cos(pa[:, 2]), torch.sin(pa[:, 2])
    r = torch.stack([(c * dx + s * dy) - transform[:, 0],
                     (-s * dx + c * dy) - transform[:, 1],
                     _normalize_angle((pb[:, 2] - pa[:, 2])
                                      - transform[:, 2])], -1)
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
    kernel."""
    if v.device.type == "cpu":
        return pcg_matvec_twin(begin, end, baa, bab, bbb, diag, lam, fm, v,
                               inc)
    dev = v.device
    N, C = v.shape[0], begin.shape[0]
    _build.require(begin, "begin", torch.int32, (C,), dev)
    _build.require(end, "end", torch.int32, (C,), dev)
    for name, t in (("baa", baa), ("bab", bab), ("bbb", bbb)):
        _build.require(t, name, torch.float32, (C, 3, 3), dev)
    _build.require(diag, "diag", torch.float32, (N, 3, 3), dev)
    _build.require(lam, "lam", torch.float32, (), dev)
    _build.require(fm, "fm", torch.float32, (N,), dev)
    _build.require(v, "v", torch.float32, (N, 3), dev)
    out = torch.empty(N, 3, dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _build.function("ndt2d_pcg_matvec", _MV_ARGS)(
        p(inc.b_ptr), p(inc.b_idx), p(inc.e_ptr), p(inc.e_idx), N, p(begin),
        p(end), p(baa), p(bab), p(bbb), p(diag), p(lam), p(fm), p(v), p(out),
        _build.stream_ptr(dev))
    _build.check(err, "pcg_matvec")
    launches["pcg_matvec"] += 1
    return out
