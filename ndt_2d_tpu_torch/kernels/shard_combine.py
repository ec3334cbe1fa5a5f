"""K12: the rank-ordered sum of a device mesh's per-shard partials (CUDA
``csrc/shard_combine.cu``) and its plain-PyTorch twin.

Replaces the float ``psum`` of ``ndt_2d_tpu/parallel/solver.py::
solve_multichip`` (cost, gradient, block diagonal, PCG matvec).  A float
all-reduce adds in the ring's order; here every rank gathers the [S, n]
partials and adds them in rank order from rank 0's, so every rank holds
the same bits.  Kernel and twin add in that order and agree bitwise.
"""

from __future__ import annotations

import ctypes

import torch

from ndt_2d_tpu_torch.kernels import _build

launches = 0

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p]


def rank_sum_twin(x):
    """Plain-PyTorch ``rank_sum``: x [S, ...] summed over ranks in order."""
    acc = x[0].clone()
    for r in range(1, x.shape[0]):
        acc = acc + x[r]
    return acc


def rank_sum(x):
    """x [S, ...] float32 (rank r's partial in x[r]) -> [...], the partials
    added in rank order from x[0].  CPU tensors run the twin; CUDA tensors
    launch the kernel."""
    global launches
    if x.device.type == "cpu":
        return rank_sum_twin(x)
    dev = x.device
    S = x.shape[0]
    n = x[0].numel()
    if S < 1 or S * n >= 2 ** 31:
        raise ValueError(f"rank_sum of {S} x {n} is outside the kernel's "
                         "range")
    _build.require(x, "x", torch.float32, tuple(x.shape), dev)
    out = torch.empty(x.shape[1:], dtype=torch.float32, device=dev)
    err = _build.function("ndt2d_rank_sum", _ARGS)(
        _build.ptr(x), S, n, _build.ptr(out), _build.stream_ptr(dev))
    _build.check(err, "rank_sum")
    launches += 1
    return out
