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

_ARGS = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
THREADS = 256        # the kernel's block size
BLOCKS_PER_SM = 4


def geometry(n: int, x_ptr: int, out_ptr: int, sms: int):
    """The launch of ``rank_sum`` over n elements a rank: (width, units,
    blocks).  ``width`` floats a load, 4 (16-byte loads and stores) when n
    is a multiple of 4 and both pointers are 16-byte aligned, else 1;
    ``units = n // width``; ``blocks`` of ``THREADS`` threads, at most
    ``BLOCKS_PER_SM`` an SM, whose thread i takes units i, i + blocks *
    THREADS, ... below ``units``."""
    width = 4 if n % 4 == 0 and x_ptr % 16 == 0 and out_ptr % 16 == 0 \
        else 1
    units = n // width
    blocks = max(1, min(-(-units // THREADS), sms * BLOCKS_PER_SM))
    return width, units, blocks


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
    dev = x.device
    if dev.type == "cpu":
        return rank_sum_twin(x)
    shape = x.shape
    S = shape[0]
    n = x.numel() // S if S else 0
    if S < 1 or n >= 2 ** 31:
        raise ValueError(f"rank_sum of {S} x {n} is outside the kernel's "
                         "range")
    _build.require(x, "x", torch.float32, shape, dev)
    out = torch.empty(shape[1:], dtype=torch.float32, device=dev)
    xp, op = x.data_ptr(), out.data_ptr()
    width, _, blocks = geometry(n, xp, op, _build.sm_count(dev.index))
    err = _build.function("ndt2d_rank_sum", _ARGS)(
        xp, S, n, width, blocks, op, _build.stream_ptr(dev))
    _build.check(err, "rank_sum")
    launches += 1
    return out
