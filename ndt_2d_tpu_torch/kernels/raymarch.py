"""K5: occupancy ray-march (CUDA ``csrc/raymarch.cu``) and its twin.

Replaces ``ndt_2d_tpu/mapping/occupancy.py::_raymarch_counts``: per ray,
K samples at t = linspace(0, 1, K), consecutive repeats of a cell dropped,
"empty" for every crossed cell but the end cell, "hit" at the end cell.
Counts are int32 and bitwise equal between the kernel and the twin.
"""

from __future__ import annotations

import ctypes

import torch

from ndt_2d_tpu_torch.kernels import _build
from ndt_2d_tpu_torch.ndt import grid as ndt_grid

launches = 0

_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p]
         + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)


def linspace01(num_samples: int, device) -> torch.Tensor:
    """jnp.linspace(0, 1, K) in float32: float(k) / float(K - 1), last = 1."""
    t = (torch.arange(num_samples, dtype=torch.float32, device=device)
         / ndt_grid.f32(num_samples - 1, device))
    t[-1] = 1.0
    return t


def raymarch_counts_twin(starts, ends, beam_mask, origin, resolution: float,
                         width: int, height: int, num_samples: int):
    """Plain-PyTorch K5: (hit [H*W], empty [H*W]) int32."""
    dev = starts.device
    res = ndt_grid.f32(resolution, dev)
    num_cells = width * height

    def cell_of(p):
        ix = torch.clamp(torch.floor((p[..., 0] - origin[0]) / res),
                         0, width - 1).to(torch.int64)
        iy = torch.clamp(torch.floor((p[..., 1] - origin[1]) / res),
                         0, height - 1).to(torch.int64)
        return iy * width + ix

    end_cell = cell_of(ends)
    t = linspace01(num_samples, dev)
    pos = starts[:, None, :] + (ends - starts)[:, None, :] * t[None, :, None]
    cells = cell_of(pos)
    first = torch.cat([torch.ones_like(cells[:, :1], dtype=torch.bool),
                       cells[:, 1:] != cells[:, :-1]], dim=1)
    empty_mask = first & (cells != end_cell[:, None]) & beam_mask[:, None]
    empty = torch.bincount(cells[empty_mask], minlength=num_cells)
    hit = torch.bincount(end_cell[beam_mask], minlength=num_cells)
    return hit.to(torch.int32), empty.to(torch.int32)


def raymarch_counts(starts, ends, beam_mask, origin, resolution: float,
                    width: int, height: int, num_samples: int):
    """K5.  starts/ends [R, 2] f32, beam_mask [R] bool, origin [2] f32.
    CPU tensors run the twin; CUDA tensors launch the kernel."""
    global launches
    if starts.device.type == "cpu":
        return raymarch_counts_twin(starts, ends, beam_mask, origin,
                                    resolution, width, height, num_samples)
    dev = starts.device
    R = starts.shape[0]
    _build.require(starts, "starts", torch.float32, (R, 2), dev)
    _build.require(ends, "ends", torch.float32, (R, 2), dev)
    _build.require(beam_mask, "beam_mask", torch.bool, (R,), dev)
    _build.require(origin, "origin", torch.float32, (2,), dev)
    if num_samples < 2:
        raise ValueError("num_samples must be >= 2")
    hit = torch.zeros(width * height, dtype=torch.int32, device=dev)
    empty = torch.zeros(width * height, dtype=torch.int32, device=dev)
    p = _build.ptr
    err = _build.function("ndt2d_raymarch", _ARGS)(
        p(starts), p(ends), p(beam_mask), R, p(origin), float(resolution),
        width, height, num_samples, p(hit), p(empty), _build.stream_ptr(dev))
    _build.check(err, "raymarch")
    launches += 1
    return hit, empty
