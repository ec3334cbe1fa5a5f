"""Device meshes for the port's multi-device paths.

Port of ``ndt_2d_tpu/parallel/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group, one process per device, with two named axes:

* ``space`` shards the candidate search (the matcher's angles);
* ``batch`` shards independent work items (confirmation rows, particles,
  constraints, descriptor queries).

The ranks form the mesh in row-major order, rank = space * B + batch, as
JAX lays its devices into ``Mesh(devices.reshape(shape))``.  The process
group must exist first (``parallel.distributed.initialize``); its backend
(NCCL for CUDA devices, gloo for the CPU) is the mesh's.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SPACE_AXIS = "space"
BATCH_AXIS = "batch"


def _factor(n: int) -> Tuple[int, int]:
    """Split n into (space, batch) as close to square as possible, space
    the larger (mesh.py:28-34)."""
    best = (n, 1)
    for s in range(1, int(np.sqrt(n)) + 1):
        if n % s == 0:
            best = (n // s, s)
    return best


def _device_type() -> str:
    """The mesh's device type: ``cuda`` under an NCCL group, else ``cpu``
    (a gloo group, whose ranks may still compute on a CUDA device)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Sequence[int]] = None) -> DeviceMesh:
    """The standard 2-D (space, batch) mesh over the process group's
    ranks; ``n_devices`` defaults to the world size, which it must equal
    (every rank runs the same host program over the whole mesh)."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a world of {n} "
                         f"ranks, not {world}")
    shape = _factor(n) if shape is None else tuple(int(s) for s in shape)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} does not hold {n} devices")
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=(SPACE_AXIS, BATCH_AXIS))


def single_axis_mesh(n_devices: Optional[int] = None,
                     axis: str = SPACE_AXIS) -> DeviceMesh:
    """A 1-D mesh of every rank along ``axis`` (mesh.py:52)."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a world of {n} "
                         f"ranks, not {world}")
    return init_device_mesh(_device_type(), (n,), mesh_dim_names=(axis,))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Ranks along ``axis`` (1 when the mesh has no such axis)."""
    if axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh[axis].size()


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 when absent)."""
    if axis not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of this rank's line along ``axis``, or None when
    the mesh has no such axis (nothing to combine)."""
    if axis not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(axis)
