"""The multi-process runtime of the port's device meshes.

Port of ``ndt_2d_tpu/parallel/distributed.py`` on ``torch.distributed``:
one process per device, every process running the same host program on
the same inputs (the multi-controller discipline of the reference), each
device computing only its rank's shard.  What JAX expresses as ``psum``
and ``all_gather`` inside ``shard_map`` is here an explicit collective
between kernels.

Every float combine is an all-gather of per-shard partials followed by a
reduction in rank order that is the same on every rank
(``kernels/shard_combine.py``), so every rank holds the same bits and the
replicated host logic (gates, the LM control flow, constraint appends)
cannot part between ranks; no float all-reduce is used, because its order
is the ring's.  Integer sums are exact and use ``all_reduce``.

Backends: NCCL for CUDA devices, gloo for the CPU.  Ranks may also share
one card over gloo (a test of the sharded code on one GPU); a gloo
collective of a CUDA tensor is staged through the host explicitly.  A
collective over a group of one rank is the identity and is skipped.

Rendezvous: ``launch`` starts N local ranks with a ``file://`` store in a
fresh temporary directory (no TCP port to race for); ``initialize`` under
``torchrun`` reads the ``env://`` variables it sets.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# The rendezvous of ranks started by ``launch``; without it, env://.
ENV_INIT = "NDT2D_DIST_INIT"


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(device=None, backend: Optional[str] = None,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device.

    Rank, world size and local rank default to ``RANK``, ``WORLD_SIZE``
    and ``LOCAL_RANK`` (as ``torchrun`` and ``launch`` set them), the
    rendezvous to ``NDT2D_DIST_INIT`` and then ``env://``.  ``device``
    defaults to ``cuda``; a CUDA device without an index becomes
    ``cuda:<local rank>``, which must exist.  ``backend`` defaults to the
    device's (``backend_for``)."""
    rank = int(os.environ.get("RANK", "0")) if rank is None else int(rank)
    world = (int(os.environ.get("WORLD_SIZE", "1")) if world_size is None
             else int(world_size))
    local = int(os.environ.get("LOCAL_RANK", str(rank)))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None:
            count = torch.cuda.device_count()
            if local >= count:
                raise RuntimeError(
                    f"rank {rank} (local {local}) needs its own CUDA device; "
                    f"{count} visible")
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    init_method = init_method or os.environ.get(ENV_INIT) or "env://"
    dist.init_process_group(backend or backend_for(dev),
                            init_method=init_method, world_size=world,
                            rank=rank)
    return dev


def is_multiprocess() -> bool:
    """True when the runtime spans more than one process."""
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def rank() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def _alone(group) -> bool:
    """True for no group, or a group of this rank alone: its collectives
    are the identity and are skipped."""
    return group is None or dist.get_world_size(group) == 1


def _staged(t: torch.Tensor, group) -> bool:
    """A CUDA tensor crossing a non-NCCL group goes through the host."""
    return t.is_cuda and dist.get_backend(group) != "nccl"


def gather(t: torch.Tensor, group, out=None) -> torch.Tensor:
    """[S, *t.shape]: every rank's ``t`` in group-rank order (an
    all-gather), written into ``out`` [S, *t.shape] when given (on a
    group of more than one rank).  ``group`` None (or of one rank) is this
    rank alone: ``t[None]``, nothing copied."""
    if _alone(group):
        return t[None]
    S = dist.get_world_size(group)
    if not _staged(t, group) and t.is_cuda:
        if out is None:
            out = torch.empty((S, *t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
        return out
    src = t.cpu() if t.is_cuda else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(S)]
    dist.all_gather(parts, src, group=group)
    stacked = torch.stack(parts)
    if out is not None:
        return out.copy_(stacked)
    return stacked.to(t.device) if t.is_cuda else stacked


def host_group():
    """A new gloo group of the whole world, for small host tensors that
    must not wait for a CUDA stream under NCCL.  Every rank calls it, at
    the same point of its program."""
    return dist.new_group(backend="gloo")


def broadcast(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` as the group's first rank holds it, on every rank of the
    group, written into ``t`` in place and returned.  ``group`` None is the
    whole world; outside a process group, or on a group of one rank,
    nothing is sent."""
    if not dist.is_initialized() or _alone(
            dist.group.WORLD if group is None else group):
        return t
    root = 0 if group is None else dist.get_global_rank(group, 0)
    if _staged(t, group):
        x = t.cpu()
        dist.broadcast(x, root, group=group)
        return t.copy_(x)
    dist.broadcast(t, root, group=group)
    return t


def sum_int(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the group's ranks of an integer tensor (all-reduce:
    exact in any order).  ``group`` None is the whole world."""
    if t.is_floating_point():
        raise TypeError("sum_int takes integer tensors; float partials "
                        "combine by gather + kernels.shard_combine.rank_sum")
    if not dist.is_initialized() or _alone(
            dist.group.WORLD if group is None else group):
        return t
    staged = _staged(t, group)
    x = t.cpu() if staged else t.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x.to(t.device) if staged else x


def barrier(group=None) -> None:
    """Block until every rank of the group gets here."""
    if dist.is_initialized():
        dist.barrier(group=group)


def assert_replicated(x, name: str = "value", group=None) -> None:
    """Raise unless the host value ``x`` is bitwise identical on every rank
    (the invariant the replicated host loop rests on)."""
    if not is_multiprocess():
        return
    mine = np.ascontiguousarray(np.asarray(x)).tobytes()
    every = [None] * dist.get_world_size(group)
    dist.all_gather_object(every, mine, group=group)
    for r, other in enumerate(every):
        if other != mine:
            raise AssertionError(
                f"host value {name!r} differs between this rank and rank "
                f"{r}: the replicated host loop has parted")


def launch(cmd: Sequence[str], n: int, env: Optional[dict] = None,
           timeout: Optional[float] = None) -> None:
    """Run ``cmd`` as ``n`` local ranks of one process group and wait for
    them: each gets ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE`` and a
    ``file://`` rendezvous in a fresh temporary directory.  Rank 0 writes
    to this process's stdout; the others' stdout is dropped.  If a rank
    fails (or ``timeout`` seconds pass) the others are stopped and
    RuntimeError is raised."""
    tmp = tempfile.mkdtemp(prefix="ndt2d_dist_")
    base = dict(os.environ if env is None else env)
    # The ranks import this package from where this process did.
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in base.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    base.update(WORLD_SIZE=str(n),
                **{ENV_INIT: "file://" + os.path.join(tmp, "rendezvous")})
    procs = []
    try:
        for r in range(n):
            e = dict(base, RANK=str(r), LOCAL_RANK=str(r))
            out = subprocess.DEVNULL if r else None
            procs.append(subprocess.Popen(list(cmd), env=e, stdout=out))
        t0 = time.monotonic()
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank {failed[0]} of {n} exited with "
                                   f"{codes[failed[0]]}: {' '.join(cmd)}")
            if all(c == 0 for c in codes):
                return
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise RuntimeError(f"{n} ranks still running after "
                                   f"{timeout} s: {' '.join(cmd)}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
