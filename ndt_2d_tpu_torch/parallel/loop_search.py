"""Loop-closure candidate search over keyframe descriptors, on one device.

Port of the single-device functions of
``ndt_2d_tpu/parallel/loop_search.py``: every keyframe gets a compact
rotation-invariant descriptor, L2-normalized so that candidate search is a
cosine similarity and a top-k.  Candidates are proposals; the mapper
confirms each with a full NDT match and the score gate.  Everything here
runs on kernel K10: the binning of the points and the descriptors' spectra
(``kernels/descriptors.py``), the similarities and the top-k
(``kernels/descriptor_search.py``).  Over a device mesh
(``search_all_pairs_multichip``) the query rows shard over the mesh's
``batch`` axis against the whole key table on every rank, and the rows are
gathered in rank order.

Sums are float32 in a fixed order, so row q of ``search_all_pairs`` is
``search_dense`` at q to the bit.  Top-k ties go to the lower index, as
``jax.lax.top_k`` returns them: empty and repeated scans tie exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ndt_2d_tpu_torch.kernels import descriptor_search
from ndt_2d_tpu_torch.kernels import descriptors as k10
from ndt_2d_tpu_torch.parallel import distributed
from ndt_2d_tpu_torch.parallel.mesh import (
    BATCH_AXIS, axis_group, axis_rank, axis_size)


def descriptors(points, point_mask, range_max: float, n_bins: int = 32,
                n_sectors: int = 64, n_rings: int = 4):
    """Rotation-invariant keyframe descriptors, L2-normalized.

    ``points`` [S, P, 2] robot frame, ``point_mask`` [S, P].  Three parts,
    concatenated and jointly normalized to unit L2 norm: the magnitude
    spectrum of the angular range profile (mean beam range per sector ->
    |DFT| over sectors, exactly invariant to a rotation of the robot); the
    per-ring angular occupancy spectra (points binned into ``n_rings``
    range bands x ``n_sectors`` sectors, each ring's profile through the
    same |DFT|); and the mean-centred range histogram over ``n_bins`` equal
    bins.  Every DFT drops its DC magnitude.  Scans with no valid point get
    a zero descriptor (cosine 0 against everything)."""
    bins = k10.bin_points(points, point_mask, range_max, n_sectors, n_rings,
                          n_bins)
    return k10.spectra(bins, range_max, n_sectors, n_rings, n_bins)


def search_dense(desc, valid, query_idx: int, k: int = 8,
                 rolling_exclude: int = 10):
    """The k most similar earlier keyframes of one query.

    desc [N, B] descriptor table, valid [N] mask of real keyframes;
    candidates satisfy ``i <= query_idx - rolling_exclude`` (the rolling
    window is excluded, src/ndt_mapper.cpp:613-615).  Returns (indices
    [k], scores [k]); empty slots score -inf."""
    limit = torch.tensor([query_idx - rolling_exclude], dtype=torch.int32,
                         device=desc.device)
    idx, scores = descriptor_search.top_k(
        desc[query_idx:query_idx + 1], desc, valid, limit,
        min(k, desc.shape[0]))
    return idx[0], scores[0]


def search_all_pairs(desc, valid, k: int = 8, rolling_exclude: int = 10):
    """Every keyframe's top-k in one launch: row q equals ``search_dense``
    at q.  Descriptors depend only on scan points, which acceptances never
    change, so one table a pass serves every query of it.  Returns (indices
    [N, k], scores [N, k])."""
    n = desc.shape[0]
    limit = torch.arange(n, dtype=torch.int32, device=desc.device) \
        - rolling_exclude
    return descriptor_search.top_k(desc, desc, valid, limit, min(k, n))



def search_all_pairs_multichip(mesh, desc, valid, k: int = 8,
                               rolling_exclude: int = 10):
    """``search_all_pairs`` with the query rows sharded over the mesh's
    ``batch`` axis (loop_search.py:180): each rank searches its contiguous
    block of query rows against the whole table in one K10 launch, and
    the blocks are all-gathered in rank order.  A row's result does not
    depend on the other rows, so every row equals the
    single-device search's bitwise.  The row count must divide over the
    shards (``pad_descriptors``).  Unlike the JAX mesh search, a query row
    of a padding keyframe is searched like any other (its rows are never
    read)."""
    n = desc.shape[0]
    S, s = axis_size(mesh, BATCH_AXIS), axis_rank(mesh, BATCH_AXIS)
    if n % S:
        raise ValueError(f"keyframe capacity {n} must divide the 'batch' "
                         f"shard count {S}")
    m = n // S
    limit = (torch.arange(s * m, (s + 1) * m, dtype=torch.int32,
                          device=desc.device) - rolling_exclude)
    idx, scores = descriptor_search.top_k(desc[s * m:(s + 1) * m], desc,
                                          valid, limit, min(k, n))
    group = axis_group(mesh, BATCH_AXIS)
    idx = distributed.gather(idx, group).reshape(n, -1)
    scores = distributed.gather(scores, group).reshape(n, -1)
    return idx, scores


def pad_descriptors(desc, valid, n_shards: int):
    """The descriptor table and its valid mask padded with invalid rows to
    a multiple of the shard count (loop_search.py:219); host numpy or
    tensors in, the same kind out."""
    n = desc.shape[0]
    n_pad = -(-n // n_shards) * n_shards
    if n_pad == n:
        return desc, valid
    if isinstance(desc, torch.Tensor):
        d = torch.zeros(n_pad, desc.shape[1], dtype=desc.dtype,
                        device=desc.device)
        v = torch.zeros(n_pad, dtype=torch.bool, device=valid.device)
    else:
        d = np.zeros((n_pad, desc.shape[1]), desc.dtype)
        v = np.zeros(n_pad, bool)
    d[:n] = desc
    v[:n] = valid
    return d, v
