"""K10 (search): cosine similarities of descriptor rows and the k best per
query (CUDA ``csrc/descriptor_search.cu``) and its plain-PyTorch twin.

Replaces the product, eligibility mask and row-wise top-k of
``ndt_2d_tpu/parallel/loop_search.py::search_all_pairs`` and
``::search_dense``.  Per query row q the similarity to key j is the sum of
``query[q, b] * keys[j, b]`` over b in order from 0, set to -inf unless
``valid[j]`` and ``j <= limit[q]``; the k largest come out in descending
order, equal values in ascending j (``jax.lax.top_k``'s order).

A similarity has one summation order whatever the launch, in the kernel and
in the twin, so a row's bits do not depend on how many rows are asked for:
the all-pairs search and the one-query search agree exactly.

On the card a call is two launches: tiles of 64 query rows x 64 keys write
the masked similarities to a scratch [Nq, Nk] buffer, skipping the tiles
whose keys all lie above their rows' limits (``plan``, ``tiles_run``);
then a warp a query row takes its k best.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ndt_2d_tpu_torch.kernels import _build

launches = 0

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
         + [ctypes.c_void_p] * 4)
TILE = 64            # query rows and keys of a similarity tile
MAX_QUERY_TILES = 65535


def plan(Nq: int, Nk: int, B: int, query_ptr: int, keys_ptr: int):
    """The similarity launch: (vec, key tiles, query tiles).  ``vec`` when
    B is a multiple of 4 and both tables are 16-byte aligned (16-byte
    copies into shared memory, else 4-byte ones); a grid of ``TILE`` x
    ``TILE`` tiles over [Nq, Nk]."""
    vec = B % 4 == 0 and query_ptr % 16 == 0 and keys_ptr % 16 == 0
    return int(vec), -(-Nk // TILE), -(-Nq // TILE)


def tiles_run(limit, Nk: int):
    """[query tiles, key tiles] bool: the similarity tiles the kernel
    computes.  Tile (a, b) is skipped when its first key, b * TILE, lies
    above the largest limit of its rows a * TILE .. (a + 1) * TILE - 1;
    the top-k reads only keys j <= limit[q]."""
    limit = np.asarray(limit, np.int64)
    pad = -len(limit) % TILE
    top = np.concatenate([limit, np.full(pad, np.iinfo(np.int64).min)])
    top = top.reshape(-1, TILE).max(axis=1)
    first = np.arange(-(-Nk // TILE)) * TILE
    return first[None, :] <= top[:, None]


def similarities_twin(query, keys):
    """[Nq, Nk] dot products of query [Nq, B] and keys [Nk, B] rows, each
    adding its B products in index order from 0."""
    acc = torch.zeros(query.shape[0], keys.shape[0], dtype=torch.float32,
                      device=query.device)
    for b in range(query.shape[1]):
        acc = acc + query[:, b, None] * keys[None, :, b]
    return acc


def top_k_twin(query, keys, valid, limit, k: int):
    """Plain-PyTorch ``top_k``: (indices [Nq, k] int64, scores [Nq, k])."""
    sims = similarities_twin(query, keys)
    j = torch.arange(keys.shape[0], device=keys.device)
    eligible = valid[None, :] & (j[None, :] <= limit[:, None])
    sims = torch.where(eligible, sims, torch.full_like(sims, -math.inf))
    scores, idx = torch.sort(sims, dim=-1, descending=True, stable=True)
    return idx[:, :k], scores[:, :k]


def top_k(query, keys, valid, limit, k: int):
    """The k most similar eligible keys of every query row.

    query [Nq, B] and keys [Nk, B] float32 (finite), valid [Nk] bool, limit
    [Nq] int32: key j is eligible for row q when ``valid[j]`` and ``j <=
    limit[q]``.  Returns (indices [Nq, k] int64, scores [Nq, k]); slots
    beyond the eligible keys score -inf.  ``1 <= k <= Nk``.  CPU tensors run
    the twin; CUDA tensors launch the kernels."""
    global launches
    Nq, B = query.shape
    Nk = keys.shape[0]
    if not 1 <= k <= Nk:
        raise ValueError(f"k = {k} outside 1 .. {Nk}")
    if query.device.type == "cpu":
        return top_k_twin(query, keys, valid, limit, k)
    dev = query.device
    _build.require(query, "query", torch.float32, (Nq, B), dev)
    _build.require(keys, "keys", torch.float32, (Nk, B), dev)
    _build.require(valid, "valid", torch.bool, (Nk,), dev)
    _build.require(limit, "limit", torch.int32, (Nq,), dev)
    qp, kp = query.data_ptr(), keys.data_ptr()
    vec, key_tiles, query_tiles = plan(Nq, Nk, B, qp, kp)
    if query_tiles > MAX_QUERY_TILES:
        raise ValueError(f"{Nq} query rows are outside the kernel's range")
    sims = torch.empty(Nq, Nk, dtype=torch.float32, device=dev)
    idx = torch.empty(Nq, k, dtype=torch.int64, device=dev)
    scores = torch.empty(Nq, k, dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _build.function("ndt2d_descriptor_top_k", _ARGS)(
        qp, kp, p(valid), p(limit), Nq, Nk, B, k, vec, key_tiles,
        query_tiles, p(sims), p(idx), p(scores), _build.stream_ptr(dev))
    _build.check(err, "descriptor_top_k")
    launches += 1
    return idx, scores
