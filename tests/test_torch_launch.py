"""The Python around the port's kernels that the CPU can check: the launch
geometry of ``rank_sum`` (K12), the tile plan of the K10 similarity
kernel, and ``kernels/_build.py``'s binding of C functions.  The kernels
themselves run only on the card (``chip_smoke.py`` holds each bitwise
against its twin); here their twins are held to plain references and to
the JAX package's search.

Tolerances: none.  Coverage is exact integer arithmetic, the twins add in
one fixed order, and the table held against JAX's search has entries that
make every similarity exact, so every comparison is bitwise.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu.parallel import loop_search as jax_search
from ndt_2d_tpu_torch.kernels import _build
from ndt_2d_tpu_torch.kernels import descriptor_search as ks
from ndt_2d_tpu_torch.kernels import shard_combine
from ndt_2d_tpu_torch.parallel import loop_search

torch.set_num_threads(2)


def T(x):
    return torch.from_numpy(np.array(x))


def covered(n, width, units, blocks):
    """How often each of n elements is touched by ``rank_sum``'s grid:
    thread i of ``blocks`` x THREADS takes units i, i + blocks x THREADS,
    ... below ``units``, each ``width`` elements wide."""
    hits = np.zeros(n, np.int64)
    stride = blocks * shard_combine.THREADS
    for first in range(stride):
        for u in range(first, units, stride):
            hits[u * width:(u + 1) * width] += 1
    return hits


@pytest.mark.parametrize("misaligned", [False, True])
def test_rank_sum_geometry_covers_every_element_once(misaligned):
    """n from 1 to a few thousand, n % 4 both zero and not; a misaligned
    pointer takes one float a load.  Few SMs so the threads stride."""
    x_ptr, out_ptr = 1 << 20, (1 << 21) + (4 if misaligned else 0)
    for n in list(range(1, 70)) + [255, 256, 257, 1023, 1024, 2049, 4096,
                                   4099]:
        for sms in (1, 3, 132):
            width, units, blocks = shard_combine.geometry(n, x_ptr, out_ptr,
                                                          sms)
            assert width == (4 if n % 4 == 0 and not misaligned else 1)
            assert units * width == n and 1 <= blocks <= 4 * sms
            assert (covered(n, width, units, blocks) == 1).all(), (n, sms)


def test_rank_sum_twin_adds_in_rank_order():
    """S = 3, n = 4099 (no multiple of 4), on a view one float into its
    buffer: the twin's bits are the left-to-right float32 sum."""
    rng = np.random.default_rng(3)
    buf = rng.normal(size=3 * 4099 + 1).astype(np.float32)
    buf[1:4100] *= 1e6
    x = T(buf)[1:].view(3, 4099)
    want = (buf[1:4100] + buf[4100:8199]) + buf[8199:]
    got = shard_combine.rank_sum(x)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("Nq,Nk,seed", [(37, 1000, 0), (1, 1000, 1),
                                        (130, 129, 2), (64, 65, 3)])
def test_search_tile_plan_leaves_out_no_eligible_pair(Nq, Nk, seed):
    """Random limits, some negative, some past the table: every (q, j)
    with j <= limit[q] and j < Nk lies in a tile the grid holds and the
    kernel computes."""
    rng = np.random.default_rng(seed)
    limit = rng.integers(-70, Nk + 70, size=Nq)
    vec, key_tiles, query_tiles = ks.plan(Nq, Nk, 192, 1 << 20, 1 << 21)
    run = ks.tiles_run(limit, Nk)
    assert vec == 1 and run.shape == (query_tiles, key_tiles)
    assert key_tiles * ks.TILE >= Nk > (key_tiles - 1) * ks.TILE
    assert query_tiles * ks.TILE >= Nq > (query_tiles - 1) * ks.TILE
    q, j = np.nonzero(np.arange(Nk)[None, :] <= limit[:, None])
    assert run[q // ks.TILE, j // ks.TILE].all()
    # Skipped tiles hold only pairs above every limit of their rows.
    a, b = np.nonzero(~run)
    for qa, kb in zip(a, b):
        assert limit[qa * ks.TILE:(qa + 1) * ks.TILE].max() < kb * ks.TILE


def test_search_plan_takes_16_byte_copies_only_when_it_can():
    assert ks.plan(5, 9, 192, 1 << 20, 1 << 21)[0] == 1
    assert ks.plan(5, 9, 190, 1 << 20, 1 << 21)[0] == 0
    assert ks.plan(5, 9, 192, (1 << 20) + 4, 1 << 21)[0] == 0
    assert ks.plan(5, 9, 192, 1 << 20, (1 << 21) + 8)[0] == 0


class _StandInLibrary:
    """Counts attribute lookups, as a loaded ``ctypes.CDLL`` would serve
    them, and hands out one function object per name."""

    def __init__(self):
        self.lookups = []
        self.fns = {}

    def __getattr__(self, name):
        self.lookups.append(name)
        return self.fns.setdefault(name, type("Fn", (), {})())


def test_function_binds_each_c_function_once(monkeypatch):
    lib = _StandInLibrary()
    monkeypatch.setattr(_build._STATE, "lib", lib)
    monkeypatch.setattr(_build._STATE, "funcs", {})
    args = [ctypes.c_void_p, ctypes.c_int]
    first = _build.function("ndt2d_rank_sum", args)
    assert first.argtypes == args and first.restype is ctypes.c_int
    first.argtypes = "left alone"          # a second call must not re-set it
    for _ in range(3):
        assert _build.function("ndt2d_rank_sum", args) is first
    assert first.argtypes == "left alone"
    assert lib.lookups == ["ndt2d_rank_sum"]
    _build.function("ndt2d_descriptor_top_k", args)
    assert lib.lookups == ["ndt2d_rank_sum", "ndt2d_descriptor_top_k"]


def test_pointers_cross_as_ints():
    t = torch.zeros(3)
    assert _build.ptr(t) == t.data_ptr() and isinstance(_build.ptr(t), int)


def odd_table(B=190, Nk=1000, seed=5, ties=(7, 300, 301, 999), of=123):
    """Keys with exact ties (rows ``ties`` repeat row ``of``), a tenth
    invalid but the tied rows."""
    rng = np.random.default_rng(seed)
    keys = rng.normal(size=(Nk, B)).astype(np.float32)
    keys[list(ties)] = keys[of]
    valid = rng.random(Nk) > 0.1
    valid[[*ties, of]] = True
    return keys, valid


def test_top_k_twin_rows_do_not_depend_on_the_launch():
    """The odd shape of the card's check: 37 queries (four of them keys
    with tied copies), 1000 keys, k = 8, negative limits; each row equals
    a one-row call of it bitwise."""
    keys, valid = odd_table()
    rng = np.random.default_rng(6)
    query = rng.normal(size=(37, keys.shape[1])).astype(np.float32)
    query[:4] = keys[123]
    limit = rng.integers(-20, 1100, size=37).astype(np.int32)
    limit[:4] = [999, 301, 5, -3]
    idx, sc = ks.top_k(T(query), T(keys), T(valid), T(limit), 8)
    assert idx[0, :5].tolist() == [7, 123, 300, 301, 999]
    assert idx[1, :4].tolist() == [7, 123, 300, 301]
    assert idx[3].tolist() == list(range(8))
    assert bool(torch.isinf(sc[3]).all())
    for q in (0, 1, 2, 3, 17, 36):
        i1, s1 = ks.top_k(T(query[q:q + 1]), T(keys), T(valid),
                          T(limit[q:q + 1]), 8)
        assert torch.equal(i1[0], idx[q]) and torch.equal(s1[0], sc[q])


def test_top_k_twin_matches_jax_search_with_ties_and_short_rows():
    """``search_all_pairs`` / ``search_dense`` on the twin against the JAX
    package's on a table whose entries are multiples of 1/8 in [-2, 2], so
    every similarity is exact in float32 whatever the order of its sum:
    scores bitwise, and the many exact ties (repeated rows, equal sums)
    break to the lower index in both; invalid rows and rows with fewer
    eligible keys than k included."""
    rng = np.random.default_rng(8)
    keys = (rng.integers(-16, 17, size=(96, 192)) / 8).astype(np.float32)
    keys[[40, 41, 95]] = keys[23]
    keys[60:64] = 0.0
    valid = rng.random(96) > 0.1
    j_idx, j_sc = jax_search.search_all_pairs(
        jnp.asarray(keys), jnp.asarray(valid), k=8, rolling_exclude=3)
    idx, sc = loop_search.search_all_pairs(T(keys), T(valid), k=8,
                                           rolling_exclude=3)
    np.testing.assert_array_equal(sc.numpy(), np.asarray(j_sc))
    finite = np.isfinite(np.asarray(j_sc))
    assert 0 < finite.sum() < finite.size
    np.testing.assert_array_equal(idx.numpy()[finite],
                                  np.asarray(j_idx)[finite])
    for q in (0, 3, 4, 10, 41, 63, 95):
        qi, qs = loop_search.search_dense(T(keys), T(valid), q, k=8,
                                          rolling_exclude=3)
        jqi, jqs = jax_search.search_dense(jnp.asarray(keys),
                                           jnp.asarray(valid), q, k=8,
                                           rolling_exclude=3)
        assert torch.equal(qi, idx[q]) and torch.equal(qs, sc[q])
        np.testing.assert_array_equal(qs.numpy(), np.asarray(jqs))
