"""K9's cooperative launch plan (``kernels/particle_filter.py::plan``) and
what the chain kernel does with it, which the CPU can check.  The kernel
runs only on the card, where ``chip_smoke.py`` holds it bitwise against
its unchanged twins (``resample_twin``, ``ewma_twin``,
``statistics_twin``); here numpy models of the kernel's order are held to
the twins' helpers:

* the fold: thread t of 256 loads chunk sums t + 256 k (k < 4), folds the
  levels 512 and 256 in registers, 128 .. 32 in shared memory and 16 .. 1
  by shuffles (every lane adds, only lane 0's total is read), which is
  ``_tree``;
* block ownership: block b of ``blocks`` stages its cpb * L items and
  thread q < cpb adds chunk b cpb + q in order from 0, which is the
  twin's chunking (``block_sum``), and the CDF's chunk runs offset by the
  scan of the chunk totals (``_cdf``);
* the scan: two buffers, x_i + (i >= off ? x_{i - off} : 0), which is
  ``_scan``; the prefix count of the marks (per block, then per chunk)
  equals a cumulative sum, and the KLD count from it ``kld_count``;
* the draw: the fixed-step halving search over the staged CDF, which is
  ``searchsorted_left``;
* the plan: its chunks cover every particle once and a block's shared
  memory fits in 227 KB at every particle count the filter runs; against
  a model of an H100's co-residency its blocks fit at once, from a few
  particles to millions (more chunks a block, then the items in device
  memory), and where the card holds the first plan it is kept.

Tolerances: none; every comparison is bitwise.
"""

import numpy as np
import pytest
import torch

from ndt_2d_tpu_torch.kernels import particle_filter as k9

torch.set_num_threads(2)

COUNTS = [1, 31, 1024, 1025, 5000, 20_000]


def terms(M, seed, positive=False):
    """M float32 values over six decades, with exact zeros of both signs
    (positive: non-negative, as weights)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1, M) * 10.0 ** rng.integers(-3, 4, M)).astype(
        np.float32)
    if positive:
        x = np.abs(x)
    zero = rng.random(M) < 0.1
    x[zero] = np.where(rng.random(int(zero.sum())) < 0.5, np.float32(0.0),
                       np.float32(-0.0 if not positive else 0.0))
    return x


def fold_model(part):
    """pf_chain's fold of the 1024 chunk sums: 4 a thread in registers,
    then shared memory, then the warp's shuffle tail."""
    T = k9.THREADS
    v = part.reshape(4, T).copy()          # v[k][t] = part[t + T k]
    v[0] = v[0] + v[2]                     # level 512
    v[1] = v[1] + v[3]
    v[0] = v[0] + v[1]                     # level 256
    sc = v[0].copy()
    h = T // 2
    while h >= 32:                         # levels 128, 64, 32
        sc[:h] = sc[:h] + sc[h:2 * h]
        h //= 2
    lanes = sc[:32].copy()
    for off in (16, 8, 4, 2, 1):           # every lane adds its shuffle
        shifted = np.concatenate([lanes[off:], lanes[:off]])
        lanes = lanes + shifted
    return lanes[0]


def chunk_sums_model(x, pl):
    """pf_chain's chunk sums: block b's items [b items, ...) staged; thread
    q < cpb adds local items q L .. q L + L - 1 below the block's count."""
    M = x.shape[0]
    part = np.zeros(k9.BLOCK, np.float32)
    for b in range(pl.blocks):
        base = b * pl.items
        nb = max(0, min(pl.items, M - base))
        staged = x[base:base + nb]
        acc = np.zeros(pl.cpb, np.float32)
        for k in range(pl.L):
            idx = np.arange(pl.cpb) * pl.L + k
            live = idx < nb
            acc[live] = acc[live] + staged[idx[live]]
        part[b * pl.cpb:(b + 1) * pl.cpb] = acc
    return part


def scan_model(v):
    """scan_chunks: two buffers, x_i + (i >= off ? x_{i - off} : 0)."""
    a = v.copy()
    off = 1
    while off < v.shape[0]:
        shifted = np.concatenate([np.zeros(off, np.float32), a[:-off]])
        a = a + shifted
        off *= 2
    return a


def cdf_model(p, pl):
    """The chain's CDF: each block's chunk runs (thread q of block b), the
    scan of the chunk totals, each item's chunk offset + its run."""
    M = p.shape[0]
    local = np.zeros(M, np.float32)
    totals = np.zeros(k9.BLOCK, np.float32)
    for b in range(pl.blocks):
        base = b * pl.items
        nb = max(0, min(pl.items, M - base))
        run = np.zeros(pl.cpb, np.float32)
        for k in range(pl.L):
            idx = np.arange(pl.cpb) * pl.L + k
            live = idx < nb
            run[live] = run[live] + p[base + idx[live]]
            local[base + idx[live]] = run[live]
        totals[b * pl.cpb:(b + 1) * pl.cpb] = run
    incl = scan_model(totals)
    chunk = np.arange(M) // pl.L
    offset = np.where(chunk > 0, incl[np.maximum(chunk - 1, 0)],
                      np.float32(0.0)).astype(np.float32)
    return offset + local


def search_model(cdf, r, levels):
    """search<true>: lo, hi = 0, M; mid = (lo + hi) / 2 unsigned; a fixed
    number of levels; the index clamped to M - 1."""
    M = cdf.shape[0]
    lo = np.zeros(r.shape, np.int64)
    hi = np.full(r.shape, M, np.int64)
    for _ in range(levels):
        mid = (lo + hi) // 2
        left = r <= cdf[mid]
        lo, hi = np.where(left, lo, mid), np.where(left, mid, hi)
    return np.minimum(hi, M - 1)


@pytest.mark.parametrize("kind", ["signed", "weights", "zeros"])
def test_fold_is_the_tree(kind):
    if kind == "zeros":
        part = np.where(np.arange(k9.BLOCK) % 3 == 0, np.float32(-0.0),
                        np.float32(0.0)).astype(np.float32)
    else:
        part = terms(k9.BLOCK, 7, positive=kind == "weights")
    want = k9._tree(torch.from_numpy(part)).numpy()
    assert np.float32(fold_model(part)).tobytes() == want.tobytes()


@pytest.mark.parametrize("M", COUNTS)
def test_block_ownership_is_block_sum(M):
    pl = k9.plan(M)
    x = terms(M, M)
    got = fold_model(chunk_sums_model(x, pl))
    want = k9.block_sum(torch.from_numpy(x)).numpy()
    assert np.float32(got).tobytes() == want.tobytes()


@pytest.mark.parametrize("M", COUNTS)
def test_block_ownership_is_the_cdf(M):
    pl = k9.plan(M)
    w = terms(M, M + 1, positive=True)
    n = max(1, (3 * M) // 4)
    mask = torch.arange(M) < n
    p = k9._normalized(torch.from_numpy(w), mask, n)
    want = k9._cdf(p).numpy()
    assert cdf_model(p.numpy(), pl).tobytes() == want.tobytes()


def test_scan_is_hillis_steele():
    v = terms(k9.BLOCK, 3, positive=True)
    want = k9._scan(torch.from_numpy(v)).numpy()
    assert scan_model(v).tobytes() == want.tobytes()


@pytest.mark.parametrize("M", [31, 5000, 20_000])
def test_prefix_count_and_kld(M):
    """The marks' prefix count k(m) as the kernel forms it (block counts,
    then chunk counts, then a chunk's run) is the cumulative sum, and the
    first m with m >= min_particles and m >= Mx(k(m)) is ``kld_count``."""
    pl = k9.plan(M)
    rng = np.random.default_rng(M)
    marks = rng.random(M) < 0.05
    marks[0] = True
    k = np.zeros(M, np.int64)
    block_counts = [int(marks[b * pl.items:(b + 1) * pl.items].sum())
                    for b in range(pl.blocks)]
    for b in range(pl.blocks):
        before = sum(block_counts[:b])
        base = b * pl.items
        for q in range(pl.cpb):
            lo = base + q * pl.L
            hi = min(lo + pl.L, M)
            run = before + int(marks[base:lo].sum())
            for i in range(lo, hi):
                run += int(marks[i])
                k[i] = run
    assert np.array_equal(k, np.cumsum(marks))
    first = torch.from_numpy(marks)
    kt = torch.from_numpy(k).to(torch.int32)
    kf = kt.to(torch.float32)
    a = (kf - 1.0) / (2.0 * torch.tensor(0.01, dtype=torch.float32))
    b = 2.0 / (9.0 * torch.clamp(kf - 1.0, min=1.0))
    c = 1.0 - b + torch.sqrt(b) * torch.tensor(2.3, dtype=torch.float32)
    mx = torch.where(kt > 1, torch.floor(a * c * c * c).to(torch.int32),
                     torch.full_like(kt, M))
    m = torch.arange(1, M + 1)
    done = ((m >= 10) & (m >= mx)).numpy()
    n = int(np.argmax(done)) + 1 if done.any() else M
    assert n == k9.kld_count(first, 0.01, 2.3, 10)


@pytest.mark.parametrize("M", COUNTS)
def test_staged_search_is_searchsorted_left(M):
    rng = np.random.default_rng(M + 2)
    w = terms(M, M + 3, positive=True)
    p = k9._normalized(torch.from_numpy(w), torch.ones(M, dtype=torch.bool),
                       M)
    cdf = k9._cdf(p)
    u = rng.random(M).astype(np.float32)
    u[:3] = [0.0, np.float32(1.0) - np.finfo(np.float32).epsneg, 0.5][:M]
    r = cdf[-1] * (1.0 - torch.from_numpy(u))
    levels = int(np.ceil(np.log2(M + 1)))
    want = k9.searchsorted_left(cdf, r).numpy()
    assert np.array_equal(search_model(cdf.numpy(), r.numpy(), levels), want)
    # Not monotone (a NaN-free shuffle): the same fixed steps still agree.
    shuffled = cdf[torch.from_numpy(rng.permutation(M))]
    assert np.array_equal(
        search_model(shuffled.numpy(), r.numpy(), levels),
        k9.searchsorted_left(shuffled, r).numpy())


@pytest.mark.parametrize("M", COUNTS + [500, 100_000])
def test_plan_covers_and_fits(M):
    pl = k9.plan(M)
    assert pl.blocks * pl.cpb == k9.BLOCK
    assert pl.items == pl.cpb * pl.L and pl.L * k9.BLOCK >= M
    assert pl.L == -(-M // k9.BLOCK)
    assert pl.items <= max(k9.THREADS, pl.L)
    items = np.concatenate([np.arange(b * pl.items,
                                      min((b + 1) * pl.items, M))
                            for b in range(pl.blocks)])
    assert np.array_equal(items, np.arange(M))
    assert pl.smem == k9.chain_smem(M, pl.cpb, pl.items, bool(pl.staged),
                                    bool(pl.spill))
    assert pl.smem + k9.SMEM_STATIC <= k9.SMEM_LIMIT
    if M <= 20_000:
        assert pl.staged  # the draw searches the CDF in shared memory
        assert not pl.spill
    with pytest.raises(ValueError):
        k9.plan(0)


def h100_fits(smem):
    """A model of an H100's co-residency for the chain: 132 SMs of 228 KB
    of shared memory (1 KB of it reserved a block), at most 6 blocks of 256
    threads an SM (40 registers a thread)."""
    return 132 * min(6, 233472 // (smem + 1024))


@pytest.mark.parametrize("M", COUNTS + [40_000, 131_073, 200_000, 1_000_000,
                                        4_000_000])
def test_plan_fits_the_card(M):
    pl = k9.plan(M, h100_fits)
    assert pl.blocks <= h100_fits(pl.smem)
    assert pl.blocks * pl.cpb == k9.BLOCK and pl.items == pl.cpb * pl.L
    assert pl.L == -(-M // k9.BLOCK)
    assert pl.smem == k9.chain_smem(M, pl.cpb, pl.items, bool(pl.staged),
                                    bool(pl.spill))
    assert pl.smem + k9.SMEM_STATIC <= k9.SMEM_LIMIT
    first = k9.plan(M)
    if first.blocks <= h100_fits(first.smem):
        assert pl == first  # a plan the card holds is kept as it is
    else:
        assert pl.cpb > first.cpb
    if M <= 20_000:  # the filter's counts: one launch as planned
        assert pl == first and pl.staged and not pl.spill
    if M >= 1_000_000:  # the items no longer fit beside the rest
        assert pl.spill and not pl.staged


def test_plan_raises_where_no_block_fits():
    with pytest.raises(ValueError):
        k9.plan(5000, lambda smem: 0)


@pytest.mark.parametrize("M", [40_000, 200_000, 1_000_000])
def test_fitted_plan_ownership(M):
    """The plans the card's co-residency forces (more chunks a block, the
    items in device memory) add in the twin's order: ``block_sum`` and
    ``_cdf``."""
    pl = k9.plan(M, h100_fits)
    x = terms(M, M)
    got = fold_model(chunk_sums_model(x, pl))
    want = k9.block_sum(torch.from_numpy(x)).numpy()
    assert np.float32(got).tobytes() == want.tobytes()
    w = terms(M, M + 1, positive=True)
    p = k9._normalized(torch.from_numpy(w), torch.ones(M, dtype=torch.bool),
                       M)
    assert cdf_model(p.numpy(), pl).tobytes() == k9._cdf(p).numpy().tobytes()
