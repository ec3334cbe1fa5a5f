"""K9: the particle filter's motion sample, KLD resample, recovery injection
and statistics (CUDA ``csrc/particle_filter.cu``) and their twins.

Replaces the jitted hot loop of ``ndt_2d_tpu/filter/motion_model.py::
sample`` and ``ndt_2d_tpu/filter/particle_filter.py::normalize_weights``,
``kld_resample``, ``inject_free_space`` and ``update_statistics`` (fused in
``pf_step`` / ``pf_step_recovery``).  Three entries:

* ``motion``: the per-particle rot-trans-rot sample, given standard normals
  and the host's motion scalars (``filter/motion_model.py``), launched
  through a ``MotionPlan``: the mesh's filter step and
  ``ParticleFilter.update``; on one device the step folds the same body
  into K3's particle launch (``score_points.motion_score``);
* ``resample``: normalize + CDF, the ``jax.random.choice`` draw (searchsorted
  left on r = cdf[-1] * (1 - u)), truncated bin keys, first occurrence per
  bin in draw order, the prefix count k(m), the KLD bound and n_active;
  with recovery the w_slow/w_fast EWMAs and the free-space injection; then
  the statistics.  One cooperative launch (``plan``, sized by what the
  card holds co-resident), no host sync;
* ``statistics``: ``update_statistics`` alone (or after an injection);
* ``ewma``: the recovery EWMAs alone (``ParticleFilter.measure``), the
  resample's first phase.

The random numbers come in as tensors.  Every float sum is taken in the
kernel's fixed order (``block_sum``, ``_cdf``): the twins add in that
order, find first occurrences as the reference does (lexsort +
segment-min), and so agree with the kernels bitwise on the card.  The
kernel's scratch is kept per (M, device, stream) and reused by the calls
on that stream, which run in order; its outputs are new tensors every
call.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple, Optional

import torch

from ndt_2d_tpu_torch.core.pose import normalize_angle_exact
from ndt_2d_tpu_torch.kernels import _build
from ndt_2d_tpu_torch.ndt.grid import f32

launches = {"pf_motion": 0, "pf_resample": 0, "pf_statistics": 0,
            "pf_ewma": 0}

BLOCK = 1024  # chunks of every sum: the twin's and the kernel's order
THREADS = 256  # threads a block of the cooperative chain
SUMS = 7  # the most sums one stage of the chain folds together
REGIONS = 13  # stages of the chain with a region of chunk sums each
SMEM_LIMIT = 232448  # shared memory a block may use on an H100 (227 KB)
SMEM_STATIC = 36  # the chain's static shared memory (block reductions)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PLAN = [_P] + [_I] * 6  # the spill scratch, then ChainPlan's ints
_FIT_ARGS = [_I, ctypes.POINTER(_I)]
_MOTION_ARGS = [_P, _P, _I] + [_F] * 6 + [_P, _P]
_RESAMPLE_ARGS = ([_P] * 4 + [_I] * 2 + [_F] * 5 + [_I] * 3 + [_F] * 2
                  + [_P] * 3 + [_F] + [_P] * 4 + [_P] * 5 + [_I] + [_P] * 8
                  + _PLAN + [_P])
_STATS_ARGS = ([_P] * 3 + [_I] * 2 + [_P] * 2 + [_F] + [_P] * 4 + [_P] * 6
               + _PLAN + [_P])
_EWMA_ARGS = [_P, _P, _I, _F, _F] + [_P] * 3 + _PLAN + [_P]


class Injection(NamedTuple):
    """AMCL recovery injection: the free-space pool and its draws."""

    free_xy: torch.Tensor   # [F, 2] f32 free-cell centers
    free_cell: float        # jitter scale (the cell size)
    u_sel: torch.Tensor     # [M] f32 uniforms in [0, 1): inject if < p
    idx: torch.Tensor       # [M] int32 pool indices in [0, F)
    jitter: torch.Tensor    # [M, 2] f32 uniforms in [-0.5, 0.5)
    theta: torch.Tensor     # [M] f32 uniforms in [-pi, pi)


class Recovery(NamedTuple):
    """The w_slow/w_fast state and gains of a recovery resample."""

    w_state: torch.Tensor   # [2] f32 (w_slow, w_fast); 0 = unset
    alpha_slow: float
    alpha_fast: float
    ewma: bool              # update the EWMAs from these weights first
    injection: Injection


class Resampled(NamedTuple):
    """What ``resample`` and ``statistics`` return, all on the device."""

    particles: torch.Tensor   # [M, 3] drawn (and injected) particles
    weights: torch.Tensor     # [M] raw weights (injected: the neutral one)
    normalized: torch.Tensor  # [M] update_statistics weights
    n: torch.Tensor           # [1] int32 n_active
    stats: torch.Tensor       # [13] f32: n, mean [3], cov [3, 3] row-major
    w_state: Optional[torch.Tensor] = None  # [2] after a recovery resample
    idx: Optional[torch.Tensor] = None      # [M] int32 drawn indices
    marks: Optional[torch.Tensor] = None    # [M] bool first occurrences


# --- the kernels' summation orders, as plain torch --------------------------
def _chunks(x):
    """[M] -> [BLOCK, L] zero-padded: row t is thread t's chunk
    [tL, tL + L), L = ceil(M / BLOCK)."""
    L = max(-(-x.shape[0] // BLOCK), 1)
    pad = x.new_zeros(BLOCK * L - x.shape[0])
    return torch.cat([x, pad]).reshape(BLOCK, L)


def _tree(v):
    """The halving tree over BLOCK partials; returns a 0-d tensor."""
    w = BLOCK // 2
    while w:
        v = v[:w] + v[w:2 * w]
        w //= 2
    return v[0]


def _scan(v):
    """Inclusive Hillis-Steele scan over BLOCK values."""
    off = 1
    while off < BLOCK:
        v = v + torch.cat([v.new_zeros(off), v[:-off]])
        off *= 2
    return v


def block_sum(x):
    """Sum of [M] terms in the single-block kernels' order: each thread
    sums its chunk from 0, then the halving tree."""
    rows = _chunks(x)
    acc = rows.new_zeros(BLOCK)
    for j in range(rows.shape[1]):
        acc = acc + rows[:, j]
    return _tree(acc)


def _normalized(w, mask, n: int):
    """normalize_weights: masked w / total, or uniform over the mask when
    the total is 0."""
    wm = torch.where(mask, w, torch.zeros_like(w))
    total = block_sum(wm)
    uni = f32(1.0, w.device) / f32(float(max(n, 1)), w.device)
    return torch.where(total != 0, wm / total,
                       torch.where(mask, uni, torch.zeros_like(w)))


def _cdf(p):
    """Inclusive CDF of [M] in the kernel's order: running sums per chunk,
    then each chunk offset by the scan of the chunk totals."""
    rows = _chunks(p)
    run = rows.new_zeros(BLOCK)
    local = []
    for j in range(rows.shape[1]):
        run = run + rows[:, j]
        local.append(run)
    incl = _scan(run)
    offset = torch.cat([incl.new_zeros(1), incl[:-1]])
    return (offset[:, None] + torch.stack(local, 1)).reshape(-1)[:p.shape[0]]


def searchsorted_left(cdf, r):
    """``jnp.searchsorted(cdf, r)`` (its 'scan' method, side left): the
    same fixed number of halving steps, so unsorted input picks the same
    index too; the index is clamped to the array as a gather clamps."""
    M = cdf.shape[0]
    lo = torch.zeros_like(r, dtype=torch.int64)
    hi = torch.full_like(lo, M)
    for _ in range(int(math.ceil(math.log2(M + 1)))):
        mid = (lo + hi) // 2
        left = r <= cdf[mid]
        lo, hi = torch.where(left, lo, mid), torch.where(left, mid, hi)
    return torch.clamp(hi, max=M - 1)


def first_occurrence(keys):
    """[M] bool: draw m is the first of its bin key in draw order (the
    reference's lexsort + segment-min)."""
    M = keys.shape[0]
    order = torch.argsort(keys[:, 2], stable=True)
    order = order[torch.argsort(keys[order, 1], stable=True)]
    order = order[torch.argsort(keys[order, 0], stable=True)]
    ks = keys[order]
    new_group = torch.cat([torch.ones(1, dtype=torch.bool,
                                      device=keys.device),
                           (ks[1:] != ks[:-1]).any(-1)])
    gid = torch.cumsum(new_group.to(torch.int64), 0) - 1
    first_draw = torch.full((M,), M, dtype=torch.int64, device=keys.device)
    first_draw = first_draw.scatter_reduce(0, gid, order, "amin")
    first = torch.zeros(M, dtype=torch.bool, device=keys.device)
    first[order] = order == first_draw[gid]
    return first


def kld_count(first, kld_err: float, kld_z: float, min_particles: int):
    """n_active from the first-occurrence marks: the first m with
    m >= min_particles and m >= Mx(k(m)), else M."""
    M = first.shape[0]
    k = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32)
    kf = k.to(torch.float32)
    a = (kf - 1.0) / f32(2.0 * kld_err, first.device)
    b = f32(2.0, first.device) / (9.0 * torch.clamp(kf - 1.0, min=1.0))
    c = 1.0 - b + torch.sqrt(b) * kld_z
    mx = torch.floor(a * c * c * c).to(torch.int32)
    mx = torch.where(k > 1, mx, torch.full_like(mx, M))
    m = torch.arange(1, M + 1, device=first.device)
    done = (m >= min_particles) & (m >= mx)
    if not bool(done.any()):
        return M
    return int(torch.argmax(done.to(torch.int32))) + 1


# --- twins -------------------------------------------------------------------
def _f32(x) -> float:
    """A host scalar rounded to float32, as a kernel argument is."""
    return float(torch.tensor(float(x), dtype=torch.float32))


def motion_twin(particles, noise, scalars):
    """Plain-PyTorch motion sample: particles [M, 3], standard normals
    noise [M, 3], scalars (rot1, trans, rot2, sigma_rot1, sigma_trans,
    sigma_rot2) as float32 values."""
    rot1, trans, rot2, s1, st, s2 = scalars
    r1 = rot1 + noise[:, 0] * s1
    t = trans + noise[:, 1] * st
    r2 = rot2 + noise[:, 2] * s2
    a = particles[:, 2] + r1
    return torch.stack([particles[:, 0] + t * torch.cos(a),
                        particles[:, 1] + t * torch.sin(a),
                        normalize_angle_exact(a + r2)], dim=-1)


def _inject_twin(particles, w, mask, n: int, p_inject, inj: Injection):
    wm = torch.where(mask, w, torch.zeros_like(w))
    neutral = block_sum(wm) / f32(float(max(n, 1)), w.device)
    sel = (inj.u_sel < p_inject) & mask
    idx = inj.idx.to(torch.int64)
    rand = torch.stack([inj.free_xy[idx, 0] + inj.jitter[:, 0] * inj.free_cell,
                        inj.free_xy[idx, 1] + inj.jitter[:, 1] * inj.free_cell,
                        inj.theta], dim=-1)
    return (torch.where(sel[:, None], rand, particles),
            torch.where(sel, neutral, w))


def _statistics_twin(particles, w, mask, n: int):
    """update_statistics in the kernel's order: (normalized [M], stats
    [13])."""
    wn = _normalized(w, mask, n)
    x, y, t = particles[:, 0], particles[:, 1], particles[:, 2]
    px, py = wn * x, wn * y
    mx, my = block_sum(px), block_sum(py)
    scos, ssin = block_sum(wn * torch.cos(t)), block_sum(wn * torch.sin(t))
    r00, r01, r11 = block_sum(px * x), block_sum(px * y), block_sum(py * y)
    mth = torch.atan2(ssin, scos)
    d = normalize_angle_exact(mth - t)
    cth = block_sum(wn * d * d)
    z = torch.zeros_like(mx)
    stats = torch.stack([f32(float(n), w.device), mx, my, mth,
                         r00 - mx * mx, r01 - mx * my, z,
                         r01 - my * mx, r11 - my * my, z, z, z, cth])
    return wn, stats


def _ewma(weights, mask, n: int, w_state, alpha_slow: float,
          alpha_fast: float):
    """The w_slow/w_fast EWMAs [2] of the mean likelihood (the negated raw
    weights) over the mask; 0 = unset takes the mean itself."""
    good = torch.where(mask, -weights, torch.zeros_like(weights))
    w_avg = block_sum(good) / f32(float(max(n, 1)), weights.device)
    ws, wf = w_state[0], w_state[1]
    ws = torch.where(ws == 0, w_avg, ws + alpha_slow * (w_avg - ws))
    wf = torch.where(wf == 0, w_avg, wf + alpha_fast * (w_avg - wf))
    return torch.stack([ws, wf])


def ewma_twin(weights, n_in, w_state, alpha_slow: float,
              alpha_fast: float) -> torch.Tensor:
    """Plain-PyTorch ``ewma`` (same arguments)."""
    M = weights.shape[0]
    n = min(max(int(n_in.reshape(-1)[0]), 0), M)
    mask = torch.arange(M, device=weights.device) < n
    return _ewma(weights, mask, n, w_state, alpha_slow, alpha_fast)


def resample_twin(weights, n_in, uniforms, particles, bins, kld_err: float,
                  kld_z: float, min_particles: int,
                  recovery: Optional[Recovery] = None) -> Resampled:
    """Plain-PyTorch ``resample`` (same arguments)."""
    M = weights.shape[0]
    kld_err, kld_z = _f32(kld_err), _f32(kld_z)
    bins = torch.tensor([_f32(b) for b in bins], dtype=torch.float32,
                        device=weights.device)
    n0 = min(max(int(n_in.reshape(-1)[0]), 0), M)
    mask0 = torch.arange(M, device=weights.device) < n0
    cdf = _cdf(_normalized(weights, mask0, n0))
    w_state = p_inject = None
    if recovery is not None:
        w_state = recovery.w_state
        if recovery.ewma:
            w_state = _ewma(weights, mask0, n0, w_state,
                            recovery.alpha_slow, recovery.alpha_fast)
        else:
            w_state = w_state.clone()
        ws, wf = w_state[0], w_state[1]
        p_inject = torch.clamp(
            1.0 - wf / torch.clamp(ws, min=1e-30), min=0.0)
    idx = searchsorted_left(cdf, cdf[-1] * (1.0 - uniforms))
    samp, samp_w = particles[idx], weights[idx]
    keys = torch.trunc(samp / bins).to(torch.int32)
    marks = first_occurrence(keys)
    n = kld_count(marks, kld_err, kld_z, min_particles)
    mask = torch.arange(M, device=weights.device) < n
    if recovery is not None:
        samp, samp_w = _inject_twin(samp, samp_w, mask, n, p_inject,
                                    recovery.injection)
    wn, stats = _statistics_twin(samp, samp_w, mask, n)
    n_t = torch.tensor([n], dtype=torch.int32, device=weights.device)
    return Resampled(samp, samp_w, wn, n_t, stats, w_state,
                     idx.to(torch.int32), marks)


def statistics_twin(particles, weights, n_in,
                    injection: Optional[Injection] = None,
                    p_inject=None) -> Resampled:
    """Plain-PyTorch ``statistics`` (same arguments)."""
    M = weights.shape[0]
    n = min(max(int(n_in.reshape(-1)[0]), 0), M)
    mask = torch.arange(M, device=weights.device) < n
    if injection is not None:
        particles, weights = _inject_twin(particles, weights, mask, n,
                                          p_inject.reshape(()), injection)
    wn, stats = _statistics_twin(particles, weights, mask, n)
    n_t = torch.tensor([n], dtype=torch.int32, device=weights.device)
    return Resampled(particles, weights, wn, n_t, stats)


# --- kernels -----------------------------------------------------------------
def _inj_args(inj: Optional[Injection], M: int, dev) -> list:
    """The injection's kernel arguments: (free_xy, free_cell, u_sel, idx,
    jitter, theta)."""
    if inj is None:
        return [None, 0.0, None, None, None, None]
    F = inj.free_xy.shape[0]
    _build.require(inj.free_xy, "free_xy", torch.float32, (F, 2), dev)
    _build.require(inj.u_sel, "u_sel", torch.float32, (M,), dev)
    _build.require(inj.idx, "inject idx", torch.int32, (M,), dev)
    _build.require(inj.jitter, "jitter", torch.float32, (M, 2), dev)
    _build.require(inj.theta, "theta", torch.float32, (M,), dev)
    p = _build.ptr
    return [p(inj.free_xy), float(inj.free_cell), p(inj.u_sel), p(inj.idx),
            p(inj.jitter), p(inj.theta)]


class MotionPlan:
    """The motion launch at M particles on one device (``motion_plan``):
    the C function bound once and the (name, dtype, shape) of its two
    tensors; ``run`` checks them in one pass, allocates the moved
    particles and makes one ctypes call.  The body
    (``csrc/pf_motion.cuh``) is the one K3's particle launch folds in."""

    def __init__(self, M: int, dev):
        self.M, self.device = M, dev
        self.expect = (("particles", torch.float32, (M, 3)),
                       ("noise", torch.float32, (M, 3)))
        self._fn = None
        self._stream = None

    def run(self, particles, noise, scalars):
        _build.require_all(self.device, (particles, noise), self.expect)
        if self._fn is None:
            self._fn = _build.function("ndt2d_pf_motion", _MOTION_ARGS)
            self._stream = _build.stream_reader(self.device)
        out = particles.new_empty(self.M, 3)
        p = _build.ptr
        _build.check(self._fn(p(particles), p(noise), self.M, *scalars,
                              p(out), self._stream()), "pf_motion")
        return out


_MOTION_PLANS: dict = {}


def motion_plan(M: int, dev) -> MotionPlan:
    """The motion plan of M particles on ``dev``, made at its first
    launch."""
    plan = _MOTION_PLANS.get((M, dev))
    if plan is None:
        plan = _MOTION_PLANS[(M, dev)] = MotionPlan(M, dev)
    return plan


def motion(particles, noise, scalars):
    """Motion sample of particles [M, 3] f32 with standard normals noise
    [M, 3] f32 and the host scalars (rot1, trans, rot2, sigma_rot1,
    sigma_trans, sigma_rot2); returns new particles [M, 3].  CPU tensors
    run the twin; CUDA tensors launch the kernel (through its plan)."""
    if particles.device.type == "cpu":
        return motion_twin(particles, noise, scalars)
    out = motion_plan(particles.shape[0], particles.device).run(
        particles, noise, [float(s) for s in scalars])
    launches["pf_motion"] += 1
    return out


class ChainPlan(NamedTuple):
    """How the cooperative chain covers M particles: the BLOCK chunks of L
    items each, ``cpb`` consecutive chunks a block of THREADS threads,
    ``blocks`` = BLOCK / cpb blocks of ``items`` = cpb * L items; the CDF
    searched in shared memory where ``staged``; a block's item arrays in
    device memory where ``spill`` (else in shared memory); ``smem`` the
    dynamic shared memory of a block (bytes)."""
    L: int
    cpb: int
    blocks: int
    items: int
    staged: int
    spill: int
    smem: int


ITEM_ARRAYS = SUMS + 5  # a block's item arrays (csrc ``kItemArrays``)


def chain_smem(M: int, cpb: int, items: int, staged: bool,
               spill: bool = False) -> int:
    """The chain's dynamic shared memory (csrc ``smem_bytes``): the staged
    CDF [M], the ITEM_ARRAYS item arrays unless spilled, the scan's 2 BLOCK
    floats, the fold's SUMS (THREADS + 1) and two chunk arrays [cpb], 4
    bytes each."""
    return 4 * ((M if staged else 0) + (0 if spill else ITEM_ARRAYS * items)
                + 2 * BLOCK + SUMS * (THREADS + 1) + 2 * cpb)


@functools.lru_cache(maxsize=None)
def plan(M: int, fits: Optional[Callable[[int], int]] = None) -> ChainPlan:
    """The chain's launch plan for M particles.  It starts from the most
    chunks a block (a power of two) with at most one item a thread, so a
    block's items load and compute in one pass; a block keeps its items in
    shared memory, and the CDF there too, where they fit (else the CDF is
    searched in device memory, and then the items go to device memory).
    ``fits(smem)`` is the number of blocks the card holds co-resident at
    ``smem`` bytes a block (``fits``: none, no limit): while a plan's
    blocks exceed it, the plan doubles the chunks a block."""
    if M < 1:
        raise ValueError(f"{M} particles: the chain needs at least one")
    L = -(-M // BLOCK)
    cpb = 1
    while cpb * 2 <= BLOCK and cpb * 2 * L <= THREADS:
        cpb *= 2
    budget = SMEM_LIMIT - SMEM_STATIC
    while True:
        items = cpb * L
        for staged, spill in ((True, False), (False, False), (True, True),
                              (False, True)):
            smem = chain_smem(M, cpb, items, staged, spill)
            if smem <= budget:
                break
        else:
            raise ValueError(f"{M} particles: a block's {smem} bytes of "
                             "shared memory exceed the card's")
        blocks = BLOCK // cpb
        if fits is None or blocks <= fits(smem):
            return ChainPlan(L, cpb, blocks, items, int(staged), int(spill),
                             smem)
        if cpb == BLOCK:
            raise ValueError(f"{M} particles: the card holds no block of "
                             f"{smem} bytes of shared memory co-resident")
        cpb *= 2


@functools.lru_cache(maxsize=None)
def fits_on(dev) -> Callable[[int], int]:
    """``plan``'s ``fits`` for CUDA device ``dev``: the blocks of the chain
    it holds co-resident at a block's shared memory, asked of the card
    once a size."""
    @functools.lru_cache(maxsize=None)
    def fits(smem: int) -> int:
        blocks = _I(0)
        with torch.cuda.device(dev):
            err = _build.function("ndt2d_pf_chain_fit", _FIT_ARGS)(
                smem, ctypes.byref(blocks))
        _build.check(err, "pf_chain occupancy")
        return blocks.value
    return fits


class _Scratch(NamedTuple):
    cdf: torch.Tensor     # [M] f32
    part: torch.Tensor    # [REGIONS, BLOCK] f32 chunk sums
    keys: torch.Tensor    # [M, 3] i32
    table: torch.Tensor   # [2, T] i32 owner and first draw of a slot
    ipart: torch.Tensor   # [2 BLOCK] i32 block counts and minima
    spill: Optional[torch.Tensor]  # [BLOCK L ITEM_ARRAYS] f32, if spilled


def _make_scratch(M: int, dev, pl: ChainPlan) -> _Scratch:
    """The chain's scratch for M particles on ``dev`` by plan ``pl``."""
    f, i32 = torch.float32, torch.int32
    T = 1 << max(2 * M - 1, 1).bit_length()
    return _Scratch(torch.empty(M, dtype=f, device=dev),
                    torch.empty(REGIONS, BLOCK, dtype=f, device=dev),
                    torch.empty(M, 3, dtype=i32, device=dev),
                    torch.empty(2, T, dtype=i32, device=dev),
                    torch.empty(2 * BLOCK, dtype=i32, device=dev),
                    torch.empty(BLOCK * pl.L * ITEM_ARRAYS, dtype=f,
                                device=dev) if pl.spill else None)


_SCRATCH: dict = {}


def _scratch(M: int, dev, pl: ChainPlan, stream: int) -> _Scratch:
    """The scratch of a call on ``dev``'s ``stream``, made at the first
    and kept for the next: calls on one stream run in order, so they may
    share it, and another stream gets its own.  PERF.md §6 gives the host
    time that making it every call would add."""
    key = (M, dev, stream, pl.spill)
    s = _SCRATCH.get(key)
    if s is None:
        s = _SCRATCH[key] = _make_scratch(M, dev, pl)
    return s


def _plan_args(pl: ChainPlan, sc: _Scratch, staged: bool) -> list:
    return [_build.ptr(sc.spill) if pl.spill else None, pl.L, pl.cpb,
            pl.blocks, pl.items, int(staged and pl.staged), pl.spill]


def _outputs(M: int, dev):
    return (torch.empty(M, 3, dtype=torch.float32, device=dev),
            torch.empty(M, dtype=torch.float32, device=dev),
            torch.empty(M, dtype=torch.float32, device=dev),
            torch.empty(1, dtype=torch.int32, device=dev),
            torch.empty(13, dtype=torch.float32, device=dev))


def resample(weights, n_in, uniforms, particles, bins, kld_err: float,
             kld_z: float, min_particles: int,
             recovery: Optional[Recovery] = None) -> Resampled:
    """KLD resample of particles [M, 3] f32 by raw weights [M] f32 over the
    active mask (first n_in [1] int32), with the draw's uniforms [M] f32
    and bins [3] f32 (host floats or a tensor); with ``recovery`` the EWMAs
    and the injection too; then the statistics.  CPU tensors run the twin;
    CUDA tensors launch the kernel, whose plan takes as many blocks as the
    card holds co-resident; it raises where the card refuses the launch
    (the plan's blocks or shared memory)."""
    if weights.device.type == "cpu":
        return resample_twin(weights, n_in, uniforms, particles, bins,
                             kld_err, kld_z, min_particles, recovery)
    dev = weights.device
    M = weights.shape[0]
    _build.require(weights, "weights", torch.float32, (M,), dev)
    _build.require(n_in, "n_in", torch.int32, (1,), dev)
    _build.require(uniforms, "uniforms", torch.float32, (M,), dev)
    _build.require(particles, "particles", torch.float32, (M, 3), dev)
    pl = plan(M, fits_on(dev))
    bx, by, bt = [float(b) for b in bins]
    levels = int(math.ceil(math.log2(M + 1)))
    f = torch.float32
    stream = _build.stream_ptr(dev)
    sc = _scratch(M, dev, pl, stream)
    T = sc.table.shape[1]
    idx = torch.empty(M, dtype=torch.int32, device=dev)
    marks = torch.empty(M, dtype=torch.bool, device=dev)
    out_p, out_w, out_wn, n_out, stats = _outputs(M, dev)
    p = _build.ptr
    w_state = None
    rec = [0, 0, 0.0, 0.0, None, None]
    if recovery is not None:
        _build.require(recovery.w_state, "w_state", f, (2,), dev)
        w_state = torch.empty(2, dtype=f, device=dev)
        rec = [1, int(recovery.ewma), float(recovery.alpha_slow),
               float(recovery.alpha_fast), p(recovery.w_state), p(w_state)]
    inj = _inj_args(None if recovery is None else recovery.injection, M, dev)
    table = p(sc.table)
    err = _build.function("ndt2d_pf_resample", _RESAMPLE_ARGS)(
        p(weights), p(n_in), p(uniforms), p(particles), M, levels, bx, by,
        bt, float(kld_err), float(kld_z), int(min_particles), *rec, *inj,
        p(sc.cdf), p(sc.part), p(sc.keys), table, table + 4 * T, T,
        p(sc.ipart), p(idx), p(marks), p(out_p), p(out_w), p(out_wn),
        p(n_out), p(stats), *_plan_args(pl, sc, True), stream)
    _build.check(err, "pf_resample")
    launches["pf_resample"] += 1
    return Resampled(out_p, out_w, out_wn, n_out, stats, w_state, idx, marks)


def ewma(weights, n_in, w_state, alpha_slow: float,
         alpha_fast: float) -> torch.Tensor:
    """The recovery EWMAs alone (``ParticleFilter.measure``): w_state [2]
    f32 (w_slow, w_fast; 0 = unset) updated from raw weights [M] f32 over
    the first n_in [1] int32, in the order of ``resample``'s.  CPU tensors
    run the twin; CUDA tensors launch the kernel (or raise, as
    ``resample``)."""
    if weights.device.type == "cpu":
        return ewma_twin(weights, n_in, w_state, alpha_slow, alpha_fast)
    dev = weights.device
    M = weights.shape[0]
    f = torch.float32
    _build.require(weights, "weights", f, (M,), dev)
    _build.require(n_in, "n_in", torch.int32, (1,), dev)
    _build.require(w_state, "w_state", f, (2,), dev)
    pl = plan(M, fits_on(dev))
    stream = _build.stream_ptr(dev)
    sc = _scratch(M, dev, pl, stream)
    out = torch.empty(2, dtype=f, device=dev)
    p = _build.ptr
    err = _build.function("ndt2d_pf_ewma", _EWMA_ARGS)(
        p(weights), p(n_in), M, float(alpha_slow), float(alpha_fast),
        p(w_state), p(out), p(sc.part), *_plan_args(pl, sc, False), stream)
    _build.check(err, "pf_ewma")
    launches["pf_ewma"] += 1
    return out


def statistics(particles, weights, n_in, injection: Optional[Injection] = None,
               p_inject=None) -> Resampled:
    """update_statistics of particles [M, 3] f32 with raw weights [M] f32
    over the first n_in [1] int32; with ``injection`` (and p_inject [1]
    f32) the free-space injection first.  CPU tensors run the twin; CUDA
    tensors launch the kernel (or raise, as ``resample``)."""
    if weights.device.type == "cpu":
        return statistics_twin(particles, weights, n_in, injection, p_inject)
    dev = weights.device
    M = weights.shape[0]
    _build.require(particles, "particles", torch.float32, (M, 3), dev)
    _build.require(weights, "weights", torch.float32, (M,), dev)
    _build.require(n_in, "n_in", torch.int32, (1,), dev)
    pl = plan(M, fits_on(dev))
    stream = _build.stream_ptr(dev)
    sc = _scratch(M, dev, pl, stream)
    scal = None
    if injection is not None:
        _build.require(p_inject, "p_inject", torch.float32, (1,), dev)
        scal = _build.ptr(p_inject)
    inj = _inj_args(injection, M, dev)
    out_p, out_w, out_wn, n_out, stats = _outputs(M, dev)
    p = _build.ptr
    err = _build.function("ndt2d_pf_statistics", _STATS_ARGS)(
        p(particles), p(weights), p(n_in), M, int(injection is not None),
        scal, *inj, p(sc.part), p(out_p), p(out_w), p(out_wn), p(n_out),
        p(stats), *_plan_args(pl, sc, False), stream)
    _build.check(err, "pf_statistics")
    launches["pf_statistics"] += 1
    return Resampled(out_p, out_w, out_wn, n_out, stats)
