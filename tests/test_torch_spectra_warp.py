"""K10's spectra a warp a scan (``csrc/descriptors.cu::scan_spectra``,
``kernels/descriptors.py::spectra_plan``) on the CPU.

The kernel runs only on the card, where ``chip_smoke.py`` holds every
block shape bitwise against ``spectra_twin``.  Here:

* a numpy model of a scan's warp (the profiles a lane a sector; lane f's
  2 (1 + n_rings) chains over the sectors in order, product rounded then
  added; the histogram's quotients a lane a bin and the mean's chain,
  which every lane adds; the squares a lane an element and the norm's
  chain, which every lane adds) against the twin,
  bitwise, at the main path's shape and at shapes that take the kernel's
  other branches (62 sectors: no 16-byte profile loads; 6 rings: two
  passes of chains; 40 bins; 128 sectors: two frequencies a lane), with
  an empty and a one-sector scan;
* ``spectra_plan`` and ``spectra_shared`` exactly: warps a block, the
  tables staged where they fit, every region 16-byte aligned, refusals;
* the twin against the JAX package's ``descriptors`` run op by op
  (``jax.disable_jit``) over seeded office tables with an empty scan,
  within 1e-5 (as in test_torch_loop_search.py: the jitted reference bins
  beams on sector edges otherwise).
"""

import jax
import numpy as np
import pytest
import torch

from ndt_2d_tpu.parallel import loop_search as jax_search
from ndt_2d_tpu_torch.kernels import descriptors as k10
from ndt_2d_tpu_torch.parallel import loop_search
from ndt_2d_tpu_torch.utils import sim

torch.set_num_threads(2)

F32 = np.float32
RANGE = 12.0


def office_table(seed: int, n: int = 5, P: int = 256):
    """n office scans from seeded poses, a one-sector scan and an empty
    scan: points [n + 2, P, 2], mask [n + 2, P]."""
    world = sim.make_office_world(16.0)
    rng = np.random.default_rng(seed)
    scans = []
    for _ in range(n):
        pose = np.asarray([rng.uniform(2.0, 14.0), rng.uniform(2.0, 14.0),
                           rng.uniform(-np.pi, np.pi)])
        scans.append(sim.project_scan(sim.scan_at_pose(
            world, pose, n_beams=300, range_max=RANGE, noise=0.01,
            rng=rng), P))
    pts = np.stack([s[0] for s in scans]).astype(F32)
    msk = np.stack([s[1] for s in scans])
    one = np.zeros((1, P, 2), F32)
    one[0, :, 0] = np.linspace(0.5, 11.5, P, dtype=F32)
    one[0, :, 1] = F32(0.1) * one[0, :, 0]
    return (np.concatenate([pts, one, pts[:1]]),
            np.concatenate([msk, np.ones((1, P), bool),
                            np.zeros((1, P), bool)]))


def root(x):
    """torch's float32 square root (this CPU build's vectorized root is
    not always correctly rounded: 1 ulp off at some inputs; the card's
    sqrtf and CUDA torch's are IEEE, so there the model's roots are)."""
    return torch.sqrt(torch.from_numpy(np.atleast_1d(np.asarray(
        x, F32)))).numpy()


def warp_model(bins, shape):
    """A scan's warp of ``scan_spectra`` in numpy float32, lane by lane
    where the kernel splits the work; roots by ``root``."""
    n_sectors, n_rings, n_bins = shape
    F, n_prof = n_sectors // 2, 1 + n_rings
    n_spec = n_prof * F
    cos_t, sin_t = (t.numpy() for t in k10.dft_tables(n_sectors, "cpu"))
    b = [t.numpy() for t in bins]
    S = b[4].shape[0]
    out = np.zeros((S, n_spec + n_bins), F32)
    for s in range(S):
        points = b[4][s]
        tot = max(points, F32(1))
        prof = np.empty((n_prof, n_sectors), F32)
        prof[0] = b[1][s] / np.maximum(b[0][s], F32(1)) / F32(RANGE)
        prof[1:] = (b[2][s] / tot).reshape(n_rings, n_sectors)
        d = np.empty(n_spec + n_bins, F32)
        for lane in range(32):
            for f in range(lane, F, 32):
                re = np.zeros(n_prof, F32)
                im = np.zeros(n_prof, F32)
                for a in range(n_sectors):
                    re = re + prof[:, a] * cos_t[a, f]
                    im = im + prof[:, a] * sin_t[a, f]
                d[np.arange(n_prof) * F + f] = root(re * re + im * im)
        q = b[3][s] / tot
        acc = F32(0)
        for v in q:  # every lane, in order
            acc = F32(acc + v)
        d[n_spec:] = q - acc / F32(n_bins)
        sq = d * d
        acc = F32(0)
        for v in sq:  # every lane, in order
            acc = F32(acc + v)
        norm = max(root(acc)[0], F32(1e-12))
        if points > 0:
            out[s] = d / norm
    return out


@pytest.mark.parametrize("shape", [(64, 4, 32), (62, 4, 32), (64, 6, 32),
                                   (64, 4, 40), (128, 4, 32)])
def test_warp_model_matches_the_twin(shape):
    pts, msk = office_table(seed=sum(shape), n=3)
    bins = k10.bin_twin(torch.from_numpy(pts), torch.from_numpy(msk), RANGE,
                        *shape)
    twin = k10.spectra_twin(bins, RANGE, *shape).numpy()
    got = warp_model(bins, shape)
    assert np.array_equal(got.view(np.int32), twin.view(np.int32))
    assert not twin[-1].any() and twin[-2].any()


@pytest.mark.parametrize("S,warps,smem", [
    (1, 4, 4 * (4096 + 4 * (320 + 192))), (512, 4, 24576),
    (1055, 4, 24576), (1056, 8, 4 * (4096 + 8 * 512)), (2048, 8, 32768)])
def test_spectra_plan(S, warps, smem):
    """Blocks of 8 warps where that gives every one of 132 SMs a block (S
    >= 1056), else 4; the 64 x 32 cos and sin tables staged beside a
    warp's 320 profile floats and 192 descriptor floats."""
    plan = k10.spectra_plan(S)
    assert (plan.warps, plan.staged, plan.smem) == (warps, 1, smem)
    assert plan.smem == k10.spectra_shared(64, 4, 32, warps, 1)


@pytest.mark.parametrize("shape,S,warps,staged", [
    ((128, 4, 32), 512, 4, 0), ((256, 4, 32), 2048, 4, 0),
    ((1024, 4, 32), 16, 1, 0), ((96, 4, 32), 512, 4, 1)])
def test_spectra_plan_unstages_the_tables_past_48_kb(shape, S, warps,
                                                     staged):
    """Tables of n_sectors^2 floats stay in global memory where they do
    not fit beside the warps (128 sectors: 64 KB); warps halve where the
    warps alone do not fit."""
    plan = k10.spectra_plan(S, *shape)
    assert (plan.warps, plan.staged) == (warps, staged)
    assert plan.smem <= k10.SPECTRA_SHARED
    if warps < 8 and S >= 1056:
        assert k10.spectra_shared(*shape, 2 * warps, 0) > \
            k10.SPECTRA_SHARED


def test_spectra_plan_refuses_what_one_warp_cannot_hold():
    with pytest.raises(ValueError):
        k10.spectra_plan(8, 4096, 4, 32)
    with pytest.raises(ValueError):
        k10.spectra_plan(8, 64, 0, 32)
    with pytest.raises(ValueError):
        k10.spectra_plan(8, 1, 4, 32)


@pytest.mark.parametrize("shape", [(63, 4, 32), (62, 5, 33), (64, 4, 500)])
def test_spectra_shared_keeps_regions_aligned(shape):
    """The staged tables and each warp's two regions are multiples of 16
    bytes (the profiles and squares are read as float4)."""
    n_sectors, n_rings, n_bins = shape
    one = k10.spectra_shared(*shape, 1, 0)
    assert one % 16 == 0
    assert k10.spectra_shared(*shape, 4, 0) == 4 * one
    tables = k10.spectra_shared(*shape, 1, 1) - one
    assert tables % 16 == 0 and tables >= 8 * n_sectors * (n_sectors // 2)
    D = (1 + n_rings) * (n_sectors // 2) + n_bins
    assert one >= 4 * (max((1 + n_rings) * n_sectors, D) + D)


def test_spectra_on_cpu_tensors_runs_the_twin():
    pts, msk = office_table(seed=3, n=2)
    bins = k10.bin_points(torch.from_numpy(pts), torch.from_numpy(msk),
                          RANGE)
    assert torch.equal(k10.spectra(bins, RANGE),
                       k10.spectra_twin(bins, RANGE))


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_twin_matches_op_by_op_jax(seed):
    pts, msk = office_table(seed)
    ours = loop_search.descriptors(torch.from_numpy(pts),
                                   torch.from_numpy(msk), RANGE).numpy()
    with jax.disable_jit():
        ref = np.asarray(jax_search.descriptors(pts, msk, F32(RANGE)))
    assert ours.shape == ref.shape == (pts.shape[0], 5 * 32 + 32)
    assert np.abs(ours - ref).max() <= 1e-5
    assert not ours[-1].any() and not ref[-1].any()
