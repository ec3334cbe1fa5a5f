"""K7's launch plan (``kernels/newton.py::plan``) and what the block design
reads, which the CPU can check.  The kernel runs only on the card, where
``chip_smoke.py`` holds it bitwise against its unchanged twin
(``matching/newton.py::refine_beams``).

* The split-warp order: warp (g, s) stages the terms of beams
  l + 32 (s + S j), then for each sum the lane l of the warp that takes it
  adds its beams chunk by chunk.
  A numpy model of that order equals the twin's lane chain
  (``score_points.lane_tree_sum``: lane l adds beams l, l + 32, ... from 0,
  then the halving tree), bitwise, at every S the kernel takes.
* The cell record: the kernel reads a beam's cell as the first 8 floats of
  row f of K1's packed table in place of the grid's mean, information and
  count arrays; for every cell of a config-3-shaped window (K1's twin, one
  grid and the four overlapping grids) those floats are mean, information
  and the count >= 5 flag.

Tolerances: none; every comparison is bitwise.
"""

import numpy as np
import pytest
import torch

from ndt_2d_tpu_torch.io.bag import record_synthetic
from ndt_2d_tpu_torch.kernels import ndt_build as k1
from ndt_2d_tpu_torch.kernels import newton as k7
from ndt_2d_tpu_torch.kernels.score_points import lane_tree_sum
from ndt_2d_tpu_torch.mapping import laser
from ndt_2d_tpu_torch.matching import newton

torch.set_num_threads(2)

BEAMS = [1, 31, 32, 100, 129, 512]


def split_warp_sums(terms, S):
    """numpy model of newton_block's sums of [K, B] float32 terms with S
    warps a grid: per chunk of 32 S beams, warp s stages beams base + 32 s
    + l (zero past B); lane l of the warp that takes a sum adds its staged
    beams base + 32 m + l for the strides m that start below B, in m
    order, from 0; then the (16, 8, 4, 2, 1) shuffle tree."""
    K, B = terms.shape
    chunk = 32 * S
    acc = np.zeros((K, 32), np.float32)
    for base in range(0, B, chunk):
        staged = np.zeros((K, chunk), np.float32)
        for s in range(S):
            for lane in range(32):
                i = base + 32 * s + lane
                if i < B:
                    staged[:, 32 * s + lane] = terms[:, i]
        for m in range(S):
            if base + 32 * m < B:
                acc = (acc + staged[:, 32 * m:32 * m + 32]).astype(np.float32)
    for off in (16, 8, 4, 2, 1):
        acc[:, :off] = (acc[:, :off] + acc[:, off:2 * off]).astype(np.float32)
    return acc[:, 0]


def random_terms(B, seed):
    """Ten rows of beam terms as K7 makes them: magnitudes over six decades,
    beams that score nothing (+0 and -0 terms)."""
    rng = np.random.default_rng(seed)
    t = (rng.normal(0, 1, (newton.NUM_SUMS, B))
         * 10.0 ** rng.integers(-3, 4, (newton.NUM_SUMS, B))).astype(
             np.float32)
    dead = rng.random(B) < 0.3
    t[:, dead] = np.where(rng.random((newton.NUM_SUMS, int(dead.sum())))
                          < 0.5, np.float32(0.0), np.float32(-0.0))
    return t


@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("B", BEAMS)
def test_split_warp_order_is_the_lane_chain(B, S):
    terms = random_terms(B, 17 * B + S)
    slots = -(-B // 32) * 32
    padded = torch.nn.functional.pad(torch.from_numpy(terms), (0, slots - B))
    twin = lane_tree_sum(padded).numpy()
    assert split_warp_sums(terms, S).tobytes() == twin.tobytes()


@pytest.mark.parametrize("B", BEAMS)
def test_plan(B):
    for G in (1, 4):
        pl = k7.plan(B, G)
        assert pl.strides == min(-(-B // 32), k7.MAX_STRIDES)
        assert pl.threads == 32 * G * pl.strides <= 1024
        assert pl.chunk == 32 * pl.strides
        assert pl.smem_bytes == 4 * (3 * B + G * 10 * pl.chunk + G * 10 + 4)
    with pytest.raises(ValueError):
        k7.plan(0, 1)


def office_window(grids):
    """Two rows of 2-scan office regions at config 3's global matcher shape
    (160 x 160 cells of 0.35 m, 512 points a scan), built by K1's twin."""
    bag = record_synthetic("office", 60, n_beams=600, range_max=12.0,
                           seed=1, odom_trans_noise=0.02,
                           odom_rot_noise=0.004)
    rows = []
    for k in (10, 40):
        scans = [laser.project_scan(bag[t][0], bag.range_max, np.zeros(3),
                                    False, None, 512) for t in (k, k + 1)]
        rows.append((bag.odom[[k, k + 1]].astype(np.float32),
                     np.stack([s[0] for s in scans]),
                     np.stack([s[1] for s in scans])))
    poses, points, masks = (torch.from_numpy(np.stack(c)) for c in zip(*rows))
    wmask = torch.ones(2, 2, dtype=torch.bool)
    return k1.build_windows_twin(poses, points.float(), masks, wmask, 12.0,
                                 0.35, 160, 160, grids)


@pytest.mark.parametrize("grids", [1, 4])
def test_table_record_is_the_cell(grids):
    grid, tables = office_window(grids)
    g = newton.with_row_grid_axes(grid, rows_axis=True)
    rec = k7.row_tables(tables, rows_axis=True)[..., :8]
    assert rec.shape == (2, grids, 160 * 160, 8)
    assert int((g.count >= 5).sum()) > 100
    assert torch.equal(rec[..., 0:2], g.mean)
    assert torch.equal(rec[..., 2:5], g.information)
    assert torch.equal(rec[..., 5], (g.count >= 5).float())
