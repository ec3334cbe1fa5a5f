#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile   # device-time breakdown of the sessions

Phases (any failure exits non-zero):
 1. require CUDA; print the card (nvidia-smi name and power limit), the
    torch/CUDA versions and nvcc's;
 2. build the kernels of ``ndt_2d_tpu_torch/csrc`` with nvcc (one process
    per source, in parallel);
 3. hold each kernel bitwise against its plain-PyTorch twin on the same
    CUDA inputs, check it is bitwise reproducible, and time kernel and twin
    with CUDA events beside its bound (bytes over 3.35 TB/s or float32
    operations over 67 TFLOP/s, counted from the inputs, each distinct
    cell or patch row the beams reach once) and, where one PyTorch call
    computes the same function, that call: K1/K2/K3/K5 at the
    rolling-mapping shapes of config 2 (10-scan window of 512 points,
    192x192 cells, 80x21x21 candidates x 100 beams, the 200-scan export);
    the same window at config-8 shapes with a grid axis of 4 (overlapping
    grids): K1 (its grid 0 bitwise the G = 1 build), K2 with its scores,
    K3's two entries, and K7 on the match (10 iterations); K1/K2 over 64
    loop-closure confirmation rows of real office windows at config-3
    shapes (2-scan regions, 160x160 cells of 0.35 m, 40x30x30 candidates)
    and K7 on them (8 iterations), each row bitwise equal to its R = 1
    launch and to itself at pad 4 and pad 16, without and with K7; K4
    (normal_blocks, pcg_matvec, the latter
    beside a torch sparse CSR product) on the 50,000-node district graph
    of config 5;
 4. drive the main paths, each with the launch counts set to 0 before and
    read after: (a) the 200-scan, 600-beam config-2 corridor through
    ``Mapper`` and ``run_bag`` (no loop closure) with its export: every scan
    accepted, ATE below odometry's, K1 = K2 = K3 = accepted - 1, K5 >= 1,
    and the first 20 scans on the GPU against the CPU twins; (b) the
    single-device PCG ``solve`` of the district, on the kernels and on the
    twins: final RMSE below the initial, the twin's poses within 1e-4 m;
    (f) BASELINE config 8 (run_benchmarks.py:139-162): the config-2
    corridor with four overlapping grids and 10 Newton iterations on both
    matchers: every scan accepted, ATE below odometry's, K1 = K2 = K3 = K7
    = accepted - 1, ms/scan and (aligned) ATE printed beside config 2's;
    its first three matches replayed through the twins (K1, K2, K3, K7
    bitwise);
    (c) the full 2000-scan config-3 office loop (radius loop closure +
    optimization) with its export: >= 1 accepted closure and >= 1
    optimization, final ATE <= 1.10 x online and below odometry's, K1/K2
    launches = accepted - 1 + confirmation chunks, K4 >= 1; the first two
    confirmation dispatches and the first solve of that session are
    replayed through the twins on the card and must reach the same scores
    bitwise and poses within 1e-4; (g) the same bag with the CLI's
    ``office`` recipe as ``run --recipe office`` builds it from config 3's
    flags (gate 0.85, 3-scan regions, both search positions,
    Geman-McClure, global refine_iterations 8):
    >= 1 closure and >= 1 optimization, final ATE below odometry's, one K7
    launch a confirmation chunk, printed beside (c); its first dispatch
    replayed through the twins (K7's after K2's), scores bitwise;
    (d) BASELINE config 4 (benchmarks/run_benchmarks.py:378-426): the
    150-scan box (360 beams, seed 2), mapped and saved before [3], is
    loaded; the 150-scan box bag (seed 7) is localized with the particle
    filter (5000 particles, KLD min 500, odometry alphas 0.05, seed 3):
    mean position error <= 0.10 m and below odometry's, every step on
    K3-batch and K9; the first three filter steps replayed through the
    twins with the same draws give the same n_active and particles
    bitwise; then the scan-match branch on the same map and bag: mean
    error <= 0.12 m.  Before it, [3] holds K3 over 5000 and over 20,000
    poses of the config-4 grid against its twin (bitwise, and 64 rows
    bitwise equal to their M = 1 launch) and K9's motion, resample (plain
    and recovery), EWMAs and statistics against their twins on the same
    scores and draws at both counts (bitwise: n_active, drawn indices,
    first-occurrence marks, particles, weights, w_slow/w_fast, mean and
    covariance); (e) BASELINE config 7 (run_benchmarks.py:598-657): 20,000
    particles seeded over the free space (K5), 40 scans; the scan it
    converged at and its final error are printed, not gated; K3-batch and
    K9 launched every step and no twin ran; the first two steps replayed
    through the twins give the same n_active and particles bitwise;
 5. print the kernels' JSON line and, last, the device JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

KERNELS = {
    "ndt_build": ("ndt_2d_tpu_torch/csrc/ndt_build.cu",
                  "ndt_2d_tpu/ndt/grid.py:111"),
    "candidate_scores": ("ndt_2d_tpu_torch/csrc/candidate_scores.cu",
                         "ndt_2d_tpu/matching/matcher.py:218"),
    "score_points": ("ndt_2d_tpu_torch/csrc/score_points.cu",
                     "ndt_2d_tpu/ndt/grid.py:220"),
    "raymarch": ("ndt_2d_tpu_torch/csrc/raymarch.cu",
                 "ndt_2d_tpu/mapping/occupancy.py:51"),
    "normal_blocks": ("ndt_2d_tpu_torch/csrc/normal_blocks.cu",
                      "ndt_2d_tpu/graph/solver.py:140"),
    "pcg_matvec": ("ndt_2d_tpu_torch/csrc/normal_blocks.cu",
                   "ndt_2d_tpu/graph/solver.py:203"),
    "score_points_batch": ("ndt_2d_tpu_torch/csrc/score_points.cu",
                           "ndt_2d_tpu/matching/matcher.py:424"),
    "pf_motion": ("ndt_2d_tpu_torch/csrc/particle_filter.cu",
                  "ndt_2d_tpu/filter/motion_model.py:21"),
    "pf_resample": ("ndt_2d_tpu_torch/csrc/particle_filter.cu",
                    "ndt_2d_tpu/filter/particle_filter.py:81"),
    "pf_statistics": ("ndt_2d_tpu_torch/csrc/particle_filter.cu",
                      "ndt_2d_tpu/filter/particle_filter.py:55"),
    "ndt_build_g4": ("ndt_2d_tpu_torch/csrc/ndt_build.cu",
                     "ndt_2d_tpu/matching/matcher.py:95"),
    "candidate_scores_g4": ("ndt_2d_tpu_torch/csrc/candidate_scores.cu",
                            "ndt_2d_tpu/matching/matcher.py:194"),
    "score_points_g4": ("ndt_2d_tpu_torch/csrc/score_points.cu",
                        "ndt_2d_tpu/matching/matcher.py:411"),
    "newton": ("ndt_2d_tpu_torch/csrc/newton.cu",
               "ndt_2d_tpu/matching/newton.py:62"),
}
# The bound of a kernel: the larger of the bytes it must move over the
# H100's memory rate and its operations over the float32 rate outside the
# tensor cores (NVIDIA's data sheet, SXM, 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
N_SCANS = 200
N_BEAMS = 600
OFFICE_SCANS = 2000
ROWS = 64
DISTRICT_NODES = 50_000
PARTICLES = 5000         # config 4
GLOBAL_PARTICLES = 20_000  # config 7


class SmokeFailure(Exception):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def timed(max_abs_err, ms, plain_ms, moved, ops, library_ms=None) -> dict:
    """A kernel's timing entry: errors and times measured in this run, and
    its bound from ``moved`` bytes (each input read once, each output
    written once; gathered rows where the data picks them) and ``ops``
    float32 operations, both counted from this run's inputs."""
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return dict(max_abs_err=float(max_abs_err), ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms)


def max_abs_diff(pairs) -> float:
    """Largest |kernel - twin| over (kernel, twin) tensor pairs."""
    return max(float((a.double() - b.double()).abs().max()) for a, b in pairs)


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn()``: CUDA events around ``reps`` calls
    back to back after a warm-up, over the count.  Where a call's host
    side (argument checks, ctypes) outlasts its device work, the host
    side sets the figure."""
    import torch
    fn()  # warm-up
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_card():
    import torch

    from ndt_2d_tpu_torch import device as devmod
    from ndt_2d_tpu_torch.kernels import _build
    ident = devmod.card_identity()
    print(ident.splitlines()[0] if ident else "nvidia-smi: not found")
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; "
          f"{nvcc.stdout.strip().splitlines()[-1]}")
    return ident.splitlines()[0] if ident else ""


def phase_build():
    from ndt_2d_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info()
    print(f"[2] built {info['path']} in {time.perf_counter() - t0:.1f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("    " + line.strip())


def inputs(dev):
    """A config-2 window, query scan and the 200-scan ray batch."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.mapping import occupancy
    from ndt_2d_tpu_torch.config import MapperConfig, ScanMatcherConfig
    from ndt_2d_tpu_torch.io.bag import record_synthetic
    from ndt_2d_tpu_torch.mapping import laser
    bag = record_synthetic("corridor", N_SCANS, n_beams=N_BEAMS, seed=0)
    m = ScanMatcherConfig(grid_cells_x=192, grid_cells_y=192)
    cfg = MapperConfig(local_scan_matcher=m, global_scan_matcher=m,
                       max_points_per_scan=512, loop_closure_every=10**9)
    pts, msk = [], []
    for t in range(N_SCANS):
        p, k = laser.project_scan(bag[t][0], bag.range_max, np.zeros(3),
                                  False, None, cfg.max_points_per_scan)
        pts.append(p)
        msk.append(k)
    pts, msk = np.stack(pts), np.stack(msk)
    D = cfg.rolling_depth
    t = torch.from_numpy
    win = dict(poses=t(bag.odom[:D].astype(np.float32)).to(dev),
               points=t(pts[:D]).to(dev), point_mask=t(msk[:D]).to(dev),
               window_mask=torch.ones(D, dtype=torch.bool, device=dev))
    query = dict(points=t(pts[D]).to(dev), point_mask=t(msk[D]).to(dev),
                 num_points=int(msk[D].sum()),
                 pose=t((bag.odom[D] + [0.02, -0.01, 0.01]).astype(
                     np.float32)).to(dev))
    rays = occupancy.ray_batch(bag.odom, pts, msk, cfg.resolution)
    return bag, cfg, win, query, rays


def phase_kernels(cfg, win, query, rays, dev):
    """Each kernel bitwise against its twin on the same CUDA inputs,
    bitwise reproducibility of K1/K2/K5, and times."""
    import torch

    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.kernels import raymarch as k5
    from ndt_2d_tpu_torch.kernels import score_points as k3
    from ndt_2d_tpu_torch.mapping import occupancy
    mc = cfg.local_scan_matcher
    W, H = mc.grid_cells_x, mc.grid_cells_y
    rmax = 15.0
    out = {}

    # K1: bitwise.
    def k1_run():
        return k1.build_window(**win, range_max=rmax,
                               cell_size=mc.ndt_resolution, width=W,
                               height=H)

    def k1_twin():
        return k1.build_window_twin(**win, range_max=rmax,
                                    cell_size=mc.ndt_resolution, width=W,
                                    height=H)

    (g, tab), (gt, tabt) = k1_run(), k1_twin()
    torch.cuda.synchronize()
    check_build(g, tab, gt, tabt, "K1")
    g2, tab2 = k1_run()
    check_build(g, tab, g2, tab2, "K1 (reproducibility)")
    print(f"[3] K1 ndt_build: {int((g.count > 0).sum())} occupied cells, "
          f"bitwise equal to its twin and reproducible")
    S, P = win["points"].shape[0], win["points"].shape[1]
    out["ndt_build"] = timed(
        0.0, cuda_ms(k1_run, 20), cuda_ms(k1_twin, 5),
        nbytes(*win.values(), g.origin, g.mean, g.information, g.covariance,
               g.count, tab), ops_ndt_build(1, 1, S * P, W * H))

    # K2 on the kernel-built grid: scores and output row bitwise.
    from ndt_2d_tpu_torch.matching.matcher import _search_offsets
    dths, dls = _search_offsets(mc, dev)
    args = (mc, g, tab, query["points"], query["point_mask"],
            query["num_points"], query["pose"], dths, dls)
    o2, sc = k2.match(*args, with_scores=True)
    rest, sct = k2.match_twin(*args)
    torch.cuda.synchronize()
    check_match(o2, sc, one_row(rest), sct, "K2")
    check_match(o2, sc, *k2.match(*args, with_scores=True),
                "K2 (reproducibility)")
    print(f"[3] K2 candidate_scores: {sc.numel()} candidates, score "
          f"{float(o2[0, 0]):.5f} correction "
          f"{[round(float(x), 4) for x in o2[0, 1:4]]}, scores and output "
          f"row bitwise equal to the twin")
    out["candidate_scores"] = timed(
        0.0, cuda_ms(lambda: k2.match(*args), 20),
        cuda_ms(lambda: k2.match_twin(*args), 5),
        *cost_candidate_scores(mc, g.origin, g.cell_size, *args[3:]))

    # K3: bitwise.
    a3 = (g, W, H, mc.laser_max_beams, query["points"], query["point_mask"],
          query["num_points"], query["pose"])
    u, ut = k3.score_at_pose(*a3), k3.score_at_pose_twin(*a3)
    require(torch.equal(u, ut), f"K3 {float(u)} differs from twin {float(ut)}")
    print(f"[3] K3 score_points: {float(u):.6f}, bitwise equal to the twin")
    out["score_points"] = timed(
        0.0, cuda_ms(lambda: k3.score_at_pose(*a3), 20),
        cuda_ms(lambda: k3.score_at_pose_twin(*a3), 5),
        *cost_score_points(mc, g, *a3[4:7], query["pose"][None]))

    # K5: bitwise.
    a5 = occupancy.ray_tensors(rays, cfg.resolution, dev)
    hit, emp = k5.raymarch_counts(*a5)
    hitt, empt = k5.raymarch_counts_twin(*a5)
    require(torch.equal(hit, hitt) and torch.equal(emp, empt),
            "K5 counts differ from twin")
    hit2, emp2 = k5.raymarch_counts(*a5)
    require(torch.equal(hit, hit2) and torch.equal(emp, emp2),
            "K5 not bitwise reproducible")
    print(f"[3] K5 raymarch: {rays.starts.shape[0]} rays x "
          f"{rays.num_samples} samples on {rays.width}x{rays.height}, "
          f"{int(hit.sum())} hits, {int(emp.sum())} empty, bitwise equal")
    # K5: per ray and sample a cell index, a compare and a count (~12).
    out["raymarch"] = timed(
        0.0, cuda_ms(lambda: k5.raymarch_counts(*a5), 10),
        cuda_ms(lambda: k5.raymarch_counts_twin(*a5), 3),
        nbytes(*a5[:4], hit, emp), 12 * a5[0].shape[0] * a5[7])
    return out


def ops_ndt_build(rows: int, grids: int, points: int, cells: int) -> int:
    """K1: per point the transform, binning and six moment sums (~20
    operations), per cell the finalize (~40)."""
    return rows * grids * (20 * points + 40 * cells)


def used_beams(mc, points, point_mask, num_points: int):
    """A scan's subsampled beams: (points [B, 2], mask [B], used)."""
    from ndt_2d_tpu_torch.kernels.score_points import subsample
    return subsample(points, point_mask, num_points, mc.laser_max_beams)


def cells_read(mc, origin, cell_size, spts, smask, poses, patch_shift=None):
    """The distinct (grid, cell) keys, g * C + cell, that the beams spts
    [B, 2] (mask [B]) land in from poses [M, 3] on the grids of origin
    [(G,) 2]: each cell a kernel must read at least once.  With
    ``patch_shift`` (K2's first lattice offset) the 2x2 patch rows K2
    gathers instead: the clamped corner cell of the shifted beam."""
    import torch
    W, H = mc.grid_cells_x, mc.grid_cells_y
    origin = origin.reshape(-1, 2)
    c, s = torch.cos(poses[:, 2:3]), torch.sin(poses[:, 2:3])
    x = c * spts[:, 0] - s * spts[:, 1] + poses[:, 0:1]
    y = s * spts[:, 0] + c * spts[:, 1] + poses[:, 1:2]
    if patch_shift is not None:
        x, y = x + patch_shift, y + patch_shift
    ix = torch.floor((x[None] - origin[:, 0, None, None]) / cell_size).long()
    iy = torch.floor((y[None] - origin[:, 1, None, None]) / cell_size).long()
    ok = smask[None, None, :].expand_as(ix)
    if patch_shift is not None:
        ix, iy = ix.clamp(0, W - 2), iy.clamp(0, H - 2)
    else:
        ok = ok & (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    g = torch.arange(origin.shape[0], device=ix.device)[:, None, None]
    return torch.unique(((g * H + iy) * W + ix)[ok])


def cell_bytes(keys, count) -> int:
    """Bytes of the cells ``keys`` that a K3/K7 evaluation needs: each
    one's count (4 bytes) and, where it holds >= 5 points, its mean and
    information (20 bytes)."""
    return 4 * keys.numel() + 20 * int((count.reshape(-1)[keys] >= 5).sum())


def sum_costs(costs):
    """(bytes, operations) pairs of rows, added."""
    return tuple(map(sum, zip(*costs)))


def cost_candidate_scores(mc, origin, cell_size, points, point_mask,
                          num_points: int, pose, dths, dls):
    """K2's (bytes, operations) for one row: each distinct 2x2 patch row
    its used beams gather on its grids (128 bytes), the used beams (9
    bytes each), the start pose and the [13] output; ~16 operations (shift,
    compare, quadratic form, exp, sum) a (candidate, used beam) per grid."""
    import torch
    spts, smask, used = used_beams(mc, points, point_mask, num_points)
    grids = origin.reshape(-1, 2).shape[0]
    at = pose + torch.stack([torch.zeros_like(dths), torch.zeros_like(dths),
                             dths], -1)
    rows = cells_read(mc, origin, cell_size, spts, smask, at, dls[0])
    L = dls.numel()
    return (rows.numel() * 128 + used * 9 + 12 + 13 * 4,
            grids * dths.numel() * L * L * used * 16)


def cost_score_points(mc, grid, points, point_mask, num_points: int, poses):
    """K3's (bytes, operations) at poses [M, 3]: the cells its used beams
    land in (``cell_bytes``), the used beams, the poses and the M scores;
    ~20 operations a (pose, used beam, grid)."""
    spts, smask, used = used_beams(mc, points, point_mask, num_points)
    keys = cells_read(mc, grid.origin, grid.cell_size, spts, smask, poses)
    M, grids = poses.shape[0], grid.origin.reshape(-1, 2).shape[0]
    return (cell_bytes(keys, grid.count) + used * 9 + M * 16,
            M * grids * used * 20)


def cost_newton(mc, origin, cell_size, count, points, point_mask,
                num_points: int, start, final, iterations: int):
    """K7's (bytes, operations) for one row: the cells its used beams land
    in at the start and the refined pose (``cell_bytes``; every evaluation
    between reads cells near those), the used beams, the pose and the [13]
    row read and written; ~60 operations a (evaluation, used beam, grid)
    for the score, its gradient and Hessian terms, ~80 an iteration for
    the damped 3x3 solve."""
    import torch
    spts, smask, used = used_beams(mc, points, point_mask, num_points)
    keys = cells_read(mc, origin, cell_size, spts, smask,
                      torch.stack([start, final]))
    grids = origin.reshape(-1, 2).shape[0]
    return (cell_bytes(keys, count) + used * 9 + 12 + 2 * 13 * 4,
            (iterations + 1) * grids * used * 60 + iterations * 80)


def reset_counts():
    from ndt_2d_tpu_torch.kernels import (
        candidate_scores, ndt_build, newton, normal_blocks, particle_filter,
        raymarch, score_points)
    for m in (ndt_build, candidate_scores, score_points, raymarch, newton):
        m.launches = 0
    score_points.batch_launches = 0
    for d in (normal_blocks.launches, particle_filter.launches):
        for k in d:
            d[k] = 0


def read_counts() -> dict:
    from ndt_2d_tpu_torch.kernels import (
        candidate_scores, ndt_build, newton, normal_blocks, particle_filter,
        raymarch, score_points)
    out = {"ndt_build": ndt_build.launches,
           "candidate_scores": candidate_scores.launches,
           "score_points": score_points.launches,
           "score_points_batch": score_points.batch_launches,
           "raymarch": raymarch.launches, "newton": newton.launches}
    out.update(normal_blocks.launches)
    out.update(particle_filter.launches)
    return out


def run_session(cfg, bag, device, n=None, mapper=None):
    """Map ``bag`` (its first ``n`` scans) through the port (``mapper``,
    else a new one); returns (stats, grid, per-scan seconds, corrections,
    accepted flags, mapper)."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.mapping import runtime
    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    from ndt_2d_tpu_torch.io.bag import ScanBag
    if n is not None:
        bag = ScanBag(ranges=bag.ranges[:n], angle_min=bag.angle_min,
                      angle_increment=bag.angle_increment,
                      time_increment=bag.time_increment,
                      range_max=bag.range_max, odom=bag.odom[:n],
                      truth=bag.truth[:n])
    mapper = mapper or Mapper(cfg, device=device)
    stamps, corr, accepted = [time.perf_counter()], [], []

    def progress(t, res):
        stamps.append(time.perf_counter())
        corr.append(res.correction if res.correction is not None
                    else np.zeros(3))
        accepted.append(res.accepted)

    stats = runtime.run_bag(mapper, bag, progress=progress)
    grid = mapper.render_map()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return (stats, grid, np.diff(stamps), np.asarray(corr),
            np.asarray(accepted), mapper)


def session_numbers(stats, bag, dt) -> dict:
    """ms/scan (median over scans 4 on), ATE, aligned ATE, odometry's."""
    import numpy as np

    from ndt_2d_tpu_torch.utils import metrics
    return dict(ms=float(np.median(dt[4:]) * 1e3), ate=stats["ate_rmse_m"],
                aligned=metrics.ate_rmse_aligned(
                    stats["_est"], bag.truth[stats["_est_t"]]),
                odom=stats["odom_ate_rmse_m"])


def phase_session(cfg, bag, dev):
    import numpy as np
    reset_counts()
    stats, grid, dt, _, _, _ = run_session(cfg, bag, dev)
    launches = read_counts()
    numbers = session_numbers(stats, bag, dt)
    acc = stats["scans_accepted"]
    require(acc == len(bag), f"accepted {acc} of {len(bag)} scans")
    for k in ("ndt_build", "candidate_scores", "score_points"):
        require(launches[k] == acc - 1,
                f"{k} launched {launches[k]} times, expected {acc - 1}")
    require(launches["raymarch"] >= 1, "raymarch never launched")
    ate, odom = stats["ate_rmse_m"], stats["odom_ate_rmse_m"]
    require(np.isfinite(ate) and ate < odom,
            f"ATE {ate} not below odometry's {odom}")
    occupied = int((grid.data == 100).sum())
    require(occupied > 0, "occupancy grid has no occupied cells")
    ms = float(np.median(dt[4:]) * 1e3)
    print(f"[4a] {acc}/{len(bag)} scans accepted, "
          f"{stats['graph_constraints']} constraints, ATE {ate:.4f} m "
          f"(odometry {odom:.4f} m), {ms:.3f} ms/scan median (scans 4+), "
          f"grid {grid.data.shape[0]}x{grid.data.shape[1]} with {occupied} "
          f"occupied cells; launches {launches}")

    # The same decisions as the plain twins on a small input.
    n = 20
    sg, gg, _, cg, _, _ = run_session(cfg, bag, dev, n)
    sc, gc, _, cc, _, _ = run_session(cfg, bag, "cpu", n)
    require(sg["scans_accepted"] == sc["scans_accepted"]
            and sg["graph_constraints"] == sc["graph_constraints"],
            "GPU and CPU-twin sessions differ in accepted scans")
    dc = np.abs(cg - cc)
    require(bool((dc <= [0.005, 0.005, 0.0025]).all()),
            "a correction differs from the twin session by > 1 lattice step")
    exact = float(np.mean(np.all(dc < 1e-6, axis=1)))
    require(exact >= 0.9, f"only {exact:.2f} of corrections equal the twins'")
    same = (float(np.mean(gg.data == gc.data))
            if gg.data.shape == gc.data.shape else 0.0)
    require(same >= 0.995, f"only {same:.4f} of occupancy cells agree")
    print(f"[4a] first {n} scans, GPU vs CPU twins: {exact:.2f} of "
          f"corrections equal, ATE {sg['ate_rmse_m']:.5f} vs "
          f"{sc['ate_rmse_m']:.5f}, {same:.4f} of grid cells equal")
    return launches, numbers


# BASELINE.json config 3, the synchronous arm of
# benchmarks/run_benchmarks.py:248-276, as flags of ``run``.
OFFICE_FLAGS = [
    "--local_scan_matcher.grid_cells", "192",
    "--global_scan_matcher.grid_cells", "160",
    "--global_scan_matcher.ndt_resolution", "0.35",
    "--global_scan_matcher.search_linear_size", "0.15",
    "--global_scan_matcher.search_linear_resolution", "0.01",
    "--global_scan_matcher.search_angular_size", "0.05",
    "--max-points-per-scan", "512", "--global-search-size", "4.0",
    "--optimization-node-limit", "10", "--loop-closure-every", "20",
    "--minimum-travel-distance", "0.3"]


def office_config(*extra):
    """Config 3 as ``run`` builds it from OFFICE_FLAGS and ``extra`` (the
    parser requires ``--bag``; building the config does not read it)."""
    from ndt_2d_tpu_torch import cli
    return cli._mapper_config(cli._build_parser().parse_args(
        ["run", "--bag", "office.npz", *OFFICE_FLAGS, *extra]))


def office_bag():
    from ndt_2d_tpu_torch.io.bag import record_synthetic
    return record_synthetic("office", OFFICE_SCANS, n_beams=N_BEAMS,
                            range_max=12.0, seed=1, odom_trans_noise=0.02,
                            odom_rot_noise=0.004)


def office_rows(cfg, bag, dev):
    """ROWS confirmation rows of real office windows: the 2-scan region
    (k, k + 10) at its odometry poses, matched by scan k + 15 from its own
    odometry pose, for k spread over the bag."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.mapping import laser
    P = cfg.max_points_per_scan
    cols = [[] for _ in range(8)]
    for r in range(ROWS):
        k = 20 + r * (OFFICE_SCANS - 60) // ROWS
        win = [laser.project_scan(bag[t][0], bag.range_max, np.zeros(3),
                                  False, None, P) for t in (k, k + 10)]
        qp, qm = laser.project_scan(bag[k + 15][0], bag.range_max,
                                    np.zeros(3), False, None, P)
        for c, v in zip(cols, (bag.odom[[k, k + 10]],
                               np.stack([w[0] for w in win]),
                               np.stack([w[1] for w in win]),
                               np.ones(2, bool), qp, qm, qm.sum(),
                               bag.odom[k + 15])):
            c.append(v)
    dtypes = (torch.float32, torch.float32, torch.bool, torch.bool,
              torch.float32, torch.bool, torch.int32, torch.float32)
    return [torch.tensor(np.stack(c), dtype=d, device=dev)
            for c, d in zip(cols, dtypes)]


def padded_rows(rows, n, pad):
    """The first ``n`` rows zero-padded to ``pad`` (the mapper's padding)."""
    import torch
    out = []
    for t in rows:
        p = torch.zeros((pad,) + tuple(t.shape[1:]), dtype=t.dtype,
                        device=t.device)
        p[:n] = t[:n]
        out.append(p)
    return out


def check_build(g, tab, gt, tabt, what):
    """K1's grid and patch table bitwise against the twin's."""
    import torch
    for f in ("origin", "mean", "information", "covariance", "count"):
        require(torch.equal(getattr(g, f), getattr(gt, f)),
                f"{what}: {f} differs")
    require(torch.equal(tab, tabt), f"{what}: patch table differs")


def one_row(res):
    """A twin's MatchResult of one scan as the kernel's [1, 13] row."""
    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    return k2.pack(k2.MatchResult(*[x[None] for x in res]))


def check_match(out, scores, twin_out, twin_scores, what):
    """K2's candidate scores and [R, 13] output rows (score, correction,
    covariance) bitwise against the twin's."""
    import torch
    require(torch.equal(scores, twin_scores), f"{what}: scores differ")
    require(torch.equal(out, twin_out), f"{what}: output rows differ")


def phase_rows(cfg, bag, dev):
    """K1/K2/K7 over ROWS confirmation rows at config-3 shapes."""
    import dataclasses

    import torch

    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.kernels import newton as k7
    from ndt_2d_tpu_torch.matching import matcher, newton
    gm = cfg.global_scan_matcher
    rmax = 12.0
    rows = office_rows(cfg, bag, dev)
    win, query = rows[:4], rows[4:]
    dths, dls = matcher._search_offsets(gm, dev)
    build = (rmax, gm.ndt_resolution, gm.grid_cells_x, gm.grid_cells_y)

    def k1_run():
        return k1.build_windows(*win, *build)

    def k1_twin():
        return k1.build_windows_twin(*win, *build)

    (g, tab), (gt, tabt) = k1_run(), k1_twin()
    torch.cuda.synchronize()
    check_build(g, tab, gt, tabt, "K1 rows")
    check_build(g, tab, *k1_run(), "K1 rows (reproducibility)")

    def k2_run(scores=False):
        return k2.match_rows(gm, g, tab, *query, dths, dls,
                             with_scores=scores)

    def k2_twin():
        return k2.match_rows_twin(gm, g, tab, *query, dths, dls)

    (k2_out, sc), (rest, sct) = k2_run(True), k2_twin()
    torch.cuda.synchronize()
    check_match(k2_out, sc, k2.pack(rest), sct, "K2 rows")
    check_match(k2_out, sc, *k2_run(True), "K2 rows (reproducibility)")

    # K7 over the rows: the office recipe's global polish (G = 1, 8
    # iterations) from K2's rows of the card, against its twin.
    rcfg = dataclasses.replace(gm, refine_iterations=8)

    def k7_run():
        return k7.refine_rows(rcfg, g, *query, k2_out.clone(), 8)

    def k7_twin():
        return k7.refine_rows_twin(rcfg, newton.with_row_grid_axes(g, True),
                                   *query, k2_out.clone(), 8)
    o7, o7t = k7_run(), k7_twin()
    torch.cuda.synchronize()
    require(torch.equal(o7, o7t), "K7 rows differ from the twin")
    require(torch.equal(o7, k7_run()), "K7 rows not bitwise reproducible")
    n_moved = int((o7[:, 1:4] != k2_out[:, 1:4]).any(dim=1).sum())

    # Row independence, without and with K7: the R = ROWS batch against
    # R = 1 launches and against the first rows at pad 4 and pad 16.
    for cfg in (gm, rcfg):
        full = matcher.match_scan_batch_multi(cfg, *win, rmax, *query)
        for r in range(ROWS):
            one = matcher.match_scan_batch_multi(
                cfg, *[t[r:r + 1] for t in win], rmax,
                *[t[r:r + 1] for t in query])
            require(all(torch.equal(a[r], b[0]) for a, b in zip(full, one)),
                    f"row {r} differs between R = {ROWS} and R = 1 "
                    f"(refine_iterations {cfg.refine_iterations})")
        for pad in (4, 16):
            p = padded_rows(rows, 3, pad)
            out = matcher.match_scan_batch_multi(cfg, *p[:4], rmax, *p[4:])
            require(all(torch.equal(a[:3], b[:3])
                        for a, b in zip(full, out)),
                    f"rows differ at pad {pad} (refine_iterations "
                    f"{cfg.refine_iterations})")
            require(bool((out[0][3:] == 0).all()),
                    f"padding rows at pad {pad} scored")
    n_live = int((k2_out[:, 0] < 0).sum())
    print(f"[3] K1/K2/K7 rows: {ROWS} office rows x {gm.grid_cells_x}^2 "
          f"cells x {dths.numel()}x{dls.numel()}x{dls.numel()} candidates, "
          f"{n_live} rows scored; K1, K2 (scores and rows) and K7 (8 "
          f"iterations) bitwise equal to their twins, {n_moved} rows moved "
          f"off the lattice by K7; each row bitwise equal to its R = 1 "
          f"launch and at pad 4 and 16, without and with K7")
    S, P = win[1].shape[1], win[1].shape[2]
    C = gm.grid_cells_x * gm.grid_cells_y
    qp, qm, qn, qpose = query
    return {"ndt_build_rows": timed(
                0.0, cuda_ms(k1_run, 20), cuda_ms(k1_twin, 2),
                nbytes(*win, g.origin, g.mean, g.information, g.covariance,
                       g.count, tab), ops_ndt_build(ROWS, 1, S * P, C)),
            "candidate_scores_rows": timed(
                0.0, cuda_ms(k2_run, 20), cuda_ms(k2_twin, 2),
                *sum_costs(cost_candidate_scores(
                    gm, g.origin[r], g.cell_size, qp[r], qm[r], int(qn[r]),
                    qpose[r], dths, dls) for r in range(ROWS))),
            "newton_rows": timed(
                0.0, cuda_ms(k7_run, 20), cuda_ms(k7_twin, 2),
                *sum_costs(cost_newton(
                    gm, g.origin[r], g.cell_size, g.count[r], qp[r], qm[r],
                    int(qn[r]), qpose[r] + k2_out[r, 1:4],
                    qpose[r] + o7[r, 1:4], 8) for r in range(ROWS)))}


def config8(cfg):
    """BASELINE config 8, "rolling_mapping_corridor_high_accuracy"
    (benchmarks/run_benchmarks.py:139-162): config 2 with overlapping grids
    and 10 Newton iterations on both matchers, no loop closure."""
    import dataclasses
    m = dataclasses.replace(cfg.local_scan_matcher, overlapping_grids=True,
                            refine_iterations=10)
    return dataclasses.replace(cfg, local_scan_matcher=m,
                               global_scan_matcher=m)


def phase_k8(cfg, win, query, dev):
    """K1, K2 (with its scores) and K3 (both entries) at G = 4 bitwise
    against their twins at config-8 shapes, the G = 4 build's first grid
    against the G = 1 build bitwise, and K7 on one config-8 local match
    (G = 4, 10 iterations) bitwise against its twin; times."""
    import torch

    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.kernels import newton as k7
    from ndt_2d_tpu_torch.kernels import score_points as k3
    from ndt_2d_tpu_torch.matching import matcher, newton
    mc = config8(cfg).local_scan_matcher
    W, H = mc.grid_cells_x, mc.grid_cells_y
    build = dict(range_max=15.0, cell_size=mc.ndt_resolution, width=W,
                 height=H)

    def k1_run():
        return k1.build_window(**win, **build, grids=4)

    def k1_twin():
        return k1.build_window_twin(**win, **build, grids=4)
    (g, tab), (gt, tabt) = k1_run(), k1_twin()
    g1, tab1 = k1.build_window(**win, **build)
    torch.cuda.synchronize()
    fields = ("origin", "mean", "information", "covariance", "count")
    check_build(g, tab, gt, tabt, "K1 G = 4")
    require(all(torch.equal(getattr(g, f)[0], getattr(g1, f))
                for f in fields) and torch.equal(tab[0], tab1),
            "K1 G = 4: grid 0 differs from the G = 1 build")
    check_build(g, tab, *k1_run(), "K1 G = 4 (reproducibility)")

    dths, dls = matcher._search_offsets(mc, dev)
    args = (mc, g, tab, query["points"], query["point_mask"],
            query["num_points"], query["pose"], dths, dls)
    out2, sc = k2.match(*args, with_scores=True)
    rest, sct = k2.match_twin(*args)
    torch.cuda.synchronize()
    check_match(out2, sc, one_row(rest), sct, "K2 G = 4")

    a3 = (g, W, H, mc.laser_max_beams, query["points"], query["point_mask"],
          query["num_points"])
    gen = torch.Generator(device=dev).manual_seed(5)
    poses = (query["pose"] + torch.randn(64, 3, generator=gen, device=dev)
             * 0.05).contiguous()
    u, ut = k3.score_at_pose(*a3, query["pose"]), \
        k3.score_at_pose_twin(*a3, query["pose"])
    ub, ubt = k3.score_batch(*a3, poses), k3.score_batch_twin(*a3, poses)
    torch.cuda.synchronize()
    require(torch.equal(u, ut) and torch.equal(ub, ubt),
            "K3 G = 4 differs from its twin")
    require(torch.equal(k3.score_at_pose(*a3, poses[7]), ub[7]),
            "K3 G = 4: a pose differs between the two entries")

    k7_args = (mc, g, query["points"], query["point_mask"],
               query["num_points"], query["pose"])

    def k7_run():
        return k7.refine(*k7_args, out2.clone(), mc.refine_iterations)

    nums = torch.tensor([query["num_points"]], dtype=torch.int32,
                        device=dev)

    def k7_twin():
        return k7.refine_rows_twin(
            mc, newton.with_row_grid_axes(g, False), query["points"][None],
            query["point_mask"][None], nums, query["pose"][None],
            out2.clone(), mc.refine_iterations)
    o7, o7t = k7_run(), k7_twin()
    torch.cuda.synchronize()
    require(torch.equal(o7, o7t), "K7 (G = 4) differs from its twin")
    require(torch.equal(o7, k7_run()), "K7 (G = 4) not reproducible")
    print(f"[3] K8 (G = 4) at config-8 shapes: K1 {int((g.count > 0).sum())} "
          f"occupied cells over 4 grids, bitwise equal to its twin, grid 0 "
          f"bitwise the G = 1 build; K2 scores and output row bitwise equal "
          f"to the twin, correction "
          f"{[round(float(x), 4) for x in out2[0, 1:4]]}; K3 both entries "
          f"bitwise equal to the twin; K7 ({mc.refine_iterations} "
          f"iterations) bitwise equal to its twin: score "
          f"{float(out2[0, 0]):.5f} -> {float(o7[0, 0]):.5f}, correction "
          f"{[round(float(x), 5) for x in o7[0, 1:4]]}")
    S, P = win["points"].shape[0], win["points"].shape[1]
    scan = args[3:6]
    return {"ndt_build_g4": timed(
                0.0, cuda_ms(k1_run, 20), cuda_ms(k1_twin, 3),
                nbytes(*win.values(), *[getattr(g, f) for f in fields], tab),
                ops_ndt_build(1, 4, S * P, W * H)),
            "candidate_scores_g4": timed(
                0.0, cuda_ms(lambda: k2.match(*args), 20),
                cuda_ms(lambda: k2.match_twin(*args), 3),
                *cost_candidate_scores(mc, g.origin, g.cell_size, *args[3:])),
            "score_points_g4": timed(
                0.0, cuda_ms(lambda: k3.score_at_pose(*a3, query["pose"]),
                             20),
                cuda_ms(lambda: k3.score_at_pose_twin(*a3, query["pose"]), 5),
                *cost_score_points(mc, g, *scan, query["pose"][None])),
            "newton": timed(
                0.0, cuda_ms(k7_run, 20), cuda_ms(k7_twin, 3),
                *cost_newton(mc, g.origin, g.cell_size, g.count, *scan,
                             query["pose"] + out2[0, 1:4],
                             query["pose"] + o7[0, 1:4],
                             mc.refine_iterations))}


class MatchRecorder:
    """Records the inputs and outputs of the first rolling matches of a
    session, for the twin replay."""

    def __init__(self, keep: int):
        from ndt_2d_tpu_torch.matching import matcher
        self.mod, self.real, self.keep = matcher, \
            matcher.match_scan_rolling, keep
        self.calls = []

    def match(self, config, window, range_max, *args):
        out = self.real(config, window, range_max, *args)
        if len(self.calls) < self.keep:
            win = tuple(getattr(window, f).clone()
                        for f in ("poses", "points", "point_mask", "mask"))
            self.calls.append((config, win, range_max,
                               [a.clone() if hasattr(a, "clone") else a
                                for a in args], [o.clone() for o in out]))
        return out

    def __enter__(self):
        self.mod.match_scan_rolling = self.match
        return self

    def __exit__(self, *exc):
        self.mod.match_scan_rolling = self.real


def phase_config8(cfg2, bag, dev, config2):
    """BASELINE config 8 on the card: the 200-scan corridor with four
    overlapping grids and 10 Newton iterations on both matchers; the first
    three matches replayed through the twins."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.kernels import newton as k7
    from ndt_2d_tpu_torch.kernels import score_points as k3
    from ndt_2d_tpu_torch.matching import matcher, newton
    cfg = config8(cfg2)
    with MatchRecorder(3) as rec:
        reset_counts()
        stats, grid, dt, _, _, _ = run_session(cfg, bag, dev)
        launches = read_counts()
    acc = stats["scans_accepted"]
    require(acc == len(bag), f"config 8 accepted {acc} of {len(bag)} scans")
    for k in ("ndt_build", "candidate_scores", "score_points", "newton"):
        require(launches[k] == acc - 1, f"config 8: {k} launched "
                f"{launches[k]} times, expected {acc - 1}")
    num = session_numbers(stats, bag, dt)
    require(np.isfinite(num["ate"]) and num["ate"] < num["odom"],
            f"config 8 ATE {num['ate']} not below odometry's {num['odom']}")
    require(int((grid.data == 100).sum()) > 0, "no occupied cells")
    print(f"[4f] config 8: {acc}/{len(bag)} scans accepted, "
          f"{num['ms']:.3f} ms/scan median (scans 4+), ATE {num['ate']:.4f} "
          f"m, aligned {num['aligned']:.4f} m (odometry {num['odom']:.4f}); "
          f"config 2 in this run: {config2['ms']:.3f} ms/scan, ATE "
          f"{config2['ate']:.4f} m, aligned {config2['aligned']:.4f} m; "
          f"launches {launches}")

    # Replay: K1's twin on the recorded window, K3's and K2's twins on the
    # kernel's grid, K7's twin from K2's kernel row; all bitwise.
    require(len(rec.calls) == 3, f"recorded {len(rec.calls)} matches")
    for mc, (poses, pts, pmask, wmask), rmax, args, out in rec.calls:
        qp, qm, n, pose = args
        W, H = mc.grid_cells_x, mc.grid_cells_y
        build = (rmax, mc.ndt_resolution, W, H, 4)
        g, tab = k1.build_window(poses, pts, pmask, wmask, *build)
        gt, tabt = k1.build_window_twin(poses, pts, pmask, wmask, *build)
        unc = k3.score_at_pose_twin(g, W, H, mc.laser_max_beams, qp, qm, n,
                                    pose)
        dths, dls = matcher._search_offsets(mc, dev)
        o2, sc = k2.match(mc, g, tab, qp, qm, n, pose, dths, dls,
                          with_scores=True)
        rest, sct = k2.match_twin(mc, g, tab, qp, qm, n, pose, dths, dls)
        o7 = k7.refine_rows_twin(
            mc, newton.with_row_grid_axes(g, False), qp[None], qm[None],
            torch.tensor([n], dtype=torch.int32, device=dev), pose[None],
            o2, mc.refine_iterations)
        torch.cuda.synchronize()
        check_build(g, tab, gt, tabt, "config-8 replay: K1")
        require(torch.equal(unc, out[0]), "config-8 replay: K3's twin")
        check_match(o2, sc, one_row(rest), sct, "config-8 replay: K2")
        require(torch.equal(o7[0, 0], out[1]) and torch.equal(o7[0, 1:4],
                                                               out[2]),
                "config-8 replay: K7's twin differs from the session")
    print("[4f] replay of the first 3 config-8 matches through the twins: "
          "K1, K2, K3 and K7 bitwise")
    return launches


def district_graph():
    """The config-5 district graph as benchmarks/run_benchmarks.py:522-554
    builds it: a serpentine survey with odometry and 10% of the column
    revisits as loop closures, noisy initial poses; exact truth."""
    import numpy as np
    n = DISTRICT_NODES
    rng = np.random.default_rng(0)
    side = int(np.sqrt(n))
    xs = np.arange(n) % side
    ys = np.arange(n) // side
    xs = np.where(ys % 2 == 0, xs, side - 1 - xs)
    truth = np.stack([xs.astype(np.float64) * 2.0, ys * 2.0,
                      rng.uniform(-0.3, 0.3, n)], -1)
    begin = np.arange(n - 1, dtype=np.int32)
    end = begin + 1
    lc_end = np.arange(n - side, dtype=np.int32)
    lc_begin = lc_end + side
    keep = rng.random(len(lc_begin)) < 0.1
    begin = np.concatenate([begin, lc_begin[keep]])
    end = np.concatenate([end, lc_end[keep]])
    d = truth[end, :2] - truth[begin, :2]
    c, s = np.cos(truth[begin, 2]), np.sin(truth[begin, 2])
    transform = np.stack([c * d[:, 0] + s * d[:, 1],
                          -s * d[:, 0] + c * d[:, 1],
                          truth[end, 2] - truth[begin, 2]], -1)
    info = np.tile(np.eye(3, dtype=np.float32) * 100.0, (len(begin), 1, 1))
    noisy = truth + rng.normal(0, [0.3, 0.3, 0.02], (n, 3))
    noisy[0] = truth[0]
    robust = np.arange(len(begin)) >= n - 1
    return truth, dict(poses=noisy, begin=begin, end=end,
                       transform=transform, information=info,
                       constraint_mask=np.ones(len(begin), bool),
                       node_mask=np.ones(n, bool), robust_mask=robust)


def phase_k4(district, dev):
    """K4's two entries against their twins on the district graph."""
    import torch

    from ndt_2d_tpu_torch import convert
    from ndt_2d_tpu_torch.kernels import normal_blocks as k4
    t = convert.solve_inputs_to_port(dev, **district)
    n = t["poses"].shape[0]
    inc = k4.incidence(t["begin"], t["end"], t["constraint_mask"], n)
    args = (t["poses"], t["begin"], t["end"], t["transform"],
            t["information"], t["constraint_mask"], t["robust_mask"])
    for loss in ("none", "huber", "geman_mcclure"):
        a = k4.normal_blocks(*args, loss, 1.0, inc)
        b = k4.normal_blocks_twin(*args, loss, 1.0, inc)
        torch.cuda.synchronize()
        names = ("Baa", "Bab", "Bbb", "ga", "gb", "g", "D")
        for name, x, y in zip(names, a, b):
            require(torch.equal(x, y),
                    f"K4 normal_blocks ({loss}): {name} differs from twin")
        again = k4.normal_blocks(*args, loss, 1.0, inc)
        require(all(torch.equal(x, y) for x, y in zip(a, again)),
                f"K4 normal_blocks ({loss}) not bitwise reproducible")
    baa, bab, bbb, _, _, _, d = a
    gen = torch.Generator(device=dev).manual_seed(0)
    v = torch.randn(n, 3, generator=gen, device=dev)
    fm = (torch.arange(n, device=dev) != 0).float()
    lam = torch.tensor(1e-3, device=dev)
    mv = (t["begin"], t["end"], baa, bab, bbb, d, lam, fm, v, inc)
    y, yt, y2 = k4.pcg_matvec(*mv), k4.pcg_matvec_twin(*mv), \
        k4.pcg_matvec(*mv)
    torch.cuda.synchronize()
    require(torch.equal(y, yt), "K4 pcg_matvec differs from twin")
    require(torch.equal(y, y2), "K4 pcg_matvec not bitwise reproducible")
    print(f"[3] K4 on the district ({n} nodes, {t['begin'].numel()} "
          "constraints): normal_blocks (none, huber, geman_mcclure) and "
          "pcg_matvec bitwise equal to their twins and reproducible")
    nb = args + ("none", 1.0, inc)
    C = t["begin"].numel()
    # The library yardstick of the matvec: the same product as one sparse
    # CSR matrix (assembled here, outside the timing) times v.
    csr = block_csr(t["begin"], t["end"], baa, bab, bbb, d, lam, fm, n)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lib = (csr @ v.reshape(-1, 1)).reshape(n, 3)
    require(torch.allclose(lib, y, rtol=1e-4, atol=1e-4 * float(
        y.abs().max())), "the sparse product differs from K4's matvec")
    # normal_blocks: per constraint the residual, its Jacobians, the robust
    # weight and three 3x3 blocks (~300 operations); pcg_matvec: four 3x3
    # block products and their sums a constraint (~70), ~6 a node.
    return {"normal_blocks": timed(
                0.0, cuda_ms(lambda: k4.normal_blocks(*nb), 20),
                cuda_ms(lambda: k4.normal_blocks_twin(*nb), 5),
                nbytes(*args, *a), 300 * C),
            "pcg_matvec": timed(
                0.0, cuda_ms(lambda: k4.pcg_matvec(*mv), 50),
                cuda_ms(lambda: k4.pcg_matvec_twin(*mv), 10),
                nbytes(t["begin"], t["end"], baa, bab, bbb, d, fm, v, y),
                70 * C + 6 * n,
                library_ms=cuda_ms(lambda: csr @ v.reshape(-1, 1), 50))}


def block_csr(begin, end, baa, bab, bbb, diag, lam, fm, n):
    """The matrix of K4's matvec, F (sum_c blocks + lam diag(D)) F with F
    the free-node mask, as a torch sparse CSR matrix [3n, 3n]."""
    import torch
    b, e = begin.long(), end.long()
    i3 = torch.arange(3, device=b.device)
    rows, cols, vals = [], [], []
    for (r, c), blk in (((b, b), baa), ((b, e), bab),
                        ((e, b), bab.transpose(1, 2)), ((e, e), bbb)):
        rows.append((3 * r[:, None, None] + i3[None, :, None]).expand(
            -1, 3, 3).reshape(-1))
        cols.append((3 * c[:, None, None] + i3[None, None, :]).expand(
            -1, 3, 3).reshape(-1))
        vals.append(blk.reshape(-1))
    node = torch.arange(n, device=b.device)
    rows.append((3 * node[:, None] + i3).reshape(-1))
    cols.append((3 * node[:, None] + i3).reshape(-1))
    vals.append((lam * torch.diagonal(diag, dim1=-2, dim2=-1)).reshape(-1))
    rows, cols, vals = (torch.cat(x) for x in (rows, cols, vals))
    f3 = fm.repeat_interleave(3)
    vals = vals * f3[rows] * f3[cols]
    with warnings.catch_warnings():  # torch calls sparse CSR "beta"
        warnings.simplefilter("ignore")
        coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                      (3 * n, 3 * n)).coalesce()
        return coo.to_sparse_csr()


def phase_district_solve(truth, district, dev):
    """The single-device PCG solve of the district (config 5's
    SolverConfig), on the kernels and then on the twins."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch import convert
    from ndt_2d_tpu_torch.graph import solver
    from ndt_2d_tpu_torch.config import SolverConfig
    cfg = SolverConfig(max_iterations=30, cg_max_iterations=150)
    t = convert.solve_inputs_to_port(dev, **district)
    t.pop("robust_mask")
    out = {}
    for twin in (False, True):
        if not twin:
            reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.solve(cfg, **t, use_dense=False, twin=twin)
        torch.cuda.synchronize()
        out[twin] = (res, time.perf_counter() - t0)
        if not twin:
            launches = read_counts()
    res, wall = out[False]
    poses = res.poses.cpu().numpy().astype(np.float64)

    def rmse(p):
        return float(np.sqrt(np.mean(np.sum((p[:, :2] - truth[:, :2]) ** 2,
                                            -1))))
    init, final = rmse(district["poses"]), rmse(poses)
    diff = float((res.poses - out[True][0].poses).abs().max())
    require(bool(res.success), "district solve failed")
    require(final < init, f"district RMSE {final} not below initial {init}")
    require(diff <= 1e-4, f"twin solve poses differ by {diff} > 1e-4")
    require(launches["pcg_matvec"] >= 1 and launches["normal_blocks"] >= 1,
            f"district solve launched {launches}")
    print(f"[4b] district PCG solve ({truth.shape[0]} nodes): RMSE "
          f"{init:.4f} -> {final:.4f} m in {int(res.iterations)} LM "
          f"iterations, {wall:.3f} s on the kernels, {out[True][1]:.3f} s "
          f"on the twins, max |kernel - twin| poses {diff:.3g}; launches "
          f"normal_blocks {launches['normal_blocks']}, pcg_matvec "
          f"{launches['pcg_matvec']}")
    return launches


class Recorder:
    """Records the inputs and outputs of the first calls of the
    confirmation and the solve during a session, for the twin replay."""

    def __init__(self, mapper):
        from ndt_2d_tpu_torch.graph import solver
        from ndt_2d_tpu_torch.matching import matcher
        self.matcher, self.solver = matcher, solver
        self.real_batch = matcher.match_scan_batch_multi
        self.real_solve = solver.solve
        self.mapper = mapper
        self.dispatches, self.solves, self.chunks = [], [], 0

    def batch(self, config, *args, **kw):
        out = self.real_batch(config, *args, **kw)
        self.chunks += 1
        if len(self.dispatches) < 2:
            m = self.mapper
            gate = (m.typical_matcher_response
                    * m.config.loop_closure_gate_scale)
            self.dispatches.append(
                (config, [a.clone() if hasattr(a, "clone") else a
                          for a in args], [o.clone() for o in out], gate))
        return out

    def solve(self, config, **kw):
        res = self.real_solve(config, **kw)
        if not self.solves:
            self.solves.append(
                (config, {k: v.clone() if hasattr(v, "clone") else v
                          for k, v in kw.items()}, res.poses.clone()))
        return res

    def __enter__(self):
        self.matcher.match_scan_batch_multi = self.batch
        self.solver.solve = self.solve
        return self

    def __exit__(self, *exc):
        self.matcher.match_scan_batch_multi = self.real_batch
        self.solver.solve = self.real_solve


def office_recipe_config():
    """Config 3 with the ``office`` recipe, as ``run --recipe office``
    builds it (gate scale 0.85, 3-scan regions, both search positions,
    Geman-McClure, global refine_iterations 8)."""
    return office_config("--recipe", "office")


def phase_office(cfg, bag, dev, tag="[4c]", plain=None):
    """The config-3 office session on the card, then the twin replay.  With
    ``plain`` (the plain config-3 run's numbers) this is the ``office``
    recipe run: its gates are >= 1 closure, >= 1 optimization and a final
    ATE below odometry's, and one K7 launch a confirmation chunk."""
    import numpy as np

    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    from ndt_2d_tpu_torch.utils import metrics
    mapper = Mapper(cfg, device=dev)
    with Recorder(mapper) as rec:
        reset_counts()
        t0 = time.perf_counter()
        stats, grid, dt, _, acc_flags, _ = run_session(cfg, bag, dev,
                                                       mapper=mapper)
        wall = time.perf_counter() - t0
        launches = read_counts()
    acc = stats["scans_accepted"]
    st = mapper.stats
    used = bag.truth[np.nonzero(acc_flags)[0]]
    online = stats["ate_rmse_m"]
    final = metrics.ate_rmse(mapper.graph.poses[:acc], used)
    odom = metrics.ate_rmse(bag.odom, bag.truth)
    require(st.loop_closures_accepted >= 1, "no loop closure accepted")
    require(st.optimizations >= 1, "no optimization ran")
    require(plain is not None or final <= online * 1.10 + 1e-6,
            f"final ATE {final} above 1.10 x online {online}")
    require(final < odom, f"final ATE {final} not below odometry's {odom}")
    require(launches["newton"] == (rec.chunks if plain else 0),
            f"newton launched {launches['newton']} times with "
            f"{rec.chunks} confirmation chunks")
    for k in ("ndt_build", "candidate_scores"):
        require(launches[k] == acc - 1 + rec.chunks,
                f"{k} launched {launches[k]} times, expected {acc - 1} "
                f"rolling + {rec.chunks} confirmation chunks")
    require(launches["score_points"] == acc - 1, "score_points count")
    require(launches["normal_blocks"] >= 1 and launches["raymarch"] >= 1,
            f"K4/K5 never launched: {launches}")
    require(int((grid.data == 100).sum()) > 0, "no occupied cells")
    timing = st.timer.summary()
    ms = float(np.median(dt[acc_flags][4:]) * 1e3)
    numbers = dict(closures=st.loop_closures_accepted,
                   rejected=st.loop_closures_rejected,
                   optimizations=st.optimizations, online=online,
                   final=final, ms=ms,
                   lc_ms=timing["loop_closure"]["mean_ms"])
    name = "office recipe" if plain else "office config 3"
    print(f"{tag} {name}: {acc}/{len(bag)} scans accepted, "
          f"{st.loop_closures_accepted} closures accepted, "
          f"{st.loop_closures_rejected} rejected, {st.optimizations} "
          f"optimizations, {rec.chunks} confirmation chunks, "
          f"{st.confirm_rows_reused} rows reused; ATE online {online:.4f} "
          f"final {final:.4f} m (odometry {odom:.4f}); {ms:.3f} ms per "
          f"accepted scan (median), loop_closure "
          f"{timing['loop_closure']['mean_ms']:.3f} ms x "
          f"{timing['loop_closure']['count']}, optimize "
          f"{timing['optimize']['mean_ms']:.3f} ms x "
          f"{timing['optimize']['count']}; session {wall:.2f} s; "
          f"launches {launches}")
    if plain:
        print(f"{tag} beside plain config 3 in this run: closures "
              f"{plain['closures']} -> {numbers['closures']}, rejected "
              f"{plain['rejected']} -> {numbers['rejected']}, optimizations "
              f"{plain['optimizations']} -> {numbers['optimizations']}, "
              f"final ATE {plain['final']:.4f} -> {numbers['final']:.4f} m, "
              f"loop_closure {plain['lc_ms']:.3f} -> {numbers['lc_ms']:.3f} "
              f"ms, {plain['ms']:.3f} -> {ms:.3f} ms per accepted scan")
    phase_replay(rec, tag, 1 if plain else 2, solve=not plain)
    return launches, numbers


def phase_replay(rec, tag, dispatches, solve=True):
    """The first recorded dispatches (and the first solve) again, through
    the twins on the same CUDA inputs; K7's twin follows K2's where the
    global matcher refines."""
    import torch

    from ndt_2d_tpu_torch.graph import solver
    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.kernels import newton as k7
    from ndt_2d_tpu_torch.matching import matcher, newton
    require(len(rec.dispatches) >= dispatches and (rec.solves or not solve),
            f"recorded {len(rec.dispatches)} dispatches and "
            f"{len(rec.solves)} solves")
    rows = 0
    for config, args, out, gate in rec.dispatches[:dispatches]:
        poses, points, pmask, wmask, rmax, qp, qm, qn, st = args
        grid, tables = k1.build_windows_twin(
            poses, points, pmask, wmask, rmax, config.ndt_resolution,
            config.grid_cells_x, config.grid_cells_y)
        twin, _ = k2.match_rows_twin(
            config, grid, tables, qp, qm, qn, st,
            *matcher._search_offsets(config, qp.device))
        scores = twin.score
        if config.refine_iterations > 0:
            scores = k7.refine_rows_twin(
                config, newton.with_row_grid_axes(grid, True), qp, qm, qn,
                st, k2.pack(twin), config.refine_iterations)[:, 0]
        live = wmask.any(dim=1)
        k, t = out[0][live], scores[live]
        require(torch.equal(k, t), "replayed confirmation scores differ")
        require(torch.equal(k < gate, t < gate),
                "replayed gate decisions differ")
        rows += int(live.sum())
    if not solve:
        print(f"{tag} replay through the twins: {rows} rows of "
              f"{dispatches} dispatch(es), scores bitwise equal, same gate "
              f"decisions")
        return
    config, kw, poses = rec.solves[0]
    res = solver.solve(config, **kw, twin=True)
    diff = float((res.poses - poses).abs().max())
    require(diff <= 1e-4, f"replayed solve differs by {diff}")
    print(f"{tag} replay through the twins: {rows} rows of {dispatches} "
          f"dispatches, scores bitwise equal, same gate decisions; first "
          f"solve "
          f"({int(kw['node_mask'].sum())} nodes) poses within {diff:.3g}")


def config4_configs():
    """BASELINE config 4 as benchmarks/run_benchmarks.py:378-426 sets it up:
    the mapping config and the particle-filter config."""
    import dataclasses

    from ndt_2d_tpu_torch.config import (
        MapperConfig, ParticleFilterConfig, ScanMatcherConfig)
    m = ScanMatcherConfig(grid_cells_x=192, grid_cells_y=192)
    base = MapperConfig(local_scan_matcher=m, global_scan_matcher=m,
                        max_points_per_scan=512)
    pf = dataclasses.replace(
        ParticleFilterConfig(), min_particles=max(100, PARTICLES // 10),
        max_particles=PARTICLES, odom_alpha1=0.05, odom_alpha2=0.05,
        odom_alpha3=0.05, odom_alpha4=0.05)
    return (dataclasses.replace(base, loop_closure_every=10**9),
            dataclasses.replace(base, use_particle_filter=True,
                                particle_filter=pf))


def map_and_save(cfg, scans, path, dev):
    """Map ``scans`` [(msg, odom pose)] with the port and save the graph;
    returns the number of keyframes."""
    from ndt_2d_tpu_torch.mapping.mapper import SAVE_TO_FILE, Mapper
    mapper = Mapper(cfg, device=dev)
    for msg, odom in scans:
        mapper.process_scan(msg, odom)
    mapper.configure(SAVE_TO_FILE, path)
    return mapper.graph.num_scans


def localizer(cfg, path, dev, seed):
    from ndt_2d_tpu_torch.mapping.mapper import LOAD_FROM_FILE, Mapper
    loc = Mapper(cfg, seed=seed, device=dev)
    loc.configure(LOAD_FROM_FILE, path)
    return loc


def phase_pf_kernels(path, bag4, dev):
    """K3 over poses and K9 against their twins on the config-4 grid (the
    loaded box map's global NDT) with the same scores and draws, at the
    particle counts of config 4 and config 7; times at both."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.mapping import laser
    from ndt_2d_tpu_torch.utils import metrics
    _, cfg = config4_configs()
    loc = localizer(cfg, path, dev, 3)
    loc._ensure_matchers(bag4.range_max)
    t = 40
    rel = metrics.relative_to_first(bag4.truth)
    pts, msk = laser.project_scan(bag4[t][0], bag4.range_max, np.zeros(3),
                                  False, None, cfg.max_points_per_scan)
    scan = (torch.tensor(pts, device=dev), torch.tensor(msk, device=dev),
            int(msk.sum()))
    center = torch.tensor(rel[t], dtype=torch.float32, device=dev)
    out = {}
    for M, suffix in ((PARTICLES, ""),
                      (GLOBAL_PARTICLES, f"_{GLOBAL_PARTICLES}")):
        times = pf_kernels_at(loc.global_matcher, cfg.particle_filter, scan,
                              center, M, dev)
        out.update({k + suffix: v for k, v in times.items()})
    return out


def pf_kernels_at(m, pcfg, scan, center, M, dev):
    """K3 over M poses around ``center`` and K9 on those scores: each
    bitwise equal to its twin and reproducible; returns the times."""
    import torch

    from ndt_2d_tpu_torch.filter import motion_model
    from ndt_2d_tpu_torch.filter import particle_filter as pf_mod
    from ndt_2d_tpu_torch.kernels import particle_filter as k9
    from ndt_2d_tpu_torch.kernels import score_points as k3
    W, H = m.config.grid_cells_x, m.config.grid_cells_y
    B = m.config.laser_max_beams
    q, qm, n = scan
    gen = torch.Generator(device=dev).manual_seed(11)
    poses = (center + torch.randn(M, 3, generator=gen, device=dev)
             * torch.tensor([0.2, 0.2, 0.05], device=dev)).contiguous()
    sa = (m.grid, W, H, B, q, qm, n, poses)
    sc, sct = k3.score_batch(*sa), k3.score_batch_twin(*sa)
    torch.cuda.synchronize()
    require(torch.equal(sc, sct), f"K3 batch ({M} poses) differs from its "
            "twin")
    for i in range(0, M, M // 64):
        one = k3.score_at_pose(m.grid, W, H, B, q, qm, n, poses[i])
        require(torch.equal(one, sc[i]), f"K3 batch row {i} of {M} differs "
                "from its M = 1 launch")
    require(torch.equal(k3.score_batch(*sa), sc),
            f"K3 batch ({M} poses) not bitwise reproducible")
    print(f"[3] K3 batch: {M} poses on the config-4 grid ({W}x{H}), "
          f"scores {float(sc.min()):.4f}..{float(sc.max()):.4f}, bitwise "
          f"equal to the twin, 64 rows bitwise equal to their M = 1 launch")
    out = {"score_points_batch": timed(
        max_abs_diff([(sc, sct)]), cuda_ms(lambda: k3.score_batch(*sa), 20),
        cuda_ms(lambda: k3.score_batch_twin(*sa), 5),
        *cost_score_points(m.config, m.grid, q, qm, n, poses))}

    # K9 on those scores, with one set of draws for kernel and twin.
    free = torch.rand(30000, 2, generator=gen, device=dev) * 8.0
    draws = pf_mod.draw_step(gen, M, dev, free.shape[0])
    scal = motion_model.motion_scalars(0.05, 0.002, 0.03, 0.05, 0.05, 0.05,
                                       0.05)
    pm, pmt = k9.motion(poses, draws.motion, scal), \
        k9.motion_twin(poses, draws.motion, scal)
    torch.cuda.synchronize()
    require(torch.equal(pm, pmt), f"K9 motion ({M}) differs from its twin")
    bins = (pcfg.kld_bin_x, pcfg.kld_bin_y, pcfg.kld_bin_theta)
    n_in = torch.tensor([M], dtype=torch.int32, device=dev)
    inj = k9.Injection(free, 0.05, draws.inject_sel, draws.inject_idx,
                       draws.inject_jitter, draws.inject_theta)
    w0 = torch.tensor([0.9, 0.5], device=dev)
    rec = k9.Recovery(w0, 0.001, 0.1, True, inj)
    args = (sc, n_in, draws.resample, pm, bins, 0.01, 2.3,
            pcfg.min_particles)
    ns, errs = [], {}
    for name, r in (("plain", None), ("recovery", rec)):
        a, b = k9.resample(*args, r), k9.resample_twin(*args, r)
        torch.cuda.synchronize()
        fields = [f for f in a._fields if getattr(a, f) is not None]
        pairs = [(getattr(a, f), getattr(b, f)) for f in fields]
        for f, (x, y) in zip(fields, pairs):
            require(torch.equal(x, y), f"K9 resample ({name}, {M}): {f} "
                    "differs from its twin")
        errs[name] = max_abs_diff(pairs)
        again = k9.resample(*args, r)
        require(all(torch.equal(getattr(a, f), getattr(again, f))
                    for f in a._fields if getattr(a, f) is not None),
                f"K9 resample ({name}, {M}) not bitwise reproducible")
        ns.append(int(a.n[0]))
        if r is not None:
            moved = int((a.particles != pm[a.idx.long()]).any(1).sum())
            require(moved > 0, "recovery resample injected nothing")
            ew = k9.ewma(sc, n_in, w0, 0.001, 0.1)
            require(torch.equal(ew, k9.ewma_twin(sc, n_in, w0, 0.001, 0.1))
                    and torch.equal(ew, a.w_state),
                    f"K9 ewma ({M}) differs from its twin or the resample's")
    st, stt = k9.statistics(pm, sc, n_in), k9.statistics_twin(pm, sc, n_in)
    torch.cuda.synchronize()
    st_pairs = [(getattr(st, f), getattr(stt, f))
                for f in ("particles", "weights", "normalized", "n", "stats")]
    require(all(torch.equal(x, y) for x, y in st_pairs),
            f"K9 statistics ({M}) differ from the twin")
    print(f"[3] K9: motion, resample (n_active {ns[0]} plain, {ns[1]} with "
          f"recovery), the EWMAs alone and statistics on {M} particles "
          f"bitwise equal to their twins (n_active, drawn indices, "
          f"first-occurrence marks, particles, weights, w_slow/w_fast, mean, "
          f"covariance) and reproducible")
    # K9: motion ~40 operations a particle (odometry model, normalize);
    # resample ~60 (weights, CDF, binary search, hash, marks, statistics);
    # statistics ~40 (normalize, weighted mean and covariance).  The
    # resample's library yardstick is torch.cumsum of the M weights, the
    # function of its CDF launch alone (no one call resamples).
    res_a = k9.resample(*args)
    res_moved = nbytes(sc, pm, draws.resample,
                       *[getattr(res_a, f) for f in res_a._fields
                         if getattr(res_a, f) is not None])
    cumsum_ms = cuda_ms(lambda: torch.cumsum(sc, 0), 20)
    out["pf_motion"] = timed(
        max_abs_diff([(pm, pmt)]),
        cuda_ms(lambda: k9.motion(poses, draws.motion, scal), 20),
        cuda_ms(lambda: k9.motion_twin(poses, draws.motion, scal), 5),
        nbytes(poses, draws.motion, pm), 40 * M)
    out["pf_resample"] = timed(
        errs["plain"], cuda_ms(lambda: k9.resample(*args), 20),
        cuda_ms(lambda: k9.resample_twin(*args), 3), res_moved, 60 * M,
        library_ms=cumsum_ms)
    out["pf_resample_recovery"] = timed(
        errs["recovery"], cuda_ms(lambda: k9.resample(*args, rec), 20),
        cuda_ms(lambda: k9.resample_twin(*args, rec), 3),
        res_moved + nbytes(free), 80 * M, library_ms=cumsum_ms)
    out["pf_statistics"] = timed(
        max_abs_diff(st_pairs),
        cuda_ms(lambda: k9.statistics(pm, sc, n_in), 20),
        cuda_ms(lambda: k9.statistics_twin(pm, sc, n_in), 3),
        nbytes(pm, sc, *[x for x, _ in st_pairs]), 40 * M)
    return out


class StepRecorder:
    """Records the inputs and outputs of the first filter steps of a
    session, for the twin replay."""

    def __init__(self, keep: int):
        from ndt_2d_tpu_torch.filter import particle_filter
        self.mod, self.real, self.keep = particle_filter, \
            particle_filter.pf_step, keep
        self.steps = []

    def step(self, *args, **kw):
        out = self.real(*args, **kw)
        if len(self.steps) < self.keep:
            self.steps.append((args, out))
        return out

    def __enter__(self):
        self.mod.pf_step = self.step
        return self

    def __exit__(self, *exc):
        self.mod.pf_step = self.real


class TwinTrap:
    """Counts calls of the K3-batch and K9 twins while it is active."""

    NAMES = {"score_points": ("score_batch_twin", "score_at_pose_twin"),
             "particle_filter": ("motion_twin", "resample_twin",
                                 "statistics_twin")}

    def __init__(self):
        from ndt_2d_tpu_torch.kernels import particle_filter, score_points
        self.mods = {"score_points": score_points,
                     "particle_filter": particle_filter}
        self.calls = 0
        self.saved = []

    def __enter__(self):
        for key, names in self.NAMES.items():
            mod = self.mods[key]
            for name in names:
                real = getattr(mod, name)
                self.saved.append((mod, name, real))

                def counted(*a, _real=real, **kw):
                    self.calls += 1
                    return _real(*a, **kw)
                setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)


def track(loc, scans, rel):
    """Run (t, msg, odom) scans through ``loc``; returns the position
    errors of the accepted scans against ``rel``, their indices t, and the
    seconds of every process_scan."""
    import numpy as np
    errs, ts, times = [], [], []
    for t, msg, odom in scans:
        t0 = time.perf_counter()
        res = loc.process_scan(msg, odom)
        times.append(time.perf_counter() - t0)
        if res.accepted:
            errs.append(float(np.hypot(*(res.pose[:2] - rel[t][:2]))))
            ts.append(t)
    return np.asarray(errs), np.asarray(ts), np.asarray(times)


def phase_config4(path_map, keyframes, dev):
    """BASELINE config 4 on the card: load the saved box map of
    ``keyframes`` keyframes, localize with the particle filter, replay its
    first steps through the twins, then the scan-match branch on the same
    map and bag."""
    import dataclasses

    import numpy as np
    import torch

    from ndt_2d_tpu_torch.io.bag import record_synthetic
    from ndt_2d_tpu_torch.utils import metrics
    mapping, cfg = config4_configs()
    loc_bag = record_synthetic("box", 150, n_beams=360, seed=7,
                               odom_trans_noise=0.01)
    rel = metrics.relative_to_first(loc_bag.truth)
    odom_rel = metrics.relative_to_first(loc_bag.odom)
    scans = [(t, msg, odom) for t, (msg, odom) in enumerate(loc_bag)
             if t > 0]
    reset_counts()
    loc = localizer(cfg, path_map, dev, 3)
    loc.set_initial_pose(rel[0], np.diag([0.04, 0.04, 0.01]),
                         loc_bag.truth[0])
    with StepRecorder(3) as rec:
        errs, ts, times = track(loc, scans, rel)
    torch.cuda.synchronize()
    launches = read_counts()
    steps = len(errs)
    require(steps >= 50, f"PF accepted {steps} of {len(scans)} scans")
    # Odometry alone over the same scans, from the same initial pose.
    odom_err = float(np.mean(np.hypot(*(odom_rel[ts, :2] - rel[ts, :2]).T)))
    for k in ("score_points_batch", "pf_motion", "pf_resample"):
        require(launches[k] == steps,
                f"{k} launched {launches[k]} times, expected {steps}")
    require(launches["pf_statistics"] >= 1, "pf_statistics never launched")
    require(launches["ndt_build"] >= 1, "the global NDT was not built")
    mean_err, final_err = float(np.mean(errs)), float(errs[-1])
    require(np.isfinite(errs).all() and mean_err <= 0.10,
            f"PF mean position error {mean_err} > 0.10 m")
    require(mean_err < odom_err, f"PF mean error {mean_err} not below "
            f"odometry's {odom_err}")
    pf_t = loc.stats.timer.summary()["pf_step"]
    print(f"[4d] config 4: {keyframes}-keyframe box map saved and loaded; "
          f"PF {PARTICLES} particles over {steps} accepted of "
          f"{len(scans)} scans: mean position "
          f"error {mean_err:.4f} m, final {final_err:.4f} m (odometry "
          f"{odom_err:.4f} m), {np.median(times[2:]) * 1e3:.3f} ms/scan "
          f"median, pf_step {pf_t['mean_ms']:.3f} ms x {pf_t['count']}, "
          f"n_active at the end {loc.filter.n_active}; launches {launches}")
    phase_pf_replay(rec, "[4d]", 3)

    # The scan-match branch on the same map and bag.
    sm_cfg = dataclasses.replace(mapping, enable_mapping=False)
    reset_counts()
    sm = localizer(sm_cfg, path_map, dev, 0)
    sm.set_initial_pose(rel[0], np.diag([0.04, 0.04, 0.01]),
                        loc_bag.truth[0])
    serrs, _, stimes = track(sm, scans, rel)
    sm_launches = read_counts()
    sm_mean = float(np.mean(serrs))
    require(len(serrs) == steps, f"scan-match accepted {len(serrs)} scans, "
            f"the PF {steps}")
    require(sm_mean <= 0.12, f"scan-match mean error {sm_mean} > 0.12 m")
    for k in ("candidate_scores", "score_points"):
        require(sm_launches[k] == len(serrs), f"scan-match {k} launched "
                f"{sm_launches[k]} times, expected {len(serrs)}")
    print(f"[4d] scan-match branch: mean position error {sm_mean:.4f} m, "
          f"final {float(serrs[-1]):.4f} m, "
          f"{np.median(stimes[2:]) * 1e3:.3f} ms/scan median; launches "
          f"{sm_launches}")
    return launches


def twin_step(draws, particles, n, control, mcfg, grid, points, point_mask,
              num_points, alphas, kld_err, kld_z, bins, min_particles):
    """A recorded ``pf_step``'s inputs through the twins: the motion sample,
    K3 over the moved particles, the KLD resample and statistics."""
    from ndt_2d_tpu_torch.filter import motion_model
    from ndt_2d_tpu_torch.kernels import particle_filter as k9
    from ndt_2d_tpu_torch.kernels import score_points as k3
    p = k9.motion_twin(particles, draws.motion,
                       motion_model.motion_scalars(*control, *alphas))
    scores = k3.score_batch_twin(grid, mcfg.grid_cells_x, mcfg.grid_cells_y,
                                 mcfg.laser_max_beams, points, point_mask,
                                 num_points, p)
    return k9.resample_twin(scores, n, draws.resample, p, bins, kld_err,
                            kld_z, min_particles)


def phase_pf_replay(rec, tag, steps):
    """The first ``steps`` recorded filter steps again, through the twins
    with the same draws: the same n_active and particles, bit for bit."""
    import torch
    require(len(rec.steps) == steps, f"recorded {len(rec.steps)} steps")
    for i, (args, out) in enumerate(rec.steps):
        twin = twin_step(*args)
        require(torch.equal(out.n, twin.n), f"replayed step {i}: n_active")
        require(torch.equal(out.particles, twin.particles),
                f"replayed step {i}: particles differ")
        require(torch.equal(out.stats, twin.stats),
                f"replayed step {i}: mean/covariance differ")
    print(f"{tag} replay of the first {steps} filter steps "
          f"({out.particles.shape[0]} particles) through the twins: "
          f"n_active {[int(o.n[0]) for _, o in rec.steps]}, particles, "
          f"mean and covariance bitwise equal")


def phase_config7(path_map, dev):
    """BASELINE config 7: global relocalization, 20,000 particles seeded
    over the free space of the symmetry-broken office."""
    import dataclasses

    import numpy as np
    import torch

    from ndt_2d_tpu_torch.config import (
        MapperConfig, ParticleFilterConfig, ScanMatcherConfig)
    from ndt_2d_tpu_torch.utils import metrics, sim
    world = np.concatenate([sim.make_office_world(16.0),
                            np.asarray([[[1.0, 13.0], [3.0, 15.0]]])],
                           axis=0)
    n = 40
    truth = np.stack([np.linspace(2.0, 10.0, n), np.full(n, 2.0),
                      np.zeros(n)], axis=-1)
    m = ScanMatcherConfig(grid_cells_x=192, grid_cells_y=192)
    mapping = MapperConfig(local_scan_matcher=m, global_scan_matcher=m,
                           max_points_per_scan=512, loop_closure_every=10**9,
                           max_range=14.0)
    cfg = dataclasses.replace(
        mapping, use_particle_filter=True,
        particle_filter=dataclasses.replace(
            ParticleFilterConfig(), min_particles=200,
            max_particles=GLOBAL_PARTICLES, odom_alpha1=0.05,
            odom_alpha2=0.05, odom_alpha3=0.05, odom_alpha4=0.05))

    def scan(t, seed):
        return sim.scan_at_pose(world, truth[t], n_beams=240, range_max=14.0,
                                noise=0.01, rng=np.random.default_rng(seed))
    rel = metrics.relative_to_first(truth)
    odom = sim.drift_odometry(truth, 0.01, 0.003, seed=31)
    scans = [(t, scan(t, 900 + t), odom[t]) for t in range(1, n)]
    with TwinTrap() as trap:
        reset_counts()
        map_and_save(mapping, [(scan(t, t), truth[t]) for t in range(n)],
                     path_map, dev)
        loc = localizer(cfg, path_map, dev, 7)
        require(loc.global_localize(truth[0]), "global_localize failed")
        spread = float(loc.filter.get_covariance()[0, 0])
        with StepRecorder(2) as rec:
            errs, ts, times = track(loc, scans, rel)
        torch.cuda.synchronize()
        launches = read_counts()
    require(trap.calls == 0, f"{trap.calls} twin calls on the CUDA path")
    steps = len(errs)
    for k in ("score_points_batch", "pf_motion", "pf_resample"):
        require(launches[k] == steps, f"config 7: {k} launched "
                f"{launches[k]} times, expected {steps}")
    require(launches["raymarch"] >= 1, "config 7: the free space was not "
            "rendered on K5")
    conv = next((int(t) for t, e in zip(ts, errs) if e < 0.5), None)
    print(f"[4e] config 7: {GLOBAL_PARTICLES} particles over the free space "
          f"(initial x variance {spread:.3f} m^2), {steps} scans; converged "
          f"(< 0.5 m) at scan {conv}, final error {float(errs[-1]):.4f} m, "
          f"{np.median(times[2:]) * 1e3:.3f} ms/scan median; no twin ran; "
          f"launches {launches}")
    phase_pf_replay(rec, "[4e]", 2)
    return launches


def profile_sessions(dev, warmup: int = 20) -> None:
    """``--profile``: the mapping sessions of [4a], [4f], [4c] and [4g],
    each with ``torch.profiler`` over every scan after the first
    ``warmup``; one JSON line each: wall and device-busy ms per accepted
    scan (busy = the union of the kernel and copy intervals), the device's
    idle share, and the kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    bag, cfg2, _, _, _ = inputs(dev)
    bag3 = office_bag()
    for name, cfg, b in (("config 2", cfg2, bag), ("config 8", config8(cfg2),
                                                   bag),
                         ("config 3", office_config(), bag3),
                         ("office recipe", office_recipe_config(), bag3)):
        mapper = Mapper(cfg, device=dev)
        scans = list(b)
        for msg, odom in scans[:warmup]:
            mapper.process_scan(msg, odom)
        torch.cuda.synchronize()
        accepted = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for msg, odom in scans[warmup:]:
                accepted += mapper.process_scan(msg, odom).accepted
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans, kernels = [], {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            spans.append((e.time_range.start, e.time_range.end))
            k = kernels.setdefault(e.name[:60], [0.0, 0])
            k[0] += (e.time_range.end - e.time_range.start) / 1e3
            k[1] += 1
        busy, end = 0.0, float("-inf")
        for s, e in sorted(spans):
            busy += max(0.0, e - max(s, end))
            end = max(end, e)
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
        print(json.dumps({
            "session": name, "scans": len(scans) - warmup,
            "accepted": accepted,
            "wall_ms_per_accepted": wall * 1e3 / max(accepted, 1),
            "device_ms_per_accepted": busy / 1e3 / max(accepted, 1),
            "idle_share": 1.0 - busy / 1e6 / wall,
            "kernels_ms": {k: [round(v[0], 3), v[1]] for k, v in top}}))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed")
        return 2
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False")
        return 2
    if "--profile" in sys.argv[1:]:
        from ndt_2d_tpu_torch.device import get_device
        profile_sessions(get_device("cuda:0"))
        return 0
    try:
        from ndt_2d_tpu_torch.device import get_device
        from ndt_2d_tpu_torch.io.bag import record_synthetic
        dev = get_device("cuda:0")
        ident = phase_card()
        phase_build()
        bag, cfg, win, query, rays = inputs(dev)
        timing = phase_kernels(cfg, win, query, rays, dev)
        timing.update(phase_k8(cfg, win, query, dev))
        cfg3, bag3 = office_config(), office_bag()
        timing.update(phase_rows(cfg3, bag3, dev))
        truth, district = district_graph()
        timing.update(phase_k4(district, dev))
        bag4 = record_synthetic("box", 150, n_beams=360, seed=2)
        with tempfile.TemporaryDirectory() as tmp:
            map4 = os.path.join(tmp, "box_map.npz")
            keyframes = map_and_save(config4_configs()[0], bag4, map4, dev)
            timing.update(phase_pf_kernels(map4, bag4, dev))
            _, config2 = phase_session(cfg, bag, dev)
            c8_launches = phase_config8(cfg, bag, dev, config2)
            district_launches = phase_district_solve(truth, district, dev)
            launches, plain3 = phase_office(cfg3, bag3, dev)
            phase_office(office_recipe_config(), bag3, dev, "[4g]", plain3)
            pf_launches = phase_config4(map4, keyframes, dev)
            phase_config7(os.path.join(tmp, "office_map.npz"), dev)
        require("jax" not in sys.modules, "jax was imported")
    except SmokeFailure as e:
        print(f"FAIL: {e}")
        return 1
    # Launch counts from the config-3 session, which runs every kernel but
    # the PCG matvec, the batched K3 and K9; the PCG matvec's from the
    # district solve, the others' from the config-4 particle filter.
    launches["pcg_matvec"] = district_launches["pcg_matvec"]
    for k in ("score_points_batch", "pf_motion", "pf_resample",
              "pf_statistics"):
        launches[k] = pf_launches[k]
    # K7 and the G = 4 launches of K1/K2/K3 from the config-8 session.
    launches["newton"] = c8_launches["newton"]
    for k in ("ndt_build", "candidate_scores", "score_points"):
        launches[f"{k}_g4"] = c8_launches[k]
    # K1/K2 times and errors at config-3 confirmation shapes (64 rows);
    # the config-2 single-window ones are printed at [3].
    for k in ("ndt_build", "candidate_scores"):
        timing[f"{k}_config2"] = timing[k]
        timing[k] = timing.pop(f"{k}_rows")
    rows = []
    for name, (src, replaces) in KERNELS.items():
        t = timing[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name], **t})
    for name, t in timing.items():
        lib = ("" if t["library_ms"] is None
               else f", library {t['library_ms']:.4f} ms")
        print(f"[5] {name}: kernel {t['ms']:.4f} ms, twin "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']}){lib} ({ident})")
    print(ident)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
