#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
 1. require CUDA; print the card (nvidia-smi name and power limit), the
    torch/CUDA versions and nvcc's;
 2. build the kernels of ``ndt_2d_tpu_torch/csrc`` with nvcc (one process
    per source, in parallel);
 3. hold each kernel against its plain-PyTorch twin on the same CUDA inputs,
    check it is bitwise reproducible, and time kernel and twin with CUDA
    events: K1/K2/K3/K5 at the rolling-mapping shapes of config 2 (10-scan
    window of 512 points, 192x192 cells, 80x21x21 candidates x 100 beams,
    the 200-scan export); K1/K2 over 64 loop-closure confirmation rows of
    real office windows at config-3 shapes (2-scan regions, 160x160 cells
    of 0.35 m, 40x30x30 candidates), each row bitwise equal to its R = 1
    launch and to itself at pad 4 and pad 16; K4 (normal_blocks,
    pcg_matvec) on the 50,000-node district graph of config 5;
 4. drive the main paths, each with the launch counts set to 0 before and
    read after: (a) the 200-scan, 600-beam config-2 corridor through
    ``Mapper`` and ``run_bag`` (no loop closure) with its export: every scan
    accepted, ATE below odometry's, K1 = K2 = K3 = accepted - 1, K5 >= 1,
    and the first 20 scans on the GPU against the CPU twins; (b) the
    single-device PCG ``solve`` of the district, on the kernels and on the
    twins: final RMSE below the initial, the twin's poses within 1e-4 m;
    (c) the full 2000-scan config-3 office loop (radius loop closure +
    optimization) with its export: >= 1 accepted closure and >= 1
    optimization, final ATE <= 1.10 x online and below odometry's, K1/K2
    launches = accepted - 1 + confirmation chunks, K4 >= 1; the first two
    confirmation dispatches and the first solve of that session are
    replayed through the twins on the card and must reach the same gate
    decisions (scores within 1e-5 relative) and poses within 1e-4;
 5. print the kernels' JSON line and, last, the device JSON line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

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
}
N_SCANS = 200
N_BEAMS = 600
OFFICE_SCANS = 2000
ROWS = 64
DISTRICT_NODES = 50_000


class SmokeFailure(Exception):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` on the device, from CUDA events."""
    import torch
    fn()  # warm-up
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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
    from ndt_2d_tpu_torch.shared import (
        MapperConfig, ScanMatcherConfig, laser, record_synthetic)
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
    """Each kernel against its twin on the same CUDA inputs, bitwise
    reproducibility of K1/K2/K5, and times."""
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

    # K1: count exact, float fields rtol 1e-5.
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
    require(torch.equal(g.count, gt.count), "K1 count differs from twin")
    err = 0.0
    for name, a, b in [("origin", g.origin, gt.origin),
                       ("mean", g.mean, gt.mean),
                       ("information", g.information, gt.information),
                       ("covariance", g.covariance, gt.covariance),
                       ("table", tab, tabt)]:
        require(torch.allclose(a, b, rtol=1e-5, atol=0),
                f"K1 {name} differs from twin beyond rtol 1e-5")
        err = max(err, float((a - b).abs().max()))
    g2, tab2 = k1_run()
    require(all(torch.equal(x, y) for x, y in [
        (g.mean, g2.mean), (g.information, g2.information),
        (g.covariance, g2.covariance), (g.count, g2.count), (tab, tab2)]),
        "K1 not bitwise reproducible")
    print(f"[3] K1 ndt_build: {int((g.count > 0).sum())} occupied cells, "
          f"max |kernel - twin| {err:.3g} (count exact, rtol 1e-5)")
    out["ndt_build"] = dict(max_abs_err=err, ms=cuda_ms(k1_run, 20),
                            plain_ms=cuda_ms(k1_twin, 5))

    # K2 on the kernel-built grid: scores rtol/atol 1e-5, argmin where the
    # top-2 gap exceeds 1e-4 |best|, covariance within 1e-4 of
    # sqrt(cov_ii cov_jj) (off-diagonals sum to near zero over the
    # symmetric lattice, so a plain rtol would test rounding noise).
    from ndt_2d_tpu_torch.matching.matcher import _search_offsets
    dths, dls = _search_offsets(mc, dev)
    args = (mc, g, tab, query["points"], query["point_mask"],
            query["num_points"], query["pose"], dths, dls)
    res, sc = k2.match(*args, with_scores=True)
    rest, sct = k2.match_twin(*args)
    torch.cuda.synchronize()

    def row(r):
        return k2.MatchResult(*[x[None] for x in r])
    check_match_rows(row(res), sc[None], row(rest), sct[None], "K2")
    res2, sc2 = k2.match(*args, with_scores=True)
    require(torch.equal(sc, sc2) and torch.equal(res.covariance,
                                                 res2.covariance)
            and torch.equal(res.score, res2.score),
            "K2 not bitwise reproducible")
    print(f"[3] K2 candidate_scores: {sc.numel()} candidates, score "
          f"{float(res.score):.5f} correction "
          f"{[round(float(x), 4) for x in res.correction]}, max |kernel - "
          f"twin| {float((sc - sct).abs().max()):.3g}")
    out["candidate_scores"] = dict(
        max_abs_err=float((sc - sct).abs().max()),
        ms=cuda_ms(lambda: k2.match(*args), 20),
        plain_ms=cuda_ms(lambda: k2.match_twin(*args), 5))

    # K3: atol 1e-6.
    a3 = (g, W, H, mc.laser_max_beams, query["points"], query["point_mask"],
          query["num_points"], query["pose"])
    u, ut = k3.score_at_pose(*a3), k3.score_at_pose_twin(*a3)
    err3 = float((u - ut).abs())
    require(err3 <= 1e-6, f"K3 differs from twin by {err3}")
    print(f"[3] K3 score_points: {float(u):.6f} vs twin {float(ut):.6f}")
    out["score_points"] = dict(
        max_abs_err=err3, ms=cuda_ms(lambda: k3.score_at_pose(*a3), 20),
        plain_ms=cuda_ms(lambda: k3.score_at_pose_twin(*a3), 5))

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
    out["raymarch"] = dict(max_abs_err=0.0,
                           ms=cuda_ms(lambda: k5.raymarch_counts(*a5), 10),
                           plain_ms=cuda_ms(
                               lambda: k5.raymarch_counts_twin(*a5), 3))
    return out


def reset_counts():
    from ndt_2d_tpu_torch.kernels import (
        candidate_scores, ndt_build, normal_blocks, raymarch, score_points)
    for m in (ndt_build, candidate_scores, score_points, raymarch):
        m.launches = 0
    for k in normal_blocks.launches:
        normal_blocks.launches[k] = 0


def read_counts() -> dict:
    from ndt_2d_tpu_torch.kernels import (
        candidate_scores, ndt_build, normal_blocks, raymarch, score_points)
    out = {"ndt_build": ndt_build.launches,
           "candidate_scores": candidate_scores.launches,
           "score_points": score_points.launches,
           "raymarch": raymarch.launches}
    out.update(normal_blocks.launches)
    return out


def run_session(cfg, bag, device, n=None, mapper=None):
    """Map ``bag`` (its first ``n`` scans) through the port (``mapper``,
    else a new one); returns (stats, grid, per-scan seconds, corrections,
    accepted flags, mapper)."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.mapping import runtime
    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    from ndt_2d_tpu_torch.shared import ScanBag
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


def phase_session(cfg, bag, dev):
    import numpy as np
    reset_counts()
    stats, grid, dt, _, _, _ = run_session(cfg, bag, dev)
    launches = read_counts()
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
    return launches


def office_config():
    """BASELINE.json config 3, the synchronous arm of
    benchmarks/run_benchmarks.py:248-276."""
    import dataclasses

    from ndt_2d_tpu_torch.shared import MapperConfig, ScanMatcherConfig
    local = ScanMatcherConfig(grid_cells_x=192, grid_cells_y=192)
    global_m = ScanMatcherConfig(
        ndt_resolution=0.35, search_linear_size=0.15,
        search_linear_resolution=0.01, search_angular_size=0.05,
        grid_cells_x=160, grid_cells_y=160)
    return dataclasses.replace(
        MapperConfig(local_scan_matcher=local, global_scan_matcher=local,
                     max_points_per_scan=512),
        global_scan_matcher=global_m, global_search_size=4.0,
        optimization_node_limit=10, loop_closure_every=20,
        loop_search="radius", minimum_travel_distance=0.3)


def office_bag():
    from ndt_2d_tpu_torch.shared import record_synthetic
    return record_synthetic("office", OFFICE_SCANS, n_beams=N_BEAMS,
                            range_max=12.0, seed=1, odom_trans_noise=0.02,
                            odom_rot_noise=0.004)


def office_rows(cfg, bag, dev):
    """ROWS confirmation rows of real office windows: the 2-scan region
    (k, k + 10) at its odometry poses, matched by scan k + 15 from its own
    odometry pose, for k spread over the bag."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.shared import laser
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


def check_match_rows(res, scores, twin, twin_scores, what):
    """K2 rows against the twin: scores rtol/atol 1e-5; per row, where the
    best two candidates are more than 1e-4 |best| apart, the same
    correction and a score within 1e-5 relative; covariance within 1e-4
    of sqrt(cov_ii cov_jj)."""
    import torch
    require(torch.allclose(scores, twin_scores, rtol=1e-5, atol=1e-5),
            f"{what}: scores differ from twin beyond rtol/atol 1e-5")
    for r in range(scores.shape[0]):
        top2 = torch.topk(twin_scores[r].reshape(-1), 2,
                          largest=False).values
        if float(top2[1] - top2[0]) > 1e-4 * abs(float(top2[0])):
            require(torch.equal(res.correction[r], twin.correction[r]),
                    f"{what}: row {r} correction differs from twin")
            require(abs(float(res.score[r] - twin.score[r]))
                    <= 1e-5 * abs(float(twin.score[r])),
                    f"{what}: row {r} score differs from twin")
        d = torch.sqrt(torch.diagonal(twin.covariance[r]).abs())
        require(bool(((res.covariance[r] - twin.covariance[r]).abs()
                      <= 1e-4 * d[:, None] * d[None, :]).all()),
                f"{what}: row {r} covariance differs from twin")


def phase_rows(cfg, bag, dev):
    """K1/K2 over ROWS confirmation rows at config-3 shapes."""
    import torch

    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.matching import matcher
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
    require(torch.equal(g.count, gt.count), "K1 rows: count differs")
    err1 = 0.0
    for name, a, b in [("origin", g.origin, gt.origin), ("mean", g.mean,
                        gt.mean), ("information", g.information,
                                   gt.information),
                       ("covariance", g.covariance, gt.covariance),
                       ("table", tab, tabt)]:
        require(torch.allclose(a, b, rtol=1e-5, atol=0),
                f"K1 rows: {name} differs from twin beyond rtol 1e-5")
        err1 = max(err1, float((a - b).abs().max()))
    g2, tab2 = k1_run()
    require(torch.equal(tab, tab2) and torch.equal(g.mean, g2.mean)
            and torch.equal(g.covariance, g2.covariance),
            "K1 rows not bitwise reproducible")

    def k2_run(scores=False):
        return k2.match_rows(gm, g, tab, *query, dths, dls,
                             with_scores=scores)

    def k2_twin():
        return k2.match_rows_twin(gm, g, tab, *query, dths, dls)

    (res, sc), (rest, sct) = k2_run(True), k2_twin()
    torch.cuda.synchronize()
    check_match_rows(res, sc, rest, sct, "K2 rows")
    err2 = float((sc - sct).abs().max())
    res2, sc2 = k2_run(True)
    require(torch.equal(sc, sc2) and torch.equal(res.score, res2.score)
            and torch.equal(res.covariance, res2.covariance),
            "K2 rows not bitwise reproducible")

    # Row independence: the R = ROWS batch against R = 1 launches and
    # against the first rows at pad 4 and pad 16.
    full = matcher.match_scan_batch_multi(gm, *win, rmax, *query)
    for r in range(ROWS):
        one = matcher.match_scan_batch_multi(
            gm, *[t[r:r + 1] for t in win], rmax,
            *[t[r:r + 1] for t in query])
        require(all(torch.equal(a[r], b[0]) for a, b in zip(full, one)),
                f"row {r} differs between R = {ROWS} and R = 1")
    for pad in (4, 16):
        p = padded_rows(rows, 3, pad)
        out = matcher.match_scan_batch_multi(gm, *p[:4], rmax, *p[4:])
        require(all(torch.equal(a[:3], b[:3]) for a, b in zip(full, out)),
                f"rows differ at pad {pad}")
        require(bool((out[0][3:] == 0).all()),
                f"padding rows at pad {pad} scored")
    n_live = int((res.score < 0).sum())
    print(f"[3] K1/K2 rows: {ROWS} office rows x {gm.grid_cells_x}^2 cells "
          f"x {dths.numel()}x{dls.numel()}x{dls.numel()} candidates, "
          f"{n_live} rows scored; K1 max |kernel - twin| {err1:.3g}, K2 "
          f"scores {err2:.3g}; each row bitwise equal to its R = 1 launch "
          f"and at pad 4 and 16")
    return {"ndt_build_rows": dict(max_abs_err=err1, ms=cuda_ms(k1_run, 20),
                                   plain_ms=cuda_ms(k1_twin, 2)),
            "candidate_scores_rows": dict(max_abs_err=err2,
                                          ms=cuda_ms(k2_run, 20),
                                          plain_ms=cuda_ms(k2_twin, 2))}


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
    return {"normal_blocks": dict(
                max_abs_err=0.0, ms=cuda_ms(lambda: k4.normal_blocks(*nb),
                                            20),
                plain_ms=cuda_ms(lambda: k4.normal_blocks_twin(*nb), 5)),
            "pcg_matvec": dict(
                max_abs_err=0.0, ms=cuda_ms(lambda: k4.pcg_matvec(*mv), 50),
                plain_ms=cuda_ms(lambda: k4.pcg_matvec_twin(*mv), 10))}


def phase_district_solve(truth, district, dev):
    """The single-device PCG solve of the district (config 5's
    SolverConfig), on the kernels and then on the twins."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch import convert
    from ndt_2d_tpu_torch.graph import solver
    from ndt_2d_tpu_torch.shared import SolverConfig
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


def phase_office(cfg, bag, dev):
    """The config-3 office session on the card, then the twin replay."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    from ndt_2d_tpu_torch.shared import metrics
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
    require(final <= online * 1.10 + 1e-6,
            f"final ATE {final} above 1.10 x online {online}")
    require(final < odom, f"final ATE {final} not below odometry's {odom}")
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
    print(f"[4c] office config 3: {acc}/{len(bag)} scans accepted, "
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
    phase_replay(rec)
    return launches


def phase_replay(rec):
    """The recorded dispatches and solve again, through the twins on the
    same CUDA inputs."""
    import torch

    from ndt_2d_tpu_torch.graph import solver
    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.matching import matcher
    require(len(rec.dispatches) == 2 and rec.solves,
            f"recorded {len(rec.dispatches)} dispatches and "
            f"{len(rec.solves)} solves")
    rows = 0
    for config, args, out, gate in rec.dispatches:
        poses, points, pmask, wmask, rmax, qp, qm, qn, st = args
        grid, tables = k1.build_windows_twin(
            poses, points, pmask, wmask, rmax, config.ndt_resolution,
            config.grid_cells_x, config.grid_cells_y)
        twin, _ = k2.match_rows_twin(
            config, grid, tables, qp, qm, qn, st,
            *matcher._search_offsets(config, qp.device))
        live = wmask.any(dim=1)
        k, t = out[0][live], twin.score[live]
        require(bool(((k - t).abs() <= 1e-5 * t.abs() + 1e-7).all()),
                "replayed confirmation scores differ beyond 1e-5 relative")
        require(torch.equal(k < gate, t < gate),
                "replayed gate decisions differ")
        rows += int(live.sum())
    config, kw, poses = rec.solves[0]
    res = solver.solve(config, **kw, twin=True)
    diff = float((res.poses - poses).abs().max())
    require(diff <= 1e-4, f"replayed solve differs by {diff}")
    print(f"[4c] replay through the twins: {rows} rows of 2 dispatches, "
          f"same gate decisions; first solve "
          f"({int(kw['node_mask'].sum())} nodes) poses within {diff:.3g}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed")
        return 2
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False")
        return 2
    try:
        from ndt_2d_tpu_torch.device import get_device
        dev = get_device("cuda:0")
        ident = phase_card()
        phase_build()
        bag, cfg, win, query, rays = inputs(dev)
        timing = phase_kernels(cfg, win, query, rays, dev)
        cfg3, bag3 = office_config(), office_bag()
        timing.update(phase_rows(cfg3, bag3, dev))
        truth, district = district_graph()
        timing.update(phase_k4(district, dev))
        phase_session(cfg, bag, dev)
        district_launches = phase_district_solve(truth, district, dev)
        launches = phase_office(cfg3, bag3, dev)
        require("jax" not in sys.modules, "jax was imported")
    except SmokeFailure as e:
        print(f"FAIL: {e}")
        return 1
    # Launch counts from the config-3 session, which runs every kernel but
    # the PCG matvec; that one's from the district solve.
    launches["pcg_matvec"] = district_launches["pcg_matvec"]
    # K1/K2 times and errors at config-3 confirmation shapes (64 rows);
    # the config-2 single-window ones are printed at [3].
    for k in ("ndt_build", "candidate_scores"):
        timing[f"{k}_config2"] = timing[k]
        timing[k] = timing.pop(f"{k}_rows")
    rows = []
    for name, (src, replaces) in KERNELS.items():
        t = timing[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"]})
    for name, t in timing.items():
        print(f"[5] {name}: kernel {t['ms']:.4f} ms, twin "
              f"{t['plain_ms']:.4f} ms ({ident})")
    print(ident)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
