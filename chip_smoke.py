#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
 1. require CUDA; print the card (nvidia-smi name and power limit), the
    torch/CUDA versions and nvcc's;
 2. build the kernels of ``ndt_2d_tpu_torch/csrc`` with nvcc;
 3. at the shapes of the rolling-mapping configuration (10-scan window of
    512 points, 192x192 NDT cells, 80x21x21 candidates x 100 beams, the
    200-scan occupancy export) hold each kernel against its plain-PyTorch
    twin on the same CUDA inputs, check K1/K2/K5 are bitwise reproducible,
    and time kernel and twin with CUDA events;
 4. map a 200-scan, 600-beam synthetic corridor through the port's
    ``Mapper`` and ``run_bag`` (no loop closure), export the occupancy grid,
    require every scan accepted, ATE below odometry's, occupied cells, and
    launch counts K1 = K2 = K3 = accepted - 1, K5 >= 1; then map the first
    20 scans on the GPU and on the CPU twins and require the same decisions;
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
}
N_SCANS = 200
N_BEAMS = 600


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
    require(torch.allclose(sc, sct, rtol=1e-5, atol=1e-5),
            "K2 scores differ from twin beyond rtol/atol 1e-5")
    flat = sct.reshape(-1)
    top2 = torch.topk(flat, 2, largest=False).values
    if float(top2[1] - top2[0]) > 1e-4 * abs(float(top2[0])):
        require(torch.equal(res.correction, rest.correction),
                "K2 argmin/correction differs from twin")
        require(abs(float(res.score - rest.score))
                <= 1e-5 * abs(float(rest.score)), "K2 score differs")
    d = torch.sqrt(torch.diagonal(rest.covariance).abs())
    require(bool(((res.covariance - rest.covariance).abs()
                  <= 1e-4 * d[:, None] * d[None, :]).all()),
            "K2 covariance differs from twin")
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


def counters():
    from ndt_2d_tpu_torch.kernels import (
        candidate_scores, ndt_build, raymarch, score_points)
    return {"ndt_build": ndt_build, "candidate_scores": candidate_scores,
            "score_points": score_points, "raymarch": raymarch}


def run_session(cfg, bag, device, n=None):
    """Map ``bag`` (its first ``n`` scans) through the port; returns
    (stats, grid, per-scan seconds, corrections)."""
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
    mapper = Mapper(cfg, device=device)
    stamps, corr = [time.perf_counter()], []

    def progress(t, res):
        stamps.append(time.perf_counter())
        corr.append(res.correction if res.correction is not None
                    else np.zeros(3))

    stats = runtime.run_bag(mapper, bag, progress=progress)
    grid = mapper.render_map()
    if device != "cpu":
        torch.cuda.synchronize()
    return stats, grid, np.diff(stamps), np.asarray(corr)


def phase_session(cfg, bag):
    import numpy as np
    mods = counters()
    for m in mods.values():
        m.launches = 0
    stats, grid, dt, _ = run_session(cfg, bag, "cuda")
    launches = {k: m.launches for k, m in mods.items()}
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
    print(f"[4] {acc}/{len(bag)} scans accepted, "
          f"{stats['graph_constraints']} constraints, ATE {ate:.4f} m "
          f"(odometry {odom:.4f} m), {ms:.3f} ms/scan median (scans 4+), "
          f"grid {grid.data.shape[0]}x{grid.data.shape[1]} with {occupied} "
          f"occupied cells; launches {launches}")

    # The same decisions as the plain twins on a small input.
    n = 20
    sg, gg, _, cg = run_session(cfg, bag, "cuda", n)
    sc, gc, _, cc = run_session(cfg, bag, "cpu", n)
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
    print(f"[4] first {n} scans, GPU vs CPU twins: {exact:.2f} of "
          f"corrections equal, ATE {sg['ate_rmse_m']:.5f} vs "
          f"{sc['ate_rmse_m']:.5f}, {same:.4f} of grid cells equal")
    return launches


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
        launches = phase_session(cfg, bag)
        require("jax" not in sys.modules, "jax was imported")
    except SmokeFailure as e:
        print(f"FAIL: {e}")
        return 1
    rows = []
    for name, (src, replaces) in KERNELS.items():
        t = timing[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"]})
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
