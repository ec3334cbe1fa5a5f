"""A City10000-shaped 2D pose graph, made from a seed (plain NumPy).

The robot of Olson et al.'s Manhattan world (ICRA 2006, the M3500 graph)
drives on the unit grid of a square city: one metre a step, turning left
or right at an intersection with a fixed chance, and turning back into the
city at its edge.  Every place it revisits offers loop closures to its
earlier visits.  Kaess et al.'s City10000 (iSAM, T-RO 2008) is such a
graph with 10,000 poses, 9,999 odometry edges and 10,688 loop closures;
this generator draws exactly those counts for every seed (the closures a
seeded choice among all revisits), adds Gaussian noise to every
measurement, and chains the noisy odometry from the first pose into the
initial estimate, the papers' poor initial estimate.

``graph(spec, seed, index)`` returns a dict of NumPy arrays: ``truth`` and
``initial`` [N, 3]; ``begin``, ``end`` [C] int32 (odometry edges first,
then the closures in the order of their later pose); ``transform`` [C, 3];
``information`` [C, 3, 3].  The sizes and noise levels come from ``spec``,
the configuration's ``graph`` object.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

# Headings of the four grid directions, counter-clockwise from east.
_STEPS = np.asarray([[1, 0], [0, 1], [-1, 0], [0, -1]], np.int64)


def _rng(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    """The generator of one stream of the seed's graph ``index`` (``seed``
    any whole number)."""
    key = [int(seed) % (1 << 63), stream] + ([index] if index else [])
    return np.random.default_rng(key)


def drive(poses: int, city: int, turn: float,
          rng: np.random.Generator) -> np.ndarray:
    """[poses, 2] int grid cells and [poses] headings (0-3) of the drive."""
    cells = np.zeros((poses, 2), np.int64)
    heads = np.zeros(poses, np.int64)
    cell = np.asarray([city // 2, city // 2], np.int64)
    head = 0
    draws = rng.random((poses, 2))
    for i in range(1, poses):
        if draws[i, 0] < turn:
            head = (head + (1 if draws[i, 1] < 0.5 else 3)) % 4
        nxt = cell + _STEPS[head]
        if not ((0 <= nxt) & (nxt < city)).all():
            # At the city's edge: turn left, else right, else back.
            for h in ((head + 1) % 4, (head + 3) % 4, (head + 2) % 4):
                nxt = cell + _STEPS[h]
                if ((0 <= nxt) & (nxt < city)).all():
                    head = h
                    break
        cell = nxt
        cells[i] = cell
        heads[i] = head
    return cells, heads


def relative(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[..., 3] pose of b in a's frame, the angle wrapped to [-pi, pi)."""
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    dx, dy = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    dth = b[..., 2] - a[..., 2]
    dth = dth - 2.0 * np.pi * np.floor((dth + np.pi) / (2.0 * np.pi))
    return np.stack([c * dx + s * dy, -s * dx + c * dy, dth], -1)


def compose(a: np.ndarray, z: np.ndarray) -> np.ndarray:
    """[3] pose a, then the motion z [3] in a's frame."""
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.asarray([a[0] + c * z[0] - s * z[1],
                       a[1] + s * z[0] + c * z[1], a[2] + z[2]])


def closures(cells: np.ndarray, count: int, gap: int,
             rng: np.random.Generator) -> np.ndarray:
    """[count, 2] (earlier, later) pose pairs at one grid cell, at least
    ``gap`` poses apart: a seeded choice among all such revisits, ordered
    by the later pose, then the earlier."""
    key = cells[:, 0] * (cells[:, 1].max() + 1) + cells[:, 1]
    order = np.argsort(key, kind="stable")
    pairs = []
    bounds = np.flatnonzero(np.diff(key[order])) + 1
    for group in np.split(order, bounds):
        if len(group) < 2:
            continue
        a, b = np.meshgrid(group, group, indexing="ij")
        keep = b - a >= gap
        pairs.append(np.stack([a[keep], b[keep]], -1))
    pairs = np.concatenate(pairs)
    if len(pairs) < count:
        raise ValueError(f"the drive revisits {len(pairs)} times, fewer "
                         f"than the {count} closures asked for")
    pick = pairs[rng.choice(len(pairs), count, replace=False)]
    return pick[np.lexsort((pick[:, 0], pick[:, 1]))]


def graph(spec: dict, seed: int, index: int = 0) -> dict:
    """The seed's pose graph ``index`` under the configuration's ``spec``."""
    n = int(spec["poses"])
    cells, heads = drive(n, int(spec["city_m"]), float(spec["turn_chance"]),
                         _rng(seed, 0, index))
    truth = np.concatenate([cells.astype(np.float64),
                            (heads * (np.pi / 2.0))[:, None]], 1)
    truth[:, 2] -= 2.0 * np.pi * np.floor((truth[:, 2] + np.pi)
                                          / (2.0 * np.pi))
    loops = closures(cells, int(spec["loop_closures"]),
                     int(spec["closure_min_gap"]), _rng(seed, 1, index))
    begin = np.concatenate([np.arange(n - 1), loops[:, 0]]).astype(np.int32)
    end = np.concatenate([np.arange(1, n), loops[:, 1]]).astype(np.int32)
    sigma = np.asarray([spec["sigma_xy_m"], spec["sigma_xy_m"],
                        spec["sigma_theta_rad"]], np.float64)
    noise = _rng(seed, 2, index).normal(0.0, 1.0, (len(begin), 3)) * sigma
    transform = relative(truth[begin], truth[end]) + noise
    information = np.broadcast_to(np.diag(1.0 / sigma ** 2),
                                  (len(begin), 3, 3)).copy()
    initial = np.zeros_like(truth)
    initial[0] = truth[0]
    for i in range(1, n):
        initial[i] = compose(initial[i - 1], transform[i - 1])
    return {"truth": truth, "initial": initial, "begin": begin, "end": end,
            "transform": transform, "information": information}


def cached(spec: dict, seed: int, index: int, cache: str) -> dict:
    """``graph(spec, seed, index)``, read from (or first written to) a file
    in the ``cache`` folder named by its arguments."""
    key = json.dumps([spec, int(seed), int(index)], sort_keys=True)
    digest = hashlib.sha256(key.encode()).hexdigest()[:16]
    path = os.path.join(cache, f"city_graph_{digest}.npz")
    if os.path.isfile(path):
        with np.load(path) as saved:
            return {k: saved[k] for k in saved.files}
    g = graph(spec, seed, index)
    os.makedirs(cache, exist_ok=True)
    part = path + ".part.npz"
    np.savez(part, **g)
    os.replace(part, path)
    return g

