"""Visualization exports: the port's copy of ``ndt_2d_tpu/utils/viz.py``.

The reference's observability *is* its visualization (SURVEY.md section 5.5):
a latched ``map`` OccupancyGrid, a ``graph`` MarkerArray (red sphere per node,
blue odometry edges, green switchable/loop-closure edges,
src/graph.cpp:191-256), and a ``particlecloud`` PoseArray
(src/particle_filter.cpp:149-161).  Without ROS, the equivalents here render
to PNG files (matplotlib Agg) and structured dicts, from the same data.
matplotlib is imported inside ``_agg`` only, so importing this module (or
the live server, which imports it lazily) never needs it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _agg():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def occupancy_to_image(data: np.ndarray) -> np.ndarray:
    """int8 occupancy grid -> uint8 grayscale (ROS map_saver convention:
    occupied black, free white, unknown mid-gray)."""
    img = np.full(data.shape, 205, np.uint8)   # unknown
    img[data == 0] = 254                       # free
    img[data == 100] = 0                       # occupied
    return img[::-1]  # image row 0 at the top; world y up


def save_occupancy_png(grid, path: str) -> None:
    """Render an OccupancyGridResult to a PNG."""
    plt = _agg()
    img = occupancy_to_image(np.asarray(grid.data))
    h, w = img.shape
    ox, oy = np.asarray(grid.origin)[:2]
    extent = (ox, ox + w * grid.resolution, oy, oy + h * grid.resolution)
    fig, ax = plt.subplots(figsize=(max(4, w / 50), max(4, h / 50)))
    ax.imshow(img, cmap="gray", vmin=0, vmax=255, extent=extent,
              interpolation="nearest")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def save_graph_png(graph, path: str, grid=None,
                   particles: Optional[np.ndarray] = None,
                   truth: Optional[np.ndarray] = None) -> None:
    """Render the pose graph the way Graph::getMsg colors it
    (src/graph.cpp:191-256): red nodes, blue odometry edges, green
    loop-closure (switchable) edges; optionally over the occupancy grid,
    with the particle cloud and/or ground-truth overlaid.
    """
    plt = _agg()
    fig, ax = plt.subplots(figsize=(8, 8))

    if grid is not None:
        img = occupancy_to_image(np.asarray(grid.data))
        h, w = img.shape
        ox, oy = np.asarray(grid.origin)[:2]
        ax.imshow(img, cmap="gray", vmin=0, vmax=255,
                  extent=(ox, ox + w * grid.resolution,
                          oy, oy + h * grid.resolution),
                  interpolation="nearest")

    poses = np.asarray(graph.poses, np.float64)
    begin = np.asarray(graph.constraint_begin)
    end = np.asarray(graph.constraint_end)
    switchable = np.asarray(graph.constraint_switchable)

    for sw, color, label in ((False, "tab:blue", "odometry"),
                             (True, "tab:green", "loop closure")):
        sel = switchable == sw
        if sel.any():
            segs = np.stack([poses[begin[sel], :2], poses[end[sel], :2]],
                            axis=1)
            for s in segs:
                ax.plot(s[:, 0], s[:, 1], color=color, linewidth=1.0,
                        zorder=2 + sw)
            ax.plot([], [], color=color, label=label)

    if truth is not None:
        truth = np.asarray(truth)
        ax.plot(truth[:, 0], truth[:, 1], color="0.4", linestyle="--",
                linewidth=1.0, label="ground truth", zorder=1)
    if particles is not None and len(particles):
        particles = np.asarray(particles)
        ax.scatter(particles[:, 0], particles[:, 1], s=2, color="tab:orange",
                   alpha=0.5, label=f"particles ({len(particles)})", zorder=4)
    if len(poses):
        ax.scatter(poses[:, 0], poses[:, 1], s=6, color="tab:red",
                   label=f"nodes ({len(poses)})", zorder=5)

    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend(loc="upper right", fontsize=8)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
