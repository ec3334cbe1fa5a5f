"""Map (graph) persistence: the port's copy of the map half of
``ndt_2d_tpu/io/serialization.py``.

The reference checkpoints the full graph — every scan (id, pose, points) and
every constraint — to a rosbag2 file (Graph::save / load ctor,
src/graph.cpp:49-165).  Both packages keep the same semantics in one
portable npz schema, so a map saved by either loads in the other.  The
session checkpoints (``save_session`` / ``load_session``) are not here:
they hold the mapper's and the particle filter's runtime state.
"""

from __future__ import annotations

import numpy as np

from ndt_2d_tpu_torch.graph.pose_graph import Graph

FORMAT_VERSION = 1


def save_graph(graph: Graph, filename: str) -> None:
    np.savez_compressed(
        filename,
        version=np.int32(FORMAT_VERSION),
        use_barycenter=np.bool_(graph.use_barycenter),
        poses=graph.poses,
        points=graph.points,
        point_mask=graph.point_mask,
        constraint_begin=graph.constraint_begin,
        constraint_end=graph.constraint_end,
        constraint_transform=graph.constraint_transform,
        constraint_information=graph.constraint_information,
        constraint_switchable=graph.constraint_switchable,
    )


def load_graph(filename: str, max_points_per_scan: int,
               use_barycenter: bool = True) -> Graph:
    with np.load(filename) as data:
        graph = Graph(max_points_per_scan, bool(data["use_barycenter"]))
        points = data["points"]
        mask = data["point_mask"]
        if points.shape[1] != max_points_per_scan:
            # Re-pad to the configured capacity.
            s = points.shape[0]
            p = min(points.shape[1], max_points_per_scan)
            np_points = np.zeros((s, max_points_per_scan, 2), np.float32)
            np_mask = np.zeros((s, max_points_per_scan), bool)
            np_points[:, :p] = points[:, :p]
            np_mask[:, :p] = mask[:, :p]
            points, mask = np_points, np_mask
        for i in range(points.shape[0]):
            graph.add_scan(data["poses"][i], points[i], mask[i])
        for j in range(data["constraint_begin"].shape[0]):
            graph.add_constraint(
                int(data["constraint_begin"][j]),
                int(data["constraint_end"][j]),
                data["constraint_transform"][j],
                data["constraint_information"][j],
                bool(data["constraint_switchable"][j]))
    graph.use_barycenter = use_barycenter
    return graph


def save_tum(path: str, times, poses) -> None:
    """Write an SE(2) trajectory in TUM format (`t x y z qx qy qz qw`, yaw
    as a z-axis quaternion) so external tools like evo can evaluate it
    against other systems.  The reference has no trajectory export at all.
    """
    times = np.asarray(times, np.float64)
    poses = np.asarray(poses, np.float64)
    with open(path, "w") as f:
        for t, (x, y, th) in zip(times, poses):
            f.write(f"{t:.6f} {x:.6f} {y:.6f} 0.000000 0.000000 0.000000 "
                    f"{np.sin(th / 2.0):.9f} {np.cos(th / 2.0):.9f}\n")


def load_tum(path: str):
    """Read a TUM trajectory back as (times [T], poses [T, 3])."""
    rows = np.loadtxt(path, ndmin=2)
    yaw = 2.0 * np.arctan2(rows[:, 6], rows[:, 7])
    return rows[:, 0], np.stack([rows[:, 1], rows[:, 2], yaw], axis=-1)
