"""Map and session persistence: the port's copy of
``ndt_2d_tpu/io/serialization.py``.

The reference checkpoints the full graph — every scan (id, pose, points) and
every constraint — to a rosbag2 file (Graph::save / load ctor,
src/graph.cpp:49-165).  Both packages keep the same semantics in one
portable npz schema, so a map saved by either loads in the other.  Session
checkpoints (``save_session`` / ``load_session``) add the mapper's runtime
state and the particle cloud in the same schema, key for key, so a session
saved by either package resumes in the other too; the port adds the state
of its filter's ``torch.Generator``.
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


def save_session(mapper, filename: str) -> None:
    """Checkpoint a FULL mapper session (beyond the reference's map-only
    save): graph + runtime estimator state + particle cloud, so a session
    resumes where it stopped, with no re-localization.

    The filter's random state is its generator's ``get_state()`` under
    ``pf_generator_state``, with the generator's device type beside it (a
    CUDA generator's state is 16 bytes, a CPU generator's 5056: they do not
    exchange).  ``pf_key`` is also written, as ``jax.random.PRNGKey(seed)``
    of the filter's seed, since the JAX package's ``load_session`` reads it
    whenever a cloud is present.  The recovery EWMAs (w_slow, w_fast) are
    not saved, as in the JAX package.
    """
    # Pipelined sessions (config.max_inflight > 0) may hold in-flight
    # results whose poses/constraints haven't landed in the graph yet.
    mapper.flush()
    g = mapper.graph
    extra = {}
    if mapper.filter is not None:
        f = mapper.filter
        extra.update(
            pf_particles=f.particles.cpu().numpy(),
            pf_weights=f.weights.cpu().numpy(),
            pf_n_active=np.int32(f.n_active),
            pf_key=np.asarray([0, f.seed], np.uint32),
            pf_generator_state=f.gen.get_state().numpy(),
            pf_generator_device=np.str_(f.gen.device.type),
        )
    np.savez_compressed(
        filename,
        version=np.int32(FORMAT_VERSION),
        session=np.bool_(True),
        use_barycenter=np.bool_(g.use_barycenter),
        poses=g.poses,
        points=g.points,
        point_mask=g.point_mask,
        constraint_begin=g.constraint_begin,
        constraint_end=g.constraint_end,
        constraint_transform=g.constraint_transform,
        constraint_information=g.constraint_information,
        constraint_switchable=g.constraint_switchable,
        prev_odom_pose=mapper.prev_odom_pose,
        prev_robot_pose=mapper.prev_robot_pose,
        odom_initialized=np.bool_(mapper.prev_odom_pose_is_initialized),
        typical_matcher_response=np.float64(mapper.typical_matcher_response),
        global_scans_processed=np.int64(mapper.global_scans_processed),
        optimization_last=np.int64(mapper.optimization_last),
        enable_mapping=np.bool_(mapper.enable_mapping),
        **extra,
    )


def load_session(filename: str, config, seed: int = 0, mesh=None,
                 device=None):
    """Restore a mapper from a ``save_session`` checkpoint of either
    package, on ``device`` (``cuda`` unless ``cpu`` is passed).  The rolling
    window is rebuilt from the graph at the next scan.

    The filter's generator takes the saved state where the checkpoint has
    one, and raises if it was saved on another device type; a checkpoint
    of the JAX package has none (its ``pf_key`` draws other numbers), and
    the generator then stays seeded from ``seed``."""
    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    graph = load_graph(filename, config.max_points_per_scan,
                       config.use_barycenter)
    with np.load(filename) as data:
        if "session" not in data.files or not bool(data["session"]):
            raise ValueError(f"{filename} is a map file, not a session "
                             "checkpoint (use load_graph)")
        mapper = Mapper(config, graph=graph, seed=seed, mesh=mesh,
                        device=device)
        mapper.prev_odom_pose = np.asarray(data["prev_odom_pose"])
        mapper.prev_robot_pose = np.asarray(data["prev_robot_pose"])
        mapper.prev_odom_pose_is_initialized = bool(data["odom_initialized"])
        mapper.typical_matcher_response = float(
            data["typical_matcher_response"])
        mapper.global_scans_processed = int(data["global_scans_processed"])
        mapper.optimization_last = int(data["optimization_last"])
        # Respect the caller's mode: a `localize` session must stay
        # localization-only even when resuming a mapping checkpoint.
        mapper.enable_mapping = (bool(data["enable_mapping"])
                                 and config.enable_mapping)
        if mapper.filter is not None and "pf_particles" in data.files:
            import torch
            f = mapper.filter
            if "pf_generator_state" in data.files:
                saved = str(data["pf_generator_device"])
                if saved != f.gen.device.type:
                    raise ValueError(
                        f"{filename}: the filter's generator state was "
                        f"saved on {saved} and cannot resume on "
                        f"{f.gen.device.type}")
                f.gen.set_state(torch.from_numpy(
                    data["pf_generator_state"].copy()))
            f.particles = torch.from_numpy(
                np.asarray(data["pf_particles"], np.float32)).to(f.device)
            f.weights = torch.from_numpy(
                np.asarray(data["pf_weights"], np.float32)).to(f.device)
            f.n_active = int(data["pf_n_active"])
            f._refresh_statistics()
    return mapper
