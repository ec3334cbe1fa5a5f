"""Reference map-file interop: rosbag2 (sqlite3 + CDR) import/export; the
port's copy of ``ndt_2d_tpu/io/rosbag2.py``, on the port's ``Graph``.

The reference persists its graph as a rosbag2 file of ``ndt_2d/msg/Scan``
and ``ndt_2d/msg/Constraint`` messages (Graph::save / load ctor,
src/graph.cpp:49-165) with two schema quirks we must honor at the boundary:

* the scan heading theta is smuggled in ``pose.orientation.w``
  (graph.cpp:70 on load, :125 on save) — the quaternion is never a real
  quaternion;
* the constraint's dtheta rides in ``transform.translation.z``
  (graph.cpp:93, :148).

This module reads and writes that exact on-disk layout with no ROS
dependency: the sqlite3 storage schema is plain SQL, and the two message
types are hand-coded XCDR1 little-endian records (the only serialization
rmw_fastrtps produces for them).  Import lets a user of the reference carry
their existing maps over; export lets maps built here flow back to the ROS
package.

Layout notes (CDR alignment is relative to the byte after the 4-byte
encapsulation header):

``Scan``:  u64 id | Pose{position f64 x,y,z | orientation f64 x,y,z,w}
           | u32 point_count | 4 pad | point_count x Point{f64 x,y,z}
``Constraint``: i64 begin | i64 end
           | Transform{translation f64 x,y,z | rotation f64 x,y,z,w}
           | f64[9] information | u8 switchable
"""

from __future__ import annotations

import logging
import os
import sqlite3
import struct
from typing import List, Optional, Tuple

import numpy as np

from ndt_2d_tpu_torch.graph.pose_graph import Graph

SCAN_TYPE = "ndt_2d/msg/Scan"
CONSTRAINT_TYPE = "ndt_2d/msg/Constraint"
_CDR_LE_HEADER = b"\x00\x01\x00\x00"


# ---------------------------------------------------------------------------
# CDR records
# ---------------------------------------------------------------------------
def _check_header(blob: bytes, what: str) -> None:
    if len(blob) < 4 or blob[1] != 0x01:
        raise ValueError(
            f"{what}: expected little-endian CDR encapsulation, got "
            f"{blob[:4]!r} (big-endian or XCDR2 bags are not supported)")


def decode_scan(blob: bytes) -> Tuple[int, np.ndarray, np.ndarray]:
    """ndt_2d/msg/Scan -> (id, pose (x, y, theta), points [N, 2])."""
    _check_header(blob, "Scan")
    b = blob[4:]
    scan_id, px, py, _pz, _qx, _qy, _qz, qw, n = struct.unpack_from(
        "<Q7dI", b, 0)
    if n:
        # points start at 72: 68 (end of length prefix) aligned up to 8.
        # CDR pads only BEFORE elements, so an empty sequence has no pad
        # and the body ends at 68 (the reference tolerates point-less
        # scans, ndt_mapper.cpp:625).
        pts = np.frombuffer(b, dtype="<f8", count=3 * n, offset=72)
        pts = pts.reshape(n, 3)[:, :2]
    else:
        pts = np.zeros((0, 2))
    # theta lives in orientation.w (graph.cpp:70).
    return int(scan_id), np.asarray([px, py, qw], np.float64), \
        pts.astype(np.float64)


def encode_scan(scan_id: int, pose, points) -> bytes:
    pose = np.asarray(pose, np.float64)
    # reshape: a point-less scan (the reference tolerates them and
    # set_initial_pose creates one) arrives as shape (0,), not (0, 2).
    points = np.asarray(points, np.float64).reshape(-1, 2)
    n = points.shape[0]
    # The alignment pad after the count exists only when elements follow.
    head = struct.pack("<Q7dI" + ("4x" if n else ""), scan_id, pose[0],
                       pose[1], 0.0, 0.0, 0.0, 0.0, pose[2], n)
    pts3 = np.zeros((n, 3), "<f8")
    pts3[:, :2] = points
    return _CDR_LE_HEADER + head + pts3.tobytes()


def decode_constraint(blob: bytes):
    """ndt_2d/msg/Constraint -> (begin, end, transform (dx, dy, dtheta),
    information [3, 3], switchable)."""
    _check_header(blob, "Constraint")
    b = blob[4:]
    vals = struct.unpack_from("<2q16d?", b, 0)
    begin, end = vals[0], vals[1]
    tx, ty, tz = vals[2], vals[3], vals[4]          # dtheta in translation.z
    info = np.asarray(vals[9:18], np.float64).reshape(3, 3)
    return (int(begin), int(end), np.asarray([tx, ty, tz], np.float64),
            info, bool(vals[18]))


def encode_constraint(begin: int, end: int, transform, information,
                      switchable: bool) -> bytes:
    t = np.asarray(transform, np.float64)
    info = np.asarray(information, np.float64).reshape(9)
    body = struct.pack("<2q16d?", begin, end, t[0], t[1], t[2],
                       0.0, 0.0, 0.0, 0.0, *info, switchable)
    return _CDR_LE_HEADER + body


# ---------------------------------------------------------------------------
# rosbag2 sqlite3 storage
# ---------------------------------------------------------------------------
def _resolve_db3(path: str) -> str:
    """Accept a bag directory (rosbag2's on-disk unit) or a .db3 file."""
    if os.path.isdir(path):
        dbs = sorted(f for f in os.listdir(path) if f.endswith(".db3"))
        if not dbs:
            raise FileNotFoundError(f"no .db3 storage file inside {path}")
        return os.path.join(path, dbs[0])
    return path


def read_messages(path: str) -> List[Tuple[str, bytes]]:
    """All (topic_name, serialized_blob) rows of a sqlite3 rosbag2 file, in
    insertion order (the reference writes scans first, then constraints, and
    its loader keys purely on topic name, graph.cpp:58-104)."""
    db = _resolve_db3(path)
    con = sqlite3.connect(f"file:{db}?mode=ro", uri=True)
    try:
        topics = {tid: name for tid, name in
                  con.execute("SELECT id, name FROM topics")}
        return [(topics[tid], bytes(data)) for tid, data in con.execute(
            "SELECT topic_id, data FROM messages ORDER BY id")]
    finally:
        con.close()


def import_map(path: str, max_points_per_scan: int,
               use_barycenter: bool = True) -> Graph:
    """Load a reference-format map into a Graph (Graph load ctor parity,
    src/graph.cpp:49-105)."""
    graph = Graph(max_points_per_scan, use_barycenter)
    n_trunc = 0
    for topic, blob in read_messages(path):
        if topic == "scans":
            scan_id, pose, pts = decode_scan(blob)
            if scan_id != graph.num_scans:
                raise ValueError(
                    f"scan id {scan_id} out of order (expected "
                    f"{graph.num_scans}); constraints index by scan id")
            n = min(len(pts), max_points_per_scan)
            n_trunc += max(0, len(pts) - n)
            padded = np.zeros((max_points_per_scan, 2), np.float32)
            mask = np.zeros(max_points_per_scan, bool)
            padded[:n] = pts[:n]
            mask[:n] = True
            graph.add_scan(pose, padded, mask)
        elif topic == "constraints":
            begin, end, t, info, sw = decode_constraint(blob)
            graph.add_constraint(begin, end, t, info, sw)
        # other topics: ignore (the reference treats every non-"scans"
        # message as a constraint, graph.cpp:82; being stricter here only
        # rejects bags the reference would misparse anyway)
    if n_trunc:
        logging.getLogger("ndt_2d_tpu_torch.io").warning(
            "import_map: %d points dropped by max_points_per_scan=%d",
            n_trunc, max_points_per_scan)
    return graph


_METADATA_TMPL = """rosbag2_bagfile_information:
  version: 5
  storage_identifier: sqlite3
  duration:
    nanoseconds: 0
  starting_time:
    nanoseconds_since_epoch: 0
  message_count: {count}
  topics_with_message_count:
    - topic_metadata:
        name: scans
        type: ndt_2d/msg/Scan
        serialization_format: cdr
        offered_qos_profiles: ""
      message_count: {n_scans}
    - topic_metadata:
        name: constraints
        type: ndt_2d/msg/Constraint
        serialization_format: cdr
        offered_qos_profiles: ""
      message_count: {n_constraints}
  compression_format: ""
  compression_mode: ""
  relative_file_paths:
    - {db_name}
  files:
    - path: {db_name}
      starting_time:
        nanoseconds_since_epoch: 0
      duration:
        nanoseconds: 0
      message_count: {count}
"""


def export_map(graph: Graph, path: str) -> None:
    """Write a Graph as a reference-format rosbag2 directory so the ROS
    package can load it (Graph::save parity, src/graph.cpp:107-165:
    all scans on topic "scans", all constraints on "constraints",
    theta -> orientation.w, dtheta -> translation.z, timestamps 0)."""
    os.makedirs(path, exist_ok=True)
    name = os.path.basename(os.path.normpath(path))
    db_name = f"{name}_0.db3"
    db = os.path.join(path, db_name)
    if os.path.exists(db):
        os.remove(db)
    con = sqlite3.connect(db)
    try:
        con.executescript(
            "CREATE TABLE schema(schema_version INTEGER PRIMARY KEY, "
            "ros_distro TEXT NOT NULL);"
            "CREATE TABLE metadata(id INTEGER PRIMARY KEY, "
            "metadata_version INTEGER NOT NULL, metadata TEXT NOT NULL);"
            "CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT NOT NULL, "
            "type TEXT NOT NULL, serialization_format TEXT NOT NULL, "
            "offered_qos_profiles TEXT NOT NULL);"
            "CREATE TABLE messages(id INTEGER PRIMARY KEY, "
            "topic_id INTEGER NOT NULL, timestamp INTEGER NOT NULL, "
            "data BLOB NOT NULL);")
        con.execute("INSERT INTO schema VALUES (3, 'humble')")
        con.execute("INSERT INTO topics VALUES (1, 'scans', ?, 'cdr', '')",
                    (SCAN_TYPE,))
        con.execute(
            "INSERT INTO topics VALUES (2, 'constraints', ?, 'cdr', '')",
            (CONSTRAINT_TYPE,))
        for i in range(graph.num_scans):
            pts = graph.points[i][graph.point_mask[i]]
            blob = encode_scan(i, graph.poses[i], pts)
            con.execute(
                "INSERT INTO messages(topic_id, timestamp, data) "
                "VALUES (1, 0, ?)", (blob,))
        for j in range(graph.num_constraints):
            blob = encode_constraint(
                int(graph.constraint_begin[j]), int(graph.constraint_end[j]),
                graph.constraint_transform[j],
                graph.constraint_information[j],
                bool(graph.constraint_switchable[j]))
            con.execute(
                "INSERT INTO messages(topic_id, timestamp, data) "
                "VALUES (2, 0, ?)", (blob,))
        count = graph.num_scans + graph.num_constraints
        meta = _METADATA_TMPL.format(count=count, n_scans=graph.num_scans,
                                     n_constraints=graph.num_constraints,
                                     db_name=db_name)
        con.execute("INSERT INTO metadata VALUES (1, 5, ?)", (meta,))
        con.commit()
    finally:
        con.close()
    with open(os.path.join(path, "metadata.yaml"), "w") as f:
        f.write(meta)
