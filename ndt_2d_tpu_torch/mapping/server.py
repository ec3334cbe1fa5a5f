"""Live streaming runtime: the reference node's topic surface over sockets;
the port's copy of ``ndt_2d_tpu/mapping/server.py``, same wire format and
same windowed protocol.

The reference is a live ROS node: scans stream in over DDS, the pose comes
back as a map->odom TF broadcast, the map publishes at 4 Hz on a latched
topic, and a Configure service mutates state (src/ndt_mapper.cpp:118-142,
:687-744).  This module provides the same surface without ROS:

* ``ScanServer`` accepts newline-delimited JSON scan messages over a UNIX
  socket and replies with the estimated pose + match stats per scan —
  the laserCallback + TF-broadcast path.
* a publisher thread re-renders the occupancy grid and graph snapshot on
  the reference's cadence (default 4 Hz, ndt_mapper.cpp:742) whenever the
  map changed, writing latched artifacts (npz + optional PNG) to a
  directory — the latched ``map``/``graph`` topics.
* the Configure control channel (``runtime.ControlServer`` semantics) rides
  the same connection: a message with an ``action`` field is a Configure
  call.

Wire format (one JSON object per line):
  scan:      {"ranges": [...], "angle_min": f, "angle_increment": f,
              "time_increment": f, "range_max": f, "odom": [x, y, th],
              "odom_end": [x, y, th]?, "id": any?, "windowed": bool?}
  configure: {"action": 1|2|4|8, "filename": "..."}
  initial:   {"initial_pose": [x, y, th], "covariance": [9 floats]?,
              "odom": [x, y, th]}
  flush:     {"flush": true}   (windowed clients: resolve all poses)
Replies:     {"ok": true, "accepted": bool, "id": any, "pose": [x, y, th],
              "map_to_odom": [x, y, th], "score": f} (or {"ok": false,
              "error": "..."}).

Windowed protocol (``"windowed": true`` + a mapper with max_inflight > 0):
the per-scan reply is an immediate ack {"ok", "accepted", "deferred", "id"}
— no device round trip — and each pose streams back later as its async copy
lands, as a separate line {"result": {"id", "pose", "map_to_odom",
"score"}} pushed before a subsequent reply.  This carries the pipelined
mapping's overlap (no device round trip per scan) to the live surface; the
synchronous protocol stays the default for per-scan-answer clients.

Threads: every client connection is served by a thread of its own, and the
publisher is another; each makes the mapper's device its current CUDA
device first (``device.thread_binder``), and every call into the mapper
holds the server's one lock.  Kernels launch on PyTorch's current stream,
which is the device's default stream in every thread, so the launch plans
kept per stream are shared by all of them.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from typing import Optional

import numpy as np

from ndt_2d_tpu_torch.device import thread_binder
from ndt_2d_tpu_torch.mapping.mapper import Mapper
from ndt_2d_tpu_torch.utils.sim import LaserScanMsg

logger = logging.getLogger("ndt_2d_tpu_torch.server")


class _GraphView:
    """Immutable graph copy with the duck-typed surface viz expects."""

    def __init__(self, poses, constraint_begin, constraint_end,
                 constraint_switchable):
        self.poses = poses
        self.constraint_begin = constraint_begin
        self.constraint_end = constraint_end
        self.constraint_switchable = constraint_switchable


class MapPublisher:
    """4 Hz latched map/graph artifact publisher (mapPublishThread,
    src/ndt_mapper.cpp:687-744)."""

    def __init__(self, mapper: Mapper, lock: threading.Lock, out_dir: str,
                 period: float = 0.25, png: bool = False):
        self.mapper = mapper
        self.lock = lock
        self.out_dir = out_dir
        self.period = period
        self.png = png
        self._stop = False
        os.makedirs(out_dir, exist_ok=True)
        self.publish_count = 0
        self._bind = thread_binder(mapper.device)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        self._bind()
        while not self._stop:
            try:
                # map->odom publishes UNCONDITIONALLY each period, exactly
                # like the reference's always-broadcast TF
                # (ndt_mapper.cpp:716-742); only the (expensive) map/graph
                # artifacts are gated on map_update_available.  drain=False:
                # the broadcast must not stall the pipelined ingest; the
                # estimate lags by <= max_inflight scans, as the reference's
                # TF lags its ingest thread.
                with self.lock:
                    tf = self.mapper.map_to_odom(drain=False)
                    n_nodes = self.mapper.graph.num_scans
                    n_edges = self.mapper.graph.num_constraints
                tmp_state = os.path.join(self.out_dir, ".state.tmp")
                with open(tmp_state, "w") as f:
                    json.dump({
                        "map_to_odom": np.asarray(tf).tolist(),
                        "nodes": int(n_nodes),
                        "edges": int(n_edges),
                        "stamp": time.time(),
                    }, f)
                os.replace(tmp_state,
                           os.path.join(self.out_dir, "state.json"))
            except Exception:
                logger.exception("state publish failed")
            if self.mapper.map_update_available:
                try:
                    with self.lock:
                        grid = self.mapper.render_map()
                        # Consistent copy for the (slow, unlocked) PNG
                        # render below — the live graph keeps growing.
                        g = self.mapper.graph
                        frozen = _GraphView(
                            poses=g.poses.copy(),
                            constraint_begin=g.constraint_begin.copy(),
                            constraint_end=g.constraint_end.copy(),
                            constraint_switchable=(
                                g.constraint_switchable.copy()))
                    # savez appends .npz to the filename, so the tmp name
                    # must already end with it for os.replace to find it.
                    tmp = os.path.join(self.out_dir, ".map.tmp.npz")
                    np.savez_compressed(tmp, data=grid.data,
                                        origin=grid.origin,
                                        resolution=grid.resolution)
                    os.replace(tmp, os.path.join(self.out_dir, "map.npz"))
                    if self.png:
                        from ndt_2d_tpu_torch.utils import viz
                        viz.save_graph_png(
                            frozen,
                            os.path.join(self.out_dir, "map.png"), grid=grid)
                    self.publish_count += 1
                except Exception:
                    logger.exception("map publish failed")
            time.sleep(self.period)

    def close(self):
        self._stop = True
        self._thread.join(timeout=2.0)


class ScanServer:
    """Newline-JSON scan/configure server over a UNIX socket."""

    def __init__(self, mapper: Mapper, path: str,
                 publish_dir: Optional[str] = None, publish_png: bool = False):
        self.mapper = mapper
        self.path = path
        self.lock = threading.Lock()
        if os.path.exists(path):
            os.unlink(path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(path)
        self._sock.listen(8)
        self._stop = False
        self.publisher = (MapPublisher(mapper, self.lock, publish_dir,
                                       png=publish_png)
                          if publish_dir else None)
        self._bind = thread_binder(mapper.device)
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def _handle(self, req: dict, pending: list):
        """Process one request; returns (reply, deferred_entry | None)."""
        if "flush" in req:  # windowed client: resolve ALL outstanding poses
            with self.lock:
                self.mapper.flush()
            return {"ok": True, "flushed": len(pending)}, None
        if "action" in req:  # Configure service (srv/Configure.srv)
            with self.lock:
                ok = self.mapper.configure(int(req["action"]),
                                           req.get("filename", ""))
            return {"ok": bool(ok)}, None
        if "initial_pose" in req:  # initialpose topic (poseCallback)
            cov = np.asarray(req.get("covariance",
                                     [0.25, 0.25, 0.06]), np.float64)
            if cov.size == 9:
                cov = cov.reshape(3, 3)
            with self.lock:
                ok = self.mapper.set_initial_pose(
                    np.asarray(req["initial_pose"], np.float64), cov,
                    np.asarray(req["odom"], np.float64))
            return {"ok": bool(ok)}, None
        # scan message (laserCallback)
        msg = LaserScanMsg(
            ranges=np.asarray(req["ranges"], np.float32),
            angle_min=float(req["angle_min"]),
            angle_increment=float(req["angle_increment"]),
            time_increment=float(req.get("time_increment", 0.0)),
            range_max=float(req["range_max"]))
        odom = np.asarray(req["odom"], np.float64)
        odom_end = (np.asarray(req["odom_end"], np.float64)
                    if req.get("odom_end") is not None else None)
        windowed = bool(req.get("windowed", False))
        with self.lock:
            res = self.mapper.process_scan(msg, odom, odom_end)
            if windowed and res.accepted and res.pose_future is not None:
                # Windowed protocol: immediate ack; the pose streams back as
                # a {"result": ...} line once its async device->host copy
                # lands (the per-scan-reply protocol drains the pipeline at
                # every scan, so the live surface would run at the
                # synchronous speed).
                return ({"ok": True, "accepted": True, "deferred": True,
                         "id": req.get("id")},
                        (req.get("id"), odom, res.pose_future,
                         res.score_future))
            if windowed and not res.accepted:
                # Motion-gated scan in a windowed stream: replying through
                # map_to_odom() below would _drain_all() and stall the whole
                # in-flight pipeline once per gated scan — at sensor rate
                # (most scans gated) that collapses windowed throughput back
                # to sync speed.  A rejected scan needs no pose; ack without
                # touching the pipeline.
                return ({"ok": True, "accepted": False,
                         "id": req.get("id")}, None)
            # Synchronous reply: map_to_odom() forces a full drain, so with
            # pipelined mapping the exact estimate is prev_robot_pose here.
            tf = self.mapper.map_to_odom()
            pose = (np.asarray(res.pose) if res.pose is not None
                    else (self.mapper.prev_robot_pose.copy()
                          if res.accepted else None))
        return {
            "ok": True,
            "accepted": bool(res.accepted),
            "id": req.get("id"),
            "pose": pose.tolist() if pose is not None else None,
            "map_to_odom": np.asarray(tf).tolist(),
            "score": float(res.matched_score),
        }, None

    @staticmethod
    def _future_ready(fut) -> bool:
        return fut.ready()

    def _resolve(self, entry) -> dict:
        """One deferred entry -> a {"result": ...} push line."""
        scan_id, odom, pose_fut, score_fut = entry
        pose = pose_fut.result()
        score = float(score_fut.result()) if score_fut is not None else None
        # map->odom for THIS scan from its own odom sample
        # (ndt_mapper.cpp:722-739).
        th = np.arctan2(np.sin(pose[2] - odom[2]), np.cos(pose[2] - odom[2]))
        c, s = np.cos(th), np.sin(th)
        tf = [float(pose[0] - (c * odom[0] - s * odom[1])),
              float(pose[1] - (s * odom[0] + c * odom[1])), float(th)]
        return {"result": {"id": scan_id, "pose": pose.tolist(),
                           "map_to_odom": tf, "score": score}}

    def _flush_ready(self, f, pending: list, block: bool = False):
        """Emit result lines for resolved futures (oldest first)."""
        while pending and (block or self._future_ready(pending[0][2])):
            f.write(json.dumps(self._resolve(pending.pop(0))).encode()
                    + b"\n")

    def _client(self, conn):
        self._bind()
        with conn:
            f = conn.makefile("rwb")
            pending = []  # deferred (id, odom, pose_future, score_future)
            for line in f:
                try:
                    reply, deferred = self._handle(json.loads(line), pending)
                except Exception as e:
                    reply, deferred = {"ok": False, "error": str(e)}, None
                if deferred is not None:
                    pending.append(deferred)
                # Push any landed results BEFORE the reply; a flush request
                # drains everything first (its reply then follows last).
                self._flush_ready(f, pending, block="flushed" in reply)
                f.write(json.dumps(reply).encode() + b"\n")
                f.flush()

    def _serve(self):
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._client, args=(conn,),
                             daemon=True).start()

    def close(self):
        self._stop = True
        self._sock.close()
        if self.publisher:
            self.publisher.close()
        if os.path.exists(self.path):
            os.unlink(self.path)


def stream_bag(path: str, sock_path: str, realtime_hz: float = 0.0,
               windowed: bool = False) -> dict:
    """Feed a recorded bag to a running ScanServer (the live-sensor client).

    ``windowed=True`` uses the windowed protocol: each scan gets an
    immediate ack and its pose streams back as a ``result`` line when the
    async device copy lands, so the session runs at pipelined speed through
    the live surface (a final ``flush`` collects stragglers).  Returns the
    last reply with ``results``: {scan id -> result dict} (empty when not
    windowed).  ``realtime_hz`` > 0 paces the stream.
    """
    from ndt_2d_tpu_torch.io.bag import load_bag
    bag = load_bag(path)
    last = {}
    results = {}
    scan_times = []  # per-scan client-side request->reply latency
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(sock_path)
        f = s.makefile("rwb")

        def read_reply():
            while True:
                line = json.loads(f.readline())
                if "result" in line:
                    results[line["result"]["id"]] = line["result"]
                    continue
                return line

        for t, (msg, odom) in enumerate(bag):
            req = {
                # Python json emits NaN literals for invalid beams; the
                # server's json.loads accepts them (both are the module's
                # defaults).
                "id": t,
                "windowed": windowed,
                "ranges": msg.ranges.astype(float).tolist(),
                "angle_min": msg.angle_min,
                "angle_increment": msg.angle_increment,
                "time_increment": msg.time_increment,
                "range_max": msg.range_max,
                "odom": odom.tolist(),
            }
            t_send = time.perf_counter()
            f.write(json.dumps(req).encode() + b"\n")
            f.flush()
            last = read_reply()
            scan_times.append(time.perf_counter() - t_send)
            if realtime_hz > 0:
                time.sleep(1.0 / realtime_hz)
        if windowed:
            f.write(json.dumps({"flush": True}).encode() + b"\n")
            f.flush()
            last = read_reply()
    last["results"] = results
    last["scan_times_s"] = scan_times
    return last
