"""Session runtime: the bag replay loop, the runtime control channel
and the writer of a session's outputs.

Port of ``ndt_2d_tpu/mapping/runtime.py``.  The reference's runtime surface
is ROS: a spinning node fed by topics plus a ``configure`` service that four
one-shot scripts call (scripts/{enable,disable}_mapping.py,
{save,load}_map.py).  Here the runtime is a deterministic replay loop
around ``Mapper`` (with the pipelined paths' deferred poses) plus a
UNIX-socket control channel speaking the same action bitmask as
``srv/Configure.srv``, so mapping can be toggled and maps saved or loaded
while a session runs.  Under a device mesh every rank replays the bag and
holds the same results: only rank 0 serves the channel, and each action is
broadcast to every rank and applied by all of them at the same scan
boundary (``ControlServer.at_boundary``); only rank 0 writes files
(``write_outputs``, and a SAVE_TO_FILE action).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import queue
import socket
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ndt_2d_tpu_torch.device import thread_binder
from ndt_2d_tpu_torch.io import serialization
from ndt_2d_tpu_torch.io.bag import ScanBag
from ndt_2d_tpu_torch.mapping.mapper import SAVE_TO_FILE, Mapper
from ndt_2d_tpu_torch.parallel import distributed
from ndt_2d_tpu_torch.utils import metrics

logger = logging.getLogger("ndt_2d_tpu_torch.runtime")


# The broadcast request of a mesh's control channel: [action, filename
# length, the filename's UTF-8 bytes packed four to an int32 word].
FILENAME_ROOM = 1024  # bytes


def pack_request(action: int, filename: str) -> torch.Tensor:
    """One request as the int32 tensor a mesh broadcasts; raises
    ValueError for a filename longer than ``FILENAME_ROOM`` bytes."""
    raw = filename.encode()
    if len(raw) > FILENAME_ROOM:
        raise ValueError(f"filename of {len(raw)} bytes: the control "
                         f"channel of a mesh carries at most {FILENAME_ROOM}")
    words = np.frombuffer(raw.ljust(FILENAME_ROOM, b"\0"), "<i4")
    return torch.from_numpy(np.concatenate(
        [np.asarray([action, len(raw)], np.int32), words]))


def unpack_request(t: torch.Tensor) -> tuple:
    """(action, filename) of a broadcast request."""
    x = t.numpy()
    raw = x[2:].astype("<i4").tobytes()[:int(x[1])]
    return int(x[0]), raw.decode()


class ControlServer:
    """UNIX-socket control channel: JSON lines
    {"action": int, "filename": str}.

    The action bitmask matches srv/Configure.srv: ENABLE_MAPPING=1,
    DISABLE_MAPPING=2, LOAD_FROM_FILE=4, SAVE_TO_FILE=8.  Without a
    ``mesh``, or on a mesh of one rank, the serving thread applies each
    action under ``_lock``, which serializes it with the caller's scans
    (``run_bag`` holds it around every ``process_scan``); it runs on the
    mapper's device.

    On a mesh of more than one rank only rank 0 binds ``path``; its
    serving thread queues each request and waits.  Every rank's scan loop
    calls ``at_boundary`` between two scans: rank 0 broadcasts the oldest
    pending request (or action 0) to every rank, every rank applies it,
    SAVE_TO_FILE written by rank 0 alone, and rank 0 replies once every
    rank has applied it, naming the ranks that failed.  Only the scan
    loop's thread takes part in a collective.  The request and the
    failures cross a gloo group of the whole world that the server makes
    once, host tensors whatever the mesh's backend, so a boundary never
    waits for the card's stream (an NCCL request would be copied to the
    card and read back a scan, ending the pipelined mapper's overlap)."""

    def __init__(self, mapper: Mapper, path: str, mesh=None):
        self.mapper = mapper
        self.path = path
        self._ranks = 1 if mesh is None else mesh.size()
        self._multi = self._ranks > 1
        self._lock = threading.Lock()
        self._pending = queue.Queue()
        self._stop = False
        self._sock = None
        if self._multi:
            self._group = distributed.host_group()
            self._idle = pack_request(0, "")
            self._request = self._idle.clone()
            if distributed.rank() != 0:
                return
        if os.path.exists(path):
            os.unlink(path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(path)
        self._sock.listen(4)
        self._bind = thread_binder(mapper.device)
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        self._bind()
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with conn:
                data = conn.makefile().readline()
                try:
                    req = json.loads(data)
                    action = int(req.get("action", 0))
                    filename = req.get("filename", "")
                    if self._multi:
                        reply = self._queue(action, filename)
                    else:
                        with self._lock:
                            ok = self.mapper.configure(action, filename)
                        reply = {"ok": bool(ok)}
                    conn.sendall(json.dumps(reply).encode() + b"\n")
                except Exception as e:
                    logger.exception("configure failed")
                    reply = {"ok": False, "error": str(e)}
                    conn.sendall(json.dumps(reply).encode() + b"\n")

    def _queue(self, action: int, filename: str) -> dict:
        """Rank 0 of a mesh: hand the request to the scan loop and wait
        for its reply."""
        packed = pack_request(action, filename)  # refuses a long filename
        done, reply = threading.Event(), {}
        self._pending.put((packed, done, reply))
        done.wait()
        return reply

    def pending(self) -> int:
        """Requests waiting for the next scan boundary (rank 0 of a mesh;
        0 elsewhere)."""
        return self._pending.qsize()

    def at_boundary(self) -> None:
        """Between two scans, on every rank of a mesh: apply the request
        rank 0 broadcasts, if any.  Nothing without a mesh of more than
        one rank, where the serving thread applies actions itself."""
        if not self._multi:
            return
        item = None
        if distributed.rank() == 0:
            try:
                item = self._pending.get_nowait()
            except queue.Empty:
                pass
            self._request.copy_(item[0] if item else self._idle)
        distributed.broadcast(self._request, self._group)
        action, filename = unpack_request(self._request)
        if action == 0:
            if item is not None:  # a request of no action: nothing to apply
                item[2].update(ok=True)
                item[1].set()
            return
        me = distributed.rank()
        failed = torch.zeros(self._ranks, dtype=torch.int32)
        error = ""
        try:
            # One file a save, written by rank 0 (write_outputs' rule);
            # every rank drains and applies the rest of the action.
            self.mapper.configure(action if me == 0
                                  else action & ~SAVE_TO_FILE, filename)
        except Exception as e:
            logger.exception("configure failed on rank %d", me)
            failed[me] = 1
            error = str(e)
        failed = distributed.sum_int(failed, self._group)
        if item is not None:
            ranks = [r for r in range(len(failed)) if failed[r]]
            reply = {"ok": not ranks}
            if ranks:
                reply.update(failed_ranks=ranks,
                             error=error or "configure failed on another "
                             "rank")
            item[2].update(reply)
            item[1].set()

    def close(self):
        self._stop = True
        if self._sock is not None:
            self._sock.close()
            if os.path.exists(self.path):
                os.unlink(self.path)
        while True:  # requests no boundary will take
            try:
                _, done, reply = self._pending.get_nowait()
            except queue.Empty:
                return
            reply.update(ok=False, error="the session ended")
            done.set()


def send_configure(path: str, action: int, filename: str = "") -> dict:
    """One-shot client of the control channel (the scripts/ equivalent)."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(path)
        s.sendall(json.dumps({"action": action,
                              "filename": filename}).encode() + b"\n")
        return json.loads(s.makefile().readline())


def sweep_end_odom(bag: ScanBag, t: int, msg) -> Optional[np.ndarray]:
    """Odometry pose at the END of scan t's sweep, for motion de-skew, or
    None when the sweep has no duration (ndt_mapper.cpp:368-370) or at the
    bag's last scan, which has no next odometry sample."""
    sweep = msg.time_increment * (len(msg.ranges) - 1)
    if sweep <= 0 or t + 1 >= len(bag):
        return None
    nxt, cur = bag.odom[t + 1], bag.odom[t]
    d = nxt - cur
    d = np.asarray([d[0], d[1], np.arctan2(np.sin(d[2]), np.cos(d[2]))])
    frac = 1.0
    if bag.times is not None and bag.times[t + 1] > bag.times[t]:
        frac = min(sweep / float(bag.times[t + 1] - bag.times[t]), 1.0)
    return cur + d * frac


def _no_boundary() -> None:
    """``run_bag``'s scan boundary without a control channel."""


def run_bag(mapper: Mapper, bag: ScanBag,
            progress: Optional[Callable[[int, object], None]] = None,
            control: Optional[ControlServer] = None) -> dict:
    """Replay a bag through the mapper; returns session statistics, with
    ATE against ground truth when the bag carries it.  The pipelined paths
    defer their poses: they are read after the final flush, when their
    copies to the host have long completed.  With a ``control`` server its
    lock is held around every scan and around the final flush and loop
    closure, so an action lands between two scans; on a mesh its
    ``at_boundary`` runs before every scan and before the final flush."""
    est, used_truth, accepted, est_t, deferred = [], [], 0, [], []
    lock = control._lock if control else contextlib.nullcontext()
    boundary = control.at_boundary if control else _no_boundary
    for t, (msg, odom_pose) in enumerate(bag):
        odom_end = sweep_end_odom(bag, t, msg)
        boundary()
        with lock:
            res = mapper.process_scan(msg, odom_pose, odom_end)
        if res.accepted:
            accepted += 1
            if res.pose is not None:
                est.append(res.pose)
                est_t.append(t)
                if bag.truth is not None:
                    used_truth.append(bag.truth[t])
            elif res.pose_future is not None:
                deferred.append((res.pose_future, t))
        if progress:
            progress(t, res)
    boundary()
    with lock:
        mapper.flush()
        mapper.loop_closure()
    for fut, t in deferred:
        est.append(fut.result())
        est_t.append(t)
        if bag.truth is not None:
            used_truth.append(bag.truth[t])

    stats = {
        "scans_in": len(bag),
        "scans_accepted": accepted,
        "graph_scans": mapper.graph.num_scans,
        "graph_constraints": mapper.graph.num_constraints,
        "loop_closures": int(mapper.graph.constraint_switchable.sum()),
        "session": mapper.stats.summary(),
    }
    if bag.truth is not None and len(est) > 1:
        stats["ate_rmse_m"] = metrics.ate_rmse(
            np.asarray(est), np.asarray(used_truth))
        stats["odom_ate_rmse_m"] = metrics.ate_rmse(bag.odom, bag.truth)
    # Private keys (numpy, not JSON): the estimated trajectory, for
    # --traj-out export; callers pop these before serializing.
    stats["_est"] = np.asarray(est) if est else np.zeros((0, 3))
    stats["_est_t"] = np.asarray(est_t, np.int64)
    return stats


def write_outputs(mapper: Mapper, stats: dict, traj_out=None, map_out=None,
                  grid_out=None, session_out=None, viz_out=None,
                  truth=None) -> dict:
    """Write a session's trajectory (TUM), map, session checkpoint,
    occupancy grid and picture (the graph over the grid, with the particle
    cloud and ``truth`` [T, 3] when given) and print its stats line;
    returns the stats without their private keys.  The grid is rendered on
    every rank (with a mesh, a collective); only rank 0 writes files and
    prints."""
    writer = distributed.rank() == 0
    est = stats.pop("_est")
    est_t = stats.pop("_est_t")
    if traj_out:
        if writer:
            serialization.save_tum(traj_out, est_t, est)
        stats["traj_out"] = traj_out
    if map_out:
        if writer:
            mapper.configure(SAVE_TO_FILE, map_out)
        stats["map_out"] = map_out
    if session_out:
        if writer:
            serialization.save_session(mapper, session_out)
        stats["session_out"] = session_out
    grid = mapper.render_map() if grid_out or viz_out else None
    if grid_out:
        if writer:
            np.savez_compressed(grid_out, data=grid.data, origin=grid.origin,
                                resolution=grid.resolution)
        stats["grid_out"] = grid_out
    if viz_out:
        if writer:
            from ndt_2d_tpu_torch.utils import viz
            viz.save_graph_png(
                mapper.graph, viz_out, grid=grid,
                particles=(mapper.filter.cloud() if mapper.filter else None),
                truth=truth)
        stats["viz_out"] = viz_out
    if writer:
        print(json.dumps(stats))
    return stats
