"""ctypes binding of the native scan-bag codec (``native/bag_codec.cpp``).

The port's counterpart of the bag half of ``ndt_2d_tpu/io/native.py``: the
``.ndtbag`` binary format (large sequential I/O, no compression) that
``io/bag.py`` reads and writes.  The C++ source lives outside both packages;
this loader compiles it with ``g++`` into the port's own (gitignored)
``ndt_2d_tpu_torch/build/`` under a name carrying a hash of the source and
flags.  The compiler writes a temporary file that ``os.replace`` then moves
into place, so a process never loads a half-written library and never
shares one with the JAX package's loader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO_ROOT, "native", "bag_codec.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build")
FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the codec if its library is missing; returns its path."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    path = os.path.join(BUILD_DIR, f"libndt2d_bag_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name in ("ndt2d_save_bag", "ndt2d_bag_header",
                         "ndt2d_load_bag"):
                getattr(lib, name).restype = ctypes.c_int
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def save_bag(bag, path: str) -> None:
    """Write a ScanBag in the native binary format."""
    lib = _load()
    ranges = np.ascontiguousarray(bag.ranges, np.float32)
    odom = np.ascontiguousarray(bag.odom, np.float64)
    has_truth = bag.truth is not None
    truth = (np.ascontiguousarray(bag.truth, np.float64) if has_truth
             else np.zeros((0, 3)))
    t, n = ranges.shape
    rc = lib.ndt2d_save_bag(
        path.encode(), ctypes.c_int(t), ctypes.c_int(n),
        ctypes.c_uint8(1 if has_truth else 0),
        ctypes.c_double(bag.angle_min), ctypes.c_double(bag.angle_increment),
        ctypes.c_double(bag.time_increment), ctypes.c_double(bag.range_max),
        _ptr(ranges, ctypes.c_float), _ptr(odom, ctypes.c_double),
        _ptr(truth, ctypes.c_double))
    if rc != 0:
        raise IOError(f"native save_bag failed: rc={rc}")


def load_bag(path: str):
    """Read a native-format ScanBag."""
    from ndt_2d_tpu_torch.io.bag import ScanBag
    lib = _load()
    t, n = ctypes.c_int(0), ctypes.c_int(0)
    ht = ctypes.c_uint8(0)
    am, ai, ti, rm = (ctypes.c_double(0) for _ in range(4))
    rc = lib.ndt2d_bag_header(path.encode(), ctypes.byref(t), ctypes.byref(n),
                              ctypes.byref(ht), ctypes.byref(am),
                              ctypes.byref(ai), ctypes.byref(ti),
                              ctypes.byref(rm))
    if rc != 0:
        raise IOError(f"native bag header read failed: rc={rc}")
    ranges = np.zeros((t.value, n.value), np.float32)
    odom = np.zeros((t.value, 3), np.float64)
    truth = np.zeros((t.value, 3), np.float64) if ht.value else None
    rc = lib.ndt2d_load_bag(
        path.encode(), _ptr(ranges, ctypes.c_float),
        _ptr(odom, ctypes.c_double),
        _ptr(truth, ctypes.c_double) if truth is not None else None)
    if rc != 0:
        raise IOError(f"native load_bag failed: rc={rc}")
    return ScanBag(ranges=ranges, angle_min=am.value,
                   angle_increment=ai.value, time_increment=ti.value,
                   range_max=rm.value, odom=odom, truth=truth)
