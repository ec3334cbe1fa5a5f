"""Build and load the CUDA kernels of ``ndt_2d_tpu_torch/csrc``.

The kernels have a plain C interface, so they are compiled by ``nvcc``
alone (one process per source, all started together, then one link) into
one shared library and loaded with ``ctypes``; no PyTorch header is
compiled.  The library lands in ``ndt_2d_tpu_torch/build/`` under a name
carrying the hash of the sources and flags, so an edited source rebuilds on
next use.  Nothing here runs at
import time: the first kernel launch builds.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` without fast math,
so every float32 expression rounds exactly as the plain-PyTorch twin's does.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional, Sequence

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class _State:
    """The process's loaded library and what its build reported."""

    def __init__(self):
        self.lock = threading.Lock()
        self.lib: Optional[ctypes.CDLL] = None
        self.path = ""
        self.build_seconds = 0.0
        self.build_log = ""


_STATE = _State()


def sources() -> list:
    """The kernel sources (``*.cu``) and headers (``*.cuh``), sorted."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def find_nvcc() -> str:
    """``nvcc`` of the CUDA toolkit PyTorch finds (CUDA_HOME), else PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        exe = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(exe):
            return exe
    exe = shutil.which("nvcc")
    if exe is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return exe


def _digest(files: Sequence[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(os.path.basename(f).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiling it first if needed."""
    with _STATE.lock:
        if _STATE.lib is not None:
            return _STATE.lib
        files = sources()
        path = os.path.join(BUILD_DIR, f"libndt2d_{_digest(files)}.so")
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            t0 = time.perf_counter()
            _STATE.build_log = _compile(
                [f for f in files if f.endswith(".cu")], path)
            _STATE.build_seconds = time.perf_counter() - t0
        _STATE.lib = ctypes.CDLL(path)
        _STATE.path = path
        return _STATE.lib


def _compile(cu: Sequence[str], path: str) -> str:
    """Compile every source to an object in parallel, link them into the
    shared library ``path``; returns the compilers' output."""
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(f) + ".o") for f in cu]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o", o, f],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for f, o in zip(cu, objs)]
        logs = [p.communicate()[0] for p in procs]
        for f, p, log in zip(cu, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(f)} "
                                   f"({p.returncode}):\n{log}")
        lib = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True, check=False)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr}")
        os.replace(lib, path)
    return "".join(logs) + link.stdout + link.stderr


def function(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """C function ``name`` of the library with its argument types set
    (``c_void_p`` for pointers and the stream); it returns the CUDA error
    code of its launches."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def build_info() -> dict:
    """Path, build seconds (0 when the library was already built) and the
    compiler's per-kernel register/shared-memory report."""
    return {"path": _STATE.path, "seconds": _STATE.build_seconds,
            "log": _STATE.build_log}


def require(t, name: str, dtype, shape, device) -> None:
    """Validate a kernel argument before its pointer crosses into C:
    device, dtype, exact shape and contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer for a ``c_void_p`` argument."""
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
