"""Build and load the hand-written CUDA kernels of :mod:`metalens_tpu_torch`.

Each ``csrc/<name>.cu`` exposes a plain C interface.  The first time a
wrapper needs it, ``nvcc`` compiles it for ``sm_90a`` (Hopper) into
``build/torch_kernels/lib<name>-<hash>.so`` at the root of the checkout, and
:mod:`ctypes` loads it.  The hash covers the source and the flags, so an
edited source is rebuilt and a stale library is never loaded.  Nothing is
compiled or loaded at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from . import trace

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (looked on PATH and under CUDA_HOME); "
                       "the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built
    (the compile is the span ``cuda.build.<name>``)."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with trace.span(f"cuda.build.{name}"):
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)          # atomic: concurrent builders agree
    return out


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; ``signatures`` maps
    each C entry point to its ctypes argument types (every entry point
    returns the ``cudaError_t`` of its launch as an int)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise if a kernel launch reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def route_counts() -> dict:
    """The inverse kernel's launches by route (``registers``, ``cluster``)
    that the trace registry counted since its last reset."""
    c = trace.snapshot()["counters"]
    return {route: c.get(f"inv.launches.{route}", 0)
            for route in ("registers", "cluster")}


def launch_counts() -> dict:
    """Launches of each hand-written kernel that the trace registry counted
    since its last reset: ``cinv`` (both routes), ``taylor``
    (``cgemm_ps_c64``) and ``taylor_chunks`` (``ps_chunks_c64``)."""
    c = trace.snapshot()["counters"]
    return {"cinv": sum(route_counts().values()),
            "taylor": c.get("taylor.gemm_launches", 0),
            "taylor_chunks": c.get("taylor.chunk_launches", 0)}
