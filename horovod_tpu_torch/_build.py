"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded
with :mod:`ctypes`.  The library lands in ``horovod_tpu_torch/_build/``
keyed by a hash of its source and flags, so an edited source rebuilds
and an unchanged one is reused; a file lock keeps two ranks (or
threads) from building the same library at once.  A missing ``nvcc`` or a failed build
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

from horovod_tpu_torch.common.types import HorovodTpuError

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall time (0.0 when reused), "log": ptxas}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise HorovodTpuError(
        "nvcc not found (looked on PATH and under CUDA_HOME or "
        "/usr/local/cuda): the CUDA kernels cannot be built")


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}_{key[:16]}.so")


def _build(name: str, out: str) -> dict:
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if os.path.exists(out):  # another rank built it meanwhile
                return {"seconds": 0.0, "log": ""}
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, f"{name}.cu")]
            t0 = time.monotonic()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            secs = time.monotonic() - t0
            if proc.returncode != 0:
                raise HorovodTpuError(
                    f"nvcc failed building {name} (rc={proc.returncode}):"
                    f"\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
            return {"seconds": secs, "log": proc.stdout + proc.stderr}
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``.  Threads may
    load libraries at once, so their ``nvcc`` runs overlap; the file
    lock in :func:`_build` keeps two of them from building one name."""
    lib = _libs.get(name)
    if lib is None:
        out = library_path(name)
        info = ({"seconds": 0.0, "log": ""} if os.path.exists(out)
                else _build(name, out))
        with _lock:
            if info["seconds"] or name not in build_info:
                build_info[name] = info
            lib = _libs.setdefault(name, ctypes.CDLL(out))
    return lib
