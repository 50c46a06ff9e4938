"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded
with :mod:`ctypes`.  The library lands in ``horovod_tpu_torch/_build/``
keyed by a hash of its source and flags, so an edited source rebuilds
and an unchanged one is reused; a file lock keeps two ranks (or
threads) from building the same library at once.  A missing ``nvcc`` or a failed build
raises: there is no fallback.

:func:`load_host_extension` builds a host C++ source the same way with
``g++`` against the running interpreter's headers (a CPython extension,
such as the negotiation wire's codec ``csrc/wire.cc``) and imports it;
:func:`load_host_library` builds a host C++ source with a plain C
interface (the KV store, ``csrc/kvstore.cc``) and loads it with
:mod:`ctypes`.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
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


HOST_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")
LIB_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-pthread", "-shared")
_modules: dict = {}


def _gxx(name: str, out: str, args: list) -> dict:
    """Build ``out`` with ``g++ ARGS -o <tmp>`` unless it exists, under
    ``name``'s file lock; the build's wall time, its output and ``out``.
    A failed build raises."""
    info = {"seconds": 0.0, "log": "", "path": out}
    if os.path.exists(out):
        return info
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if os.path.exists(out):  # another rank built it meanwhile
                return info
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = ["g++", *args, "-o", tmp]
            t0 = time.monotonic()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as exc:
                raise HorovodTpuError(
                    f"g++ could not run to build {name}: {exc}") from exc
            if proc.returncode != 0:
                raise HorovodTpuError(
                    f"g++ failed building {name} (rc={proc.returncode}):"
                    f"\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
            return {"seconds": time.monotonic() - t0,
                    "log": f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                           f"built {out}\n",
                    "path": out}
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def load_host_extension(mod_name: str, source: str):
    """The CPython extension ``mod_name`` built from ``csrc/<source>``
    with ``g++`` (at first use, into :data:`BUILD_DIR` keyed by a hash
    of the source, the flags and the interpreter's ABI, under the same
    file lock as the kernels) and imported.  A failed build raises."""
    with _lock:
        mod = _modules.get(mod_name)
    if mod is not None:
        return mod
    src_path = os.path.join(CSRC, source)
    include = sysconfig.get_paths()["include"]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    with open(src_path, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(HOST_FLAGS).encode()
                             + include.encode() + suffix.encode()
                             ).hexdigest()
    out = os.path.join(BUILD_DIR, f"{mod_name}_{key[:16]}{suffix}")
    _gxx(mod_name, out, [*HOST_FLAGS, f"-I{include}", src_path])
    spec = importlib.util.spec_from_file_location(mod_name, out)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with _lock:
        return _modules.setdefault(mod_name, mod)


def load_host_library(lib_name: str, source: str) -> ctypes.CDLL:
    """The ctypes library ``lib<lib_name>_<hash>.so`` built from
    ``csrc/<source>`` with ``g++`` (at first use, into :data:`BUILD_DIR`
    keyed by a hash of the source and the flags, under the same file lock
    as the kernels) and loaded.  :data:`build_info` records the build's
    wall time, its output and the library's path.  A failed build
    raises."""
    with _lock:
        lib = _libs.get(lib_name)
    if lib is not None:
        return lib
    src_path = os.path.join(CSRC, source)
    with open(src_path, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(LIB_FLAGS).encode()
                             ).hexdigest()
    out = os.path.join(BUILD_DIR, f"lib{lib_name}_{key[:16]}.so")
    info = _gxx(lib_name, out, [*LIB_FLAGS, src_path])
    with _lock:
        if info["seconds"] or lib_name not in build_info:
            build_info[lib_name] = info
        return _libs.setdefault(lib_name, ctypes.CDLL(out))
