"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded
with :mod:`ctypes`.  A library is keyed by a hash of its source, its
flags and the compiler's identity (``nvcc --version``, ``g++
-dumpfullversion``, read once per process), so an edited source or
another compiler rebuilds and an unchanged one is reused; a file lock
keeps two ranks (or threads) from building the same library at once.
A missing ``nvcc`` or a failed build raises: there is no fallback.

While the AOT cache is enabled (``HOROVOD_AOT_CACHE_DIR``,
:mod:`horovod_tpu_torch.runtime.aot_cache`) every library goes through
it: a valid entry is loaded, and a corrupt or skewed one is evicted and
built again.  Otherwise the library lands in
``horovod_tpu_torch/_build/``.  Real builds count
``hvd_compile_seconds_total{path=cold}`` either way.

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
HOST_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")
LIB_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-pthread", "-shared")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_modules: dict = {}
# tool -> its identity, read once per process
_compilers: dict[str, str] = {}
# name -> {"seconds": build (or cache load) wall time, 0.0 when reused
# from _build/; "log": the compiler's output; "path": the loaded file;
# "hit": whether the AOT cache served it and "entry": its record, while
# the cache is enabled}
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


def _run(tool: str, name: str, cmd: list) -> subprocess.CompletedProcess:
    try:
        return subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise HorovodTpuError(
            f"{tool} could not run to build {name}: {exc}") from exc


def compiler_id(tool: str) -> str:
    """The identity of ``tool`` (``nvcc`` or ``g++``): its version
    output, read once per process.  Part of every library's key."""
    with _lock:
        ident = _compilers.get(tool)
    if ident is None:
        cmd = ([_nvcc(), "--version"] if tool == "nvcc"
               else ["g++", "-dumpfullversion"])
        proc = _run(tool, "its identity", cmd)
        ident = (proc.stdout + proc.stderr).strip()
        with _lock:
            ident = _compilers.setdefault(tool, ident)
    return ident


def _key(src_path: str, flags, tool: str, extra: bytes = b"") -> str:
    with open(src_path, "rb") as f:
        src = f.read()
    return hashlib.sha256(src + " ".join(flags).encode()
                          + compiler_id(tool).encode() + extra).hexdigest()


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu``'s library lands in :data:`BUILD_DIR`."""
    key = _key(os.path.join(CSRC, f"{name}.cu"), NVCC_FLAGS, "nvcc")
    return os.path.join(BUILD_DIR, f"lib{name}_{key[:16]}.so")


def _nvcc_build(name: str):
    src = os.path.join(CSRC, f"{name}.cu")

    def build(out: str) -> str:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", out, src]
        proc = _run("nvcc", name, cmd)
        if proc.returncode != 0:
            raise HorovodTpuError(
                f"nvcc failed building {name} (rc={proc.returncode}):"
                f"\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        return proc.stdout + proc.stderr

    return build


def _gxx_build(name: str, args: list):
    def build(out: str) -> str:
        cmd = ["g++", *args, "-o", out]
        proc = _run("g++", name, cmd)
        if proc.returncode != 0:
            raise HorovodTpuError(
                f"g++ failed building {name} (rc={proc.returncode}):"
                f"\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        return f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}built {out}\n"

    return build


def _locked_build(name: str, out: str, build) -> dict:
    """Build ``out`` unless it exists, under ``name``'s file lock in
    :data:`BUILD_DIR`; the build's wall time, its log and ``out``."""
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
            t0 = time.monotonic()
            log = build(tmp)
            os.replace(tmp, out)
            secs = time.monotonic() - t0
            from horovod_tpu_torch.runtime import aot_cache as _aot

            _aot.count_cold(secs)
            return {"seconds": secs, "log": log, "path": out}
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def _artifact(name: str, key: str, out: str, build, load,
              suffix: str = ".so"):
    """``(loaded, info)``: through the AOT cache while it is enabled,
    else ``out`` in :data:`BUILD_DIR`, built first unless it exists."""
    from horovod_tpu_torch.runtime import aot_cache as _aot

    if _aot.enabled():
        return _aot.build_or_load(name, key, build, load, suffix)
    info = _locked_build(name, out, build)
    return load(out), info


def _remember(table: dict, name: str, obj, info: dict):
    with _lock:
        if info["seconds"] or name not in build_info:
            build_info[name] = info
        return table.setdefault(name, obj)


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``.  Threads may
    load libraries at once, so their ``nvcc`` runs overlap; the file
    lock keeps two of them from building one name."""
    lib = _libs.get(name)
    if lib is None:
        key = _key(os.path.join(CSRC, f"{name}.cu"), NVCC_FLAGS, "nvcc")
        out = os.path.join(BUILD_DIR, f"lib{name}_{key[:16]}.so")
        lib, info = _artifact(name, key, out, _nvcc_build(name), ctypes.CDLL)
        lib = _remember(_libs, name, lib, info)
    return lib


def _import_extension(mod_name: str):
    def load_(path: str):
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    return load_


def load_host_extension(mod_name: str, source: str):
    """The CPython extension ``mod_name`` built from ``csrc/<source>``
    with ``g++`` (at first use, keyed by a hash of the source, the
    flags, the compiler and the interpreter's ABI, under the same file
    lock as the kernels) and imported.  A failed build raises."""
    with _lock:
        mod = _modules.get(mod_name)
    if mod is not None:
        return mod
    src_path = os.path.join(CSRC, source)
    include = sysconfig.get_paths()["include"]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    key = _key(src_path, HOST_FLAGS, "g++",
               include.encode() + suffix.encode())
    out = os.path.join(BUILD_DIR, f"{mod_name}_{key[:16]}{suffix}")
    mod, info = _artifact(
        mod_name, key, out,
        _gxx_build(mod_name, [*HOST_FLAGS, f"-I{include}", src_path]),
        _import_extension(mod_name), suffix)
    return _remember(_modules, mod_name, mod, info)


def load_host_library(lib_name: str, source: str) -> ctypes.CDLL:
    """The ctypes library ``lib<lib_name>_<hash>.so`` built from
    ``csrc/<source>`` with ``g++`` (at first use, keyed by a hash of the
    source, the flags and the compiler, under the same file lock as the
    kernels) and loaded.  :data:`build_info` records the build's wall
    time, its output and the library's path.  A failed build raises."""
    with _lock:
        lib = _libs.get(lib_name)
    if lib is not None:
        return lib
    src_path = os.path.join(CSRC, source)
    key = _key(src_path, LIB_FLAGS, "g++")
    out = os.path.join(BUILD_DIR, f"lib{lib_name}_{key[:16]}.so")
    lib, info = _artifact(lib_name, key, out,
                          _gxx_build(lib_name, [*LIB_FLAGS, src_path]),
                          ctypes.CDLL)
    return _remember(_libs, lib_name, lib, info)


def forget() -> None:
    """Test hook: forget the libraries and extensions this process
    loaded, so the next load goes through the build (or the cache)
    again.  A CPython extension cannot be imported twice under one
    name; use it for the ctypes libraries."""
    with _lock:
        _libs.clear()
        _modules.clear()
        build_info.clear()
