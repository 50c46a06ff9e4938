"""Persistent, fail-closed AOT cache: this package's copy of
``horovod_tpu/runtime/aot_cache.py``, over torch's artifacts.

The JAX package serializes its negotiated data plane's compiled
executables so a restart or an elastic re-form loads them in seconds.
This package's eager executor compiles nothing per response; its cold
compile is :mod:`horovod_tpu_torch._build`'s (``nvcc`` for the CUDA
kernels, ``g++`` for the wire codec, the KV store and the timeline).
So the cache holds two kinds of entry under ``HOROVOD_AOT_CACHE_DIR``:

* **programs** (:func:`compile_or_load`), addressed by a SHA-256 over
  the schema version, :func:`versions` (torch, its CUDA toolkit,
  Triton), the topology (world, local and cross size, device type and
  card name), the round-0 cfg vector
  (:func:`horovod_tpu_torch.runtime.controller.round0_cfg`: every knob
  that can change a negotiated program rides it) and the program key.
  ``HOROVOD_AOT_CACHE_MODE`` picks the format: ``exec`` (the default,
  through ``auto``) is an AOTInductor package
  (``torch._inductor.aoti_compile_and_package``), whose warm load skips
  compilation; ``export`` is a ``torch.export`` program, whose warm
  load skips tracing only;
* **libraries** (:func:`build_or_load`, mode ``lib``), addressed by the
  schema, :func:`versions` and the builder's key: the source, the
  flags and the compiler's identity.  A library does not depend on the
  world, so its key has no topology and no cfg vector, and a world
  builds each library once: the rank holding the name's file lock
  builds it, and a rank that takes the lock after it finds the entry
  written and counts a hit.

**Fail-closed.** Any unreadable record, schema or version skew, key
mismatch, payload whose SHA-256 disagrees, or artifact that fails to
load evicts the entry (one warning per failure class) and falls
through to a normal build: a stale or corrupt artifact never runs, and
never gives way to a plain PyTorch version.  Serialization failures are
advisory: the fresh artifact is used and simply not persisted.

CLI: ``python -m horovod_tpu_torch.runtime.aot_cache
list|info|prune|clear`` (also ``python -m horovod_tpu_torch.trace
aot-cache ...``).
"""

from __future__ import annotations

import fcntl
import hashlib
import io
import os
import pickle
import shutil
import subprocess
import tempfile
import time

from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common import logging as _log
from horovod_tpu_torch.runtime import flight as _flight
from horovod_tpu_torch.runtime import metrics as _metrics

SCHEMA = 1
_SUFFIX = ".aot"
#: the subdirectory a library entry's bytes are written to for loading
LIB_DIR = "lib"

# the reference's names and help texts (a library is one more kind of
# "program" here)
_M_HITS = _metrics.counter(
    "hvd_aot_cache_hits_total",
    "Programs loaded from the persistent AOT executable cache instead "
    "of compiled (docs/aot-cache.md).")
_M_MISSES = _metrics.counter(
    "hvd_aot_cache_misses_total",
    "Programs compiled cold because no (valid) AOT cache entry "
    "existed; counted only while the cache is enabled.")
_M_EVICTIONS = _metrics.counter(
    "hvd_aot_cache_evictions_total",
    "AOT cache entries evicted fail-closed (corrupt, truncated, "
    "version-skewed or wrong-key files) — each eviction recompiles.")
# registered by the metrics module for the goodput ledger's compile split
_M_COMPILE_S = _metrics.counter("hvd_compile_seconds_total")

_warned: set = set()
_version_cache: tuple | None = None


def cache_dir() -> str | None:
    d = str(_config.get("aot_cache_dir")).strip()
    return d or None


def mode() -> str:
    """Resolved serialization format: ``exec`` | ``export`` | ``off``."""
    m = str(_config.get("aot_cache_mode")).strip().lower()
    if m in ("", "auto"):
        return "exec"
    if m in ("exec", "export", "off"):
        return m
    _warn_once("mode", f"unknown HOROVOD_AOT_CACHE_MODE={m!r}; "
                       "expected auto|exec|export|off — cache disabled")
    return "off"


def enabled() -> bool:
    return cache_dir() is not None and mode() != "off"


def _warn_once(category: str, msg: str) -> None:
    if category not in _warned:
        _warned.add(category)
        _log.warning(f"aot-cache: {msg}")


def reset_warnings() -> None:  # test hook
    _warned.clear()


def versions() -> tuple:
    """(torch, CUDA toolkit, Triton) versions: part of every key.  The
    Triton version is read from the installed distribution, never by
    importing it."""
    global _version_cache
    if _version_cache is None:
        import torch

        triton = ""
        try:
            from importlib.metadata import version as _v

            for name in ("triton", "pytorch-triton"):
                try:
                    triton = _v(name)
                    break
                except Exception:
                    continue
        except Exception:
            pass
        _version_cache = (torch.__version__, torch.version.cuda or "",
                          triton)
    return _version_cache


def _topology() -> tuple:
    import torch

    from horovod_tpu_torch.common import basics as _basics

    st = _basics.state()
    dev = st.device
    name = ""
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
    return (st.size, st.local_size, st.cross_size, dev.type, name)


def _cfg_vector() -> tuple:
    # Lazy: the controller module is heavier than this one, and at the
    # only call sites (a program build) it is loaded anyway.
    from horovod_tpu_torch.runtime.controller import round0_cfg

    return tuple(int(v) for v in round0_cfg())


def context() -> tuple:
    """Everything but the program signature: recomputed per call (all
    env and state reads) so a mid-run knob change keys the rebuilt
    programs honestly."""
    return (SCHEMA, versions(), _topology(), _cfg_vector())


def _key_material(program_key) -> str:
    return repr((context(), repr(program_key)))


def _lib_key_material(name: str, key: str) -> str:
    # no topology and no cfg vector: a library does not depend on the
    # world it is loaded in
    return repr((SCHEMA, versions(), "lib", name, key))


def _path_of(material: str) -> str:
    digest = hashlib.sha256(material.encode()).hexdigest()[:32]
    return os.path.join(cache_dir() or "", digest + _SUFFIX)


def entry_path(program_key) -> str:
    return _path_of(_key_material(program_key))


def lib_entry_path(name: str, key: str) -> str:
    return _path_of(_lib_key_material(name, key))


def _label(program_key) -> str:
    """Short human name for CLI listings (kind + arity), best-effort."""
    try:
        kind = str(program_key[0])
        return f"{kind}:{len(repr(program_key))}"
    except Exception:
        return "?"


def _evict(path: str, reason: str, category: str) -> None:
    _M_EVICTIONS.inc()
    _warn_once(
        f"evict:{category}",
        f"evicting {os.path.basename(path)} ({reason}); rebuilding")
    try:
        os.unlink(path)
    except OSError:
        pass
    try:
        _flight.record("aot", event="evict", entry=os.path.basename(path),
                       reason=reason[:160])
    except Exception:
        pass


def _record_hit(label: str, dt: float) -> None:
    _M_HITS.inc()
    _M_COMPILE_S.inc(dt, path="warm")
    try:
        # ``label``: the reference passes ``kind=``, which collides with
        # the record's own kind and is dropped inside its guard
        _flight.record("aot", event="hit", label=label,
                       load_s=round(dt, 4))
    except Exception:
        pass


def _read_record(path: str, material: str, modes: tuple):
    """The checked record at ``path``, or ``None`` (absent, or evicted
    here: unreadable, schema or version skew, key mismatch, foreign
    mode)."""
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            rec = pickle.load(f)
    except Exception as exc:
        _evict(path, f"unreadable/corrupt: {exc!r}", "corrupt")
        return None
    # Explicit category per failure class: the warn-once dedup is per
    # class, so a later DIFFERENT failure still surfaces.
    if not isinstance(rec, dict) or rec.get("schema") != SCHEMA:
        got = rec.get("schema") if isinstance(rec, dict) else "?"
        _evict(path, f"schema skew: {got} != {SCHEMA}", "schema")
        return None
    if rec.get("versions") != versions():
        _evict(path, f"version skew: built under {rec.get('versions')}, "
                     f"running {versions()}", "version")
        return None
    if rec.get("key") != material:
        _evict(path, "key mismatch (collision or relocated file)", "key")
        return None
    if rec.get("mode") not in modes:
        _evict(path, f"unknown entry mode {rec.get('mode')!r}", "mode")
        return None
    return rec


def _load_program(payload: bytes, fmt: str, work: str):
    import torch

    if fmt == "export":
        return torch.export.load(io.BytesIO(payload)).module()
    path = os.path.join(work, "program.pt2")
    with open(path, "wb") as f:
        f.write(payload)
    return torch._inductor.aoti_load_package(path)


def _try_load(program_key):
    """Load one program entry, or ``None``; NEVER raises (any failure
    evicts and falls through to a cold build)."""
    path = entry_path(program_key)
    rec = _read_record(path, _key_material(program_key), ("exec", "export"))
    if rec is None:
        return None
    work = tempfile.mkdtemp(prefix=".load-", dir=cache_dir())
    try:
        return _load_program(rec["payload"], rec["mode"], work)
    except Exception as exc:
        _evict(path, f"{type(exc).__name__}: {exc}", "deserialize")
        return None
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _atomic_write(path: str, rec: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(tmp, "wb") as f:
            pickle.dump(rec, f)
        os.replace(tmp, path)
    except Exception as exc:
        _warn_once("persist", f"could not persist entry ({exc!r}); "
                              "it will rebuild next start")
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _as_module(fn):
    """``build()``'s plain callable as an ``nn.Module`` for
    ``torch.export``."""
    import torch

    if isinstance(fn, torch.nn.Module):
        return fn

    class Program(torch.nn.Module):
        def forward(self, *a):
            return fn(*a)

    return Program()


# A one-function OpenMP shared library: AOTInductor compiles and links
# every ``exec`` program with ``-fopenmp`` and ``-lgomp``
# (``torch._inductor.cpp_builder._get_openmp_args``).
_OMP_PROBE = ('#include <omp.h>\n'
              'extern "C" int hvd_probe() { return omp_get_max_threads(); }\n')
_exec_cxx: dict | None = None


def cxx_candidates() -> list:
    """The C++ compilers :func:`exec_compiler` tries, in order: ``$CXX``,
    ``g++`` on ``PATH``, ``/usr/bin/g++``, ``c++`` on ``PATH`` (each
    once)."""
    out = []
    for c in (os.environ.get("CXX"), shutil.which("g++"), "/usr/bin/g++",
              shutil.which("c++")):
        if c and c not in out:
            out.append(c)
    return out


def _probe_cxx(cxx: str, work: str) -> str | None:
    """``None`` when ``cxx`` compiles and links the OpenMP probe as a
    shared library, else its error (the compiler's last output)."""
    src = os.path.join(work, "omp_probe.cc")
    with open(src, "w") as f:
        f.write(_OMP_PROBE)
    cmd = [cxx, "-shared", "-fPIC", "-fopenmp", src, "-o",
           os.path.join(work, "omp_probe.so"), "-lgomp"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"{type(exc).__name__}: {exc}"
    if proc.returncode == 0:
        return None
    err = (proc.stderr or proc.stdout).strip()
    return err[-1000:] or f"exit code {proc.returncode}"


def exec_compiler(candidates=None) -> dict:
    """The C++ compiler for the ``exec`` format's AOTInductor build: the
    first of ``candidates`` (default :func:`cxx_candidates`) whose
    ``-fopenmp`` link of a probe succeeds becomes
    ``torch._inductor.config.cpp.cxx``.  Returns ``{"chosen": path or
    None, "probes": [{"cxx", "error"}]}`` (``error`` ``None`` for the
    chosen one; the candidates after it are not probed) and records it
    as the ``aot`` flight event ``compiler``.  The default probe runs
    once per process."""
    global _exec_cxx
    if candidates is None and _exec_cxx is not None:
        return _exec_cxx
    import torch._inductor.config as inductor_config

    rec = {"chosen": None, "probes": []}
    with tempfile.TemporaryDirectory(prefix="hvd-cxx-") as work:
        for cxx in (cxx_candidates() if candidates is None else candidates):
            err = _probe_cxx(cxx, work)
            rec["probes"].append({"cxx": cxx, "error": err})
            if err is None:
                rec["chosen"] = cxx
                inductor_config.cpp.cxx = cxx
                break
    try:
        _flight.record("aot", event="compiler", chosen=rec["chosen"],
                       probes=[(p["cxx"], p["error"])
                               for p in rec["probes"]])
    except Exception:
        pass
    if candidates is None:
        _exec_cxx = rec
    return rec


def _compile(fn, args, fmt: str, work: str):
    """``(program, artifact)``: the exported (``export``) or
    AOTInductor-compiled and loaded (``exec``) program, and what
    :func:`_serialize` persists of it.  ``exec`` first picks its C++
    compiler (:func:`exec_compiler`) and raises, naming every probe's
    error, when none links OpenMP."""
    import torch

    ep = torch.export.export(_as_module(fn), tuple(args))
    if fmt == "export":
        return ep.module(), ep
    cxx = exec_compiler()
    if cxx["chosen"] is None:
        raise RuntimeError(
            "no C++ compiler links -fopenmp for AOTInductor: " + "; ".join(
                f"{p['cxx']}: {p['error']}" for p in cxx["probes"]))
    pkg = torch._inductor.aoti_compile_and_package(
        ep, package_path=os.path.join(work, "program.pt2"))
    return torch._inductor.aoti_load_package(pkg), pkg


def _serialize(artifact, fmt: str) -> bytes:
    """Payload for one fresh program (advisory: a failure here leaves
    the program running, just not persisted)."""
    if fmt == "exec":
        with open(artifact, "rb") as f:
            return f.read()
    import torch

    buf = io.BytesIO()
    torch.export.save(artifact, buf)
    return buf.getvalue()


def compile_or_load(program_key, build, args):
    """The entry point for a program: ``build()`` returns a module or a
    plain callable, ``args`` are the concrete call arguments (their
    shapes, dtypes and devices are what the export binds).  Returns a
    callable with the program's calling convention: a cache-loaded
    program on a hit, the fresh program on a miss (persisted for next
    time), or ``build()``'s own callable when the cache is off or when
    export or compilation fails.  Seconds are counted either way
    (``hvd_compile_seconds_total{path=cold|warm}``)."""
    t0 = time.perf_counter()
    if enabled():
        loaded = _try_load(program_key)
        if loaded is not None:
            _record_hit(_label(program_key), time.perf_counter() - t0)
            return loaded
        _M_MISSES.inc()
    fn = build()
    if not enabled():
        # nothing to persist: the eager callable is the program
        _M_COMPILE_S.inc(time.perf_counter() - t0, path="cold")
        return fn
    fmt = mode()
    d = cache_dir()
    os.makedirs(d, exist_ok=True)
    work = tempfile.mkdtemp(prefix=".build-", dir=d)
    try:
        try:
            program, artifact = _compile(fn, args, fmt, work)
        except Exception as exc:
            _M_COMPILE_S.inc(time.perf_counter() - t0, path="cold")
            _warn_once("lower", f"export/compile unavailable for "
                                f"{_label(program_key)} ({exc!r}); using "
                                "the eager callable (not cacheable)")
            try:
                _flight.record("aot", event="uncached",
                               label=_label(program_key), mode=fmt,
                               error=f"{type(exc).__name__}: {exc}"[:2000])
            except Exception:
                pass
            return fn
        compile_s = time.perf_counter() - t0
        _M_COMPILE_S.inc(compile_s, path="cold")
        try:
            payload = _serialize(artifact, fmt)
        except Exception as exc:
            _warn_once("serialize",
                       f"could not serialize {_label(program_key)} "
                       f"({exc!r}); it will rebuild next start")
            payload = None
        if payload is not None:
            _atomic_write(entry_path(program_key), {
                "schema": SCHEMA,
                "mode": fmt,
                "versions": versions(),
                "key": _key_material(program_key),
                "label": _label(program_key),
                "created": time.time(),
                "compile_s": round(compile_s, 4),
                "payload": payload,
            })
        return program
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# Libraries: the builds of horovod_tpu_torch._build
# ---------------------------------------------------------------------------


def _materialize(name: str, data: bytes, digest: str, suffix: str) -> str:
    """Write a library's bytes to ``lib/<name>-<sha>.<suffix>`` in the
    cache directory (atomically: a process that mapped an earlier copy
    keeps it) and return the path."""
    d = os.path.join(cache_dir(), LIB_DIR)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{name}-{digest[:16]}{suffix}")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path


def _try_load_lib(name: str, key: str, suffix: str, load):
    """``(library, path)`` from the entry, or ``None``: any failure,
    the loader's included, evicts."""
    path = lib_entry_path(name, key)
    rec = _read_record(path, _lib_key_material(name, key), ("lib",))
    if rec is None:
        return None
    try:
        data, digest = rec["payload"]
    except Exception as exc:
        _evict(path, f"malformed payload: {exc!r}", "payload")
        return None
    if hashlib.sha256(data).hexdigest() != digest:
        _evict(path, "payload does not match its SHA-256", "hash")
        return None
    try:
        out = _materialize(name, data, digest, suffix)
        return load(out), out
    except Exception as exc:
        _evict(path, f"{type(exc).__name__}: {exc}", "load")
        return None


def build_or_load(name: str, key: str, build, load, suffix: str = ".so"):
    """The entry point for a library while the cache is enabled.
    ``key`` is the builder's key (source, flags, compiler identity);
    ``build(out)`` writes the library to ``out`` and returns its log
    (it raises when the build fails); ``load(path)`` loads it.  Returns
    ``(library, info)`` with ``info`` = ``{"seconds", "log", "path",
    "hit", "entry"}`` (``path`` the loaded file, ``entry`` the
    record).  A miss builds under ``name``'s file lock in the cache
    directory; a process that takes the lock after another built the
    entry loads it and counts a hit, so a world builds each library
    once."""
    t0 = time.perf_counter()
    d = cache_dir()
    got = _try_load_lib(name, key, suffix, load)
    if got is None:
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{name}.lock"), "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                got = _try_load_lib(name, key, suffix, load)
                if got is None:
                    return _build_lib(name, key, build, load, suffix, t0)
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)
    dt = time.perf_counter() - t0
    _record_hit(f"lib:{name}", dt)
    return got[0], {"seconds": dt, "log": "", "path": got[1], "hit": True,
                    "entry": lib_entry_path(name, key)}


def _build_lib(name, key, build, load, suffix, t0):
    _M_MISSES.inc()
    work = tempfile.mkdtemp(prefix=".build-", dir=cache_dir())
    try:
        tmp = os.path.join(work, f"{name}{suffix}")
        log = build(tmp)
        with open(tmp, "rb") as f:
            data = f.read()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    digest = hashlib.sha256(data).hexdigest()
    material = _lib_key_material(name, key)
    _atomic_write(lib_entry_path(name, key), {
        "schema": SCHEMA,
        "mode": "lib",
        "versions": versions(),
        "key": material,
        "label": f"lib:{name}",
        "created": time.time(),
        "compile_s": round(time.perf_counter() - t0, 4),
        "payload": (data, digest),
    })
    out = _materialize(name, data, digest, suffix)
    lib = load(out)
    dt = time.perf_counter() - t0
    _M_COMPILE_S.inc(dt, path="cold")
    return lib, {"seconds": dt, "log": log, "path": out, "hit": False,
                 "entry": lib_entry_path(name, key)}


def count_cold(seconds: float) -> None:
    """A real build's seconds while the cache is off (the reference
    counts its cold compiles with the cache off too)."""
    _M_COMPILE_S.inc(seconds, path="cold")


def stats() -> dict:
    """Counter snapshot for smoke runs and tests."""
    return {
        "hits": int(_M_HITS.total()),
        "misses": int(_M_MISSES.total()),
        "evictions": int(_M_EVICTIONS.total()),
        "compile_s_cold": round(_M_COMPILE_S.value(path="cold"), 4),
        "compile_s_warm": round(_M_COMPILE_S.value(path="warm"), 4),
    }


# ---------------------------------------------------------------------------
# CLI: list / info / prune / clear
# ---------------------------------------------------------------------------


def iter_entries(d: str):
    """Yield ``(path, meta | None)`` per cache file; ``None`` meta
    marks an unreadable entry."""
    for name in sorted(os.listdir(d)):
        if not name.endswith(_SUFFIX):
            continue
        path = os.path.join(d, name)
        try:
            with open(path, "rb") as f:
                rec = pickle.load(f)
            meta = {k: rec.get(k) for k in
                    ("schema", "mode", "versions", "label", "created",
                     "compile_s")}
            meta["bytes"] = os.path.getsize(path)
            yield path, meta
        except Exception:
            yield path, None


def prune(d: str, max_age_days: float = 0.0, max_mb: float = 0.0,
          stale_only: bool = False) -> list:
    """Delete corrupt entries, entries older than ``max_age_days``,
    version-skewed entries (``stale_only`` restricts to these two),
    then the oldest entries beyond ``max_mb``.  Returns deleted paths."""
    deleted: list = []
    keep: list = []
    now = time.time()
    cur_versions = versions()
    for path, meta in iter_entries(d):
        if meta is None or meta.get("schema") != SCHEMA \
                or meta.get("versions") != cur_versions:
            deleted.append(path)
            continue
        age_days = (now - float(meta.get("created") or 0)) / 86400.0
        if max_age_days and age_days > max_age_days:
            deleted.append(path)
            continue
        keep.append((float(meta.get("created") or 0), meta["bytes"], path))
    if max_mb and not stale_only:
        keep.sort()  # oldest first
        total = sum(b for _, b, _ in keep)
        budget = max_mb * 1024 * 1024
        while keep and total > budget:
            _, b, path = keep.pop(0)
            total -= b
            deleted.append(path)
    for path in deleted:
        try:
            os.unlink(path)
        except OSError:
            pass
    return deleted


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.runtime.aot_cache",
        description="Inspect/prune the persistent AOT cache "
                    "(HOROVOD_AOT_CACHE_DIR).")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, hlp in (("list", "one line per cached program or library"),
                      ("info", "aggregate totals"),
                      ("clear", "delete every entry"),
                      ("prune", "delete corrupt/skewed/old entries")):
        sp = sub.add_parser(name, help=hlp)
        sp.add_argument("dir", nargs="?", default=cache_dir(),
                        help="cache directory (default: "
                             "HOROVOD_AOT_CACHE_DIR)")
        if name == "prune":
            sp.add_argument("--max-age-days", type=float, default=0.0,
                            help="also delete entries older than this")
            sp.add_argument("--max-mb", type=float, default=0.0,
                            help="then trim oldest entries beyond this "
                                 "total size")
    args = p.parse_args(argv)
    d = args.dir
    if not d:
        print("no cache dir (set HOROVOD_AOT_CACHE_DIR or pass one)")
        return 1
    if not os.path.isdir(d):
        print(f"{d}: not a directory")
        return 1
    if args.cmd == "list":
        rows = list(iter_entries(d))
        for path, meta in rows:
            if meta is None:
                print(f"{os.path.basename(path):36s}  CORRUPT")
                continue
            age = time.time() - float(meta.get("created") or 0)
            print(f"{os.path.basename(path):36s}  {meta['mode']:6s}  "
                  f"{meta['bytes']:>9d}B  {age / 3600:6.1f}h  "
                  f"torch={meta['versions'][0]}  "
                  f"compile={meta.get('compile_s')}s  {meta['label']}")
        print(f"{len(rows)} entr{'y' if len(rows) == 1 else 'ies'}")
        return 0
    if args.cmd == "info":
        n = bad = total = 0
        saved = 0.0
        for _, meta in iter_entries(d):
            n += 1
            if meta is None:
                bad += 1
            else:
                total += meta["bytes"]
                saved += float(meta.get("compile_s") or 0)
        print(f"dir={d} entries={n} corrupt={bad} "
              f"bytes={total} cold_compile_s_banked={saved:.2f}")
        return 0
    if args.cmd == "clear":
        deleted = [path for path, _ in iter_entries(d)]
        for path in deleted:
            try:
                os.unlink(path)
            except OSError:
                pass
        # the libraries' loadable copies (a process that mapped one
        # keeps it)
        shutil.rmtree(os.path.join(d, LIB_DIR), ignore_errors=True)
        print(f"deleted {len(deleted)} entr"
              f"{'y' if len(deleted) == 1 else 'ies'}")
        return 0
    deleted = prune(d, args.max_age_days, args.max_mb)
    print(f"pruned {len(deleted)} entr"
          f"{'y' if len(deleted) == 1 else 'ies'}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
