"""The port's persistent AOT cache (``horovod_tpu_torch/runtime/aot_cache.py``)
against the JAX package's (``tests/test_aot_cache.py``).

Parity: the seven reference tests that pass here run the JAX function
and the port's counterpart on the same inputs (``export`` round trips,
the off switch, advisory serialization, the key's cfg vector and
program key, the CLI's lines with the version and sizes masked and
``prune``'s choice of entries, the trace CLI's delegation).

The port's own contracts, where the reference's tests fail on the
installed jax: the ``exec`` (AOTInductor) round trip, the five
corruptions evicted and rebuilt over a program and over a ``g++``
library entry (and a library whose bytes miss their hash, or do not
load), a two-rank gloo world cold then warm over one cache directory
(each library built once across the world, then no miss), the
compiler's identity in the ``_build/`` name, ``init()``'s
announcement.  One AOTInductor compile costs ~50 s of CPU here, so only
the round trip compiles in ``exec``; the rest run in ``export``.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from horovod_tpu.runtime import aot_cache as J
from horovod_tpu.trace.__main__ import main as jtrace_main
from horovod_tpu_torch import _build
from horovod_tpu_torch.runtime import aot_cache as A
from horovod_tpu_torch.trace.__main__ import main as trace_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TL, KV = ("hvdtorchtl", "timeline.cc"), ("hvdtorchkv", "kvstore.cc")


@pytest.fixture()
def cache_dir(tmp_path, monkeypatch):
    d = str(tmp_path / "aot")
    monkeypatch.setenv("HOROVOD_AOT_CACHE_DIR", d)
    monkeypatch.delenv("HOROVOD_AOT_CACHE_MODE", raising=False)
    J.reset_warnings()
    A.reset_warnings()
    yield d


@pytest.fixture()
def fresh_libs(monkeypatch):
    """The build module's in-process tables, emptied for the test and
    restored after it (other tests of the worker keep their loads)."""
    for name in ("_libs", "_modules", "build_info"):
        monkeypatch.setattr(_build, name, {})


def _jbuild():
    import jax

    return jax.jit(lambda x: x * 2 + 1)


def _tbuild():
    return lambda x: x * 2 + 1


def _both(n: int):
    """``(package, module, build, input)`` of each package on the same
    values."""
    x = np.arange(float(n), dtype=np.float32)
    return (("jax", J, _jbuild, jnp.asarray(x)),
            ("port", A, _tbuild, torch.from_numpy(x.copy())))


def _np(y) -> np.ndarray:
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


# ---------------------------------------------------------------------------
# Parity with the reference's passing tests
# ---------------------------------------------------------------------------


def test_export_mode_roundtrip(cache_dir, monkeypatch):
    monkeypatch.setenv("HOROVOD_AOT_CACHE_MODE", "export")
    key = ("t_export", (6,))
    outs = {}
    for pkg, M, build, x in _both(6):
        s0 = M.stats()
        y1 = _np(M.compile_or_load(key, build, [x])(x))
        y2 = _np(M.compile_or_load(key, build, [x])(x))
        s1 = M.stats()
        assert s1["hits"] == s0["hits"] + 1, pkg
        assert s1["misses"] == s0["misses"] + 1, pkg
        np.testing.assert_array_equal(y1, y2)
        with open(M.entry_path(key), "rb") as f:
            assert pickle.load(f)["mode"] == "export", pkg
        outs[pkg] = y2
    np.testing.assert_array_equal(outs["port"], outs["jax"])


def test_mode_off_and_unset_dir(cache_dir, monkeypatch):
    monkeypatch.setenv("HOROVOD_AOT_CACHE_MODE", "off")
    outs = {}
    for pkg, M, build, x in _both(4):
        assert not M.enabled() and M.mode() == "off", pkg
        outs[pkg] = _np(M.compile_or_load(("t_off",), build, [x])(x))
    np.testing.assert_array_equal(outs["port"], outs["jax"])
    assert not os.path.exists(cache_dir) or not os.listdir(cache_dir)
    monkeypatch.setenv("HOROVOD_AOT_CACHE_MODE", "bogus")
    assert J.mode() == A.mode() == "off"
    monkeypatch.delenv("HOROVOD_AOT_CACHE_MODE", raising=False)
    assert J.mode() == A.mode() == "exec"
    monkeypatch.delenv("HOROVOD_AOT_CACHE_DIR", raising=False)
    assert not J.enabled() and not A.enabled()
    assert J.cache_dir() is None and A.cache_dir() is None


def test_serialize_failure_is_advisory(cache_dir, monkeypatch):
    """A program the serializer rejects still runs, and is not
    persisted.  The port runs in ``export`` (its ``exec`` compile would
    cost an AOTInductor build before the serializer is reached)."""
    def boom(*a, **k):
        raise RuntimeError("no serialization today")

    monkeypatch.setattr(J, "_serialize", boom)
    monkeypatch.setattr(A, "_serialize", boom)
    key = ("t_serfail", (5,))
    outs = {}
    for pkg, M, build, x in _both(5):
        if pkg == "port":
            monkeypatch.setenv("HOROVOD_AOT_CACHE_MODE", "export")
        outs[pkg] = _np(M.compile_or_load(key, build, [x])(x))
        assert not os.path.exists(M.entry_path(key)), pkg
    np.testing.assert_array_equal(outs["port"], outs["jax"])


def test_cfg_vector_discriminates_keys(cache_dir, monkeypatch):
    key = ("t_cfgkey", (4,))
    paths = {"jax": [], "port": []}

    def take():
        # the same round-0 vector in both packages, knob for knob
        assert A._cfg_vector() == J._cfg_vector()
        paths["jax"].append(J.entry_path(key))
        paths["port"].append(A.entry_path(key))

    take()
    monkeypatch.setenv("HOROVOD_COMPRESSION", "int8")
    take()
    monkeypatch.setenv("HOROVOD_ZERO_STAGE", "2")
    take()
    for pkg, p in paths.items():
        assert len(set(p)) == 3, pkg


def test_program_key_discriminates(cache_dir):
    for M in (J, A):
        assert M.entry_path(("ar", (4,))) != M.entry_path(("ar", (8,)))
        assert M.entry_path(("ar", (4,))) == M.entry_path(("ar", (4,)))


_HEX = re.compile(r"\b[0-9a-f]{32}\.aot\b")


def _mask(line: str) -> str:
    """A CLI line with what differs between the packages masked: the
    entry's file name, its size, the framework's name and version, the
    build seconds, the directory."""
    line = _HEX.sub("<entry>", line)
    line = re.sub(r"\b\d+B\b", "<n>B", line)
    line = re.sub(r"\b(jax|torch)=\S+", "<version>", line)
    line = re.sub(r"compile=\S+s", "compile=<s>", line)
    line = re.sub(r"dir=\S+", "dir=<d>", line)
    line = re.sub(r"bytes=\d+", "bytes=<n>", line)
    return re.sub(r"banked=\S+", "banked=<s>", line)


def _cli(M, argv, capsys) -> tuple:
    rc = M.main(argv)
    return rc, sorted(_mask(ln) for ln in
                      capsys.readouterr().out.splitlines())


def _seed(M, build, key, x):
    M.compile_or_load(key, build, [x])
    path = M.entry_path(key)
    assert os.path.exists(path)
    return path


def test_cli_list_info_prune_clear(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HOROVOD_AOT_CACHE_MODE", "export")
    got, kept = {}, {}
    for pkg, M, build, x in _both(12):
        d = str(tmp_path / pkg)
        monkeypatch.setenv("HOROVOD_AOT_CACHE_DIR", d)
        _seed(M, build, ("t_cli_a", (12,)), x)
        _seed(M, build, ("t_cli_b", (12,)), x)
        # one corrupt and one version-skewed entry for prune to collect
        bad = os.path.join(d, "deadbeef" + "0" * 24 + ".aot")
        with open(bad, "wb") as f:
            f.write(b"junk")
        skew = _seed(M, build, ("t_cli_skew", (12,)), x)
        with open(skew, "rb") as f:
            rec = pickle.load(f)
        rec["versions"] = ("9.9.9", "9.9.9", "")
        with open(skew, "wb") as f:
            pickle.dump(rec, f)
        runs = [_cli(M, [cmd, d], capsys) for cmd in ("list", "info")]
        assert "4 entries" in runs[0][1] and runs[0][0] == 0
        assert any("CORRUPT" in ln for ln in runs[0][1])
        assert any("entries=4 corrupt=1" in ln for ln in runs[1][1])
        runs.append(_cli(M, ["prune", d], capsys))
        assert runs[-1] == (0, ["pruned 2 entries"])
        assert not os.path.exists(bad) and not os.path.exists(skew)
        # prune's choice: the two valid entries stay, by label
        kept[pkg] = sorted(meta["label"] for _, meta in M.iter_entries(d))
        runs.append(_cli(M, ["clear", d], capsys))
        assert not [n for n in os.listdir(d) if n.endswith(".aot")]
        runs.append(_cli(M, ["list", str(tmp_path / "absent")], capsys))
        got[pkg] = runs
    assert got["port"] == got["jax"]
    assert kept["port"] == kept["jax"] == ["t_cli_a:18", "t_cli_b:18"]


def test_trace_cli_delegates(cache_dir, monkeypatch, capsys):
    monkeypatch.setenv("HOROVOD_AOT_CACHE_MODE", "export")
    lines = {}
    for (pkg, M, build, x), main in zip(_both(3), (jtrace_main,
                                                   trace_main)):
        d = os.path.join(cache_dir, pkg)
        monkeypatch.setenv("HOROVOD_AOT_CACHE_DIR", d)
        _seed(M, build, ("t_trace_cli", (3,)), x)
        assert main(["aot-cache", "list", d]) == 0
        out = capsys.readouterr().out
        assert "1 entry" in out, pkg
        lines[pkg] = [_mask(ln) for ln in out.splitlines()]
    assert lines["port"] == lines["jax"]


# ---------------------------------------------------------------------------
# The port's own contracts (the reference's tests of them fail on the
# installed jax)
# ---------------------------------------------------------------------------


def test_roundtrip_hit_and_miss(cache_dir):
    """``exec``: an AOTInductor package, loaded warm without compiling
    (the suite's one ``exec`` compile)."""
    x = torch.arange(8.0)
    key = ("t_roundtrip", (8,), "f32")
    s0 = A.stats()
    fn = A.compile_or_load(key, _tbuild, [x])
    torch.testing.assert_close(fn(x), x * 2 + 1, rtol=0, atol=0)
    s1 = A.stats()
    assert s1["misses"] == s0["misses"] + 1
    assert s1["hits"] == s0["hits"]
    with open(A.entry_path(key), "rb") as f:
        assert pickle.load(f)["mode"] == "exec"
    fn2 = A.compile_or_load(key, _tbuild, [x])
    torch.testing.assert_close(fn2(x), x * 2 + 1, rtol=0, atol=0)
    s2 = A.stats()
    assert s2["hits"] == s1["hits"] + 1
    assert s2["misses"] == s1["misses"]
    assert s2["compile_s_warm"] > s1["compile_s_warm"]
    # the warm load skips the compile
    assert (s2["compile_s_warm"] - s1["compile_s_warm"]) * 10 \
        < s1["compile_s_cold"] - s0["compile_s_cold"]


def _fake_cxx(tmp_path, name: str, msg: str) -> str:
    """A "compiler" that fails every call with ``msg`` on stderr."""
    p = tmp_path / name
    p.write_text(f"#!/bin/sh\necho \"{msg}\" >&2\nexit 1\n")
    p.chmod(0o755)
    return str(p)


def _aot_events(event: str) -> list:
    from horovod_tpu_torch.runtime import flight

    return [e for e in flight.recorder().snapshot()
            if e["kind"] == "aot" and e.get("event") == event]


def test_exec_compiler_takes_the_first_that_links(tmp_path, monkeypatch):
    """The ``exec`` format's compiler probe: candidates in order, the
    first whose ``-fopenmp`` link succeeds becomes inductor's
    ``cpp.cxx`` and the rest are not tried; the record (also the ``aot``
    flight event ``compiler``) lists each tried candidate's error."""
    import torch._inductor.config as inductor_config

    monkeypatch.setattr(inductor_config.cpp, "cxx", inductor_config.cpp.cxx)
    nospec = _fake_cxx(tmp_path, "gxx-nospec",
                       "g++: fatal error: cannot read spec file "
                       "'libgomp.spec'")
    absent = str(tmp_path / "absent-g++")
    good = shutil.which("g++")
    rec = A.exec_compiler([nospec, absent, good, nospec])
    assert rec["chosen"] == good and inductor_config.cpp.cxx == good
    assert [p["cxx"] for p in rec["probes"]] == [nospec, absent, good]
    assert "libgomp.spec" in rec["probes"][0]["error"]
    assert "absent-g++" in rec["probes"][1]["error"]
    assert rec["probes"][2]["error"] is None
    ev = _aot_events("compiler")[-1]
    assert ev["chosen"] == good and len(ev["probes"]) == 3


def test_exec_without_a_linking_compiler_lists_every_error(
        cache_dir, tmp_path, monkeypatch):
    """No candidate links: the record names every candidate with its
    error, the program runs eagerly and uncached, and its ``uncached``
    flight event's error lists every candidate's."""
    import torch._inductor.config as inductor_config

    monkeypatch.setattr(inductor_config.cpp, "cxx", inductor_config.cpp.cxx)
    monkeypatch.setenv("HOROVOD_AOT_CACHE_MODE", "exec")
    fakes = [_fake_cxx(tmp_path, f"cxx{i}",
                       f"cxx{i}: cannot read spec file 'libgomp.spec'")
             for i in range(2)]
    monkeypatch.setattr(A, "cxx_candidates", lambda: fakes)
    monkeypatch.setattr(A, "_exec_cxx", None)
    x = torch.arange(4.0)
    key = ("t_no_cxx", (4,), "f32")
    fn = A.compile_or_load(key, _tbuild, [x])
    torch.testing.assert_close(fn(x), x * 2 + 1, rtol=0, atol=0)
    assert not os.path.exists(A.entry_path(key))
    rec = A.exec_compiler()
    assert rec["chosen"] is None
    assert [p["cxx"] for p in rec["probes"]] == fakes
    assert all(f"{os.path.basename(p['cxx'])}: cannot read spec file"
               in p["error"] for p in rec["probes"])
    err = _aot_events("uncached")[-1]["error"]
    assert all(f in err for f in fakes), err


def _lib_entry(name: str, source: str) -> tuple:
    lib = _build.load_host_library(name, source)
    info = _build.build_info[name]
    assert lib.hvd_tl_open if name == TL[0] else lib.hvd_kv_connect
    return info["entry"], info


def _seed_lib(kind: str, key, x) -> str:
    if kind == "program":
        return _seed(A, _tbuild, key, x)
    path, info = _lib_entry(*TL)
    assert not info["hit"]
    return path


def _reload(kind: str, key, x):
    """One more load of the seeded artifact; its output (the program's
    result, or whether the library served from the cache)."""
    if kind == "program":
        return A.compile_or_load(key, _tbuild, [x])(x)
    _build.forget()
    lib = _build.load_host_library(*TL)
    assert lib.hvd_tl_open and lib.hvd_tl_close
    return _build.build_info[TL[0]]["hit"]


def _corrupt(kind: str, corruption: str, path: str, x) -> None:
    if corruption == "garbage":
        with open(path, "wb") as f:
            f.write(b"\x00not a pickle at all")
    elif corruption == "truncated":
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[:len(data) // 3])
    elif corruption in ("version_skew", "schema_skew", "hash_mismatch",
                        "unloadable"):
        with open(path, "rb") as f:
            rec = pickle.load(f)
        if corruption == "version_skew":
            rec["versions"] = ("0.0.1", "0.0.1", "")
        elif corruption == "schema_skew":
            rec["schema"] = A.SCHEMA + 999
        else:
            data, digest = rec["payload"]
            bad = data[:len(data) // 2] + b"\x00" + data[len(data) // 2 + 1:]
            if corruption == "unloadable":
                # bytes that match their hash but are no library
                bad = b"\x7fELF" + b"\x00" * 60
                digest = A.hashlib.sha256(bad).hexdigest()
            rec["payload"] = (bad, digest)
        with open(path, "wb") as f:
            pickle.dump(rec, f)
    else:  # wrong_key: ANOTHER artifact's entry moved onto this key
        if kind == "program":
            other = _seed(A, _tbuild, ("t_other_program", (16,)), x)
        else:
            other, _ = _lib_entry(*KV)
        shutil.copy(other, path)


@pytest.mark.parametrize("corruption", [
    "garbage", "truncated", "version_skew", "schema_skew", "wrong_key",
])
@pytest.mark.parametrize("kind", ["program", "library"])
def test_bad_entries_evicted_and_recompiled(cache_dir, monkeypatch,
                                            fresh_libs, kind, corruption):
    monkeypatch.setenv("HOROVOD_AOT_CACHE_MODE", "export")
    _evicted_rebuilt_hit(kind, corruption)


@pytest.mark.parametrize("corruption", ["hash_mismatch", "unloadable"])
def test_library_payload_evicted_and_rebuilt(cache_dir, fresh_libs,
                                             corruption):
    """A library entry whose bytes miss their SHA-256, or whose bytes
    match it but fail ``ctypes.CDLL``, is evicted and built again: it
    never loads, and never gives way to anything but a rebuild."""
    _evicted_rebuilt_hit("library", corruption)


def _evicted_rebuilt_hit(kind: str, corruption: str) -> None:
    x = torch.arange(16.0)
    key = (f"t_{corruption}", (16,))
    path = _seed_lib(kind, key, x)
    _corrupt(kind, corruption, path, x)
    s0 = A.stats()
    y = _reload(kind, key, x)
    s1 = A.stats()
    assert s1["evictions"] == s0["evictions"] + 1, corruption
    assert s1["misses"] == s0["misses"] + 1  # rebuilt, not crashed
    if kind == "program":
        torch.testing.assert_close(y, x * 2 + 1, rtol=0, atol=0)
    else:
        assert y is False
    # the rebuild persisted a VALID entry in place of the bad one
    y2 = _reload(kind, key, x)
    s2 = A.stats()
    assert s2["hits"] == s1["hits"] + 1
    assert s2["evictions"] == s1["evictions"]
    assert s2["misses"] == s1["misses"]
    if kind == "program":
        torch.testing.assert_close(y2, x * 2 + 1, rtol=0, atol=0)
    else:
        assert y2 is True


def test_library_hit_counts_and_cli(cache_dir, fresh_libs, capsys):
    """A library's first load builds (a miss, cold seconds), the next
    loads its entry (a hit, warm seconds, one ``hit`` flight event);
    the CLI lists it in mode ``lib``."""
    from horovod_tpu_torch.runtime import flight

    s0 = A.stats()
    _, info = _lib_entry(*TL)
    s1 = A.stats()
    assert (s1["misses"], s1["hits"]) == (s0["misses"] + 1, s0["hits"])
    assert s1["compile_s_cold"] > s0["compile_s_cold"]
    assert info["path"].startswith(os.path.join(cache_dir, A.LIB_DIR))
    _build.forget()
    _lib_entry(*TL)
    s2 = A.stats()
    assert (s2["misses"], s2["hits"]) == (s1["misses"], s1["hits"] + 1)
    assert s2["compile_s_warm"] > s1["compile_s_warm"]
    hits = [e for e in flight.recorder().snapshot()
            if e["kind"] == "aot" and e.get("event") == "hit"]
    assert hits and hits[-1]["label"] == "lib:hvdtorchtl"
    assert A.main(["list", cache_dir]) == 0
    out = capsys.readouterr().out
    assert "lib:hvdtorchtl" in out and " lib " in out and "1 entry" in out


def test_compiler_identity_names_another_build(tmp_path, monkeypatch,
                                               fresh_libs):
    """The repair of the library's name: the key carries the compiler's
    identity, so another ``nvcc`` or ``g++`` gives another ``_build/``
    file, and the cache off still counts a real build's seconds."""
    monkeypatch.delenv("HOROVOD_AOT_CACHE_DIR", raising=False)
    monkeypatch.setattr(_build, "_compilers", {"nvcc": "nvcc A"})
    a = _build.library_path("fused_update")
    monkeypatch.setitem(_build._compilers, "nvcc", "nvcc B")
    b = _build.library_path("fused_update")
    assert a != b
    assert {os.path.dirname(a), os.path.dirname(b)} == {_build.BUILD_DIR}
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    paths = []
    for ident in ("g++ 1.0", "g++ 2.0"):
        monkeypatch.setitem(_build._compilers, "g++", ident)
        _build.forget()
        s0 = A.stats()
        _build.load_host_library(*TL)
        s1 = A.stats()
        assert s1["compile_s_cold"] > s0["compile_s_cold"]
        # hits and misses count only while the cache is enabled
        assert (s1["hits"], s1["misses"]) == (s0["hits"], s0["misses"])
        paths.append(_build.build_info[TL[0]]["path"])
    assert paths[0] != paths[1] and all(map(os.path.exists, paths))
    assert all(os.path.basename(p).startswith("libhvdtorchtl_")
               for p in paths)


def test_init_announces_enabled_cache(cache_dir, monkeypatch, capsys):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.runtime import flight

    if hvd.is_initialized():
        hvd.shutdown()
    monkeypatch.setenv("HOROVOD_LOG_LEVEL", "info")
    monkeypatch.setenv("HOROVOD_AOT_CACHE_MODE", "export")
    hvd.init(device="cpu")
    try:
        ev = [e for e in flight.recorder().snapshot()
              if e["kind"] == "aot" and e.get("event") == "enabled"]
        assert ev and ev[-1]["dir"] == cache_dir
        assert ev[-1]["mode"] == "export"
        assert f"aot-cache: {cache_dir} (mode=export)" \
            in capsys.readouterr().err
    finally:
        hvd.shutdown()
    # off: no announcement
    monkeypatch.setenv("HOROVOD_AOT_CACHE_MODE", "off")
    n = len([e for e in flight.recorder().snapshot() if e["kind"] == "aot"])
    hvd.init(device="cpu")
    try:
        assert n == len([e for e in flight.recorder().snapshot()
                         if e["kind"] == "aot"])
    finally:
        hvd.shutdown()


_WORLD = r"""
import json, os, sys
import horovod_tpu_torch as hvd
from horovod_tpu_torch import _build
from horovod_tpu_torch.runtime import aot_cache, kvstore, wire

hvd.init(device="cpu")
# the three host libraries of a rank: the wire codec (a CPython
# extension), the KV store and the timeline (ctypes)
assert wire.native_loaded()
kvstore._load()
_build.load_host_library("hvdtorchtl", "timeline.cc")
hits = {n: i.get("hit") for n, i in _build.build_info.items()}
print("AOT-STATS-%d %s" % (hvd.rank(), json.dumps(
    dict(aot_cache.stats(), loaded=hits))), flush=True)
hvd.shutdown()
"""


def _world(cache: str, n: int = 2) -> list:
    from horovod_tpu_torch.common.util import reserve_port

    sock, port = reserve_port()
    procs = []
    try:
        for r in range(n):
            env = dict(os.environ)
            env.update({
                "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
                "HOROVOD_PLATFORM": "cpu", "OMP_NUM_THREADS": "1",
                "HOROVOD_RANK": str(r), "HOROVOD_SIZE": str(n),
                "HOROVOD_LOCAL_RANK": str(r), "HOROVOD_LOCAL_SIZE": str(n),
                "HOROVOD_COORDINATOR_ADDR": f"127.0.0.1:{port}",
                "HOROVOD_AOT_CACHE_DIR": cache,
            })
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORLD], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = []
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise AssertionError(f"rank {r} timed out")
            assert p.returncode == 0, f"rank {r} failed:\n{out}"
            outs.append(out)
    finally:
        sock.close()
    stats = []
    for r, out in enumerate(outs):
        m = re.search(rf"AOT-STATS-{r} (.+)", out)
        assert m, out
        stats.append(json.loads(m.group(1)))
    return stats


def test_cold_then_warm_2proc(tmp_path):
    """A gloo world of two, cold then warm over one cache directory: the
    cold world builds each library once across its ranks (the other
    rank takes the lock after the build and counts a hit); the warm
    world misses nothing and spends under half the cold build seconds
    materializing."""
    cache = str(tmp_path / "aot")
    cold = _world(cache)
    names = set(cold[0]["loaded"])
    assert names == {"_hvdtorchwire", "hvdtorchkv", "hvdtorchtl"}
    assert sum(s["misses"] for s in cold) == len(names), cold
    for s in cold:
        assert s["hits"] + s["misses"] == len(names), s
        assert s["evictions"] == 0 and set(s["loaded"]) == names, s
    for n in names:  # built once: by exactly one rank
        assert sorted(s["loaded"][n] for s in cold) == [False, True], n
    entries = [f for f in os.listdir(cache) if f.endswith(".aot")]
    assert len(entries) == len(names)
    warm = _world(cache)
    cold_s = sum(s["compile_s_cold"] for s in cold)
    for w in warm:
        assert w["misses"] == 0 and w["evictions"] == 0, w
        assert w["hits"] == len(names), w
        assert all(w["loaded"].values()), w
        assert cold_s > 2 * (w["compile_s_warm"] + w["compile_s_cold"]), \
            (cold, w)
