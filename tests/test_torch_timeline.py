"""The port's timeline (``runtime/timeline.py``, ``csrc/timeline.cc``)
against the JAX package's.

1. The writers: the port's Python ``Timeline`` writes the JAX package's
   events for one scripted call sequence (negotiation, rank-ready ticks,
   activities, cycle markers, overlap phases), ``ts`` left out; the
   native writer writes the same (row, event, ``ph``, scope) sequence
   (it writes no ``args``) in batches of any size; events after
   ``close`` are dropped; a
   native writer that fails to build raises, naming the compiler's
   error.
2. The runtime: the reference's ``test_timeline_written``,
   ``test_timeline_per_rank_ready_ticks`` (a spawned gloo world of 2,
   rank 1 straggling 2 s) and ``test_timeline_overlap_phase_events`` on
   the port; each submitted tensor's row at world 1 holds its
   ``NEGOTIATE_ALLREDUCE`` B/E, ``RANK0_READY`` and ``XLA_ALLREDUCE``
   B/E, and ``CYCLE_START`` marks under ``HOROVOD_TIMELINE_MARK_CYCLES``;
   the overlap schedule's ticks are the JAX package's, the reduce-scatter's
   leading-dimension padding included; a trace still open when a
   coordinated abort came is valid JSON before the handle fails; an
   elastic teardown closes the trace; with no knob set the runtime opens
   no timeline and owns no tuner.
3. The knobs: ``HOROVOD_TIMELINE_JAX_PROFILER`` is noted once at
   ``init()`` and ignored; the launcher's ``--timeline-filename``,
   ``--timeline-mark-cycles`` and ``--autotune*`` flags export the knobs;
   the new modules import neither JAX nor the JAX package.
"""

import ast
import json
import os
import sys
import threading
import time
import types

import pytest
import torch

from horovod_tpu.runtime import background as jbg
from horovod_tpu.runtime.timeline import Timeline as JTimeline

import horovod_tpu_torch as hvd
from horovod_tpu_torch import _build
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common.types import HorovodTpuError, RanksDownError
from horovod_tpu_torch.ops import eager as E
from horovod_tpu_torch.runtime import background as tbg
from horovod_tpu_torch.runtime import timeline as TL

from _torch_collectives_worker import spawn  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(tl) -> None:
    """One call of every record method, interleaved over three rows."""
    tl.mark_cycle()
    tl.negotiate_start("grad.a", "allreduce")
    tl.negotiate_start("grad.b", "allreduce")
    tl.negotiate_rank_ready("grad.a", 0)
    tl.negotiate_start("w.g", "allgather")
    tl.negotiate_rank_ready("grad.a", 1)
    tl.negotiate_rank_ready("grad.b", 1)
    tl.mark_cycle()
    tl.negotiate_rank_ready("grad.b", 0)
    tl.negotiate_end("grad.a", "allreduce")
    tl.negotiate_end("grad.b", "allreduce")
    tl.activity_start("grad.a", "XLA_ALLREDUCE")
    tl.activity_start("grad.b", "XLA_ALLREDUCE")
    for b in range(2):
        for phase in ("rs", "compute", "ag"):
            tl.overlap_phase("grad.a", b, phase, elems=96 + b)
    tl.activity_end("grad.a", "XLA_ALLREDUCE")
    tl.activity_end("grad.b", "XLA_ALLREDUCE")
    tl.negotiate_rank_ready("w.g", 0)
    tl.negotiate_end("w.g", "allgather")
    tl.close()


def _load(path):
    with open(path) as f:
        return json.load(f)


def _rows(events):
    """``(row name or None, event name, ph, scope)`` per event."""
    names = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    return [(names.get(e["tid"]), e["name"], e["ph"], e.get("s"))
            for e in events if e["ph"] != "M"]


# ---------------------------------------------------------------------------
# 1. The writers
# ---------------------------------------------------------------------------


def test_python_timeline_matches_reference(tmp_path):
    _script(TL.Timeline(str(tmp_path / "port.json")))
    _script(JTimeline(str(tmp_path / "jax.json")))
    port, jax = _load(tmp_path / "port.json"), _load(tmp_path / "jax.json")
    strip = [[{k: v for k, v in e.items() if k != "ts"} for e in ev]
             for ev in (port, jax)]
    assert strip[0] == strip[1]
    assert len(port) == 28  # 5 row metadata events and 23 records


@pytest.mark.parametrize("flush_at", [TL.NativeTimeline.FLUSH_AT, 1, 5])
def test_native_timeline_matches_python(tmp_path, monkeypatch, flush_at):
    """The same records in the same order, whatever batches the pending
    events reach the native writer in."""
    monkeypatch.setattr(TL.NativeTimeline, "FLUSH_AT", flush_at)
    _script(TL.make_timeline(str(tmp_path / "native.json")))
    _script(TL.Timeline(str(tmp_path / "python.json")))
    native = _load(tmp_path / "native.json")
    python = _load(tmp_path / "python.json")
    # the metadata rows: the same tids in the same order
    assert [e for e in native if e["ph"] == "M"] == \
        [e for e in python if e["ph"] == "M"]
    assert _rows(native) == _rows(python)
    # the native writer writes no args (overlap_phase drops elems)
    assert all("args" not in e for e in native if e["ph"] != "M")
    ts = [e["ts"] for e in native if e["ph"] != "M"]
    assert ts == sorted(ts)


@pytest.mark.parametrize("writer", ["native", "python"])
def test_events_after_close_are_dropped(tmp_path, writer):
    path = str(tmp_path / "tl.json")
    tl = TL.make_timeline(path) if writer == "native" else TL.Timeline(path)
    tl.negotiate_start("x", "allreduce")
    tl.close()
    tl.negotiate_end("x", "allreduce")   # after close: no record, no crash
    tl.mark_cycle()
    tl.close()                           # idempotent
    assert [e["name"] for e in _load(path)] == ["thread_name",
                                                "NEGOTIATE_ALLREDUCE"]


def test_native_writer_concurrent_close(tmp_path):
    """Framework threads record while the background thread closes (the
    close frees the native writer): every event lands before the footer
    or not at all, and the trace stays valid JSON."""
    path = str(tmp_path / "tl.json")
    tl = TL.make_timeline(path)
    stop = threading.Event()
    sent = [0] * 8

    def spam(k):
        while not stop.is_set():
            tl.negotiate_start(f"t{sent[k] % 7}", "allreduce")
            sent[k] += 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=spam, args=(k,))
              for k in range(len(sent))]
        for t in ts:
            t.start()
        while sum(sent) < 2000:
            time.sleep(0.001)
        tl.close()
        stop.set()
        for t in ts:
            t.join(10)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    events = _load(path)
    records = [e for e in events if e["ph"] != "M"]
    assert {e["name"] for e in records} == {"NEGOTIATE_ALLREDUCE"}
    assert 0 < len(records) <= sum(sent)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No fallback to the Python writer: a source that does not compile
    raises, and the message carries the compiler's error."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "timeline.cc").write_text(
        '#include <cstdio>\nextern "C" void* hvd_tl_open(const char* p) '
        '{ return undeclared_symbol_here(p); }\n')
    monkeypatch.setattr(_build, "CSRC", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(HorovodTpuError) as ei:
        TL.make_timeline(str(tmp_path / "tl.json"))
    msg = str(ei.value)
    assert "g++ failed building hvdtorchtl" in msg
    assert "undeclared_symbol_here" in msg


# ---------------------------------------------------------------------------
# 2. The runtime
# ---------------------------------------------------------------------------


@pytest.fixture()
def fresh():
    if hvd.is_initialized():
        hvd.shutdown()
    yield
    if hvd.is_initialized():
        hvd.shutdown()


def test_timeline_written(tmp_path, monkeypatch, fresh):
    """``tests/test_eager_single.py::test_timeline_written`` on the
    port."""
    monkeypatch.setenv("HOROVOD_TIMELINE", str(tmp_path / "timeline.json"))
    hvd.init(device="cpu")
    try:
        hvd.allreduce(torch.ones(4), name="tl_tensor")
    finally:
        hvd.shutdown()
    data = _load(tmp_path / "timeline.json")
    names = {e.get("name") for e in data}
    assert "NEGOTIATE_ALLREDUCE" in names
    assert "XLA_ALLREDUCE" in names
    assert any(e.get("ph") == "M" and
               e.get("args", {}).get("name") == "tl_tensor" for e in data)


def test_timeline_rows_at_world1(tmp_path, monkeypatch, fresh):
    """Every submitted tensor's row: its negotiation's B/E, the
    coordinator's RANK0_READY and the dispatch's XLA_<KIND> B/E, once per
    submission; cycle marks under HOROVOD_TIMELINE_MARK_CYCLES."""
    monkeypatch.setenv("HOROVOD_TIMELINE", str(tmp_path / "tl.json"))
    monkeypatch.setenv("HOROVOD_TIMELINE_MARK_CYCLES", "1")
    hvd.init(device="cpu")
    names = [f"allreduce.layer{i}.weight" for i in range(9)]
    try:
        for _ in range(2):
            hs = [hvd.allreduce_async(torch.full((i + 3,), float(i)), name=n)
                  for i, n in enumerate(names)]
            for i, h in enumerate(hs):
                assert torch.equal(hvd.synchronize(h),
                                   torch.full((i + 3,), float(i)))
        hvd.allgather(torch.ones(2, 3), name="gather.x")
    finally:
        hvd.shutdown()
    rows = {}
    events = _load(tmp_path / "tl.json")
    for row, name, ph, _ in _rows(events):
        rows.setdefault(row, []).append((name, ph))
    for n in names:
        got = sorted(rows[n])
        assert got == sorted(
            [("NEGOTIATE_ALLREDUCE", "B"), ("NEGOTIATE_ALLREDUCE", "E"),
             ("RANK0_READY", "i"), ("XLA_ALLREDUCE", "B"),
             ("XLA_ALLREDUCE", "E")] * 2), (n, got)
    assert sorted(rows["gather.x"]) == sorted(
        [("NEGOTIATE_ALLGATHER", "B"), ("NEGOTIATE_ALLGATHER", "E"),
         ("RANK0_READY", "i"), ("XLA_ALLGATHER", "B"),
         ("XLA_ALLGATHER", "E")])
    assert ("CYCLE_START", "i") in rows[None]


def test_timeline_per_rank_ready_ticks(tmp_path):
    """``tests/test_timeline.py`` on the port: a spawned gloo world of 2,
    rank 1 sleeping 2 s before its allreduce; rank 0's trace carries both
    ranks' ticks on the tensor's row, rank 1's later by more than 1 s."""
    trace = tmp_path / "tl.json"
    outs = spawn(2, "cpu", timeout=120, mode="timeline_ticks",
                 env_extra={"HOROVOD_TIMELINE": str(trace),
                            "HVD_TEST_STRAGGLE": "2"})
    assert all(o["completed"] for o in outs)
    data = _load(trace)
    rows = {e["args"]["name"]: e["tid"] for e in data
            if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert "tickme" in rows, rows
    ticks = {e["name"]: e for e in data
             if e.get("ph") == "i" and e.get("tid") == rows["tickme"]}
    assert "RANK0_READY" in ticks and "RANK1_READY" in ticks, sorted(ticks)
    assert ticks["RANK1_READY"]["ts"] - ticks["RANK0_READY"]["ts"] > 1e6


@pytest.mark.parametrize("writer", ["python", "native"])
def test_timeline_overlap_phase_events(tmp_path, writer):
    """``tests/test_overlap.py::test_timeline_overlap_phase_events`` on
    the port's writers (the native one writes no ``args``)."""
    path = str(tmp_path / "tl.json")
    tl = TL.Timeline(path) if writer == "python" else TL.make_timeline(path)
    for b in range(3):
        for phase in ("rs", "compute", "ag"):
            tl.overlap_phase("grad_buffer.f32", b, phase, elems=128)
    tl.close()
    events = _load(path)
    names = {e["name"] for e in events if e.get("ph") == "i"}
    assert {"overlap/rs", "overlap/compute", "overlap/ag"} <= names
    rows = {e["args"]["name"] for e in events if e.get("ph") == "M"}
    assert "grad_buffer.f32/bucket2" in rows
    if writer == "python":
        buckets = {e["args"]["bucket"] for e in events
                   if e.get("ph") == "i"}
        assert buckets == {0, 1, 2}


class _Recorder:
    def __init__(self):
        self.calls = []

    def overlap_phase(self, *a):
        self.calls.append(a)


@pytest.mark.parametrize("kind,op,shapes", [
    ("allreduce", 1, [(10,), (3, 5)]),
    ("allreduce", 2, [(7,)]),
    ("reducescatter", 2, [(9, 5), (3,)]),
    ("reducescatter", 1, [(2, 2, 3)]),
    ("allreduce", 3, [(16,)]),          # Adasum: no schedule
    ("allgather", 2, [(4, 2)]),
])
@pytest.mark.parametrize("chunks", [1, 4])
def test_overlap_schedule_ticks_match_reference(kind, op, shapes, chunks,
                                                monkeypatch):
    monkeypatch.setenv("HOROVOD_OVERLAP", "1")
    monkeypatch.setenv("HOROVOD_OVERLAP_CHUNKS", str(chunks))
    resp = types.SimpleNamespace(kind=kind, op=op, shapes=shapes)
    entries = [types.SimpleNamespace(name="grad_buffer.float32.2")]
    got = []
    for cls in (tbg.BackgroundRuntime, jbg.BackgroundRuntime):
        rec = _Recorder()
        cls._mark_overlap_schedule(
            types.SimpleNamespace(world=4, timeline=rec), resp, entries)
        got.append(rec.calls)
    assert got[0] == got[1]
    assert bool(got[0]) == (kind != "allgather" and op != 3)


def test_trace_valid_after_coordinated_abort(tmp_path, monkeypatch, fresh):
    """A coordinated abort out of the background loop: the trace is
    closed (valid JSON) by the time the handle fails, before
    ``shutdown()``."""
    path = tmp_path / "tl.json"
    monkeypatch.setenv("HOROVOD_TIMELINE", str(path))
    hvd.init(device="cpu")
    hvd.allreduce(torch.ones(2), name="before")
    rt = E._runtime()
    assert basics.state().timeline is rt.timeline is not None

    def boom(*a, **k):
        raise RanksDownError(
            'RanksDownError: {"ranks": [1], "round": 3, "elapsed": 5.0}'
            " - peer dead")

    monkeypatch.setattr(rt.controller, "negotiate", boom)
    h = hvd.allreduce_async(torch.ones(2), name="doomed")
    with pytest.raises(RanksDownError):
        hvd.synchronize(h)
    data = _load(path)   # closed before the handle failed
    assert [e["name"] for e in data if e.get("ph") == "M"] == \
        ["thread_name", "thread_name"]
    assert ("doomed", "NEGOTIATE_ALLREDUCE", "B", None) in _rows(data)
    assert rt._stopped.wait(10)
    hvd.shutdown()
    assert basics.state().timeline is None


def test_teardown_distributed_closes_timeline(tmp_path, monkeypatch, fresh):
    """An elastic re-form's teardown flushes and drops the generation's
    trace; the next ``init()`` opens a fresh one."""
    path = tmp_path / "tl.json"
    monkeypatch.setenv("HOROVOD_TIMELINE", str(path))
    hvd.init(device="cpu")
    hvd.allreduce(torch.ones(2), name="gen1")
    assert basics.state().timeline is not None
    assert basics.teardown_distributed()
    assert basics.state().timeline is None
    assert ("gen1", "XLA_ALLREDUCE", "E", None) in _rows(_load(path))
    hvd.shutdown()
    hvd.init(device="cpu")
    hvd.allreduce(torch.ones(2), name="gen2")
    hvd.shutdown()
    assert {r for r, *_ in _rows(_load(path))} == {"gen2"}


def test_no_knob_no_timeline_no_tuner(fresh, monkeypatch):
    monkeypatch.delenv("HOROVOD_TIMELINE", raising=False)
    monkeypatch.delenv("HOROVOD_AUTOTUNE", raising=False)
    hvd.init(device="cpu")
    hvd.allreduce(torch.ones(2), name="plain")
    rt = E._runtime()
    assert rt.timeline is None and rt.pm is None
    assert basics.state().timeline is None
    assert rt.controller.coordinator.timeline is None
    hvd.shutdown()


# ---------------------------------------------------------------------------
# 3. The knobs and the modules
# ---------------------------------------------------------------------------


def test_jax_profiler_knob_noted_once(monkeypatch, tmp_path, fresh):
    """``HOROVOD_TIMELINE_JAX_PROFILER`` is ported: no "not ported" note;
    each ``init()`` opens the whole-run ``torch.profiler`` capture (the
    first under ``rank0/``, a re-init over the same directory under
    ``gen<g>/rank0/``) and ``shutdown()`` lands its trace."""
    from horovod_tpu_torch.perf.kineto import is_trace_file

    monkeypatch.setenv("HOROVOD_TIMELINE_JAX_PROFILER", str(tmp_path))
    seen = []
    monkeypatch.setattr(basics._log, "warning",
                        lambda msg, rank=None: seen.append(msg))
    for _ in range(2):
        hvd.init(device="cpu")
        assert basics.state().profiler is not None
        hvd.shutdown()
        assert basics.state().profiler is None
    assert not any("HOROVOD_TIMELINE_JAX_PROFILER" in m for m in seen), seen
    traces = sorted(os.path.relpath(os.path.join(d, f), tmp_path)
                    for d, _, fs in os.walk(tmp_path) for f in fs
                    if is_trace_file(f))
    assert len(traces) == 2 and traces[0].startswith("gen2")
    assert traces[1].startswith("rank0"), traces


def test_launcher_flags_export_the_knobs():
    from horovod_tpu_torch.run import launcher

    args = launcher.build_parser().parse_args([
        "-np", "2", "--timeline-filename", "/tmp/tl.json",
        "--timeline-mark-cycles", "--autotune", "--autotune-log-file",
        "/tmp/at.csv", "--autotune-warmup-samples", "2",
        "--autotune-steps-per-sample", "5",
        "--autotune-bayes-opt-max-samples", "9",
        "--autotune-gaussian-process-noise", "0.3",
        "--compression-max-residual-ratio", "0.25", "python", "x.py"])
    env = _config.set_env_from_args(args, {})
    assert env == {
        "HOROVOD_TIMELINE": "/tmp/tl.json",
        "HOROVOD_TIMELINE_MARK_CYCLES": "1", "HOROVOD_AUTOTUNE": "1",
        "HOROVOD_AUTOTUNE_LOG": "/tmp/at.csv",
        "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "2",
        "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "5",
        "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "9",
        "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE": "0.3",
        "HOROVOD_COMPRESSION_MAX_RESIDUAL_RATIO": "0.25"}


@pytest.mark.parametrize("name,default", [
    ("timeline", ""), ("timeline_mark_cycles", False), ("autotune", False),
    ("autotune_log", ""), ("autotune_warmup_samples", 3),
    ("autotune_steps_per_sample", 10),
    ("autotune_bayes_opt_max_samples", 20),
    ("autotune_gaussian_process_noise", 0.8),
    ("compression_guard_ratio", 0.5)])
def test_knob_registered_as_reference(name, default):
    from horovod_tpu.common import config as jconfig

    k, j = _config.knobs()[name], jconfig.knobs()[name]
    assert (k.env, k.default, k.cli, k.config_key) == \
        (j.env, j.default, j.cli, j.config_key)
    assert k.default == default


@pytest.mark.parametrize("module", [
    "runtime/timeline.py", "runtime/gaussian_process.py",
    "runtime/bayes_opt.py", "runtime/parameter_manager.py",
    "runtime/background.py", "runtime/controller.py", "common/basics.py"])
def test_module_imports_no_jax(module):
    path = os.path.join(REPO, "horovod_tpu_torch", module)
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            root = m.split(".")[0]
            assert root not in ("jax", "jaxlib", "horovod_tpu", "flax",
                                "optax"), (module, m)
