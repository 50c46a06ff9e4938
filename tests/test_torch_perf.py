"""The port's perf observatory (``horovod_tpu_torch/perf/{kineto,
attribution,capture,report,compare}.py``) against the JAX package's
(``horovod_tpu/perf/{xplane,attribution,capture,report,compare}.py``).

1. Shared synthetic event sets, in integer microseconds, each encoded
   twice: as xplane bytes (``tests/test_perf.py``'s golden writer) for
   the JAX package and as a ``torch.profiler`` Chrome trace for the port.
   Both ``attribute()`` return equal dicts (the plane names aside, which
   say TPU on one side and GPU on the other): nested scopes, overlap
   hidden and exposed, MFU, no steps (the synthetic window), windows
   deduplicated across two device planes, the comm-kind patterns.
2. The reader's contract: truncated, garbled and missing files never
   raise and keep what was read; real ``torch.profiler`` traces of this
   machine's torch parse (decimal microseconds, step annotations).
3. The port's own rules: the device window from the step's launches, a
   device event's scope through its launch or the ``gpu_user_annotation``
   spans, host self time on a CPU capture.
4. A real capture over a gloo world of 2 (``tests/_torch_perf_worker.py``
   through the collectives worker's mode ``perf``): the sampled capture
   of ``overlapped_allreduce`` resolves ``hvd_overlap_rs0``/``math0``
   and splits comm from compute.
5. The sampled capture (rotation, gauges, backpressure, yielding to the
   bridge, off by default), the bridge's generation directories and
   teardown, the knobs against the JAX package's, the ``compare`` gate
   against the JAX package's ``compare_result``, the CLI, the import
   discipline, and the goodput ledger's device source feeding the
   autopilot's ``comm_retune`` on an in-trace step.

The cases of ``tests/test_perf.py`` that drive ``bench.py`` wait for the
port's benchmark.
"""

import gzip
import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from horovod_tpu.common import config as jconfig
from horovod_tpu.perf import attribution as JA
from horovod_tpu.perf import compare as JCMP
from horovod_tpu.perf import xplane as JX

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.perf import attribution as A
from horovod_tpu_torch.perf import capture as C
from horovod_tpu_torch.perf import compare as CMP
from horovod_tpu_torch.perf import goodput as GP
from horovod_tpu_torch.perf import kineto as K
from horovod_tpu_torch.perf import report as R
from horovod_tpu_torch.runtime import metrics as M

import test_perf as JT  # noqa: E402  (the xplane golden writer)
from _torch_collectives_worker import spawn  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
US = JT.US


# ---------------------------------------------------------------------------
# One event set, two encodings
# ---------------------------------------------------------------------------


def _xplane(devices: dict, host_steps=(), device_steps=None) -> bytes:
    """``devices``: {index: [(name, start_us, dur_us, scope path or
    None)]}; ``host_steps``: [(step, start_us, end_us)] on the host
    plane; ``device_steps``: {index: [(step, start_us, end_us)]} on the
    device planes' ``Steps`` lines."""
    instrs = b"".join(
        JT.LD(2, JT.S(1, name) + JT.S(2, "op") + JT.LD(
            7, JT.S(2, f"jit(f)/jit(main)/{scope}/op")))
        for evs in devices.values() for name, _, _, scope in evs if scope)
    out = b""
    if instrs:
        out += JT._plane("/host:metadata", JT._event_meta(
            1, "jit_f(1)", JT.LD(1, JT.LD(3, JT.S(1, "main") + instrs))))
    for d, evs in devices.items():
        mids = {n: 10 + i for i, n in enumerate(sorted({e[0] for e in evs}))}
        body = b"".join(JT._event_meta(m, n) for n, m in mids.items())
        body += JT._line("XLA Ops", 0, b"".join(
            JT._event(mids[n], s * US, dur * US) for n, s, dur, _ in evs))
        steps = (device_steps or {}).get(d, ())
        if steps:
            body += JT._stat_meta(3, "step_num") + JT._event_meta(
                90, "hvd_step") + JT._line("Steps", 0, b"".join(
                    JT._event(90, s * US, (e - s) * US,
                              JT.LD(4, JT.V(1, 3) + JT.V(4, num)))
                    for num, s, e in steps))
        out += JT._plane(f"/device:TPU:{d}", body)
    if host_steps:
        out += JT._plane("/host:CPU", JT._event_meta(20, "hvd_step")
                         + JT._stat_meta(3, "step_num") + JT._line(
            "python", 0, b"".join(
                JT._event(20, s * US, (e - s) * US,
                          JT.LD(4, JT.V(1, 3) + JT.V(4, num)))
                for num, s, e in host_steps)))
    return out


def _chrome(devices: dict, host_steps=(), device_steps=None,
            launch_at=None) -> dict:
    """The same events as a ``torch.profiler`` trace: kernels on stream 7
    of their device, each scoped one launched by a ``cudaLaunchKernel``
    nested in one ``user_annotation`` per scope component (at host time
    ``launch_at[name]``, else 1000 + 10 x its index), the steps as
    ``hvd_step#<n>`` spans (host ``user_annotation``, device
    ``gpu_user_annotation``)."""
    evs = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": 1,
            "args": {"name": "python"}}]
    corr = 0
    for d, kernels in devices.items():
        for name, s, dur, scope in kernels:
            corr += 1
            evs.append({"ph": "X", "cat": "kernel", "name": name, "pid": d,
                        "tid": 7, "ts": s, "dur": dur,
                        "args": {"device": d, "stream": 7,
                                 "correlation": corr}})
            if scope is None and launch_at is None:
                continue
            at = (launch_at or {}).get(name, 1000 + 10 * corr)
            parts = scope.split("/") if scope else []
            for depth, part in enumerate(parts):
                pad = len(parts) - depth
                evs.append({"ph": "X", "cat": "user_annotation",
                            "name": part, "pid": 1, "tid": 1,
                            "ts": at - pad, "dur": 1 + 2 * pad})
            evs.append({"ph": "X", "cat": "cuda_runtime",
                        "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
                        "ts": at, "dur": 1, "args": {"correlation": corr}})
    for num, s, e in host_steps:
        evs.append({"ph": "X", "cat": "user_annotation",
                    "name": f"hvd_step#{num}", "pid": 1, "tid": 1,
                    "ts": s, "dur": e - s})
    for d, steps in (device_steps or {}).items():
        for num, s, e in steps:
            evs.append({"ph": "X", "cat": "gpu_user_annotation",
                        "name": f"hvd_step#{num}", "pid": d, "tid": 7,
                        "ts": s, "dur": e - s,
                        "args": {"device": d, "stream": 7}})
    return {"schemaVersion": 1, "traceEvents": evs}


def _both(devices, host_steps=(), device_steps=None, **kw):
    """``(JAX package's result, port's result)``: the JAX package reads
    the step from the host plane, the port from the card's annotation of
    the same span."""
    ref = JA.attribute(JX.parse_xspace(
        _xplane(devices, host_steps, device_steps)), **kw)
    dev = device_steps or ({0: list(host_steps)} if host_steps else None)
    got = A.attribute(K.parse_trace(json.dumps(_chrome(devices, (), dev))),
                      **kw)
    return ref, got


def _same(ref: dict, got: dict) -> None:
    """Equal results; the plane lists agree on the devices' indices."""
    def devices(planes):
        return [p.rsplit(":", 1)[1] for p in planes
                if p.startswith("/device:")]

    ref, got = dict(ref), dict(got)
    assert devices(ref.pop("planes")) == devices(got.pop("planes"))
    assert got == ref


#: the reference's device fixture (tests/test_perf.py:89-119): comm
#: 0-100 us under hvd_overlap_ag1, compute 50-150 us under
#: hvd_overlap_math1/nested, step 7 over 0-200 us
OVERLAP = {0: [("all-gather.3", 0, 100, "hvd_overlap_ag1"),
               ("fusion.1", 50, 100, "hvd_overlap_math1/nested")]}

CASES = {
    "nested scopes, overlap hidden and exposed": (OVERLAP, [(7, 0, 200)],
                                                  None, {}),
    "mfu": (OVERLAP, [(7, 0, 200)], None,
            {"flops_per_step": 1e9, "peak_flops": 1e13}),
    "no steps": ({0: [("all-reduce.1", 0, 10, None)]}, (), None, {}),
    "windows across two device planes": (
        {0: [("fusion.9", 0, 100, None)], 1: [("fusion.9", 0, 100, None)]},
        (), {0: [(3, 0, 150)], 1: [(3, 0, 160)]}, {}),
    "every comm kind, hidden and exposed, two steps": (
        {0: [("all-reduce.2", 0, 40, None),
             ("reduce-scatter.1", 30, 30, "hvd_zero2_rs0"),
             ("fusion.4", 20, 50, "hvd_overlap_math0"),
             ("collective-permute.7", 90, 20, None),
             ("all-to-all.3", 120, 10, None),
             ("copy.5", 140, 20, "hvd_zero3_ag1"),
             ("fusion.6", 210, 40, None),
             ("all-gather.8", 240, 30, "hvd_overlap_ag2")]},
        [(1, 0, 200), (2, 200, 300)], None,
        {"wire_bytes": 4e6, "flops_per_step": 2e8, "peak_flops": 1e13}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_attribute_matches_the_jax_package(case):
    devices, host_steps, device_steps, kw = CASES[case]
    ref, got = _both(devices, host_steps, device_steps, **kw)
    assert ref["steps"], ref
    _same(ref, got)


def test_reference_fixture_itself():
    """The reference's own bytes (``tests/test_perf.py:_device_fixture``)
    against the port's encoding of :data:`OVERLAP`."""
    ref = JA.attribute(JX.parse_xspace(JT._device_fixture()))
    got = A.attribute(K.parse_trace(json.dumps(
        _chrome(OVERLAP, (), {0: [(7, 0, 200)]}))))
    _same(ref, got)
    (step,) = got["steps"]
    assert step["comm_hidden_s"] == pytest.approx(50e-6)
    assert step["scopes"]["hvd_overlap_ag1"] == pytest.approx(100e-6)


COMM_NAMES = [
    "all-reduce.5", "fusion.2", "reduce-scatter.1", "all-to-all.9",
    "reduce-window.1", "jit(f)/ppermute", "psum-scatter.3", "copy.1",
    "all-gather-start", "collective-permute-done", "conv.4",
]
TORCH_NAMES = {
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)":
        "all-reduce",
    "ncclKernel_AllReduce_RING_LL_Sum_float(ncclWorkElem)": "all-reduce",
    "ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL": "reduce-scatter",
    "ncclDevKernel_AllGather_RING_LL": "all-gather",
    "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)":
        "collective-permute",
    "c10d::allreduce_": "all-reduce",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::_allgather_base_": "all-gather",
    "c10d::alltoall_base_": "all-to-all",
    "gloo:all_reduce": "all-reduce",
    "gloo:all_gather": "all-gather",
    "record_param_comms[allreduce]": "all-reduce",
    "record_param_comms[_reduce_scatter_base]": "reduce-scatter",
    "record_param_comms[all_gather_into_tensor]": "all-gather",
    "aten::convolution": None, "void multi_kernel<Momentum>(Table)": None,
    "void finalize<false>(float const*)": None,
    "sm90_xmma_gemm_bf16bf16_bf16f32": None,
}


@pytest.mark.parametrize("name", COMM_NAMES)
def test_comm_kind_patterns_match_the_jax_package(name):
    assert A._comm_kind(name) == JA._comm_kind(name)
    assert A._comm_kind("fusion.1", name) == JA._comm_kind("fusion.1", name)


@pytest.mark.parametrize("name", sorted(TORCH_NAMES))
def test_comm_kind_of_torch_names(name):
    assert A._comm_kind(name) == TORCH_NAMES[name]


def test_scopes_of_paths():
    assert A._scope_of("hvd_overlap_rs0/c10d::x/cudaLaunchKernel") == \
        JA._scope_of("jit(f)/hvd_overlap_rs0/x") == "hvd_overlap_rs0"
    # the step annotation is no scope; an hvd_* name of the eager plane is
    assert A._scope_of("hvd_step/aten::mm") is None
    assert A._scope_of("hvd_allreduce/aten::copy_") == "hvd_allreduce"
    # a scope's name never makes an op a collective
    assert A._comm_kind("aten::copy_",
                        A._unscoped("hvd_allreduce/aten::copy_")) is None


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H100 NVL", 835e12), ("NVIDIA H200", 989e12),
    ("NVIDIA A100-SXM4-80GB", 312e12), ("NVIDIA L40S", 362e12),
    ("NVIDIA L4", 121e12), ("cpu", None), ("", None)])
def test_peak_flops_table(monkeypatch, name, peak):
    monkeypatch.delenv("HOROVOD_PEAK_FLOPS_PER_CHIP", raising=False)
    assert A.peak_flops_per_chip(name) == peak
    monkeypatch.setenv("HOROVOD_PEAK_FLOPS_PER_CHIP", "123.0")
    assert A.peak_flops_per_chip(name) == 123.0 == \
        JA.peak_flops_per_chip("cpu")


# ---------------------------------------------------------------------------
# The reader's contract
# ---------------------------------------------------------------------------


def _fixture_text() -> str:
    return json.dumps(_chrome(OVERLAP, [(7, 0, 200)], {0: [(7, 0, 200)]}))


def test_reader_shapes_and_integer_times():
    space = K.parse_trace(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "pid": 0, "tid": 7,
         "ts": 1491340359311.872, "dur": 2.5,
         "args": {"device": 0, "stream": 7, "correlation": 3}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 9,
         "tid": 9, "ts": 1491340359311, "dur": 1},
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#12",
         "pid": 9, "tid": 9, "ts": 1491340359310, "dur": 9}]}))
    assert not space.truncated
    assert [p.name for p in space.planes] == ["/host:CPU", "/device:GPU:0"]
    (stream,) = space.plane("/device:GPU:0").lines
    assert stream.name == "Stream #7"
    (k,) = stream.events
    # the decimal text, not a float: exact picoseconds
    assert k.start_ps == 1491340359311_872000 and k.duration_ps == 2_500_000
    assert k.stats["correlation"] == 3
    host = space.plane("/host:CPU").lines[0].events
    step = [e for e in host if e.name == "ProfilerStep"]
    assert step and step[0].stats["step_num"] == 12
    mm = [e for e in host if e.name == "aten::mm"][0]
    assert mm.stats["path"] == "aten::mm"  # the step is not a scope


def test_truncated_input_never_raises_and_keeps_partial():
    text = _fixture_text()
    full = A.attribute(K.parse_trace(text))
    assert full["op_events"] == 2 and not K.parse_trace(text).truncated
    for cut in range(len(text)):
        space = K.parse_trace(text[:cut])
        assert isinstance(A.attribute(space), dict)
        if 0 < cut < len(text) - 2:
            assert space.truncated, cut
    # a cut after the first kernel keeps it
    first_end = text.index("}}", text.index('"kernel"')) + 2
    space = K.parse_trace(text[:first_end + 3])
    assert space.truncated
    (dev,) = [p for p in space.planes if p.name.startswith("/device:")]
    assert [e.name for ln in dev.lines for e in ln.events] == ["all-gather.3"]


def test_gzip_and_truncated_gzip(tmp_path):
    data = gzip.compress(_fixture_text().encode())
    path = tmp_path / "h_1.1.pt.trace.json.gz"
    path.write_bytes(data)
    assert A.attribute(K.read_trace(str(path)))["op_events"] == 2
    for cut in (10, len(data) // 2, len(data) - 5):
        space = K.parse_trace(data[:cut])
        assert space.truncated and isinstance(A.attribute(space), dict)


def test_garbage_and_missing_files(tmp_path):
    for blob in (b"", b"\xff" * 64, b"\x00" * 64, os.urandom(256),
                 b"[1, 2, {", b'{"traceEvents": 7}', b"\x1f\x8b junk",
                 b'{"traceEvents": [{"ph": "X", "ts": "x", "dur": true}]}'):
        space = K.parse_trace(blob)
        assert isinstance(space, K.XSpace)
        assert isinstance(A.attribute(space), dict)
    assert K.parse_trace(b"\xff" * 64).truncated
    space = K.read_trace(str(tmp_path / "nope.pt.trace.json"))
    assert space.truncated and space.errors


def test_real_cpu_trace_parses(tmp_path):
    """A trace this machine's ``torch.profiler`` wrote: the step span and
    the framework scope resolve, and the host self time adds up."""
    from horovod_tpu_torch.common.util import profiler_scope

    x = torch.ones(96, 96)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for s in range(2):
            with M.trace_step(step=s):
                with profiler_scope("hvd_overlap_math0"):
                    y = x @ x
                y.sum()
    path = str(tmp_path / "t.pt.trace.json")
    prof.export_chrome_trace(path)
    res = A.attribute(K.read_trace(path))
    assert [s["step"] for s in res["steps"]] == [0, 1]
    for s in res["steps"]:
        assert "hvd_overlap_math0" in s["scopes"]
        assert 0 < s["compute_s"] <= s["wall_s"] and s["comm_s"] == 0


def test_profiler_scope_is_free_when_nothing_records():
    from horovod_tpu_torch.common.util import profiler_scope

    import contextlib

    assert isinstance(profiler_scope("hvd_x"), contextlib.nullcontext)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert not isinstance(profiler_scope("hvd_x"),
                              contextlib.nullcontext)


# ---------------------------------------------------------------------------
# The port's own rules
# ---------------------------------------------------------------------------


def test_device_window_from_the_steps_launches():
    """Without the card's annotation, step 5's window runs from the first
    to the last kernel its host span launched (launches at 10 and 20 us
    inside the host span 0-50; the kernels run at 60-160 and 170-190)."""
    devices = {0: [("fusion.1", 60, 100, "hvd_overlap_math0"),
                   ("ncclDevKernel_AllReduce_Sum", 170, 20, None),
                   ("late.2", 400, 10, None)]}
    trace = _chrome(devices, [(5, 0, 50)], None,
                    launch_at={"fusion.1": 10,
                               "ncclDevKernel_AllReduce_Sum": 20,
                               "late.2": 300})
    res = A.attribute(K.parse_trace(json.dumps(trace)))
    (step,) = res["steps"]
    assert step["step"] == 5
    assert step["wall_s"] == pytest.approx(130e-6)
    assert step["comm_by_kind"] == {"all-reduce": pytest.approx(20e-6)}
    assert step["comm_exposed_s"] == pytest.approx(20e-6)
    assert step["scopes"] == {"hvd_overlap_math0": pytest.approx(100e-6)}


def test_scope_through_gpu_user_annotation():
    """A kernel whose launch the capture lacks takes the scope of the
    ``gpu_user_annotation`` spans around it on its stream."""
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_ReduceScatter",
         "pid": 0, "tid": 7, "ts": 10, "dur": 5,
         "args": {"device": 0, "stream": 7, "correlation": 4}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "hvd_zero2_rs1",
         "pid": 0, "tid": 7, "ts": 9, "dur": 7,
         "args": {"device": 0, "stream": 7}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "hvd_zero2_rs9",
         "pid": 0, "tid": 8, "ts": 9, "dur": 7,
         "args": {"device": 0, "stream": 8}}]}
    space = K.parse_trace(json.dumps(trace))
    assert K.scope_map(space) == {4: "hvd_zero2_rs1"}
    (step,) = A.attribute(space)["steps"]
    assert step["step"] == -1
    assert step["scopes"] == {"hvd_zero2_rs1": pytest.approx(5e-6)}
    assert step["comm_by_kind"] == {"reduce-scatter": pytest.approx(5e-6)}


def test_cpu_capture_counts_host_self_time():
    """On a capture without device events, an op counts where no op
    nested in it runs: a gloo worker's collective under the math of the
    main thread is hidden, and a parent (``c10d`` op, annotation) never
    covers its children's time twice."""
    def ev(cat, name, tid, s, d):
        return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
                "ts": s, "dur": d}

    trace = {"traceEvents": [
        ev("user_annotation", "hvd_step#3", 1, 0, 100),
        ev("user_annotation", "hvd_overlap_rs0", 1, 0, 20),
        ev("cpu_op", "c10d::_reduce_scatter_base_", 1, 1, 18),
        ev("cpu_op", "aten::copy_", 1, 5, 10),
        ev("cpu_op", "aten::matmul", 1, 30, 50),
        ev("cpu_op", "aten::mm", 1, 32, 40),
        ev("user_annotation", "gloo:all_reduce", 2, 40, 30)]}
    (step,) = A.attribute(K.parse_trace(json.dumps(trace)))["steps"]
    assert step["step"] == 3 and step["wall_s"] == pytest.approx(100e-6)
    # comm: the c10d op and its copy 1-19, gloo 40-70; compute 30-80
    assert step["comm_s"] == pytest.approx(48e-6)
    assert step["compute_s"] == pytest.approx(50e-6)
    assert step["comm_hidden_s"] == pytest.approx(30e-6)
    assert step["comm_by_kind"] == {"all-reduce": pytest.approx(30e-6),
                                    "reduce-scatter": pytest.approx(18e-6)}
    assert step["scopes"] == {"hvd_overlap_rs0": pytest.approx(18e-6)}


# ---------------------------------------------------------------------------
# A real capture over gloo
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gloo_pair(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("perf_pair"))
    return root, spawn(2, mode="perf", timeout=240,
                       env_extra={"HOROVOD_PROFILE_DIR": root})


def test_gloo_pair_capture_splits_comm_from_compute(gloo_pair):
    root, outs = gloo_pair
    for o in outs:
        la = o["analysis"]
        assert la["captured_step"] == 2
        (step,) = la["steps"]
        assert {"hvd_overlap_rs0", "hvd_overlap_math0"} <= set(step["scopes"])
        tot = la["totals"]
        assert tot["comm_s"] > 0 and tot["compute_s"] > 0
        assert tot["comm_hidden_s"] + tot["comm_exposed_s"] == \
            pytest.approx(tot["comm_s"], abs=2e-6)
        assert {"reduce-scatter", "all-gather"} <= set(step["comm_by_kind"])


def test_gloo_pair_report(gloo_pair, capsys):
    from horovod_tpu_torch.perf.__main__ import main

    root, outs = gloo_pair
    rep = R.analyze_dir(root)
    # every rank keeps HOROVOD_PROFILE_KEEP (4) of its two captures
    assert sorted(c["rank"] for c in rep["captures"]) == [0, 0, 1, 1]
    assert main(["report", root]) == 0
    text = capsys.readouterr().out
    assert "rank 1" in text and "scopes: hvd_overlap_" in text


# ---------------------------------------------------------------------------
# The sampled capture
# ---------------------------------------------------------------------------


@pytest.fixture()
def fresh_capture():
    C.reset()
    GP.reset()
    yield
    C.reset()
    GP.reset()


def test_sampled_capture_rotation_and_gauges(tmp_path, monkeypatch,
                                             fresh_capture):
    monkeypatch.setenv("HOROVOD_PROFILE_EVERY_N_STEPS", "2")
    monkeypatch.setenv("HOROVOD_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("HOROVOD_PROFILE_KEEP", "1")
    monkeypatch.setenv("HOROVOD_PEAK_FLOPS_PER_CHIP", "1e9")
    C.set_step_flops(2 * 128 ** 3)
    x = torch.ones(128, 128)
    captures0 = M.counter("hvd_profile_captures_total").total()
    for step in range(6):
        with M.trace_step(step=step):
            x @ x
        C.drain(60)
    # every_n=2 skips span 0 -> captures at steps 2 and 4; keep=1
    # rotates step2 away
    kept = sorted(os.listdir(tmp_path / "rank0"))
    assert kept == ["step00000004"], kept
    last = json.load(open(tmp_path / "rank0" / "step00000004"
                          / "analysis.json"))
    assert last["captured_step"] == 4 and last["totals"]["steps"] == 1
    assert last == C.last_analysis()
    wall = last["steps"][0]["wall_s"]
    assert last["totals"]["mfu"] > 0
    assert last["totals"]["mfu"] == pytest.approx(
        2 * 128 ** 3 / (1e9 * wall), rel=1e-2)  # wall_s is rounded
    snap = M.metrics()["metrics"]
    for g in ("hvd_device_compute_seconds", "hvd_device_comm_seconds",
              "hvd_device_comm_hidden_seconds",
              "hvd_device_comm_exposed_seconds", "hvd_mfu",
              "hvd_profile_last_step"):
        assert g in snap, sorted(k for k in snap if "device" in k)
    assert snap["hvd_profile_last_step"]["series"][0]["value"] == 4
    assert snap["hvd_device_comm_seconds"]["series"][0]["value"] == 0
    assert M.counter("hvd_profile_captures_total").total() - captures0 == 2
    rep = R.analyze_dir(str(tmp_path))
    assert rep["captures"][0]["captured_step"] == 4


def test_comm_kind_gauge_is_replaced_whole(fresh_capture):
    C._publish({"totals": {}, "steps": [
        {"comm_by_kind": {"all-reduce": 0.2, "all-gather": 0.1}}]})
    C._publish({"totals": {}, "steps": [{"comm_by_kind": {"all-gather":
                                                          0.3}}]})
    series = M.metrics()["metrics"]["hvd_device_comm_kind_seconds"]
    assert [(s["labels"], s["value"]) for s in series["series"]] == \
        [({"kind": "all-gather"}, 0.3)]


def test_sampled_capture_backpressure(tmp_path, monkeypatch, fresh_capture):
    monkeypatch.setenv("HOROVOD_PROFILE_EVERY_N_STEPS", "1")
    monkeypatch.setenv("HOROVOD_PROFILE_DIR", str(tmp_path))
    gate = threading.Event()
    slow = threading.Thread(target=gate.wait, daemon=True)
    slow.start()
    try:
        with C._lock:
            C._state["count"] = 1
            C._state["threads"] = [slow]
        skips0 = M.counter("hvd_profile_skips_total").total()
        assert C.maybe_start(1) is None
        assert M.counter("hvd_profile_skips_total").total() == skips0 + 1
        gate.set()
        slow.join(10)
        tok = C.maybe_start(2)
        assert tok is not None
        C.stop_and_analyze(tok)
        C.drain(60)
        assert os.path.isdir(tmp_path / "rank0" / "step00000002")
        assert C.last_analysis()["captured_step"] == 2
    finally:
        gate.set()


def test_sampled_capture_yields_to_bridge(tmp_path, monkeypatch,
                                          fresh_capture):
    class FakeBridge:
        _active = True

    monkeypatch.setenv("HOROVOD_PROFILE_EVERY_N_STEPS", "1")
    monkeypatch.setenv("HOROVOD_PROFILE_DIR", str(tmp_path))
    monkeypatch.setattr(basics.state(), "profiler", FakeBridge())
    for _ in range(3):
        assert C.maybe_start(None) is None
    assert not (tmp_path / "rank0").exists()


def test_capture_off_by_default(monkeypatch, fresh_capture):
    monkeypatch.delenv("HOROVOD_PROFILE_EVERY_N_STEPS", raising=False)
    assert C.maybe_start(0) is None
    assert C._state["count"] == 0
    with M.trace_step(step=1):
        pass
    assert C._state["count"] == 0 and C.last_analysis() is None


def test_failed_capture_is_counted_not_raised(tmp_path, monkeypatch,
                                              fresh_capture):
    monkeypatch.setenv("HOROVOD_PROFILE_EVERY_N_STEPS", "1")
    monkeypatch.setenv("HOROVOD_PROFILE_DIR", str(tmp_path))
    fails0 = M.counter("hvd_profile_capture_failures_total").total()
    monkeypatch.setattr(C, "_open_profiler", lambda: 1 / 0)
    with M.trace_step(step=0):
        pass
    with M.trace_step(step=1):
        pass
    assert M.counter("hvd_profile_capture_failures_total").total() == \
        fails0 + 1


# ---------------------------------------------------------------------------
# The goodput ledger's device source and the autopilot
# ---------------------------------------------------------------------------


def test_comm_retune_fires_on_an_in_trace_step(monkeypatch, fresh_capture):
    """An in-trace step's collectives block nothing on the host, so the
    ledger booked them as compute and ``comm_retune`` could not fire.
    With a capture's analysis landed (injected here), the ledger books
    the device's exposed comm, the tuner's signal reads the gauge, and
    the rule fires."""
    import time

    from horovod_tpu_torch.runtime import autopilot as AP
    from horovod_tpu_torch.runtime import parameter_manager as PM

    monkeypatch.setenv("HOROVOD_OVERLAP_CHUNKS", "4")
    monkeypatch.delenv("HOROVOD_LOCAL_SGD_H", raising=False)

    def steps():
        for i in range(3):
            with M.trace_step(step=i):
                time.sleep(0.02)
        phases = GP.ledger().snapshot()["phases"]
        act = AP.Autopilot(trip_ticks=1, cooldown_s=0.0,
                           record=False).observe_comm(
            phases.get("comm_exposed", 0.0), phases.get("compute", 0.0),
            now=0.0)
        return act.to_dict() if act is not None else None

    monkeypatch.delenv("HOROVOD_PROFILE_EVERY_N_STEPS", raising=False)
    assert steps() is None
    GP.reset()
    monkeypatch.setenv("HOROVOD_PROFILE_EVERY_N_STEPS", "1000")
    la = {"totals": {"comm_exposed_s_per_step": 0.015,
                     "comm_s_per_step": 0.02, "compute_s_per_step": 0.005},
          "steps": [{"comm_by_kind": {"all-reduce": 0.02}}],
          "captured_step": 0}
    with C._lock:
        C._state["last"] = la
    C._publish(la)
    act = steps()
    assert act is not None and act["rule"] == "comm_retune"
    assert act["evidence"]["proposal"] == {"overlap_chunks": 8}
    assert GP.ledger().snapshot()["exposed_source"] == {
        "device": 3, "trace_step": 0}
    assert PM._default_comm_signal() == 0.015


# ---------------------------------------------------------------------------
# The bridge
# ---------------------------------------------------------------------------


def _traces(d) -> list:
    return [p for p in d.rglob("*") if K.is_trace_file(p.name)]


def test_bridge_generation_dirs(tmp_path):
    from horovod_tpu_torch.runtime.timeline import TorchProfilerBridge

    for gen in (1, 2):
        b = TorchProfilerBridge(str(tmp_path), 0, generation=gen)
        with b.annotate("hvd_allreduce"):
            torch.ones(4).sum()
        b.close()
        b.close()  # idempotent
    assert _traces(tmp_path / "rank0") and _traces(tmp_path / "gen2" / "rank0")
    res = A.attribute(K.read_trace(str(_traces(tmp_path / "rank0")[0])))
    assert "hvd_allreduce" in res["steps"][0]["scopes"]


def test_teardown_closes_profiler_bridge(tmp_path, monkeypatch):
    """``init()`` opens the bridge; ``teardown_distributed`` closes it so
    the generation's trace lands and a re-init over the same dir opens
    the next under ``gen2/``; ``shutdown`` closes that one."""
    monkeypatch.setenv("HOROVOD_TIMELINE_JAX_PROFILER", str(tmp_path))
    st = basics.state()
    hvd.init(device="cpu")
    try:
        assert st.profiler is not None and st.profiler._active
        assert C._bridge_active()  # the sampler yields to it
        torch.ones(4).sum()
        basics.teardown_distributed()
        assert st.profiler is None
        assert _traces(tmp_path / "rank0")
        st.initialized = False
        hvd.init(device="cpu")
        assert st.profiler is not None
        assert "gen2" in st.profiler._dir
    finally:
        hvd.shutdown()
    assert st.profiler is None
    assert _traces(tmp_path / "gen2" / "rank0")


# ---------------------------------------------------------------------------
# Knobs, the gate, the CLI, the imports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["jax_profiler", "profile_every_n",
                                  "profile_dir", "profile_keep",
                                  "peak_flops"])
def test_knobs_match_the_jax_package(name):
    mine, ref = _config._KNOBS[name], jconfig._KNOBS[name]
    assert (mine.env, mine.default, mine.cli, mine.config_key) == \
        (ref.env, ref.default, ref.cli, ref.config_key)
    for raw in ("1", "0", "2.5", "/tmp/x"):
        try:
            want = ref.parse(raw)
        except ValueError:
            with pytest.raises(ValueError):
                mine.parse(raw)
        else:
            assert mine.parse(raw) == want


def _result(value=100.0, **extra):
    base = {"resnet50_final_loss": 6.9,
            "resnet50_param_bytes_per_chip": 1000,
            "goodput_ratio": 0.9, "wire_compression_ratio": 0.27,
            "device_comm_exposed_s_per_step": 0.01,
            "metrics_summary": {"step_time_mean_s": 0.5}}
    base.update(extra)
    return {"metric": "m", "value": value, "extra": base}


GATE_CASES = {
    "rerun": ([_result(100.0), _result(104.0)], _result(100.0), {}),
    "throughput collapse": ([_result(100.0), _result(104.0)],
                            _result(10.0), {}),
    "exact moved": ([_result(100.0)],
                    _result(100.0, resnet50_param_bytes_per_chip=1001), {}),
    "slower": ([_result(100.0)],
               _result(100.0, metrics_summary={"step_time_mean_s": 9.0}),
               {}),
    "goodput drop": ([_result(100.0)], _result(100.0, goodput_ratio=0.6),
                     {}),
    "missing metric": ([_result(100.0)],
                       {"metric": "m", "value": 100.0, "extra": {}}, {}),
    "inject": ([_result(100.0)], _result(100.0), {"value": 0.1}),
    "sigma": ([_result(100.0), _result(140.0), _result(60.0)],
              _result(1.0), {}),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_compare_matches_the_jax_package(case):
    runs, cur, inject = GATE_CASES[case]
    base = CMP.build_baseline(runs, note=case)
    assert base == JCMP.build_baseline(runs, note=case)
    got = CMP.compare_result(cur, base, inject=inject)
    assert got == JCMP.compare_result(cur, base, inject=inject)
    assert CMP.format_compare(got, "b.json") == \
        JCMP.format_compare(got, "b.json")
    assert got["ok"] == (case == "rerun")


def test_parse_inject_tolerates_garbage():
    spec = "value=0.5, x = 2,junk,=,k=notnum"
    assert CMP.parse_inject(spec) == JCMP.parse_inject(spec) == {
        "value": 0.5, "x": 2.0}


def test_perf_cli_report_baseline_compare(tmp_path, capsys):
    from horovod_tpu.perf.__main__ import main as jmain

    from horovod_tpu_torch.perf.__main__ import main

    p1, p2 = tmp_path / "r1.json", tmp_path / "r2.json"
    p1.write_text(json.dumps(_result(100.0)))
    p2.write_text(json.dumps(_result(102.0)))
    out, jout = tmp_path / "base.json", tmp_path / "jbase.json"
    assert main(["baseline", str(p1), str(p2), "-o", str(out)]) == 0
    assert jmain(["baseline", str(p1), str(p2), "-o", str(jout)]) == 0
    assert out.read_text() == jout.read_text()
    capsys.readouterr()
    for args in (["compare", str(p1), str(out)],
                 ["compare", str(p1), str(out), "--inject", "value=0.01"],
                 ["compare", str(p1), str(out), "--json"],
                 ["compare", str(tmp_path / "nope.json"), str(out)],
                 ["report", str(tmp_path / "empty")],
                 ["report", str(tmp_path / "empty"), "--json"]):
        rc = main(args)
        mine = capsys.readouterr()
        assert rc == jmain(args), args
        theirs = capsys.readouterr()
        assert mine.out.replace("*.pt.trace.json", "*.xplane.pb") == \
            theirs.out, args
    assert main(["compare", str(p1), str(out), "--inject",
                 "value=0.01"]) == 3
    capsys.readouterr()
    (tmp_path / "cap" / "rank3" / "step00000002").mkdir(parents=True)
    (tmp_path / "cap" / "rank3" / "step00000002" / "h_1.1.pt.trace.json") \
        .write_text(_fixture_text())
    assert main(["report", str(tmp_path / "cap"), "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    (cap,) = rep["captures"]
    assert cap["rank"] == 3 and cap["steps"][0]["step"] == 7


def test_perf_import_is_tf_free():
    """The reader loads with nothing beyond the stdlib; the package pulls
    in no tensorflow, tensorboard or prometheus_client."""
    script = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('kt', "
        f"{os.path.join(REPO, 'horovod_tpu_torch', 'perf', 'kineto.py')!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "sys.modules['kt'] = mod\n"
        "spec.loader.exec_module(mod)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('torch', 'numpy', 'jax', 'tensorflow', 'tensorboard')]\n"
        "assert not bad, ('kineto.py must be stdlib-only', bad)\n"
        "import horovod_tpu_torch.perf\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('tensorflow', 'tensorboard',\n"
        "        'tensorboard_plugin_profile', 'prometheus_client',\n"
        "        'jax', 'horovod_tpu')]\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n")
    out = subprocess.run([sys.executable, "-c", script],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "CLEAN" in out.stdout
