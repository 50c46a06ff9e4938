"""Horovod Timeline: a Chrome-tracing profile of every tensor's lifecycle
(this package's copy of ``horovod_tpu/runtime/timeline.py``).

Parity with reference ``horovod/common/timeline.{h,cc}``: one trace
"thread" per tensor name, announced by a ``thread_name`` metadata row;
``NEGOTIATE_<KIND>`` B/E from enqueue to the response, a
``RANK<k>_READY`` instant on the coordinator when rank k's request
arrived (the straggler signal), the dispatch activity ``XLA_<KIND>``
B/E (the JAX package's name, kept so a trace reader's tooling applies
unchanged; here it spans the executor's enqueue of the response's
collectives), ``overlap/rs|compute|ag`` instants on ``<name>/bucket<k>``
rows, and global ``CYCLE_START`` markers under
``HOROVOD_TIMELINE_MARK_CYCLES``.  Rank 0 writes the file
(``operations.cc:403-411``); view it in chrome://tracing or Perfetto.

:class:`NativeTimeline` is the writer the runtime opens: records are
stamped and queued in Python and handed in batches to a native writer
thread (``csrc/timeline.cc``, built at first use with ``g++``), which
formats them and writes the file.  A writer that fails to build raises,
naming the compiler's error: there is no fallback.  :class:`Timeline` is the plain Python
writer the tests hold the native one against.

:class:`TorchProfilerBridge` is the device-side capture of a whole run
(``HOROVOD_TIMELINE_JAX_PROFILER``), the JAX package's
``JaxProfilerBridge`` over ``torch.profiler``.
"""

from __future__ import annotations

import array
import collections
import json
import queue
import threading
import time

LIB_NAME = "hvdtorchtl"


class NativeTimeline:
    """The C++ writer (``csrc/timeline.cc``): formatting and file IO run
    on a native thread.  An event costs its caller a timestamp and one
    append to a deque (safe from any thread); :meth:`flush` hands the
    pending events to the native queue in one call, which the runtime
    makes once per background cycle (and an append does past
    ``FLUSH_AT`` pending events).  The library is called through
    ``ctypes.PyDLL``, which keeps the interpreter lock across the call
    (the native side never calls back into Python): a call that released
    it would hand it to the other runnable Python thread, and the caller
    would wait for it back.  A foreign call per event, lock released,
    cost the eager step more than the writer's work.  A lock orders
    :meth:`flush` against :meth:`close`, which frees the native
    writer."""

    FLUSH_AT = 4096

    def __init__(self, path: str) -> None:
        import ctypes

        from horovod_tpu_torch import _build

        lib = ctypes.PyDLL(
            _build.load_host_library(LIB_NAME, "timeline.cc")._name)
        lib.hvd_tl_open.restype = ctypes.c_void_p
        lib.hvd_tl_open.argtypes = [ctypes.c_char_p]
        lib.hvd_tl_events.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.c_char_p, ctypes.c_char_p]
        lib.hvd_tl_close.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._lock = threading.Lock()
        self._pending: collections.deque = collections.deque()
        self._t0 = time.monotonic_ns()
        self._h = lib.hvd_tl_open(path.encode())
        if not self._h:
            raise OSError(f"timeline: cannot open {path}")

    def _event(self, row: str, name: str, phase: str) -> None:
        if self._h is None:  # closed: dropped
            return
        self._pending.append(
            ((time.monotonic_ns() - self._t0) // 1000, row, name, phase))
        if len(self._pending) >= self.FLUSH_AT:
            self.flush()

    def negotiate_start(self, name: str, kind: str) -> None:
        self._event(name, f"NEGOTIATE_{kind.upper()}", "B")

    def negotiate_end(self, name: str, kind: str) -> None:
        self._event(name, f"NEGOTIATE_{kind.upper()}", "E")

    def negotiate_rank_ready(self, name: str, rank: int) -> None:
        """Instant tick on the tensor's row: ``rank``'s request reached
        the coordinator (reference ``timeline.h:85-88``)."""
        self._event(name, f"RANK{rank}_READY", "i")

    def activity_start(self, name: str, activity: str) -> None:
        self._event(name, activity, "B")

    def activity_end(self, name: str, activity: str) -> None:
        self._event(name, activity, "E")

    def mark_cycle(self) -> None:
        self._event("", "CYCLE_START", "i")  # no row: a global marker

    def overlap_phase(self, name: str, bucket: int, phase: str,
                      elems: int = 0) -> None:
        """Instant tick on a per-bucket row: bucket ``bucket`` of the
        overlap schedule issued ``phase`` (``rs``/``compute``/``ag``)."""
        del elems  # the native writer has no args payload
        self._event(f"{name}/bucket{bucket}", f"overlap/{phase}", "i")

    def flush(self) -> None:
        """Hand the pending events to the native writer, in order."""
        with self._lock:
            n = len(self._pending)
            if not n or not self._h:
                return
            pop = self._pending.popleft
            ts, rows, names, phases = zip(*(pop() for _ in range(n)))
            self._lib.hvd_tl_events(
                self._h, n, array.array("q", ts).tobytes(),
                "".join(phases).encode(),
                "\0".join(rows).encode() + b"\0",
                "\0".join(names).encode() + b"\0")

    def close(self) -> None:
        """Flush, drain the queue, write the footer and free the writer
        (idempotent)."""
        self.flush()
        with self._lock:
            h, self._h = self._h, None
            if h:
                self._lib.hvd_tl_close(h)


class TorchProfilerBridge:
    """Device-side tracing via ``torch.profiler``: the counterpart of
    the JAX package's ``JaxProfilerBridge``.  A whole-run capture of the
    CPU and, on a card, CUDA activities (CUPTI) under
    ``<logdir>/rank<k>``; :meth:`close` writes it as a Chrome trace
    (``<host>_<pid>.<ms>.pt.trace.json``), which Perfetto,
    chrome://tracing and ``python -m horovod_tpu_torch.perf report``
    read.  Enabled by ``HOROVOD_TIMELINE_JAX_PROFILER`` (the JAX
    package's knob; every rank captures, since device activity is
    per-process).

    Elastic lifecycle: a re-form tears the world down and re-enters
    ``init()`` in the same process -- the old bridge is closed first
    (``teardown_distributed``, landing the old generation's trace) and
    the new one opens under ``gen<g>/rank<k>``, so a re-formed
    generation never writes into a prior generation's directory (ranks
    are renumbered across re-forms).
    """

    def __init__(self, logdir: str, rank: int,
                 generation: int = 1, device=None) -> None:
        import atexit
        import os

        import torch

        sub = (f"rank{rank}" if generation <= 1
               else os.path.join(f"gen{generation}", f"rank{rank}"))
        self._dir = os.path.join(logdir, sub)
        os.makedirs(self._dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device is not None and torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._active = True
        # The trace only lands at close(); scripts that exit without
        # hvd.shutdown() must still get their profile.
        atexit.register(self.close)

    def annotate(self, label: str):
        """Context manager labelling framework work (e.g. the fused
        dispatch of one negotiated response) in the trace."""
        import torch

        return torch.profiler.record_function(label)

    def close(self) -> None:
        """Stop the capture and write its trace (idempotent)."""
        if self._active:
            self._active = False
            from horovod_tpu_torch.perf import capture as _capture

            self._prof.stop()
            self._prof.export_chrome_trace(_capture.trace_path(self._dir))


def make_timeline(path: str) -> NativeTimeline:
    """The native writer; a failed build raises (the JAX package falls
    back to the Python writer, this package does not)."""
    return NativeTimeline(path)


class Timeline:
    """The plain Python writer: the same events through a queue to a
    Python writer thread."""

    def __init__(self, path: str) -> None:
        self._path = path
        self._q: queue.Queue = queue.Queue()
        self._tids: dict[str, int] = {}
        self._start = time.monotonic()
        self._file = open(path, "w")
        self._file.write("[\n")
        self._first = True
        self._closed = False
        self._writer = threading.Thread(target=self._write_loop,
                                        name="hvd-timeline", daemon=True)
        self._writer.start()

    # -- record API (called from the background thread) --------------------

    def _us(self) -> int:
        return int((time.monotonic() - self._start) * 1e6)

    def _tid(self, tensor_name: str) -> int:
        tid = self._tids.get(tensor_name)
        if tid is None:
            tid = len(self._tids) + 1
            self._tids[tensor_name] = tid
            self._q.put({"name": "thread_name", "ph": "M", "pid": 0,
                         "tid": tid,
                         "args": {"name": tensor_name}})
        return tid

    def negotiate_start(self, name: str, kind: str) -> None:
        self._q.put({"name": f"NEGOTIATE_{kind.upper()}", "ph": "B",
                     "pid": 0, "tid": self._tid(name), "ts": self._us()})

    def negotiate_end(self, name: str, kind: str) -> None:
        self._q.put({"name": f"NEGOTIATE_{kind.upper()}", "ph": "E",
                     "pid": 0, "tid": self._tid(name), "ts": self._us()})

    def negotiate_rank_ready(self, name: str, rank: int) -> None:
        """Instant tick: ``rank``'s request for ``name`` reached the
        coordinator (reference ``timeline.h:85-88``)."""
        self._q.put({"name": f"RANK{rank}_READY", "ph": "i", "pid": 0,
                     "tid": self._tid(name), "ts": self._us(), "s": "t",
                     "args": {"rank": rank}})

    def activity_start(self, name: str, activity: str) -> None:
        self._q.put({"name": activity, "ph": "B", "pid": 0,
                     "tid": self._tid(name), "ts": self._us()})

    def activity_end(self, name: str, activity: str) -> None:
        self._q.put({"name": activity, "ph": "E", "pid": 0,
                     "tid": self._tid(name), "ts": self._us()})

    def mark_cycle(self) -> None:
        self._q.put({"name": "CYCLE_START", "ph": "i", "pid": 0, "tid": 0,
                     "ts": self._us(), "s": "g"})

    def overlap_phase(self, name: str, bucket: int, phase: str,
                      elems: int = 0) -> None:
        """Per-bucket overlap-schedule tick (``overlap/rs``,
        ``overlap/compute``, ``overlap/ag``) on a ``<name>/bucket<k>``
        row: the host's issue order of the K-bucket pipeline."""
        self._q.put({"name": f"overlap/{phase}", "ph": "i", "pid": 0,
                     "tid": self._tid(f"{name}/bucket{bucket}"),
                     "ts": self._us(), "s": "t",
                     "args": {"bucket": bucket, "elems": int(elems)}})

    def flush(self) -> None:
        """Nothing to hand over: each event is queued as it comes."""

    # -- writer ------------------------------------------------------------

    def _write_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                # the footer, written by the thread that owns the file
                self._file.write("\n]\n")
                self._file.close()
                return
            text = json.dumps(item)
            if self._first:
                self._first = False
                self._file.write(text)
            else:
                self._file.write(",\n" + text)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._writer.join(timeout=10)
