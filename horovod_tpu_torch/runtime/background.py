"""Background runtime: the tensor queue and the thread that negotiates
and executes it (counterpart of ``horovod_tpu/runtime/background.py``).

Parity with the reference's core runtime (``horovod/common/operations.cc``):
framework threads only enqueue (``EnqueueTensorAllreduce``,
``operations.cc:803``) into a mutex-guarded tensor queue
(``tensor_queue.{h,cc}``); one background thread runs negotiation rounds
no more often than the cycle time (``RunLoopOnce``,
``operations.cc:550-600``), executes the negotiated fused collectives
and completes the handles.  Framework threads never touch the wire.

On CUDA each entry carries the ready event recorded on its submitting
thread's current stream at enqueue; the executor's stream waits on it
before reading, and the handle's done event is what :func:`synchronize`
makes the caller's stream wait on (the reference's
``horovod/torch/ready_event.cc``).

The controller's heartbeat starts with the runtime; a coordinated abort
(:class:`~horovod_tpu_torch.common.types.RanksDownError`, raised by the
controller's liveness sweep or observed from a peer) fails every
outstanding handle with the abort's message, and the runtime refuses new
work the same way from then on; the flight ring dumps first
(``flight.dump_on_failure``), as it does on a background failure and a
coordinated stop.

The loop records what the JAX package's does: the negotiation-latency
and response-count histograms, the fast-round gauge, the dispatch
seconds, and per response the wire bytes (what its transfers really
sent, ``common.events.counting_sent``) and the logical bytes, with a
``dispatch`` B/E span on the flight ring.  ``HOROVOD_FAULT_SPEC``'s
``nan:``/``inf:`` rules poison payloads before dispatch
(``runtime.faults.poison_entries``), where the executor's health tap
sees them; under ``HOROVOD_HEALTH`` each round is marked once for the
nonfinite alert's clear hysteresis (``health.note_wire_round``).

On rank 0, under ``HOROVOD_TIMELINE``, the runtime opens the Chrome-trace
timeline (``runtime/timeline.py``): ``NEGOTIATE_<KIND>`` from enqueue to
the response, the coordinator's ``RANK<k>_READY`` ticks, ``XLA_<KIND>``
around the executor's dispatch, ``overlap/*`` ticks per bucket and,
under ``HOROVOD_TIMELINE_MARK_CYCLES``, a ``CYCLE_START`` per cycle; the
writer is flushed and closed on stop and, before the handles fail, on a
coordinated abort or a background failure.  Under ``HOROVOD_AUTOTUNE``
rank 0 owns the ``ParameterManager``: every response's bytes feed it,
it ticks after every round, and its proposal rides the next round's
response list to every rank (at world 1 it applies at once).
"""

from __future__ import annotations

import collections
import contextlib
import math
import threading
import time

import torch

from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common import logging as _log
from horovod_tpu_torch.common.types import (DuplicateNameError, RanksDownError,
                                            Status, dtype_code,
                                            dtype_from_code)
from horovod_tpu_torch.runtime import flight as _flight
from horovod_tpu_torch.runtime import metrics as _metrics
from horovod_tpu_torch.runtime.controller import (RANKS_DOWN_PREFIX, Request,
                                                 reduction_scope,
                                                 tensor_nbytes)

_M_NEG_LAT = _metrics.histogram(
    "hvd_negotiation_seconds",
    "Wall time of one negotiation round (request post -> response "
    "list executed locally).")
_M_RESP_SIZE = _metrics.histogram(
    "hvd_response_list_size",
    "Responses per negotiated round (post-fusion launch count).",
    lo=0, hi=12)
_M_FAST_ROUNDS = _metrics.gauge(
    "hvd_negotiation_fast_rounds",
    "Rounds resolved via the cache-bit fast path since init.")
_M_DISPATCH = _metrics.counter(
    "hvd_comm_dispatch_seconds_total",
    "Background-thread seconds executing negotiated collectives.")
_M_WIRE_BYTES = _metrics.counter(
    "hvd_data_wire_bytes_total",
    "Data-plane bytes a negotiated response moves on the wire, after "
    "HOROVOD_COMPRESSION, labeled by collective kind and by axis "
    "(axis=local: ICI-only scoped reductions of the local-SGD inner "
    "step; axis=cross: everything that crosses slices over DCN — "
    "world-scoped collectives and local-SGD pseudo-gradient syncs).")
_M_LOGICAL_BYTES = _metrics.counter(
    "hvd_data_logical_bytes_total",
    "Uncompressed payload bytes of the same responses — "
    "wire/logical is the achieved compression ratio.")


def _logical_nbytes(resp, dtype) -> int:
    """Uncompressed payload bytes of a response (an allgather's: every
    rank's negotiated rows), as the JAX package counts them."""
    if resp.kind == "allgather" and resp.first_dims:
        row = (tensor_nbytes(tuple(resp.shapes[0][1:]), dtype)
               if len(resp.shapes[0]) > 1 else dtype.itemsize)
        return sum(int(d) for d in resp.first_dims) * row
    return sum(tensor_nbytes(s, dtype) for s in resp.shapes)


class _Entry:
    __slots__ = ("name", "kind", "op", "root_rank", "tensor", "handle",
                 "postprocess", "out", "ready")

    def __init__(self, name, kind, op, root_rank, tensor, handle,
                 postprocess, out=None, ready=None):
        self.name = name
        self.kind = kind
        self.op = op
        self.root_rank = root_rank
        self.tensor = tensor
        self.handle = handle
        self.postprocess = postprocess
        self.out = out        # the tensor the result is written into
        self.ready = ready    # CUDA event: the tensor is ready to read


class TensorQueue:
    """Mutex-guarded name table + FIFO (reference ``tensor_queue.h:28-64``).
    A duplicate name before completion raises (reference ``common.h:161``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._fifo: list[_Entry] = []
        self._table: dict[str, _Entry] = {}

    def add(self, entry: _Entry) -> None:
        with self._lock:
            if entry.name in self._table:
                raise DuplicateNameError(
                    f"Requested to {entry.kind} a tensor with the same name "
                    f"as another tensor that is currently being processed. "
                    f"If you want to request another tensor, pass a "
                    f"different tensor name. Tensor name: {entry.name}")
            self._table[entry.name] = entry
            self._fifo.append(entry)

    def pop_pending(self) -> list[_Entry]:
        with self._lock:
            out, self._fifo = self._fifo, []
            return out

    def drain_all(self) -> list[_Entry]:
        """Remove and return every outstanding entry, queued or
        negotiating (on shutdown or failure, so no handle hangs)."""
        with self._lock:
            out = list(self._table.values())
            self._table.clear()
            self._fifo = []
            return out

    def finalize(self, name: str) -> "_Entry | None":
        with self._lock:
            return self._table.pop(name, None)

    def outstanding(self) -> int:
        with self._lock:
            return len(self._table)


class BackgroundRuntime:
    """One rank's tensor queue, controller and executor, and the thread
    that drives them.  ``start=False`` leaves the thread unstarted: the
    caller then drives the rounds with :meth:`run_cycle` (several
    runtimes in one process, each on a thread of the caller's), or
    starts the thread later with :meth:`start`."""

    def __init__(self, rank: int, world: int, controller, executor,
                 handle_manager, start: bool = True) -> None:
        self.rank = rank
        self.world = world
        self.controller = controller
        self.executor = executor
        self.hm = handle_manager
        self.queue = TensorQueue()
        self._counters: dict[str, int] = {}
        self._counter_lock = threading.Lock()
        self._stop_requested = threading.Event()
        self._wake = threading.Event()
        self._stopped = threading.Event()
        self._join_requested = threading.Event()
        self._join_done = threading.Event()
        self._join_result = -1
        self._error: str | None = None
        self._error_class: type | None = None
        self._dumped_flight = False
        # rank 0's autotuner and the proposal the next round carries
        self.pm = None
        self._pending_tune: dict | None = None
        if rank == 0 and _config.get("autotune"):
            from horovod_tpu_torch.runtime.parameter_manager import \
                ParameterManager

            self.pm = ParameterManager(
                world=world,
                hier_possible=getattr(executor, "pair", None) is not None)
        # the whole-run torch.profiler capture, which labels each
        # response's dispatch (basics owns it and closes it)
        from horovod_tpu_torch.common import basics as _basics

        self.profiler = _basics.state().profiler
        # rank 0's timeline; its coordinator ticks the ranks' arrivals
        self.timeline = None
        tl_path = _config.get("timeline")
        if tl_path and rank == 0:
            from horovod_tpu_torch.runtime.timeline import make_timeline

            self.timeline = make_timeline(tl_path)
            coord = getattr(controller, "coordinator", None)
            if coord is not None:
                coord.timeline = self.timeline
        # the plane's counters: responses executed (join and error
        # included), negotiation rounds, and each round's host seconds
        # (negotiation and dispatch of its responses)
        self.responses = 0
        self.rounds = 0
        self.round_seconds = collections.deque(maxlen=4096)
        # held while a response executes: a barrier issued from another
        # thread must not interleave with it on the eager group
        self._exec_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._run, name=f"hvd-background-{rank}", daemon=True)
        if start:
            self.start()

    def start(self) -> None:
        # liveness: this rank beats for as long as the runtime lives
        if hasattr(self.controller, "start_heartbeat"):
            self.controller.start_heartbeat()
        self._thread.start()

    # -- framework-thread API ---------------------------------------------

    def autoname(self, kind: str) -> str:
        with self._counter_lock:
            i = self._counters.get(kind, 0)
            self._counters[kind] = i + 1
        return f"{kind}.noname.{i}"

    def enqueue(self, kind, tensor, name, op, handle, postprocess,
                root_rank=-1, out=None) -> None:
        """Queue ``tensor`` for ``kind``; ``out`` (optional) receives the
        result in place."""
        if self._stopped.is_set() or self._error:
            self.hm.mark_done(handle, Status.aborted(
                self._error or "Horovod-TPU runtime has been shut down.",
                self._error_class), None)
            return
        if not isinstance(tensor, torch.Tensor):
            tensor = torch.as_tensor(tensor)
        ready = None
        if tensor.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(tensor.device))
        name = name or self.autoname(kind)
        entry = _Entry(name, kind, op, root_rank, tensor, handle,
                       postprocess, out, ready)
        if self.timeline:
            self.timeline.negotiate_start(name, kind)
        try:
            self.queue.add(entry)
        except DuplicateNameError:
            self.hm.mark_done(handle, Status.aborted("duplicate name"), None)
            raise
        # a stop() racing this enqueue: nothing would process the entry
        if self._stopped.is_set():
            if self.queue.finalize(name) is not None:
                self.hm.mark_done(handle, Status.aborted(
                    self._error or
                    "Horovod-TPU runtime has been shut down.",
                    self._error_class), None)
        # wake the loop: one op should not wait out a whole cycle
        self._wake.set()

    def flush(self, timeout: float = 600.0) -> None:
        deadline = time.monotonic() + timeout
        while self.queue.outstanding() and time.monotonic() < deadline:
            time.sleep(0.001)

    def barrier(self) -> None:
        """Wait for this rank's queued ops, then for every rank (one sum
        on the eager group, issued between two responses)."""
        self.flush()
        with self._exec_lock:
            self.executor.barrier()

    def join(self) -> int:
        """Block until every rank joins; the last rank to join."""
        self._join_done.clear()
        self._join_requested.set()
        self._wake.set()
        self._join_done.wait()
        return self._join_result

    def aborted(self) -> bool:
        """True after a coordinated abort (a peer is down)."""
        return self._error_class is RanksDownError

    def stop(self) -> None:
        self._stop_requested.set()
        self._wake.set()
        if self._thread.is_alive():
            self._thread.join(timeout=30)
        if hasattr(self.controller, "close"):
            self.controller.close()
        self._close_timeline()

    def _close_timeline(self) -> None:
        """Flush and join the timeline's writer (idempotent): a dying
        rank's trace ends on a whole record."""
        if self.timeline:
            try:
                self.timeline.close()
            except Exception as exc:  # noqa: BLE001 -- advisory
                _log.warning(f"timeline close failed: {exc!r}",
                             rank=self.rank)

    # -- background loop ---------------------------------------------------

    def _run(self) -> None:
        while True:
            # re-read each cycle: the autotuner retunes it at runtime
            cycle_s = _config.get("cycle_time_ms") / 1000.0
            t0 = time.monotonic()
            if self.timeline and _config.get("timeline_mark_cycles"):
                self.timeline.mark_cycle()
            try:
                stop = self.run_cycle()
                if self.timeline:
                    # the cycle's events to the native writer, in one call
                    self.timeline.flush()
            except RanksDownError as exc:
                # the coordinated abort: every pending and later handle
                # fails with the dead ranks, the round and the silence
                _log.error(f"coordinated abort: {exc}", rank=self.rank)
                self._error = str(exc)
                self._error_class = RanksDownError
                # the ring dumps before the handles fail: a survivor that
                # exits on the RanksDownError still leaves its dump
                _flight.dump_on_failure("ranks_down", flush_metrics=False)
                self._dumped_flight = True
                from horovod_tpu_torch.common import basics as _basics

                if _basics.state().background is self:
                    # NCCL waits on a dead peer forever: abort this
                    # generation's communicators so a collective the
                    # caller still waits on fails (gloo resets by itself)
                    _basics.abort_communicators()
                # the trace is flushed before the handles fail: a
                # survivor may exit on the RanksDownError at once
                self._close_timeline()
                self._fail_outstanding()
                _flight.flush_terminal_metrics()
                stop = True
            except Exception as exc:  # noqa: BLE001 -- never die silently
                _log.error(f"background loop error: {exc!r}",
                           rank=self.rank)
                self._error = f"Horovod-TPU background failure: {exc!r}"
                _flight.dump_on_failure("background_failure",
                                        flush_metrics=False)
                self._dumped_flight = True
                self._close_timeline()
                self._fail_outstanding()
                _flight.flush_terminal_metrics()
                stop = True
            if stop:
                break
            elapsed = time.monotonic() - t0
            if elapsed < cycle_s:
                self._wake.wait(cycle_s - elapsed)
            self._wake.clear()
        self._stopped.set()
        if self._error:
            self._close_timeline()
        self._fail_outstanding()
        if self._error and not self._dumped_flight:
            # the one error path with no exception: a coordinator-
            # initiated stop (the round-0 knob mismatch)
            _flight.dump_on_failure("coordinated_stop")
            self._dumped_flight = True
        if self._join_requested.is_set():
            self._join_done.set()

    def run_cycle(self) -> bool:
        """One cycle: negotiate what is pending (when this rank or a peer
        has work) and execute the responses.  Returns True when the
        world stops."""
        pending = self.queue.pop_pending()
        joined = self._join_requested.is_set()
        shutdown = self._stop_requested.is_set()
        have_work = bool(pending) or joined or shutdown
        ctl = self.controller
        if hasattr(ctl, "should_participate"):
            # an outstanding entry, or a half-arrived negotiation on the
            # coordinator, keeps rounds running (so the stall inspector
            # sees a rank that never shows up)
            coord = getattr(ctl, "coordinator", None)
            waiting = bool(self.queue.outstanding()) or bool(
                coord is not None and (coord.table.entries or coord.joined))
            if not ctl.should_participate(have_work or waiting):
                return False
            if have_work or waiting:
                ctl.kick()
        elif not have_work and not self.queue.outstanding():
            return False

        t0 = time.perf_counter()
        requests = [Request(e.name, e.kind, e.op, dtype_code(e.tensor.dtype),
                            tuple(e.tensor.shape), e.root_rank)
                    for e in pending]
        tune, self._pending_tune = self._pending_tune, None
        neg_t0 = time.perf_counter()
        result = ctl.negotiate(requests, joined, shutdown, tune=tune)
        _M_NEG_LAT.observe(time.perf_counter() - neg_t0)
        _M_RESP_SIZE.observe(len(result.responses))
        fast = getattr(ctl, "fast_rounds", None)
        if fast is not None:
            _M_FAST_ROUNDS.set(fast)
        if result.should_stop and self._error is None and not shutdown:
            # a coordinator-initiated stop (the round-0 cfg mismatch):
            # its reason reaches every outstanding and late handle
            for resp in result.responses:
                if resp.kind == "error" and resp.error:
                    self._error = resp.error
                    if resp.error.startswith(RANKS_DOWN_PREFIX):
                        self._error_class = RanksDownError
                    break
        for resp in result.responses:
            self._execute(resp)
        if self.pm is not None:
            self._pending_tune = self.pm.tick()
            if self._pending_tune is not None and self.world == 1:
                # no wire to ride: apply at once.  At world > 1 every
                # rank, this one included, applies on the response
                # list's receipt, so the knobs never diverge across
                # ranks (a proposal of the last round is dropped on
                # every rank alike)
                from horovod_tpu_torch.runtime.parameter_manager import \
                    apply_params

                apply_params(self._pending_tune)
        self.rounds += 1
        self.round_seconds.append(time.perf_counter() - t0)
        if result.all_joined and self._join_requested.is_set():
            # cleared here, not in the waiting thread, so the next cycle
            # does not mark this rank joined again
            self._join_requested.clear()
            self._join_result = result.last_joined
            self._join_done.set()
        return result.should_stop

    def _fail_outstanding(self) -> None:
        msg = self._error or "Horovod-TPU runtime has been shut down."
        for entry in self.queue.drain_all():
            if entry.handle is not None:
                self.hm.mark_done(
                    entry.handle,
                    Status.aborted(msg, self._error_class), None)

    # -- response execution (the data plane) ------------------------------

    def _execute(self, resp) -> None:
        with self._exec_lock:
            self._execute_locked(resp)

    def _execute_locked(self, resp) -> None:
        self.responses += 1
        if resp.kind == "join":
            return
        if resp.kind == "error":
            exc_class = (RanksDownError if resp.error
                         and resp.error.startswith(RANKS_DOWN_PREFIX)
                         else None)
            for name in resp.names:
                entry = self.queue.finalize(name)
                if entry is not None:
                    if self.timeline:
                        self.timeline.negotiate_end(name, entry.kind)
                    self.hm.mark_done(
                        entry.handle,
                        Status.precondition(resp.error, exc_class), None)
            return

        entries, zeros = [], []
        dtype = dtype_from_code(resp.dtype_code)
        for name, shape in zip(resp.names, resp.shapes):
            entry = self.queue.finalize(name)
            if entry is None:
                # this rank joined: zeros of the negotiated shape (zero
                # rows of an allgather; reference GetTensorEntriesFrom-
                # Response), made in work()
                if resp.kind == "allgather":
                    shape = (0,) + tuple(shape[1:])
                zeros.append((len(entries), tuple(shape)))
                entry = _Entry(name, resp.kind, resp.op, resp.root_rank,
                               None, None, None)
            if self.timeline:
                self.timeline.negotiate_end(name, entry.kind)
            entries.append(entry)
        from horovod_tpu_torch.runtime import faults as _faults

        rnd = int(getattr(self.controller, "round", 0) or 0)
        if _faults.data_rules():
            # nan:/inf: rules poison this rank's payload before dispatch,
            # so the executor's health tap sees the poison pre-reduction
            _faults.poison_entries(entries, self.rank, rnd)
        if _config.get("health"):
            # a completed clean round counts once toward the nonfinite
            # alert's clear hysteresis, whatever its responses
            from horovod_tpu_torch.runtime import health as _health

            _health.note_wire_round(rnd)
        inputs = [e.tensor for e in entries if e.tensor is not None]

        def work():
            # the zeros are filled on the executor's stream, so the
            # fused copy that reads them is ordered after the fill
            for i, shape in zeros:
                entries[i].tensor = torch.zeros(
                    shape, dtype=dtype, device=self.executor.device)
            # the postprocess runs on the executor's stream too
            outs = self._dispatch(resp, entries)
            return [e.postprocess(o) if e.postprocess is not None else o
                    for e, o in zip(entries, outs)]

        scope = reduction_scope(resp.names[0]) \
            if resp.kind == "allreduce" and resp.names else None
        activity = f"XLA_{resp.kind.upper()}"
        if self.timeline:
            # the JAX package's activity name: a trace reader's tooling
            # applies unchanged
            for e in entries:
                self.timeline.activity_start(e.name, activity)
            self._mark_overlap_schedule(resp, entries)
        annotate = (self.profiler.annotate(f"hvd_{resp.kind}")
                    if self.profiler else contextlib.nullcontext())
        _flight.record("dispatch", ph="B", collective=resp.kind,
                       n=len(entries), names=[e.name for e in entries[:8]])
        disp_t0 = time.perf_counter()
        from horovod_tpu_torch.common.events import counting_sent

        with counting_sent() as sent:
            try:
                with annotate:
                    outs, done = self.executor.execute(
                        work, inputs, [e.ready for e in entries])
                status = Status.ok()
            except Exception as exc:  # noqa: BLE001 -- fails the handles
                outs, done = [None] * len(entries), None
                status = Status.unknown(
                    f"Collective {resp.kind} failed: {exc!r}")
                _log.error(status.reason, rank=self.rank)
        _M_DISPATCH.inc(time.perf_counter() - disp_t0, kind=resp.kind)
        if self.timeline:
            for e in entries:
                self.timeline.activity_end(e.name, activity)
        logical_b = _logical_nbytes(resp, dtype)
        _M_WIRE_BYTES.inc(sent[0], kind=resp.kind,
                          axis="local" if scope == "local" else "cross")
        _M_LOGICAL_BYTES.inc(logical_b, kind=resp.kind)
        if self.pm is not None:
            # at world 1 nothing crosses a wire: the tuner scores the
            # negotiated payload, as the JAX package's count does there
            self.pm.record_bytes(sent[0] if self.world > 1 else logical_b,
                                 logical_b)
        _flight.record("dispatch", ph="E", collective=resp.kind,
                       ok=status.ok_p(), bytes=sent[0])
        for entry, out in zip(entries, outs):
            if entry.handle is not None:
                self.hm.mark_done(entry.handle, status, out, done)

    def _mark_overlap_schedule(self, resp, entries) -> None:
        """Per-bucket ``overlap/rs|compute|ag`` timeline ticks for a
        response riding the overlap schedule (the host's issue order).
        The reduce-scatter wire pads each tensor's leading dimension to
        the world size, so its per-rank bucket space is the sum of
        ``ceil(d0 / n)`` rows per tensor; an allreduce pads the flat
        total."""
        from horovod_tpu_torch.ops import overlap as _ovl
        from horovod_tpu_torch.ops.eager_exec import _ADASUM

        if resp.kind not in ("allreduce", "reducescatter") or \
                resp.op == _ADASUM or self.world <= 1 or \
                not _ovl.enabled():
            return
        if resp.kind == "reducescatter":
            shard = sum(-(-int(s[0]) // self.world) * math.prod(s[1:])
                        for s in resp.shapes)
        else:
            total = sum(math.prod(s) for s in resp.shapes)
            shard = (total + (-total) % self.world) // self.world
        name = entries[0].name
        for b, (s, e) in enumerate(_ovl.bucket_bounds(shard)):
            for phase in ("rs", "compute", "ag"):
                self.timeline.overlap_phase(name, b, phase,
                                            (e - s) * self.world)

    def _dispatch(self, resp, entries):
        ex = self.executor
        tensors = [e.tensor for e in entries]
        if resp.kind == "allreduce":
            scope = reduction_scope(resp.names[0])
            if scope is not None:
                return ex.scoped_allreduce(tensors, resp.op, scope,
                                           [e.out for e in entries])
            return ex.fused_allreduce(tensors, resp.op,
                                      [e.out for e in entries])
        if resp.kind == "broadcast":
            return ex.fused_broadcast(tensors, resp.root_rank,
                                      [e.out for e in entries])
        if resp.kind == "allgather":
            sizes = list(resp.first_dims) or None
            return [ex.allgather(t, sizes=sizes) for t in tensors]
        if resp.kind == "alltoall":
            return [ex.alltoall(t) for t in tensors]
        if resp.kind == "reducescatter":
            return [ex.reducescatter(t, resp.op) for t in tensors]
        raise RuntimeError(f"unknown response kind {resp.kind}")
