"""The eager collective API with async handles (counterpart of
``horovod_tpu/ops/eager.py``).

Parity surface of the reference's framework ops layer
(``horovod/torch/mpi_ops.py``): ``allreduce[_async][_]``,
``allgather[_async]``, ``broadcast[_async][_]``,
``reducescatter[_async]``, ``alltoall``, ``poll``/``synchronize`` on
integer handles, ``join`` and ``barrier``, with the deprecated
``average=`` argument (``horovod/common/util.py``).  Every op enqueues
into the process's background runtime (:mod:`horovod_tpu_torch.runtime.
background`), which negotiates it with the other ranks, fuses it and
runs it over the eager plane's own process group.

The in-place spellings (trailing ``_``) write the result into the
submitted tensor and return it, as the reference does.  On CUDA,
:func:`synchronize` makes the caller's current stream wait for the
result; it does not block the host on the device.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from horovod_tpu_torch.common import basics as _basics
from horovod_tpu_torch.common.types import HorovodTpuError, RanksDownError, Status
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.runtime import flight as _flight
from horovod_tpu_torch.runtime import metrics as _metrics

_M_BLOCKED = _metrics.counter("hvd_handle_wait_seconds_total")

# Values match the in-trace module's (reference C ABI).
Average, Sum, Adasum = 1, 2, 3


def _resolve_op(op, average):
    """Deprecated ``average=`` -> ``op=`` (reference ``common/util.py:
    get_average_backwards_compatibility_fun``)."""
    if op is not None and average is not None:
        raise HorovodTpuError(
            "The 'average' parameter is deprecated; specify only 'op'.")
    if op is None:
        if average is None:
            return Average
        return Average if average else Sum
    return op


class HandleManager:
    """Integer handles -> completion status and result (reference
    ``horovod/torch/handle_manager.{h,cc}``).  A result computed on a
    CUDA stream carries its done event."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next = 0
        self._results: dict[int, tuple | None] = {}
        self._events: dict[int, threading.Event] = {}

    def allocate(self) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            self._results[h] = None
            self._events[h] = threading.Event()
            return h

    def mark_done(self, handle: int, status: Status, result,
                  done=None) -> None:
        with self._lock:
            self._results[handle] = (status, result, done)
            self._events[handle].set()

    def poll(self, handle: int) -> bool:
        with self._lock:
            if handle not in self._results:
                raise HorovodTpuError(
                    f"Handle {handle} was not created or has been cleared.")
            return self._results[handle] is not None

    def wait(self, handle: int):
        with self._lock:
            if handle not in self._results:
                raise HorovodTpuError(
                    f"Handle {handle} was not created or has been cleared.")
            ev = self._events[handle]
        if not ev.is_set():
            # the blocked phase of hvd.trace_step(): seconds this thread
            # waits on unfinished collectives; the flight events bracket
            # the wait, so a rank that dies here dumps an open span
            # naming the handle
            _flight.record("wait", ph="B", handle=handle)
            t0 = time.perf_counter()
            ev.wait()
            dt = time.perf_counter() - t0
            _M_BLOCKED.inc(dt)
            _flight.record("wait", ph="E", handle=handle,
                           blocked_s=round(dt, 6))
        with self._lock:
            entry = self._results.pop(handle, None)
            self._events.pop(handle, None)
        if entry is None:
            # a concurrent wait() on the same handle consumed it
            raise HorovodTpuError(
                f"Handle {handle} was not created or has been cleared.")
        status, result, done = entry
        if not status.ok_p():
            raise (status.exc_class or HorovodTpuError)(status.reason)
        if done is not None:
            if isinstance(result, torch.Tensor) and result.is_cuda:
                stream = torch.cuda.current_stream(result.device)
                stream.wait_event(done)
                result.record_stream(stream)
            else:
                done.synchronize()
        return result


handle_manager = HandleManager()
_bound = threading.local()


@contextlib.contextmanager
def bound_runtime(rt):
    """Route this thread's eager ops to ``rt``, a ``BackgroundRuntime``
    built over :data:`handle_manager`, instead of the process's runtime
    (several emulated ranks in one process, each on a thread of its
    own)."""
    prev = getattr(_bound, "rt", None)
    _bound.rt = rt
    try:
        yield rt
    finally:
        _bound.rt = prev


def plane_place() -> tuple[int, int]:
    """``(rank, world)`` of the eager plane this thread's ops run on."""
    rt = _runtime()
    return rt.rank, rt.world


def plane_pair():
    """The (cross, local) ``HopPair`` of the eager plane this thread's ops
    run on, or ``None`` when it has none (it does not start the
    process's runtime)."""
    rt = getattr(_bound, "rt", None)
    if rt is not None:
        return rt.executor.pair
    return _basics._state.eager_pair


def _runtime():
    """This thread's bound runtime (:func:`bound_runtime`), else the
    process's background runtime (:func:`start_runtime`), after the
    eager op path's refusal of a data mesh with model-parallel axes."""
    rt = getattr(_bound, "rt", None)
    if rt is not None:
        return rt
    st = _basics._state
    if not st.initialized:
        raise HorovodTpuError(
            "Horovod-TPU has not been initialized; use hvd.init().")
    from horovod_tpu_torch.parallel import mesh as _pmesh

    if _pmesh.model_parallel_size() > 1:
        raise HorovodTpuError(
            "eager collectives reduce over the whole world and cannot "
            "honor a data mesh with model-parallel axes "
            f"({_pmesh.canonical_spec(_pmesh.active_spec())!r}); run "
            "the collective in-trace (shard_map over the data mesh) or "
            "drop the tp/pp/sp extents from HOROVOD_MESH "
            "(docs/mesh.md)")
    return start_runtime()


def start_runtime():
    """The process's background runtime, started once over the eager
    group :func:`~horovod_tpu_torch.common.basics.init` built (reference
    ``InitializeHorovodOnce``, ``operations.cc:604-650``).  ``init()``
    calls it at world > 1, so every rank beats and negotiates from the
    start; the model-parallel refusal stays on the op path
    (:func:`_runtime`), since
    every rank of the port is a process and a model-parallel world must
    still initialize."""
    st = _basics._state
    if st.background is None:
        with st.lock:
            if st.background is None:
                from horovod_tpu_torch.ops.eager_exec import EagerExecutor
                from horovod_tpu_torch.runtime.background import \
                    BackgroundRuntime
                from horovod_tpu_torch.runtime.controller import \
                    make_controller

                st.background = BackgroundRuntime(
                    st.rank, st.size,
                    make_controller(st.rank, st.size, st.epoch),
                    EagerExecutor(st.eager_hop, st.device, st.eager_pair),
                    handle_manager)
                # rank 0's timeline, closed by shutdown() and by an
                # elastic teardown
                st.timeline = st.background.timeline
    return st.background


# ---------------------------------------------------------------------------
# Public ops
# ---------------------------------------------------------------------------


def _enqueue(kind, tensor, name, op, postprocess=None, root_rank=-1,
             out=None) -> int:
    handle = handle_manager.allocate()
    _runtime().enqueue(kind=kind, tensor=tensor, name=name, op=op,
                       handle=handle, postprocess=postprocess,
                       root_rank=root_rank, out=out)
    return handle


def _allreduce_async(tensor, average, name, op, compression, inplace):
    op = _resolve_op(op, average)
    if getattr(compression, "quantized", False):
        # the scale-aware reduction is the negotiated wire's, and every
        # rank must agree on it: the knob is checked at round 0, a
        # per-call argument could differ by rank
        raise HorovodTpuError(
            "Compression.int8 on the eager path is selected via the "
            "HOROVOD_COMPRESSION=int8 knob (all ranks must agree), not "
            "a per-call argument; see docs/compression.md.")
    wire, ctx = compression.compress(tensor)
    if ctx is None:
        return _enqueue("allreduce", wire, name, op,
                        out=tensor if inplace else None)
    if inplace:
        def post(out):
            return tensor.copy_(compression.decompress(out, ctx))
    else:
        def post(out):
            return compression.decompress(out, ctx)
    return _enqueue("allreduce", wire, name, op, post)


def allreduce_async(tensor, average=None, name=None, op=None,
                    compression=Compression.none) -> int:
    return _allreduce_async(tensor, average, name, op, compression, False)


def allreduce(tensor, average=None, name=None, op=None,
              compression=Compression.none):
    return synchronize(allreduce_async(tensor, average, name, op,
                                       compression))


def allreduce_async_(tensor, average=None, name=None, op=None,
                     compression=Compression.none) -> int:
    """:func:`allreduce_async` writing the result into ``tensor``."""
    return _allreduce_async(tensor, average, name, op, compression, True)


def allreduce_(tensor, average=None, name=None, op=None,
               compression=Compression.none):
    return synchronize(allreduce_async_(tensor, average, name, op,
                                        compression))


def allgather_async(tensor, name=None) -> int:
    return _enqueue("allgather", tensor, name, Sum)


def allgather(tensor, name=None):
    return synchronize(allgather_async(tensor, name))


def reducescatter_async(tensor, name=None, op=None) -> int:
    """Reduce + scatter along axis 0.  ``op`` defaults to Sum; a leading
    dim that does not divide the world is zero-padded, every rank
    receiving ``ceil(d0 / size)`` rows.  ``HOROVOD_COMPRESSION`` applies
    on the wire."""
    op = Sum if op is None else op
    if op not in (Sum, Average):
        raise HorovodTpuError(
            f"reducescatter supports Sum/Average only, got op={op}")
    tensor = torch.as_tensor(tensor)
    if tensor.dim() == 0:
        raise HorovodTpuError("reducescatter requires rank >= 1 tensors")
    return _enqueue("reducescatter", tensor, name, op)


def reducescatter(tensor, name=None, op=None):
    return synchronize(reducescatter_async(tensor, name, op))


def broadcast_async(tensor, root_rank, name=None) -> int:
    return _enqueue("broadcast", tensor, name, Sum, root_rank=root_rank)


def broadcast(tensor, root_rank, name=None):
    return synchronize(broadcast_async(tensor, root_rank, name))


def broadcast_async_(tensor, root_rank, name=None) -> int:
    """:func:`broadcast_async` writing the result into ``tensor``."""
    return _enqueue("broadcast", tensor, name, Sum, root_rank=root_rank,
                    out=tensor)


def broadcast_(tensor, root_rank, name=None):
    return synchronize(broadcast_async_(tensor, root_rank, name))


def alltoall(tensor, name=None):
    """Equal-split all-to-all along axis 0."""
    return synchronize(_enqueue("alltoall", tensor, name, Sum))


def poll(handle: int) -> bool:
    """True when the op behind ``handle`` has completed."""
    return handle_manager.poll(handle)


def synchronize(handle: int):
    """Wait for the op behind ``handle`` and return its output."""
    return handle_manager.wait(handle)


def join() -> int:
    """Signal that this rank has no more data (uneven inputs; reference
    ``torch/mpi_ops.py:494-508``, semantics ``controller.cc:789-812``):
    blocks until every rank has joined and returns the last rank to
    join.  Until then this rank contributes zeros of the negotiated
    shape to every collective the others run."""
    return _runtime().join()


def barrier() -> None:
    """Wait until this rank's queued ops are done, then until every rank
    reaches the barrier (one sum on the eager group)."""
    _runtime().barrier()


def check_liveness() -> None:
    """Sweep the peers' heartbeats now: raises
    :class:`~horovod_tpu_torch.common.types.RanksDownError` when a peer is
    silent past ``HOROVOD_HEARTBEAT_TIMEOUT_SECONDS`` or a coordinated
    abort was broadcast.  The negotiated plane sweeps by itself every
    round; this is for loops that run long stretches of in-trace steps
    between eager ops.  A no-op at one rank (``init()`` starts the
    runtime, and with it the heartbeat, at world > 1)."""
    st = _basics._state
    ctl = getattr(st.background, "controller", None)
    fn = getattr(ctl, "check_liveness", None)
    if fn is not None:
        try:
            fn()
        except RanksDownError:
            # this generation has a dead member: shutdown() skips its
            # barrier and tears the groups down the bounded way
            st.peer_down = True
            raise
