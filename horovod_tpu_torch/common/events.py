"""The data plane's event hooks: what every transfer and every hand-kernel
launch reports, and who listens.

Each transfer of a hop (:class:`horovod_tpu_torch.parallel.mesh.Hop` and
the emulated hop of :mod:`horovod_tpu_torch.parallel.emulated`) calls
:func:`note_transfer` once, and each kernel wrapper calls
:func:`note_launch` where it launches its kernel.  Two listeners read
them:

* :func:`counting_sent`: the payload bytes a thread's transfers sent
  (the eager plane's ``hvd_data_wire_bytes_total``);
* a receiver opened with :func:`listening` (the schedule recorder of
  :mod:`horovod_tpu_torch.analysis.schedule_lint` opens its program
  here), which gets each transfer of a hop of more than one rank and
  each launch.

Stdlib only: the transports and the kernel wrappers import it, and it
imports nothing of theirs.  When no receiver is open anywhere in the
process, a hook costs its byte or launch count plus one read of a
module global.
"""

from __future__ import annotations

import contextlib
import threading

# Payload bytes this thread's transfers sent inside a counting_sent()
# block (what a response really put on the wire, compression, padding
# and scales included).
_sent = threading.local()
# This thread's receiver (listening()).
_tls = threading.local()
#: Receivers open anywhere in the process: the hooks' fast path.
_open = 0
_open_lock = threading.Lock()
# Finds the receiver of a thread that has none of its own but runs work
# a listening thread handed it (autograd's device threads).
_carried = None


@contextlib.contextmanager
def counting_sent():
    """Count the payload bytes every transfer this thread makes sends
    (a member's own payload, once per transfer); yields a one-element
    list holding the running total."""
    prev = getattr(_sent, "box", None)
    box = [0]
    _sent.box = box
    try:
        yield box
    finally:
        _sent.box = prev
        if prev is not None:
            prev[0] += box[0]


def note_transfer(hop, opcode: str, sent, out=None, pairs=None) -> None:
    """One transfer over ``hop``: ``sent`` is this member's payload
    (``None`` where it sends nothing), ``out`` the tensor whose shape a
    receiver records (default ``sent``), ``pairs`` a permute's
    ``(source, target)`` member indices.  ``opcode`` is the reference's
    name (``all-reduce``, ``reduce-scatter``, ``all-gather``,
    ``all-to-all``, ``collective-permute``, ``broadcast``)."""
    box = getattr(_sent, "box", None)
    if box is not None and sent is not None:
        box[0] += sent.numel() * sent.element_size()
    if _open and len(hop.ranks) > 1:
        receiver = _receiver()
        if receiver is not None:
            receiver.on_transfer(hop.ranks, opcode,
                                 sent if out is None else out, pairs)


def note_launch(counts: dict, module: str, kind: str, n: int = 1) -> None:
    """``n`` launches of the hand kernel ``kind`` of ``module``: counted
    in the wrapper's ``counts`` (its ``LAUNCHES``) and reported to an
    open receiver."""
    counts[kind] += n
    if _open:
        receiver = _receiver()
        if receiver is not None:
            receiver.on_launch(module, kind, n)


def _receiver():
    receiver = getattr(_tls, "receiver", None)
    if receiver is None and _carried is not None:
        receiver = _carried()
    return receiver


@contextlib.contextmanager
def listening(receiver, carried=None):
    """Route the calling thread's transfers and launches to ``receiver``
    (its ``on_transfer(ranks, opcode, out, pairs)`` and
    ``on_launch(module, kind, n)``) while the block runs.  ``carried()``
    finds the receiver of a thread that has none of its own, or
    ``None``."""
    global _open, _carried
    prev = getattr(_tls, "receiver", None)
    with _open_lock:
        _open += 1
        if carried is not None:
            _carried = carried
    _tls.receiver = receiver
    try:
        yield receiver
    finally:
        _tls.receiver = prev
        with _open_lock:
            _open -= 1
