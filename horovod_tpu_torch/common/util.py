"""Small shared helpers."""

from __future__ import annotations

import contextlib
import socket

import torch

from horovod_tpu_torch.common.types import HorovodTpuError


def free_port() -> int:
    """Pick a currently free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def reserve_port() -> tuple[socket.socket, int]:
    """A loopback port held for a server that another process (or a later
    ``init()``) will start: ``(socket, port)``.  The socket is bound with
    ``SO_REUSEADDR`` and never listens, so while it is open the kernel
    gives the port to no other ``bind(0)`` or outgoing connection, and a
    server binding with ``SO_REUSEADDR`` (as c10d's ``TCPStore`` does) can
    still take it.  :func:`free_port` releases its port at once, and
    anything started before the server binds may take it.  Close the
    socket once the server is up."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    return s, s.getsockname()[1]


def true_divide(x: torch.Tensor, c) -> torch.Tensor:
    """``x / c`` as a true division by a broadcast tensor.  PyTorch
    divides by a Python scalar through its reciprocal, which rounds
    differently from the reference's ``x / c``."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device).expand_as(x)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  A CUDA request on a machine without a usable card
    raises instead of carrying on elsewhere."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise HorovodTpuError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise HorovodTpuError(f"unsupported device {dev}")
    return dev


def profiler_scope(name: str):
    """A framework scope (``hvd_overlap_rs0``, ``hvd_zero3_ag1``, ...):
    ``torch.profiler.record_function(name)`` while a profiler records,
    else a no-op context.  The perf observatory resolves device work to
    the outermost ``hvd_*`` scope around its launch; an unprofiled step
    pays one flag read instead of a ``record_function``, which is a
    dispatcher call even with no profiler running."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def validate_warmup_epochs(warmup_epochs) -> None:
    """Loud failure for callers of the removed ``(initial_lr, epochs)``
    positional ``LearningRateWarmupCallback`` signature: a fractional
    count like ``0.001`` is the tell, and would otherwise silently
    explode the rate on the first batch.  Integer-like values
    (``np.int64``, ``5.0``) are fine."""
    import numbers

    integral = (isinstance(warmup_epochs, numbers.Integral)
                or (isinstance(warmup_epochs, float)
                    and warmup_epochs.is_integer()))
    if not integral or warmup_epochs < 1:
        raise TypeError(
            f"warmup_epochs must be a positive integer, got "
            f"{warmup_epochs!r}. (The optimizer should carry the "
            "size-scaled LR; this callback no longer takes "
            "initial_lr.)")
