"""Frontend collective ops with async handles and autograd (counterpart
of ``horovod_tpu/torch/mpi_ops.py``; reference ``horovod/torch/
mpi_ops.py`` and ``mpi_ops_v2.cc``/``handle_manager.cc``).

The ops run on the port's eager plane (:mod:`horovod_tpu_torch.ops.
eager`): negotiated, fused and executed over the eager group, on the
tensor's device.  In-place spellings (trailing ``_``) write the result
into the submitted tensor.  int64 and float64 allreduces gather every
rank's tensor and sum the rows in rank order on the device (an int64
Average truncating toward zero, as the reference's C++ ``/``), which
gives the values the JAX frontend computes on the host.
"""

from __future__ import annotations

import threading

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics as _basics
from horovod_tpu_torch.common.basics import (  # noqa: F401
    init, local_rank, local_size, rank, shutdown, size)
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.common.util import true_divide
from horovod_tpu_torch.ops import eager as _eager
from horovod_tpu_torch.ops.eager import Adasum, Average, Sum  # noqa: F401
from horovod_tpu_torch.torch.compression import Compression


def is_homogeneous() -> bool:
    """True when every host runs the same number of ranks."""
    st = _basics._check()
    return st.local_size * st.cross_size == st.size


def mpi_threads_supported() -> bool:
    return False


def mpi_built() -> bool:
    return False


def mpi_enabled() -> bool:
    return False


def gloo_built() -> bool:
    return dist.is_gloo_available()


def gloo_enabled() -> bool:
    return _basics.is_initialized() and _basics.device().type == "cpu"


def nccl_built() -> bool:
    return dist.is_nccl_available()


def ddl_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


# ---------------------------------------------------------------------------
# Handle table: frontend handle -> completion action
# ---------------------------------------------------------------------------


class _TorchHandles:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: dict[int, tuple] = {}

    def register(self, handle: int, inplace_target=None,
                 postprocess=None) -> int:
        with self._lock:
            self._entries[handle] = (inplace_target, postprocess)
        return handle

    def finish(self, handle: int):
        out = _eager.synchronize(handle)
        with self._lock:
            e = self._entries.pop(handle, None)
        if e is None:
            raise HorovodTpuError(
                f"Handle {handle} was not created or has been cleared.")
        target, post = e
        if post is not None:
            out = post(out)
        if target is not None and out is not target:
            target.copy_(out.reshape(target.shape))
            return target
        return out


_handles = _TorchHandles()


def poll(handle: int) -> bool:
    """True when the op behind ``handle`` is finished."""
    return _eager.poll(handle)


def synchronize(handle: int) -> torch.Tensor:
    """Wait for the op and return its output (an in-place op returns the
    submitted tensor, updated)."""
    return _handles.finish(handle)


def wait_and_clear(handle: int) -> torch.Tensor:
    """Reference ``horovod_torch_wait_and_clear`` spelling."""
    return synchronize(handle)


def join() -> int:
    """Uneven inputs: blocks until every rank joins; returns the last
    rank to join."""
    return _eager.join()


def barrier() -> None:
    _eager.barrier()


# ---------------------------------------------------------------------------
# allreduce
# ---------------------------------------------------------------------------

_EXACT64 = (torch.float64, torch.int64)


def _allreduce64_async(wire, name, op, average, inplace_target,
                       decompress) -> int:
    """int64/float64: every rank's tensor gathered, the rows summed in
    rank order, an int64 Average truncated toward zero."""
    if op == Adasum:
        raise HorovodTpuError(
            "Adasum allreduce does not support 64-bit dtypes; cast to "
            "float32/bfloat16 first.")
    op = _eager._resolve_op(op, average)
    shape, world = tuple(wire.shape), size()
    h = _eager.allgather_async(wire.reshape(1, -1),
                               name=name and f"{name}.w64")

    def post(t):
        rows = t.reshape((world,) + shape)
        summed = rows[0].clone()
        for row in rows[1:]:
            summed += row
        if op == Average:
            summed = (torch.div(summed, world, rounding_mode="trunc")
                      if summed.dtype == torch.int64
                      else true_divide(summed, world))
        return decompress(summed)

    return _handles.register(h, inplace_target=inplace_target,
                             postprocess=post)


def _allreduce_async(tensor, average, name, op, compression, inplace):
    wire, cctx = compression.compress(tensor)
    target = tensor if inplace else None
    if wire.dtype in _EXACT64:
        return _allreduce64_async(
            wire, name, op, average, target,
            lambda t: compression.decompress(t, cctx))
    if cctx is None:
        if inplace:
            h = _eager.allreduce_async_(wire, average=average, name=name,
                                        op=op)
        else:
            h = _eager.allreduce_async(wire, average=average, name=name,
                                       op=op)
        return _handles.register(h)
    h = _eager.allreduce_async(wire, average=average, name=name, op=op)
    return _handles.register(
        h, inplace_target=target,
        postprocess=lambda t: compression.decompress(t, cctx))


def allreduce_async(tensor: torch.Tensor, average=None, name=None,
                    op=None, compression=Compression.none) -> int:
    return _allreduce_async(tensor, average, name, op, compression, False)


def allreduce(tensor: torch.Tensor, average=None, name=None,
              compression=Compression.none, op=None) -> torch.Tensor:
    """Averaged (by default) allreduce with autograd: the gradient of an
    allreduce is the allreduce of the gradient (reference
    ``mpi_ops.py:158-171``)."""
    return _HorovodAllreduce.apply(tensor, average, name, op, compression)


def allreduce_async_(tensor: torch.Tensor, average=None, name=None,
                     op=None, compression=Compression.none) -> int:
    return _allreduce_async(tensor, average, name, op, compression, True)


def allreduce_(tensor: torch.Tensor, average=None, name=None,
               op=None, compression=Compression.none) -> torch.Tensor:
    return synchronize(allreduce_async_(tensor, average, name, op,
                                        compression))


class _HorovodAllreduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, average, name, op, compression):
        ctx.average = average
        ctx.op = op
        return synchronize(allreduce_async(tensor, average, name, op,
                                           compression))

    @staticmethod
    def backward(ctx, grad_output):
        g = synchronize(allreduce_async(grad_output, ctx.average,
                                        None, ctx.op))
        return g, None, None, None, None


# ---------------------------------------------------------------------------
# allgather
# ---------------------------------------------------------------------------


def allgather_async(tensor: torch.Tensor, name=None) -> int:
    return _handles.register(_eager.allgather_async(tensor, name=name))


def allgather(tensor: torch.Tensor, name=None) -> torch.Tensor:
    """Every rank's tensor concatenated along dim 0 (ranks may differ in
    dim 0).  Gradient: the sum-allreduce of the upstream gradient, this
    rank's rows of it (reference ``mpi_ops.py:289-307``)."""
    return _HorovodAllgather.apply(tensor, name)


class _HorovodAllgather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, name):
        ctx.dim0 = tensor.shape[0] if tensor.dim() else 1
        return synchronize(allgather_async(tensor, name))

    @staticmethod
    def backward(ctx, grad_output):
        # every rank runs this backward: the row counts are gathered
        # here, so the forward stays one collective
        counts = synchronize(allgather_async(
            torch.tensor([ctx.dim0], dtype=torch.int32,
                         device=grad_output.device)))
        summed = synchronize(allreduce_async(grad_output, op=Sum))
        start = int(counts[:rank()].sum())
        return summed[start:start + ctx.dim0], None


# ---------------------------------------------------------------------------
# broadcast
# ---------------------------------------------------------------------------


def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    name=None) -> int:
    return _handles.register(_eager.broadcast_async(tensor, root_rank,
                                                    name=name))


def broadcast(tensor: torch.Tensor, root_rank: int,
              name=None) -> torch.Tensor:
    """``tensor``'s value on ``root_rank``, everywhere.  Gradient: the
    sum-allreduce on the root rank, zeros elsewhere (reference
    ``mpi_ops.py:371-385``)."""
    return _HorovodBroadcast.apply(tensor, root_rank, name)


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     name=None) -> int:
    return _handles.register(_eager.broadcast_async_(tensor, root_rank,
                                                     name=name))


def broadcast_(tensor: torch.Tensor, root_rank: int,
               name=None) -> torch.Tensor:
    return synchronize(broadcast_async_(tensor, root_rank, name))


class _HorovodBroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, root_rank, name):
        ctx.root_rank = root_rank
        return synchronize(broadcast_async(tensor, root_rank, name))

    @staticmethod
    def backward(ctx, grad_output):
        summed = synchronize(allreduce_async(grad_output, op=Sum))
        if rank() != ctx.root_rank:
            summed = summed * 0
        return summed, None, None


# ---------------------------------------------------------------------------
# alltoall
# ---------------------------------------------------------------------------


def alltoall(tensor: torch.Tensor, name=None) -> torch.Tensor:
    """Equal-split all-to-all: row block i goes to rank i."""
    return _eager.alltoall(tensor, name=name)
