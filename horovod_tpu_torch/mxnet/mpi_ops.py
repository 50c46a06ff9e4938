"""MXNet tensor ops over the shared eager plane (counterpart of
``horovod_tpu/mxnet/mpi_ops.py``; reference ``horovod/mxnet/mpi_ops.py``,
246 LoC): sync and in-place collectives on ``mx.nd.NDArray``.  The
reference pushes ops through the MXNet engine asynchronously with a
``priority`` (``mpi_ops.cc``); here NDArrays cross to the runtime's
device through the numpy bridge
(:mod:`horovod_tpu_torch.ops.numpy_bridge`) into the negotiated eager
plane, and come back as NDArrays in the input's context.  ``priority``
is accepted for the reference's signature: the submission order already
encodes it, and the controller fuses per cycle regardless.

MXNet itself is imported lazily: the module imports (for
``mxnet_built()`` probing) without MXNet installed.
"""

from __future__ import annotations

import numpy as np

from horovod_tpu_torch.common.basics import rank, size  # noqa: F401
from horovod_tpu_torch.ops import eager as _eager
from horovod_tpu_torch.ops import numpy_bridge as _bridge
from horovod_tpu_torch.ops.eager import Adasum, Average, Sum  # noqa: F401


def _np(tensor) -> np.ndarray:
    if hasattr(tensor, "asnumpy"):  # mx.nd.NDArray
        return tensor.asnumpy()
    return np.asarray(tensor)


def _like(arr: np.ndarray, template):
    """An NDArray holding ``arr`` in ``template``'s context."""
    import mxnet as mx

    ctx = getattr(template, "context", None)
    return mx.nd.array(arr, ctx=ctx, dtype=arr.dtype)


def _run(collective, tensor, *args, **kwargs) -> np.ndarray:
    """``collective`` on ``tensor`` over the bridge; the result on the
    host, in the input's dtype."""
    a = _np(tensor)
    return _bridge.to_host(collective(_bridge.to_device(a), *args,
                                      **kwargs), a.dtype)


def allreduce(tensor, average=None, name=None, priority=0, op=None):
    """Allreduce returning a new NDArray (reference ``mpi_ops.py``)."""
    return _like(_run(_eager.allreduce, tensor, average=average, name=name,
                      op=op), tensor)


def allreduce_(tensor, average=None, name=None, priority=0, op=None):
    """In-place allreduce: the reference mutates the NDArray the MXNet
    engine hands it; here the reduced values are written back."""
    out = _run(_eager.allreduce, tensor, average=average, name=name, op=op)
    tensor[:] = _like(out, tensor)
    return tensor


def allgather(tensor, name=None, priority=0):
    return _like(_run(_eager.allgather, tensor, name=name), tensor)


def broadcast(tensor, root_rank, name=None, priority=0):
    return _like(_run(_eager.broadcast, tensor, root_rank, name=name),
                 tensor)


def broadcast_(tensor, root_rank, name=None, priority=0):
    out = _run(_eager.broadcast, tensor, root_rank, name=name)
    tensor[:] = _like(out, tensor)
    return tensor


def alltoall(tensor, name=None, priority=0):
    return _like(_run(_eager.alltoall, tensor, name=name), tensor)
