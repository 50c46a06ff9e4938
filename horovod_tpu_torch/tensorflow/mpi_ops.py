"""TensorFlow tensor ops: a ``tf.Tensor`` in, a ``tf.Tensor`` out
(counterpart of ``horovod_tpu/tensorflow/mpi_ops.py``; reference
``horovod/tensorflow/mpi_ops.py`` + ``tensorflow/mpi_ops.cc``):
allreduce, allgather and broadcast (sync, and async with handles),
differentiable under ``tf.GradientTape`` (the reference registers TF op
gradients, ``mpi_ops.py:188-200``; here ``tf.custom_gradient`` plays
that role), with the sparse ``tf.IndexedSlices`` -> 2x allgather path
(reference ``tensorflow/__init__.py:74-89``).

The wire is the negotiated eager plane every frontend shares
(:mod:`horovod_tpu_torch.ops.eager`, over the world's NCCL or gloo
group).  TF tensors cross through the numpy bridge
(:mod:`horovod_tpu_torch.ops.numpy_bridge`): to the runtime's device,
and back to the host as a TF tensor of the input's dtype.
"""

from __future__ import annotations

import numpy as np

import tensorflow as tf

from horovod_tpu_torch.common.basics import rank, size
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.ops import eager as _eager
from horovod_tpu_torch.ops import numpy_bridge as _bridge_np
from horovod_tpu_torch.ops.eager import Adasum, Average, Sum  # noqa: F401


class _TFHandle:
    """Async handle pairing the engine handle with TF-side finishing
    (reference ``handle_manager`` + done-callback split)."""

    __slots__ = ("engine_handle", "finish")

    def __init__(self, engine_handle, finish):
        self.engine_handle = engine_handle
        self.finish = finish


def _to_numpy(tensor) -> np.ndarray:
    if isinstance(tensor, tf.IndexedSlices):
        raise HorovodTpuError(
            "IndexedSlices must go through allreduce(), which routes "
            "them to the sparse allgather path.")
    return np.asarray(tensor.numpy() if hasattr(tensor, "numpy")
                      else tensor)


def _to_device(tensor):
    return _bridge_np.to_device(_to_numpy(tensor))


def _from_device(out, dtype) -> tf.Tensor:
    # a Keras 3 variable names its dtype as a string
    dtype = tf.as_dtype(dtype) if dtype is not None else None
    np_dtype = dtype.as_numpy_dtype if dtype is not None else None
    return tf.convert_to_tensor(_bridge_np.to_host(out, np_dtype),
                                dtype=dtype)


def allreduce_async(tensor, average=None, name=None, op=None) -> _TFHandle:
    dtype = tensor.dtype if hasattr(tensor, "dtype") else None
    h = _eager.allreduce_async(_to_device(tensor), average=average,
                               name=name, op=op)
    return _TFHandle(h, lambda out: _from_device(out, dtype))


def allgather_async(tensor, name=None) -> _TFHandle:
    dtype = tensor.dtype if hasattr(tensor, "dtype") else None
    h = _eager.allgather_async(_to_device(tensor), name=name)
    return _TFHandle(h, lambda out: _from_device(out, dtype))


def broadcast_async(tensor, root_rank, name=None) -> _TFHandle:
    dtype = tensor.dtype if hasattr(tensor, "dtype") else None
    h = _eager.broadcast_async(_to_device(tensor), root_rank, name=name)
    return _TFHandle(h, lambda out: _from_device(out, dtype))


def synchronize(handle: _TFHandle) -> tf.Tensor:
    out = _eager.synchronize(handle.engine_handle)
    return handle.finish(out)


def poll(handle: _TFHandle) -> bool:
    return _eager.poll(handle.engine_handle)


def join() -> int:
    return _eager.join()


def barrier() -> None:
    _eager.barrier()


# ---------------------------------------------------------------------------
# Differentiable sync ops
# ---------------------------------------------------------------------------


def _bridge(func, tensor, out_shape=None):
    """Run ``func`` (eager tensor → eager tensor) now, or as a
    ``tf.py_function`` when tracing under ``tf.function`` — the role of
    the reference's registered TF kernels, which work in both modes
    (``tensorflow/mpi_ops.cc``).  ``out_shape``: static shape to pin on
    the symbolic output (None entries for dynamic dims)."""
    if tf.executing_eagerly():
        return func(tensor)
    out = tf.py_function(func, [tensor], tensor.dtype)
    out.set_shape(tf.TensorShape(out_shape) if out_shape is not None
                  else tensor.shape)
    return out


def _allreduce_dense(tensor, name, op):
    """Dense allreduce, differentiable: the gradient of an allreduce is
    an allreduce of the gradient with the same op (reference
    ``mpi_ops.py:158-171``)."""

    @tf.custom_gradient
    def fn(x):
        out = _bridge(
            lambda t: synchronize(allreduce_async(t, name=name, op=op)), x)

        def grad(dy):
            return _allreduce_dense(dy, name and f"{name}.grad", op)

        return out, grad

    return fn(tensor)


def allreduce(tensor, average=None, name=None, op=None,
              compression=None):
    """Allreduce a ``tf.Tensor`` (or ``tf.IndexedSlices`` via the
    sparse 2×allgather path, reference
    ``tensorflow/__init__.py:74-89``)."""
    op = _eager._resolve_op(op, average)
    if isinstance(tensor, tf.IndexedSlices):
        if op == Adasum:
            raise NotImplementedError(
                "The Adasum reduction does not currently support sparse "
                "tensors. As a workaround please pass "
                "sparse_as_dense=True to DistributedOptimizer")
        # Two allgathers instead of an allreduce: each rank contributes
        # its (values, indices) slices; Average divides values by size.
        horovod_size = tf.cast(size(), tensor.values.dtype)
        values = allgather(tensor.values)
        indices = allgather(tensor.indices)
        new_values = (values / horovod_size) if op == Average else values
        return tf.IndexedSlices(new_values, indices,
                                dense_shape=tensor.dense_shape)
    if compression is not None and compression is not Compression.none:
        wire, ctx = compression.compress(tensor)
        out = _allreduce_dense(wire, name, op)
        return compression.decompress(out, ctx)
    return _allreduce_dense(tensor, name, op)


def allgather(tensor, name=None):
    """Concatenate across ranks along axis 0 (ragged first dims
    allowed).  Gradient: every rank takes its own slice of the summed
    upstream gradient (reference ``mpi_ops.py:289-307``)."""

    @tf.custom_gradient
    def fn(x):
        out = _bridge(
            lambda t: synchronize(allgather_async(t, name=name)), x,
            out_shape=[None] + list(x.shape[1:]))

        def grad(dy):
            # This rank's first-dim size is read from the *runtime*
            # tensor (x.shape[0] is None at tf.function trace time for
            # the dynamic batch dims ragged allgather exists for), so
            # the backward py_function takes both dy and x.
            def _g(dy_eager, x_eager):
                d0 = int(x_eager.shape[0])
                sizes = synchronize(allgather_async(
                    tf.constant([d0], dtype=tf.int32),
                    name=name and f"{name}.sizes")).numpy().reshape(-1)
                summed = synchronize(allreduce_async(
                    dy_eager, name=name and f"{name}.grad", op=Sum))
                start = int(sizes[:rank()].sum())
                return summed[start:start + d0]

            if tf.executing_eagerly():
                return _g(dy, x)
            gout = tf.py_function(_g, [dy, x], dy.dtype)
            gout.set_shape(x.shape)
            return gout

        return out, grad

    return fn(tensor)


def broadcast(tensor, root_rank, name=None):
    """Broadcast from ``root_rank``.  Gradient: allreduce to the root,
    zeros elsewhere (reference ``mpi_ops.py:371-385``)."""

    @tf.custom_gradient
    def fn(x):
        out = _bridge(
            lambda t: synchronize(broadcast_async(t, root_rank,
                                                  name=name)), x)

        def grad(dy):
            red = _allreduce_dense(dy, name and f"{name}.grad", Sum)
            if rank() != root_rank:
                return red * 0
            return red

        return out, grad

    return fn(tensor)


def alltoall(tensor, name=None):
    dtype = tensor.dtype if hasattr(tensor, "dtype") else None
    out = _eager.alltoall(_to_device(tensor), name=name)
    return _from_device(out, dtype)


# ---------------------------------------------------------------------------
# Compression (reference tensorflow/compression.py)
# ---------------------------------------------------------------------------


class NoneCompressor:
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class FP16Compressor:
    """Cast fp32/fp64 to fp16 on the wire (reference
    ``tensorflow/compression.py``)."""

    @staticmethod
    def compress(tensor):
        if tensor.dtype in (tf.float32, tf.float64):
            return tf.cast(tensor, tf.float16), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tf.cast(tensor, ctx) if ctx is not None else tensor


class Compression:
    none = NoneCompressor
    fp16 = FP16Compressor
