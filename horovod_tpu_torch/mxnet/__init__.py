"""MXNet frontend (counterpart of ``horovod_tpu/mxnet/``).

The parity surface of reference ``horovod/mxnet/__init__.py`` (124 LoC):
``DistributedOptimizer`` wrapping an ``mx.optimizer.Optimizer`` so every
``update`` all-reduces the gradient first; ``DistributedTrainer``
(Gluon), overriding ``_allreduce_grads``; ``broadcast_parameters`` for
``get_params()`` dicts and Gluon ``ParameterDict``s.  The wire is the
port's negotiated eager plane, reached through the numpy bridge the
TensorFlow frontend shares (:mod:`horovod_tpu_torch.ops.numpy_bridge`).

MXNet is retired upstream and is an optional dependency, so everything
that needs ``import mxnet`` is built lazily: this module imports for
probing (``mxnet_built()`` is False without it), and only the entry
points that need MXNet raise, pointing at the core and torch
equivalents.

Validation scope: API-shape parity, exercised against a stubbed mxnet
module (``tests/test_torch_mxnet.py``); the real library has not run
against this frontend.
"""

from __future__ import annotations

import warnings

from horovod_tpu_torch import (  # noqa: F401
    cross_rank,
    cross_size,
    init,
    join,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)
from horovod_tpu_torch.common.types import HorovodTpuError


def mxnet_built() -> bool:
    try:
        import mxnet  # noqa: F401

        return True
    except ImportError:
        return False


def _require_mx():
    try:
        import mxnet

        return mxnet
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.mxnet requires MXNet, which is not "
            "installed (the project is retired upstream). Use the core "
            "API (import horovod_tpu_torch as hvd) or the PyTorch "
            "frontend (import horovod_tpu_torch.torch as hvd): both "
            "provide the same DistributedOptimizer/broadcast_parameters "
            "surface.") from e


def __getattr__(name):
    # the tensor ops live in mpi_ops (importable without mxnet); resolve
    # them lazily so `hvd.allreduce_` etc. work as module attributes
    if name in ("allreduce", "allreduce_", "allgather", "broadcast",
                "broadcast_", "alltoall", "Average", "Sum", "Adasum"):
        from horovod_tpu_torch.mxnet import mpi_ops

        return getattr(mpi_ops, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class DistributedOptimizer:
    """Wrap an ``mx.optimizer.Optimizer``: every ``update`` allreduces
    the gradient (sum), with averaging folded into ``rescale_grad``
    (reference ``mxnet/__init__.py:40-77`` — dividing rescale_grad by
    the world size is equivalent to averaging and cheaper)."""

    def __init__(self, optimizer):
        _require_mx()
        from horovod_tpu_torch.mxnet import mpi_ops as _ops

        self._optimizer = optimizer
        self._ops = _ops
        self._optimizer.rescale_grad /= size()

    def __getattr__(self, item):
        return getattr(self._optimizer, item)

    def create_state_multi_precision(self, index, weight):
        return self._optimizer.create_state_multi_precision(index, weight)

    def _do_allreduce(self, index, grad):
        if size() == 1:
            return
        if isinstance(index, (tuple, list)):
            for i in range(len(index)):
                self._ops.allreduce_(grad[i], average=False,
                                     name=str(index[i]), priority=-i)
        else:
            self._ops.allreduce_(grad, average=False, name=str(index))

    def update(self, index, weight, grad, state):
        self._do_allreduce(index, grad)
        self._optimizer.update(index, weight, grad, state)

    def update_multi_precision(self, index, weight, grad, state):
        self._do_allreduce(index, grad)
        self._optimizer.update_multi_precision(index, weight, grad, state)

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def set_lr_mult(self, args_lr_mult):
        self._optimizer.set_lr_mult(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self._optimizer.set_wd_mult(args_wd_mult)


def DistributedTrainer(params, optimizer, optimizer_params=None):
    """Gluon trainer whose gradient reduction rides this framework's
    allreduce instead of a kvstore (reference
    ``mxnet/__init__.py:86-110``).  Factory function: the subclass is
    created lazily because its base is ``mx.gluon.Trainer``."""
    mx = _require_mx()
    from horovod_tpu_torch.mxnet import mpi_ops as _ops

    if isinstance(optimizer, DistributedOptimizer):
        optimizer = optimizer._optimizer
        warnings.warn("DistributedTrainer does not take "
                      "DistributedOptimizer as its optimizer. It has "
                      "been unwrapped for you.")

    class _DistributedTrainer(mx.gluon.Trainer):
        def __init__(self):
            super().__init__(params, optimizer,
                             optimizer_params=optimizer_params,
                             kvstore=None)
            # averaging folded into the step scale, as in the optimizer
            self._scale /= size()

        def _allreduce_grads(self):
            if size() == 1:
                return
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    _ops.allreduce_(param.list_grad()[0], average=False,
                                    name=param.name, priority=-i)

    return _DistributedTrainer()


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Broadcast ``Module.get_params()`` dicts or Gluon
    ``ParameterDict``s from ``root_rank`` (reference
    ``mxnet/__init__.py`` broadcast_parameters)."""
    _require_mx()
    from horovod_tpu_torch.mxnet import mpi_ops as _ops

    if isinstance(params, dict):
        tensors = sorted(params.items())
    elif hasattr(params, "items"):  # gluon ParameterDict
        tensors = []
        for name, p in sorted(params.items()):
            try:
                tensors.append((name, p.data()))
            except Exception:
                # deferred-init parameter: broadcast when initialized
                continue
    else:
        raise HorovodTpuError(
            f"Cannot broadcast parameters of type {type(params)!r}; "
            "expected a dict of NDArrays or a gluon ParameterDict.")
    for name, tensor in tensors:
        _ops.broadcast_(tensor, root_rank, name=f"param.{name}")
