"""TensorFlow frontend (counterpart of ``horovod_tpu/tensorflow/``).

The parity surface of reference ``horovod/tensorflow/__init__.py`` (531
LoC): tensor collectives with the sparse ``tf.IndexedSlices`` path
(``:74-89``), ``DistributedOptimizer`` overriding the gradient
computation (``:266-311``), ``DistributedGradientTape`` (``:475-531``),
``broadcast_global_variables`` / ``BroadcastGlobalVariablesHook``
(``:150-227``), build introspection.  The wire underneath is the port's
negotiated eager plane; TF tensors cross to the runtime's device through
the numpy bridge (:mod:`horovod_tpu_torch.ops.numpy_bridge`) and come
back as TF tensors.

Without TensorFlow installed, importing this module still succeeds, so
``horovod_tpu_torch.tensorflow`` can be probed (``tensorflow_built()``
is False) and the port's core API is re-exported under the same names;
the TF-tensor entry points then raise ImportError.
"""

from __future__ import annotations

try:
    import tensorflow as _tf

    _HAVE_TF = True
except ImportError:
    _tf = None
    _HAVE_TF = False

from horovod_tpu_torch import (  # noqa: F401
    Adasum,
    Average,
    Sum,
    broadcast_object,
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
from horovod_tpu_torch.torch.mpi_ops import is_homogeneous  # noqa: F401


def tensorflow_built() -> bool:
    """Whether a TensorFlow installation was found."""
    return _HAVE_TF


if _HAVE_TF:
    from horovod_tpu_torch.tensorflow.mpi_ops import (  # noqa: F401
        Compression,
        allgather,
        allgather_async,
        allreduce,
        allreduce_async,
        alltoall,
        barrier,
        broadcast,
        broadcast_async,
        poll,
        synchronize,
    )
else:  # the core API keeps the module importable and probeable
    from horovod_tpu_torch import (  # noqa: F401
        Compression,
        allgather,
        allreduce,
        alltoall,
        broadcast,
    )


def _require_tf():
    if not _HAVE_TF:
        raise ImportError(
            "horovod_tpu_torch.tensorflow requires a TensorFlow "
            "installation for TF-tensor entry points; this environment "
            "has none. The core API (horovod_tpu_torch) provides the same "
            "collectives on torch tensors.")


def _make_allreduce_grads_fn(compression, sparse_as_dense, op):
    """Reference ``_make_allreduce_grads_fn``: allreduce every gradient,
    densifying IndexedSlices first when asked (``:230-251``)."""

    def _allreduce_grads(grads):
        out = []
        for i, grad in enumerate(grads):
            if grad is None:
                out.append(None)
                continue
            if sparse_as_dense and isinstance(grad, _tf.IndexedSlices):
                grad = _tf.convert_to_tensor(grad)
            out.append(allreduce(grad, op=op,
                                 name=f"DistributedGrad.{i}",
                                 compression=compression))
        return out

    return _allreduce_grads


def DistributedGradientTape(gradtape, device_dense="", device_sparse="",
                            compression=None, sparse_as_dense=False,
                            op=Average):
    """A tape wrapping another ``tf.GradientTape`` whose ``gradient()``
    allreduces the gradients before returning them (reference
    ``tensorflow/__init__.py:475-531``).  ``device_dense`` /
    ``device_sparse`` are accepted for API compatibility; placement is
    the numpy bridge's job."""
    _require_tf()
    allreduce_grads = _make_allreduce_grads_fn(compression,
                                               sparse_as_dense, op)

    class _Wrapped:
        def __init__(self, tape):
            self._tape = tape

        def __getattr__(self, item):
            return getattr(self._tape, item)

        def __enter__(self):
            self._tape.__enter__()
            return self

        def __exit__(self, *exc):
            return self._tape.__exit__(*exc)

        def gradient(self, target, sources, output_gradients=None):
            grads = self._tape.gradient(target, sources, output_gradients)
            if size() <= 1:
                return grads
            single = not isinstance(grads, (list, tuple))
            reduced = allreduce_grads([grads] if single else list(grads))
            return reduced[0] if single else reduced

    return _Wrapped(gradtape)


def DistributedOptimizer(optimizer, name=None, use_locking=False,
                         device_dense="", device_sparse="",
                         compression=None, sparse_as_dense=False,
                         op=Average, backward_passes_per_step=1):
    """Wrap an optimizer so gradients are allreduced across ranks before
    being applied (reference ``:266-311`` for tf.compat.v1 optimizers;
    Keras optimizers are wrapped at ``apply_gradients``, matching what
    the reference's keras frontend does)."""
    _require_tf()
    if backward_passes_per_step != 1:
        raise HorovodTpuError(
            "backward_passes_per_step > 1 is not supported by the TF "
            "frontend; accumulate locally before calling the optimizer.")
    allreduce_grads = _make_allreduce_grads_fn(compression,
                                               sparse_as_dense, op)

    v1_opt = getattr(_tf.compat.v1.train, "Optimizer", None)
    if v1_opt is not None and isinstance(optimizer, v1_opt):
        # Reference shape: dynamic subclass overriding compute_gradients.
        class _DistributedOptimizer(optimizer.__class__):
            def __init__(self):  # pragma: no cover - state comes from copy
                pass

            def compute_gradients(self, *args, **kwargs):
                gradients = super().compute_gradients(*args, **kwargs)
                if size() <= 1:
                    return gradients
                grads, variables = zip(*gradients)
                return list(zip(allreduce_grads(list(grads)), variables))

        dist = _DistributedOptimizer()
        dist.__dict__.update(optimizer.__dict__)
        return dist

    # Keras (2.x and 3.x) optimizers: allreduce at apply_gradients.
    if hasattr(optimizer, "apply_gradients"):
        class _DistributedKerasOptimizer(optimizer.__class__):
            _horovod_tpu_distributed = True

            def __init__(self):  # pragma: no cover - state comes from copy
                pass

            def apply_gradients(self, grads_and_vars, *args, **kwargs):
                gv = list(grads_and_vars)
                if size() > 1 and gv:
                    grads, variables = zip(*gv)
                    gv = list(zip(allreduce_grads(list(grads)), variables))
                return super().apply_gradients(gv, *args, **kwargs)

        # Keep the wrapped class under the inner optimizer's name (the
        # reference builds the subclass with ``type(name, ...)`` for the
        # same reason): Keras serializes ``class_name`` from
        # ``cls.__name__``, so a saved model round-trips as the plain
        # optimizer and ``keras.load_model`` re-wraps it on load.
        _DistributedKerasOptimizer.__name__ = optimizer.__class__.__name__
        _DistributedKerasOptimizer.__qualname__ = \
            optimizer.__class__.__qualname__
        dist = _DistributedKerasOptimizer()
        dist.__dict__.update(optimizer.__dict__)
        return dist

    raise HorovodTpuError(
        f"Cannot wrap optimizer of type {type(optimizer)!r}: expected a "
        "tf.compat.v1.train.Optimizer or an object with apply_gradients.")


def DistributedAdasumOptimizer(optimizer, name=None, use_locking=False,
                               device_dense="", device_sparse="",
                               compression=None,
                               backward_passes_per_step=1):
    """Delta-model Adasum optimizer (reference
    ``tensorflow/__init__.py:313-407``): apply the wrapped optimizer's
    update locally, then Adasum-combine the resulting model *deltas*
    across ranks — scale-invariant combining of whole steps rather than
    gradients.  Implemented for Keras-style optimizers (eager/TF2): the
    reference's graph-session slot machinery has no counterpart here."""
    _require_tf()
    if backward_passes_per_step != 1:
        raise HorovodTpuError(
            "backward_passes_per_step > 1 is not supported; accumulate "
            "locally before calling the optimizer.")
    if not hasattr(optimizer, "apply_gradients"):
        raise HorovodTpuError(
            f"Cannot wrap optimizer of type {type(optimizer)!r}: "
            "expected an object with apply_gradients.")

    class _DistributedAdasumOptimizer(optimizer.__class__):
        _horovod_tpu_distributed = True

        def __init__(self):  # pragma: no cover - state comes from copy
            pass

        def apply_gradients(self, grads_and_vars, *args, **kwargs):
            gv = list(grads_and_vars)
            variables = [v for _, v in gv]
            starts = [_tf.identity(v) for v in variables]
            result = super().apply_gradients(gv, *args, **kwargs)
            if size() > 1:
                # async launch + synchronize: one negotiated round can
                # fuse all deltas instead of N sequential round trips
                # (same pipelining shape as broadcast_variables)
                from horovod_tpu_torch.tensorflow.mpi_ops import (
                    allreduce_async, synchronize)

                comp = compression or Compression.none
                handles, ctxs = [], []
                for i, (v, start) in enumerate(zip(variables, starts)):
                    wire, ctx = comp.compress(v - start)
                    ctxs.append(ctx)
                    handles.append(allreduce_async(
                        wire, op=Adasum, name=f"adasum_delta.{i}"))
                for v, start, hnd, ctx in zip(variables, starts,
                                              handles, ctxs):
                    v.assign(start + comp.decompress(synchronize(hnd),
                                                     ctx))
            return result

    # Serialize under the inner optimizer's name so a saved model
    # round-trips through keras.load_model (same as DistributedOptimizer).
    _DistributedAdasumOptimizer.__name__ = optimizer.__class__.__name__
    _DistributedAdasumOptimizer.__qualname__ = \
        optimizer.__class__.__qualname__
    dist = _DistributedAdasumOptimizer()
    dist.__dict__.update(optimizer.__dict__)
    return dist


def broadcast_variables(variables, root_rank: int = 0) -> None:
    """Assign every variable its ``root_rank`` value (reference
    ``broadcast_global_variables`` body, ``:150-170``)."""
    _require_tf()
    variables = list(variables)
    handles = [broadcast_async(v, root_rank, name=f"broadcast_var.{i}")
               for i, v in enumerate(variables)]
    for v, h in zip(variables, handles):
        v.assign(synchronize(h))


def broadcast_global_variables(root_rank: int = 0) -> None:
    """TF1-graph parity: broadcast every global variable (reference
    ``:150-170``).  Eager/TF2 code should pass explicit variables to
    :func:`broadcast_variables`."""
    _require_tf()
    broadcast_variables(_tf.compat.v1.global_variables(), root_rank)


class BroadcastGlobalVariablesHook:
    """SessionRunHook that broadcasts all global variables from
    ``root_rank`` at session creation (reference ``:194-227``).  In
    TF2/eager, call :func:`broadcast_variables` after building the
    model instead."""

    def __init__(self, root_rank: int = 0, device=""):
        _require_tf()
        self.root_rank = root_rank

    def begin(self):
        pass

    def after_create_session(self, session, coord):
        broadcast_global_variables(self.root_rank)

    def before_run(self, run_context):
        return None

    def after_run(self, run_context, run_values):
        pass
