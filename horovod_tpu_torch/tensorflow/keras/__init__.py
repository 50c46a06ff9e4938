"""``horovod_tpu_torch.tensorflow.keras``: tf.keras integration
(counterpart of ``horovod_tpu/tensorflow/keras/``).

The parity surface of reference ``horovod/tensorflow/keras/__init__.py``:
``DistributedOptimizer`` for tf.keras optimizers (gradients all-reduced
before ``apply_gradients``), the callback trio
(``BroadcastGlobalVariablesCallback`` / ``MetricAverageCallback`` /
``LearningRateWarmupCallback``) and the core basics under their usual
names.  Eager/TF2 first: the reference's graph-session branches
(``_keras/callbacks.py``, the ``backend.get_session`` paths) have no
counterpart; Keras 3 runs eagerly or under ``tf.function``.
"""

from __future__ import annotations

import tensorflow as tf

from horovod_tpu_torch import (  # noqa: F401
    init,
    join,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)
from horovod_tpu_torch.tensorflow import (  # noqa: F401
    Average,
    Compression,
    DistributedOptimizer,
    Sum,
    allgather,
    allreduce,
    broadcast,
    broadcast_variables,
)

from horovod_tpu_torch.tensorflow.keras import callbacks  # noqa: E402,F401

BroadcastGlobalVariablesCallback = callbacks.BroadcastGlobalVariablesCallback
MetricAverageCallback = callbacks.MetricAverageCallback
LearningRateWarmupCallback = callbacks.LearningRateWarmupCallback
LearningRateScheduleCallback = callbacks.LearningRateScheduleCallback


def load_model(filepath, custom_optimizers=None, custom_objects=None,
               compression=None):
    """Load a saved tf.keras model with its optimizer re-wrapped in
    :func:`DistributedOptimizer` (reference
    ``keras/__init__.py:117-150`` + ``_keras/__init__.py:112-131``).

    The saved optimizer state (hyperparameters, slot variables) is
    restored into the wrapped optimizer so retraining continues
    distributed.  All built-in ``tf.keras.optimizers`` classes are
    recognised automatically; pass ``custom_optimizers`` (a list of
    Optimizer subclasses) for user-defined ones, and ``custom_objects``
    for any other custom layers/objects (these take precedence).
    """
    # Keras 3 resolves built-in classes from the recorded module path
    # *before* consulting custom_objects, so the reference's trick of
    # shadowing every optimizer name in custom_objects cannot intercept
    # deserialization.  Equivalent-and-robust here: load the model (the
    # optimizer state deserializes into a plain optimizer), then wrap
    # that optimizer in-place — DistributedOptimizer copies the inner
    # optimizer's __dict__, so restored hyperparameters and slot
    # variables carry over.
    base = tf.keras.optimizers.Optimizer
    objects = {}
    for attr in dir(tf.keras.optimizers):
        cls = getattr(tf.keras.optimizers, attr, None)
        if (isinstance(cls, type) and issubclass(cls, base)
                and cls is not base):
            # Name-based fallback: a model saved *with* a wrapped
            # optimizer records our module path, which fails the import
            # probe; keras then matches the bare class name here.
            objects.setdefault(cls.__name__, cls)
    if custom_optimizers is not None:
        objects.update({cls.__name__: cls for cls in custom_optimizers})
    if custom_objects is not None:
        objects.update(custom_objects)

    model = tf.keras.models.load_model(filepath, custom_objects=objects)
    optimizer = getattr(model, "optimizer", None)
    if optimizer is not None and not getattr(
            optimizer, "_horovod_tpu_distributed", False):
        model.optimizer = DistributedOptimizer(optimizer,
                                               compression=compression)
    return model
