"""Keras-style high-level API (counterpart of ``horovod_tpu/keras/``;
reference ``horovod/keras/__init__.py`` and ``horovod/_keras/``):
``DistributedOptimizer`` (the top-level one: a torch optimizer is the
substrate, so no separate Keras wrapping is needed) and the callbacks
for explicit training loops (:mod:`horovod_tpu_torch.keras.callbacks`).
"""

from horovod_tpu_torch.keras.callbacks import (  # noqa: F401
    BroadcastGlobalVariablesCallback,
    Callback,
    CallbackList,
    LearningRateScheduleCallback,
    LearningRateWarmupCallback,
    MetricAverageCallback,
    TrainingState,
    find_hyperparams,
)
from horovod_tpu_torch.optim.distributed import (  # noqa: F401
    DistributedOptimizer,
    broadcast_parameters,
)
from horovod_tpu_torch.ops.compression import Compression  # noqa: F401
from horovod_tpu_torch.common.basics import (  # noqa: F401
    init,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)
from horovod_tpu_torch.ops.eager import (  # noqa: F401
    allgather,
    allreduce,
    broadcast,
)


def broadcast_global_variables(variables, root_rank: int = 0):
    """The JAX package's ``broadcast_global_variables``: broadcast a
    module's state (or a mapping or list of tensors) from ``root_rank``
    in place."""
    return broadcast_parameters(variables, root_rank)


def load_model(filepath, custom_optimizers=None, custom_objects=None,
               compression=None):
    """Reference ``keras/__init__.py:117``: load a saved Keras model with
    its optimizer re-wrapped for distributed retraining.  Keras
    serialization is a tf.keras feature, so this delegates to
    :func:`horovod_tpu_torch.tensorflow.keras.load_model` (a torch
    model's state goes through :mod:`horovod_tpu_torch.checkpoint`)."""
    try:
        from horovod_tpu_torch.tensorflow.keras import load_model as _lm
    except ImportError as e:
        raise ImportError(
            "load_model needs tensorflow (keras serialization); for "
            "torch state use horovod_tpu_torch.checkpoint.") from e
    return _lm(filepath, custom_optimizers=custom_optimizers,
               custom_objects=custom_objects, compression=compression)
