"""``horovod_tpu_torch.spark.keras``: the reference's
``horovod.spark.keras`` estimator surface (``KerasEstimator``/
``KerasModel``, ``spark/keras/estimator.py``) over the port's in-trace
estimator (counterpart of ``horovod_tpu/spark/keras.py``).

:class:`KerasEstimator` adapts :class:`horovod_tpu_torch.estimator.
JaxEstimator`: it translates the reference's Keras spellings (loss names
like ``sparse_categorical_crossentropy``, ``optimizer='adam'``,
``feature_cols``/``label_cols``) into that estimator's vocabulary and
refuses the Petastorm-only parameters rather than ignoring them.
``fit`` takes arrays or a DataFrame (materialized into the Store first,
``spark/common/util.py:360-608``, through
:mod:`horovod_tpu_torch.estimator.dataframe`).
"""

from __future__ import annotations

from horovod_tpu_torch.estimator import (  # noqa: F401
    JaxEstimator,
    JaxTrainedModel,
    LocalStore,
    Store,
)

# Keras loss spellings -> the in-trace estimator's loss vocabulary (the
# reference takes any tf.keras loss; these are the ones the rank's loop
# implements; a callable passes through untouched)
_LOSS_MAP = {
    "sparse_categorical_crossentropy": "softmax_cross_entropy",
    "categorical_crossentropy": "softmax_cross_entropy",
    "softmax_cross_entropy": "softmax_cross_entropy",
    "mse": "mse",
    "mean_squared_error": "mse",
}

# the reference estimator's parameters that belong to its
# Petastorm/Spark-executor pipeline
_UNSUPPORTED = ("sample_weight_col", "partitions_per_process",
                "shuffle_buffer_size", "transformation_fn",
                "custom_objects", "loss_weights")


class KerasEstimator(JaxEstimator):
    """The reference ``KerasEstimator``'s parameters over the in-trace
    training path (an ``nn.Module`` under the top-level
    ``DistributedOptimizer``)."""

    def __init__(self, *, model, loss="sparse_categorical_crossentropy",
                 optimizer="adam", lr: float = 1e-3, metrics=None,
                 backend=None, **kw):
        for name in _UNSUPPORTED:
            if kw.pop(name, None) is not None:
                raise NotImplementedError(
                    f"KerasEstimator({name}=...) is part of the "
                    "reference's Petastorm/Spark-executor pipeline; this "
                    "estimator materializes DataFrames on the driver "
                    "(docs/spark.md) and does not support it")
        if metrics:
            raise NotImplementedError(
                "metrics= is not implemented; training/validation loss "
                "history is always recorded (model.history / "
                "model.val_history)")
        del backend  # the reference's Spark-backend selector
        if isinstance(loss, str):
            try:
                loss = _LOSS_MAP[loss]
            except KeyError:
                raise ValueError(
                    f"unsupported loss {loss!r}; one of "
                    f"{sorted(_LOSS_MAP)} or a callable") from None
        super().__init__(model=model, loss=loss, lr=lr,
                         optimizer=optimizer, **kw)


KerasModel = JaxTrainedModel
