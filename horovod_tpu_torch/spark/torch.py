"""``horovod_tpu_torch.spark.torch``: the reference's
``horovod.spark.torch`` estimator surface (``TorchEstimator``/
``TorchModel``, ``spark/torch/estimator.py``) over the port's torch
estimator (counterpart of ``horovod_tpu/spark/torch.py``).

:class:`TorchEstimator` maps the reference's parameter spellings
(``loss`` for ``loss_fn``, the optimizer by name) onto
:class:`horovod_tpu_torch.estimator.TorchEstimator` and refuses the
Petastorm-only parameters.  ``fit`` takes arrays or a DataFrame with
``feature_cols``/``label_cols`` (materialized into the Store first,
``spark/common/util.py:360-608``).
"""

from __future__ import annotations

from horovod_tpu_torch.estimator import \
    TorchEstimator as _BaseTorchEstimator
from horovod_tpu_torch.estimator import (  # noqa: F401
    LocalStore,
    Store,
    TorchTrainedModel,
)

_UNSUPPORTED = ("sample_weight_col", "partitions_per_process",
                "shuffle_buffer_size", "transformation_fn",
                "input_shapes", "loss_weights")


class TorchEstimator(_BaseTorchEstimator):
    """The reference ``TorchEstimator``'s parameters over the port's
    torch training path."""

    def __init__(self, *, model, loss=None, loss_fn=None,
                 optimizer="adam", lr: float = 1e-3, metrics=None,
                 backend=None, **kw):
        for name in _UNSUPPORTED:
            if kw.pop(name, None) is not None:
                raise NotImplementedError(
                    f"TorchEstimator({name}=...) is part of the "
                    "reference's Petastorm/Spark-executor pipeline; this "
                    "estimator materializes DataFrames on the driver "
                    "(docs/spark.md) and does not support it")
        if metrics:
            raise NotImplementedError(
                "metrics= is not implemented; training/validation loss "
                "history is always recorded")
        del backend
        super().__init__(model=model, loss_fn=loss_fn or loss, lr=lr,
                         optimizer=optimizer, **kw)


TorchModel = TorchTrainedModel
