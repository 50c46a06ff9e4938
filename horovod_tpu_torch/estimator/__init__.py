"""Estimator subsystem (counterpart of ``horovod_tpu/estimator/``): the
reference's Spark Estimator/Store shape (SURVEY.md §2.5) without the
Spark dependency.  Data is materialized into a :class:`Store`, training
runs through the launcher's run-function mode, checkpoints are kept per
run id, and a trained model comes back for inference.
:mod:`horovod_tpu_torch.spark` layers the Spark wiring on top when
pyspark is available.
"""

from horovod_tpu_torch.estimator.estimator import (  # noqa: F401
    EstimatorBase,
    JaxEstimator,
    JaxTrainedModel,
    TorchEstimator,
    TorchTrainedModel,
)
from horovod_tpu_torch.estimator.store import (  # noqa: F401
    KVStore,
    LocalStore,
    Store,
)
