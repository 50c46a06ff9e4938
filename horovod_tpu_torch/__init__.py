"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

Horovod's core contract over ``torch.distributed`` (NCCL on CUDA, gloo on
the CPU), with the JAX package's public names::

    import horovod_tpu_torch as hvd
    hvd.init()
    opt = hvd.DistributedOptimizer(
        hvd.fused_update.sgd(model.parameters(), 0.1, momentum=0.9))

``hvd.LocalSGD`` wraps the same optimizer in the local-SGD / DiLoCo
regime over a ``(cross, local)`` axis pair.

The top-level ``allreduce``, ``allgather``, ``broadcast``,
``reducescatter`` and ``alltoall`` (with their ``_async`` and in-place
spellings, ``poll``, ``synchronize``, ``join`` and ``barrier``) are the
eager ops of the negotiated plane, as in the JAX package; the in-trace
functions are ``hvd.collectives.<name>``.  ``horovod_tpu_torch.torch`` is
the hook-driven PyTorch frontend on the eager plane.

Observability: ``hvd.metrics()`` (the metrics registry's snapshot),
``hvd.trace_step``, ``hvd.data_wait``, ``hvd.wrap_data_loader``,
``hvd.dump_flight_recorder()`` and the training-health plane
``hvd.health`` (``HOROVOD_HEALTH``; ``hvd.health.observe_loss(loss)``
feeds its sentinels); ``python -m horovod_tpu_torch.trace`` and
``python -m horovod_tpu_torch.perf goodput|health`` read the dumps.
``hvd.checkpoint`` saves, restores and resyncs training state.

Importing the package builds nothing and touches no device.
"""

from horovod_tpu_torch.common.basics import (  # noqa: F401
    cross_rank, cross_size, data_mesh, data_parallel_size, device, init,
    is_initialized, local_rank, local_size, rank, shutdown, size)
from horovod_tpu_torch.common.types import (  # noqa: F401
    HorovodTpuError, RanksDownError, StalledError)
from horovod_tpu_torch.ops import collectives  # noqa: F401  (in-trace API)
from horovod_tpu_torch.ops.collectives import (  # noqa: F401
    Adasum, Average, Sum, cross_allreduce, grouped_allreduce,
    grouped_quantized_allreduce, grouped_reducescatter,
    hierarchical_allgather, hierarchical_allreduce, local_allreduce,
    quantized_allreduce)
from horovod_tpu_torch.ops.eager import (  # noqa: F401
    allgather, allgather_async, allreduce, allreduce_, allreduce_async,
    allreduce_async_, alltoall, barrier, broadcast, broadcast_,
    broadcast_async, broadcast_async_, join, poll, reducescatter,
    reducescatter_async, synchronize)
from horovod_tpu_torch.ops.compression import Compression  # noqa: F401
from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    hierarchical_mesh, make_mesh, parse_mesh_spec)
from horovod_tpu_torch.optim import fused_update  # noqa: F401
from horovod_tpu_torch.optim.distributed import (  # noqa: F401
    DistributedOptimizer, ShardedState, Zero3Params, allreduce_gradients,
    allreduce_gradients_with_feedback, broadcast_object,
    broadcast_optimizer_state, broadcast_parameters,
    broadcast_skipping_shards, params_from_host, params_to_host,
    sharded_state_from_host, sharded_state_to_host, zero3_full_params,
    zero3_params_from_host, zero3_params_to_host, zero3_shard_params)
from horovod_tpu_torch.optim.local_sgd import (  # noqa: F401
    LocalSGD, LocalSGDOptimizer)
from horovod_tpu_torch.runtime.metrics import (  # noqa: F401
    data_wait, metrics, trace_step, wrap_data_loader)
from horovod_tpu_torch.runtime.flight import (  # noqa: F401
    dump as dump_flight_recorder)
from horovod_tpu_torch.runtime import health  # noqa: F401
from horovod_tpu_torch import checkpoint  # noqa: F401
