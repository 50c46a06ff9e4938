"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

Horovod's core contract over ``torch.distributed`` (NCCL on CUDA, gloo on
the CPU), with the JAX package's public names::

    import horovod_tpu_torch as hvd
    hvd.init()
    opt = hvd.DistributedOptimizer(
        hvd.fused_update.sgd(model.parameters(), 0.1, momentum=0.9))

Importing the package builds nothing and touches no device.
"""

from horovod_tpu_torch.common.basics import (  # noqa: F401
    cross_rank, cross_size, device, init, is_initialized, local_rank,
    local_size, rank, shutdown, size)
from horovod_tpu_torch.common.types import HorovodTpuError  # noqa: F401
from horovod_tpu_torch.ops.collectives import (  # noqa: F401
    Adasum, Average, Sum, allgather, allreduce, alltoall, broadcast,
    grouped_allreduce, grouped_quantized_allreduce, grouped_reducescatter,
    quantized_allreduce, reducescatter)
from horovod_tpu_torch.ops.compression import Compression  # noqa: F401
from horovod_tpu_torch.optim import fused_update  # noqa: F401
from horovod_tpu_torch.optim.distributed import (  # noqa: F401
    DistributedOptimizer, allreduce_gradients,
    allreduce_gradients_with_feedback, broadcast_object,
    broadcast_optimizer_state, broadcast_parameters)
