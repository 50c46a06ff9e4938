"""Distributed MNIST training with the port's own API, the counterpart
of the JAX package's ``examples/jax_mnist.py``: init -> broadcast
parameters -> DistributedOptimizer train loop, one process per card.

Run::

    python -m horovod_tpu_torch.run -np 2 python -m horovod_tpu_torch.examples.jax_mnist

Uses a synthetic MNIST-shaped dataset so the example runs hermetically
(no downloads); swap ``synthetic_mnist`` for a real loader in practice.
"""

import numpy as np
import torch
import torch.nn.functional as F

try:
    import horovod_tpu_torch as hvd
except ImportError:  # running by path from a source checkout
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import horovod_tpu_torch as hvd

from horovod_tpu_torch.estimator.estimator import OptaxAdamW  # noqa: E402
from horovod_tpu_torch.examples import print_kernel_launches  # noqa: E402
from horovod_tpu_torch.models.mnist import MnistCNN  # noqa: E402


def synthetic_mnist(rank: int, n: int = 2048):
    rng = np.random.RandomState(1234 + rank)  # each rank gets its shard
    images = rng.rand(n, 28, 28, 1).astype(np.float32)
    labels = rng.randint(0, 10, n).astype(np.int64)
    return images, labels


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--steps", type=int, default=0,
                    help="cap steps per epoch (0 = full shard)")
    cli = ap.parse_args()

    hvd.init()
    dev = hvd.device()
    batch, epochs = cli.batch_size, cli.epochs

    model = MnistCNN(device=dev, seed=0)
    # every rank starts from rank 0's init
    hvd.broadcast_parameters(model, root_rank=0)

    # scale LR by world size (the reference examples do the same).  The
    # reference's optax.adam is OptaxAdamW without weight decay; the
    # update runs outside the step's graph on the eager plane
    # (eager=True: the negotiated fused allreduce, the Horovod-style
    # pipeline), as the reference calls opt.update outside jit.
    opt = hvd.DistributedOptimizer(
        OptaxAdamW(model.parameters(), 1e-3 * hvd.size(), weight_decay=0.0),
        eager=True)

    images, labels = synthetic_mnist(hvd.rank())
    steps = len(images) // batch
    if cli.steps:
        steps = min(steps, cli.steps)
    for epoch in range(epochs):
        for i in range(steps):
            sl = slice(i * batch, (i + 1) * batch)
            x = torch.from_numpy(images[sl]).to(dev)
            y = torch.from_numpy(labels[sl]).to(dev)
            opt.zero_grad(set_to_none=True)
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            loss = loss.detach()
            if i % 10 == 0 and hvd.rank() == 0:
                print(f"epoch {epoch} step {i}/{steps} "
                      f"loss {float(loss):.4f}", flush=True)
        # epoch-end metric averaging (reference MetricAverageCallback)
        avg_loss = hvd.allreduce(loss, op=hvd.Average,
                                 name="epoch_loss")
        if hvd.rank() == 0:
            print(f"epoch {epoch} mean loss across ranks: "
                  f"{float(avg_loss):.4f}", flush=True)

    print_kernel_launches(hvd.rank(), dev, epochs * steps)
    hvd.shutdown()


if __name__ == "__main__":
    main()
