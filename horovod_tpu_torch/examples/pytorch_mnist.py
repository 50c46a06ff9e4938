"""Distributed MNIST training with the PyTorch frontend
(``horovod_tpu_torch.torch``), the counterpart of the JAX package's
``examples/pytorch_mnist.py``: per-parameter gradient hooks fire async
allreduces during backward; ``opt.step()`` synchronizes.

Run::

    python -m horovod_tpu_torch.run -np 2 python -m horovod_tpu_torch.examples.pytorch_mnist

Synthetic MNIST-shaped data keeps the example hermetic (no downloads).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

try:
    import horovod_tpu_torch  # noqa: F401
except ImportError:  # running by path from a source checkout
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import horovod_tpu_torch.torch as hvd  # noqa: E402
from horovod_tpu_torch import device  # noqa: E402
from horovod_tpu_torch.examples import print_kernel_launches  # noqa: E402


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 32, 3, 1)
        self.conv2 = nn.Conv2d(32, 64, 3, 1)
        self.fc1 = nn.Linear(9216, 128)
        self.fc2 = nn.Linear(128, 10)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.max_pool2d(F.relu(self.conv2(x)), 2)
        x = torch.flatten(x, 1)
        return self.fc2(F.relu(self.fc1(x)))


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20)
    cli = ap.parse_args()

    hvd.init()
    dev = device()
    torch.manual_seed(42)
    batch, epochs = cli.batch_size, cli.epochs

    model = Net().to(dev)
    # sync initial weights, then wrap the optimizer with gradient hooks
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    optimizer = torch.optim.SGD(model.parameters(),
                                lr=0.01 * hvd.size(), momentum=0.5)
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        compression=hvd.Compression.fp16)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

    # the batches are drawn on the host, so the CPU and the card see the
    # same numbers
    gen = torch.Generator().manual_seed(1234 + hvd.rank())
    for epoch in range(epochs):
        for step in range(cli.steps):
            data = torch.rand(batch, 1, 28, 28, generator=gen).to(dev)
            target = torch.randint(0, 10, (batch,), generator=gen).to(dev)
            optimizer.zero_grad()
            loss = F.cross_entropy(model(data), target)
            loss.backward()          # hooks launch async allreduces here
            optimizer.step()         # waits for all handles, then updates
            if step % 10 == 0 and hvd.rank() == 0:
                print(f"epoch {epoch} step {step} "
                      f"loss {loss.item():.4f}", flush=True)
        avg = hvd.allreduce(loss.detach(), op=hvd.Average,
                            name=f"epoch_loss.{epoch}")
        if hvd.rank() == 0:
            print(f"epoch {epoch} mean loss across ranks: "
                  f"{avg.item():.4f}", flush=True)

    print_kernel_launches(hvd.rank(), dev, epochs * cli.steps)
    hvd.shutdown()


if __name__ == "__main__":
    main()
