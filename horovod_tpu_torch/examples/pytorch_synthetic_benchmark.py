"""Synthetic benchmark for the PyTorch frontend
(``horovod_tpu_torch.torch``), the counterpart of the JAX package's
``examples/pytorch_synthetic_benchmark.py``: measures the hook-driven
eager allreduce pipeline (negotiation, fusion, response cache) rather
than the in-trace path; compare with ``jax_synthetic_benchmark.py``.

Run::

    python -m horovod_tpu_torch.run -np 2 python -m horovod_tpu_torch.examples.pytorch_synthetic_benchmark
"""

import argparse
import time

import numpy as np
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


class SmallResNet(nn.Module):
    """Compact residual CNN (torchvision isn't a dependency)."""

    def __init__(self, num_classes=1000, width=64):
        super().__init__()
        self.stem = nn.Conv2d(3, width, 7, stride=4, padding=3)
        self.blocks = nn.ModuleList()
        for i in range(4):
            c = width * (2 ** min(i, 2))
            self.blocks.append(nn.Sequential(
                nn.Conv2d(c, c, 3, padding=1), nn.BatchNorm2d(c),
                nn.ReLU(), nn.Conv2d(c, c, 3, padding=1),
                nn.BatchNorm2d(c)))
            if i < 2:
                self.blocks.append(nn.Sequential(
                    nn.Conv2d(c, 2 * c, 1, stride=2),
                    nn.BatchNorm2d(2 * c)))
        self.head = nn.Linear(width * 4, num_classes)

    def forward(self, x):
        x = self.stem(x)
        for blk in self.blocks:
            out = blk(x)
            x = F.relu(out + x) if out.shape == x.shape else F.relu(out)
        x = x.mean(dim=(2, 3))
        return self.head(x)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--num-iters", type=int, default=5)
    p.add_argument("--num-batches-per-iter", type=int, default=5)
    p.add_argument("--fp16-allreduce", action="store_true")
    args = p.parse_args()

    hvd.init()
    dev = device()
    torch.manual_seed(0)
    model = SmallResNet().to(dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    compression = (hvd.Compression.fp16 if args.fp16_allreduce
                   else hvd.Compression.none)
    optimizer = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01),
        named_parameters=model.named_parameters(),
        compression=compression)

    data = torch.rand(args.batch_size, 3, 224, 224).to(dev)
    target = torch.randint(0, 1000, (args.batch_size,)).to(dev)

    def benchmark_step():
        optimizer.zero_grad()
        F.cross_entropy(model(data), target).backward()
        optimizer.step()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def log(s):
        if hvd.rank() == 0:
            print(s, flush=True)

    log(f"Batch size: {args.batch_size}, ranks: {hvd.size()}")
    benchmark_step()  # warmup
    sync()

    img_secs = []
    for i in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            benchmark_step()
        sync()
        dt = time.perf_counter() - t0
        rate = args.batch_size * args.num_batches_per_iter / dt
        log(f"Iter #{i}: {rate:.1f} img/sec per rank")
        img_secs.append(rate)

    mean, conf = np.mean(img_secs), 1.96 * np.std(img_secs)
    log(f"Img/sec per rank: {mean:.1f} +-{conf:.1f}")
    log(f"Total img/sec on {hvd.size()} rank(s): "
        f"{mean * hvd.size():.1f} +-{conf * hvd.size():.1f}")
    print_kernel_launches(hvd.rank(), dev,
                          1 + args.num_iters * args.num_batches_per_iter)
    hvd.shutdown()


if __name__ == "__main__":
    main()
