"""Synthetic-data throughput benchmark, the counterpart of the JAX
package's ``examples/jax_synthetic_benchmark.py`` (the reference's
headline benchmark workload): ResNet-50 forward+backward+update on
random ImageNet-shaped batches, reporting img/sec per device (mean ±
1.96σ) and aggregate.

Run::

    python -m horovod_tpu_torch.run -np 4 python -m horovod_tpu_torch.examples.jax_synthetic_benchmark
    python -m horovod_tpu_torch.run -np 1 python -m horovod_tpu_torch.examples.jax_synthetic_benchmark --model ResNet50 --batch-size 64

The train step is the port's in-trace data-parallel path
(``horovod_tpu_torch.train_step.train_step``): the DistributedOptimizer's
collective over the world inside the step.
"""

try:
    import horovod_tpu_torch  # noqa: F401
except ImportError:  # running by path from a source checkout
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import argparse
import time

import numpy as np


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="ResNet50")
    p.add_argument("--batch-size", type=int, default=64,
                   help="per-device batch")
    p.add_argument("--num-iters", type=int, default=10)
    p.add_argument("--num-batches-per-iter", type=int, default=10)
    p.add_argument("--num-warmup-batches", type=int, default=3)
    p.add_argument("--fp16-allreduce", action="store_true")
    args = p.parse_args()

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import print_kernel_launches
    from horovod_tpu_torch.models import inception, mnist, resnet, vgg
    from horovod_tpu_torch.train_step import train_step

    hvd.init()
    n = hvd.size()
    dev = hvd.device()
    registry = {
        "ResNet18": resnet.ResNet18, "ResNet34": resnet.ResNet34,
        "ResNet50": resnet.ResNet50, "ResNet101": resnet.ResNet101,
        "ResNet152": resnet.ResNet152,
        "VGG11": vgg.VGG11, "VGG13": vgg.VGG13, "VGG16": vgg.VGG16,
        "VGG19": vgg.VGG19,
        "InceptionV3": inception.InceptionV3,
        # CPU-smoke stand-in, like the reference tf2 bench's SmallCNN
        "SmallCNN": mnist.SmallCNN,
    }
    if args.model not in registry:
        raise SystemExit(f"unknown model {args.model}; choose from "
                         f"{sorted(registry)}")
    model = registry[args.model](num_classes=1000, dtype=torch.bfloat16,
                                 device=dev)
    side = {"InceptionV3": 299, "SmallCNN": 96}.get(args.model, 224)
    # every rank starts from rank 0's weights
    hvd.broadcast_parameters(model, root_rank=0)

    compression = (hvd.Compression.fp16 if args.fp16_allreduce
                   else hvd.Compression.none)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.01),
                                   op=hvd.Average, compression=compression)

    # the global batch from RandomState(0); this rank's rows, as the
    # reference's P("hvd") places them
    shape = (args.batch_size * n, side, side, 3)
    rng_np = np.random.RandomState(0)
    rows = slice(hvd.rank() * args.batch_size,
                 (hvd.rank() + 1) * args.batch_size)
    images = torch.from_numpy(
        rng_np.rand(*shape).astype(np.float32)[rows]).to(dev)
    labels = torch.from_numpy(
        rng_np.randint(0, 1000, shape[0])[rows]).long().to(dev)

    def log(msg):
        if hvd.rank() == 0:
            print(msg, flush=True)

    log(f"Model: {args.model}")
    log(f"Batch size: {args.batch_size} per device, {n} device(s)")

    for _ in range(args.num_warmup_batches):
        loss = train_step(model, opt, images, labels)
    float(loss)  # host sync = real completion barrier

    img_secs = []
    for i in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            loss = train_step(model, opt, images, labels)
        float(loss)
        dt = time.perf_counter() - t0
        rate = shape[0] * args.num_batches_per_iter / dt / n
        log(f"Iter #{i}: {rate:.1f} img/sec per device")
        img_secs.append(rate)

    mean, conf = np.mean(img_secs), 1.96 * np.std(img_secs)
    log(f"Img/sec per device: {mean:.1f} +-{conf:.1f}")
    log(f"Total img/sec on {n} device(s): "
        f"{mean * n:.1f} +-{conf * n:.1f}")
    print_kernel_launches(hvd.rank(), dev, args.num_warmup_batches
                          + args.num_iters * args.num_batches_per_iter)
    hvd.shutdown()


if __name__ == "__main__":
    main()
