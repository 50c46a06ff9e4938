"""ImageNet ResNet-50 training, the counterpart of the JAX package's
``examples/jax_imagenet_resnet50.py`` (reference
``examples/pytorch_imagenet_resnet50.py``), the canonical "real training
job" example: Goyal LR scaling (warmup to base_lr*size over 5 epochs,
/10 decay at epochs 30/60/80, arXiv:1706.02677 defaults like the
reference), allreduce-averaged train/val metrics, per-epoch rank-0
checkpointing with resume discovery + broadcast, fp16-compressed or
Adasum reduction flags, and gradient accumulation
(``--batches-per-allreduce``).

Data: ``--train-dir`` with one ``.npz`` shard per rank (keys x, y) or
``--synthetic`` (default) for generated batches.

Run::

    python -m horovod_tpu_torch.run -np 4 python -m horovod_tpu_torch.examples.jax_imagenet_resnet50 \\
        --synthetic --epochs 2 --steps-per-epoch 50
"""

import argparse
import os

import numpy as np

try:
    import horovod_tpu_torch  # noqa: F401
except ImportError:  # running by path from a source checkout
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import torch  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import checkpoint as ckpt  # noqa: E402
from horovod_tpu_torch.examples import print_kernel_launches  # noqa: E402
from horovod_tpu_torch.models import resnet as resnet_models  # noqa: E402
from horovod_tpu_torch.train_step import softmax_cross_entropy  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="ImageNet ResNet-50 on the port",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--train-dir", default=None,
                   help="dir with part.<rank>.npz shards (x, y)")
    p.add_argument("--synthetic", action="store_true", default=True,
                   help="generated data (no dataset in the image)")
    p.add_argument("--checkpoint-dir", default="./checkpoints")
    p.add_argument("--fp16-allreduce", action="store_true")
    p.add_argument("--use-adasum", action="store_true")
    p.add_argument("--batches-per-allreduce", type=int, default=1)
    # arXiv:1706.02677 defaults, like the reference
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--val-batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=90)
    p.add_argument("--base-lr", type=float, default=0.0125)
    p.add_argument("--warmup-epochs", type=float, default=5)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=5e-5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--steps-per-epoch", type=int, default=100,
                   help="synthetic-mode steps per epoch")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--model", default="ResNet50",
                   choices=["ResNet18", "ResNet34", "ResNet50",
                            "ResNet101", "ResNet152"],
                   help="ResNet variant (horovod_tpu_torch.models.resnet)")
    return p.parse_args(argv)


def make_lr_schedule(args, steps_per_epoch):
    """Goyal recipe (reference adjust_learning_rate): linear warmup from
    base_lr to base_lr*size over warmup_epochs, then step decay x0.1 at
    epochs 30/60/80.  ``schedule(step)`` is the reference's
    ``optax.linear_schedule`` and ``optax.piecewise_constant_schedule``
    evaluated in float32 as JAX evaluates them."""
    f32 = np.float32
    peak = args.base_lr * hvd.size()
    warmup_steps = max(1, int(args.warmup_epochs * steps_per_epoch))
    bounds = sorted({30 * steps_per_epoch: 0.1, 60 * steps_per_epoch: 0.1,
                     80 * steps_per_epoch: 0.1}.items())

    def warmup(step):
        frac = f32(1) - f32(min(max(step, 0), warmup_steps)) / f32(
            warmup_steps)
        return f32(args.base_lr - peak) * frac + f32(peak)

    def decay(step):
        v = f32(peak)
        for threshold, scale in bounds:
            ind = f32(max(0.0, np.sign(threshold - step)))
            v = v * ind + (f32(1) - ind) * f32(scale) * v
        return v

    def schedule(step):
        # decay is indexed by the GLOBAL step so the /10 drops land at
        # epochs 30/60/80 exactly (not shifted by the warmup length)
        return warmup(step) if step < warmup_steps else decay(step)

    return schedule


def load_data(args):
    if args.train_dir:
        with np.load(os.path.join(
                args.train_dir, f"part.{hvd.rank()}.npz")) as z:
            return z["x"], z["y"]
    rng = np.random.RandomState(args.seed + hvd.rank())
    n = args.batch_size * args.steps_per_epoch
    x = rng.rand(n, args.image_size, args.image_size, 3).astype(np.float32)
    y = rng.randint(0, args.num_classes, n).astype(np.int32)
    return x, y


def main():
    args = parse_args()
    hvd.init()
    dev = hvd.device()
    verbose = hvd.rank() == 0

    def log(s):
        if verbose:
            print(s, flush=True)

    x, y = load_data(args)
    n_val = max(args.val_batch_size, len(x) // 10)
    x, vx = x[:-n_val], x[-n_val:]
    y, vy = y[:-n_val], y[-n_val:]
    steps_per_epoch = max(1, len(x) // args.batch_size)

    model = getattr(resnet_models, args.model)(
        num_classes=args.num_classes, dtype=torch.bfloat16, device=dev,
        seed=args.seed)

    schedule = make_lr_schedule(args, steps_per_epoch)
    # optax.chain(add_decayed_weights(wd), sgd(schedule, momentum)):
    # torch's SGD adds wd * p to the gradient, then keeps the same trace
    # (t = g + momentum * t, from t = 0) and steps by -lr * t; the
    # schedule sets lr before each update.  Outside the step's graph, on
    # the eager plane, as the reference calls opt.update outside jit.
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=float(schedule(0)),
                        momentum=args.momentum, weight_decay=args.wd),
        op=hvd.Adasum if args.use_adasum else hvd.Average,
        compression=(hvd.Compression.fp16 if args.fp16_allreduce
                     else hvd.Compression.none), eager=True)
    count = 0  # optimizer updates so far: the schedule's step

    # Resume discovery + broadcast: rank 0 finds the newest checkpoint,
    # every rank restores bit-identically.
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    start_epoch = 0
    latest = ckpt.latest_step(args.checkpoint_dir)
    if latest is not None:
        state = ckpt.resync(ckpt.restore(args.checkpoint_dir, latest))
        with torch.no_grad():
            for name, t in model.named_parameters():
                t.copy_(state["params"][name])
            for name, t in model.named_buffers():
                t.copy_(state["batch_stats"][name])
        opt.load_state_dict(state["opt_state"]["sgd"])
        count = int(state["opt_state"]["count"])
        start_epoch = int(state["epoch"]) + 1
        log(f"resumed from epoch {start_epoch}")
    else:
        hvd.broadcast_parameters(model, root_rank=0)

    def metric_avg(name, value):
        """Allreduce-averaged metric (reference Metric class)."""
        return float(hvd.allreduce(torch.tensor(float(value)),
                                   op=hvd.Average, name=name))

    def batch(xs, ys, sl):
        return (torch.from_numpy(xs[sl]).to(dev),
                torch.from_numpy(ys[sl]).long().to(dev))

    accum = args.batches_per_allreduce
    steps = 0
    for epoch in range(start_epoch, args.epochs):
        model.train()
        perm = np.random.RandomState(args.seed + epoch).permutation(len(x))
        losses, accs = [], []
        for i in range(0, steps_per_epoch, accum):
            # batches-per-allreduce: accum consecutive disjoint
            # sub-batches fold into one device batch per optimizer step
            sl = perm[i * args.batch_size:(i + accum) * args.batch_size]
            if len(sl) == 0:
                continue
            bx, by = batch(x, y, sl)
            for g in opt.param_groups:
                g["lr"] = float(schedule(count))
            opt.zero_grad(set_to_none=True)
            out = model(bx)
            loss = softmax_cross_entropy(out, by)
            loss.backward()
            opt.step()
            count += 1
            steps += 1
            losses.append(float(loss.detach()))
            accs.append(float((out.detach().argmax(-1) == by).float().mean()))
        tl = metric_avg(f"train_loss.{epoch}", np.mean(losses))
        ta = metric_avg(f"train_acc.{epoch}", np.mean(accs))

        model.eval()
        vlosses, vaccs = [], []
        with torch.no_grad():
            for i in range(0, len(vx), args.val_batch_size):
                bx, by = batch(vx, vy, slice(i, i + args.val_batch_size))
                out = model(bx)
                vlosses.append(float(softmax_cross_entropy(out, by)))
                vaccs.append(float((out.argmax(-1) == by).float().mean()))
        vl = metric_avg(f"val_loss.{epoch}", np.mean(vlosses))
        va = metric_avg(f"val_acc.{epoch}", np.mean(vaccs))
        log(f"epoch {epoch}: train_loss {tl:.4f} acc {ta:.4f} | "
            f"val_loss {vl:.4f} acc {va:.4f} | "
            f"lr {float(schedule(epoch * steps_per_epoch)):.5f}")

        # rank-0 checkpoint per epoch (reference save_checkpoint)
        ckpt.save(args.checkpoint_dir,
                  {"params": dict(model.named_parameters()),
                   "batch_stats": dict(model.named_buffers()),
                   "opt_state": {"sgd": opt.state_dict(), "count": count},
                   "epoch": epoch},
                  step=epoch)
    log("done")
    print_kernel_launches(hvd.rank(), dev, steps)
    hvd.shutdown()


if __name__ == "__main__":
    main()
