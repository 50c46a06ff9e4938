"""Flagship transformer LM with full parallelism, the counterpart of the
JAX package's ``examples/transformer_lm.py``: tensor parallel, pipeline
parallel, sequence parallel (ring attention) and expert parallel, over
one ``make_mesh(dp, pp, tp, sp)`` of the launcher's ranks, with the
attention in kernels B8-B10 on the card.

Run (one rank per card; the world must be dp * pp * tp * sp)::

    python -m horovod_tpu_torch.run -np 8 python -m horovod_tpu_torch.examples.transformer_lm --dp 2 --tp 2 --sp 2
    python -m horovod_tpu_torch.run -np 1 python -m horovod_tpu_torch.examples.transformer_lm \\
        --dp 1 --tp 1 --sp 1 --d-model 768 --n-layers 12 --seq 1024 --batch 16

``--d-model 768`` gives the reference formula's head dim of 192.
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
    p.add_argument("--dp", type=int, default=2)
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--tp", type=int, default=2)
    p.add_argument("--sp", type=int, default=2)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--moe-every", type=int, default=0,
                   help="insert an expert-parallel MoE block every k "
                        "layers (0 = dense)")
    p.add_argument("--pp-schedule", default="gpipe",
                   choices=["gpipe", "interleaved"],
                   help="pipeline schedule when pp > 1 (interleaved = "
                        "Megatron virtual stages, ~pp-virtual-fold "
                        "smaller bubble)")
    p.add_argument("--pp-virtual", type=int, default=1,
                   help="virtual chunks per pipeline rank "
                        "(interleaved schedule)")
    args = p.parse_args()
    if args.pp_virtual > 1 and args.pp <= 1:
        raise SystemExit(
            "--pp-virtual > 1 needs --pp > 1: without pipeline ranks "
            "there is nothing to interleave (the run would just train "
            "a deeper dense model)")

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.estimator.estimator import OptaxAdamW
    from horovod_tpu_torch.examples import print_kernel_launches
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig,
                                                      init_params)
    from horovod_tpu_torch.parallel.mesh import make_mesh
    from horovod_tpu_torch.train_step import (lm_optimizer, lm_train_step,
                                              shard_tokens)

    hvd.init()
    n = args.dp * args.pp * args.tp * args.sp
    if hvd.size() != n:
        raise SystemExit(f"need {n} devices for dp*pp*tp*sp, "
                         f"have {hvd.size()}")
    dev = hvd.device()

    cfg = TransformerConfig(
        vocab=1024, d_model=args.d_model,
        n_heads=max(4, 2 * args.tp), head_dim=args.d_model // 4,
        n_layers=args.n_layers * max(1, args.pp) * args.pp_virtual,
        d_ff=4 * args.d_model, max_seq=args.seq,
        moe_every=args.moe_every, experts_per_rank=2,
        pp_microbatches=2 if args.pp > 1 else 1,
        pp_schedule=args.pp_schedule, pp_virtual=args.pp_virtual)
    mesh = make_mesh(dp=args.dp, pp=args.pp, tp=args.tp, sp=args.sp)
    lead = hvd.rank() == 0
    if lead:
        print(f"mesh: dp={args.dp} pp={args.pp} tp={args.tp} sp={args.sp} "
              f"({n} devices)", flush=True)

    # the full tree from one seed; each rank keeps its own shards
    model = Transformer(cfg, params=init_params(np.random.RandomState(0),
                                                cfg, ep=args.dp),
                        mesh=mesh, device=dev)
    # optax.adamw(3e-4), its sums over each leaf's data axes
    opt = lm_optimizer(model, OptaxAdamW(model.parameters(), 3e-4))

    rng = np.random.RandomState(1)
    c = model.coord()
    tokens, targets = (
        shard_tokens(torch.from_numpy(
            rng.randint(0, cfg.vocab, (args.batch, args.seq))).long(),
            args.dp, args.sp, c["dp"][0], c["sp"][0]).to(dev)
        for _ in range(2))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    loss = lm_train_step(model, opt, tokens, targets)
    sync()  # first step, untimed
    t0 = time.perf_counter()
    for i in range(args.steps):
        loss = lm_train_step(model, opt, tokens, targets)
        if i % 5 == 0 and lead:
            print(f"step {i} loss {float(loss):.4f}", flush=True)
    sync()
    dt = time.perf_counter() - t0
    toks = args.batch * args.seq * args.steps
    if lead:
        print(f"{toks / dt:.0f} tokens/sec ({dt / args.steps * 1000:.1f} "
              f"ms/step)", flush=True)
    print_kernel_launches(hvd.rank(), dev, 1 + args.steps)
    hvd.shutdown()


if __name__ == "__main__":
    main()
