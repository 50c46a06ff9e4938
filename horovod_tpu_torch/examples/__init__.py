"""Runnable training scripts on the port (the L7 layer: the counterparts
of the JAX package's ``examples/``, one file per reference script under
the same name, with the same flags, defaults and printed lines)::

    python -m horovod_tpu_torch.run -np 2 python -m horovod_tpu_torch.examples.pytorch_mnist
    python -m horovod_tpu_torch.run -np 1 python horovod_tpu_torch/examples/transformer_lm.py --dp 1 --tp 1 --sp 1

Each runs on ``hvd.device()``: the card, unless ``HOROVOD_PLATFORM=cpu``
asks for the CPU.  On the card each rank also prints, last, one line
with its hand-kernel launches (:func:`print_kernel_launches`).
"""

from __future__ import annotations

import json

#: the prefix of the per-rank launch line
LAUNCH_TAG = "kernel launches"


def kernel_launches() -> dict:
    """This process's hand-kernel launches so far, by kernel (the CPU
    runs the plain versions and counts none); kernels never launched are
    left out."""
    from horovod_tpu_torch.estimator.estimator import _launch_counts

    return {k: v for k, v in _launch_counts().items()
            if v and k != "flight_seq"}


def print_kernel_launches(rank: int, device, steps: int) -> None:
    """On the card, print ``kernel launches on rank <r> over <steps>
    steps: {json}``."""
    if device.type == "cuda":
        print(f"{LAUNCH_TAG} on rank {rank} over {steps} steps: "
              f"{json.dumps(kernel_launches(), sort_keys=True)}",
              flush=True)
