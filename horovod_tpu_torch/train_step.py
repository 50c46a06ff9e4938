"""One data-parallel training step: the counterpart of ``one_step`` in
the JAX package's ``bench.py`` (forward in train mode with the
batch-statistics update, mean softmax cross-entropy on one-hot labels,
backward, ``DistributedOptimizer`` step)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from horovod_tpu_torch.common.util import resolve_device


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """``optax.softmax_cross_entropy(logits, one_hot(labels)).mean()``."""
    onehot = F.one_hot(labels, logits.shape[-1]).to(logits.dtype)
    return -(onehot * F.log_softmax(logits, dim=-1)).sum(-1).mean()


def train_step(model, optimizer, images: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """Run one step and return the (detached) loss."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss = softmax_cross_entropy(model(images), labels)
    loss.backward()
    optimizer.step()
    return loss.detach()


def synthetic_batch(batch: int, image_size: int, num_classes: int = 1000,
                    seed: int = 0, device=None):
    """The bench's synthetic batch: uniform [0, 1) NHWC float32 images
    and uniform labels from ``numpy.random.RandomState(seed)``."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    images = torch.from_numpy(
        rng.rand(batch, image_size, image_size, 3).astype(np.float32))
    labels = torch.from_numpy(
        rng.randint(0, num_classes, batch).astype(np.int64))
    return images.to(dev), labels.to(dev)
