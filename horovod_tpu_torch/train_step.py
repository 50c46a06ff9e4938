"""Data-parallel training steps: :func:`train_step`, the counterpart of
``one_step`` in the JAX package's ``bench.py`` (forward in train mode
with the batch-statistics update, mean softmax cross-entropy on one-hot
labels, backward, ``DistributedOptimizer`` step), and
:func:`lm_train_step`, the transformer LM's step (the JAX package's
``make_train_step`` at one rank of each model axis)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from horovod_tpu_torch.common.util import resolve_device
from horovod_tpu_torch.models.transformer import loss_fn


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


def lm_train_step(model, optimizer, tokens: torch.Tensor,
                  targets: torch.Tensor) -> torch.Tensor:
    """One transformer LM step (forward, mean next-token cross entropy,
    backward, ``DistributedOptimizer`` step); returns the detached
    loss."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(model(tokens), targets)
    loss.backward()
    optimizer.step()
    return loss.detach()


def synthetic_tokens(batch: int, seq: int, vocab: int, seed: int = 1,
                     device=None):
    """The transformer bench's synthetic batch: ``(tokens, targets)``,
    each uniform in ``[0, vocab)`` of shape (batch, seq), drawn in that
    order from ``numpy.random.RandomState(seed)`` (the bench uses seed
    1)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, (batch, seq))
    targets = rng.randint(0, vocab, (batch, seq))
    return (torch.from_numpy(tokens).long().to(dev),
            torch.from_numpy(targets).long().to(dev))


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
