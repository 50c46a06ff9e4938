"""Data-parallel training steps: :func:`train_step`, the counterpart of
``one_step`` in the JAX package's ``bench.py`` (forward in train mode
with the batch-statistics update, mean softmax cross-entropy on one-hot
labels, backward, ``DistributedOptimizer`` step), and
:func:`lm_train_step`, the transformer LM's step (the JAX package's
``make_train_step`` at world = dp x sp, with ``tp = pp = 1``; its batch
from :func:`shard_tokens`).  Their ZeRO
stage-3 twins, :func:`zero3_train_step` and :func:`zero3_lm_train_step`,
run the forward on the full parameters that ``zero3_full_params``
gathers from the shards (``bench.py``'s ``p = hvd.zero3_full_params(p)``
inside the loss), through ``torch.func.functional_call``; the model's
buffers (BatchNorm statistics) stay its own and update in place.

The reduction axis is the optimizer's (``DistributedOptimizer(axis_name=
...)``, default the data mesh's dp axis); the stage-3 steps take
``axis_name`` for ``zero3_full_params`` (default: the axis the shards
were cut over).  The LM steps keep the world reduction of their loss:
their ``("dp", "sp")`` reduction arrives with tensor parallelism."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.common.util import resolve_device, true_divide
from horovod_tpu_torch.models.transformer import loss_fn
from horovod_tpu_torch.optim.distributed import zero3_full_params


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


def world_mean(x: torch.Tensor) -> torch.Tensor:
    """The average of ``x`` over the world (``x`` itself at world 1),
    outside autograd."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n == 1:
        return x.detach()
    x = x.detach().clone()
    dist.all_reduce(x)
    return true_divide(x, n)


def lm_train_step(model, optimizer, tokens: torch.Tensor,
                  targets: torch.Tensor, sp_group=None) -> torch.Tensor:
    """One transformer LM step (forward, mean next-token cross entropy,
    backward, ``DistributedOptimizer`` step) on this rank's rows and
    sequence chunk (:func:`shard_tokens`) of a sequence sharded over
    ``sp_group``; returns the global loss, the world average of the local
    losses (the reference's ``psum`` over ``("dp", "sp")``)."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(model(tokens, sp_group), targets)
    loss.backward()
    optimizer.step()
    return world_mean(loss)


def shard_tokens(x: torch.Tensor, dp: int, sp: int, d: int,
                 s: int) -> torch.Tensor:
    """Rank ``(d, s)``'s block of a global (B, L) batch, as the
    reference's ``P("dp", "sp")`` places it: rows ``[d*B/dp,
    (d+1)*B/dp)`` and tokens ``[s*L/sp, (s+1)*L/sp)``."""
    b, l_ = x.shape
    if b % dp or l_ % sp:
        raise HorovodTpuError(
            f"a ({b}, {l_}) batch does not split over dp={dp}, sp={sp}")
    rb, rl = b // dp, l_ // sp
    return x[d * rb:(d + 1) * rb, s * rl:(s + 1) * rl].contiguous()


def zero3_train_step(model, zp, optimizer, images: torch.Tensor,
                     labels: torch.Tensor, axis_name=None) -> torch.Tensor:
    """:func:`train_step` at ZeRO stage 3: ``zp`` is the model's
    ``Zero3Params`` and ``optimizer`` the stage-3
    ``DistributedOptimizer`` over its shards."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    full = zero3_full_params(zp, axis_name=axis_name)
    logits = torch.func.functional_call(model, full, (images,))
    loss = softmax_cross_entropy(logits, labels)
    loss.backward()
    optimizer.step()
    return loss.detach()


def zero3_lm_train_step(model, zp, optimizer, tokens: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """:func:`lm_train_step` at ZeRO stage 3 (the tied embedding is one
    parameter, gathered once and used twice)."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    full = zero3_full_params(zp)
    loss = loss_fn(torch.func.functional_call(model, full, (tokens,)),
                   targets)
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
