"""Training steps: :func:`train_step`, the counterpart of ``one_step`` in
the JAX package's ``bench.py`` (forward in train mode with the
batch-statistics update, mean softmax cross-entropy on one-hot labels,
backward, ``DistributedOptimizer`` step), and :func:`lm_train_step`, the
transformer LM's step (the JAX package's ``make_train_step``; its batch
from :func:`shard_tokens`).  Their ZeRO stage-3 twins,
:func:`zero3_train_step` and :func:`zero3_lm_train_step`, run the
forward on the full parameters that ``zero3_full_params`` gathers from
the shards (``bench.py``'s ``p = hvd.zero3_full_params(p)`` inside the
loss), through ``torch.func.functional_call``; the model's buffers
(BatchNorm statistics) stay its own and update in place.

The reduction axis is the optimizer's (``DistributedOptimizer(axis_name=
...)``, default the data mesh's dp axis); the stage-3 steps take
``axis_name`` for ``zero3_full_params`` (default: the axis the shards
were cut over).  An LM built on a mesh trains through
:func:`lm_optimizer`, which sums each gradient over the data axes of its
leaf (``grad_reduce_axes`` of ``param_specs``) as the reference does;
an LM without a mesh keeps a ``DistributedOptimizer``'s average over the
world (= dp x sp of :func:`horovod_tpu_torch.parallel.mesh.
sequence_groups`)."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.common.util import resolve_device, true_divide
from horovod_tpu_torch.models.transformer import loss_fn
from horovod_tpu_torch.ops.collectives import Sum
from horovod_tpu_torch.optim.distributed import (DistributedOptimizer,
                                                 _resolve_zero_stage,
                                                 optimizer_like,
                                                 zero3_full_params)
from horovod_tpu_torch.parallel import mesh as _pmesh

#: the Queue A item that ZeRO under tensor, pipeline or expert
#: parallelism waits for
ZERO_MODEL_PARALLEL_ITEM = "ROADMAP.md Queue A item 10e"


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


def _refuse_partial_average(optimizer) -> None:
    """An LM without a mesh is whole on every rank and its loss is the
    world's average: its optimizer must average over the whole world,
    or the ranks outside its axis (the sp ranks of ``HOROVOD_MESH=dp:2,
    sp:2`` under the default dp axis) train apart with no error."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    axis = getattr(optimizer, "axis_name", None)
    span = 1 if axis is None else _pmesh.axis_total(axis)
    if span != n:
        raise HorovodTpuError(
            f"an LM without a mesh needs its gradients averaged over the "
            f"whole world ({n} ranks), but its optimizer reduces over "
            f"{span} (axis {axis!r}): build it on the data mesh "
            "(Transformer(..., mesh=hvd.data_mesh())) and train it with "
            "lm_optimizer, or give DistributedOptimizer an axis_name that "
            "spans the world")


def _refuse_zero_model_parallel(model, stage: int) -> None:
    c = model.coord()
    if stage and (c["tp"][1] > 1 or c["pp"][1] > 1 or model.moe_ids):
        raise NotImplementedError(
            f"ZeRO stage {stage} with tensor or pipeline parallelism or "
            f"MoE layers is not ported yet ({ZERO_MODEL_PARALLEL_ITEM}): "
            "the shards would cut across leaves that reduce over "
            "different axes or live on other stages")


class _LMOptimizer:
    """See :func:`lm_optimizer`.  The optimizer of an LM built on a
    mesh: one ``DistributedOptimizer`` (``op=Sum``) per group of
    parameters that reduce over the same data axes -- ``("dp", "sp")``
    for every leaf but the experts, ``("sp",)`` for the experts -- over
    that group's hop of the model's place.  The fused tail therefore
    launches once per group and dtype.  ``state`` and ``param_groups``
    span the groups."""

    def __init__(self, model, optimizer, **kwargs):
        place = model.place
        if place is None:
            raise HorovodTpuError(
                "lm_optimizer needs an LM built on a mesh (Transformer("
                "..., mesh=...)); wrap the optimizer of a model without "
                "one in DistributedOptimizer")
        for k in ("op", "axis_name"):
            if k in kwargs:
                raise TypeError(f"lm_optimizer sets {k} itself")
        _refuse_zero_model_parallel(model, _resolve_zero_stage(
            kwargs.get("zero_stage"), kwargs.get("sharded")))
        hops = {("dp", "sp"): place.data, ("sp",): place.sp}
        groups: dict = {}
        params = dict(model.named_parameters())
        for name, axes in model.reduce_axes().items():
            groups.setdefault(axes, []).append(params[name])
        self.place = place
        self.axes = list(groups)
        self.optimizers = [
            DistributedOptimizer(optimizer_like(optimizer, ps), op=Sum,
                                 axis_name=hops[axes], **kwargs)
            for axes, ps in groups.items()]
        # the groups' optimizers hold the state from here on
        optimizer.state.clear()

    @property
    def data_ranks(self) -> int:
        """Ranks of ``("dp", "sp")``: the loss's global token count is
        this times the local count."""
        return self.place.data.flat.size

    @property
    def param_groups(self) -> list:
        return [g for o in self.optimizers for g in o.param_groups]

    @property
    def state(self) -> dict:
        return {p: st for o in self.optimizers for p, st in o.state.items()}

    def state_bytes(self) -> int:
        return sum(o.state_bytes() for o in self.optimizers)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for o in self.optimizers:
            o.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        for o in self.optimizers:
            o.step()

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over ``("dp", "sp")``, outside autograd (the
        reference's ``psum`` of the loss)."""
        x = x.detach().clone()
        self.place.data.flat.all_reduce(x)
        return x


def lm_optimizer(model, optimizer, **kwargs) -> _LMOptimizer:
    """The LM's optimizer on a mesh: ``optimizer`` (built over
    ``model.parameters()``; its class and hyperparameters are copied per
    group and its own state dropped) split by reduction group, each
    group wrapped in ``DistributedOptimizer(..., op=Sum, axis_name=<the
    group's hop>, **kwargs)``: the hops of this rank's place, so at pp >
    1 or tp > 1 the ``("dp", "sp")`` group is the one at this rank's
    ``(pp, tp)`` coordinate and no gradient is summed over pp or tp.
    ZeRO stages 1-3 with tp > 1, pp > 1 or MoE layers raise
    ``NotImplementedError``."""
    return _LMOptimizer(model, optimizer, **kwargs)


def _fill_grads(model) -> None:
    """A parameter the step did not reach (the dense MLP of an MoE layer)
    gets a zero gradient, as JAX's gradient tree has one: its Adam
    moments and step count move with every other leaf's."""
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def lm_train_step(model, optimizer, tokens: torch.Tensor,
                  targets: torch.Tensor, sp_group=None) -> torch.Tensor:
    """One transformer LM step (forward, the reference's loss, backward,
    optimizer step) on this rank's rows and sequence chunk
    (:func:`shard_tokens`); returns the global loss, the reference's
    ``psum`` over ``("dp", "sp")`` (at pp > 1 this rank's own: the pp
    ranks' heads drift apart, as the reference's do).

    A model on a mesh takes an :func:`lm_optimizer`: the local loss is
    divided by the global token count and each gradient summed over its
    leaf's data axes.  A model without one takes a
    ``DistributedOptimizer`` and ``sp_group`` (a sequence group of
    :func:`~horovod_tpu_torch.parallel.mesh.sequence_groups`, or
    ``None``) and an optimizer that averages over the whole world: the
    local mean loss, averaged over the world."""
    moe = bool(model.moe_ids)
    on_mesh = isinstance(optimizer, _LMOptimizer)
    if not on_mesh and model.place is not None:
        raise HorovodTpuError(
            "an LM built on a mesh sums each gradient over its own data "
            "axes: train it with lm_optimizer(model, optimizer)")
    if not on_mesh and moe and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise HorovodTpuError(
            "MoE layers shard their experts over dp: build the LM on a "
            "mesh (Transformer(..., mesh=make_mesh(dp, ...))) and train "
            "it with lm_optimizer")
    if not on_mesh:
        _refuse_partial_average(optimizer)
    model.train()
    optimizer.zero_grad(set_to_none=True)
    logits, aux = model(tokens, sp_group, with_aux=True)
    loss = loss_fn(logits, targets, aux if moe else None,
                   optimizer.data_ranks if on_mesh else 1)
    # the backward needs the log-softmax, not the float32 logits (2 GiB
    # at the bench config): do not hold them through it
    del logits
    loss.backward()
    _fill_grads(model)
    optimizer.step()
    return optimizer.data_sum(loss) if on_mesh else world_mean(loss)


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
    parameter, gathered once and used twice) for an LM without tensor
    parallelism or MoE layers."""
    _refuse_zero_model_parallel(model, 3)
    _refuse_partial_average(optimizer)
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
