"""``DistributedOptimizer`` at ZeRO stage 0, and the broadcast helpers
(counterpart of ``horovod_tpu/optim/distributed.py``).

The wrapper reduces every gradient with one grouped allreduce per dtype
group, writes the reduced gradient back to ``p.grad`` and then updates:
through the fused tail (one kernel launch per parameter,
``fused_update.fused_update_tree``) when ``HOROVOD_FUSED_UPDATE=1`` and
the wrapped optimizer is fusable, else through the wrapped optimizer's
own ``step()``.  Reduction is synchronous, inside ``step()`` (or an
explicit ``synchronize()``).

With a lossy compressor (int8, int4, top-k), ``backward_passes_per_step
== 1`` and an op other than Adasum, the wrapper keeps error feedback:
one float32 residual per parameter (``residuals``, the port's form of
the JAX package's ``_FeedbackState.residual``), zero at the start,
re-injected into the next step's gradient before the reduction.  With
accumulation (``backward_passes_per_step > 1``) a lossy compressor
reduces without feedback, as in the JAX package.
"""

from __future__ import annotations

import io
import pickle

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics as _basics
from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common.util import true_divide
from horovod_tpu_torch.ops import collectives as _coll
from horovod_tpu_torch.ops.collectives import Adasum, Average
from horovod_tpu_torch.ops import quantization as _quant
from horovod_tpu_torch.ops.compression import (Compression,
                                               active_compression,
                                               is_quantized, wire_mode)
from horovod_tpu_torch.optim import fused_update as _fused


def _resolve_compression(compression):
    return active_compression() if compression is None else compression


def allreduce_gradients(grads, op: int = Average, compression=None):
    """Allreduce a list of gradients: leaves grouped by dtype, each group
    one flat buffer and one collective (a lossy compressor fuses every
    floating leaf into one float32 buffer)."""
    return _coll.grouped_allreduce(list(grads), op=op,
                                   compression=_resolve_compression(
                                       compression))


def allreduce_gradients_with_feedback(grads, residuals, op: int = Average,
                                      compression=None):
    """Lossy gradient allreduce with error feedback: returns
    ``(reduced, new_residuals)``, lists like ``grads``.  Last step's
    ``residuals`` are added to the gradients before the reduction; the
    new ones carry this step's local compression error.
    ``compression=None`` reads the ``HOROVOD_COMPRESSION`` knob and takes
    int8 when it names a mode that is not lossy."""
    compression = _resolve_compression(compression)
    if not is_quantized(compression):
        compression = Compression.int8
    grads = list(grads)
    if not grads:
        return [], list(residuals)
    injected = _quant.apply_error_feedback(grads, residuals)
    return _coll.grouped_quantized_allreduce(
        injected, op=op, with_error=True, mode=wire_mode(compression))


class _DistributedOptimizer:
    """See :func:`DistributedOptimizer`.  Attributes not defined here
    (``param_groups``, ``state``, ``state_dict``, ...) are the wrapped
    optimizer's."""

    def __init__(self, optimizer, compression, backward_passes_per_step,
                 op, zero_stage):
        if not isinstance(optimizer, torch.optim.Optimizer):
            raise TypeError("DistributedOptimizer expects a "
                            f"torch.optim.Optimizer (got {type(optimizer)!r})")
        _config.refuse_not_ported()
        stage = int(_config.get("zero_stage") if zero_stage is None
                    else zero_stage)
        if stage != 0:
            raise NotImplementedError(
                f"zero_stage={stage} is not ported yet (ROADMAP.md Queue A "
                "item 8); only the replicated update (stage 0) runs")
        self.compression = _resolve_compression(compression)
        if is_quantized(self.compression):
            _coll._check_quantized_op(op)
        if op == Adasum:
            raise NotImplementedError(
                "op=Adasum is not ported yet (ROADMAP.md Queue A item 9)")
        self.optimizer = optimizer
        self.op = op
        self.backward_passes_per_step = int(backward_passes_per_step)
        if self.backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.fused_spec = _fused.resolve_spec(optimizer)
        self._counter = 0
        self._accum: dict = {}
        #: parameter -> float32 error-feedback residual, or None when the
        #: wrapper reduces without feedback
        self.residuals = None
        if is_quantized(self.compression) \
                and self.backward_passes_per_step == 1:
            params = [p for g in optimizer.param_groups for p in g["params"]]
            self.residuals = dict(zip(
                params, _quant.init_error_feedback(params)))

    def __getattr__(self, name):
        return getattr(self.__dict__["optimizer"], name)

    def _params(self):
        return [p for g in self.optimizer.param_groups for p in g["params"]
                if p.grad is not None]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def synchronize(self):
        """Reduce every gradient across the world in place; returns the
        parameters that have one."""
        params = self._params()
        grads = [p.grad for p in params]
        if self.residuals is None:
            reduced = allreduce_gradients(grads, op=self.op,
                                          compression=self.compression)
        else:
            reduced, new = allreduce_gradients_with_feedback(
                grads, [self.residuals[p] for p in params], op=self.op,
                compression=self.compression)
            self.residuals.update(zip(params, new))
        for p, r in zip(params, reduced):
            p.grad.copy_(r)
        return params

    @torch.no_grad()
    def _accumulate(self) -> bool:
        """backward_passes_per_step > 1: sum this pass's gradients; on
        the k-th pass put their mean in ``p.grad`` and return True
        (``_AccumulationState`` semantics: no update in between)."""
        k = self.backward_passes_per_step
        for p in self._params():
            acc = self._accum.get(p)
            self._accum[p] = p.grad.clone() if acc is None else acc.add_(
                p.grad)
        self._counter += 1
        if self._counter < k:
            return False
        for p, acc in self._accum.items():
            p.grad = true_divide(acc, k)
        self._accum = {}
        self._counter = 0
        return True

    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if self.backward_passes_per_step > 1 and not self._accumulate():
            return loss
        params = self.synchronize()
        if self.fused_spec is None:
            self.optimizer.step()
            return loss
        with torch.no_grad():
            updates = _fused.fused_update_tree(
                self.fused_spec, [p.grad for p in params],
                [self.optimizer.state[p] for p in params])
            for p, u in zip(params, updates):
                p.add_(u)
        return loss


def DistributedOptimizer(optimizer, compression=None,
                         backward_passes_per_step: int = 1,
                         op: int = Average, zero_stage: int | None = None):
    """Wrap a ``torch.optim.Optimizer`` with cross-rank gradient
    averaging (Horovod's contract).  ``compression=None`` reads the
    ``HOROVOD_COMPRESSION`` knob; ``zero_stage=None`` reads
    ``HOROVOD_ZERO_STAGE``.  With ``backward_passes_per_step=k`` the
    update runs on every k-th ``step()`` with the mean of the k
    gradients, and ``step()`` leaves the parameters unchanged in
    between."""
    return _DistributedOptimizer(optimizer, compression,
                                 backward_passes_per_step, op, zero_stage)


# ---------------------------------------------------------------------------
# Broadcast helpers
# ---------------------------------------------------------------------------


def _tensors_of(params):
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    if isinstance(params, dict):
        return list(params.values())
    out = []
    for item in params:
        out.append(item[1] if isinstance(item, tuple) else item)
    return out


def broadcast_parameters(params, root_rank: int = 0):
    """Overwrite ``params`` in place with ``root_rank``'s values, fused
    per dtype.  ``params`` is a module (its ``state_dict()``, buffers
    included), a mapping of name to tensor, or an iterable of tensors or
    ``(name, tensor)`` pairs.  Returns ``params``."""
    _coll.broadcast_(_tensors_of(params), root_rank)
    return params


def broadcast_optimizer_state(optimizer, root_rank: int = 0):
    """Overwrite the optimizer's state with ``root_rank``'s: tensors in
    place, other entries (step counts, hyperparameters) by object
    broadcast."""
    opt = getattr(optimizer, "optimizer", optimizer)
    params = [p for g in opt.param_groups for p in g["params"]]
    tensors, others = [], {}
    for i, p in enumerate(params):
        for k, v in opt.state[p].items():
            if isinstance(v, torch.Tensor):
                tensors.append(v)
            else:
                others[(i, k)] = v
    hyper = [{k: v for k, v in g.items() if k != "params"}
             for g in opt.param_groups]
    _coll.broadcast_(tensors, root_rank)
    others, hyper = broadcast_object((others, hyper), root_rank)
    for (i, k), v in others.items():
        opt.state[params[i]][k] = v
    for g, h in zip(opt.param_groups, hyper):
        g.update(h)
    return optimizer


def broadcast_object(obj, root_rank: int = 0):
    """Broadcast a picklable object from ``root_rank`` (length, then
    payload, as uint8 tensors on this rank's device)."""
    dev = _basics.device()
    if _basics.rank() == root_rank:
        buf = io.BytesIO()
        pickle.dump(obj, buf)
        payload = torch.from_numpy(
            np.frombuffer(buf.getvalue(), dtype=np.uint8).copy()).to(dev)
        length = torch.tensor([payload.numel()], dtype=torch.int64,
                              device=dev)
    else:
        payload = None
        length = torch.zeros(1, dtype=torch.int64, device=dev)
    dist.broadcast(length, src=root_rank)
    if payload is None:
        payload = torch.empty(int(length.item()), dtype=torch.uint8,
                              device=dev)
    dist.broadcast(payload, src=root_rank)
    return pickle.loads(payload.cpu().numpy().tobytes())
