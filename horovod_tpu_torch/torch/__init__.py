"""The PyTorch frontend on the eager plane (counterpart of
``horovod_tpu/torch/__init__.py``; reference ``horovod/torch/
__init__.py``)::

    import horovod_tpu_torch.torch as hvd
    hvd.init()
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

A gradient hook on each parameter fires an async in-place allreduce as
soon as its gradient is accumulated (reference ``torch/__init__.py:
127-162``); ``optimizer.step()`` synchronizes every handle before the
update (``:203-214``).  The collectives go through the negotiated eager
plane (fusion, response cache) over its own process group, so one step
should not also run the in-trace collectives of ``horovod_tpu_torch``
on its gradients.
"""

from __future__ import annotations

import pickle

import torch

from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.torch.compression import Compression  # noqa: F401
from horovod_tpu_torch.torch.mpi_ops import (  # noqa: F401
    Adasum,
    Average,
    Sum,
    allgather,
    allgather_async,
    allreduce,
    allreduce_,
    allreduce_async,
    allreduce_async_,
    alltoall,
    barrier,
    broadcast,
    broadcast_,
    broadcast_async,
    broadcast_async_,
    ccl_built,
    ddl_built,
    gloo_built,
    gloo_enabled,
    init,
    is_homogeneous,
    join,
    local_rank,
    local_size,
    mpi_built,
    mpi_enabled,
    mpi_threads_supported,
    nccl_built,
    poll,
    rank,
    shutdown,
    size,
    synchronize,
    wait_and_clear,
)


class _DistributedOptimizer(torch.optim.Optimizer):
    """Mixin applied over the wrapped optimizer's class (reference
    class-swap construction, ``torch/__init__.py:66``)."""

    def __init__(self, params, named_parameters, compression,
                 backward_passes_per_step=1, op=Average):
        super(self.__class__, self).__init__(params)
        self._compression = compression
        self.op = op
        self.backward_passes_per_step = backward_passes_per_step

        if named_parameters is not None:
            named_parameters = list(named_parameters)
        else:
            named_parameters = [
                (f"allreduce.noname.{i}.{j}", v)
                for i, group in enumerate(self.param_groups)
                for j, v in enumerate(group["params"])]
        # names must be unique and cover every trainable parameter
        # (reference validation, ``torch/__init__.py:80-103``)
        all_names = [n for n, _ in named_parameters]
        if len(set(all_names)) != len(all_names):
            raise ValueError(
                "named_parameters should consist of unique names")
        all_params = {id(v) for _, v in named_parameters}
        for group in self.param_groups:
            for p in group["params"]:
                if p.requires_grad and id(p) not in all_params:
                    raise ValueError(
                        "named_parameters was specified, but one or more "
                        "model parameters were not named")
        self._parameter_names = {id(v): k for k, v in named_parameters}
        self._handles: dict = {}
        self._requires_update: set = set()
        self._allreduce_delay: dict = {}
        if size() > 1:
            self._register_hooks()

    # -- hooks ------------------------------------------------------------

    def _register_hooks(self) -> None:
        for group in self.param_groups:
            for p in group["params"]:
                if not p.requires_grad:
                    continue
                self._requires_update.add(p)
                self._allreduce_delay[p] = self.backward_passes_per_step
                p.register_post_accumulate_grad_hook(self._make_hook(p))

    def _make_hook(self, p):
        def hook(param):
            self._hook_body(p)
        return hook

    def _hook_body(self, p) -> None:
        delay = self._allreduce_delay[p]
        if delay <= 0:
            raise AssertionError(
                "Gradients were computed more than "
                "backward_passes_per_step times before call to "
                "step(). Increase backward_passes_per_step to "
                "accumulate gradients locally.")
        self._allreduce_delay[p] = delay - 1
        if delay == 1:
            self._handles[p] = self._allreduce_grad_async(p)

    def _allreduce_grad_async(self, p) -> int:
        name = self._parameter_names.get(id(p))
        return allreduce_async_(p.grad, name=name and f"allreduce.{name}",
                                op=self.op, compression=self._compression)

    # -- public surface ----------------------------------------------------

    def synchronize(self) -> None:
        """Wait for every outstanding gradient allreduce (reference
        ``torch/__init__.py:164-181``); a parameter whose hook did not
        fire this step is reduced now, zeros if it has no gradient."""
        missing = [p for p in self._requires_update
                   if p not in self._handles]
        for p in missing:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            self._handles[p] = self._allreduce_grad_async(p)
        for p, handle in list(self._handles.items()):
            synchronize(handle)
            self._allreduce_delay[p] = self.backward_passes_per_step
        self._handles.clear()

    def step(self, closure=None):
        if size() > 1:
            self.synchronize()
        return super(self.__class__, self).step(closure)

    def zero_grad(self, *args, **kwargs):
        if self._handles:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() "
                "but before optimizer.step() or optimizer.synchronize(). "
                "This is prohibited as it can cause a race condition.")
        return super(self.__class__, self).zero_grad(*args, **kwargs)


class _DistributedAdasumOptimizer(torch.optim.Optimizer):
    """Adasum: apply the local update, Adasum-combine the resulting
    delta, re-apply the combined delta (reference delta-model
    formulation, ``torch/__init__.py:224-392``)."""

    def __init__(self, params, named_parameters, compression,
                 backward_passes_per_step=1):
        super(self.__class__, self).__init__(params)
        self._compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        named_parameters = (list(named_parameters)
                            if named_parameters is not None else [])
        self._parameter_names = {id(v): k for k, v in named_parameters}

    def step(self, closure=None):
        starts = {}
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    starts[p] = p.data.clone()
        loss = super(self.__class__, self).step(closure)
        if size() > 1:
            handles = []
            for p, start in starts.items():
                delta = p.data - start
                name = self._parameter_names.get(id(p))
                h = allreduce_async(delta, name=name and f"adasum.{name}",
                                    op=Adasum,
                                    compression=self._compression)
                handles.append((p, start, h))
            for p, start, h in handles:
                p.data.copy_(start + synchronize(h))
        return loss


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step=1, op=Average):
    """Wrap a torch optimizer for data-parallel training on the eager
    plane (reference ``torch/__init__.py:395-448``)."""
    if op != Adasum:
        cls = type(optimizer.__class__.__name__,
                   (optimizer.__class__,),
                   dict(_DistributedOptimizer.__dict__))
        return cls(optimizer.param_groups, named_parameters,
                   compression, backward_passes_per_step, op)
    cls = type(optimizer.__class__.__name__,
               (optimizer.__class__,),
               dict(_DistributedAdasumOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression,
               backward_passes_per_step)


# ---------------------------------------------------------------------------
# Parameter / optimizer-state / object broadcast
# ---------------------------------------------------------------------------


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Broadcast a ``state_dict()`` or an iterable of ``(name, tensor)``
    from ``root_rank`` in place (reference ``torch/__init__.py:451-481``)."""
    if isinstance(params, dict):
        params = sorted(params.items())
    elif not isinstance(params, list):
        params = list(params)
    handles = []
    for name, p in params:
        if p is None or not torch.is_tensor(p):
            continue
        handles.append(broadcast_async_(p, root_rank,
                                        name=f"broadcast.{name}"))
    for h in handles:
        synchronize(h)


def broadcast_optimizer_state(optimizer, root_rank: int = 0) -> None:
    """Broadcast optimizer state from ``root_rank`` in place (reference
    ``torch/__init__.py:483-604``): tensor state rides the tensor wire;
    Python scalars ride as float64 tensors and are cast back to their
    type; each param_groups option travels under its own name."""
    if isinstance(optimizer, torch.optim.LBFGS):
        raise ValueError(
            "cannot broadcast torch.optim.LBFGS state")
    state_dict = optimizer.state_dict()
    if len(state_dict["state"]) == 0:
        # materialize the state with a step on zero gradients; that step
        # is not a no-op (weight decay), so parameters are restored
        snapshot = []
        for group in optimizer.param_groups:
            for p in group["params"]:
                snapshot.append((p, p.data.clone()))
                if p.requires_grad and p.grad is None:
                    p.grad = torch.zeros_like(p)
        optimizer.step()
        for p, saved in snapshot:
            p.data.copy_(saved)
        state_dict = optimizer.state_dict()

    callbacks = []
    handles = []

    def _wrap_scalar(container, key, value, name):
        t = torch.tensor([float(value)], dtype=torch.float64)
        handles.append(broadcast_async_(t, root_rank, name=name))
        caster = type(value)
        callbacks.append(
            lambda: container.__setitem__(key, caster(t.item())))

    for pid, pstate in sorted(state_dict["state"].items(),
                              key=lambda kv: str(kv[0])):
        for key, value in sorted(pstate.items()):
            name = f"optimizer.state.{pid}.{key}"
            if torch.is_tensor(value):
                handles.append(broadcast_async_(value, root_rank,
                                                name=name))
            elif isinstance(value, (int, float, bool)):
                _wrap_scalar(pstate, key, value, name)
    for gi, group in enumerate(state_dict["param_groups"]):
        for key, value in sorted(group.items()):
            if key == "params":
                continue
            name = f"optimizer.group.{gi}.{key}"
            if isinstance(value, (int, float, bool)):
                _wrap_scalar(group, key, value, name)
            elif isinstance(value, (list, tuple)) and all(
                    isinstance(v, (int, float, bool)) for v in value):
                seq_t = torch.tensor([float(v) for v in value],
                                     dtype=torch.float64)
                handles.append(broadcast_async_(seq_t, root_rank,
                                                name=name))
                kinds = [type(v) for v in value]
                container = type(value)

                def _restore(group=group, key=key, seq_t=seq_t,
                             kinds=kinds, container=container):
                    group[key] = container(
                        k(x) for k, x in zip(kinds, seq_t.tolist()))
                callbacks.append(_restore)
    for h in handles:
        synchronize(h)
    for cb in callbacks:
        cb()
    optimizer.load_state_dict(state_dict)


def broadcast_object(obj, root_rank: int = 0, name=None):
    """Broadcast a picklable object (reference ``torch/__init__.py:
    607-647``): its pickle as a byte tensor, length first."""
    name = name or "broadcast_object"
    if rank() == root_rank:
        payload = torch.frombuffer(
            bytearray(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)),
            dtype=torch.uint8)
        # an int64 length: a pickle of 2 GiB or more fits the header
        length = torch.tensor([payload.numel()], dtype=torch.int64)
    else:
        length = torch.tensor([0], dtype=torch.int64)
    length = broadcast_(length, root_rank, name=f"{name}.sz")
    if rank() == root_rank:
        t = payload
    else:
        t = torch.zeros(int(length.item()), dtype=torch.uint8)
    t = broadcast_(t, root_rank, name=f"{name}.data")
    if rank() != root_rank:
        obj = pickle.loads(t.numpy().tobytes())
    return obj


def broadcast_optimizer_state_async(*a, **k):  # pragma: no cover
    raise HorovodTpuError(
        "broadcast_optimizer_state is synchronous in horovod_tpu")
