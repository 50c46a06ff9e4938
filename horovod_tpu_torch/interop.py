"""Weights and optimizer state across the two packages.

The port's ResNet names its submodules after the flax scopes, so a flax
path ``a/b/kernel`` is the torch name ``a.b.weight``: convolution
kernels go HWIO -> OIHW, the Dense kernel ``(in, out)`` -> ``(out, in)``,
and everything else (BatchNorm ``scale``/``bias``, Dense ``bias``,
``batch_stats`` ``mean``/``var``) is copied as it is.  Arrays are numpy
on the flax side.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_torch_layout(leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf == "kernel":
        return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
    return a


def _to_flax_layout(leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf == "kernel":
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
    return a


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _nest(items) -> dict:
    out: dict = {}
    for path, v in items:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def _torch_name(path) -> str:
    leaf = "weight" if path[-1] == "kernel" else path[-1]
    return ".".join(path[:-1] + (leaf,))


def _flax_path(name: str) -> tuple:
    path = tuple(name.split("."))
    return path[:-1] + ("kernel",) if path[-1] == "weight" else path


def _load(tensors: dict, tree: dict, what: str) -> None:
    seen = set()
    for path, a in _flat(tree):
        name = _torch_name(path)
        if name not in tensors:
            raise KeyError(f"{what}: flax key {'/'.join(path)} has no "
                           f"counterpart {name!r} in the module")
        t = tensors[name]
        src = torch.from_numpy(np.ascontiguousarray(
            _to_torch_layout(path[-1], np.array(a, np.float32))))
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"flax {'/'.join(path)} gives "
                             f"{tuple(src.shape)}")
        with torch.no_grad():
            t.copy_(src.to(t.dtype))
        seen.add(name)
    missing = set(tensors) - seen
    if missing:
        raise KeyError(f"{what}: no flax value for {sorted(missing)}")


def resnet_from_flax(params: dict, batch_stats: dict, model):
    """Load flax ``params`` and ``batch_stats`` (nested dicts of numpy
    arrays) into the port's ResNet ``model``; every key on both sides
    must map.  Returns ``model``."""
    _load(dict(model.named_parameters()), params, "params")
    _load(dict(model.named_buffers()), batch_stats, "batch_stats")
    return model


def _to_tree(named) -> dict:
    return _nest((_flax_path(name),
                  _to_flax_layout(_flax_path(name)[-1],
                                  t.detach().float().cpu().numpy()))
                 for name, t in named)


def resnet_to_flax(model, grads: bool = False):
    """``(params, batch_stats)`` of ``model`` as flax-layout numpy trees;
    with ``grads=True`` the first tree holds each parameter's ``.grad``
    instead."""
    named = [(n, p.grad if grads else p) for n, p in model.named_parameters()]
    return _to_tree(named), _to_tree(model.named_buffers())


def momentum_from_optax(trace_tree: dict, model, optimizer) -> None:
    """Set ``optimizer``'s per-parameter ``trace`` from optax's
    ``TraceState.trace`` tree (flax layout, numpy)."""
    opt = getattr(optimizer, "optimizer", optimizer)
    params = dict(model.named_parameters())
    states = {name: opt.state[p] for name, p in params.items()}
    _load({n: st["trace"] for n, st in states.items()}, trace_tree, "trace")


def momentum_to_optax(model, optimizer) -> dict:
    """The inverse of :func:`momentum_from_optax`."""
    opt = getattr(optimizer, "optimizer", optimizer)
    return _to_tree((n, opt.state[p]["trace"])
                    for n, p in model.named_parameters())
