"""Weights and optimizer state across the two packages.

The port's ResNet names its submodules after the flax scopes, so a flax
path ``a/b/kernel`` is the torch name ``a.b.weight``: convolution
kernels go HWIO -> OIHW, the Dense kernel ``(in, out)`` -> ``(out, in)``,
and everything else (BatchNorm ``scale``/``bias``, Dense ``bias``,
``batch_stats`` ``mean``/``var``) is copied as it is.  The transformer's
stacked layer leaves map to one parameter per layer.  Arrays are numpy
on the JAX side.  Nothing here imports JAX.
"""

from __future__ import annotations

from typing import NamedTuple

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


# ---------------------------------------------------------------------------
# The transformer LM: the JAX tree stacks each layer matrix over the
# layers (``layers/wqkv`` is (n_layers, d_model, 3*H*D)); the port keeps
# one parameter per layer (``layers.<i>.wqkv``), in the same (in, out)
# layout.
# ---------------------------------------------------------------------------


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState`` fields, as numpy trees."""
    count: np.ndarray
    mu: dict
    nu: dict


def _lm_tensors(model, pick) -> dict:
    """JAX tree path -> the port tensor ``pick(param)`` (or a list of
    one per layer for a stacked leaf)."""
    out: dict = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            out.setdefault(("layers", parts[2]), []).append(
                (int(parts[1]), pick(p)))
        else:
            out[(name,)] = pick(p)
    return {path: ([t for _, t in sorted(v)] if isinstance(v, list) else v)
            for path, v in out.items()}


def _lm_load(tensors: dict, tree: dict, what: str) -> None:
    seen = set()
    for path, a in _flat(tree):
        if path not in tensors:
            raise KeyError(f"{what}: JAX key {'/'.join(path)} has no "
                           "counterpart in the module")
        a = np.asarray(a, np.float32)
        t = tensors[path]
        stack = t if isinstance(t, list) else [t]
        parts = list(a) if isinstance(t, list) else [a]
        if len(parts) != len(stack):
            raise ValueError(f"{what}: {'/'.join(path)} stacks {len(parts)} "
                             f"layers, the module has {len(stack)}")
        for dst, src in zip(stack, parts):
            if tuple(dst.shape) != src.shape:
                raise ValueError(
                    f"{what}: {'/'.join(path)} gives {src.shape}, the "
                    f"module holds {tuple(dst.shape)}")
            with torch.no_grad():
                dst.copy_(torch.from_numpy(np.ascontiguousarray(src))
                          .to(dst.dtype))
        seen.add(path)
    missing = set(tensors) - seen
    if missing:
        raise KeyError(f"{what}: no JAX value for "
                       f"{sorted('/'.join(p) for p in missing)}")


def _lm_tree(tensors: dict) -> dict:
    def host(t):
        return t.detach().float().cpu().numpy()

    return _nest((path, np.stack([host(x) for x in t])
                  if isinstance(t, list) else host(t))
                 for path, t in tensors.items())


def transformer_from_jax(params: dict, model):
    """Load the JAX package's transformer ``params`` (a nested dict of
    numpy arrays, ``layers/*`` stacked over the layers) into the port's
    ``Transformer``; every key on both sides must map.  Returns
    ``model``."""
    _lm_load(_lm_tensors(model, lambda p: p), params, "params")
    return model


def transformer_to_jax(model, grads: bool = False) -> dict:
    """The port transformer's parameters (or, with ``grads=True``, their
    ``.grad``) as the JAX package's tree of numpy arrays."""
    return _lm_tree(_lm_tensors(model,
                                (lambda p: p.grad) if grads else
                                (lambda p: p)))


def adam_from_optax(state, model, optimizer) -> None:
    """Set an Adam optimizer's per-parameter ``mu``, ``nu`` and ``count``
    from optax's ``ScaleByAdamState`` (anything with ``count``, ``mu``,
    ``nu``; trees in the JAX transformer's layout)."""
    opt = getattr(optimizer, "optimizer", optimizer)
    for key in ("mu", "nu"):
        _lm_load(_lm_tensors(model, lambda p, key=key: opt.state[p][key]),
                 getattr(state, key), key)
    count = int(np.asarray(state.count))
    for g in opt.param_groups:
        for p in g["params"]:
            opt.state[p]["count"] = count


def adam_to_optax(model, optimizer) -> AdamState:
    """The inverse of :func:`adam_from_optax`: ``AdamState(count, mu,
    nu)`` with numpy trees (``optax.ScaleByAdamState(*result)`` rebuilds
    optax's own)."""
    opt = getattr(optimizer, "optimizer", optimizer)
    counts = {opt.state[p]["count"] for g in opt.param_groups
              for p in g["params"]}
    if len(counts) != 1:
        raise ValueError(f"parameters disagree on the Adam step count: "
                         f"{sorted(counts)}")
    trees = [_lm_tree(_lm_tensors(model, lambda p, key=key:
                                  opt.state[p][key]))
             for key in ("mu", "nu")]
    return AdamState(np.asarray(counts.pop(), np.int32), *trees)


# ---------------------------------------------------------------------------
# Error-feedback residuals: the JAX package's ``_FeedbackState.residual``
# tree, mapped like the weights (the transformer's layout for a
# ``Transformer``, the flax layout otherwise).
# ---------------------------------------------------------------------------


def _residual_tensors(model, optimizer, lm: bool) -> dict:
    res = optimizer.residuals
    if res is None:
        raise ValueError("the optimizer keeps no error-feedback residuals "
                         "(it needs a lossy compressor and "
                         "backward_passes_per_step=1)")
    if lm:
        return _lm_tensors(model, lambda p: res[p])
    return {n: res[p] for n, p in model.named_parameters()}


def feedback_from_jax(residual_tree: dict, model, optimizer) -> None:
    """Set a ``DistributedOptimizer``'s per-parameter residuals from the
    JAX package's ``_FeedbackState.residual`` tree (numpy arrays, laid
    out like the weights of ``model``)."""
    from horovod_tpu_torch.models.transformer import Transformer

    lm = isinstance(model, Transformer)
    tensors = _residual_tensors(model, optimizer, lm)
    if lm:
        _lm_load(tensors, residual_tree, "residual")
    else:
        _load(tensors, residual_tree, "residual")


def feedback_to_jax(model, optimizer) -> dict:
    """The inverse of :func:`feedback_from_jax`."""
    from horovod_tpu_torch.models.transformer import Transformer

    lm = isinstance(model, Transformer)
    tensors = _residual_tensors(model, optimizer, lm)
    return _lm_tree(tensors) if lm else _to_tree(tensors.items())
