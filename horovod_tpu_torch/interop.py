"""Weights and optimizer state across the two packages.

The port's CNNs (ResNet, VGG, Inception-v3, SmallCNN, MnistCNN) name
their submodules after the flax scopes, so a flax path ``a/b/kernel`` is
the torch name ``a.b.weight``: convolution kernels go HWIO -> OIHW, a
Dense kernel ``(in, out)`` -> ``(out, in)``, and everything else
(BatchNorm ``scale``/``bias``, convolution and Dense ``bias``,
``batch_stats`` ``mean``/``var``) is copied as it is
(:func:`cnn_from_flax`, :func:`cnn_to_flax`).  The transformer's
stacked layer (and MoE) leaves map to one parameter per layer; a
transformer on a mesh loads its own shards of the full JAX tree, and
:func:`transformer_to_jax_full` puts every rank's shards back together.
Arrays are numpy on the JAX side.  Nothing here imports JAX.
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


def cnn_from_flax(params: dict, batch_stats: dict, model):
    """Load flax ``params`` and ``batch_stats`` (nested dicts of numpy
    arrays; ``{}`` for a model without BatchNorm) into the port's CNN
    ``model``; every key on both sides must map.  Returns ``model``."""
    _load(dict(model.named_parameters()), params, "params")
    _load(dict(model.named_buffers()), batch_stats, "batch_stats")
    return model


def _to_tree(named) -> dict:
    return _nest((_flax_path(name),
                  _to_flax_layout(_flax_path(name)[-1],
                                  t.detach().float().cpu().numpy()))
                 for name, t in named)


def cnn_to_flax(model, grads: bool = False):
    """``(params, batch_stats)`` of ``model`` as flax-layout numpy trees;
    with ``grads=True`` the first tree holds each parameter's ``.grad``
    instead."""
    named = [(n, p.grad if grads else p) for n, p in model.named_parameters()]
    return _to_tree(named), _to_tree(model.named_buffers())


resnet_from_flax = cnn_from_flax
resnet_to_flax = cnn_to_flax


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
# layers (``layers/wqkv`` is (n_layers, d_model, 3*H*D)) and each MoE
# matrix over the MoE layers (``moe/w_in``); the port keeps one parameter
# per layer (``layers.<i>.wqkv``, ``moe.<k>.w_in``), in the same (in,
# out) layout.  A model on a mesh holds its shards (``shard_params``).
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
        if parts[0] in ("layers", "moe"):
            out.setdefault((parts[0], parts[2]), []).append(
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


def _local(tree: dict, model) -> dict:
    """This rank's shards of a full JAX-layout tree in storage order (the
    tree itself for a model without a mesh)."""
    if model.place is None:
        return tree
    from horovod_tpu_torch.models.transformer import cut_params

    return cut_params(tree, model.cfg, model.coord())


def transformer_from_jax(params: dict, model, local: bool = False):
    """Load the JAX package's transformer ``params`` (a nested dict of
    numpy arrays, ``layers/*`` and ``moe/*`` stacked) into the port's
    ``Transformer``; every key on both sides must map.  The tree is the
    full one in the reference's storage order (as its placed arrays hold
    it: under the interleaved schedule at pp > 1 the layers permuted by
    ``interleave_layer_order``), cut to the model's shards on a mesh; or
    with ``local=True`` this rank's own shards already (the reference
    device's ``addressable_shards``: the replicated leaves of pp ranks
    drift apart, see ``models/transformer.py``).  Returns ``model``."""
    _lm_load(_lm_tensors(model, lambda p: p),
             params if local else _local(params, model), "params")
    return model


def transformer_to_jax(model, grads: bool = False) -> dict:
    """The port transformer's parameters (or, with ``grads=True``, their
    ``.grad``) as the JAX package's tree of numpy arrays: this rank's
    shards on a mesh, the layers in storage order
    (:func:`transformer_to_jax_full` joins them)."""
    return _lm_tree(_lm_tensors(model,
                                (lambda p: p.grad) if grads else
                                (lambda p: p)))


def transformer_to_jax_full(parts, cfg) -> dict:
    """The full JAX tree, in storage order, from every rank's
    :func:`transformer_to_jax`: ``parts`` is a list of ``(model.coord(),
    tree)``, one per rank (or at least one per shard; of a replicated
    leaf the last part's)."""
    from horovod_tpu_torch.models.transformer import unshard_params

    return unshard_params(parts, cfg)


def adam_from_optax(state, model, optimizer) -> None:
    """Set an Adam optimizer's per-parameter ``mu``, ``nu`` and ``count``
    from optax's ``ScaleByAdamState`` (anything with ``count``, ``mu``,
    ``nu``; full trees in the JAX transformer's layout, cut to the
    model's shards on a mesh; ``optimizer`` may be an ``lm_optimizer``)."""
    opt = getattr(optimizer, "optimizer", optimizer)
    for key in ("mu", "nu"):
        _lm_load(_lm_tensors(model, lambda p, key=key: opt.state[p][key]),
                 _local(getattr(state, key), model), key)
    count = int(np.asarray(state.count))
    for g in opt.param_groups:
        for p in g["params"]:
            opt.state[p]["count"] = count


def adam_to_optax(model, optimizer) -> AdamState:
    """The inverse of :func:`adam_from_optax`: ``AdamState(count, mu,
    nu)`` with numpy trees (``optax.ScaleByAdamState(*result)`` rebuilds
    optax's own; this rank's shards on a mesh)."""
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


# ---------------------------------------------------------------------------
# ZeRO state: the JAX package's fused buffers (stage-1/2 ``_ShardedState``,
# stage-3 ``Zero3Params``) split per leaf in its layout, mapped like the
# weights, and fused again in the port's (leaf order and convolution
# layout differ between the packages, so the shards do too).
# ---------------------------------------------------------------------------


def _jax_leaves(tree: dict, prefix=()):
    """``(path, array)`` of a nested dict in JAX's flatten order (keys
    sorted at every level)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _jax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _from_jax_fused(bufs, layout, params_tree: dict, model, tensors: dict,
                    what: str) -> None:
    """Split the JAX fused buffers ``bufs`` (one host array per group of
    ``layout``, every rank's shard concatenated) into the leaves of
    ``params_tree`` and load them, mapped like the weights, into
    ``tensors`` (the port's parameter name -> tensor)."""
    from horovod_tpu_torch.models.transformer import Transformer

    leaves = list(_jax_leaves(params_tree))
    items = []
    for g, buf in enumerate(bufs):
        buf = np.asarray(buf, np.float32).reshape(-1)
        off = 0
        for i, sz in zip(layout.idxs[g], layout.sizes[g]):
            path, like = leaves[i]
            items.append((path, buf[off:off + sz].reshape(np.shape(like))))
            off += sz
    tree = _nest(items)
    if isinstance(model, Transformer):
        by_param = {p: tensors[name] for name, p in model.named_parameters()}
        _lm_load(_lm_tensors(model, lambda p: by_param[p]), tree, what)
    else:
        _load(tensors, tree, what)


def sharded_state_from_jax(state: dict, layout, params_tree: dict, model,
                           optimizer) -> None:
    """Set a stage-1/2 ``DistributedOptimizer``'s shard state from the JAX
    package's ``_ShardedState``: ``state`` maps each moment (``trace``,
    or ``mu`` and ``nu``) to that state's full fused buffers, one host
    array per dtype group of ``layout`` (the JAX ``_ShardLayout``; every
    rank's shard concatenated), and ``count`` to Adam's step count;
    ``params_tree`` is the JAX parameter tree (flax or transformer
    layout) whose flatten order the layout indexes.  Each leaf maps as
    the weights do, and the port's layout is fused anew: this rank's
    shard of each group."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.optim.distributed import _rank_shard

    names = [name for name, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    by_id = {id(p): name for name, p in params.items()}
    order = [by_id[id(p)] for p in optimizer._params_all]
    if sorted(order) != sorted(names):
        raise ValueError("the optimizer's parameters are not the model's")
    shard_state = optimizer.shard_state
    for key, bufs in state.items():
        if key == "count":
            for st in shard_state:
                st["count"] = int(np.asarray(bufs))
            continue
        tensors = {name: torch.empty(p.shape, dtype=p.dtype)
                   for name, p in params.items()}
        _from_jax_fused(bufs, layout, params_tree, model, tensors, key)
        leaves = [tensors[name] for name in order]
        for g, st in enumerate(shard_state):
            with torch.no_grad():
                st[key].copy_(_rank_shard(leaves, optimizer.layout, g,
                                          basics.rank()))


def zero3_params_from_jax(shards, layout, params_tree: dict, model,
                          zp) -> None:
    """Set the port's ``Zero3Params`` ``zp`` (of ``model``) from the JAX
    package's stage-3 shards: ``shards`` holds each dtype group's full
    fused buffer (every rank's shard concatenated) in the JAX
    ``layout``."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.optim.distributed import _rank_shard

    dtypes = {}
    for g, key in enumerate(zp.layout.keys):
        for i in zp.layout.idxs[g]:
            dtypes[zp.names[i]] = key
    tensors = {name: torch.empty(shape, dtype=dtypes[name])
               for name, shape in zip(zp.names, zp.shapes)}
    _from_jax_fused(shards, layout, params_tree, model, tensors, "params")
    leaves = [tensors[name] for name in zp.names]
    for g, shard in enumerate(zp.shards):
        with torch.no_grad():
            shard.copy_(_rank_shard(leaves, zp.layout, g, basics.rank()))


# ---------------------------------------------------------------------------
# Local SGD: the JAX package's ``LocalSGDState`` (the inner optimizer's
# state, the ``OuterState`` buffers, ``inner_steps``).  Its fused buffers
# hold the leaves in the JAX tree's flatten order and flax layout; the
# port's hold the optimizer's parameter order and torch layout, so each
# buffer is split per leaf, mapped like the weights, and fused again.  A
# buffer is the whole fused buffer of this rank's slice: at ZeRO stages
# 1-3 the local shards concatenated in local order (each rank keeps its
# own segment; a slice's residual elements each live on one rank).
# ---------------------------------------------------------------------------


class JaxLayout(NamedTuple):
    """The JAX package's ``_ShardLayout``: per dtype group (keys are
    dtype names) the member leaf indices in flatten order, their sizes,
    the padded length and the shard length."""
    keys: tuple
    idxs: tuple
    sizes: tuple
    padded: tuple
    shard: tuple


class OuterBuffers(NamedTuple):
    """The JAX ``OuterState``'s buffers as host arrays (one per dtype
    group of ``layout``; ``residual`` ``None`` on a lossless wire) and its
    ``kind``."""
    anchor: list
    velocity: list
    residual: list | None
    layout: JaxLayout
    kind: str


class LocalSGDState(NamedTuple):
    """``LocalSGDState`` as host values: ``inner_state`` maps each moment
    of the inner optimizer (``trace``; ``mu``, ``nu`` and ``count``) to a
    flax-layout tree at stage 0 or to the fused buffers of ``layout`` at
    stages 1-3; ``outer`` is ``None`` when the regime is off."""
    inner_state: dict
    outer: OuterBuffers | None
    inner_steps: int


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _ls_leaves(model, optimizer, zp):
    """The port's fused order: ``(names, shapes by name, dtypes by
    name)``."""
    if zp is not None:
        dtypes = {}
        for g, key in enumerate(zp.layout.keys):
            for i in zp.layout.idxs[g]:
                dtypes[zp.names[i]] = key
        return list(zp.names), dict(zip(zp.names, zp.shapes)), dtypes
    by_id = {id(p): name for name, p in model.named_parameters()}
    params = optimizer.inner._params_all
    names = [by_id[id(p)] for p in params]
    return (names, {n: tuple(p.shape) for n, p in zip(names, params)},
            {n: p.dtype for n, p in zip(names, params)})


def _skeleton(names, shapes) -> dict:
    """Zeros shaped like the JAX parameter tree (flax layout)."""
    items = []
    for name in names:
        path = _flax_path(name)
        a = np.zeros(shapes[name], np.float32)
        items.append((path, _to_flax_layout(path[-1], a)))
    return _nest(items)


def _jax_layout(tree: dict, dtypes: dict, n: int) -> JaxLayout:
    groups: dict = {}
    leaves = list(_jax_leaves(tree))
    for i, (path, _) in enumerate(leaves):
        groups.setdefault(_dtype_name(dtypes[_torch_name(path)]),
                          []).append(i)
    keys, idxs, sizes, padded, shard = [], [], [], [], []
    for key, ii in groups.items():
        sz = tuple(int(np.prod(np.shape(leaves[i][1]))) for i in ii)
        p = sum(sz) + (-sum(sz)) % n
        keys.append(key)
        idxs.append(tuple(ii))
        sizes.append(sz)
        padded.append(p)
        shard.append(p // n)
    return JaxLayout(tuple(keys), tuple(idxs), tuple(sizes), tuple(padded),
                     tuple(shard))


class _LSMap:
    """The two layouts of one local-SGD optimizer's buffers: the port's
    (``port``, a ``ShardLayout``) and the JAX package's (``jax``, over as
    many shards), and the maps between their full buffers."""

    def __init__(self, model, optimizer, zp, port_layout):
        self.names, self.shapes, self.dtypes = _ls_leaves(model, optimizer,
                                                          zp)
        self.model, self.port = model, port_layout
        self.tree = _skeleton(self.names, self.shapes)
        self.jax = _jax_layout(self.tree, self.dtypes,
                               port_layout.padded[0] // port_layout.shard[0])
        self.hop = _local_hop(optimizer)

    def to_jax(self, bufs: list, sharded: bool) -> list:
        """Port buffers (this rank's shards when ``sharded``) -> the JAX
        layout's full buffers of the slice."""
        from horovod_tpu_torch.ops import quantization as _quant

        named = {}
        for g, buf in enumerate(bufs):
            buf = buf.detach()
            if sharded:
                buf = _quant._all_gather(buf, self.hop)
            off = 0
            for i, sz in zip(self.port.idxs[g], self.port.sizes[g]):
                name = self.names[i]
                named[name] = buf[off:off + sz].reshape(self.shapes[name])
                off += sz
        tree = _to_tree((name, named[name]) for name in self.names)
        leaves = [a for _, a in _jax_leaves(tree)]
        out = []
        for g in range(len(self.jax.keys)):
            flat = np.concatenate([leaves[i].reshape(-1)
                                   for i in self.jax.idxs[g]])
            out.append(np.pad(flat, (0, self.jax.padded[g] - flat.size)))
        return out

    def from_jax(self, bufs: list, like: list, sharded: bool) -> list:
        """JAX full buffers (``bufs``, in ``self.jax`` or the given JAX
        layout) -> port buffers like ``like`` (this rank's local shard
        when ``sharded``)."""
        from horovod_tpu_torch.optim.distributed import (_fuse_group,
                                                         _rank_shard)

        tensors = {name: torch.empty(self.shapes[name],
                                     dtype=self.dtypes[name])
                   for name in self.names}
        _from_jax_fused(bufs, self.jax, self.tree, self.model, tensors,
                        "local-SGD state")
        leaves = [tensors[name] for name in self.names]
        idx = self.hop.index if sharded else 0
        out = []
        for g, dst in enumerate(like):
            src = (_rank_shard(leaves, self.port, g, idx) if sharded
                   else _fuse_group(leaves, self.port, g))
            out.append(src.to(dtype=dst.dtype, device=dst.device))
        return out


def _local_hop(optimizer):
    from horovod_tpu_torch.parallel import mesh as _pmesh

    return _pmesh.flat_hop(optimizer.inner_axis)


def _inner_bufs(optimizer):
    """The inner optimizer's per-group state dicts at stages 1-3."""
    if optimizer.zero_stage == 3:
        return [optimizer.inner.optimizer.state[p]
                for p in optimizer.inner._params_all]
    return optimizer.shard_state


def local_sgd_to_jax(model, optimizer, zp=None) -> LocalSGDState:
    """A ``LocalSGD`` optimizer's state in the JAX package's layout (see
    :class:`LocalSGDState`).  At stages 1-3 the shards are gathered over
    the local hop: every rank of the slice calls it.  ``zp`` is the
    model's ``Zero3Params`` at stage 3."""
    stage = optimizer.zero_stage
    sharded = stage >= 1
    port = zp.layout if stage == 3 else (
        optimizer.inner.layout if sharded else None)
    inner: dict = {}
    if stage == 0:
        opt = optimizer.inner.optimizer
        params = dict(model.named_parameters())
        for key, v in opt.state[next(iter(params.values()))].items():
            inner[key] = (_to_tree((n, opt.state[p][key])
                                   for n, p in params.items())
                          if isinstance(v, torch.Tensor) else np.asarray(v))
    else:
        m = _LSMap(model, optimizer, zp, port)
        states = _inner_bufs(optimizer)
        for key, v in states[0].items():
            if isinstance(v, torch.Tensor):
                inner[key] = m.to_jax([st[key] for st in states], True)
            else:
                inner[key] = np.asarray(v)
    outer = None
    o = optimizer.outer
    if o is not None:
        m = _LSMap(model, optimizer, zp, o.layout)
        conv = [m.to_jax(bufs, o.kind != "full") for bufs in
                (o.anchor, o.velocity, o.residual or [])]
        outer = OuterBuffers(conv[0], conv[1],
                             conv[2] if o.residual is not None else None,
                             m.jax, o.kind)
    return LocalSGDState(inner, outer, int(optimizer.inner_steps))


def local_sgd_from_jax(state, model, optimizer, zp=None) -> None:
    """Load the JAX package's local-SGD state into a ``LocalSGD``
    optimizer of ``model`` built alike (stage, wire, pair).  ``state``
    has ``inner_state``, ``outer`` and ``inner_steps`` as
    :class:`LocalSGDState` describes them (the JAX ``OuterState``'s
    lists of full buffers of this rank's slice, and its ``layout``);
    ``zp`` is the model's ``Zero3Params`` at stage 3."""
    stage = optimizer.zero_stage
    sharded = stage >= 1
    inner = state.inner_state or {}
    if stage == 0:
        opt = optimizer.inner.optimizer
        params = dict(model.named_parameters())
        for key, v in inner.items():
            if isinstance(v, dict):
                _load({n: opt.state[p][key] for n, p in params.items()}, v,
                      key)
            else:
                for p in params.values():
                    opt.state[p][key] = int(np.asarray(v))
    elif inner:
        port = zp.layout if stage == 3 else optimizer.inner.layout
        m = _LSMap(model, optimizer, zp, port)
        states = _inner_bufs(optimizer)
        for key, v in inner.items():
            if key == "count":
                for st in states:
                    st[key] = int(np.asarray(v))
                continue
            new = m.from_jax(v, [st[key] for st in states], True)
            with torch.no_grad():
                for st, t in zip(states, new):
                    st[key].copy_(t)
    o, jo = optimizer.outer, state.outer
    if (o is None) != (jo is None):
        raise ValueError("the JAX state and the optimizer disagree on "
                         "whether the local-SGD regime is active")
    if o is not None:
        if (o.residual is None) != (jo.residual is None):
            raise ValueError("the JAX state and the optimizer disagree on "
                             "whether the outer wire is lossy")
        m = _LSMap(model, optimizer, zp, o.layout)
        m.jax = JaxLayout(*(tuple(getattr(jo.layout, f))
                            for f in JaxLayout._fields))
        for name in ("anchor", "velocity", "residual"):
            dst = getattr(o, name)
            if dst is None:
                continue
            new = m.from_jax([np.asarray(b) for b in getattr(jo, name)],
                             dst, o.kind != "full")
            with torch.no_grad():
                for d, t in zip(dst, new):
                    d.copy_(t)
    optimizer.inner_steps = int(np.asarray(state.inner_steps))
