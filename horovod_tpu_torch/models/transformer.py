"""Decoder-only transformer LM: the counterpart of
``horovod_tpu/models/transformer.py`` at one rank of its dp x pp x tp x
sp mesh, with optional Switch-MoE layers whose experts shard over dp.

- **Parallelism.**  ``Transformer(cfg, ..., mesh=...)`` takes the
  rank's place in a mesh (a ``RankMesh`` from ``make_mesh(dp, pp, tp,
  sp)`` or ``hvd.data_mesh()``, or a :class:`~horovod_tpu_torch.
  parallel.mesh.Place`) and holds its local shards (:func:`shard_params`
  of the full tree by :func:`param_specs`): ``wqkv`` and ``w1`` by
  contiguous columns over tp, ``wo`` and ``w2`` by rows, the experts by
  expert over dp.  A block runs Megatron's f before ``wqkv`` and ``w1``
  and g after ``wo`` and ``w2`` (:mod:`~horovod_tpu_torch.parallel.
  sharding`), attention over ``n_heads / tp`` heads through the KV ring
  over the sp group, and every ``moe_every``-th MLP as
  :func:`~horovod_tpu_torch.parallel.moe.moe_layer` over the dp hop,
  replicated over tp.  Without a mesh the model is whole on this rank
  and ``forward(tokens, sp_group)`` takes a sequence group of
  :func:`horovod_tpu_torch.parallel.mesh.sequence_groups`.
- **Pipeline parallelism.**  At pp > 1 a rank holds its stage's
  ``n_layers / pp`` blocks (the layer stacks' pp shard; under
  ``pp_schedule="interleaved"`` of the stacks permuted by
  :func:`interleave_layer_order` first, as the reference stores them).
  Every rank embeds, stage 0 feeds ``pp_microbatches`` microbatches of
  rows to :func:`~horovod_tpu_torch.parallel.pipeline.gpipe` or
  :func:`~horovod_tpu_torch.parallel.pipeline.interleaved_pipeline`
  over the pp hop, and every rank computes ``ln_f`` and the tied head
  from the broadcast result.  As on the reference, the broadcast's
  backward sums the cotangents over pp and nothing sums the replicated
  leaves' gradients over pp: the layer gradients are pp times those of
  pp = 1, and each pp rank's ``embed``, ``pos`` and ``ln_f`` train
  apart (ROADMAP.md, "Handled, kept as traps").  MoE layers under pp
  raise, as there.
- **The wqkv layout.**  A rank reshapes its local ``wqkv`` columns as
  ``(3, n_heads / tp, head_dim)``, as the reference does, so at tp > 1
  the same full weights give another function than at tp = 1;
  :func:`tp_equivalent_wqkv` permutes the columns so that a tp = 1
  model computes the tp model's function.
- **Weights.**  :func:`init_params` draws the JAX package's arrays in its
  order from a ``numpy.random.RandomState`` (the MoE tree after the
  layers, ``ep * experts_per_rank`` experts), so one seed gives the same
  float32 arrays in both packages.  Matrices keep the JAX ``(in, out)``
  layout, so ``x @ w`` reads as it does there.
- **Precision.**  Parameters are float32; every matrix product runs in
  the compute dtype (``h.to(cd) @ w.to(cd)``), the tensor-parallel sums
  in float32; RMSNorm in float32 with ``1e-6`` inside the square root;
  GELU with the tanh approximation (``jax.nn.gelu``'s default); the
  residual stream in the compute dtype; logits through the tied
  embedding, in float32.
- **Attention** is :func:`horovod_tpu_torch.parallel.ring_attention.
  ring_attention` in the contiguous layout, as in the reference: kernels
  B8-B10 on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.common import basics as _basics
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.common.util import resolve_device, true_divide
from horovod_tpu_torch.parallel.mesh import (Place, RankMesh, group_place,
                                             make_mesh)
from horovod_tpu_torch.parallel.moe import moe_layer
from horovod_tpu_torch.parallel.pipeline import gpipe, interleaved_pipeline
from horovod_tpu_torch.parallel.ring_attention import ring_attention
from horovod_tpu_torch.parallel.sharding import (P, copy_to_tp,
                                                 grad_reduce_axes,
                                                 reduce_from_tp)

# the compute dtypes the attention kernels take
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
LAYER_KEYS = ("wqkv", "wo", "w1", "w2", "ln1", "ln2")
MOE_KEYS = ("router", "w_in", "w_out")


@dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's config, same fields and defaults.  The port
    always runs the kernels, so ``attn_impl`` takes only ``None`` or
    ``"pallas"``; the ``pp_*`` fields are checked as there and read at
    pp > 1: ``pp_microbatches`` splits this rank's rows, ``pp_schedule``
    and ``pp_virtual`` pick the schedule, ``pp_remat`` recomputes each
    pipeline item in the backward."""
    vocab: int = 32000
    d_model: int = 512
    n_heads: int = 8
    head_dim: int = 64
    n_layers: int = 8
    d_ff: int = 2048
    max_seq: int = 2048
    dtype: str = "bfloat16"
    attn_impl: str | None = None
    moe_every: int = 0
    experts_per_rank: int = 2
    pp_microbatches: int = 2
    pp_schedule: str = "gpipe"
    pp_virtual: int = 1
    pp_remat: bool = False

    def __post_init__(self):
        if self.attn_impl not in (None, "pallas"):
            raise NotImplementedError(
                f"attn_impl={self.attn_impl!r}: the port runs attention "
                "only through its flash kernels (None or 'pallas')")
        if self.pp_schedule not in ("gpipe", "interleaved"):
            raise ValueError(
                f"pp_schedule must be 'gpipe' or 'interleaved', got "
                f"{self.pp_schedule!r}")
        if self.pp_schedule == "gpipe" and self.pp_virtual != 1:
            raise ValueError(
                "pp_virtual > 1 requires pp_schedule='interleaved'")
        if self.pp_virtual < 1:
            raise ValueError(f"pp_virtual must be >= 1: {self.pp_virtual}")

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def moe_layer_ids(cfg: TransformerConfig) -> list:
    """The layers whose MLP is the MoE (every ``moe_every``-th)."""
    if not cfg.moe_every:
        return []
    return [i for i in range(cfg.n_layers) if (i + 1) % cfg.moe_every == 0]


def init_params(rng: np.random.RandomState, cfg: TransformerConfig,
                ep: int = 1) -> dict:
    """The full parameter tree as float32 numpy arrays, drawn in the JAX
    package's order (embed, pos, the stacked layer matrices, then with
    ``moe_every`` the MoE tree of ``ep * experts_per_rank`` experts)."""
    dm, hd, nh, ff, nl = (cfg.d_model, cfg.head_dim, cfg.n_heads,
                          cfg.d_ff, cfg.n_layers)

    def norm(*shape, scale):
        return (rng.randn(*shape) * scale).astype(np.float32)

    p = {
        "embed": norm(cfg.vocab, dm, scale=0.02),
        "pos": norm(cfg.max_seq, dm, scale=0.02),
        "ln_f": np.ones(dm, np.float32),
        "layers": {
            "wqkv": norm(nl, dm, 3 * nh * hd, scale=dm ** -0.5),
            "wo": norm(nl, nh * hd, dm, scale=(nh * hd) ** -0.5),
            "w1": norm(nl, dm, ff, scale=dm ** -0.5),
            "w2": norm(nl, ff, dm, scale=ff ** -0.5),
            "ln1": np.ones((nl, dm), np.float32),
            "ln2": np.ones((nl, dm), np.float32),
        },
    }
    if cfg.moe_every:
        n_moe = len(moe_layer_ids(cfg))
        e = ep * cfg.experts_per_rank
        p["moe"] = {
            "router": norm(n_moe, dm, e, scale=dm ** -0.5),
            "w_in": norm(n_moe, e, dm, ff, scale=dm ** -0.5),
            "w_out": norm(n_moe, e, ff, dm, scale=ff ** -0.5),
        }
    return p


def param_specs(cfg: TransformerConfig) -> dict:
    """The reference's partition specs (``transformer.py:120-146``): the
    layer stacks over pp and the column/row-parallel matrices over tp;
    the experts over dp."""
    specs = {
        "embed": P(), "pos": P(), "ln_f": P(),
        "layers": {
            "wqkv": P("pp", None, "tp"),
            "wo": P("pp", "tp", None),
            "w1": P("pp", None, "tp"),
            "w2": P("pp", "tp", None),
            "ln1": P("pp"),
            "ln2": P("pp"),
        },
    }
    if cfg.moe_every:
        specs["moe"] = {"router": P(), "w_in": P(None, "dp"),
                        "w_out": P(None, "dp")}
    return specs


def _block_slices(shape, spec, coord: dict) -> tuple:
    """The slice of each dimension that the rank at ``coord`` (``{axis:
    (index, size)}``) holds of a leaf of ``shape`` under ``spec``."""
    out = []
    for dim, n in enumerate(shape):
        axis = spec[dim] if dim < len(spec) else None
        if axis is None:
            out.append(slice(None))
            continue
        idx, size = coord.get(axis, (0, 1))
        if n % size:
            raise HorovodTpuError(
                f"dimension {dim} ({n}) does not split over {axis}={size}")
        out.append(slice(idx * n // size, (idx + 1) * n // size))
    return tuple(out)


def _leaves(tree: dict, specs: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, specs[k], prefix + (k,))
        else:
            yield prefix + (k,), v, specs[k]


def _set(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def interleave_layer_order(n_layers: int, pp: int, n_virtual: int):
    """Storage permutation for the interleaved pipeline (the reference's,
    ``transformer.py:355-369``): rank p's contiguous pp shard must hold
    global chunks p, p+pp, ... in slot order (each chunk =
    n_layers/(pp*n_virtual) consecutive layers)."""
    D = pp * n_virtual
    if n_layers % D:
        raise ValueError(f"n_layers {n_layers} not divisible by "
                         f"{pp} stages x {n_virtual} virtual chunks")
    per = n_layers // D
    order = []
    for p in range(pp):
        for v in range(n_virtual):
            c = v * pp + p
            order.extend(range(c * per, (c + 1) * per))
    return np.asarray(order)


def storage_order(params: dict, cfg: TransformerConfig, pp: int) -> dict:
    """``params`` (layers in model order) in the order the reference
    stores them at pp stages: under ``pp_schedule="interleaved"`` at pp
    > 1 the layer stacks permuted by :func:`interleave_layer_order`
    (``shard_params``, ``transformer.py:384-388``), else unchanged."""
    if cfg.pp_schedule != "interleaved" or pp == 1:
        return params
    order = interleave_layer_order(cfg.n_layers, pp, cfg.pp_virtual)
    return dict(params, layers={k: np.asarray(v)[order]
                                for k, v in params["layers"].items()})


def cut_params(params: dict, cfg: TransformerConfig, coord: dict) -> dict:
    """The local arrays of the rank at ``coord`` (``{axis: (index,
    size)}``, :meth:`Transformer.coord`) cut by :func:`param_specs` from
    the full tree ``params`` in storage order; unsharded leaves whole."""
    out: dict = {}
    for path, a, spec in _leaves(params, param_specs(cfg)):
        a = np.asarray(a)
        _set(out, path, a[_block_slices(a.shape, spec, coord)])
    return out


def shard_params(params: dict, cfg: TransformerConfig, coord: dict) -> dict:
    """The reference's ``shard_params`` for the rank at ``coord``: the
    full tree in model order put in :func:`storage_order` and cut to its
    shards (:func:`cut_params`)."""
    return cut_params(storage_order(params, cfg, coord.get("pp", (0, 1))[1]),
                      cfg, coord)


def unshard_params(parts, cfg: TransformerConfig) -> dict:
    """The full tree, in storage order, from every rank's local tree:
    ``parts`` is a list of ``(coord, local tree)`` that covers every
    shard (replicas may repeat; the last one given wins)."""
    coord0, tree0 = parts[0]
    out: dict = {}
    for path, a, spec in _leaves(tree0, param_specs(cfg)):
        a = np.asarray(a)
        full = [n * coord0.get(spec[d], (0, 1))[1]
                if d < len(spec) and spec[d] is not None else n
                for d, n in enumerate(a.shape)]
        buf = np.zeros(full, a.dtype)
        for coord, tree in parts:
            leaf = tree
            for k in path:
                leaf = leaf[k]
            buf[_block_slices(full, spec, coord)] = np.asarray(leaf)
        _set(out, path, buf)
    return out


def tp_equivalent_wqkv(w, tp: int):
    """``wqkv`` (``(..., d_model, 3 * n_heads * head_dim)``, numpy or
    torch) with its columns permuted so that a tp = 1 model computes the
    function that the tp model computes from ``w``: rank ``t``'s local
    columns ``(3, n_heads / tp, head_dim)`` become heads ``t * n_heads /
    tp ...`` of q, k and v."""
    c = w.shape[-1] // 3
    lead = tuple(w.shape[:-1])
    x = w.reshape(lead + (tp, 3, c // tp))
    x = x.swapaxes(-3, -2) if isinstance(x, np.ndarray) else \
        x.transpose(-3, -2)
    return x.reshape(lead + (3 * c,))


def _rmsnorm(x, g):
    x32 = x.float()
    rms = torch.sqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6)
    return ((x32 / rms) * g).to(x.dtype)


def _param(a) -> nn.Parameter:
    return nn.Parameter(torch.from_numpy(np.array(a, np.float32)))


class Block(nn.Module):
    """One transformer block at this rank's tp shard; parameters named
    as the JAX layer stack's leaves (``wqkv``, ``wo``, ``w1``, ``w2``,
    ``ln1``, ``ln2``)."""

    def __init__(self, cfg: TransformerConfig, arrays: dict):
        super().__init__()
        self.cfg = cfg
        for key in LAYER_KEYS:
            setattr(self, key, _param(arrays[key]))

    def forward(self, x, sp_group=None, tp=None, moe=None, dp=None):
        """``x`` (B, Lc, d_model) -> (x, aux): ``tp`` is the tensor hop,
        ``moe`` this layer's :class:`MoE` (or ``None``: the dense MLP)
        over the dp hop ``dp``; aux is ``None`` for the dense MLP."""
        lp = {key: getattr(self, key) for key in LAYER_KEYS}
        return block(self.cfg, lp, x, sp_group, tp, moe, dp)


def block(cfg: TransformerConfig, lp: dict, x, sp_group=None, tp=None,
          moe=None, dp=None):
    """:meth:`Block.forward` on the layer weights ``lp`` (a dict of the
    ``LAYER_KEYS`` tensors): the form a pipeline stage runs."""
    cd = cfg.compute_dtype
    b, lc, dm = x.shape
    nh = lp["wqkv"].shape[1] // (3 * cfg.head_dim)   # n_heads / tp
    h = _rmsnorm(x, lp["ln1"])
    h = copy_to_tp(h, tp)        # Megatron "f"
    qkv = h.to(cd) @ lp["wqkv"].to(cd)
    qkv = qkv.reshape(b, lc, 3, nh, cfg.head_dim)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    attn = ring_attention(q, k, v, sp_group, causal=True)
    attn = attn.reshape(b, lc, nh * cfg.head_dim)
    proj = (attn.to(cd) @ lp["wo"].to(cd)).float()
    proj = reduce_from_tp(proj, tp)  # Megatron "g", in float32
    x = x + proj.to(x.dtype)

    h = _rmsnorm(x, lp["ln2"])
    aux = None
    if moe is not None:
        out, aux = moe_layer(h.reshape(b * lc, dm), moe.router,
                             moe.w_in, moe.w_out, dp)
        mlp = out.reshape(b, lc, dm).float()
    else:
        h = copy_to_tp(h, tp)
        ff = F.gelu((h.to(cd) @ lp["w1"].to(cd)).float(),
                    approximate="tanh").to(cd)
        mlp = (ff @ lp["w2"].to(cd)).float()
        mlp = reduce_from_tp(mlp, tp)
    return x + mlp.to(x.dtype), aux


class MoE(nn.Module):
    """One MoE layer's weights at this rank: the router over all
    experts, ``w_in``/``w_out`` of this rank's experts."""

    def __init__(self, arrays: dict):
        super().__init__()
        for key in MOE_KEYS:
            setattr(self, key, _param(arrays[key]))


def _place_of(mesh) -> Place | None:
    if mesh is None or isinstance(mesh, Place):
        return mesh
    if isinstance(mesh, RankMesh):
        return mesh.place()
    raise TypeError(f"mesh must be a RankMesh or a Place, got "
                    f"{type(mesh).__name__}")


class Transformer(nn.Module):
    """The LM: ``forward(tokens, sp_group=None)`` maps this rank's (B,
    Lc) int64 tokens (sequence chunk ``s`` of a sequence sharded over
    ``sp`` ranks, or the whole sequence) to float32 logits (B, Lc,
    vocab); ``with_aux=True`` also returns the MoE layers' summed
    load-balancing loss (float32; zero without MoE).

    ``mesh`` is the rank's place (a ``RankMesh`` with the ``dp``, ``pp``,
    ``tp`` and ``sp`` axes, or a ``Place``); the sequence group is then
    its sp axis.  Without it the model is whole here and the sequence
    group comes from ``forward``.  Weights come from ``params`` (the full
    tree as :func:`init_params` returns it, cut to this rank's shards)
    or else from ``init_params(RandomState(seed), cfg, ep=dp)``.
    Without ``mesh``, ``pp > 1`` or ``tp > 1`` builds ``make_mesh(dp=
    world // (pp * tp), pp=pp, tp=tp)`` (every rank must build the
    model, in one order); ``pp`` and ``tp`` are the mesh's when it is
    given.  At pp > 1 ``params`` is in model order (the storage order is
    made here) and the rows of ``tokens`` must split into
    ``pp_microbatches``.  Runs on ``device`` (default ``cuda``)."""

    def __init__(self, cfg: TransformerConfig, params: dict | None = None,
                 seed: int = 0, device=None, pp: int = 1, tp: int = 1,
                 mesh=None):
        dev = resolve_device(device)
        if mesh is not None and (pp, tp) != (1, 1):
            raise TypeError("pp and tp are the mesh's: give the sizes or "
                            "the mesh, not both")
        place = _place_of(mesh)
        if place is not None:
            pp, tp = place.pp.size, place.tp.size
        if pp > 1 and cfg.moe_every:
            raise NotImplementedError(
                "MoE layers under pipeline parallelism are not supported "
                "yet; use moe_every=0 when pp > 1.")
        if cfg.n_heads % tp:
            raise HorovodTpuError(
                f"n_heads={cfg.n_heads} does not split over tp={tp}")
        if place is None and (pp > 1 or tp > 1):
            place = make_mesh(dp=_basics.size() // (pp * tp), pp=pp,
                              tp=tp).place()
        super().__init__()
        self.cfg = cfg
        self.place = place
        ep = 1 if place is None else place.dp.size
        if params is None:
            params = init_params(np.random.RandomState(seed), cfg, ep)
        if cfg.moe_every:
            e = np.shape(params["moe"]["router"])[-1]
            if e != ep * cfg.experts_per_rank:
                raise HorovodTpuError(
                    f"the tree has {e} experts; dp={ep} x experts_per_rank="
                    f"{cfg.experts_per_rank} are {ep * cfg.experts_per_rank}"
                    " (init_params(rng, cfg, ep=dp))")
        if place is not None:
            params = shard_params(params, cfg, self.coord())
        for key in ("embed", "pos", "ln_f"):
            setattr(self, key, _param(params[key]))
        stack = params["layers"]
        self.layers = nn.ModuleList(
            Block(cfg, {key: stack[key][i] for key in LAYER_KEYS})
            for i in range(len(stack["ln1"])))   # n_layers / pp
        self.moe_ids = moe_layer_ids(cfg)
        self.moe = nn.ModuleList(
            MoE({key: params["moe"][key][k] for key in MOE_KEYS})
            for k in range(len(self.moe_ids)))
        self.to(dev)

    def coord(self) -> dict:
        """``{axis: (index, size)}`` of this rank on the mesh (all ``(0,
        1)`` without one)."""
        if self.place is None:
            return {a: (0, 1) for a in ("dp", "pp", "tp", "sp")}
        return self.place.coord()

    def forward(self, tokens, sp_group=None, with_aux: bool = False):
        cd = self.cfg.compute_dtype
        place = self.place
        if sp_group is None and place is not None:
            sp_group = place.sp.group
        tp = dp = None
        if place is not None:
            tp, dp = place.tp, place.dp
        b, lc = tokens.shape
        sp, s = group_place(sp_group)
        if lc * sp > self.cfg.max_seq:
            raise ValueError(f"sequence length {lc * sp} ({sp} chunks of "
                             f"{lc}) exceeds max_seq {self.cfg.max_seq}")
        # chunk s starts at global position s * lc
        pos = s * lc + torch.arange(lc, device=tokens.device)
        x = (self.embed[tokens] + self.pos[pos]).to(cd)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if place is not None and place.pp.size > 1:
            x = self._pipeline(x, sp_group, tp)
        else:
            moe = dict(zip(self.moe_ids, self.moe))
            for i, blk in enumerate(self.layers):
                x, a = blk(x, sp_group, tp, moe.get(i), dp)
                if a is not None:
                    aux = aux + a
        x = _rmsnorm(x, self.ln_f)
        logits = (x.to(cd) @ self.embed.to(cd).T).float()
        return (logits, aux) if with_aux else logits

    def _pipeline(self, x, sp_group, tp):
        """This rank's blocks as a pipeline stage over the pp hop (the
        reference's ``forward``, ``transformer.py:225-255``): ``x`` split
        by rows into ``pp_microbatches``, the broadcast result joined."""
        cfg = self.cfg
        b, lc, dm = x.shape
        m = cfg.pp_microbatches
        if b % m:
            raise HorovodTpuError(f"{b} rows do not split into "
                                  f"pp_microbatches={m}")
        micro = x.reshape(m, b // m, lc, dm)
        layers = [{key: getattr(blk, key) for key in LAYER_KEYS}
                  for blk in self.layers]

        def stage(lps, h):
            for lp in lps:
                h, _ = block(cfg, lp, h, sp_group, tp)
            return h

        hop = self.place.pp
        if cfg.pp_schedule == "interleaved":
            per = len(layers) // cfg.pp_virtual
            chunks = [layers[v * per:(v + 1) * per]
                      for v in range(cfg.pp_virtual)]
            y = interleaved_pipeline(stage, chunks, micro, cfg.pp_virtual,
                                     hop, remat=cfg.pp_remat)
        else:
            y = gpipe(stage, layers, micro, hop, remat=cfg.pp_remat)
        return y.reshape(b, lc, dm)

    def reduce_axes(self) -> dict:
        """Parameter name -> the data axes its gradient sums over
        (``grad_reduce_axes`` of its spec)."""
        specs = param_specs(self.cfg)
        out = {}
        for name, _ in self.named_parameters():
            parts = name.split(".")
            spec = specs[parts[0]][parts[2]] if parts[0] in ("layers",
                                                              "moe") \
                else specs[name]
            out[name] = grad_reduce_axes(spec)
        return out


def loss_fn(logits: torch.Tensor, targets: torch.Tensor, aux=None,
            data_ranks: int = 1) -> torch.Tensor:
    """The JAX ``loss_fn``'s local slice: the target's negative
    log-probability under a float32 log-softmax, summed and divided by
    the global token count (this rank's count times ``data_ranks``, the
    ranks of ``("dp", "sp")``), plus ``0.01 * aux / data_ranks``.  At
    ``data_ranks=1`` it is the mean cross entropy (plus ``0.01 * aux``),
    whose world average ``DistributedOptimizer`` takes over equal local
    counts; under a mesh the gradients are summed instead, as the
    reference sums them."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    loss = true_divide(nll.sum(), nll.numel() * data_ranks)
    if aux is not None:
        loss = loss + true_divide(0.01 * aux, data_ranks)
    return loss
