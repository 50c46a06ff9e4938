"""Decoder-only transformer LM: the counterpart of
``horovod_tpu/models/transformer.py`` at one rank of the tp, pp and ep
axes.

- **Parallelism.**  Data and sequence parallelism: ``forward(tokens,
  sp_group)`` takes this rank's sequence chunk of a sequence sharded
  over ``sp_group`` (:func:`horovod_tpu_torch.parallel.mesh.
  sequence_groups`), at global positions, and attention runs the KV
  ring over that group; ``DistributedOptimizer`` averages every
  gradient over the world (= dp x sp).  Tensor and pipeline parallelism
  and the MoE layers are not ported yet (``tp``/``pp`` > 1 and
  ``moe_every != 0`` raise ``NotImplementedError``).
- **Weights.**  :func:`init_params` draws the JAX package's arrays in its
  order from a ``numpy.random.RandomState``, so one seed gives the same
  float32 arrays in both packages.  Matrices keep the JAX ``(in, out)``
  layout, so ``x @ w`` reads as it does there.
- **Precision.**  Parameters are float32; every matrix product runs in
  the compute dtype (``h.to(cd) @ w.to(cd)``); RMSNorm in float32 with
  ``1e-6`` inside the square root; GELU with the tanh approximation
  (``jax.nn.gelu``'s default); the residual stream in the compute dtype;
  logits through the tied embedding, in float32.
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

from horovod_tpu_torch.common.util import resolve_device, true_divide
from horovod_tpu_torch.parallel.mesh import group_place
from horovod_tpu_torch.parallel.ring_attention import ring_attention

# the compute dtypes the attention kernels take
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
LAYER_KEYS = ("wqkv", "wo", "w1", "w2", "ln1", "ln2")


@dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's config, same fields and defaults.  The port
    always runs the kernels, so ``attn_impl`` takes only ``None`` or
    ``"pallas"``; the ``pp_*`` fields are checked as there and carried
    only for parity (pipeline parallelism is not ported)."""
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


def init_params(rng: np.random.RandomState, cfg: TransformerConfig) -> dict:
    """The full parameter tree as float32 numpy arrays, drawn in the JAX
    package's order (embed, pos, then the stacked layer matrices)."""
    if cfg.moe_every:
        raise NotImplementedError(
            "MoE layers (moe_every != 0) are not ported yet (ROADMAP.md "
            "Queue A item 10)")
    dm, hd, nh, ff, nl = (cfg.d_model, cfg.head_dim, cfg.n_heads,
                          cfg.d_ff, cfg.n_layers)

    def norm(*shape, scale):
        return (rng.randn(*shape) * scale).astype(np.float32)

    return {
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


def _rmsnorm(x, g):
    x32 = x.float()
    rms = torch.sqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6)
    return ((x32 / rms) * g).to(x.dtype)


class Block(nn.Module):
    """One transformer block; parameters named as the JAX layer stack's
    leaves (``wqkv``, ``wo``, ``w1``, ``w2``, ``ln1``, ``ln2``)."""

    def __init__(self, cfg: TransformerConfig, arrays: dict):
        super().__init__()
        self.cfg = cfg
        for key in LAYER_KEYS:
            setattr(self, key, nn.Parameter(torch.from_numpy(
                np.array(arrays[key], np.float32))))

    def forward(self, x, sp_group=None):
        cfg = self.cfg
        cd = cfg.compute_dtype
        b, lc, dm = x.shape
        h = _rmsnorm(x, self.ln1)
        qkv = h.to(cd) @ self.wqkv.to(cd)
        qkv = qkv.reshape(b, lc, 3, cfg.n_heads, cfg.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = ring_attention(q, k, v, sp_group, causal=True)
        attn = attn.reshape(b, lc, cfg.n_heads * cfg.head_dim)
        proj = (attn.to(cd) @ self.wo.to(cd)).float()
        x = x + proj.to(x.dtype)

        h = _rmsnorm(x, self.ln2)
        ff = F.gelu((h.to(cd) @ self.w1.to(cd)).float(),
                    approximate="tanh").to(cd)
        mlp = (ff @ self.w2.to(cd)).float()
        return x + mlp.to(x.dtype)


class Transformer(nn.Module):
    """The LM: ``forward(tokens, sp_group=None)`` maps this rank's (B,
    Lc) int64 tokens (sequence chunk ``s`` of ``sp_group``'s ``sp``, or
    the whole sequence) to float32 logits (B, Lc, vocab).  Weights come
    from ``params`` (a tree as :func:`init_params` returns it) or else from
    ``init_params(RandomState(seed), cfg)``.  ``pp``/``tp`` are the
    model-axis sizes (only 1 is ported).  Runs on ``device`` (default
    ``cuda``)."""

    def __init__(self, cfg: TransformerConfig, params: dict | None = None,
                 seed: int = 0, device=None, pp: int = 1, tp: int = 1):
        dev = resolve_device(device)
        if pp != 1 or tp != 1:
            raise NotImplementedError(
                f"pipeline (pp={pp}) and tensor (tp={tp}) parallelism are "
                "not ported yet (ROADMAP.md Queue A item 10); data "
                "parallelism is the world, through DistributedOptimizer")
        if cfg.moe_every:
            raise NotImplementedError(
                "MoE layers (moe_every != 0) are not ported yet (ROADMAP.md "
                "Queue A item 10)")
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_params(np.random.RandomState(seed), cfg)
        for key in ("embed", "pos", "ln_f"):
            setattr(self, key, nn.Parameter(torch.from_numpy(
                np.array(params[key], np.float32))))
        stack = params["layers"]
        self.layers = nn.ModuleList(
            Block(cfg, {key: stack[key][i] for key in LAYER_KEYS})
            for i in range(cfg.n_layers))
        self.to(dev)

    def forward(self, tokens, sp_group=None):
        cd = self.cfg.compute_dtype
        b, lc = tokens.shape
        sp, s = group_place(sp_group)
        if lc * sp > self.cfg.max_seq:
            raise ValueError(f"sequence length {lc * sp} ({sp} chunks of "
                             f"{lc}) exceeds max_seq {self.cfg.max_seq}")
        # chunk s starts at global position s * lc
        pos = s * lc + torch.arange(lc, device=tokens.device)
        x = (self.embed[tokens] + self.pos[pos]).to(cd)
        for blk in self.layers:
            x = blk(x, sp_group)
        x = _rmsnorm(x, self.ln_f)
        return (x.to(cd) @ self.embed.to(cd).T).float()


def loss_fn(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy: float32 log-softmax, the target's
    negative log-probability summed and divided by the token count (the
    JAX ``loss_fn`` at one rank of ``("dp", "sp")``, which divides by the
    global count instead: ``DistributedOptimizer``'s average over the
    world of equal local counts gives the same gradient)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return true_divide(nll.sum(), nll.numel())
