"""Ulysses sequence parallelism: the counterpart of
``horovod_tpu/parallel/ulysses.py``.

An all-to-all over the sequence group re-shards the activations from
sequence-sharded to head-sharded, :func:`blockwise_attention` runs on
the whole sequence with ``H / sp`` heads, and a second all-to-all
restores sequence sharding.  Each exchange is one
``dist.all_to_all_single`` (NCCL or gloo) and an
``autograd.Function`` whose backward is the other exchange.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.parallel.mesh import group_place
from horovod_tpu_torch.parallel.ring_attention import blockwise_attention


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """Slot ``j`` of ``x`` (axis 0) goes to sp-rank ``j``; slot ``j`` of
    the result came from sp-rank ``j``."""
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def _seq_to_heads(x: torch.Tensor, group, sp: int) -> torch.Tensor:
    b, lc, h, d = x.shape
    # head group j goes to rank j; what arrives is every rank's sequence
    # chunk of this rank's head group, in rank (= sequence) order
    x = x.reshape(b, lc, sp, h // sp, d).permute(2, 0, 1, 3, 4)
    y = _exchange(x, group)                    # (sp, B, Lc, Hc, D)
    return y.permute(1, 0, 2, 3, 4).reshape(b, sp * lc, h // sp, d)


def _heads_to_seq(x: torch.Tensor, group, sp: int) -> torch.Tensor:
    b, l_, hc, d = x.shape
    # sequence chunk j goes to rank j; what arrives is this rank's chunk
    # of every head group, in rank (= head group) order
    x = x.reshape(b, sp, l_ // sp, hc, d).permute(1, 0, 2, 3, 4)
    y = _exchange(x, group)                    # (sp, B, Lc, Hc, D)
    return y.permute(1, 2, 0, 3, 4).reshape(b, l_ // sp, sp * hc, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sp):
        ctx.group, ctx.sp = group, sp
        return _seq_to_heads(x, group, sp)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.group, ctx.sp), None, None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sp):
        ctx.group, ctx.sp = group, sp
        return _heads_to_seq(x, group, sp)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.group, ctx.sp), None, None


def seq_to_heads(x: torch.Tensor, sp_group=None) -> torch.Tensor:
    """(B, Lc, H, D) sequence-sharded -> (B, L, H/sp, D) head-sharded."""
    sp, _ = group_place(sp_group)
    if x.shape[2] % sp:
        raise HorovodTpuError(
            f"heads {x.shape[2]} must divide axis size {sp}")
    return x if sp == 1 else _SeqToHeads.apply(x, sp_group, sp)


def heads_to_seq(x: torch.Tensor, sp_group=None) -> torch.Tensor:
    """(B, L, Hc, D) head-sharded -> (B, Lc, H, D) sequence-sharded; the
    inverse of :func:`seq_to_heads`."""
    sp, _ = group_place(sp_group)
    return x if sp == 1 else _HeadsToSeq.apply(x, sp_group, sp)


def ulysses_attention(q, k, v, sp_group=None, causal: bool = True,
                      block_k: int = 512):
    """Attention on this rank's (B, Lc, H, D) chunks of a sequence
    sharded over ``sp_group``, through a head scatter: returns (B, Lc, H,
    D).  Memory stays O(L * block_k) although each rank sees the whole
    sequence."""
    qh, kh, vh = (seq_to_heads(t, sp_group) for t in (q, k, v))
    oh = blockwise_attention(qh, kh, vh, causal=causal, block_k=block_k)
    return heads_to_seq(oh, sp_group)
