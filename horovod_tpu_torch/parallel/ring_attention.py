"""Ring attention: the counterpart of
``horovod_tpu/parallel/ring_attention.py``, at one sequence rank.

:func:`ring_attention` runs the JAX package's ring-level saved-LSE
custom VJP (``_ring_flash``, ``ring_attention(impl="pallas")``) as a
``torch.autograd.Function``: the forward is one flash step (B8) per ring
step from a fresh ``(m, l, o)`` and saves only ``(q, k, v, out, lse)``;
the backward is one B9 and one B10 per ring step.  Nothing of size
``Lq x Lk`` is kept between the two passes.

With one sequence rank the ring has one step.  The KV ring over
``torch.distributed`` point-to-point sends (``sp > 1``), the zigzag
layout and ``blockwise_attention`` are later work (ROADMAP.md, Queue A
item 10).  There is no XLA block step: on the CPU the plain version of
B8 takes its place, and on the card the kernel always runs.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.ops.flash_attention import (flash_block_step,
                                                   flash_bwd_dkv,
                                                   flash_bwd_dq)


def _pack(x: torch.Tensor) -> torch.Tensor:
    """(B, L, H, D) -> contiguous (B*H, L, D)."""
    b, l_, h, d = x.shape
    return x.transpose(1, 2).contiguous().view(b * h, l_, d)


def _unpack(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, l_, d = x.shape
    return x.reshape(b, h, l_, d).transpose(1, 2)


def finish(m, l, o):
    """The normalised output and the saved log-sum-exp of a final flash
    state: ``out = o / l`` (true division) and ``lse = m + log(l)``; a
    row that saw no key (``l == 0``) gets ``out = 0`` and ``lse = -inf``,
    which the backward kernels read as ``p = 0``."""
    pos = l > 0.0
    lse = torch.where(pos, m + torch.log(torch.where(pos, l, 1.0)),
                      -torch.inf)
    return o / torch.where(l == 0.0, 1.0, l)[..., None], lse


class _RingFlash(torch.autograd.Function):
    """``_ring_flash`` at one sequence rank, on packed (B*H, Lc, D)
    operands; returns the normalised float32 output."""

    @staticmethod
    def forward(ctx, qp, kp, vp, causal: bool):
        bh, lc, d = qp.shape
        m = torch.full((bh, lc), -torch.inf, device=qp.device)
        l = torch.zeros((bh, lc), device=qp.device)
        o = torch.zeros((bh, lc, d), device=qp.device)
        # ring step 0: the KV block is this rank's own, offsets (0, 0)
        out, lse = finish(*flash_block_step(qp, kp, vp, m, l, o, 0, 0,
                                            causal=causal))
        ctx.causal = causal
        ctx.save_for_backward(qp, kp, vp, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        qp, kp, vp, out, lse = ctx.saved_tensors
        dout = dout.float()
        delta = (dout * out).sum(-1)
        do_mm = dout.to(qp.dtype).contiguous()
        dq = flash_bwd_dq(qp, kp, vp, do_mm, lse, delta, 0, 0,
                          causal=ctx.causal)
        dk, dv = flash_bwd_dkv(qp, kp, vp, do_mm, lse, delta, 0, 0,
                               causal=ctx.causal)
        return dq.to(qp.dtype), dk.to(kp.dtype), dv.to(vp.dtype), None


def ring_attention(q, k, v, sp_group=None, causal: bool = True):
    """Multi-head attention on (B, Lc, H, D) in the contiguous layout;
    returns (B, Lc, H, D) in q's dtype.  ``sp_group`` is the process
    group the sequence is sharded over (``None``: not sharded)."""
    if sp_group is not None:
        import torch.distributed as dist

        if dist.get_world_size(sp_group) > 1:
            raise NotImplementedError(
                "ring attention over more than one sequence rank (the KV "
                "ring over torch.distributed point-to-point sends) is not "
                "ported yet (ROADMAP.md Queue A item 10)")
    b, lc, h, d = q.shape
    out = _RingFlash.apply(_pack(q), _pack(k), _pack(v), causal)
    return _unpack(out, b, h).to(q.dtype)


def reference_attention(q, k, v, causal: bool = True):
    """Dense attention for tests: (B, L, H, D) -> (B, L, H, D), the JAX
    package's ``reference_attention``."""
    b, l_, h, d = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / (d ** 0.5)
    if causal:
        mask = torch.tril(torch.ones(l_, l_, dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)
