"""Expert parallelism: the counterpart of ``horovod_tpu/parallel/moe.py``.

A Switch-style top-1 mixture of experts whose expert dimension is
sharded over a hop (the LM's dp axis).  Dispatch follows the
Mesh-TensorFlow/Switch einsum formulation: a (tokens, experts, capacity)
one-hot dispatch tensor turns routing into two einsums, and a pair of
all-to-alls moves the token blocks to the ranks that own each expert and
back (:class:`_AllToAll`, whose backward is the inverse all-to-all).

Precision is the reference's, with JAX's type promotion made explicit
(``torch.matmul`` refuses mixed dtypes): the router product runs in the
promoted dtype of the tokens and the router (float32 for bfloat16 tokens
and float32 weights), the dispatched tokens are rounded to the tokens'
dtype and then promoted again against the expert weights, so the experts
run in float32 on bfloat16-rounded inputs; GELU is the tanh form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from horovod_tpu_torch.common.types import HorovodTpuError


class _AllToAll(torch.autograd.Function):
    """``lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=False)``
    over ``hop``: block ``j`` of dim 0 goes to member ``j``, and block
    ``i`` of the result came from member ``i``.  It is its own
    transpose."""

    @staticmethod
    def forward(ctx, x, hop):
        ctx.hop = hop
        return _all_to_all(x, hop)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.hop), None


def _all_to_all(x: torch.Tensor, hop) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    hop.all_to_all(out, x)
    return out


def _promoted(x: torch.Tensor, w: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, w.dtype)


def capacity(tokens: int, experts: int, capacity_factor: float) -> int:
    """Slots per expert: ``int(max(1, tokens / experts * factor))``."""
    return int(max(1, (tokens / experts) * capacity_factor))


def route(x: torch.Tensor, router_w: torch.Tensor,
          capacity_factor: float = 1.25):
    """The router's decisions for tokens ``x`` (T, d): ``(gates,
    expert, onehot, gate, pos, keep, capacity)`` -- the float32 gate
    probabilities (T, E), each token's expert (the first maximum), its
    one-hot row, its gate, its 1-based slot in its expert (T, E; 0
    elsewhere), whether that slot is within the capacity (T, E), and the
    capacity."""
    e = router_w.shape[1]
    cap = capacity(x.shape[0], e, capacity_factor)
    pt = _promoted(x, router_w)
    logits = (x.to(pt) @ router_w.to(pt)).float()
    gates = torch.softmax(logits, dim=-1)
    idx = torch.argmax(gates, dim=-1)
    onehot = F.one_hot(idx, e).float()
    gate = (gates * onehot).sum(-1)
    pos = torch.cumsum(onehot, dim=0) * onehot           # 1-based
    keep = (pos > 0) & (pos <= cap)
    return gates, idx, onehot, gate, pos, keep, cap


def moe_layer(x: torch.Tensor, router_w: torch.Tensor, w_in: torch.Tensor,
              w_out: torch.Tensor, hop, capacity_factor: float = 1.25):
    """Top-1 (Switch) MoE over experts sharded on ``hop`` (``None``: all
    experts here).

    ``x``: (T, d) this rank's tokens; ``router_w``: (d, E) over all E
    experts; ``w_in`` (E_local, d, ff) and ``w_out`` (E_local, ff, d):
    this rank's experts, E = hop size * E_local.  Returns ``(out (T, d)
    in x's dtype, aux)``, aux the float32 Switch load-balancing loss."""
    ep = 1 if hop is None else hop.size
    t, d = x.shape
    e_local = w_in.shape[0]
    e = ep * e_local
    if router_w.shape[1] != e:
        raise HorovodTpuError(
            f"router width {router_w.shape[1]} != experts {e}")
    gates, _, onehot, gate, pos, keep, cap = route(x, router_w,
                                                   capacity_factor)
    # Switch aux loss: E * sum_e fraction_tokens_e * mean_prob_e
    aux = e * (onehot.mean(0) * gates.mean(0)).sum()
    pos0 = torch.clamp(pos - 1, 0, cap - 1).long()
    dispatch = keep.float()[..., None] * F.one_hot(pos0, cap).float()
    combine = dispatch * gate[:, None, None]               # (T, E, C)

    expert_in = torch.einsum("tec,td->ecd", dispatch, x.float())
    expert_in = expert_in.reshape(ep, e_local, cap, d)
    if ep > 1:
        expert_in = _AllToAll.apply(expert_in, hop)
    # (src, E_local, C, d): every rank's tokens for this rank's experts
    xe = expert_in.to(x.dtype)
    pt = _promoted(xe, w_in)
    h = F.gelu(torch.einsum("secd,edf->secf", xe.to(pt), w_in.to(pt)),
               approximate="tanh")
    pt = _promoted(h, w_out)
    expert_out = torch.einsum("secf,efd->secd", h.to(pt),
                              w_out.to(pt)).float()
    if ep > 1:
        expert_out = _AllToAll.apply(expert_out, hop)
    back = expert_out.reshape(e, cap, d)                   # at the source
    out = torch.einsum("tec,ecd->td", combine, back)
    return out.to(x.dtype), aux.float()


def moe_reference(x: torch.Tensor, router_w: torch.Tensor,
                  w_in_full: torch.Tensor, w_out_full: torch.Tensor,
                  capacity_factor: float = 1.25) -> torch.Tensor:
    """The single-device golden model (all experts here): each kept
    token through its own expert, scaled by its gate; dropped tokens
    give zero.  Tokens are gathered per expert rather than looped one by
    one as the reference does; each row is the same function."""
    _, idx, _, gate, _, keep, _ = route(x, router_w, capacity_factor)
    kept = keep.any(-1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for ei in range(router_w.shape[1]):
        rows = torch.nonzero((idx == ei) & kept).flatten()
        if rows.numel() == 0:
            continue
        xe = x[rows]
        pt = _promoted(xe, w_in_full)
        h = F.gelu(xe.to(pt) @ w_in_full[ei].to(pt), approximate="tanh")
        pt = _promoted(h, w_out_full)
        out[rows] = (h.to(pt) @ w_out_full[ei].to(pt)).float() \
            * gate[rows, None]
    return out.to(x.dtype)
