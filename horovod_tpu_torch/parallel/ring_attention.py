"""Ring attention: the counterpart of
``horovod_tpu/parallel/ring_attention.py``.

The sequence is sharded over a process group of ``sp`` ranks.  Each rank
attends its Q chunk against the KV block it holds, and the KV blocks
rotate around the ring, so after ``sp`` steps every Q chunk has seen
every KV block.

- **One schedule.**  :func:`ring_plan` lists the launches a rank makes
  at each ring step (its Q slice and KV slice, the global offsets, the
  causal flag, and whether it runs).  The ring, the tests and
  ``chip_smoke.py``'s emulated world all read it;
  :func:`blockwise_plan` is the same list for one rank whose KV is
  sliced instead of rotated.
- **Layouts.**  ``contiguous``: rank ``i`` holds tokens ``[i*lc,
  (i+1)*lc)``; a KV block after its Q chunk is hidden whole and its
  launches are skipped, so rank ``i`` runs ``i + 1`` of ``sp`` steps.
  ``zigzag``: rank ``i`` holds half-chunks ``i`` and ``2sp-1-i`` of the
  ``2sp``-way split (:func:`zigzag_shard`); each step has four
  (Q-half, KV-half) pairs, full (no mask), diagonal (masked at offsets
  ``(0, 0)``) or hidden (skipped), and every rank runs ``2sp + 1``.
  Without the causal mask both layouts run one launch per step over the
  whole chunk.
- **Kernels.**  :class:`_RingFlash` is the reference's ring-level
  saved-LSE VJP (``_ring_flash``): the forward runs one B8 per launch
  from a fresh ``(m, l, o)`` and saves only ``(q, k, v, out, lse)``; the
  backward runs one B9 and one B10 per launch, dQ accumulates at home in
  float32 and the float32 dK/dV accumulators rotate with KV, so after
  the cycle each block's gradient is home.  The reference's zigzag ring
  differentiates its XLA step; here it runs the same pairs through the
  saved-LSE backward.  There is no XLA block step: on the CPU the plain
  version of each kernel takes its place, and on the card the kernels
  always run.
- **Rotation.**  :func:`_rotate` sends to sp-rank ``idx + 1`` and
  receives from ``idx - 1`` in one ``batch_isend_irecv`` (NCCL or gloo),
  one buffer each way: a block's K and V (or its dK and dV) travel
  packed in one tensor (:func:`pack_rows`).
  Step ``j + 1``'s KV exchange is posted before step ``j``'s kernels and
  waited before the next step reads it; the last step's KV rotation
  carries nothing that is read again and is not made.  A step's dK/dV
  exchange is posted after its kernels and waited after the next step's
  kernels, just before their sums are added.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops.flash_attention import (flash_block_step,
                                                   flash_bwd_dkv,
                                                   flash_bwd_dq)
from horovod_tpu_torch.parallel.mesh import group_place

LAYOUTS = ("contiguous", "zigzag")


@dataclass(frozen=True)
class Launch:
    """One kernel launch of a ring step: rows ``q`` of the rank's Q
    chunk against rows ``kv`` of the KV block it holds, at global
    positions ``q_offset``/``k_offset`` (they feed only the causal
    mask); ``run`` is false for a pair the mask hides whole."""
    q: slice
    kv: slice
    q_offset: int
    k_offset: int
    causal: bool
    run: bool


def _zigzag_chunks(rank: int, sp: int) -> tuple[int, int]:
    """Global half-chunk ids held by ``rank`` (front, back)."""
    return rank, 2 * sp - 1 - rank


def ring_plan(idx: int, sp: int, lc: int, causal: bool = True,
              layout: str = "contiguous") -> list:
    """The launches sequence rank ``idx`` of ``sp`` makes at each of the
    ``sp`` ring steps, for a local chunk of ``lc`` tokens.  At step ``j``
    the rank holds the KV block of rank ``(idx - j) mod sp``."""
    if layout not in LAYOUTS:
        raise ValueError(f"ring_attention layout must be 'contiguous' or "
                         f"'zigzag', got {layout!r}")
    if not 0 <= idx < sp:
        raise ValueError(f"sequence rank {idx} is outside [0, {sp})")
    whole = slice(0, lc)
    steps = []
    for j in range(sp):
        src = (idx - j) % sp
        if not causal:
            steps.append([Launch(whole, whole, 0, 0, False, True)])
        elif layout == "contiguous":
            # the key chunk lies after the query chunk: hidden whole
            steps.append([Launch(whole, whole, idx * lc, src * lc, True,
                                 src <= idx)])
        else:
            if lc % 2:
                raise ValueError(
                    "zigzag layout needs an even local chunk length")
            halves = (slice(0, lc // 2), slice(lc // 2, lc))
            steps.append([
                Launch(qs, ks, 0, 0, qc == kc, qc >= kc)
                for qs, qc in zip(halves, _zigzag_chunks(idx, sp))
                for ks, kc in zip(halves, _zigzag_chunks(src, sp))])
    return steps


def blockwise_plan(length: int, block_k: int = 512,
                   causal: bool = True) -> list:
    """One step of launches over KV blocks of ``block_k`` keys (halved
    while it does not divide ``length``), each at offsets ``(0, j*bk)``:
    the reference's ``blockwise_attention`` schedule."""
    bk = min(block_k, length)
    while length % bk:
        bk //= 2
    whole = slice(0, length)
    return [[Launch(whole, slice(j, j + bk), 0, j, causal, True)
             for j in range(0, length, bk)]]


def _key(s: slice) -> tuple[int, int]:
    return s.start, s.stop


def plan_slices(plan) -> tuple[list, list]:
    """The distinct Q and KV slices of a plan, each in row order."""
    qs = {_key(a.q): a.q for step in plan for a in step}
    kvs = {_key(a.kv): a.kv for step in plan for a in step}
    return [qs[k] for k in sorted(qs)], [kvs[k] for k in sorted(kvs)]


def split_rows(x: torch.Tensor, slices) -> dict:
    """Contiguous copies of ``x``'s rows (axis 1) for each slice, keyed
    by ``(start, stop)``; the whole of a contiguous ``x`` is ``x``
    itself."""
    return {_key(s): x[:, s].contiguous() for s in slices}


def pack_rows(xs: list, slices) -> tuple:
    """One contiguous buffer of, for each tensor of ``xs`` in turn, its
    rows (axis 1) of each of ``slices`` (all of one length), and its
    views keyed as :func:`split_rows` keys them (:func:`row_views`): the
    ring sends a block's K and V, or its dK and dV, as one message."""
    buf = torch.stack([x[:, s] for x in xs for s in slices])
    return buf, row_views(buf, len(xs), slices)


def row_views(buf: torch.Tensor, n: int, slices) -> list:
    """The ``n`` dicts of views of a :func:`pack_rows` buffer."""
    keys = [_key(s) for s in slices]
    return [{k: buf[i * len(keys) + j] for j, k in enumerate(keys)}
            for i in range(n)]


def join_rows(parts: dict) -> torch.Tensor:
    """The inverse of :func:`split_rows` over slices that tile the
    rows."""
    ts = [parts[k] for k in sorted(parts)]
    return ts[0] if len(ts) == 1 else torch.cat(ts, 1)


def fresh_state(q: dict) -> dict:
    """A fresh float32 ``(m, l, o)`` for each Q slice."""
    out = {}
    for key, t in q.items():
        bh, n, d = t.shape
        out[key] = (torch.full((bh, n), -torch.inf, device=t.device),
                    torch.zeros((bh, n), device=t.device),
                    torch.zeros((bh, n, d), device=t.device))
    return out


def ring_fwd_step(launches, q: dict, k: dict, v: dict, state: dict) -> None:
    """One ring step's B8 launches: ``q`` maps each Q slice to its rows,
    ``k``/``v`` each KV slice to the rows of the block held at this step
    (:func:`split_rows`); ``state`` maps each Q slice to its ``(m, l,
    o)`` and is updated."""
    for a in launches:
        if a.run:
            qk, kk = _key(a.q), _key(a.kv)
            state[qk] = flash_block_step(q[qk], k[kk], v[kk], *state[qk],
                                         a.q_offset, a.k_offset,
                                         causal=a.causal)


def ring_bwd_step(launches, q: dict, k: dict, v: dict, do: dict, lse: dict,
                  delta: dict, dq: dict) -> dict:
    """One ring step's B9 and B10 launches: adds each launch's dQ into
    ``dq`` (float32, by Q slice) and returns this step's float32 ``[dK,
    dV]`` sums by KV slice (absent where nothing ran)."""
    dkv = {}
    for a in launches:
        if not a.run:
            continue
        qk, kk = _key(a.q), _key(a.kv)
        args = (q[qk], k[kk], v[kk], do[qk], lse[qk], delta[qk],
                a.q_offset, a.k_offset)
        dq[qk].add_(flash_bwd_dq(*args, causal=a.causal))
        dk, dv = flash_bwd_dkv(*args, causal=a.causal)
        if kk in dkv:
            dkv[kk][0].add_(dk)
            dkv[kk][1].add_(dv)
        else:
            dkv[kk] = [dk, dv]
    return dkv


def _rotate(buf: torch.Tensor, group):
    """Post one ring rotation of ``buf`` over ``group``: it goes to
    sp-rank ``idx + 1`` and a fresh buffer receives sp-rank ``idx - 1``'s,
    in one ``batch_isend_irecv``.  Returns a function that waits for the
    exchange and returns the received buffer."""
    sp, idx = group_place(group)
    recv = torch.empty_like(buf)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, buf, dist.get_global_rank(group, (idx + 1)
                                                         % sp), group),
        dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (idx - 1)
                                                          % sp), group)])

    def wait(sent=buf):  # the sent buffer lives until the exchange is done
        for w in works:
            w.wait()
        return recv

    return wait


class _RingFlash(torch.autograd.Function):
    """The saved-LSE ring on packed (B*H, Lc, D) operands, running
    ``plan`` (:func:`ring_plan` or :func:`blockwise_plan`); a plan of
    more than one step rotates KV over ``group``.  Returns the normalised
    float32 output."""

    @staticmethod
    def forward(ctx, qp, kp, vp, plan, group):
        qsl, kvsl = plan_slices(plan)
        q = split_rows(qp, qsl)
        kv, (k, v) = pack_rows([kp, vp], kvsl)
        state = fresh_state(q)
        for j, launches in enumerate(plan):
            nxt = _rotate(kv, group) if j + 1 < len(plan) else None
            ring_fwd_step(launches, q, k, v, state)
            if nxt is not None:
                kv = nxt()
                k, v = row_views(kv, 2, kvsl)
        done = {key: finish(*st) for key, st in state.items()}
        out = join_rows({key: r[0] for key, r in done.items()})
        lse = join_rows({key: r[1] for key, r in done.items()})
        ctx.plan, ctx.group = plan, group
        ctx.save_for_backward(qp, kp, vp, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        qp, kp, vp, out, lse = ctx.saved_tensors
        plan, group = ctx.plan, ctx.group
        dout = dout.float()
        qsl, kvsl = plan_slices(plan)
        q = split_rows(qp, qsl)
        do = split_rows(dout.to(qp.dtype), qsl)
        lse_p = split_rows(lse, qsl)
        delta = split_rows((dout * out).sum(-1), qsl)
        kv, (k, v) = pack_rows([kp, vp], kvsl)
        dq = {key: torch.zeros(t.shape, device=t.device)
              for key, t in q.items()}
        # the float32 dK/dV accumulators of the block held at this step
        acc = torch.zeros(kv.shape, device=kv.device)
        dk, dv = row_views(acc, 2, kvsl)
        pending = None
        for j, launches in enumerate(plan):
            nxt = _rotate(kv, group) if j + 1 < len(plan) else None
            dkv = ring_bwd_step(launches, q, k, v, do, lse_p, delta, dq)
            if pending is not None:
                acc = pending()
                dk, dv = row_views(acc, 2, kvsl)
            for key, (a, b) in dkv.items():
                dk[key].add_(a)
                dv[key].add_(b)
            if len(plan) > 1:
                pending = _rotate(acc, group)
            if nxt is not None:
                kv = nxt()
                k, v = row_views(kv, 2, kvsl)
        if pending is not None:
            dk, dv = row_views(pending(), 2, kvsl)
        return (join_rows(dq).to(qp.dtype), join_rows(dk).to(kp.dtype),
                join_rows(dv).to(vp.dtype), None, None)


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


def ring_attention(q, k, v, sp_group=None, causal: bool = True,
                   layout: str = "contiguous"):
    """Multi-head attention on this rank's (B, Lc, H, D) chunk of a
    sequence sharded over ``sp_group`` (``None``: not sharded) in
    ``layout`` (``"zigzag"``: feed :func:`zigzag_shard`'s order); returns
    (B, Lc, H, D) in q's dtype."""
    sp, idx = group_place(sp_group)
    b, lc, h, _ = q.shape
    plan = ring_plan(idx, sp, lc, causal, layout)
    out = _RingFlash.apply(_pack(q), _pack(k), _pack(v), plan, sp_group)
    return _unpack(out, b, h).to(q.dtype)


def blockwise_attention(q, k, v, causal: bool = True, block_k: int = 512):
    """Single-rank flash attention over KV blocks of ``block_k`` keys
    (:func:`blockwise_plan`): (B, L, H, D) -> (B, L, H, D) in q's dtype.
    The local step Ulysses runs after its head scatter."""
    b, l_, h, _ = q.shape
    plan = blockwise_plan(l_, block_k, causal)
    out = _RingFlash.apply(_pack(q), _pack(k), _pack(v), plan, None)
    return _unpack(out, b, h).to(q.dtype)


def _zigzag_order(n: int, sp: int) -> list[int]:
    """Token permutation global -> zigzag for a length-``n`` sequence:
    the 2*sp-way split c0..c(2sp-1) becomes [c0, c(2sp-1), c1, c(2sp-2),
    ...], so a contiguous sp-way shard hands rank i (ci, c(2sp-1-i))."""
    if n % (2 * sp):
        raise ValueError(
            f"sequence length {n} must be a multiple of 2*sp={2 * sp}")
    h = n // (2 * sp)
    order = []
    for i in range(sp):
        order.extend(range(i * h, (i + 1) * h))
        order.extend(range((2 * sp - 1 - i) * h, (2 * sp - i) * h))
    return order


def zigzag_shard(x: torch.Tensor, sp: int, axis: int = 1) -> torch.Tensor:
    """Reorder a global sequence axis into zigzag rank order; invert
    with :func:`zigzag_unshard`."""
    order = torch.tensor(_zigzag_order(x.shape[axis], sp), device=x.device)
    return torch.index_select(x, axis, order)


def zigzag_unshard(x: torch.Tensor, sp: int, axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`zigzag_shard` (gathered output -> global
    order)."""
    order = torch.tensor(_zigzag_order(x.shape[axis], sp), device=x.device)
    return torch.index_select(x, axis, torch.argsort(order))


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
