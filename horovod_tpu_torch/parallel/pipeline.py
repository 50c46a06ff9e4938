"""Pipeline parallelism: the counterpart of
``horovod_tpu/parallel/pipeline.py``.

Each rank of the ``pp`` hop holds one stage's parameters (:func:`gpipe`)
or ``n_virtual`` non-adjacent chunks (:func:`interleaved_pipeline`: rank
``p`` holds chunks ``p, p + P, ...``); microbatches flow from stage to
stage over point-to-point sends (:meth:`~horovod_tpu_torch.parallel.
mesh.Hop.permute`, the port's ``lax.ppermute``).

- **One static schedule, walked twice.**  Both schedules are tables
  ``run[t][p]`` of ``(chunk, microbatch)`` or ``None``: GPipe's
  fill-drain (microbatch ``t - p`` on stage ``p``) and the reference's
  greedy :func:`interleaved_schedule`.  One ``torch.autograd.Function``
  per call runs the table forward and, in its backward, in reverse:
  each item's input gradient goes one hop upstream.  Every rank walks
  the same steps in the same order, so the transfers pair up on NCCL
  and gloo alike.  ``loss.backward()`` never orders them: it would
  follow each rank's own graph, and the stages' graphs differ.
- **Skipped items.**  Where the reference runs a stage on a masked
  input and zeroes the result (``active``, ``ract``), a rank here runs
  nothing and sends nothing: the same values, fewer launches.
- **The result.**  The last chunk's outputs land in an ``(M, ...)``
  buffer that is zero on every other rank; ``broadcast_result`` sums it
  over the hop (the reference's ``psum(out * mask)``).  Its backward sums
  the cotangents over the hop as well, since ``psum`` transposes to
  ``psum``: where every rank computes one loss from the result, each
  stage's gradients are ``P`` times those of one rank holding every
  layer (ROADMAP.md, "Handled, kept as traps").
- **remat.**  The forward runs without a graph and keeps each item's
  input; the backward recomputes the item with one, as ``jax.checkpoint``
  does for the reference: activation memory holds the boundary
  activations only, at one more forward per item.
- **Collectives inside a stage** (the sp ring, Megatron's f/g over tp)
  run forward and backward inside ``stage_fn``; every member of a
  stage's sp or tp group walks the same schedule, so they stay in step.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from horovod_tpu_torch.common.types import HorovodTpuError


# ---------------------------------------------------------------------------
# Schedules (pure Python)
# ---------------------------------------------------------------------------


def interleaved_schedule(nstages: int, n_virtual: int, n_micro: int):
    """Greedy static list schedule for the interleaved pipeline (the
    reference's, ``pipeline.py:95-136``).

    D = nstages * n_virtual chunks; chunk c lives on rank c % P (local
    slot c // P).  An item (c, m) is ready at step t once (c-1, m) ran
    at some step < t.  Each step every rank runs its lowest-(c, m) ready
    item.  Returns ``(steps, run)`` where ``run[t][p]`` is ``(chunk,
    mb)`` or ``None`` (idle); for M >= P, ``steps == M * V + P - 1``."""
    P, V, M = nstages, n_virtual, n_micro
    D = P * V
    done = {}  # (chunk, mb) -> step it ran
    run = []
    t = 0
    while len(done) < D * M:
        row = []
        for p in range(P):
            pick = None
            for v in range(V):
                c = v * P + p
                for m in range(M):
                    if (c, m) in done:
                        continue
                    if c == 0 or done.get((c - 1, m), t) < t:
                        pick = (c, m)
                    break  # FIFO within a chunk: only mb order matters
                if pick is not None:
                    break  # lowest local chunk first
            row.append(pick)
        for p, item in enumerate(row):
            if item is not None:
                done[item] = t
        run.append(row)
        t += 1
        if t > 4 * (D + M) * V:  # schedule bug guard, not reachable
            raise HorovodTpuError("interleaved schedule did not converge")
    return t, run


def gpipe_schedule(nstages: int, n_micro: int):
    """GPipe's fill-drain table in :func:`interleaved_schedule`'s form:
    ``steps = M + P - 1``, stage ``p`` runs microbatch ``t - p``."""
    steps = n_micro + nstages - 1
    return steps, [[(p, t - p) if 0 <= t - p < n_micro else None
                    for p in range(nstages)] for t in range(steps)]


# ---------------------------------------------------------------------------
# Parameter trees (nested dicts, lists and tuples of tensors)
# ---------------------------------------------------------------------------


class _Leaf(int):
    """A leaf's position in a flattened tree."""


def _flatten(tree):
    """``(leaves, build)``: the tensors of ``tree`` in order, and
    ``build(new_leaves)`` for the same tree over other tensors."""
    leaves = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            leaves.append(t)
            return _Leaf(len(leaves) - 1)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)([walk(v) for v in t])
        return t

    skeleton = walk(tree)

    def build(new):
        def fill(s):
            if isinstance(s, _Leaf):
                return new[s]
            if isinstance(s, dict):
                return {k: fill(v) for k, v in s.items()}
            if isinstance(s, (list, tuple)):
                return type(s)([fill(v) for v in s])
            return s

        return fill(skeleton)

    return leaves, build


def _slot(stage_params, v: int):
    """Local slot ``v`` of an interleaved rank's parameters: element
    ``v`` of a list or tuple of chunk trees, else every leaf's row
    ``v`` (the leading ``n_virtual`` axis of
    :func:`interleaved_stage_split`)."""
    if isinstance(stage_params, (list, tuple)):
        return stage_params[v]
    leaves, build = _flatten(stage_params)
    return build([leaf[v] for leaf in leaves])


# ---------------------------------------------------------------------------
# The pipeline: one autograd Function per call
# ---------------------------------------------------------------------------


class _Plan:
    """A call's static part: the schedule as this rank's items and the
    transfers of every step, forward and backward."""

    def __init__(self, stage_fn, build, chunk, hop, steps, run,
                 n_chunks, broadcast, remat):
        P, me = hop.size, hop.index
        self.stage_fn, self.build, self.chunk = stage_fn, build, chunk
        self.hop, self.steps, self.n_chunks = hop, steps, n_chunks
        self.broadcast, self.remat = broadcast, remat
        self.items = [row[me] for row in run]
        # forward: a chunk's output goes to the rank of the next chunk
        # (p + 1 mod P), which banks it for that chunk; backward: an
        # input's gradient goes back to the rank of the chunk before
        self.fwd, self.bwd = [], []
        for row in run:
            fwd, bwd, frecv, brecv = [], [], None, None
            for p, item in enumerate(row):
                if item is None:
                    continue
                c, mb = item
                if c + 1 < n_chunks:
                    fwd.append((p, (p + 1) % P))
                    if (p + 1) % P == me:
                        frecv = (c + 1, mb)
                if c > 0:
                    bwd.append((p, (p - 1) % P))
                    if (p - 1) % P == me:
                        brecv = (c - 1, mb)
            self.fwd.append((fwd, frecv))
            self.bwd.append((bwd, brecv))

    def run_item(self, params, item, x):
        return self.stage_fn(self.chunk(params, item[0] // self.hop.size),
                             x)


class _Pipeline(torch.autograd.Function):
    """``(M, ...)`` microbatches through ``plan``'s schedule; returns the
    last chunk's outputs (summed over the hop under ``broadcast``)."""

    @staticmethod
    def forward(ctx, plan, micro, *leaves):
        needs = ctx.needs_input_grad
        params = [leaf.detach().requires_grad_(needs[2 + i])
                  for i, leaf in enumerate(leaves)]
        tree = plan.build(params)
        out = torch.zeros_like(micro)
        like = micro[0]
        bank, saved = {}, {}
        for t in range(plan.steps):
            item, y = plan.items[t], None
            if item is not None:
                c, mb = item
                x = micro[mb] if c == 0 else bank.pop(item)
                x = x.detach().requires_grad_(c > 0 or needs[1])
                with torch.set_grad_enabled(not plan.remat):
                    y = plan.run_item(tree, item, x)
                saved[item] = x if plan.remat else (x, y)
                y = y.detach()
                if c == plan.n_chunks - 1:
                    out[mb].copy_(y)
            pairs, key = plan.fwd[t]
            got = plan.hop.permute(y, pairs, like)
            if got is not None:
                bank[key] = got
        if plan.broadcast:
            plan.hop.all_reduce(out)
        ctx.plan, ctx.params, ctx.tree, ctx.saved = plan, params, tree, saved
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        plan, params, tree, saved = ctx.plan, ctx.params, ctx.tree, ctx.saved
        ctx.saved = ctx.tree = ctx.params = None
        needs = ctx.needs_input_grad
        g = g.contiguous()
        if plan.broadcast:  # psum's transpose: the cotangents summed
            g = plan.hop.all_reduce(g.clone())
        d_micro = torch.zeros_like(g) if needs[1] else None
        d_params = [None] * len(params)
        want = [p for p in params if p.requires_grad]
        at = [i for i, p in enumerate(params) if p.requires_grad]
        like = g[0]
        bank = {}
        for t in reversed(range(plan.steps)):
            item, dx = plan.items[t], None
            if item is not None:
                c, mb = item
                dy = g[mb] if c == plan.n_chunks - 1 else bank.pop(item)
                if plan.remat:
                    x = saved.pop(item).requires_grad_(c > 0 or needs[1])
                    with torch.enable_grad():
                        y = plan.run_item(tree, item, x)
                else:
                    x, y = saved.pop(item)
                inputs = ([x] if x.requires_grad else []) + want
                grads = torch.autograd.grad(y, inputs, dy, allow_unused=True)
                del y
                if x.requires_grad:
                    dx, grads = grads[0], grads[1:]
                    if dx is None:
                        dx = torch.zeros_like(x)
                for i, gp in zip(at, grads):
                    if gp is not None:
                        d_params[i] = gp if d_params[i] is None else \
                            d_params[i].add_(gp)
                if c == 0:
                    if d_micro is not None:
                        d_micro[mb].copy_(dx)
                    dx = None
            pairs, key = plan.bwd[t]
            got = plan.hop.permute(dx, pairs, like)
            if got is not None:
                bank[key] = got
        return (None, d_micro, *d_params)


def _run(stage_fn, stage_params, microbatches, hop, steps, run, n_chunks,
         chunk, broadcast_result, remat):
    leaves, build = _flatten(stage_params)
    plan = _Plan(stage_fn, build, chunk, hop, steps, run, n_chunks,
                 broadcast_result, remat)
    return _Pipeline.apply(plan, microbatches, *leaves)


def gpipe(stage_fn, stage_params, microbatches, hop,
          broadcast_result: bool = True, remat: bool = False):
    """Run ``microbatches`` through a P-stage pipeline over ``hop`` (the
    ``pp`` :class:`~horovod_tpu_torch.parallel.mesh.Hop`).

    ``stage_fn(stage_params, x) -> y`` with x and y of one shape and
    dtype (the transformer block's contract); ``stage_params`` is this
    rank's tree of tensors (or ``None``), whose gradients the pipeline
    returns.  ``microbatches``: (M, *item_shape), present on every rank
    (only stage 0 reads them).  Returns (M, *item_shape) final-stage
    outputs, summed over the hop when ``broadcast_result`` (replicated),
    else valid only on the last stage (zero elsewhere).  Every rank of
    the hop must differentiate through the result.  ``remat``
    recomputes each stage in the backward instead of keeping its
    graph."""
    P, m = hop.size, microbatches.shape[0]
    steps, run = gpipe_schedule(P, m)
    return _run(stage_fn, stage_params, microbatches, hop, steps, run, P,
                lambda params, v: params, broadcast_result, remat)


def interleaved_pipeline(stage_fn, stage_params, microbatches,
                         n_virtual: int, hop, broadcast_result: bool = True,
                         remat: bool = False):
    """Run microbatches through a P*V-chunk interleaved pipeline over
    ``hop``.

    ``stage_params``: this rank's V chunks, local slot v holding global
    chunk ``v * P + p`` -- a list of V chunk trees, or a tree whose every
    leaf carries a leading ``n_virtual`` axis (as
    :func:`interleaved_stage_split` returns it).  ``stage_fn(chunk_params,
    x) -> y`` as in :func:`gpipe` (chunk_params is one slot).  Returns
    (M, *item_shape) final-chunk outputs, summed over the hop when
    ``broadcast_result``.  ``remat`` as in :func:`gpipe`."""
    P, m = hop.size, microbatches.shape[0]
    steps, run = interleaved_schedule(P, n_virtual, m)
    return _run(stage_fn, stage_params, microbatches, hop, steps, run,
                P * n_virtual, _slot, broadcast_result, remat)


def pipeline(stage_fn, stage_params, microbatches, hop,
             schedule: str = "gpipe", n_virtual: int = 1,
             broadcast_result: bool = True, remat: bool = False):
    """Schedule-selectable entry point: ``"gpipe"`` runs :func:`gpipe`,
    ``"interleaved"`` :func:`interleaved_pipeline` with ``n_virtual``
    chunks per rank."""
    if schedule == "gpipe":
        if n_virtual != 1:
            raise HorovodTpuError("gpipe schedule has n_virtual == 1; "
                                  "use schedule='interleaved'")
        return gpipe(stage_fn, stage_params, microbatches, hop,
                     broadcast_result, remat=remat)
    if schedule == "interleaved":
        return interleaved_pipeline(stage_fn, stage_params, microbatches,
                                    n_virtual, hop, broadcast_result,
                                    remat=remat)
    raise HorovodTpuError(f"unknown pipeline schedule {schedule!r}")


# ---------------------------------------------------------------------------
# Stage splits of a layer-stacked tree
# ---------------------------------------------------------------------------


def interleaved_stage_split(tree, nstages: int, n_virtual: int, stage: int):
    """Slice a tree of layer stacks into one rank's V chunk stacks: rank
    ``stage`` gets global chunks ``stage, stage + P, ...``; each leaf (L,
    ...) becomes (V, L // (P*V), ...), slot v holding the layers of chunk
    ``v * P + stage``."""
    D = nstages * n_virtual
    leaves, build = _flatten(tree)
    if any(leaf.shape[0] % D for leaf in leaves):
        raise HorovodTpuError(
            f"layer count {leaves[0].shape[0]} not divisible by "
            f"{D} chunks ({nstages} stages x {n_virtual} virtual)")
    per = leaves[0].shape[0] // D
    return build([torch.stack([
        leaf[(v * nstages + stage) * per:(v * nstages + stage + 1) * per]
        for v in range(n_virtual)]) for leaf in leaves])


def stage_split(tree, nstages: int, stage: int):
    """Slice a tree of layer stacks into a stage's chunk.  Layers must
    divide evenly across stages."""
    leaves, build = _flatten(tree)
    if any(leaf.shape[0] % nstages for leaf in leaves):
        raise HorovodTpuError(
            f"layer count {leaves[0].shape[0]} not divisible by "
            f"{nstages} stages")
    per = leaves[0].shape[0] // nstages
    return build([leaf[stage * per:(stage + 1) * per] for leaf in leaves])
