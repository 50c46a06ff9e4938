"""The eager plane's executor: runs one negotiated response over the
eager plane's own process group (counterpart of
``horovod_tpu/ops/xla_exec.py``).

Where the JAX package compiles and caches one program per negotiated
signature, the port copies a fused response's tensors into a flat fusion
buffer (one per executor, at least the fusion threshold, reused across
rounds: the reference's ``MemcpyInFusionBuffer`` and fusion-buffer
manager), runs the port's own
in-trace collectives over the eager group's :class:`~horovod_tpu_torch.
parallel.mesh.Hop` on it, and copies the results out.  So the wire
rounds and divides as the in-trace plane does:

* allreduce: Sum, and Average as the sum divided in the payload dtype
  (``xla_exec.py:513-607``); Adasum with per-tensor segments; under
  ``HOROVOD_COMPRESSION`` the fp16/bf16 cast sandwich where it shrinks
  the payload, and int8/int4/topk through ``quantized_allreduce``
  without error feedback (B4/B5, B6/B7); the two-level split under
  ``HOROVOD_HIERARCHICAL_ALLREDUCE``
  (``parallel.mesh.hier_admissibility``); the bucketed schedule under ``HOROVOD_OVERLAP``;
* a ``localsgd.local.``/``localsgd.cross.``-scoped allreduce (local SGD's
  eager regime) over that hop of the (cross, local) pair only
  (``xla_exec.py:416-512``): the local hop in full precision, the cross
  hop on the outer sync's wire;
* reducescatter along axis 0, zero-padded to ``ceil(d0 / size)`` rows;
* allgather, ragged from the response's first dims
  (``HOROVOD_RAGGED_ALLGATHER``) or equal-size;
* fused broadcast, alltoall and barrier.

One rank is the identity, as on the reference.  On CUDA every response
runs on the executor's own stream, after the ready events of its inputs
(:meth:`EagerExecutor.execute`).
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.common.util import true_divide
from horovod_tpu_torch.ops import collectives as _coll
from horovod_tpu_torch.ops import overlap as _overlap
from horovod_tpu_torch.ops import quantization as _quant
from horovod_tpu_torch.ops.compression import Compression

_AVERAGE, _SUM, _ADASUM = 1, 2, 3
_LOSSY = ("int8", "int4", "topk")
_CASTS = {"fp16": torch.float16, "bf16": torch.bfloat16}


def wire_mode(dtype: torch.dtype) -> str:
    """The mode ``HOROVOD_COMPRESSION`` puts on a payload of ``dtype``:
    ``none`` for a non-floating payload and for a cast that would not
    shrink it."""
    mode = str(_config.get("compression")).lower()
    Compression.lookup(mode)  # fail fast on a misspelt knob
    mode = mode or "none"
    if not dtype.is_floating_point:
        return "none"
    if mode in _CASTS and dtype.itemsize <= _CASTS[mode].itemsize:
        return "none"
    return mode


def _quant_block() -> int | None:
    return int(_config.get("quant_block_size")) or None


def outer_wire_mode(dtype: torch.dtype) -> str:
    """The mode of a ``localsgd.cross.`` response's payload of ``dtype``
    (``xla_exec.py:_pseudo_wire_compression``):
    ``HOROVOD_LOCAL_SGD_COMPRESSION``, else ``HOROVOD_COMPRESSION``, while
    the regime is on (``HOROVOD_LOCAL_SGD_H >= 2``), else ``none``; a
    cast that would not shrink the payload and a non-floating payload
    are ``none`` too."""
    mode = "none"
    if int(_config.get("local_sgd_h") or 0) > 1:
        mode = str(_config.get("local_sgd_compression")
                   or _config.get("compression")).strip().lower() or "none"
    Compression.lookup(mode)  # fail fast on a misspelt knob
    if not dtype.is_floating_point:
        return "none"
    if mode in _CASTS and dtype.itemsize <= _CASTS[mode].itemsize:
        return "none"
    return mode


class EagerExecutor:
    """Runs negotiated responses for one rank over ``hop`` (the eager
    world) and, when the two-level split applies, ``pair`` (a
    ``HopPair`` of eager groups).  Tensors are computed on ``device``;
    on CUDA, on the executor's own stream."""

    def __init__(self, hop, device, pair=None) -> None:
        self.hop = hop
        self.size = hop.size
        self.device = torch.device(device)
        self.pair = pair
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._buffer = None  # the fusion buffer, bytes

    # -- the stream contract ----------------------------------------------

    def execute(self, fn, inputs, ready):
        """Run ``fn()`` after the inputs' ready events, on the
        executor's stream; returns ``(result, done event or None)``.
        The inputs are marked as used on that stream, so the caching
        allocator does not hand their memory out while it reads them."""
        if self.stream is None:
            return fn(), None
        with torch.cuda.stream(self.stream):
            for ev in ready:
                if ev is not None:
                    self.stream.wait_event(ev)
            for t in inputs:
                if t.is_cuda:
                    t.record_stream(self.stream)
            out = fn()
            done = torch.cuda.Event()
            done.record(self.stream)
        return out, done

    # -- helpers ----------------------------------------------------------

    def _fusion_buffer(self, dtype, n: int) -> torch.Tensor:
        """The first ``n`` elements, as ``dtype``, of the one fusion
        buffer: grown to the largest response seen and at least the
        fusion threshold, so a run keeps one buffer whatever sizes its
        responses take.  Responses run one after another on the
        executor's stream, so they can share it."""
        nbytes = n * dtype.itemsize
        if self._buffer is None or self._buffer.numel() < nbytes:
            cap = max(nbytes, int(_config.get("fusion_threshold")))
            self._buffer = torch.empty(cap, dtype=torch.uint8,
                                       device=self.device)
        return self._buffer[:nbytes].view(dtype)

    def _fuse(self, tensors) -> torch.Tensor:
        """The tensors copied, flat and in order, into the fusion buffer
        of their dtype and total size (from any device)."""
        sizes = [t.numel() for t in tensors]
        buf = self._fusion_buffer(tensors[0].dtype, sum(sizes))
        off = 0
        for t, n in zip(tensors, sizes):
            buf[off:off + n].copy_(t.reshape(-1))
            off += n
        return buf

    @staticmethod
    def _split(red, tensors, outs) -> list:
        """Copy the flat result out, one piece per tensor: into
        ``outs[i]`` where given, else into a new tensor on the input's
        device."""
        res, off = [], 0
        for i, t in enumerate(tensors):
            n = t.numel()
            piece = red[off:off + n].view(t.shape)
            off += n
            dst = outs[i] if outs is not None else None
            if dst is None:
                dst = torch.empty(t.shape, dtype=red.dtype, device=t.device)
            dst.copy_(piece)
            res.append(dst)
        return res

    def _two_level(self, knob: str):
        return self.pair if self.pair is not None and _config.get(knob) \
            else None

    # -- allreduce --------------------------------------------------------

    def fused_allreduce(self, tensors, op: int, outs=None) -> list:
        """One reduction of a fused bucket of same-dtype tensors."""
        if self.size == 1:
            return self._identity(tensors, outs)
        in_dtype = tensors[0].dtype
        flat = self._fuse(tensors)
        n = self.size
        pair = self._two_level("hierarchical_allreduce")
        if op == _ADASUM:
            sizes = [t.numel() for t in tensors]
            red = _coll._adasum_buffer_reduce(
                flat, sizes, pair if pair is not None else self.hop)
            return self._split(red, tensors, outs)
        mode = wire_mode(in_dtype)
        hops = pair if pair is not None else self.hop
        if _overlap.enabled():
            # the schedule applies the mode (and HOROVOD_BUCKET_
            # COMPRESSION) bucket by bucket
            red, _ = _overlap.overlapped_flat_reduce(
                flat, op=_SUM, quantized=mode, block_size=_quant_block(),
                axis_name=hops)
            red = red.to(in_dtype)
        else:
            wire = flat
            if mode in _CASTS:
                wire, mode = flat.to(_CASTS[mode]), "none"
            if pair is not None:
                red = _coll.hierarchical_allreduce(
                    wire, pair.local, pair.cross, op=_SUM,
                    compression=Compression.lookup(mode),
                    block_size=_quant_block())
            elif mode in _LOSSY:
                red = _coll.quantized_allreduce(
                    wire, op=_SUM, block_size=_quant_block(), mode=mode,
                    overlap=False, axis_name=self.hop)
            else:
                red = self.hop.all_reduce(wire)
            red = red.to(in_dtype)
        if op == _AVERAGE:
            red = true_divide(red, n).to(in_dtype)
        return self._split(red, tensors, outs)

    def scoped_allreduce(self, tensors, op: int, scope: str,
                         outs=None) -> list:
        """One reduction of a fused bucket over one hop of the eager
        plane's (cross, local) pair: ``scope`` ``"local"`` in full
        precision, ``"cross"`` on :func:`outer_wire_mode`'s wire (B4/B5,
        B6/B7 for int8/int4, without error feedback).  Average divides
        by that hop's size.  Without a pair every rank is its own slice:
        the local reduction is the identity, the cross one the world's."""
        if scope not in ("local", "cross"):
            raise HorovodTpuError(
                f"unknown reduction scope {scope!r}: expected 'local' or "
                "'cross'")
        if op == _ADASUM:
            raise HorovodTpuError(
                "scoped (local-SGD) reductions support Sum/Average only: "
                "the Adasum projection needs the full reduction")
        if self.pair is not None:
            hop = self.pair.local if scope == "local" else self.pair.cross
        elif scope == "local":
            return self._identity(tensors, outs)
        else:
            hop = self.hop
        if hop.size == 1:
            return self._identity(tensors, outs)
        in_dtype = tensors[0].dtype
        flat = self._fuse(tensors)
        mode = "none" if scope == "local" else outer_wire_mode(in_dtype)
        wire = flat
        if mode in _CASTS:
            wire, mode = flat.to(_CASTS[mode]), "none"
        if mode in _LOSSY:
            red, _ = _quant._lossy_psum_impl(wire, mode, _quant_block(),
                                             None, False, hop)
        else:
            red = hop.all_reduce(wire)
        red = red.to(in_dtype)
        if op == _AVERAGE:
            red = true_divide(red, hop.size).to(in_dtype)
        return self._split(red, tensors, outs)

    @staticmethod
    def _identity(tensors, outs) -> list:
        """One rank: each result is its input, copied (an in-place op's
        is the input itself)."""
        res = []
        for i, t in enumerate(tensors):
            o = outs[i] if outs is not None else None
            if o is None:
                res.append(t.clone())
            else:
                if o is not t:
                    o.copy_(t)
                res.append(o)
        return res

    # -- reducescatter ----------------------------------------------------

    def reducescatter(self, tensor, op: int):
        """Reduce + scatter along axis 0: every rank gets its
        ``ceil(d0 / size)`` rows (``xla_exec.py:609-673``)."""
        if self.size == 1:
            return tensor.clone()
        mode = wire_mode(tensor.dtype)
        pair = self._two_level("hierarchical_allreduce")
        out = _coll.reducescatter(
            tensor.to(self.device), op=op,
            compression=Compression.lookup(mode),
            block_size=_quant_block(), overlap=_overlap.enabled(),
            axis_name=pair if pair is not None else self.hop)
        return out.to(tensor.device)

    # -- allgather --------------------------------------------------------

    def _equal_allgather(self, t):
        pair = self._two_level("hierarchical_allgather")
        if pair is not None:
            return _coll.hierarchical_allgather(t, pair.local, pair.cross)
        return _quant._all_gather(t, self.hop)

    def allgather(self, tensor, sizes=None):
        """Concatenation of every rank's tensor along axis 0, ranks
        differing in dim 0 by the negotiated ``sizes``
        (``xla_exec.py:675-810``)."""
        if self.size == 1:
            return tensor.clone()
        if tensor.dim() == 0:
            raise HorovodTpuError("allgather requires rank >= 1 tensors")
        d0 = int(tensor.shape[0])
        me = self.hop.index
        if sizes is None:
            counts = _quant._all_gather(
                torch.tensor([d0], dtype=torch.int64, device=self.device),
                self.hop)
            sizes = [int(v) for v in counts.tolist()]
        else:
            sizes = [int(v) for v in sizes]
            if len(sizes) != self.size or sizes[me] != d0:
                raise HorovodTpuError(
                    f"negotiated allgather sizes {sizes} disagree with "
                    f"local first dim {d0} on rank {me}")
        t = tensor.to(self.device)
        max0 = max(sizes)
        if all(s == max0 for s in sizes):
            return self._equal_allgather(t).to(tensor.device)
        strategy = str(_config.get("ragged_allgather")).lower()
        if strategy == "auto":
            strategy = "psum" if 2 * sum(sizes) < max0 * self.size else "pad"
        if strategy == "psum":
            out = self._ragged_psum(t, sizes)
        else:
            pad = t.new_zeros((max0 - d0,) + tuple(t.shape[1:]))
            gathered = self._equal_allgather(torch.cat([t, pad]))
            out = torch.cat([gathered[i * max0:i * max0 + sizes[i]]
                             for i in range(self.size)])
        return out.to(tensor.device)

    def _ragged_psum(self, t, sizes):
        """Every rank's rows at their offset in one zero buffer, one
        sum (disjoint blocks: the sum is the concatenation)."""
        cast = t.dtype == torch.bool
        if cast:
            t = t.to(torch.uint8)
        offset = sum(sizes[:self.hop.index])
        buf = t.new_zeros((sum(sizes),) + tuple(t.shape[1:]))
        buf[offset:offset + t.shape[0]] = t
        out = self.hop.all_reduce(buf)
        return out.to(torch.bool) if cast else out

    # -- broadcast, alltoall, barrier --------------------------------------

    def fused_broadcast(self, tensors, root_rank: int, outs=None) -> list:
        """One broadcast of a fused bucket of same-dtype tensors from
        ``root_rank`` (``xla_exec.py:812-867``)."""
        if self.size == 1:
            return self._identity(tensors, outs)
        dtype = tensors[0].dtype
        wires = [t.to(self.device, torch.uint8 if dtype == torch.bool
                      else dtype) for t in tensors]
        buf = self.hop.broadcast(self._fuse(wires), root_rank)
        if dtype == torch.bool:
            buf = buf.to(torch.bool)
        return self._split(buf, tensors, outs)

    def alltoall(self, tensor):
        """Equal-split all-to-all along axis 0 (``xla_exec.py:869-894``)."""
        if self.size == 1:
            return tensor.clone()
        if tensor.dim() == 0 or tensor.shape[0] % self.size != 0:
            raise HorovodTpuError(
                f"alltoall axis-0 size {tensor.shape[0] if tensor.dim() else 0}"
                f" must divide world size {self.size}")
        out = _coll.alltoall(tensor.to(self.device), axis_name=self.hop)
        return out.to(tensor.device)

    def barrier(self) -> None:
        """Every rank reaches here before any leaves (a one-element sum
        on the eager group, waited for)."""
        if self.size == 1:
            return
        z = torch.zeros(1, dtype=torch.int32, device=self.device)
        out, done = self.execute(lambda: self.hop.all_reduce(z), [], [])
        if done is not None:
            done.synchronize()
        else:
            out.sum().item()
