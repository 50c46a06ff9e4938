"""Response cache (counterpart of ``horovod_tpu/runtime/cache.py``,
ported whole): skip negotiation for tensors whose collective was
already negotiated in a previous cycle.

Parity with reference ``horovod/common/response_cache.{h,cc}``: an LRU
cache of previously negotiated responses, addressed by small integer
bits (``response_cache.h:44-102``).  Each cycle every rank probes its
pending tensors against its local cache and ships the hit *bits*
instead of full request metadata; when every rank's queued work is the
same set of global cache hits, the coordinator's full
request-expansion/validation is skipped entirely and each rank
reconstructs + fuses the responses locally (the reference's bitvector
fast path, ``controller.cc:174-202``).

All collective kinds are cacheable, as in the reference (its ``put``
preserves ``response_type`` and keys on the *local* tensor's params,
``response_cache.cc:156-203``).  Ragged allgather stays correct
because each entry stores the globally negotiated per-rank first dims
alongside the rank-LOCAL shape: a HIT asserts "my shape is unchanged
since negotiation", an all-rank hit therefore re-validates the whole
``first_dims`` vector, and the coordinator can reconstruct any hitting
rank *r*'s request shape as ``(first_dims[r],) + tail`` in mixed
hit/miss rounds.

Consistency model (reference ``CacheCoordinator``,
``response_cache.h:107-167``): cache mutations — inserts after a
negotiated round, LRU touches on execution, and evictions of
invalidated bits — are derived only from the broadcast response
payloads, which every rank receives in the same order, so bit
assignments stay identical across ranks without extra synchronization
(entry *content* may differ per rank — allgather local shapes — but
the name→bit map cannot).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

from horovod_tpu_torch.common import config as _config


MISS = "miss"
HIT = "hit"
INVALID = "invalid"

_CACHEABLE = ("allreduce", "allgather", "broadcast", "alltoall",
              "reducescatter")


@dataclass
class CacheEntry:
    name: str
    kind: str
    op: int
    dtype_code: int
    shape: tuple          # this RANK's submitted shape (local)
    root_rank: int = -1   # broadcast only
    first_dims: tuple = field(default_factory=tuple)  # allgather only


class ResponseCache:
    """LRU map of negotiated-collective metadata keyed by stable
    integer bits."""

    def __init__(self, capacity: int | None = None) -> None:
        self.capacity = (
            _config.get("cache_capacity") if capacity is None else capacity)
        self._bits: dict[int, CacheEntry] = {}
        self._by_name: dict[str, int] = {}
        self._lru: OrderedDict[int, None] = OrderedDict()
        self._next_bit = 0

    def __len__(self) -> int:
        return len(self._bits)

    # -- rank-local probe (phase A) ----------------------------------------

    def probe(self, req) -> tuple[str, int | None]:
        """Classify a pending Request: (HIT, bit) when the cached
        metadata matches exactly, (INVALID, bit) when the name is cached
        with different metadata (e.g. a ragged final batch changed the
        shape — reference invalid-bit handling), else (MISS, None)."""
        if req.kind not in _CACHEABLE:
            return MISS, None
        bit = self._by_name.get(req.name)
        if bit is None:
            return MISS, None
        e = self._bits[bit]
        same = (e.kind == req.kind and e.dtype_code == req.dtype_code
                and e.shape == tuple(req.shape))
        if req.kind in ("allreduce", "reducescatter"):
            same = same and e.op == req.op
        elif req.kind == "broadcast":
            same = same and e.root_rank == req.root_rank
        return (HIT, bit) if same else (INVALID, bit)

    def request_for(self, bit: int, rank: int):
        """Expand rank ``rank``'s hit bit back into its Request
        (coordinator side: lets slow rounds reuse cached metadata
        instead of re-shipping it).  For allgather the sender's first
        dim comes from the negotiated ``first_dims`` — its HIT asserts
        its shape is unchanged since that negotiation — so the
        coordinator never substitutes its own local shape."""
        from horovod_tpu_torch.runtime.controller import Request

        e = self._bits.get(bit)
        if e is None:
            raise RuntimeError(
                f"Response-cache divergence: a rank shipped hit bit {bit} "
                f"that this rank's cache does not hold. Caches must evolve "
                f"identically on every rank — check that HOROVOD_CACHE_"
                f"CAPACITY and HOROVOD_FUSION_THRESHOLD agree across ranks.")
        shape = e.shape
        if e.kind == "allgather":
            if rank >= len(e.first_dims):
                # substituting our local shape here would silently
                # corrupt the gather's displacements — same failure
                # class as the missing-bit divergence above
                raise RuntimeError(
                    f"Response-cache divergence: allgather entry "
                    f"{e.name!r} holds {len(e.first_dims)} first dims "
                    f"but rank {rank} shipped its hit bit.")
            shape = (e.first_dims[rank],) + tuple(e.shape[1:])
        return Request(e.name, e.kind, e.op, e.dtype_code, shape,
                       e.root_rank)

    def response_for(self, bit: int):
        """Reconstruct the single-tensor Response for a fast-path bit."""
        from horovod_tpu_torch.runtime.controller import Response

        e = self._bits[bit]
        self.touch(bit)
        return Response(kind=e.kind, names=[e.name], op=e.op,
                        root_rank=e.root_rank, dtype_code=e.dtype_code,
                        shapes=[e.shape], first_dims=list(e.first_dims))

    # -- globally ordered mutations ----------------------------------------

    def touch(self, bit: int) -> None:
        if bit in self._lru:
            self._lru.move_to_end(bit)

    def evict_bits(self, bits) -> None:
        for bit in bits:
            e = self._bits.pop(bit, None)
            if e is not None:
                self._by_name.pop(e.name, None)
                self._lru.pop(bit, None)

    def insert_or_touch(self, name: str, kind: str, op: int,
                        dtype_code: int, shape: tuple, root_rank: int = -1,
                        first_dims: tuple = ()) -> None:
        """Record one negotiated collective.  Cached name → LRU touch (a
        metadata change always routes through an INVALID probe, whose
        bit is evicted before this runs, so the entry here can only
        match); new name → new bit, evicting the LRU entry at
        capacity."""
        bit = self._by_name.get(name)
        if bit is not None:
            self.touch(bit)
            return
        if self.capacity <= 0:
            return
        while len(self._bits) >= self.capacity:
            old_bit, _ = self._lru.popitem(last=False)
            old = self._bits.pop(old_bit)
            self._by_name.pop(old.name, None)
        bit = self._next_bit
        self._next_bit += 1
        self._bits[bit] = CacheEntry(name, kind, op, dtype_code,
                                     tuple(shape), root_rank,
                                     tuple(first_dims))
        self._by_name[name] = bit
        self._lru[bit] = None

    def record_responses(self, responses, local_shapes=None) -> None:
        """Apply a broadcast ResponseList to the cache (identical
        insertion ORDER on all ranks — the reference's post-round
        ``update_cache_bits``).  ``local_shapes`` maps tensor name →
        this rank's submitted shape (the probe key; reference ``put``
        reads it from the tensor queue).  A name absent from it was a
        joined-rank zero-fill: its local shape is the zero contribution
        (allgather: first dim 0)."""
        local_shapes = local_shapes or {}
        for resp in responses:
            if resp.kind not in _CACHEABLE:
                continue
            for name, shape in zip(resp.names, resp.shapes):
                local = local_shapes.get(name)
                if local is None:
                    local = (((0,) + tuple(shape[1:]))
                             if resp.kind == "allgather"
                             else tuple(shape))
                self.insert_or_touch(name, resp.kind, resp.op,
                                     resp.dtype_code, local,
                                     resp.root_rank,
                                     tuple(resp.first_dims))
