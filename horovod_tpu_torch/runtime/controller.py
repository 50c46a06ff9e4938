"""Controller: the coordination plane that decides, every cycle, which
tensors are ready on every rank and how they fuse into collective
launches (counterpart of ``horovod_tpu/runtime/controller.py``).

Parity with reference ``horovod/common/controller.{h,cc}``: workers send
ready-tensor Requests; rank 0 counts them per name
(``controller.cc:789-812``), validates dtype/shape/op agreement (an
error Response on mismatch, ``controller.cc:378-611``), fuses ready
responses up to the fusion threshold (``controller.cc:640-761``), tracks
join and shutdown, and posts the ResponseList.

The wire is a key-value store: :class:`StoreTransport` over the default
process group's ``torch.distributed`` store, or any object with the same
six methods (the tests' ``DictTransport``).  Messages are the binary
request and response lists of :mod:`horovod_tpu_torch.runtime.wire`,
keyed by round.  This is the JAX package's flat protocol; its heartbeat
and coordinated abort, the hierarchical exchange and the autotuner's
parameter broadcast are not ported yet (ROADMAP.md Queue A item 7b).
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field

from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common import logging as _log
from horovod_tpu_torch.common.types import RanksDownError, dtype_from_code
from horovod_tpu_torch.runtime import wire as _wire
from horovod_tpu_torch.runtime.cache import HIT, INVALID, ResponseCache
from horovod_tpu_torch.runtime.stall import StallInspector

JOIN_NAME = "__hvd_join__"
RANKS_DOWN_PREFIX = RanksDownError.WIRE_PREFIX

# The JAX package's values for its knobs the port does not read yet
# (ROADMAP.md Queue A items 7b and 12): round0_cfg sends what the JAX
# package sends with them unset, so a world of the two packages'
# controllers agrees at round 0.
HEARTBEAT_INTERVAL_S = 2.0
HEARTBEAT_TIMEOUT_S = 20.0
CONTROL_FANOUT = 8
CHECKPOINT_REPLICAS = 2


@dataclass
class Request:
    """One ready tensor (reference ``message.h:47-100``)."""
    name: str
    kind: str          # allreduce | allgather | broadcast | alltoall
                       # | reducescatter
    op: int            # reduce op for allreduce/reducescatter
    dtype_code: int
    shape: tuple
    root_rank: int = -1

    def wire(self):
        return {"n": self.name, "k": self.kind, "o": self.op,
                "d": self.dtype_code, "s": list(self.shape),
                "r": self.root_rank}

    @staticmethod
    def from_wire(w) -> "Request":
        return Request(w["n"], w["k"], w["o"], w["d"], tuple(w["s"]), w["r"])


@dataclass
class Response:
    """A negotiated (possibly fused) collective launch
    (reference ``message.h:132``).  ``first_dims`` holds an allgather's
    per-rank first dims (index = rank; 0 for a joined rank), so the
    executor needs no size-gathering collective."""
    kind: str                  # allreduce|allgather|broadcast|alltoall|join|error
    names: list = field(default_factory=list)
    op: int = 2
    root_rank: int = -1
    dtype_code: int = 0
    shapes: list = field(default_factory=list)
    error: str | None = None
    last_joined: int = -1
    first_dims: list = field(default_factory=list)

    def wire(self):
        return {"k": self.kind, "n": self.names, "o": self.op,
                "r": self.root_rank, "d": self.dtype_code,
                "s": [list(s) for s in self.shapes], "e": self.error,
                "j": self.last_joined,
                "fd": [int(v) for v in self.first_dims]}

    @staticmethod
    def from_wire(w) -> "Response":
        return Response(w["k"], w["n"], w["o"], w["r"], w["d"],
                        [tuple(s) for s in w["s"]], w["e"], w["j"],
                        list(w.get("fd") or []))


@dataclass
class NegotiationResult:
    responses: list
    all_joined: bool = False
    last_joined: int = -1
    should_stop: bool = False


# ---------------------------------------------------------------------------
# The coordinator (rank 0, or trivially the one rank)
# ---------------------------------------------------------------------------


class _MessageTable:
    """The coordinator's pending-tensor table (reference
    ``IncrementTensorCount`` state)."""

    def __init__(self, world: int):
        self.world = world
        self.entries: dict[str, dict] = {}

    def add(self, rank: int, req: Request) -> str | None:
        """Returns an error string on a cross-rank mismatch."""
        if req.kind in ("allgather", "reducescatter") \
                and len(req.shape) == 0:
            return (f"{req.kind} requires rank >= 1 tensors "
                    f"(tensor {req.name} is a scalar).")
        e = self.entries.get(req.name)
        if e is None:
            self.entries[req.name] = {
                "kind": req.kind, "op": req.op, "dtype": req.dtype_code,
                "root": req.root_rank, "ranks": {rank},
                "shapes": {rank: req.shape}}
            return None
        if e["kind"] != req.kind:
            return (f"Mismatched collective operations for tensor "
                    f"{req.name}: one rank did {e['kind']}, another "
                    f"{req.kind}.")
        if e["dtype"] != req.dtype_code:
            return (f"Mismatched data types for tensor {req.name}: "
                    f"ranks submitted different dtypes.")
        if req.kind in ("allreduce", "reducescatter") \
                and e["op"] != req.op:
            return (f"Mismatched reduce ops for tensor {req.name}.")
        if req.kind == "broadcast" and e["root"] != req.root_rank:
            return (f"Mismatched root ranks for broadcast tensor "
                    f"{req.name}: {e['root']} vs {req.root_rank}.")
        base = next(iter(e["shapes"].values()))
        if req.kind in ("allreduce", "broadcast", "alltoall",
                        "reducescatter"):
            if tuple(req.shape) != tuple(base):
                return (f"Mismatched shapes for tensor {req.name}: "
                        f"{tuple(base)} vs {tuple(req.shape)}.")
        else:  # allgather: all dims but the first must match
            if tuple(req.shape[1:]) != tuple(base[1:]):
                return (f"Mismatched allgather shapes for tensor "
                        f"{req.name} beyond the first dimension: "
                        f"{tuple(base)} vs {tuple(req.shape)}.")
        if rank in e["ranks"]:
            return (f"Duplicate submission of tensor {req.name} from "
                    f"rank {rank} before completion.")
        e["ranks"].add(rank)
        e["shapes"][rank] = req.shape
        return None


class Coordinator:
    """Rank 0's negotiation, independent of the transport."""

    def __init__(self, world: int):
        self.world = world
        self.table = _MessageTable(world)
        self.joined: set[int] = set()
        self.last_joined = -1
        self.errors: dict[str, str] = {}
        self.stall = StallInspector(world)

    def ingest(self, rank: int, requests: list, joined: bool,
               shutdown: bool) -> bool:
        """Feed one rank's request list; returns the shutdown flag."""
        if joined and rank not in self.joined:
            self.joined.add(rank)
            self.last_joined = rank
        for req in requests:
            err = self.table.add(rank, req)
            if err:
                self.errors[req.name] = err
            else:
                self.stall.observe(req.name)
        return shutdown

    def compute_responses(self) -> tuple[list, bool]:
        """Ready set + fusion -> the ordered ResponseList: errors first
        (by name), then the ready tensors by name, fused.  Returns
        ``(responses, all_joined)``."""
        responses: list[Response] = []
        for name in sorted(self.errors):
            self.table.entries.pop(name, None)
            responses.append(Response(kind="error", names=[name],
                                      error=self.errors[name]))
            self.stall.resolve(name)
        self.errors.clear()

        ready = []
        for name, e in self.table.entries.items():
            if e["ranks"] | self.joined >= set(range(self.world)):
                ready.append((name, e))
        # the reference orders by arrival at the coordinator; any order
        # every rank agrees on is valid, and names are that order here
        ready.sort(key=lambda kv: kv[0])
        for name, _ in ready:
            self.table.entries.pop(name)
            self.stall.resolve(name)

        stall_error = self.stall.check(
            {n: e["ranks"] for n, e in self.table.entries.items()})
        if stall_error:
            for name in list(self.table.entries):
                self.table.entries.pop(name)
                responses.append(Response(kind="error", names=[name],
                                          error=stall_error))

        responses.extend(self._fuse(ready))

        all_joined = len(self.joined) == self.world
        if all_joined:
            responses.append(Response(kind="join",
                                      last_joined=self.last_joined))
            self.joined.clear()
        return responses, all_joined

    def _fuse(self, ready: list) -> list:
        singles = []
        for name, e in ready:
            resp = Response(kind=e["kind"], names=[name], op=e["op"],
                            root_rank=e["root"], dtype_code=e["dtype"],
                            shapes=[tuple(next(iter(
                                e["shapes"].values())))])
            if e["kind"] == "allgather":
                resp.first_dims = [
                    int(e["shapes"][r][0]) if r in e["shapes"] else 0
                    for r in range(self.world)]
            singles.append(resp)
        return fuse_singles(singles)


def tensor_nbytes(shape: tuple, dtype) -> int:
    """A negotiated tensor's bytes (a scalar counts one element)."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype.itemsize


_COMPRESSION_WIRE_CODES = {"": 0, "none": 0, "fp16": 1, "bf16": 2,
                           "int8": 3, "int4": 4, "topk": 5}
_RAGGED_WIRE_CODES = {"auto": 0, "psum": 1, "pad": 2}


def _mode_code(mode: str, codes: dict) -> int:
    """A mode string's i64 code; an unknown spelling hashes, so a typo
    on one rank still fails the round-0 comparison."""
    code = codes.get(mode)
    return 256 + zlib.crc32(mode.encode()) if code is None else code


def _active_wire_modes() -> set:
    modes = {str(_config.get("compression")).strip().lower() or "none"}
    spec = str(_config.get("bucket_compression")).strip().lower()
    modes.update(m.strip() for m in spec.split(":") if m.strip())
    return modes


def _bucket_modes_code() -> int:
    spec = ":".join(m.strip() for m in
                    str(_config.get("bucket_compression")).strip()
                    .lower().split(":") if m.strip())
    return 1 + zlib.crc32(spec.encode()) if spec else 0


def _local_sgd_codes() -> tuple:
    h = max(int(_config.get("local_sgd_h") or 0), 0)
    if h <= 1:
        return h, 0, 0, 0
    mode = str(_config.get("local_sgd_compression") or
               _config.get("compression")).strip().lower()
    return (h,
            int(round(float(_config.get("outer_lr")) * 1e6)),
            int(round(float(_config.get("outer_momentum")) * 1e6)),
            _mode_code(mode, _COMPRESSION_WIRE_CODES))


def _mesh_code() -> int:
    from horovod_tpu_torch.parallel import mesh as _pmesh

    spec = str(_config.get("mesh") or "").strip()
    if not spec:
        return 0
    return _pmesh.mesh_signature(_pmesh.parse_mesh_spec(spec))


def round0_cfg() -> list:
    """The round-0 handshake's i64 vector, in the JAX package's layout
    (``horovod_tpu/runtime/controller.py:round0_cfg``): every knob whose
    divergence across ranks would deadlock or corrupt the negotiated
    wire.  Each entry reads the port's knob where the port has it; the
    heartbeat, elastic, checkpoint and fanout entries send the JAX
    package's values for those knobs unset, and the refused adaptive and
    health knobs 0."""
    cmodes = _active_wire_modes()
    qbs = (_config.get("quant_block_size")
           if cmodes & {"int8", "int4"} else 0)
    topk_ppm = (int(round(float(_config.get("topk_ratio")) * 1e6))
                if "topk" in cmodes else 0)
    hier = (_config.get("hierarchical_allreduce")
            or _config.get("hierarchical_allgather"))
    stage = int(_config.get("zero_stage"))
    return [_config.get("cache_capacity"),
            _config.get("fusion_threshold"),
            _mode_code(str(_config.get("compression")).strip().lower(),
                       _COMPRESSION_WIRE_CODES),
            qbs,
            1 if _config.get("sharded_optimizer") else 0,
            int(round(HEARTBEAT_INTERVAL_S * 1000)),
            int(round(HEARTBEAT_TIMEOUT_S * 1000)),
            0,                                   # HOROVOD_ELASTIC
            1 if _config.get("overlap") else 0,
            int(_config.get("overlap_chunks"))
            if _config.get("overlap") else 0,
            stage,
            int(_config.get("zero_prefetch_chunks")) if stage >= 2 else 0,
            topk_ppm,
            _bucket_modes_code(),
            0,                                   # HOROVOD_ADAPTIVE_COMPRESSION
            1 if _config.get("hierarchical_allreduce") else 0,
            1 if _config.get("hierarchical_allgather") else 0,
            int(_config.get("hierarchical_local_size")) if hier else 0,
            _mode_code(str(_config.get("ragged_allgather")).strip().lower(),
                       _RAGGED_WIRE_CODES),
            0,                                   # HOROVOD_HEALTH
            0,                                   # HOROVOD_HEALTH_SKIP_NONFINITE
            CHECKPOINT_REPLICAS,
            *_local_sgd_codes(),
            _mesh_code(),
            CONTROL_FANOUT]


#: Env names of the knobs in round0_cfg's vector, in its order.
ROUND0_KNOB_ENVS = (
    "HOROVOD_CACHE_CAPACITY",
    "HOROVOD_FUSION_THRESHOLD",
    "HOROVOD_COMPRESSION",
    "HOROVOD_QUANT_BLOCK_SIZE",
    "HOROVOD_SHARDED_OPTIMIZER",
    "HOROVOD_HEARTBEAT_INTERVAL",
    "HOROVOD_HEARTBEAT_TIMEOUT_SECONDS",
    "HOROVOD_ELASTIC",
    "HOROVOD_OVERLAP",
    "HOROVOD_OVERLAP_CHUNKS",
    "HOROVOD_ZERO_STAGE",
    "HOROVOD_ZERO_PREFETCH_CHUNKS",
    "HOROVOD_TOPK_RATIO",
    "HOROVOD_BUCKET_COMPRESSION",
    "HOROVOD_ADAPTIVE_COMPRESSION",
    "HOROVOD_HIERARCHICAL_ALLREDUCE",
    "HOROVOD_HIERARCHICAL_ALLGATHER",
    "HOROVOD_HIERARCHICAL_LOCAL_SIZE",
    "HOROVOD_RAGGED_ALLGATHER",
    "HOROVOD_HEALTH",
    "HOROVOD_HEALTH_SKIP_NONFINITE",
    "HOROVOD_CHECKPOINT_REPLICAS",
    "HOROVOD_LOCAL_SGD_H",
    "HOROVOD_OUTER_LR",
    "HOROVOD_OUTER_MOMENTUM",
    "HOROVOD_LOCAL_SGD_COMPRESSION",
    "HOROVOD_MESH",
    "HOROVOD_CONTROL_FANOUT",
)


def reduction_scope(name: str) -> str | None:
    """The axis scope a negotiated allreduce is pinned to by its name:
    ``localsgd.local.`` and ``localsgd.cross.`` prefixes (local SGD's
    eager regime, which the port does not run yet) never fuse with each
    other or with world-scoped tensors."""
    if name.startswith("localsgd.local."):
        return "local"
    if name.startswith("localsgd.cross."):
        return "cross"
    return None


def fuse_singles(singles: list) -> list:
    """Fuse single-tensor Responses of matching dtype (and op / root) up
    to ``HOROVOD_FUSION_THRESHOLD`` bytes (reference ``FuseResponses``,
    ``controller.cc:640-761``), shared by negotiated rounds and the cache
    fast path.  Deterministic given the input order and the threshold,
    so every rank computes the same launches."""
    threshold = _config.get("fusion_threshold")
    out: list[Response] = []
    buckets: dict[tuple, Response] = {}
    bucket_bytes: dict[tuple, int] = {}
    for s in singles:
        shape = tuple(s.shapes[0])
        nbytes = tensor_nbytes(shape, dtype_from_code(s.dtype_code))
        if s.kind == "allreduce":
            bkey = ("allreduce", s.op, s.dtype_code,
                    reduction_scope(s.names[0]))
        elif s.kind == "broadcast":
            bkey = ("broadcast", s.root_rank, s.dtype_code)
        else:
            out.append(s)
            continue
        resp = buckets.get(bkey)
        if resp is not None and bucket_bytes[bkey] + nbytes <= threshold:
            resp.names.append(s.names[0])
            resp.shapes.append(shape)
            bucket_bytes[bkey] += nbytes
        else:
            out.append(s)
            buckets[bkey] = s
            bucket_bytes[bkey] = nbytes
    return out


_warned_wire_coupling = False


def wire_timeout() -> float:
    """The control plane's wire deadline (``HOROVOD_WIRE_TIMEOUT_SECONDS``).
    Warns once when ``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS``, which once
    doubled as this deadline on the reference, would have given another
    value."""
    global _warned_wire_coupling
    wt = float(_config.get("wire_timeout"))
    stall = float(_config.get("stall_shutdown_time") or 0)
    if not _config.is_set("wire_timeout") and stall > 0 and stall != wt \
            and not _warned_wire_coupling:
        _warned_wire_coupling = True
        _log.warning(
            "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS no longer sets the "
            f"control-plane wire timeout (previously it would have been "
            f"{stall:.0f}s; now HOROVOD_WIRE_TIMEOUT_SECONDS defaults "
            f"to {wt:.0f}s). Set HOROVOD_WIRE_TIMEOUT_SECONDS "
            "explicitly to restore the old deadline.")
    return max(wt, 0.001)


# ---------------------------------------------------------------------------
# Controllers
# ---------------------------------------------------------------------------


class LocalController:
    """One rank: everything is ready at once (no wire)."""

    def __init__(self) -> None:
        self.coordinator = Coordinator(1)
        self.round = 0
        self.fast_rounds = 0

    def negotiate(self, requests: list, joined: bool,
                  shutdown: bool) -> NegotiationResult:
        stop = self.coordinator.ingest(0, requests, joined, shutdown)
        responses, all_joined = self.coordinator.compute_responses()
        self.round += 1
        return NegotiationResult(responses, all_joined,
                                 self.coordinator.last_joined,
                                 should_stop=stop or shutdown)


class KVController:
    """Several processes negotiating over a key-value store (the JAX
    package's flat protocol).

    Round protocol (lazy cycles: an idle cycle costs one ``try_get``):
      * a rank with pending work "kicks" round r (``k/<r>``);
      * every participating rank posts its request list at
        ``q/<r>/<rank>``, cache hits as bits;
      * rank 0 ingests all lists, computes the fused ResponseList and
        posts it at ``p/<r>``; when every rank shipped the same hit bits
        and nothing else, it posts only the bits (the fast path) and
        each rank rebuilds and fuses the responses from its own cache;
      * everyone executes the list in order and moves to round r+1.
        Rank 0 deletes round r-2's keys.
    Round 0 carries :func:`round0_cfg` from every rank; a mismatch fails
    every rank with one error response.  ``timeout`` (default
    :func:`wire_timeout`) bounds each wait on the store."""

    def __init__(self, transport, rank: int, world: int, epoch: int = 0,
                 timeout: float | None = None):
        self.t = transport
        self.rank = rank
        self.world = world
        self.epoch = epoch
        self.round = 0
        self.coordinator = Coordinator(world) if rank == 0 else None
        self._timeout = wire_timeout() if timeout is None else timeout
        self.cache = (ResponseCache()
                      if _config.get("cache_capacity") > 0 else None)
        self._pending_shapes: dict[str, tuple] = {}
        self.fast_rounds = 0
        # requests this rank shipped with their metadata (not as hit bits)
        self.explicit_requests = 0

    def _key(self, *parts) -> str:
        # epoch-namespaced: a shutdown() + init() generation never meets
        # the previous generation's keys
        return f"hvd{self.epoch}/" + "/".join(str(p) for p in parts)

    def _wire_timeout_error(self, key: str, rnd: int,
                            context: str) -> TimeoutError:
        return TimeoutError(
            f"kv get({key}) timed out after "
            f"{self._timeout:.0f}s (rank {self.rank}, round "
            f"{rnd}, epoch {self.epoch}; {context}). "
            "Raise HOROVOD_WIRE_TIMEOUT_SECONDS if the job is "
            "merely slow.")

    def _get_blocking(self, key: str, context: str) -> str:
        """A wait on ``key`` in slices of at most 5 s, up to the wire
        deadline."""
        deadline = time.monotonic() + self._timeout
        slice_s = min(self._timeout, 5.0)
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise self._wire_timeout_error(key, self.round, context)
            t0 = time.monotonic()
            try:
                return self.t.get_blocking(key, min(slice_s, remaining))
            except Exception:  # noqa: BLE001 -- slice expired or transient
                if time.monotonic() - t0 < 0.05:
                    time.sleep(min(slice_s, 0.05))

    def _fair_gather(self, r: int, got: dict[int, str],
                     expected: dict[int, str], what: str) -> dict[int, str]:
        """Collect ``expected[peer] -> key`` payloads into ``got`` by
        polling every missing peer in turn (so one slow rank does not
        delay noticing the others), up to the wire deadline."""
        missing = list(expected)
        deadline = time.monotonic() + self._timeout
        while missing:
            progressed = False
            for other in list(missing):
                try:
                    raw = self.t.try_get(expected[other])
                except Exception:  # noqa: BLE001 -- retried next sweep
                    raw = None
                if raw is not None:
                    got[other] = raw
                    missing.remove(other)
                    progressed = True
            if not missing:
                break
            if time.monotonic() > deadline:
                raise self._wire_timeout_error(
                    expected[missing[0]], r,
                    f"waiting for rank(s) {missing}'s {what}")
            if not progressed:
                time.sleep(0.001)
        return got

    def should_participate(self, have_pending: bool) -> bool:
        if have_pending:
            return True
        return self.t.try_get(self._key("k", self.round)) is not None

    def kick(self) -> None:
        self.t.set_once(self._key("k", self.round), "1")

    def _coordinate(self, r: int, raws: list) -> str:
        """Rank 0: ingest every rank's round-``r`` payload, compute the
        ResponseList, post it at ``p/<r>`` and return it."""
        msgs = [_wire.loads_rank(raw) for raw in raws]
        if r == 0:
            cfgs = {tuple(m["cfg"]) for m in msgs}
            if len(cfgs) > 1:
                names = sorted({w["n"] for m in msgs for w in m["req"]})
                err = ("Mismatched "
                       + " / ".join(ROUND0_KNOB_ENVS)
                       + f" across ranks ({sorted(cfgs)}); these "
                       "knobs must agree on every rank (one rank "
                       "reduce-scattering while another allreduces "
                       "would deadlock; a rank without heartbeats "
                       "would be declared dead by peers expecting "
                       "them). Shutting down.")
                resp_payload = _wire.dumps_resp({
                    "resp": [Response(kind="error", names=names,
                                      error=err).wire()],
                    "i": [], "x": True, "aj": False, "lj": -1})
                self.t.set(self._key("p", r), resp_payload)
                return resp_payload
        glob_inv = sorted({b for m in msgs for b in m["i"]})
        # the fast path (reference ``controller.cc:174-202``): every
        # rank's queued work is the same set of valid cache hits and
        # nothing else is pending
        fast = (self.cache is not None and not glob_inv
                and not any(m["req"] for m in msgs)
                and not any(m["j"] for m in msgs)
                and not any(m["x"] for m in msgs)
                and all(m["b"] == msgs[0]["b"] for m in msgs)
                and not self.coordinator.table.entries
                and not self.coordinator.joined)
        if fast:
            resp_payload = _wire.dumps_resp({"f": msgs[0]["b"]})
        else:
            stop = False
            for other, m in enumerate(msgs):
                reqs = [Request.from_wire(w) for w in m["req"]]
                if self.cache is not None:
                    # expand hit bits from rank 0's cache (identical on
                    # every rank), invalidated ones too, so a genuine
                    # mismatch reaches the validator
                    reqs += [self.cache.request_for(b, other)
                             for b in m["b"]]
                stop |= self.coordinator.ingest(other, reqs,
                                                m["j"], m["x"])
            responses, all_joined = self.coordinator.compute_responses()
            resp_payload = _wire.dumps_resp({
                "resp": [p.wire() for p in responses],
                "i": glob_inv, "x": stop, "aj": all_joined,
                "lj": self.coordinator.last_joined})
        self.t.set(self._key("p", r), resp_payload)
        return resp_payload

    def _gc(self, gc: int) -> None:
        if self.rank != 0:
            return
        self.t.delete(self._key("k", gc))
        self.t.delete(self._key("p", gc))
        for other in range(self.world):
            self.t.delete(self._key("q", gc, other))

    def negotiate(self, requests: list, joined: bool,
                  shutdown: bool) -> NegotiationResult:
        r = self.round
        # this rank's submitted shape per pending name: the cache's
        # probe key when the response (maybe of a later round) lands
        for q in requests:
            self._pending_shapes[q.name] = tuple(q.shape)
        bits: list[int] = []
        invalid: list[int] = []
        explicit = requests
        if self.cache is not None:
            explicit = []
            for q in requests:
                state, bit = self.cache.probe(q)
                if state == HIT:
                    bits.append(bit)
                elif state == INVALID:
                    invalid.append(bit)
                    explicit.append(q)
                else:
                    explicit.append(q)
        self.explicit_requests += len(explicit)
        wire_msg = {
            "b": sorted(bits), "i": sorted(invalid),
            "req": [q.wire() for q in explicit],
            "j": joined, "x": shutdown}
        if r == 0:
            wire_msg["cfg"] = round0_cfg()
        payload = _wire.dumps_rank(wire_msg)
        if self.rank == 0:
            raws = self._fair_gather(
                r, {0: payload},
                {o: self._key("q", r, o) for o in range(1, self.world)},
                "request lists")
            resp_payload = self._coordinate(
                r, [raws[o] for o in range(self.world)])
        else:
            self.t.set(self._key("q", r, self.rank), payload)
            resp_payload = self._get_blocking(
                self._key("p", r),
                "waiting for the coordinator's response list")

        msg = _wire.loads_resp(resp_payload)
        self.round += 1
        if r >= 2:
            self._gc(r - 2)

        if "f" in msg:
            self.fast_rounds += 1
            singles = [self.cache.response_for(b) for b in msg["f"]]
            for s in singles:
                for name in s.names:
                    self._pending_shapes.pop(name, None)
            return NegotiationResult(fuse_singles(singles),
                                     False, -1, should_stop=False)
        responses = [Response.from_wire(w) for w in msg["resp"]]
        if self.cache is not None:
            self.cache.evict_bits(msg["i"])
            self.cache.record_responses(responses, self._pending_shapes)
        for resp in responses:
            for name in resp.names:
                self._pending_shapes.pop(name, None)
        return NegotiationResult(responses, msg["aj"], msg["lj"],
                                 should_stop=msg["x"])


# ---------------------------------------------------------------------------
# The transport
# ---------------------------------------------------------------------------


class StoreTransport:
    """The KV wire over a ``torch.distributed`` store (by default the
    default process group's), under a ``PrefixStore`` of this
    generation's epoch: the counterpart of ``JaxCoordTransport``, with
    its six methods."""

    def __init__(self, epoch: int = 0, store=None) -> None:
        import torch.distributed as dist

        if store is None:
            store = dist.distributed_c10d._get_default_store()
        self._s = dist.PrefixStore(f"hvd_eager{epoch}/", store)

    def set(self, key: str, value: str) -> None:
        self._s.set(key, value)

    def set_overwrite(self, key: str, value: str) -> None:
        self._s.set(key, value)

    def set_once(self, key: str, value: str) -> None:
        # sets only a key that does not exist yet
        self._s.compare_set(key, "", value)

    def get_blocking(self, key: str, timeout_s: float) -> str:
        from datetime import timedelta

        # a wait of 0 ms is no deadline at all to the store
        self._s.wait([key], timedelta(milliseconds=max(timeout_s * 1e3, 1)))
        return self._s.get(key).decode()

    def try_get(self, key: str):
        if not self._s.check([key]):
            return None
        return self._s.get(key).decode()

    def delete(self, key: str) -> None:
        self._s.delete_key(key)


def make_controller(rank: int, world: int, epoch: int = 0):
    """:class:`LocalController` for one rank, else a
    :class:`KVController` over the default group's store."""
    if world == 1:
        return LocalController()
    return KVController(StoreTransport(epoch), rank, world, epoch)
