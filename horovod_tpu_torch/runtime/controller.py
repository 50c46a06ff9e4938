"""Controller: the coordination plane that decides, every cycle, which
tensors are ready on every rank and how they fuse into collective
launches (counterpart of ``horovod_tpu/runtime/controller.py``).

Parity with reference ``horovod/common/controller.{h,cc}``: workers send
ready-tensor Requests; rank 0 counts them per name
(``controller.cc:789-812``), validates dtype/shape/op agreement (an
error Response on mismatch, ``controller.cc:378-611``), fuses ready
responses up to the fusion threshold (``controller.cc:640-761``), tracks
join and shutdown, and posts the ResponseList.

The wire is a key-value store: the launcher's native KV server
(``runtime/kvstore.KVStoreClient``) when ``hvdrun`` exported its
rendezvous, else :class:`StoreTransport` over the default process
group's ``torch.distributed`` store, or any object with the same six
methods (the tests' ``DictTransport``).  Messages are the binary
request and response lists of :mod:`horovod_tpu_torch.runtime.wire`,
keyed by round.  This is the JAX package's protocol: the flat star on
rank 0, or above ``HOROVOD_CONTROL_FANOUT`` the two-level star on slice
leaders (:func:`control_topology`), with heartbeats and the coordinated
abort (:class:`HeartbeatPublisher`, :meth:`KVController.check_liveness`).
It records the JAX package's control-plane metrics (rounds, wire retries
and timeouts, heartbeat publishes, gaps, staleness and sweep lag,
coordinated aborts) and flight events (``round``, ``arrive``,
``hb_pub``, ``hb_stale``, ``hb_fresh``, ``clk``, ``abort``,
``wire_timeout``), and :func:`make_controller` wraps the transport in
``HOROVOD_FAULT_SPEC``'s rules (``runtime/faults.py``).  The autotuner's
parameter broadcast waits for ROADMAP.md Queue A item 12h.
"""

from __future__ import annotations

import json
import threading
import time
import zlib
from dataclasses import dataclass, field

from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common import logging as _log
from horovod_tpu_torch.common.types import RanksDownError, dtype_from_code
from horovod_tpu_torch.runtime import flight as _flight
from horovod_tpu_torch.runtime import metrics as _metrics
from horovod_tpu_torch.runtime import wire as _wire
from horovod_tpu_torch.runtime.cache import HIT, INVALID, ResponseCache
from horovod_tpu_torch.runtime.stall import StallInspector

JOIN_NAME = "__hvd_join__"
RANKS_DOWN_PREFIX = RanksDownError.WIRE_PREFIX

# Control-plane observability (docs/metrics.md): one lock + dict op per
# record on the hot path.
_M_ROUNDS = _metrics.counter(
    "hvd_negotiation_rounds_total",
    "Negotiation rounds completed, labeled path=fast|slow.")
_M_RETRIES = _metrics.counter(
    "hvd_wire_retries_total",
    "Control-plane wire retries, labeled by op: KV client "
    "reconnect-and-retry attempts plus controller blocking-get slice "
    "expiries.")
_M_TIMEOUTS = _metrics.counter(
    "hvd_wire_timeouts_total",
    "Control-plane waits that exhausted HOROVOD_WIRE_TIMEOUT_SECONDS.")
_M_HB_PUB = _metrics.counter(
    "hvd_heartbeat_publishes_total", "Heartbeat beats published.")
_M_HB_FAIL = _metrics.counter(
    "hvd_heartbeat_publish_failures_total",
    "Heartbeat publishes that failed on the wire (swallowed; peers "
    "observe the absence).")
_M_HB_GAP = _metrics.gauge(
    "hvd_heartbeat_publish_gap_seconds",
    "Measured gap between this rank's consecutive heartbeat publishes "
    "(should track HOROVOD_HEARTBEAT_INTERVAL; a larger value means "
    "the publisher itself is being delayed).")
_M_HB_STALE = _metrics.gauge(
    "hvd_heartbeat_staleness_seconds",
    "Seconds since each swept peer's heartbeat last changed, labeled "
    "peer=<rank>.  Crossing HOROVOD_HEARTBEAT_TIMEOUT_SECONDS "
    "triggers the coordinated abort.")
_M_ABORTS = _metrics.counter(
    "hvd_coordinated_aborts_total",
    "Coordinated aborts this process observed or initiated.")
_M_SWEEP_LAG = _metrics.gauge(
    "hvd_heartbeat_sweep_lag_seconds",
    "How far one full pass over this rank's heartbeat sweep ring runs "
    "behind HOROVOD_HEARTBEAT_INTERVAL (0 when the budgeted sweep "
    "keeps up).  A persistently positive value means peers are "
    "sampled slower than they beat — the false-dead window is "
    "silently widening; shrink the ring (hierarchical control plane) "
    "or raise the interval.")

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
    """Every wire mode this rank's data plane can run: the uniform
    ``HOROVOD_COMPRESSION`` knob plus any ``HOROVOD_BUCKET_COMPRESSION``
    entries, and under ``HOROVOD_ADAPTIVE_COMPRESSION`` every lossy mode
    (the JAX package's tuner may pick any later, and the block and ratio
    knobs do not ride its proposals): the set that decides which
    mode-scoped knobs the round-0 handshake checks."""
    modes = {str(_config.get("compression")).strip().lower() or "none"}
    spec = str(_config.get("bucket_compression")).strip().lower()
    modes.update(m.strip() for m in spec.split(":") if m.strip())
    if _config.get("adaptive_compression"):
        modes.update(("int8", "int4", "topk"))
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


def round0_cfg(hb_interval: float | None = None,
               hb_timeout: float | None = None,
               control_fanout: int | None = None) -> list:
    """The round-0 handshake's i64 vector, in the JAX package's layout
    (``horovod_tpu/runtime/controller.py:round0_cfg``): every knob whose
    divergence across ranks would deadlock or corrupt the negotiated
    wire.  Each entry reads the port's knob where the port has it (the
    heartbeat pair and the control fanout included, in ms and as is;
    the adaptive, health, skip, checkpoint-replica and elastic knobs
    included).  A controller passes its own liveness and fanout
    values."""
    cmodes = _active_wire_modes()
    qbs = (_config.get("quant_block_size")
           if cmodes & {"int8", "int4"} else 0)
    topk_ppm = (int(round(float(_config.get("topk_ratio")) * 1e6))
                if "topk" in cmodes else 0)
    hier = (_config.get("hierarchical_allreduce")
            or _config.get("hierarchical_allgather"))
    stage = int(_config.get("zero_stage"))
    if hb_interval is None:
        hb_interval = max(float(_config.get("heartbeat_interval")), 0)
    if hb_timeout is None:
        hb_timeout = max(float(_config.get("heartbeat_timeout") or 0), 0)
    if control_fanout is None:
        control_fanout = max(int(_config.get("control_fanout")), 0)
    return [_config.get("cache_capacity"),
            _config.get("fusion_threshold"),
            _mode_code(str(_config.get("compression")).strip().lower(),
                       _COMPRESSION_WIRE_CODES),
            qbs,
            1 if _config.get("sharded_optimizer") else 0,
            int(round(hb_interval * 1000)),
            int(round(hb_timeout * 1000)),
            1 if _config.get("elastic") else 0,
            1 if _config.get("overlap") else 0,
            int(_config.get("overlap_chunks"))
            if _config.get("overlap") else 0,
            stage,
            int(_config.get("zero_prefetch_chunks")) if stage >= 2 else 0,
            topk_ppm,
            _bucket_modes_code(),
            1 if _config.get("adaptive_compression") else 0,
            1 if _config.get("hierarchical_allreduce") else 0,
            1 if _config.get("hierarchical_allgather") else 0,
            int(_config.get("hierarchical_local_size")) if hier else 0,
            _mode_code(str(_config.get("ragged_allgather")).strip().lower(),
                       _RAGGED_WIRE_CODES),
            1 if _config.get("health") else 0,
            1 if _config.get("health_skip_nonfinite") else 0,
            max(int(_config.get("checkpoint_replicas") or 0), 0),
            *_local_sgd_codes(),
            _mesh_code(),
            int(control_fanout)]


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
    eager regime) never fuse with each other or with world-scoped
    tensors; the executor reduces them over that hop only."""
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


# ---------------------------------------------------------------------------
# The hierarchical control plane
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ControlTopology:
    """The slice map of the hierarchical control plane: contiguous rank
    ranges of ``slice_size`` (the last may be ragged), each led by its
    lowest rank.  Rank 0 leads slice 0 and is the global coordinator, so
    the root handles one merged message per slice instead of one per
    rank."""

    world: int
    slice_size: int

    @property
    def n_slices(self) -> int:
        return -(-self.world // self.slice_size)

    def slice_of(self, rank: int) -> int:
        return rank // self.slice_size

    def leader_of(self, slice_id: int) -> int:
        return slice_id * self.slice_size

    def is_leader(self, rank: int) -> bool:
        return rank % self.slice_size == 0

    def members(self, slice_id: int) -> list[int]:
        lo = slice_id * self.slice_size
        return list(range(lo, min(lo + self.slice_size, self.world)))

    def leaders(self) -> list[int]:
        return [self.leader_of(s) for s in range(self.n_slices)]


def _slice_size_candidates(world: int) -> list[int]:
    """Physical groupings preferred over the raw fanout when they cut
    the world evenly: the launcher's local size (when every host holds
    as many ranks) and ``HOROVOD_HIERARCHICAL_LOCAL_SIZE``."""
    from horovod_tpu_torch.common import basics as _basics

    cands: list[int] = []
    st = _basics._state
    if st.initialized and st.local_size * st.cross_size == st.size:
        cands.append(int(st.local_size))
    cands.append(int(_config.get("hierarchical_local_size")))
    return cands


def control_topology(world: int,
                     fanout: int | None = None) -> ControlTopology | None:
    """The slice map for ``world``, or ``None`` for the flat plane.  The
    hierarchy starts at ``world > fanout >= 2`` (fanout 0 keeps any
    world flat); the slice size is a physical grouping that divides the
    world evenly where there is one, else the fanout."""
    if fanout is None:
        fanout = max(int(_config.get("control_fanout")), 0)
    if fanout < 2 or world <= fanout:
        return None
    size = int(fanout)
    for cand in _slice_size_candidates(world):
        if 1 < cand < world and world % cand == 0:
            size = cand
            break
    return ControlTopology(world, size)


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


class HeartbeatPublisher:
    """The thread that publishes this rank's liveness beat: ``seq:wall``
    (a counter and the wall clock) at ``hvd<epoch>/hb/<rank>`` every
    ``HOROVOD_HEARTBEAT_INTERVAL`` seconds, the first beat at once.
    Peers sweep the key; one that stops changing for
    ``HOROVOD_HEARTBEAT_TIMEOUT_SECONDS`` marks the rank dead and starts
    the coordinated abort.  A failed publish is swallowed: a rank that
    cannot reach the store is down, and the peers' sweep reports it."""

    def __init__(self, transport, key: str, interval_s: float):
        self.t = transport
        self.key = key
        self.interval_s = interval_s
        self._seq = 0
        self._last_pub: float | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="hvd-heartbeat", daemon=True)
        self._thread.start()

    def _publish(self) -> None:
        self._seq += 1
        # the wall clock in the beat: each new beat a peer observes is a
        # ``clk`` offset sample for the trace merge's clock alignment
        value = f"{self._seq}:{time.time():.6f}"
        _flight.record("hb_pub", seq=self._seq)
        setter = getattr(self.t, "set_overwrite", None)
        try:
            if setter is not None:
                setter(self.key, value)
            else:
                self.t.set(self.key, value)
        except Exception:  # noqa: BLE001 -- the peers' sweep reports it
            try:
                self.t.delete(self.key)
                self.t.set(self.key, value)
            except Exception:  # noqa: BLE001
                _M_HB_FAIL.inc()
                _flight.record("hb_pub_fail", seq=self._seq)
        now = time.monotonic()
        if self._last_pub is not None:
            # publish to publish, the publish's own wire time included
            _M_HB_GAP.set(now - self._last_pub)
        self._last_pub = now
        _M_HB_PUB.inc()

    def _run(self) -> None:
        self._publish()
        while not self._stop.wait(self.interval_s):
            self._publish()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
        try:
            self.t.delete(self.key)
        except Exception:  # noqa: BLE001 -- the store may be gone
            pass


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
    package's protocol).

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
    Above ``fanout`` (:func:`control_topology`) the exchange is two-level
    (:meth:`_exchange_hier`): members post to their slice leader, each
    leader forwards one merged message to rank 0 and fans the response
    list back down; the responses are byte-identical to the flat
    plane's.  Round 0 carries :func:`round0_cfg` from every rank; a
    mismatch fails every rank with one error response.  ``timeout``
    (default :func:`wire_timeout`) bounds each wait on the store.

    Liveness (``HOROVOD_HEARTBEAT_INTERVAL`` and ``_TIMEOUT_SECONDS`` both
    above 0, once :meth:`start_heartbeat` has run): every rank beats, and
    sweeps the peers of its ring (:meth:`_sweep_ring`) between wait
    slices and at every cycle; a peer silent past the timeout fails the
    sweeping rank with :class:`RanksDownError` after it made the abort
    visible to every survivor (:meth:`_broadcast_abort`)."""

    def __init__(self, transport, rank: int, world: int, epoch: int = 0,
                 timeout: float | None = None, fanout: int | None = None):
        self.t = transport
        self.rank = rank
        self.world = world
        self.epoch = epoch
        self.round = 0
        self.coordinator = Coordinator(world) if rank == 0 else None
        self._fanout = (max(int(_config.get("control_fanout")), 0)
                        if fanout is None else max(int(fanout), 0))
        self._hier = control_topology(world, self._fanout)
        self._timeout = wire_timeout() if timeout is None else timeout
        self.cache = (ResponseCache()
                      if _config.get("cache_capacity") > 0 else None)
        self._pending_shapes: dict[str, tuple] = {}
        self.fast_rounds = 0
        # requests this rank shipped with their metadata (not as hit bits)
        self.explicit_requests = 0
        # liveness: peer -> [last beat, monotonic time it last changed,
        # suspected]
        self._hb_interval = max(float(_config.get("heartbeat_interval")), 0)
        self._hb_timeout = max(
            float(_config.get("heartbeat_timeout") or 0), 0)
        self._beats: dict[int, list] = {}
        self._last_sweep = 0.0
        self._sweep_cursor = 0
        self._sweep_wrap_t: float | None = None
        self._sweep_covered = 0
        self._abort_key = self._key("a")
        self._heartbeat: HeartbeatPublisher | None = None

    def _key(self, *parts) -> str:
        # epoch-namespaced: a shutdown() + init() generation never meets
        # the previous generation's keys
        return f"hvd{self.epoch}/" + "/".join(str(p) for p in parts)

    # -- liveness ----------------------------------------------------------

    def start_heartbeat(self) -> None:
        """Start publishing this rank's beat (once); the background
        runtime calls it when its loop starts."""
        if self._heartbeat is None and self._hb_interval > 0 \
                and self._hb_timeout > 0:
            self._heartbeat = HeartbeatPublisher(
                self.t, self._key("hb", self.rank), self._hb_interval)

    def close(self) -> None:
        if self._heartbeat is not None:
            self._heartbeat.stop()
            self._heartbeat = None
        # this world is over: its per-peer staleness series go with it
        _M_HB_STALE.reset()
        _M_SWEEP_LAG.reset()
        # the launcher's KV client is this controller's own connection
        closer = getattr(self.t, "close", None)
        if closer is not None:
            try:
                closer()
            except Exception:  # noqa: BLE001 -- the world is over
                pass

    def _liveness_enabled(self) -> bool:
        return (self._hb_interval > 0 and self._hb_timeout > 0
                and self._heartbeat is not None)

    def _sweep_ring(self) -> list[int]:
        """The peers this rank watches: rank 0 and everyone in the flat
        star; under the hierarchical plane a leader its slice's members
        and rank 0 (rank 0 the other leaders), a member its leader."""
        h = self._hier
        if h is None:
            return list(range(1, self.world)) if self.rank == 0 else [0]
        s = h.slice_of(self.rank)
        lead = h.leader_of(s)
        if self.rank != lead:
            return [lead]
        ring = [m for m in h.members(s) if m != self.rank]
        if self.rank == 0:
            ring += [ld for ld in h.leaders() if ld != 0]
        else:
            ring.append(0)
        return ring

    def _sweep_budget_s(self, ring_len: int) -> float:
        """One sweep's wire budget: one interval per 8 peers, between 1
        and 8 intervals."""
        base = max(self._hb_interval, 0.25)
        return base * max(1.0, min(ring_len / 8.0, 8.0))

    def _note_sweep_coverage(self, ring_len: int, probed: int) -> None:
        """Publish the sweep-lag gauge: how far one complete pass over
        the ring runs behind the heartbeat interval (0 = keeping up)."""
        now = time.monotonic()
        if self._sweep_wrap_t is None:
            self._sweep_wrap_t = now
        self._sweep_covered += probed
        if self._sweep_covered >= ring_len:
            period = now - self._sweep_wrap_t
            _M_SWEEP_LAG.set(
                max(0.0, period - max(self._hb_interval, 1e-9)))
            self._sweep_wrap_t = now
            self._sweep_covered = 0

    def _sweep_peers(self) -> list[tuple[int, float]]:
        """One heartbeat sweep: ``[(dead rank, seconds silent)]``.  A
        peer's clock starts at the first sweep that looks at it, so a
        rank that never beats is flagged one timeout after that.  A sweep
        that runs out of budget resumes at its cursor next time."""
        now = time.monotonic()
        ring = self._sweep_ring()
        if len(ring) > 1:
            start = self._sweep_cursor % len(ring)
            peers = ring[start:] + ring[:start]
        else:
            start, peers = 0, ring
        budget_deadline = now + self._sweep_budget_s(len(ring))
        probed = len(peers)
        dead: list[tuple[int, float]] = []
        for i, peer in enumerate(peers):
            if i and time.monotonic() > budget_deadline:
                self._sweep_cursor = (start + i) % len(ring)
                probed = i
                break
            try:
                value = self.t.try_get(self._key("hb", peer))
            except Exception:  # noqa: BLE001 -- no evidence of death
                value = None
            rec = self._beats.get(peer)
            if rec is None:
                self._beats[peer] = [value, now, False]
                _M_HB_STALE.set(0.0, peer=str(peer))
                if value is not None:
                    self._clock_sample(peer, value)
                continue
            if value is not None and value != rec[0]:
                if rec[2]:
                    _flight.record("hb_fresh", peer=peer,
                                   stale_s=round(now - rec[1], 3))
                rec[0], rec[1], rec[2] = value, now, False
                self._clock_sample(peer, value)
            stale = now - rec[1]
            _M_HB_STALE.set(stale, peer=str(peer))
            if value is None or value == rec[0]:
                # once per silence, at half the deadline: when this rank
                # first suspected the peer
                if stale > self._hb_timeout / 2 and not rec[2]:
                    rec[2] = True
                    _flight.record("hb_stale", peer=peer,
                                   stale_s=round(stale, 3))
                if stale > self._hb_timeout:
                    dead.append((peer, stale))
        self._note_sweep_coverage(len(ring), probed)
        return dead

    @staticmethod
    def _clock_sample(peer: int, value: str) -> None:
        """A ``clk`` offset sample from a newly observed beat: the
        event's own wall stamp minus the publisher's ``peer_wall`` is
        (this clock - peer clock) + the one-way publish latency; the
        trace merge pairs both directions of a link to bound it."""
        try:
            peer_wall = float(value.split(":", 1)[1])
        except (IndexError, ValueError):
            return
        _flight.record("clk", peer=int(peer), peer_wall=peer_wall)

    def _abort_message(self, dead: list[tuple[int, float]]) -> str:
        ranks = sorted(r for r, _ in dead)
        stale = max(s for _, s in dead)
        return (f"{RANKS_DOWN_PREFIX} " + json.dumps({
            "ranks": ranks, "round": self.round,
            "elapsed": round(stale, 1), "by": self.rank}) +
            f" — rank(s) {ranks} missed heartbeats for {stale:.1f}s "
            f"(> HOROVOD_HEARTBEAT_TIMEOUT_SECONDS="
            f"{self._hb_timeout:.0f}) at negotiation round {self.round}; "
            "aborting all in-flight collectives. The rank(s) likely "
            "crashed or were preempted.")

    def _broadcast_abort(self, msg: str) -> None:
        """Coordinator or leader: make the abort visible to every
        survivor -- the abort key for pollers, and an error response
        list at every response slot a peer may be waiting on: ``p/<r>``
        (rank 0) and this leader's slice slot ``sp/<slice>/<r>``."""
        payload = _wire.dumps_resp({
            "resp": [Response(kind="error", names=[JOIN_NAME],
                              error=msg).wire()],
            "i": [], "x": True, "aj": False, "lj": -1})
        try:
            self.t.set_once(self._abort_key, msg)
        except Exception:  # noqa: BLE001 -- best effort on a dying world
            pass
        if self.rank == 0:
            try:
                self.t.set_once(self._key("p", self.round), payload)
            except Exception:  # noqa: BLE001
                pass
        if self._hier is not None and self._hier.is_leader(self.rank):
            s = self._hier.slice_of(self.rank)
            try:
                self.t.set_once(self._key("sp", s, self.round), payload)
            except Exception:  # noqa: BLE001
                pass

    def check_liveness(self) -> None:
        """Sweep the heartbeats and raise :class:`RanksDownError` (after
        the abort broadcast, on the coordinator or a leader) if a peer
        is silent past the timeout, or if another rank already
        broadcast an abort.  Throttled to one sweep per half interval
        (at least 50 ms), so calling it every cycle is cheap."""
        if not self._liveness_enabled():
            return
        now = time.monotonic()
        if now - self._last_sweep < max(self._hb_interval / 2, 0.05):
            return
        self._last_sweep = now
        abort = None
        try:
            abort = self.t.try_get(self._abort_key)
        except Exception:  # noqa: BLE001 -- retried next sweep
            pass
        if abort:
            _M_ABORTS.inc()
            exc = RanksDownError(abort)
            _flight.record("abort", ranks=list(exc.ranks),
                           round=exc.round, observed=True)
            raise exc
        dead = self._sweep_peers()
        if not dead:
            return
        _M_ABORTS.inc()
        _flight.record("abort", ranks=sorted(r for r, _ in dead),
                       round=self.round, observed=False)
        msg = self._abort_message(dead)
        _log.error(msg, rank=self.rank)
        if self.rank == 0 or (self._hier is not None
                              and self._hier.is_leader(self.rank)):
            self._broadcast_abort(msg)
        else:
            # this rank's upstream died: leave the note for the others
            try:
                self.t.set_once(self._abort_key, msg)
            except Exception:  # noqa: BLE001
                pass
        raise RanksDownError(msg)

    def _poll_slice_s(self) -> float:
        """A blocking wait's slice: half an interval (0.1-1 s) with
        liveness on, so a death shows between slices; else at most 5 s."""
        return (min(max(self._hb_interval / 2, 0.1), 1.0)
                if self._liveness_enabled()
                else min(self._timeout, 5.0))

    # -- the wire ----------------------------------------------------------

    def _wire_timeout_error(self, key: str, rnd: int,
                            context: str) -> TimeoutError:
        _M_TIMEOUTS.inc(op="get_blocking")
        _flight.record("wire_timeout", key=key, round=rnd)
        return TimeoutError(
            f"kv get({key}) timed out after "
            f"{self._timeout:.0f}s (rank {self.rank}, round "
            f"{rnd}, epoch {self.epoch}; {context}). "
            "Raise HOROVOD_WIRE_TIMEOUT_SECONDS if the job is "
            "merely slow.")

    def _get_blocking(self, key: str, context: str) -> str:
        """A wait on ``key`` in slices (:meth:`_poll_slice_s`), up to the
        wire deadline, with a liveness check after each slice."""
        deadline = time.monotonic() + self._timeout
        slice_s = self._poll_slice_s()
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise self._wire_timeout_error(key, self.round, context)
            t0 = time.monotonic()
            try:
                return self.t.get_blocking(key, min(slice_s, remaining))
            except Exception:  # noqa: BLE001 -- slice expired or transient
                _M_RETRIES.inc(op="get_blocking")
                if time.monotonic() - t0 < 0.05:
                    time.sleep(min(slice_s, 0.05))
            self.check_liveness()

    def _fair_gather(self, r: int, got: dict[int, str],
                     expected: dict[int, str], what: str) -> dict[int, str]:
        """Collect ``expected[peer] -> key`` payloads into ``got`` by
        polling every missing peer in turn (so one slow rank does not
        delay noticing the others), up to the wire deadline, with a
        liveness check between sweeps.  Shared by the flat coordinator,
        the slice leaders and the root's merge of the slices."""
        missing = list(expected)
        deadline = time.monotonic() + self._timeout
        # one retry tick per expired wait slice, as the blocking get
        slice_s = self._poll_slice_s()
        slice_mark = time.monotonic()
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
                    # the arrival, on the gatherer's own clock: the
                    # straggler analyzer's signal
                    _flight.record("arrive", peer=other, round=r)
                    progressed = True
            if not missing:
                break
            if time.monotonic() > deadline:
                raise self._wire_timeout_error(
                    expected[missing[0]], r,
                    f"waiting for rank(s) {missing}'s {what}")
            self.check_liveness()
            if not progressed:
                now = time.monotonic()
                if now - slice_mark >= slice_s:
                    slice_mark = now
                    _M_RETRIES.inc(op="get_blocking")
                time.sleep(0.001)
        return got

    def _gather_request_lists(self, r: int, payload: str) -> list:
        """The flat coordinator: every rank's round-``r`` request list."""
        _flight.record("arrive", peer=0, round=r)
        raws = self._fair_gather(
            r, {0: payload},
            {o: self._key("q", r, o) for o in range(1, self.world)},
            "request lists")
        return [raws[o] for o in range(self.world)]

    def should_participate(self, have_pending: bool) -> bool:
        # liveness first: an idle rank notices a death or an abort too
        self.check_liveness()
        if have_pending:
            return True
        h = self._hier
        if h is None:
            return self.t.try_get(self._key("k", self.round)) is not None
        # members poll their slice's kick key only; the leader relays
        # kicks both ways between its slice and the world
        s = h.slice_of(self.rank)
        sk = self._key("sk", s, self.round)
        if self.rank != h.leader_of(s):
            return self.t.try_get(sk) is not None
        k = self._key("k", self.round)
        if self.t.try_get(k) is not None:
            self.t.set_once(sk, "1")
            return True
        if self.t.try_get(sk) is not None:
            self.t.set_once(k, "1")
            return True
        return False

    def kick(self) -> None:
        h = self._hier
        if h is None:
            self.t.set_once(self._key("k", self.round), "1")
            return
        s = h.slice_of(self.rank)
        if self.rank == h.leader_of(s):
            self.t.set_once(self._key("k", self.round), "1")
        self.t.set_once(self._key("sk", s, self.round), "1")

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
                _flight.record("round", ph="E", round=r, error=True)
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

    def _exchange_hier(self, r: int, payload: str) -> str:
        """The two-level round-``r`` exchange: members post at
        ``sq/<slice>/<r>/<rank>`` and wait on the slice's fan-down
        ``sp/<slice>/<r>``; each leader gathers its slice, forwards one
        merged message at ``gq/<r>/<slice>`` (rank 0 merges them all and
        coordinates) and posts rank 0's response list to its slice."""
        h = self._hier
        s = h.slice_of(self.rank)
        leader = h.leader_of(s)
        if self.rank != leader:
            self.t.set(self._key("sq", s, r, self.rank), payload)
            return self._get_blocking(
                self._key("sp", s, r),
                "waiting for the slice leader's response fan-down")
        _flight.record("arrive", peer=self.rank, round=r)
        merged = self._fair_gather(
            r, {self.rank: payload},
            {m: self._key("sq", s, r, m)
             for m in h.members(s) if m != self.rank},
            f"slice-{s} request lists")
        merged_payload = json.dumps(
            {str(k): v for k, v in sorted(merged.items())})
        if self.rank == 0:
            slices = self._fair_gather(
                r, {0: merged_payload},
                {h.leader_of(o): self._key("gq", r, o)
                 for o in range(1, h.n_slices)},
                "merged slice request lists")
            raws: list = [None] * self.world
            for mp in slices.values():
                for rk, pl in json.loads(mp).items():
                    raws[int(rk)] = pl
            resp_payload = self._coordinate(r, raws)
        else:
            self.t.set(self._key("gq", r, s), merged_payload)
            resp_payload = self._get_blocking(
                self._key("p", r),
                "waiting for the coordinator's response list")
        self.t.set(self._key("sp", s, r), resp_payload)
        return resp_payload

    def _gc(self, gc: int) -> None:
        """Delete round ``gc``'s keys: rank 0 all of them on the flat
        plane; under the hierarchy each leader its slice's, rank 0 also
        the global ones."""
        h = self._hier
        if h is None:
            if self.rank != 0:
                return
            self.t.delete(self._key("k", gc))
            self.t.delete(self._key("p", gc))
            for other in range(self.world):
                self.t.delete(self._key("q", gc, other))
            return
        s = h.slice_of(self.rank)
        if self.rank != h.leader_of(s):
            return
        self.t.delete(self._key("sp", s, gc))
        self.t.delete(self._key("sk", s, gc))
        for m in h.members(s):
            if m != self.rank:
                self.t.delete(self._key("sq", s, gc, m))
        if self.rank == 0:
            self.t.delete(self._key("k", gc))
            self.t.delete(self._key("p", gc))
            for o in range(1, h.n_slices):
                self.t.delete(self._key("gq", gc, o))

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
            wire_msg["cfg"] = round0_cfg(self._hb_interval,
                                         self._hb_timeout, self._fanout)
        payload = _wire.dumps_rank(wire_msg)
        # round open: this rank's request list hits the wire (names
        # capped, so one large round cannot evict the ring)
        _flight.record("round", ph="B", round=r, n_req=len(requests),
                       n_hits=len(bits),
                       names=[q.name for q in requests[:16]])
        if self._hier is not None:
            resp_payload = self._exchange_hier(r, payload)
        elif self.rank == 0:
            resp_payload = self._coordinate(
                r, self._gather_request_lists(r, payload))
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
            _M_ROUNDS.inc(path="fast")
            singles = [self.cache.response_for(b) for b in msg["f"]]
            for s in singles:
                for name in s.names:
                    self._pending_shapes.pop(name, None)
            _flight.record("round", ph="E", round=r, path="fast",
                           n_resp=len(singles))
            return NegotiationResult(fuse_singles(singles),
                                     False, -1, should_stop=False)
        _M_ROUNDS.inc(path="slow")
        responses = [Response.from_wire(w) for w in msg["resp"]]
        _flight.record("round", ph="E", round=r, path="slow",
                       n_resp=len(responses), stop=bool(msg["x"]))
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
    :class:`KVController` over the launcher's KV server when ``hvdrun``
    exported its rendezvous (``HOROVOD_GLOO_RENDEZVOUS_ADDR``/``PORT``:
    heartbeats, negotiation and the coordinated abort then outlive rank
    0's process), else over the default group's store; wrapped in
    ``HOROVOD_FAULT_SPEC``'s rules when the knob is set."""
    if world == 1:
        return LocalController()
    from horovod_tpu_torch.runtime import faults as _faults

    addr = _config.get("rendezvous_addr")
    port = _config.get("rendezvous_port")
    if addr and port:
        from horovod_tpu_torch.runtime.kvstore import KVStoreClient

        transport = KVStoreClient(addr, port)
    else:
        transport = StoreTransport(epoch)
    return KVController(_faults.maybe_wrap(transport, rank), rank, world,
                        epoch)
