"""Metrics plane: process-local registry + exposition (counterpart of
``horovod_tpu/runtime/metrics.py``; the same metric names, kinds, help
strings, labels and Prometheus text).

The registry the runtime's subsystems write into, and the surfaces that
read it:

* ``hvd.metrics()`` -- a nested snapshot dict;
* a per-rank Prometheus-text HTTP endpoint
  (``HOROVOD_METRICS_PORT`` + rank, off by default);
* ``aggregate_snapshots`` / ``aggregate_render``: the fleet merge of
  published snapshots (pure functions over a ``key -> str`` getter),
  which the ranks' ``KVSnapshotPublisher`` feeds through the
  launcher's KV store every ``HOROVOD_METRICS_PUBLISH_INTERVAL``
  seconds (``maybe_start_kv_publisher``).

Design constraints (``tests/test_torch_metrics.py``):

* import stays stdlib-only (no ``prometheus_client``, no torch);
* the hot path (a counter increment) is lock-cheap: one mutex + dict
  op, no syscalls, no IO -- IO happens only on the endpoint thread.

Histograms use fixed log2 buckets (upper bounds ``2**k`` for ``k`` in
``[lo, hi]`` plus ``+Inf``) so cross-rank series are always mergeable
without bucket negotiation.

``trace_step`` opens a ``torch.profiler.record_function`` span named
after the step, so a ``torch.profiler`` capture sees it.  Its wall
clock is the host's: it does not synchronize the device, so a step
whose kernels are still queued when the span closes is timed as far as
the host got; a step that ends in ``torch.cuda.synchronize()`` is timed
whole.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import socket
import threading
import time

from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common import logging as _log
from horovod_tpu_torch.runtime import flight as _flight

_INF = float("inf")


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _esc_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _esc_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(v) -> str:
    if v == _INF:
        return "+Inf"
    if isinstance(v, float) and v.is_integer() and abs(v) < 2 ** 53:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


class _Metric:
    """Base: one named metric holding labeled series.  The per-metric
    lock guards only the series dict — an increment is acquire +
    dict-get/set + release, nothing else."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: dict[tuple, float] = {}

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))

    def total(self) -> float:
        with self._lock:
            return float(sum(self._series.values()))

    def series(self) -> list:
        with self._lock:
            return [{"labels": dict(k), "value": v}
                    for k, v in sorted(self._series.items())]

    def reset(self) -> None:
        """Drop every series of this metric.  For topology-scoped
        gauges (per-peer staleness): the old generation's peers must
        not survive into snapshots published after a re-form."""
        with self._lock:
            self._series.clear()


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0) + value


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = value

    def replace(self, series: list) -> None:
        """Atomically swap ALL series of this gauge in one lock
        acquisition — a concurrent snapshot sees the old set or the new
        set, never the empty/partial window a reset()+set() spelling
        leaves.  ``series`` is ``[(labels_dict, value), ...]``."""
        new = {_label_key(labels): float(v) for labels, v in series}
        with self._lock:
            self._series = new

    def inc(self, value: float = 1, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0) + value


class Histogram(_Metric):
    """Fixed log2 buckets: upper bounds ``2**k`` for ``k in [lo, hi]``
    plus ``+Inf``.  Defaults suit seconds-scale latencies (~61 µs to
    512 s)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", lo: int = -14,
                 hi: int = 9):
        super().__init__(name, help)
        self.bounds = [2.0 ** k for k in range(lo, hi + 1)]
        # series value: [per-bucket counts..., +Inf count, sum, count]

    def observe(self, value: float, **labels) -> None:
        k = _label_key(labels)
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            s = self._series.get(k)
            if s is None:
                s = self._series[k] = [0] * (len(self.bounds) + 1) + [0.0, 0]
            s[i] += 1
            s[-2] += value
            s[-1] += 1

    def value(self, **labels) -> float:
        """Observation count for one label set."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            return float(s[-1]) if s else 0.0

    def total(self) -> float:
        with self._lock:
            return float(sum(s[-1] for s in self._series.values()))

    def series(self) -> list:
        out = []
        with self._lock:
            items = sorted((k, list(v)) for k, v in self._series.items())
        for k, s in items:
            cum, buckets = 0, []
            for le, n in zip(self.bounds + [_INF], s[:-2]):
                cum += n
                buckets.append(["+Inf" if le == _INF else le, cum])
            out.append({"labels": dict(k), "buckets": buckets,
                        "sum": s[-2], "count": s[-1]})
        return out


class MetricsRegistry:
    """Get-or-create metric table.  Creation takes the registry lock;
    recording goes straight to the metric's own lock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name} already registered as {m.kind}, "
                    f"not {cls.kind}")
            elif help and not m.help:
                m.help = help
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "", lo: int = -14,
                  hi: int = 9) -> Histogram:
        return self._get(Histogram, name, help, lo=lo, hi=hi)

    def snapshot(self) -> dict:
        """Nested dict of every metric's current series — the
        ``hvd.metrics()`` payload and the KV-published wire format."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: {"kind": m.kind, "help": m.help,
                         "series": m.series()}
                for m in sorted(metrics, key=lambda m: m.name)}

    def render(self) -> str:
        """This process's metrics in Prometheus text format 0.0.4."""
        return render_snapshots([{"meta": {}, "metrics": self.snapshot()}])

    def clear(self) -> None:  # test hook
        with self._lock:
            self._metrics.clear()


_registry = MetricsRegistry()

# Pre-snapshot hooks: callables invoked (best-effort) right before a
# snapshot is taken for exposition — the scrape render, hvd.metrics(),
# and the KV publisher payload.  The goodput ledger registers its gauge
# refresh here so derived series (phase attribution, the unattributed
# gap growing during a stall) are current on every read instead of
# only at step boundaries.
_SNAPSHOT_HOOKS: list = []


def add_snapshot_hook(fn) -> None:
    if fn not in _SNAPSHOT_HOOKS:
        _SNAPSHOT_HOOKS.append(fn)


def remove_snapshot_hook(fn) -> None:
    try:
        _SNAPSHOT_HOOKS.remove(fn)
    except ValueError:
        pass


def _run_snapshot_hooks() -> None:
    # Stand down inside the fatal-signal handler (the terminal KV flush
    # runs there): hooks like the goodput refresh read counters behind
    # PLAIN locks the interrupted main thread may hold — the flush must
    # publish what exists, not deadlock the handler refreshing it.
    if _flight._in_signal_handler:
        return
    for fn in list(_SNAPSHOT_HOOKS):
        try:
            fn()
        except Exception:  # exposition must never fail a scrape
            pass


def registry() -> MetricsRegistry:
    return _registry


def counter(name: str, help: str = "") -> Counter:
    return _registry.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _registry.gauge(name, help)


def histogram(name: str, help: str = "", lo: int = -14,
              hi: int = 9) -> Histogram:
    return _registry.histogram(name, help, lo=lo, hi=hi)


# ---------------------------------------------------------------------------
# Rendering (shared by the per-rank endpoint and the launcher aggregate)
# ---------------------------------------------------------------------------


def _render_sample(name: str, labels: dict, value, out: list) -> None:
    if labels:
        body = ",".join(f'{k}="{_esc_label(str(v))}"'
                        for k, v in sorted(labels.items()))
        out.append(f"{name}{{{body}}} {_fmt(value)}")
    else:
        out.append(f"{name} {_fmt(value)}")


def render_snapshots(snaps: list) -> str:
    """Merge snapshot dicts (``{"meta": {...}, "metrics": {...}}``) into
    one Prometheus text page.  Each snapshot's series gain ``rank`` /
    ``host`` labels from its meta, so the launcher aggregate keeps every
    process's series distinguishable (per-rank endpoints pass one
    snapshot with empty meta and get plain series)."""
    by_name: dict[str, dict] = {}
    for snap in snaps:
        meta = snap.get("meta") or {}
        extra = {}
        if "rank" in meta:
            extra["rank"] = str(meta["rank"])
        if meta.get("host"):
            extra["host"] = str(meta["host"])
        for name, m in (snap.get("metrics") or {}).items():
            slot = by_name.setdefault(
                name, {"kind": m.get("kind", "untyped"),
                       "help": m.get("help", ""), "series": []})
            for s in m.get("series") or []:
                labels = dict(s.get("labels") or {})
                labels.update(extra)
                merged = dict(s)
                merged["labels"] = labels
                slot["series"].append(merged)
    out: list[str] = []
    for name in sorted(by_name):
        m = by_name[name]
        if m["help"]:
            out.append(f"# HELP {name} {_esc_help(m['help'])}")
        out.append(f"# TYPE {name} {m['kind']}")
        for s in m["series"]:
            if m["kind"] == "histogram":
                for le, cum in s.get("buckets") or []:
                    bl = dict(s["labels"])
                    bl["le"] = _fmt(le) if not isinstance(le, str) else le
                    _render_sample(f"{name}_bucket", bl, cum, out)
                _render_sample(f"{name}_sum", s["labels"], s.get("sum", 0),
                               out)
                _render_sample(f"{name}_count", s["labels"],
                               s.get("count", 0), out)
            else:
                _render_sample(name, s["labels"], s.get("value", 0), out)
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# Snapshot surface (hvd.metrics()) and the step-span tracer
# ---------------------------------------------------------------------------


def _process_meta() -> dict:
    meta = {"host": socket.gethostname(),
            "time": time.time()}
    try:
        from horovod_tpu_torch.common import basics as _basics

        st = _basics.state()
        if st.initialized:
            meta.update({"rank": st.rank, "size": st.size,
                         "generation": st.epoch})
    except Exception:
        pass
    return meta


def metrics() -> dict:
    """``hvd.metrics()``: nested snapshot of every registered metric
    plus process meta (rank/size/generation when initialized).  Pure
    host-side dict — safe to call from any thread, never touches the
    device."""
    _run_snapshot_hooks()
    return {"meta": _process_meta(), "metrics": _registry.snapshot()}


# Step-span metrics.  "comm" is background-thread dispatch busy time
# (it may overlap compute — the overlap engine exists to make it);
# "blocked" is framework-thread handle-wait time (communication the
# schedule failed to hide); "input_wait" is hvd.data_wait() time spent
# starved on the input pipeline; "compute" is wall minus blocked minus
# input_wait.
_STEP_HIST = histogram(
    "hvd_step_time_seconds",
    "Wall time per hvd.trace_step() span (rolling log2 histogram).")
_STEPS = counter("hvd_steps_total", "trace_step() spans recorded.")
_PHASE = counter(
    "hvd_step_phase_seconds_total",
    "Per-step wall time split: compute | comm (background dispatch, "
    "may overlap compute) | blocked (handle waits) | input_wait "
    "(hvd.data_wait spans).")
_LAST = gauge("hvd_step_last_seconds",
              "Last trace_step() span, split by phase plus wall.")
_BLOCKED = counter(
    "hvd_handle_wait_seconds_total",
    "Framework-thread seconds blocked in synchronize()/handle waits.")
_COMM = counter(
    "hvd_comm_dispatch_seconds_total",
    "Background-thread seconds executing negotiated collectives.")
_DATA_WAIT = counter(
    "hvd_data_wait_seconds_total",
    "Seconds the training thread spent starved on the input pipeline "
    "(hvd.data_wait() spans / hvd.wrap_data_loader) — the bottleneck "
    "the device observatory cannot see (docs/goodput.md).")

# Registered at 0 for the goodput ledger's compile split: the JAX
# package counts its negotiated-program builds here; the port has no
# such compile (cuDNN's autotuning is not one), so nothing increments
# it.
_COMPILE = counter(
    "hvd_compile_seconds_total",
    "Wall seconds spent materializing negotiated programs, labeled "
    "path=cold (trace + lower + XLA compile) vs path=warm (AOT cache "
    "load).")

# Open trace_step spans in this process: data_wait uses it to decide
# whether its seconds are attributed by the enclosing step's split
# (counter delta) or directly as out-of-step input_wait on the goodput
# ledger.  A plain int mutated under the GIL from the (single) training
# thread; cross-thread data_wait during a step still lands once, via
# the counter delta.
_open_steps = 0


def _compile_total() -> float:
    """Negotiated-program compile wall (the aot_cache cold/warm
    counter) — trace_step samples it to attribute in-step compiles on
    the goodput ledger."""
    return _COMPILE.total()


@contextlib.contextmanager
def data_wait(source: str = "data"):
    """Span the training thread's wait on the input pipeline (an
    iterator ``next()``, a host2device feed, a remote batch fetch).
    Seconds land on ``hvd_data_wait_seconds_total``, the flight ring,
    and the goodput ledger's ``input_wait`` phase — closing the
    blind spot where a starved input pipeline reads as "compute"
    (docs/goodput.md).  Spans shorter than
    ``HOROVOD_DATA_WAIT_MIN_SECONDS`` are ignored (noise floor)."""
    try:
        # start the ledger clock at span entry, so the first wait of an
        # uninitialized process is inside elapsed, not scaled away
        from horovod_tpu_torch.perf import goodput as _goodput

        _goodput.start()
    except Exception:
        pass
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        try:
            floor = float(_config.get("data_wait_min") or 0.0)
        except (TypeError, ValueError):
            floor = 0.0
        if dt > 0 and dt >= floor:
            _DATA_WAIT.inc(dt, source=source)
            _flight.record("data_wait", s=round(dt, 6), source=source)
            if _open_steps <= 0:
                # outside a step: the span attributes itself (inside
                # one, the enclosing trace_step's counter delta does)
                try:
                    from horovod_tpu_torch.perf import goodput as _goodput

                    _goodput.observe("input_wait", dt)
                except Exception:
                    pass


def wrap_data_loader(iterable, source: str = "data"):
    """Wrap any iterable/iterator so every ``next()`` is timed as a
    :func:`data_wait` span — the one-line way to instrument an input
    pipeline::

        for batch in hvd.wrap_data_loader(loader):
            with hvd.trace_step(step=i):
                ...
    """
    def _gen():
        it = iter(iterable)
        while True:
            with data_wait(source):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    return _gen()


@contextlib.contextmanager
def trace_step(step: int | None = None, name: str = "hvd_step"):
    """Span one training step: wall time lands in the
    ``hvd_step_time_seconds`` histogram, split into compute / comm /
    blocked phases from the runtime's own accounting, and the span is
    labelled for ``torch.profiler`` by one ``record_function(name)``.
    The wall is the host's clock; the device is not synchronized."""
    global _open_steps
    try:  # ledger clock starts at the first span of uninitialized runs
        from horovod_tpu_torch.perf import goodput as _goodput

        _goodput.start()
    except Exception:
        pass
    t0 = time.perf_counter()
    blocked0 = _BLOCKED.total()
    comm0 = _COMM.total()
    dwait0 = _DATA_WAIT.total()
    compile0 = _compile_total()
    _open_steps += 1
    _flight.record("step", ph="B",
                   step=int(step) if step is not None else -1)
    ann = None
    try:  # advisory: the span only labels a torch.profiler capture
        from torch.profiler import record_function

        ann = record_function(name)
        ann.__enter__()
    except Exception:
        ann = None
    try:
        yield
    finally:
        if ann is not None:
            try:
                ann.__exit__(None, None, None)
            except Exception:
                pass
        wall = time.perf_counter() - t0
        _open_steps = max(0, _open_steps - 1)
        blocked = min(max(0.0, _BLOCKED.total() - blocked0), wall)
        comm = min(max(0.0, _COMM.total() - comm0), wall)
        input_wait = min(max(0.0, _DATA_WAIT.total() - dwait0), wall)
        compile_d = max(0.0, _compile_total() - compile0)
        compute = max(0.0, wall - blocked - input_wait)
        _STEP_HIST.observe(wall)
        _STEPS.inc()
        _PHASE.inc(compute, phase="compute")
        _PHASE.inc(comm, phase="comm")
        _PHASE.inc(blocked, phase="blocked")
        if input_wait:
            _PHASE.inc(input_wait, phase="input_wait")
        _LAST.set(wall, phase="wall")
        _LAST.set(compute, phase="compute")
        _LAST.set(comm, phase="comm")
        _LAST.set(blocked, phase="blocked")
        _LAST.set(input_wait, phase="input_wait")
        # Goodput ledger (docs/goodput.md): this span's wall split into
        # exclusive phases by priority budget -- input_wait first (the
        # measured starvation), then comm_exposed (the blocked split;
        # the sampled device capture is ROADMAP.md Queue A item 12i),
        # then negotiated-compile wall that advanced during the span,
        # compute as the remainder.  Each clamped to what's left of the
        # wall so the step's phases sum to it exactly.
        try:
            exposed, exposed_src = blocked, "trace_step"
            budget = wall - input_wait
            exposed = min(max(0.0, exposed), max(0.0, budget))
            budget -= exposed
            compile_in = min(compile_d, max(0.0, budget))
            budget -= compile_in
            from horovod_tpu_torch.perf import goodput as _goodput

            _goodput.observe_step(
                wall, compute=max(0.0, budget),
                comm_exposed=exposed, input_wait=input_wait,
                compile_s=compile_in, exposed_source=exposed_src)
        except Exception:
            pass
        # Flight-recorder step span: the per-step comm/compute/blocked
        # split lands on the postmortem record too, so the trace
        # analyzer can show where each rank's step time went.
        _flight.record("step", ph="E",
                       step=int(step) if step is not None else -1,
                       wall_s=round(wall, 6),
                       compute_s=round(compute, 6),
                       comm_s=round(comm, 6),
                       blocked_s=round(blocked, 6),
                       input_wait_s=round(input_wait, 6))


# ---------------------------------------------------------------------------
# Per-rank HTTP endpoint
# ---------------------------------------------------------------------------


class MetricsHTTPServer:
    """Tiny threaded HTTP server: ``/metrics`` (Prometheus text 0.0.4)
    and ``/metrics.json`` (the snapshot dict).  ``render_fn`` runs on
    the serving thread — scrapes never touch the training threads
    beyond per-metric lock acquisitions."""

    def __init__(self, render_fn, port: int, json_fn=None,
                 host: str = "0.0.0.0"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                try:
                    if self.path.startswith("/metrics.json"):
                        body = json.dumps(
                            json_fn() if json_fn else {}).encode()
                        ctype = "application/json"
                    elif self.path == "/" or \
                            self.path.startswith("/metrics"):
                        body = render_fn().encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                    else:
                        self.send_error(404)
                        return
                except Exception as exc:  # pragma: no cover
                    self.send_error(500, str(exc)[:200])
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request lines
                pass

        self._srv = ThreadingHTTPServer((host, port), Handler)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="hvd-metrics-http",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        try:
            self._srv.shutdown()
            self._srv.server_close()
        except Exception:
            pass
        self._thread.join(timeout=2)


def start_rank_endpoint(rank: int):
    """Per-rank endpoint at ``HOROVOD_METRICS_PORT + rank`` (0 = off,
    the default).  Under ``hvdrun`` the launcher serves the fleet
    aggregate on the operator's port and exports ``base + 1`` to ranks,
    so nothing collides on a shared host.  Returns the server or
    None."""
    base = int(_config.get("metrics_port") or 0)
    if base <= 0:
        return None
    port = base + max(0, int(rank))

    def _render_with_hooks() -> str:
        _run_snapshot_hooks()
        return _registry.render()

    try:
        srv = MetricsHTTPServer(_render_with_hooks, port, json_fn=metrics)
    except OSError as exc:
        _log.warning(
            f"metrics endpoint unavailable on port {port}: {exc}")
        return None
    _log.info(f"metrics endpoint serving on :{port}/metrics", rank=rank)
    return srv


# ---------------------------------------------------------------------------
# KV snapshot publisher (rank side) + aggregation (launcher side)
# ---------------------------------------------------------------------------

INDEX_KEY = "metrics/index"


def _rank_key(epoch: int, rank: int) -> str:
    return f"hvd{epoch}/metrics/{rank}"


class KVSnapshotPublisher:
    """Background thread publishing this process's snapshot into the
    rendezvous KV every ``HOROVOD_METRICS_PUBLISH_INTERVAL`` seconds
    (0 disables).  Rank 0 additionally maintains ``metrics/index``
    ({epoch, size}) — the head pointer the launcher aggregate follows
    across elastic re-forms, which is what keeps a dead generation's
    series from resurfacing.  Publish failures are swallowed:
    observability must never take a healthy rank down.  All IO happens
    on this thread; the training threads only touch in-memory
    counters."""

    def __init__(self, transport, rank: int, world: int, epoch: int,
                 interval_s: float, own_transport: bool = False):
        self.t = transport
        self.rank = rank
        self.world = world
        self.epoch = epoch
        self.interval_s = interval_s
        self._own_transport = own_transport
        self._host = socket.gethostname()
        self._seq = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="hvd-metrics-pub", daemon=True)
        self._thread.start()

    def _payload(self) -> str:
        self._seq += 1
        _run_snapshot_hooks()
        return json.dumps({
            "meta": {"rank": self.rank, "host": self._host,
                     "size": self.world, "generation": self.epoch,
                     "seq": self._seq, "time": time.time()},
            "metrics": _registry.snapshot()})

    def publish(self) -> None:
        setter = getattr(self.t, "set_overwrite", None) or self.t.set
        try:
            setter(_rank_key(self.epoch, self.rank), self._payload())
            if self.rank == 0:
                setter(INDEX_KEY, json.dumps(
                    {"epoch": self.epoch, "size": self.world}))
        except Exception:
            pass

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.publish()

    def stop(self) -> None:
        self._stop.set()
        # final flush so short-lived jobs still land their last counts
        self.publish()
        self._thread.join(timeout=2)
        if self._own_transport:
            closer = getattr(self.t, "close", None)
            if closer is not None:
                try:
                    closer()
                except Exception:
                    pass


def maybe_start_kv_publisher(rank: int, world: int, epoch: int):
    """Start the KV snapshot publisher over the launcher's rendezvous
    store, on a dedicated client connection.  Deliberately independent
    of the negotiation controller: an elastic world shrunk to size 1
    runs a LocalController with no transport at all, yet its metrics
    must keep reaching the launcher aggregate (the acceptance case:
    the fleet view must show the post-re-form generation/size).
    Returns None when publishing is off or no rendezvous is configured
    (without the rendezvous KV there is no launcher-readable store)."""
    interval = float(_config.get("metrics_publish_interval") or 0)
    addr = _config.get("rendezvous_addr")
    port = _config.get("rendezvous_port")
    if interval <= 0 or not addr or not port:
        return None
    try:
        from horovod_tpu_torch.runtime.kvstore import KVStoreClient

        client = KVStoreClient(addr, port, connect_timeout_s=5.0)
    except Exception as exc:  # observability must never fail init
        _log.warning(f"metrics KV publisher unavailable: {exc}")
        return None
    return KVSnapshotPublisher(client, rank, world, epoch, interval,
                               own_transport=True)


def aggregate_snapshots(try_get, extra_snapshots=()) -> tuple[list, dict]:
    """Read the fleet's published snapshots through ``try_get`` (a
    ``key -> str | None`` callable, e.g. a KVStoreClient's).  Follows
    ``metrics/index`` to the current generation, so only the live
    world's series are returned.  Returns (snapshots, index)."""
    snaps = list(extra_snapshots)
    idx = {}
    try:
        raw = try_get(INDEX_KEY)
        if raw:
            idx = json.loads(raw)
    except Exception:
        idx = {}
    epoch = int(idx.get("epoch", 0) or 0)
    size = int(idx.get("size", 0) or 0)
    for r in range(size):
        try:
            raw = try_get(_rank_key(epoch, r))
            if raw:
                snaps.append(json.loads(raw))
        except Exception:
            continue
    return snaps, idx


def snapshot_age_snapshot(snaps: list, now: float | None = None) -> dict:
    """Synthetic ``hvd_metrics_snapshot_age_seconds{rank=...}`` gauges
    from the published snapshots' own timestamps: a wedged per-rank
    publisher becomes visible as a growing age instead of the merge
    silently serving its stale series forever."""
    now = time.time() if now is None else now
    series = []
    for s in snaps:
        meta = (s or {}).get("meta") or {}
        ts = meta.get("time")
        if meta.get("rank") is None or not isinstance(ts, (int, float)):
            continue
        series.append({"labels": {"rank": str(meta["rank"])},
                       "value": round(max(0.0, now - float(ts)), 3)})
    return {"meta": {}, "metrics": {
        "hvd_metrics_snapshot_age_seconds": {
            "kind": "gauge",
            "help": "Seconds since each rank's KV metrics snapshot was "
                    "published; a growing age means that rank's "
                    "publisher is wedged and its other series are "
                    "stale.",
            "series": series}}} if series else {"meta": {}, "metrics": {}}


def aggregate_render(try_get, extra_snapshots=(), fleet=None) -> str:
    """Fleet-wide Prometheus page for the launcher's ``/metrics``:
    every live rank's series labeled ``rank``/``host``, plus synthetic
    ``hvd_fleet_generation`` / ``hvd_fleet_size`` /
    ``hvd_metrics_snapshot_age_seconds`` gauges — and, when ``fleet``
    (a ``perf.goodput.FleetGoodput``) is passed, the fleet goodput /
    bottleneck / SLO-alert gauges (docs/goodput.md)."""
    snaps, idx = aggregate_snapshots(try_get, extra_snapshots)
    age = snapshot_age_snapshot(snaps)
    if age["metrics"]:
        snaps.append(age)
    if fleet is not None:
        try:
            snaps.append(fleet.synthetic_snapshot(snaps))
        except Exception:  # goodput gauges must never cost the scrape
            pass
    if idx:
        snaps.append({"meta": {}, "metrics": {
            "hvd_fleet_generation": {
                "kind": "gauge",
                "help": "Current communicator generation (KV epoch) "
                        "per the rank-0 metrics index.",
                "series": [{"labels": {},
                            "value": int(idx.get("epoch", 0) or 0)}]},
            "hvd_fleet_size": {
                "kind": "gauge",
                "help": "World size of the current generation.",
                "series": [{"labels": {},
                            "value": int(idx.get("size", 0) or 0)}]},
        }})
    return render_snapshots(snaps)
