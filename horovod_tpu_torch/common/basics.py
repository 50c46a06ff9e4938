"""Process-world bring-up over ``torch.distributed``.

Reads the launcher's env contract (``HOROVOD_RANK/SIZE/LOCAL_RANK/
LOCAL_SIZE/CROSS_RANK/CROSS_SIZE/COORDINATOR_ADDR``, exported by
``python -m horovod_tpu_torch.run``; the JAX package's launcher spawns
ranks of this package unchanged), else a pod orchestrator's
(``run/pod.py``).  With no env the world is one process.
The process group is started at every size -- ``nccl`` on CUDA, ``gloo``
on the CPU -- so a one-process run takes the same collective path as a
larger one.

``init(mesh=...)`` (or ``HOROVOD_MESH``) names a data mesh: ``init``
builds its process groups once, on every rank in the same order
(``parallel/mesh.py``), and the gradient collectives reduce over its dp
axis.  At world > 1 ``init`` also starts the eager plane's background
runtime (negotiation and heartbeats), as the JAX package does.

:func:`teardown_distributed` is the bounded teardown an elastic re-form
runs before it calls ``init`` again (``elastic.py``); on NCCL it aborts
the communicators first, since a group with a dead member can hang a
plain destroy.

``init`` and ``shutdown`` carry the observability hooks of the JAX
package's: the goodput ledger's start and ``init`` phase, the
``hvd_world_size``/``hvd_generation`` gauges, the per-rank metrics
endpoint (``HOROVOD_METRICS_PORT``), the fatal-signal dump handlers and
the ``init``/``shutdown`` flight records and dumps.  ``shutdown`` and
:func:`teardown_distributed` close rank 0's timeline
(``HOROVOD_TIMELINE``), so an elastic re-form flushes the old
generation's trace and the new rank 0 opens a fresh one.  With
``HOROVOD_TIMELINE_JAX_PROFILER`` set, ``init`` opens every rank's
whole-run ``torch.profiler`` capture (``runtime.timeline.
TorchProfilerBridge``), and both close it, so the old generation's trace
lands before a re-form's ``init`` opens the next under ``gen<g>/``.
"""

from __future__ import annotations

import os
import threading
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common import logging as _log
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.common.util import free_port, resolve_device


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.initialized = False
        self.rank = 0
        self.size = 1
        self.local_rank = 0
        self.local_size = 1
        self.cross_rank = 0
        self.cross_size = 1
        self.device = torch.device("cpu")
        self.data_mesh = None   # parallel.mesh.RankMesh of HOROVOD_MESH
        self.data_axes = None   # its axis sizes, e.g. {'dp': 4, 'tp': 2}
        self.epoch = 0          # init() generation: namespaces eager keys
        self.eager_hop = None   # the eager plane's world (its own group)
        self.eager_pair = None  # its (cross, local) pair, or None
        self.background = None  # runtime.background.BackgroundRuntime
        self.timeline = None    # rank 0's runtime.timeline writer
        self.metrics_server = None     # per-rank /metrics endpoint
        self.metrics_publisher = None  # KV snapshot publisher
        # the card of the process's first init(): a re-init (an elastic
        # re-form) keeps it, whatever local rank the new roster gives
        # this process -- its tensors and its card stay together
        self.first_device = None
        # a peer of this generation is known dead (a liveness sweep
        # raised RanksDownError): shutdown() then meets no barrier
        self.peer_down = False
        self.profiler = None  # runtime.timeline.TorchProfilerBridge


_state = _State()
# HOROVOD_TIMELINE_JAX_PROFILER dir -> the epoch that first opened it
_PROF_DIR_EPOCH0: dict = {}


def state() -> _State:
    return _state


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    return int(raw) if raw.strip() else default


def _platform_device():
    """``cpu`` when ``HOROVOD_PLATFORM`` asks for the CPU, else None
    (the default device, ``cuda``)."""
    plat = str(_config.get("platform") or "").strip().lower()
    return "cpu" if plat == "cpu" else None


def _apply_pod_env() -> None:
    """Without a launcher's ``HOROVOD_SIZE``/``HOROVOD_RANK``, take the
    world from a pod orchestrator's environment (``run/pod.detect``),
    exported as the launcher would.  Multislice (megascale) discovery
    needs a cluster resolver ``torch.distributed`` does not have, and
    raises."""
    if "HOROVOD_SIZE" in os.environ or "HOROVOD_RANK" in os.environ:
        return
    from horovod_tpu_torch.run import pod as _pod

    info = _pod.detect()
    if info is None:
        return
    if info.auto:
        found = sorted(k for k in os.environ if k.startswith("MEGASCALE_"))
        raise HorovodTpuError(
            f"pod metadata ({info.source}: {', '.join(found)}) asks for "
            "multislice cluster resolution, which torch.distributed does "
            "not have; launch with python -m horovod_tpu_torch.run or "
            "export HOROVOD_RANK/SIZE/COORDINATOR_ADDR")
    if info.size > 1:
        os.environ.setdefault("HOROVOD_COORDINATOR_ADDR", info.coordinator)
        os.environ["HOROVOD_RANK"] = str(info.rank)
        os.environ["HOROVOD_SIZE"] = str(info.size)
        _log.info(f"pod metadata ({info.source}): rank={info.rank} "
                  f"size={info.size}", rank=info.rank)


def init(device=None, timeout_s: float = 300.0, mesh=None) -> None:
    """Initialize the world.  ``device`` is where this rank computes:
    ``cuda`` (the default; local rank ``i`` takes card ``i``) or
    ``cpu`` (also chosen by ``HOROVOD_PLATFORM=cpu``).  A re-init keeps
    the card of the process's first ``init``.  The process group's
    timeout is at least three heartbeat timeouts, so NCCL's watchdog
    never tears a survivor down before the heartbeat's verdict; in
    elastic mode on gloo it is ``max(3 heartbeat timeouts, 30 s)``: gloo
    has no abort, and the op timeout is what releases a survivor that
    waits on a peer which already left for a re-form.  ``mesh`` names
    the data mesh: a spec string (``'dp:4,tp:2'``), an axis dict, or a
    mesh object whose axis names come from ``parallel.mesh.AXES`` and
    include ``dp`` (a torch ``DeviceMesh`` or a
    ``parallel.mesh.RankMesh``); it is exported as
    ``HOROVOD_MESH`` and must agree with a ``HOROVOD_MESH`` already set.
    Idempotent until :func:`shutdown`."""
    with _state.lock:
        if _state.initialized:
            return
        # the goodput ledger's wall clock starts at the first init();
        # the bring-up lands in its "init" phase (advisory)
        t_init = time.monotonic()
        try:
            from horovod_tpu_torch.perf import goodput as _goodput

            _goodput.start()
        except Exception:  # noqa: BLE001 -- observability never fails init
            _goodput = None
        from horovod_tpu_torch.runtime import faults as _faults

        # a malformed HOROVOD_FAULT_SPEC fails before any group exists,
        # at every world size
        _faults.check_spec()
        _apply_mesh_arg(mesh)
        _apply_pod_env()
        if device is None and _state.first_device is not None:
            dev = _state.first_device
        else:
            dev = resolve_device(device if device is not None
                                 else _platform_device())
        size = _env_int("HOROVOD_SIZE", 1)
        rank = _env_int("HOROVOD_RANK", 0)
        if not 0 <= rank < size:
            raise HorovodTpuError(
                f"HOROVOD_RANK={rank} is outside HOROVOD_SIZE={size}")
        axes = _mesh_axes(size)
        local_rank = _env_int("HOROVOD_LOCAL_RANK", rank)
        local_size = _env_int("HOROVOD_LOCAL_SIZE", size)
        if size > 1:
            coord = str(_config.get("coordinator_addr")).strip()
            if not coord:
                raise HorovodTpuError(
                    "HOROVOD_SIZE > 1 but HOROVOD_COORDINATOR_ADDR is not "
                    "set (the launcher exports it)")
        else:
            coord = f"127.0.0.1:{free_port()}"
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", local_rank)
            torch.cuda.set_device(dev)
            backend = "nccl"
        else:
            backend = "gloo"
        hb_timeout = float(_config.get("heartbeat_timeout") or 0)
        pg_timeout = max(timeout_s, 3 * hb_timeout)
        if backend == "gloo" and _config.get("elastic"):
            # gloo has no abort that frees a rank's own pending op: a
            # survivor waiting on a live peer that already left the
            # collective for a re-form is released by the op timeout
            pg_timeout = max(3 * hb_timeout, 30.0)
        if not dist.is_initialized():
            dist.init_process_group(
                backend, init_method=f"tcp://{coord}", world_size=size,
                rank=rank, timeout=timedelta(seconds=pg_timeout))
        _state.rank, _state.size = rank, size
        _state.local_rank, _state.local_size = local_rank, local_size
        _state.cross_rank = _env_int("HOROVOD_CROSS_RANK", 0)
        _state.cross_size = _env_int("HOROVOD_CROSS_SIZE", 1)
        _state.device = dev
        if _state.first_device is None and dev.type == "cuda":
            _state.first_device = dev
        _state.epoch += 1
        _state.initialized = True
        _open_profiler_bridge()
        _build_eager_groups()
        if axes is not None:
            _build_data_mesh(axes)
        _start_observability()
        if _goodput is not None:
            try:
                _goodput.observe("init", time.monotonic() - t_init)
            except Exception:  # noqa: BLE001
                pass
        _log.debug(f"init: backend={backend} size={size} device={dev}",
                   rank=rank)
    if _state.size > 1:
        # every rank negotiates and beats from the start (reference
        # InitializeHorovodOnce): a rank whose first eager op comes late
        # is a late rank, not a dead one
        from horovod_tpu_torch.ops import eager as _eager

        _eager.start_runtime()


def _open_profiler_bridge() -> None:
    """The whole-run device capture of ``HOROVOD_TIMELINE_JAX_PROFILER``
    (``horovod_tpu/common/basics.py:217-247``).  It starts here, not in
    the background runtime, so a world of one records too."""
    prof_dir = _config.get("jax_profiler")
    if not prof_dir:
        return
    from horovod_tpu_torch.runtime.timeline import TorchProfilerBridge

    # a prior generation's bridge still holding the profiler (a teardown
    # path that never ran) is closed, so its trace lands and the new
    # capture can start
    _close_profiler()
    # Generation is relative to the first time THIS process opened THIS
    # logdir: a plain shutdown()+init() against a fresh dir gets the
    # rank<k> layout; only a re-form over the same dir moves to
    # gen<g>/rank<k>.
    base = _PROF_DIR_EPOCH0.setdefault(str(prof_dir), _state.epoch)
    try:
        _state.profiler = TorchProfilerBridge(
            prof_dir, _state.rank, generation=_state.epoch - base + 1,
            device=_state.device)
    except Exception as exc:  # noqa: BLE001 -- capture is advisory
        _log.warning(f"torch.profiler capture unavailable: {exc!r}",
                     rank=_state.rank)


def _close_profiler() -> None:
    """Stop the whole-run capture and write its trace (idempotent)."""
    prof, _state.profiler = _state.profiler, None
    if prof is not None:
        try:
            prof.close()
        except Exception as exc:  # noqa: BLE001 -- advisory
            _log.warning(f"torch.profiler capture close failed: {exc!r}",
                         rank=_state.rank)


def _close_timeline() -> None:
    """Flush, join and drop rank 0's timeline writer (idempotent)."""
    tl, _state.timeline = _state.timeline, None
    if tl is not None:
        try:
            tl.close()
        except Exception as exc:  # noqa: BLE001 -- advisory
            _log.warning(f"timeline close failed: {exc!r}",
                         rank=_state.rank)


def _start_observability() -> None:
    """The metrics plane's topology gauges and per-rank endpoint, the
    fatal-signal dump handlers, the ``init`` flight record and the AOT
    cache's announcement (``horovod_tpu/common/basics.py:248-300``)."""
    from horovod_tpu_torch.runtime import flight as _flight
    from horovod_tpu_torch.runtime import metrics as _metrics

    _metrics.gauge(
        "hvd_world_size", "Current world size.").set(_state.size)
    _metrics.gauge(
        "hvd_generation",
        "Communicator generation (KV epoch; bumps on every "
        "elastic re-form).").set(_state.epoch)
    if _state.metrics_server is not None:
        _state.metrics_server.close()
    _state.metrics_server = _metrics.start_rank_endpoint(_state.rank)
    if _state.metrics_publisher is not None:
        _state.metrics_publisher.stop()
    _state.metrics_publisher = _metrics.maybe_start_kv_publisher(
        _state.rank, _state.size, _state.epoch)
    _flight.install_signal_handlers()
    _flight.record("init", rank=_state.rank, size=_state.size,
                   generation=_state.epoch)
    # The persistent AOT cache: nothing to open (entries are keyed per
    # library or program on demand), but the operator should see where
    # warm starts come from, and a re-init announces under the new
    # topology (horovod_tpu/common/basics.py:280-295).
    from horovod_tpu_torch.runtime import aot_cache as _aot

    if _aot.enabled():
        _log.info(f"aot-cache: {_aot.cache_dir()} (mode={_aot.mode()}) — "
                  "kernel and host libraries load from cache when keys "
                  "match", rank=_state.rank)
        _flight.record("aot", event="enabled", dir=_aot.cache_dir(),
                       mode=_aot.mode())


def _apply_mesh_arg(mesh) -> None:
    """Canonicalize an ``init(mesh=...)`` argument into the ``mesh``
    knob (``horovod_tpu/common/basics.py:391-430``)."""
    if mesh is None:
        return
    from horovod_tpu_torch.parallel import mesh as _pmesh

    if isinstance(mesh, str):
        axes = _pmesh.parse_mesh_spec(mesh)
    elif isinstance(mesh, dict):
        axes = _pmesh.parse_mesh_spec(
            ",".join(f"{k}:{v}" for k, v in mesh.items()))
    else:
        names = getattr(mesh, "mesh_dim_names", None) \
            or getattr(mesh, "axis_names", None)
        shape = getattr(mesh, "shape", None)
        if names is None or shape is None:
            raise HorovodTpuError(
                "init(mesh=...) wants a spec string ('dp:4,tp:2'), an "
                "axis dict, or a DeviceMesh; got "
                f"{type(mesh).__name__}")
        shape = dict(zip(names, tuple(shape)))
        bad = sorted(n for n in shape if n not in _pmesh.AXES)
        if bad:
            raise HorovodTpuError(
                f"init(mesh=...) axis names must come from "
                f"{'/'.join(_pmesh.AXES)}; got {bad}")
        if _pmesh.DATA_AXIS not in shape:
            raise HorovodTpuError(
                "init(mesh=...) mesh has no 'dp' axis; the gradient "
                "stack reduces over dp")
        axes = {a: int(shape.get(a, 1)) for a in _pmesh.AXES}
    canon = _pmesh.canonical_spec(axes)
    knob = str(_config.get("mesh") or "").strip()
    if knob and _pmesh.canonical_spec(_pmesh.parse_mesh_spec(knob)) != canon:
        raise HorovodTpuError(
            f"init(mesh=...) ({canon!r}) disagrees with HOROVOD_MESH "
            f"({knob!r}); set one, not both")
    _config.set_knob("mesh", canon)


def _mesh_axes(size: int):
    """The axis sizes the ``mesh`` knob names, or ``None``: a spec that
    does not cover the world exactly raises (training on it would reduce
    over the wrong replica groups)."""
    spec = str(_config.get("mesh") or "").strip()
    if not spec:
        return None
    from horovod_tpu_torch.parallel import mesh as _pmesh

    axes = _pmesh.parse_mesh_spec(spec)
    n = 1
    for v in axes.values():
        n *= int(v)
    if n != size:
        raise HorovodTpuError(
            f"HOROVOD_MESH {_pmesh.canonical_spec(axes)!r} covers {n} "
            f"ranks but the world has {size}; every rank must belong to "
            "exactly one mesh coordinate")
    return axes


def _build_data_mesh(axes) -> None:
    """Build the data mesh of ``axes`` (every rank, one order)."""
    from horovod_tpu_torch.parallel import mesh as _pmesh

    _state.data_mesh = _pmesh.build_data_mesh(axes)
    _state.data_axes = _state.data_mesh.sizes()
    _log.debug(f"data mesh {_pmesh.canonical_spec(axes)}: axes "
               f"{_state.data_axes}", rank=_state.rank)


def _build_eager_groups() -> None:
    """The eager plane's own process group over the world (and, when
    ``HOROVOD_HIERARCHICAL_ALLREDUCE``/``_ALLGATHER`` or the local-SGD
    regime (``HOROVOD_LOCAL_SGD_H >= 2``) ask for it and the layout
    admits a (cross, local) split, its local and cross groups), built
    here on every rank
    in one order: the background thread's collectives never share a
    communicator with the caller's in-trace ones, and a rank that joins
    early never has to build a group late."""
    from horovod_tpu_torch.parallel import mesh as _pmesh

    size, rank = _state.size, _state.rank
    group = dist.new_group(list(range(size))) if size > 1 else None
    _state.eager_hop = _pmesh.Hop(range(size), rank, group, "eager")
    _state.eager_pair = None
    if size > 1 and (_config.get("hierarchical_allreduce")
                     or _config.get("hierarchical_allgather")
                     or int(_config.get("local_sgd_h") or 0) > 1):
        local, warn = _pmesh.hier_admissibility(
            size, rank, _state.local_size, _state.cross_size,
            _state.cross_rank, _state.local_rank)
        if warn:
            _log.warning(warn, rank=rank)
        if local:
            shape = (size // local, local)
            _state.eager_pair = _pmesh.HopPair(
                _pmesh._axis_groups(shape, (0,), rank, "eager_cross"),
                _pmesh._axis_groups(shape, (1,), rank, "eager_local"),
                _state.eager_hop)
    if size > 1 and dist.get_backend() == "gloo":
        # gloo connects a new group eagerly: nobody leaves init while a
        # peer still connects
        dist.barrier()


def shutdown() -> None:
    """Stop the eager runtime (its shutdown round stops every rank's),
    then tear the process groups down."""
    with _state.lock:
        if not _state.initialized:
            return
        from horovod_tpu_torch.runtime import flight as _flight

        _flight.record("shutdown", rank=_state.rank,
                       generation=_state.epoch)
        # the goodput ledger's final accounting beside the flight dumps
        # (abort paths dump through flight.dump_on_failure)
        try:
            from horovod_tpu_torch.perf import goodput as _goodput

            _goodput.dump("shutdown")
        except Exception:  # noqa: BLE001 -- advisory
            pass
        # ...and the health monitor's, with every queued verdict
        # published first (python -m horovod_tpu_torch.perf health
        # covers healthy runs too)
        try:
            from horovod_tpu_torch.runtime import health as _health

            _health.flush()
            if _health._monitor is not None:
                _health.dump("shutdown")
        except Exception:  # noqa: BLE001 -- advisory
            pass
        peer_down = _state.peer_down
        if _state.background is not None:
            bg, _state.background = _state.background, None
            bg.stop()
            peer_down = peer_down or bg.aborted()
            if _state.size > 1 and not peer_down:
                # no rank tears down the store while a peer still reads
                # the shutdown round from it (after a coordinated abort
                # a peer is dead: nobody would meet this barrier)
                dist.barrier()
        _close_timeline()
        _close_profiler()
        if _state.metrics_server is not None:
            _state.metrics_server.close()
            _state.metrics_server = None
        if _state.metrics_publisher is not None:
            _state.metrics_publisher.stop()
            _state.metrics_publisher = None
        if dist.is_initialized():
            if peer_down:
                teardown_distributed()
            else:
                dist.destroy_process_group()
        _state.data_mesh = _state.data_axes = None
        _state.eager_hop = _state.eager_pair = None
        _state.peer_down = False
        _state.initialized = False


def abort_communicators() -> None:
    """Abort every NCCL communicator of this generation (the coordinated
    abort's data-plane half): a collective still waiting on a dead peer
    fails instead of hanging, and the process groups are gone.  Gloo
    needs nothing: a dead peer resets its connections.  Safe to call
    from the background thread."""
    if not dist.is_initialized() or dist.get_backend() != "nccl":
        return
    from torch.distributed import distributed_c10d as c10d

    try:
        # every group of the world, in one NCCL group call, and torch's
        # registry cleared (a later init_process_group starts afresh)
        c10d._abort_process_group()
        _log.warning("aborted every NCCL communicator of generation "
                     f"{_state.epoch} (_abort_process_group)",
                     rank=_state.rank)
    except Exception as exc:  # noqa: BLE001 -- best effort, dying world
        _log.warning(f"NCCL abort failed: {exc!r}", rank=_state.rank)


def teardown_distributed(timeout_s: float | None = None) -> bool:
    """Destroy every process group (the default group, the eager plane's
    and the data mesh's), bounded by ``HOROVOD_SHUTDOWN_TIMEOUT_SECONDS``:
    on NCCL through the communicators' abort (a plain destroy of a group
    with a dead member can hang), on gloo through a destroy run on a
    helper thread.  Returns False when the deadline passed first (the
    groups are then abandoned)."""
    # the generation's trace ends on a whole record before its world
    # goes (shutdown() may have closed it already); the device capture
    # lands, and the re-init's next one can start
    _close_timeline()
    _close_profiler()
    if not dist.is_initialized():
        return True
    timeout_s = (float(_config.get("shutdown_timeout"))
                 if timeout_s is None else float(timeout_s))
    if dist.get_backend() == "nccl":
        work = abort_communicators
    else:
        work = dist.destroy_process_group
    t = threading.Thread(target=work, name="hvd-teardown", daemon=True)
    t.start()
    t.join(max(timeout_s, 0.1))
    if t.is_alive():
        _log.warning(f"process-group teardown still running after "
                     f"{timeout_s:.0f}s; abandoning it", rank=_state.rank)
        return False
    return True


def is_initialized() -> bool:
    return _state.initialized


def _check() -> _State:
    if not _state.initialized:
        raise HorovodTpuError(
            "horovod_tpu_torch has not been initialized; call init() "
            "first")
    return _state


def rank() -> int:
    return _check().rank


def size() -> int:
    return _check().size


def local_rank() -> int:
    return _check().local_rank


def local_size() -> int:
    return _check().local_size


def cross_rank() -> int:
    return _check().cross_rank


def cross_size() -> int:
    return _check().cross_size


def device() -> torch.device:
    """The device :func:`init` bound this rank to."""
    return _check().device


def data_mesh():
    """The named data mesh (``parallel.mesh.RankMesh``) built at
    :func:`init`, or ``None`` in the flat world.  Under hierarchical
    mode its dp axis is the ``("dpc", "dpl")`` pair."""
    return _check().data_mesh


def data_parallel_size() -> int:
    """Replicas of the gradient reduction: the data mesh's dp extent
    when one is named, else the world size."""
    from horovod_tpu_torch.parallel import mesh as _pmesh

    dp = _pmesh.data_parallel_size()
    return dp if dp is not None else _check().size
