"""Process-world bring-up over ``torch.distributed``.

Reads the launcher's env contract (``HOROVOD_RANK/SIZE/LOCAL_RANK/
LOCAL_SIZE/CROSS_RANK/CROSS_SIZE/COORDINATOR_ADDR``, exported by
``horovod_tpu/run/launcher.py``), so the JAX package's launcher spawns
ranks of this package unchanged.  With no env the world is one process.
The process group is started at every size -- ``nccl`` on CUDA, ``gloo``
on the CPU -- so a one-process run takes the same collective path as a
larger one.

``init(mesh=...)`` (or ``HOROVOD_MESH``) names a data mesh: ``init``
builds its process groups once, on every rank in the same order
(``parallel/mesh.py``), and the gradient collectives reduce over its dp
axis.
"""

from __future__ import annotations

import os
import threading
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


_state = _State()


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    return int(raw) if raw.strip() else default


def init(device=None, timeout_s: float = 300.0, mesh=None) -> None:
    """Initialize the world.  ``device`` is where this rank computes:
    ``cuda`` (the default; local rank ``i`` takes card ``i``) or
    ``cpu``.  ``mesh`` names the data mesh: a spec string
    (``'dp:4,tp:2'``), an axis dict, or a mesh object whose axis names
    come from ``parallel.mesh.AXES`` and include ``dp`` (a torch
    ``DeviceMesh`` or a ``parallel.mesh.RankMesh``); it is exported as
    ``HOROVOD_MESH`` and must agree with a ``HOROVOD_MESH`` already set.
    Idempotent until :func:`shutdown`."""
    with _state.lock:
        if _state.initialized:
            return
        _apply_mesh_arg(mesh)
        dev = resolve_device(device)
        size = _env_int("HOROVOD_SIZE", 1)
        rank = _env_int("HOROVOD_RANK", 0)
        if not 0 <= rank < size:
            raise HorovodTpuError(
                f"HOROVOD_RANK={rank} is outside HOROVOD_SIZE={size}")
        axes = _mesh_axes(size)
        local_rank = _env_int("HOROVOD_LOCAL_RANK", rank)
        local_size = _env_int("HOROVOD_LOCAL_SIZE", size)
        if size > 1:
            coord = os.environ.get("HOROVOD_COORDINATOR_ADDR", "").strip()
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
        if not dist.is_initialized():
            dist.init_process_group(
                backend, init_method=f"tcp://{coord}", world_size=size,
                rank=rank, timeout=timedelta(seconds=timeout_s))
        _state.rank, _state.size = rank, size
        _state.local_rank, _state.local_size = local_rank, local_size
        _state.cross_rank = _env_int("HOROVOD_CROSS_RANK", 0)
        _state.cross_size = _env_int("HOROVOD_CROSS_SIZE", 1)
        _state.device = dev
        _state.epoch += 1
        _state.initialized = True
        _build_eager_groups()
        if axes is not None:
            _build_data_mesh(axes)
        _log.debug(f"init: backend={backend} size={size} device={dev}",
                   rank=rank)


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
        if _state.background is not None:
            _state.background.stop()
            _state.background = None
            if _state.size > 1:
                # no rank tears down the store while a peer still reads
                # the shutdown round from it
                dist.barrier()
        if dist.is_initialized():
            dist.destroy_process_group()
        _state.data_mesh = _state.data_axes = None
        _state.eager_hop = _state.eager_pair = None
        _state.initialized = False


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
