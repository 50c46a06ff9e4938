"""Process-world bring-up over ``torch.distributed``.

Reads the launcher's env contract (``HOROVOD_RANK/SIZE/LOCAL_RANK/
LOCAL_SIZE/CROSS_RANK/CROSS_SIZE/COORDINATOR_ADDR``, exported by
``horovod_tpu/run/launcher.py``), so the JAX package's launcher spawns
ranks of this package unchanged.  With no env the world is one process.
The process group is started at every size -- ``nccl`` on CUDA, ``gloo``
on the CPU -- so a one-process run takes the same collective path as a
larger one.
"""

from __future__ import annotations

import os
import threading
from datetime import timedelta

import torch
import torch.distributed as dist

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


_state = _State()


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    return int(raw) if raw.strip() else default


def init(device=None, timeout_s: float = 300.0) -> None:
    """Initialize the world.  ``device`` is where this rank computes:
    ``cuda`` (the default; local rank ``i`` takes card ``i``) or
    ``cpu``.  Idempotent until :func:`shutdown`."""
    with _state.lock:
        if _state.initialized:
            return
        dev = resolve_device(device)
        size = _env_int("HOROVOD_SIZE", 1)
        rank = _env_int("HOROVOD_RANK", 0)
        if not 0 <= rank < size:
            raise HorovodTpuError(
                f"HOROVOD_RANK={rank} is outside HOROVOD_SIZE={size}")
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
        _state.initialized = True
        _log.debug(f"init: backend={backend} size={size} device={dev}",
                   rank=rank)


def shutdown() -> None:
    with _state.lock:
        if not _state.initialized:
            return
        if dist.is_initialized():
            dist.destroy_process_group()
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
