"""The ``HOROVOD_*`` knobs this package reads: same env names and
defaults as ``horovod_tpu/common/config.py``, restricted to the ones the
port implements.  Kernel selection is not a knob here: a kernel wrapper
launches its CUDA kernel for a CUDA tensor and uses its plain PyTorch
version only for a CPU tensor."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class Knob:
    env: str
    default: Any
    parse: Callable[[str], Any]
    help: str = ""


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


_KNOBS: dict[str, Knob] = {
    "fused_update": Knob(
        "HOROVOD_FUSED_UPDATE", False, _parse_bool,
        "Fused optimizer tail: one CUDA kernel per parameter applies the "
        "update of an optimizer built by fused_update.sgd/adam."),
    "compression": Knob(
        "HOROVOD_COMPRESSION", "none", str,
        "Gradient wire compression for allreduce: none | fp16 | bf16."),
    "zero_stage": Knob(
        "HOROVOD_ZERO_STAGE", 0, int,
        "ZeRO sharding stage for DistributedOptimizer; only 0 (the "
        "replicated update) is implemented."),
    "log_level": Knob(
        "HOROVOD_LOG_LEVEL", "warning", str,
        "trace | debug | info | warning | error | fatal."),
    "log_hide_time": Knob(
        "HOROVOD_LOG_HIDE_TIME", False, _parse_bool,
        "Drop the timestamp from log lines."),
}


def get(name: str) -> Any:
    """Read a knob: the env var wins, else the default (an unparsable
    value reads as the default, as in the JAX package)."""
    k = _KNOBS[name]
    raw = os.environ.get(k.env)
    if raw is None or raw == "":
        return k.default
    try:
        return k.parse(raw)
    except (ValueError, TypeError):
        return k.default
