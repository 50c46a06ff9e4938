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
        "Gradient wire compression for allreduce: none | fp16 | bf16 "
        "(dtype casts) | int8 | int4 (block-scaled with shared per-block "
        "scales) | topk (sparse index + value payload)."),
    "quant_block_size": Knob(
        "HOROVOD_QUANT_BLOCK_SIZE", 256, int,
        "Elements per int8/int4 quantization block (one float32 scale "
        "each; default 256).  Must agree on every rank."),
    "topk_ratio": Knob(
        "HOROVOD_TOPK_RATIO", 0.01, float,
        "Top-k density: each payload sends max(1, round(ratio * n)) "
        "(index, value) pairs; the rest stays in the error-feedback "
        "residual.  Must agree on every rank."),
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


# Knobs of the JAX package whose feature is not ported yet and which,
# set there, change the values the entry points compute or the
# collectives they run: each one set raises instead of being ignored.
# (The knobs ignored on purpose, each with its reason, are listed in
# ROADMAP.md Queue C.)
_NOT_PORTED = {
    "HOROVOD_OVERLAP": "the overlap engine (ROADMAP.md Queue A item 8)",
    "HOROVOD_BUCKET_COMPRESSION":
        "per-bucket wire modes of the overlap engine (ROADMAP.md Queue A "
        "item 8)",
    "HOROVOD_SHARDED_OPTIMIZER":
        "ZeRO stage 1, the sharded weight update (ROADMAP.md Queue A "
        "item 8)",
    "HOROVOD_HIERARCHICAL_ALLREDUCE":
        "hierarchical (cross, local) reductions (ROADMAP.md Queue A item 9)",
    "HOROVOD_HIERARCHICAL_ALLGATHER":
        "hierarchical (cross, local) gathers (ROADMAP.md Queue A item 9)",
    "HOROVOD_MESH":
        "named mesh axes, with every collective over the dp axis only "
        "(ROADMAP.md Queue A item 9)",
    "HOROVOD_ADAPTIVE_COMPRESSION":
        "the residual-ratio guardrail and its metrics (ROADMAP.md Queue A "
        "item 12)",
    "HOROVOD_HEALTH":
        "the training-health taps of DistributedOptimizer (ROADMAP.md "
        "Queue A item 12)",
    "HOROVOD_HEALTH_SKIP_NONFINITE":
        "the health plane's skip-step contract (ROADMAP.md Queue A item 12)",
}


def refuse_not_ported() -> None:
    """Raise ``NotImplementedError`` if a knob of an unported feature is
    set (to anything but an empty or false value)."""
    for env, what in _NOT_PORTED.items():
        raw = os.environ.get(env, "").strip().lower()
        if raw not in ("", "0", "false", "no", "off"):
            raise NotImplementedError(
                f"{env}={os.environ[env]!r} asks for {what}, which is not "
                "ported yet")


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
