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
        "ZeRO sharding stage for DistributedOptimizer (0-3): 0 the "
        "replicated update; 1 optimizer state as rank-local 1/world "
        "shards; 2 also the gradients (bucket-wise reduce-scatter, no "
        "full fused buffer); 3 also the parameters (zero3_shard_params, "
        "zero3_full_params)."),
    "sharded_optimizer": Knob(
        "HOROVOD_SHARDED_OPTIMIZER", False, _parse_bool,
        "ZeRO stage 1 under its older name: read when HOROVOD_ZERO_STAGE "
        "is 0."),
    "zero_prefetch_chunks": Knob(
        "HOROVOD_ZERO_PREFETCH_CHUNKS", 4, int,
        "Buckets of the stage-2/3 pipelines: the gradient reduce-scatter "
        "and the stage-3 parameter all-gather run in this many column "
        "buckets of the (world, shard) view."),
    "overlap": Knob(
        "HOROVOD_OVERLAP", False, _parse_bool,
        "Bucketed gradient communication: each fused buffer is reduced in "
        "HOROVOD_OVERLAP_CHUNKS buckets, bucket b+1's reduce-scatter "
        "issued before bucket b's math and all-gather."),
    "overlap_chunks": Knob(
        "HOROVOD_OVERLAP_CHUNKS", 4, int,
        "Bucket count of the overlap schedule (default 4)."),
    "bucket_compression": Knob(
        "HOROVOD_BUCKET_COMPRESSION", "", str,
        "Per-bucket wire modes, colon-separated (e.g. 'int8:int4:topk'), "
        "cycled over the buckets of the overlap and stage-2/3 schedules; "
        "empty: every bucket rides the call's own mode."),
    "mesh": Knob(
        "HOROVOD_MESH", "", str,
        "Named data-mesh axis sizes as 'axis:size' pairs, e.g. "
        "'dp:4,tp:2' (axes dp/pp/tp/sp; empty = flat world).  When set, "
        "init() builds the mesh's process groups and every gradient "
        "collective, the optimizer and the ZeRO shard layouts reduce "
        "over the dp axis only.  Must agree on every rank."),
    "hierarchical_allreduce": Knob(
        "HOROVOD_HIERARCHICAL_ALLREDUCE", False, _parse_bool,
        "Two-level (cross, local) allreduce over an axis pair: local "
        "reduce-scatter, cross allreduce (the only hop a lossy "
        "compressor touches), local all-gather.  With a data mesh and "
        "HOROVOD_HIERARCHICAL_LOCAL_SIZE the dp axis splits into the "
        "(dpc, dpl) pair; alone it changes nothing.  Must agree on every "
        "rank."),
    "hierarchical_allgather": Knob(
        "HOROVOD_HIERARCHICAL_ALLGATHER", False, _parse_bool,
        "Two-level allgather: like HOROVOD_HIERARCHICAL_ALLREDUCE, "
        "splits a data mesh's dp axis under "
        "HOROVOD_HIERARCHICAL_LOCAL_SIZE.  Must agree on every rank."),
    "hierarchical_local_size": Knob(
        "HOROVOD_HIERARCHICAL_LOCAL_SIZE", 0, int,
        "Local extent of the dp axis's (dpc, dpl) split: used when "
        "1 < L < dp and L divides dp; 0 (the default) splits nothing.  "
        "Must agree on every rank."),
    "local_sgd_h": Knob(
        "HOROVOD_LOCAL_SGD_H", 0, int,
        "Outer-sync period H of the local-SGD / DiLoCo regime "
        "(optim/local_sgd.py): 0 or 1 = off (every step synchronous); H "
        ">= 2 reduces the inner steps over the local hop only and "
        "exchanges the parameter deltas over the cross hop every H-th "
        "step.  Must agree on every rank."),
    "outer_lr": Knob(
        "HOROVOD_OUTER_LR", 0.7, float,
        "Learning rate of the local-SGD outer Nesterov step on the "
        "averaged parameter delta.  Must agree on every rank."),
    "outer_momentum": Knob(
        "HOROVOD_OUTER_MOMENTUM", 0.9, float,
        "Nesterov momentum of the local-SGD outer step.  Must agree on "
        "every rank."),
    "local_sgd_compression": Knob(
        "HOROVOD_LOCAL_SGD_COMPRESSION", "", str,
        "Wire mode of the local-SGD outer sync's cross hop: none | fp16 "
        "| bf16 | int8 | int4 | topk (empty = HOROVOD_COMPRESSION).  The "
        "inner steps' local reduction stays full precision.  Must agree "
        "on every rank."),
    "fusion_threshold": Knob(
        "HOROVOD_FUSION_THRESHOLD", 64 * 1024 * 1024, int,
        "Eager plane: the bytes one fused response may hold (default "
        "64 MiB).  Must agree on every rank."),
    "cycle_time_ms": Knob(
        "HOROVOD_CYCLE_TIME", 5.0, float,
        "Eager plane: the background thread's cycle in ms (default 5): at "
        "most one negotiation round per cycle under sustained load."),
    "cache_capacity": Knob(
        "HOROVOD_CACHE_CAPACITY", 1024, int,
        "Eager plane: response-cache entries (default 1024); 0 disables "
        "the cache and its bit fast path.  Must agree on every rank."),
    "ragged_allgather": Knob(
        "HOROVOD_RAGGED_ALLGATHER", "auto", str,
        "Eager plane: a ragged allgather's strategy: auto (the cheaper "
        "in bytes), psum (every rank's rows at their offsets in one "
        "zero buffer, one sum) or pad (pad to the longest, gather, "
        "trim).  Must agree on every rank."),
    "stall_check_disable": Knob(
        "HOROVOD_STALL_CHECK_DISABLE", False, _parse_bool,
        "Eager plane: disable the stall inspector."),
    "stall_warning_time": Knob(
        "HOROVOD_STALL_CHECK_TIME_SECONDS", 60.0, float,
        "Eager plane: seconds before rank 0 warns of a tensor some ranks "
        "have not submitted."),
    "stall_shutdown_time": Knob(
        "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", 0.0, float,
        "Eager plane: seconds after which such a stall fails every "
        "pending tensor (0 = never)."),
    "wire_timeout": Knob(
        "HOROVOD_WIRE_TIMEOUT_SECONDS", 600.0, float,
        "Eager plane: deadline of one wait on the negotiation store."),
    "heartbeat_interval": Knob(
        "HOROVOD_HEARTBEAT_INTERVAL", 2.0, float,
        "Eager plane: seconds between this rank's liveness beats; 0 "
        "turns liveness and the coordinated abort off.  Must agree on "
        "every rank."),
    "heartbeat_timeout": Knob(
        "HOROVOD_HEARTBEAT_TIMEOUT_SECONDS", 20.0, float,
        "Eager plane: seconds a peer's beat may stay unchanged before "
        "the peer is declared dead and every survivor raises "
        "RanksDownError.  Must agree on every rank."),
    "control_fanout": Knob(
        "HOROVOD_CONTROL_FANOUT", 8, int,
        "Eager plane: worlds larger than this negotiate through slices "
        "of about this many ranks, each led by its lowest rank (the "
        "launcher's local size or HOROVOD_HIERARCHICAL_LOCAL_SIZE when "
        "it divides the world); 0 keeps every world flat.  Must agree "
        "on every rank."),
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


def is_set(name: str) -> bool:
    """True when the knob's env var is set to a non-blank value."""
    return bool(os.environ.get(_KNOBS[name].env, "").strip())


def set_knob(name: str, value: Any) -> None:
    """Set a knob by exporting its env var (the one source of truth)."""
    k = _KNOBS[name]
    os.environ[k.env] = ("1" if value else "0") if isinstance(value, bool) \
        else str(value)
