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
    cli: str | None = None         # the launcher's flag (hvdrun)
    config_key: str | None = None  # dotted key in --config-file


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


_KNOBS: dict[str, Knob] = {
    "fused_update": Knob(
        "HOROVOD_FUSED_UPDATE", False, _parse_bool,
        "Fused optimizer tail: one CUDA kernel per parameter applies the "
        "update of an optimizer built by fused_update.sgd/adam.",
        cli="--fused-update", config_key="optimizer.fused_update"),
    "compression": Knob(
        "HOROVOD_COMPRESSION", "none", str,
        "Gradient wire compression for allreduce: none | fp16 | bf16 "
        "(dtype casts) | int8 | int4 (block-scaled with shared per-block "
        "scales) | topk (sparse index + value payload).",
        cli="--compression", config_key="compression.mode"),
    "quant_block_size": Knob(
        "HOROVOD_QUANT_BLOCK_SIZE", 256, int,
        "Elements per int8/int4 quantization block (one float32 scale "
        "each; default 256).  Must agree on every rank.",
        cli="--quant-block-size", config_key="compression.quant_block_size"),
    "topk_ratio": Knob(
        "HOROVOD_TOPK_RATIO", 0.01, float,
        "Top-k density: each payload sends max(1, round(ratio * n)) "
        "(index, value) pairs; the rest stays in the error-feedback "
        "residual.  Must agree on every rank.",
        cli="--topk-ratio", config_key="compression.topk_ratio"),
    "zero_stage": Knob(
        "HOROVOD_ZERO_STAGE", 0, int,
        "ZeRO sharding stage for DistributedOptimizer (0-3): 0 the "
        "replicated update; 1 optimizer state as rank-local 1/world "
        "shards; 2 also the gradients (bucket-wise reduce-scatter, no "
        "full fused buffer); 3 also the parameters (zero3_shard_params, "
        "zero3_full_params).",
        cli="--zero-stage", config_key="optimizer.zero_stage"),
    "sharded_optimizer": Knob(
        "HOROVOD_SHARDED_OPTIMIZER", False, _parse_bool,
        "ZeRO stage 1 under its older name: read when HOROVOD_ZERO_STAGE "
        "is 0.",
        cli="--sharded-optimizer", config_key="optimizer.sharded"),
    "zero_prefetch_chunks": Knob(
        "HOROVOD_ZERO_PREFETCH_CHUNKS", 4, int,
        "Buckets of the stage-2/3 pipelines: the gradient reduce-scatter "
        "and the stage-3 parameter all-gather run in this many column "
        "buckets of the (world, shard) view.",
        cli="--zero-prefetch-chunks",
        config_key="optimizer.zero_prefetch_chunks"),
    "overlap": Knob(
        "HOROVOD_OVERLAP", False, _parse_bool,
        "Bucketed gradient communication: each fused buffer is reduced in "
        "HOROVOD_OVERLAP_CHUNKS buckets, bucket b+1's reduce-scatter "
        "issued before bucket b's math and all-gather.",
        cli="--overlap", config_key="overlap.enabled"),
    "overlap_chunks": Knob(
        "HOROVOD_OVERLAP_CHUNKS", 4, int,
        "Bucket count of the overlap schedule (default 4).",
        cli="--overlap-chunks", config_key="overlap.chunks"),
    "bucket_compression": Knob(
        "HOROVOD_BUCKET_COMPRESSION", "", str,
        "Per-bucket wire modes, colon-separated (e.g. 'int8:int4:topk'), "
        "cycled over the buckets of the overlap and stage-2/3 schedules; "
        "empty: every bucket rides the call's own mode.",
        cli="--bucket-compression", config_key="compression.bucket_modes"),
    "mesh": Knob(
        "HOROVOD_MESH", "", str,
        "Named data-mesh axis sizes as 'axis:size' pairs, e.g. "
        "'dp:4,tp:2' (axes dp/pp/tp/sp; empty = flat world).  When set, "
        "init() builds the mesh's process groups and every gradient "
        "collective, the optimizer and the ZeRO shard layouts reduce "
        "over the dp axis only.  Must agree on every rank.",
        cli="--mesh", config_key="mesh.axes"),
    "hierarchical_allreduce": Knob(
        "HOROVOD_HIERARCHICAL_ALLREDUCE", False, _parse_bool,
        "Two-level (cross, local) allreduce over an axis pair: local "
        "reduce-scatter, cross allreduce (the only hop a lossy "
        "compressor touches), local all-gather.  With a data mesh and "
        "HOROVOD_HIERARCHICAL_LOCAL_SIZE the dp axis splits into the "
        "(dpc, dpl) pair; alone it changes nothing.  Must agree on every "
        "rank.",
        cli="--hierarchical-allreduce", config_key="hierarchical.allreduce"),
    "hierarchical_allgather": Knob(
        "HOROVOD_HIERARCHICAL_ALLGATHER", False, _parse_bool,
        "Two-level allgather: like HOROVOD_HIERARCHICAL_ALLREDUCE, "
        "splits a data mesh's dp axis under "
        "HOROVOD_HIERARCHICAL_LOCAL_SIZE.  Must agree on every rank.",
        cli="--hierarchical-allgather", config_key="hierarchical.allgather"),
    "hierarchical_local_size": Knob(
        "HOROVOD_HIERARCHICAL_LOCAL_SIZE", 0, int,
        "Local extent of the dp axis's (dpc, dpl) split: used when "
        "1 < L < dp and L divides dp; 0 (the default) splits nothing.  "
        "Must agree on every rank.",
        cli="--hierarchical-local-size", config_key="hierarchical.local_size"),
    "local_sgd_h": Knob(
        "HOROVOD_LOCAL_SGD_H", 0, int,
        "Outer-sync period H of the local-SGD / DiLoCo regime "
        "(optim/local_sgd.py): 0 or 1 = off (every step synchronous); H "
        ">= 2 reduces the inner steps over the local hop only and "
        "exchanges the parameter deltas over the cross hop every H-th "
        "step.  Must agree on every rank.",
        cli="--local-sgd-h", config_key="local_sgd.h"),
    "outer_lr": Knob(
        "HOROVOD_OUTER_LR", 0.7, float,
        "Learning rate of the local-SGD outer Nesterov step on the "
        "averaged parameter delta.  Must agree on every rank.",
        cli="--outer-lr", config_key="local_sgd.outer_lr"),
    "outer_momentum": Knob(
        "HOROVOD_OUTER_MOMENTUM", 0.9, float,
        "Nesterov momentum of the local-SGD outer step.  Must agree on "
        "every rank.",
        cli="--outer-momentum", config_key="local_sgd.outer_momentum"),
    "local_sgd_compression": Knob(
        "HOROVOD_LOCAL_SGD_COMPRESSION", "", str,
        "Wire mode of the local-SGD outer sync's cross hop: none | fp16 "
        "| bf16 | int8 | int4 | topk (empty = HOROVOD_COMPRESSION).  The "
        "inner steps' local reduction stays full precision.  Must agree "
        "on every rank.",
        cli="--local-sgd-compression", config_key="local_sgd.compression"),
    "fusion_threshold": Knob(
        "HOROVOD_FUSION_THRESHOLD", 64 * 1024 * 1024, int,
        "Eager plane: the bytes one fused response may hold (default "
        "64 MiB).  Must agree on every rank.",
        cli="--fusion-threshold-mb", config_key="tensor_fusion.threshold"),
    "cycle_time_ms": Knob(
        "HOROVOD_CYCLE_TIME", 5.0, float,
        "Eager plane: the background thread's cycle in ms (default 5): at "
        "most one negotiation round per cycle under sustained load.",
        cli="--cycle-time-ms", config_key="tensor_fusion.cycle_time"),
    "cache_capacity": Knob(
        "HOROVOD_CACHE_CAPACITY", 1024, int,
        "Eager plane: response-cache entries (default 1024); 0 disables "
        "the cache and its bit fast path.  Must agree on every rank.",
        cli="--cache-capacity", config_key="cache.capacity"),
    "ragged_allgather": Knob(
        "HOROVOD_RAGGED_ALLGATHER", "auto", str,
        "Eager plane: a ragged allgather's strategy: auto (the cheaper "
        "in bytes), psum (every rank's rows at their offsets in one "
        "zero buffer, one sum) or pad (pad to the longest, gather, "
        "trim).  Must agree on every rank.",
        cli="--ragged-allgather", config_key="ragged_allgather"),
    "stall_check_disable": Knob(
        "HOROVOD_STALL_CHECK_DISABLE", False, _parse_bool,
        "Eager plane: disable the stall inspector.",
        cli="--no-stall-check", config_key="stall_check.disable"),
    "stall_warning_time": Knob(
        "HOROVOD_STALL_CHECK_TIME_SECONDS", 60.0, float,
        "Eager plane: seconds before rank 0 warns of a tensor some ranks "
        "have not submitted.",
        cli="--stall-timeout-seconds",
        config_key="stall_check.warning_time_seconds"),
    "stall_shutdown_time": Knob(
        "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", 0.0, float,
        "Eager plane: seconds after which such a stall fails every "
        "pending tensor (0 = never).",
        cli="--stall-shutdown-timeout-seconds",
        config_key="stall_check.shutdown_time_seconds"),
    "wire_timeout": Knob(
        "HOROVOD_WIRE_TIMEOUT_SECONDS", 600.0, float,
        "Eager plane: deadline of one wait on the negotiation store.",
        cli="--wire-timeout-seconds",
        config_key="fault_tolerance.wire_timeout"),
    "heartbeat_interval": Knob(
        "HOROVOD_HEARTBEAT_INTERVAL", 2.0, float,
        "Eager plane: seconds between this rank's liveness beats; 0 "
        "turns liveness and the coordinated abort off.  Must agree on "
        "every rank.",
        cli="--heartbeat-interval",
        config_key="fault_tolerance.heartbeat_interval"),
    "heartbeat_timeout": Knob(
        "HOROVOD_HEARTBEAT_TIMEOUT_SECONDS", 20.0, float,
        "Eager plane: seconds a peer's beat may stay unchanged before "
        "the peer is declared dead and every survivor raises "
        "RanksDownError.  Must agree on every rank.",
        cli="--heartbeat-timeout-seconds",
        config_key="fault_tolerance.heartbeat_timeout"),
    "control_fanout": Knob(
        "HOROVOD_CONTROL_FANOUT", 8, int,
        "Eager plane: worlds larger than this negotiate through slices "
        "of about this many ranks, each led by its lowest rank (the "
        "launcher's local size or HOROVOD_HIERARCHICAL_LOCAL_SIZE when "
        "it divides the world); 0 keeps every world flat.  Must agree "
        "on every rank.",
        cli="--control-fanout", config_key="control_plane.fanout"),
    "flight_dir": Knob(
        "HOROVOD_FLIGHT_DIR", "", str,
        "Directory for flight-recorder dumps: every rank keeps an "
        "in-memory ring of runtime events and dumps it here as JSONL on "
        "a coordinated abort, a background failure, SIGTERM/SIGABRT or "
        "hvd.dump_flight_recorder().  Merge and analyze with `python -m "
        "horovod_tpu_torch.trace merge <dir>`.  Empty (default) disables "
        "dumping; the ring still records.",
        cli="--flight-dir", config_key="flight.dir"),
    "flight_events": Knob(
        "HOROVOD_FLIGHT_EVENTS", 4096, int,
        "Flight-recorder ring capacity in events (default 4096; 0 "
        "disables recording).",
        cli="--flight-events", config_key="flight.events"),
    "goodput_dir": Knob(
        "HOROVOD_GOODPUT_DIR", "", str,
        "Directory for per-rank goodput ledger dumps "
        "(goodput-r<k>-g<g>.json, on shutdown and on every failure "
        "dump); empty falls back to HOROVOD_FLIGHT_DIR.  Report with "
        "`python -m horovod_tpu_torch.perf goodput <dir>`.",
        cli="--goodput-dir", config_key="goodput.dir"),
    "goodput_slo": Knob(
        "HOROVOD_GOODPUT_SLO", 0.0, float,
        "Fleet goodput SLO in (0, 1] for the fleet report's burn-rate "
        "alert; 0 (default) disarms it.",
        cli="--goodput-slo", config_key="goodput.slo"),
    "goodput_window": Knob(
        "HOROVOD_GOODPUT_WINDOW_SECONDS", 300.0, float,
        "Sliding window of the fleet goodput / dominant-bottleneck / "
        "SLO-burn computation (default 300 s).",
        cli="--goodput-window-seconds", config_key="goodput.window"),
    "goodput_unattributed_max": Knob(
        "HOROVOD_GOODPUT_UNATTRIBUTED_MAX", 0.10, float,
        "Unattributed share of wall-clock past which the goodput ledger "
        "logs one warning (default 0.10; 0 disables).",
        cli="--goodput-unattributed-max",
        config_key="goodput.unattributed_max"),
    "data_wait_min": Knob(
        "HOROVOD_DATA_WAIT_MIN_SECONDS", 0.0, float,
        "Noise floor of hvd.data_wait() / hvd.wrap_data_loader spans: "
        "shorter waits are not recorded (default 0).",
        cli="--data-wait-min-seconds", config_key="goodput.data_wait_min"),
    "metrics_port": Knob(
        "HOROVOD_METRICS_PORT", 0, int,
        "Prometheus-text metrics endpoint base port; 0 (default) "
        "disables.  Each rank serves /metrics on base + rank.",
        cli="--metrics-port", config_key="metrics.port"),
    "fault_spec": Knob(
        "HOROVOD_FAULT_SPEC", "", str,
        "Deterministic fault injection on the control-plane wire "
        "(testing only): comma-separated delay:<glob>:<dur>, "
        "drop:<glob>[:<n>], die:rank<k>[:round<n>], slow:<rank>:<delay>, "
        "nan:<nameglob>[:round<n>], inf:<nameglob>[:round<n>] specs "
        "(preempt: waits for the preemption plane and raises).",
        cli="--fault-spec", config_key="fault_tolerance.fault_spec"),
    "health": Knob(
        "HOROVOD_HEALTH", False, _parse_bool,
        "Training-health plane (runtime/health.py): stat taps in "
        "DistributedOptimizer (all ZeRO stages, overlap on/off) and the "
        "eager executor's allreduce/reducescatter -- per-dtype-group grad "
        "norm, max-abs and PRE-reduction nonfinite count published as "
        "hvd_grad_norm / hvd_nonfinite_total{group,rank} with culprit-rank "
        "attribution, the post-update update-to-weight ratio and the EWMA "
        "divergence sentinels; one small per-rank verdict vector is "
        "all-gathered per step.  Must agree on every rank (validated at "
        "the round-0 handshake: the tap adds an all-gather to the "
        "negotiated responses).",
        cli="--health", config_key="health.enabled"),
    "health_skip_nonfinite": Knob(
        "HOROVOD_HEALTH_SKIP_NONFINITE", False, _parse_bool,
        "Skip-step contract: when the health verdict reports a nonfinite "
        "gradient on ANY rank, the optimizer suppresses the step -- no "
        "parameter and no optimizer state (momenta, error-feedback "
        "residuals, shard state, the accumulation counter) changes.  "
        "Requires HOROVOD_HEALTH=1.  Must agree on every rank (validated "
        "at the round-0 handshake).",
        cli="--health-skip-nonfinite", config_key="health.skip_nonfinite"),
    "health_ewma_alpha": Knob(
        "HOROVOD_HEALTH_EWMA_ALPHA", 0.1, float,
        "EWMA smoothing factor of the divergence sentinels' loss and "
        "grad-norm baselines (default 0.1).",
        cli="--health-ewma-alpha", config_key="health.ewma_alpha"),
    "health_sentinel_ratio": Knob(
        "HOROVOD_HEALTH_SENTINEL_RATIO", 4.0, float,
        "Divergence sentinel threshold: a sample breaches above this "
        "multiple of its EWMA (default 4.0; 0 disables ratio breaches).",
        cli="--health-sentinel-ratio", config_key="health.sentinel_ratio"),
    "health_trip_steps": Knob(
        "HOROVOD_HEALTH_TRIP_STEPS", 3, int,
        "Consecutive breaching samples before hvd_health_alert raises "
        "(default 3).",
        cli="--health-trip-steps", config_key="health.trip_steps"),
    "health_clear_steps": Knob(
        "HOROVOD_HEALTH_CLEAR_STEPS", 20, int,
        "Consecutive healthy samples before an active alert clears "
        "(default 20).",
        cli="--health-clear-steps", config_key="health.clear_steps"),
    "health_dir": Knob(
        "HOROVOD_HEALTH_DIR", "", str,
        "Directory for per-rank health snapshot dumps "
        "(health-r<k>-g<g>.json, on shutdown and on every failure dump); "
        "empty falls back to HOROVOD_FLIGHT_DIR.  Report with `python -m "
        "horovod_tpu_torch.perf health <dir>`.",
        cli="--health-dir", config_key="health.dir"),
    "adaptive_compression": Knob(
        "HOROVOD_ADAPTIVE_COMPRESSION", False, _parse_bool,
        "Adaptive compression's guardrail signal: the error-feedback "
        "paths and the eager wire's lossy responses publish "
        "hvd_compression_residual_ratio per bucket, and the round-0 "
        "handshake checks the int8/int4/topk knobs whatever "
        "HOROVOD_COMPRESSION is.  The tuner that picks modes per bucket "
        "(HOROVOD_AUTOTUNE) is not ported.  Must agree on every rank.",
        cli="--adaptive-compression", config_key="compression.adaptive"),
    "checkpoint_keep": Knob(
        "HOROVOD_CHECKPOINT_KEEP", 0, int,
        "Last-K checkpoint retention ring: after each save, complete "
        "snapshots older than the newest K are pruned (0 keeps all).",
        cli="--checkpoint-keep", config_key="fault_tolerance.checkpoint_keep"),
    "checkpoint_verify": Knob(
        "HOROVOD_CHECKPOINT_VERIFY", True, _parse_bool,
        "Verify snapshots against their MANIFEST.json (per-file SHA-256 "
        "and size) on restore and discovery; a corrupt one is "
        "quarantined as step_<N>.corrupt.  0 restores unverified "
        "bytes.",
        cli="--checkpoint-verify",
        config_key="fault_tolerance.checkpoint_verify"),
    "checkpoint_replicas": Knob(
        "HOROVOD_CHECKPOINT_REPLICAS", 2, int,
        "Copies of each all_ranks shard dir per snapshot (default 2: the "
        "owner and one ring-buddy replica under rep_<owner>_<holder>/); "
        "0/1 disables replication.  Must agree on every rank (validated "
        "at the round-0 handshake).",
        cli="--checkpoint-replicas",
        config_key="fault_tolerance.checkpoint_replicas"),
    "kv_retries": Knob(
        "HOROVOD_KV_RETRIES", 3, int,
        "Bounded retries (exponential backoff and jitter, a reconnect "
        "between attempts) of a native KV-store wire failure.",
        cli="--kv-retries", config_key="fault_tolerance.kv_retries"),
    "elastic": Knob(
        "HOROVOD_ELASTIC", False, _parse_bool,
        "Elastic mode: survivors of a dead or preempted rank re-form the "
        "job at the new world size in-process (hvd.elastic.run) instead "
        "of the whole job restarting; the launcher keeps its KV server "
        "alive across re-forms, blacklists hosts whose ranks died and "
        "respawns joiners admitted at the next commit boundary.  Must "
        "agree on every rank (validated at the round-0 handshake).",
        cli="--elastic", config_key="fault_tolerance.elastic"),
    "min_ranks": Knob(
        "HOROVOD_MIN_RANKS", 1, int,
        "Elastic mode: the smallest world the job may shrink to; a "
        "re-form that would leave fewer fails the job (then "
        "--restart-attempts applies).",
        cli="--min-ranks", config_key="fault_tolerance.min_ranks"),
    "blacklist_cooldown": Knob(
        "HOROVOD_BLACKLIST_COOLDOWN_SECONDS", 120.0, float,
        "Elastic mode: how long the launcher refuses to respawn ranks on "
        "a host after one of its ranks died.",
        cli="--blacklist-cooldown-seconds",
        config_key="fault_tolerance.blacklist_cooldown"),
    "elastic_settle": Knob(
        "HOROVOD_ELASTIC_SETTLE_SECONDS", 10.0, float,
        "Elastic mode: how long the re-form leader waits for every "
        "expected survivor to announce itself before declaring the "
        "missing ones dead and publishing the new roster.",
        cli="--elastic-settle-seconds",
        config_key="fault_tolerance.elastic_settle"),
    "elastic_join_timeout": Knob(
        "HOROVOD_ELASTIC_JOIN_TIMEOUT_SECONDS", 3600.0, float,
        "Elastic mode: how long a joiner waits for a commit boundary to "
        "admit it; on timeout it retracts its registration and exits.",
        cli="--elastic-join-timeout-seconds",
        config_key="fault_tolerance.elastic_join_timeout"),
    "restart_attempts": Knob(
        "HOROVOD_RESTART_ATTEMPTS", 0, int,
        "hvdrun: relaunch the whole job up to N times after a failed "
        "attempt, resuming from the latest complete checkpoint under "
        "--checkpoint-dir (HOROVOD_RESUME_STEP is exported to the "
        "restarted ranks).",
        cli="--restart-attempts",
        config_key="fault_tolerance.restart_attempts"),
    "checkpoint_dir": Knob(
        "HOROVOD_CHECKPOINT_DIR", "", str,
        "Checkpoint store the launcher consults on restart "
        "(checkpoint.latest_complete: torn snapshots are refused).",
        cli="--checkpoint-dir", config_key="fault_tolerance.checkpoint_dir"),
    "preempt_grace": Knob(
        "HOROVOD_PREEMPT_GRACE_SECONDS", 30.0, float,
        "Graceful-preemption plane: the advance-notice window a drain "
        "must finish inside.  A noticed rank (SIGTERM/SIGUSR1, hvdrun "
        "--preempt, a preempt: fault rule, the metadata source) drains at "
        "the next agreed step boundary with one emergency commit and "
        "exits 0; survivors re-form.  <= 0 disables the plane.",
        cli="--preempt-grace-seconds",
        config_key="fault_tolerance.preempt_grace"),
    "platform": Knob(
        "HOROVOD_PLATFORM", "", str,
        "Where init() places this rank when the caller names no device: "
        "'cpu' (gloo) is an explicit request for the CPU; unset or a GPU "
        "name leaves cuda (which raises without a card).",
        cli="--platform", config_key="tpu.platform"),
    "rendezvous_addr": Knob(
        "HOROVOD_GLOO_RENDEZVOUS_ADDR", "", str,
        "The launcher's KV server host (exported by hvdrun); when set with "
        "its port the eager plane negotiates over it instead of rank 0's "
        "torch.distributed store."),
    "rendezvous_port": Knob(
        "HOROVOD_GLOO_RENDEZVOUS_PORT", 0, int,
        "The launcher's KV server port."),
    "shutdown_timeout": Knob(
        "HOROVOD_SHUTDOWN_TIMEOUT_SECONDS", 10, int,
        "Deadline of the bounded teardown of the process groups (an "
        "elastic re-form) and of the launcher's TERM -> KILL "
        "escalation."),
    "metrics_publish_interval": Knob(
        "HOROVOD_METRICS_PUBLISH_INTERVAL", 5.0, float,
        "Seconds between each rank's metric-snapshot publishes into the "
        "launcher's KV store (hvd<epoch>/metrics/<rank>, merged by the "
        "launcher's aggregate /metrics endpoint); 0 disables.",
        cli="--metrics-publish-interval",
        config_key="metrics.publish_interval"),
    "log_level": Knob(
        "HOROVOD_LOG_LEVEL", "warning", str,
        "trace | debug | info | warning | error | fatal.",
        cli="--log-level", config_key="logging.level"),
    "log_hide_time": Knob(
        "HOROVOD_LOG_HIDE_TIME", False, _parse_bool,
        "Drop the timestamp from log lines.",
        cli="--log-hide-timestamp", config_key="logging.hide_timestamp"),
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


def is_set(name: str) -> bool:
    """True when the knob's env var is set to a non-blank value."""
    return bool(os.environ.get(_KNOBS[name].env, "").strip())


def set_knob(name: str, value: Any) -> None:
    """Set a knob by exporting its env var (the one source of truth)."""
    k = _KNOBS[name]
    os.environ[k.env] = ("1" if value else "0") if isinstance(value, bool) \
        else str(value)


def knobs() -> dict[str, Knob]:
    return dict(_KNOBS)


# ---------------------------------------------------------------------------
# Config file and launcher flags -> env (horovod_tpu/common/config.py:885-956)
# ---------------------------------------------------------------------------


def _flatten(d: dict, prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for key, val in d.items():
        dotted = f"{prefix}.{key}" if prefix else key
        if isinstance(val, dict):
            out.update(_flatten(val, dotted))
        else:
            out[dotted] = val
    return out


def load_config_file(path: str, override: bool = False) -> dict[str, Any]:
    """Load a YAML/JSON config file and export the knobs it names to the
    environment.  Launcher flags take precedence over the file: the
    launcher loads the file first, then applies its flags on top.
    Returns the applied mapping."""
    import json

    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        try:
            import yaml  # type: ignore
        except ImportError as exc:
            raise RuntimeError(
                "config file is not JSON and PyYAML is unavailable"
            ) from exc
        data = yaml.safe_load(text)
    by_key = {k.config_key: (name, k) for name, k in _KNOBS.items()
              if k.config_key}
    applied = {}
    for dotted, value in _flatten(data or {}).items():
        if dotted in by_key:
            name, knob = by_key[dotted]
            if not override and os.environ.get(knob.env):
                continue
            set_knob(name, value)
            applied[name] = value
    return applied


def set_env_from_args(args, env: dict | None = None) -> dict:
    """Map parsed launcher flags onto their ``HOROVOD_*`` variables in
    ``env`` (default ``os.environ``)."""
    env = env if env is not None else os.environ  # type: ignore[assignment]
    for name, knob in _KNOBS.items():
        if knob.cli is None:
            continue
        attr = knob.cli.lstrip("-").replace("-", "_")
        val = getattr(args, attr, None)
        if val is None:
            continue
        if name == "fusion_threshold":
            val = int(val) * 1024 * 1024  # the flag is in MB
        if isinstance(val, bool):
            # an explicit False (--no-flag) overrides a truthy default
            env[knob.env] = "1" if val else "0"
        else:
            env[knob.env] = str(val)
    return env
