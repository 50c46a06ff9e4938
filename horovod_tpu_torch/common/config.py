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
        "scales) | topk (sparse index + value payload).  Must agree on "
        "every rank (validated at the round-0 handshake).",
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
        "zero3_full_params).  Must agree on every rank (validated at the "
        "round-0 handshake).",
        cli="--zero-stage", config_key="optimizer.zero_stage"),
    "sharded_optimizer": Knob(
        "HOROVOD_SHARDED_OPTIMIZER", False, _parse_bool,
        "ZeRO stage 1 under its older name: read when HOROVOD_ZERO_STAGE "
        "is 0.  Must agree on every rank (validated at the round-0 "
        "handshake).",
        cli="--sharded-optimizer", config_key="optimizer.sharded"),
    "zero_prefetch_chunks": Knob(
        "HOROVOD_ZERO_PREFETCH_CHUNKS", 4, int,
        "Buckets of the stage-2/3 pipelines: the gradient reduce-scatter "
        "and the stage-3 parameter all-gather run in this many column "
        "buckets of the (world, shard) view.  Must agree on every rank "
        "(validated at the round-0 handshake when HOROVOD_ZERO_STAGE >= "
        "2).",
        cli="--zero-prefetch-chunks",
        config_key="optimizer.zero_prefetch_chunks"),
    "overlap": Knob(
        "HOROVOD_OVERLAP", False, _parse_bool,
        "Bucketed gradient communication: each fused buffer is reduced in "
        "HOROVOD_OVERLAP_CHUNKS buckets, bucket b+1's reduce-scatter "
        "issued before bucket b's math and all-gather.  Must agree on "
        "every rank (validated at the round-0 handshake).",
        cli="--overlap", config_key="overlap.enabled"),
    "overlap_chunks": Knob(
        "HOROVOD_OVERLAP_CHUNKS", 4, int,
        "Bucket count of the overlap schedule (default 4).  Must agree on "
        "every rank (validated at the round-0 handshake when "
        "HOROVOD_OVERLAP is on).",
        cli="--overlap-chunks", config_key="overlap.chunks"),
    "bucket_compression": Knob(
        "HOROVOD_BUCKET_COMPRESSION", "", str,
        "Per-bucket wire modes, colon-separated (e.g. 'int8:int4:topk'), "
        "cycled over the buckets of the overlap and stage-2/3 schedules; "
        "empty: every bucket rides the call's own mode.  Must agree on "
        "every rank (validated at the round-0 handshake).",
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
        "HOROVOD_COMPRESSION is.  Under HOROVOD_AUTOTUNE the tuner on "
        "rank 0 also proposes a wire mode per overlap bucket "
        "(HOROVOD_BUCKET_COMPRESSION, from the ladder none -> bf16 -> "
        "fp16 -> int8 -> int4 -> topk) behind the bounded-loss guardrail "
        "(HOROVOD_COMPRESSION_MAX_RESIDUAL_RATIO and the health plane's "
        "loss verdict), applied by every rank at one round.  Must agree "
        "on every rank.",
        cli="--adaptive-compression", config_key="compression.adaptive"),
    "compression_guard_ratio": Knob(
        "HOROVOD_COMPRESSION_MAX_RESIDUAL_RATIO", 0.5, float,
        "Bounded-loss guardrail for adaptive compression: when a "
        "bucket's reported error-feedback residual-to-gradient norm "
        "ratio exceeds this ceiling, the tuner pins that bucket back "
        "to int8 instead of int4/topk (0 disables the aggressive "
        "modes entirely for reported buckets).",
        cli="--compression-max-residual-ratio",
        config_key="compression.max_residual_ratio"),
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
    "autopilot": Knob(
        "HOROVOD_AUTOPILOT", False, _parse_bool,
        "Closed-loop supervisor (runtime/autopilot.py): the elastic "
        "launcher's evidence sweep and the rank side's elastic commit act "
        "on the observability planes: preemptive host blacklist on "
        "sustained straggling, elastic shrink/grow on goodput SLO burn, "
        "rollback to the newest healthy commit on a health sentinel trip, "
        "and a comm-knob retune from measured exposed communication.  "
        "Every verdict lands on the flight ring with its evidence.",
        cli="--autopilot", config_key="autopilot.enabled"),
    "autopilot_dry_run": Knob(
        "HOROVOD_AUTOPILOT_DRY_RUN", False, _parse_bool,
        "Autopilot shadow mode: every rule still evaluates, paces its "
        "cooldowns and records would-have-acted verdicts (outcome "
        "dry_run) on the flight ring, but no actuator fires.",
        cli="--autopilot-dry-run", config_key="autopilot.dry_run"),
    "autopilot_cooldown": Knob(
        "HOROVOD_AUTOPILOT_COOLDOWN_SECONDS", 60.0, float,
        "Per-rule refractory period: after a rule fires (or dry-run "
        "fires) it cannot fire again for this long; its verdicts are "
        "recorded as suppressed:cooldown.",
        cli="--autopilot-cooldown-seconds", config_key="autopilot.cooldown"),
    "autopilot_rate_limit": Knob(
        "HOROVOD_AUTOPILOT_RATE_LIMIT", 4, int,
        "Global action ceiling: at most this many autopilot actions (all "
        "gated rules combined) per HOROVOD_AUTOPILOT_RATE_WINDOW_SECONDS; "
        "excess verdicts are recorded as suppressed:rate_limit.",
        cli="--autopilot-rate-limit", config_key="autopilot.rate_limit"),
    "autopilot_rate_window": Knob(
        "HOROVOD_AUTOPILOT_RATE_WINDOW_SECONDS", 600.0, float,
        "Sliding window over which HOROVOD_AUTOPILOT_RATE_LIMIT counts "
        "actions.",
        cli="--autopilot-rate-window-seconds",
        config_key="autopilot.rate_window"),
    "autopilot_trip_ticks": Knob(
        "HOROVOD_AUTOPILOT_TRIP_TICKS", 3, int,
        "Hysteresis: consecutive evaluation ticks a condition must hold "
        "(the same candidate for the straggler rule) before the rule "
        "fires; health_rollback relies on the health sentinels' own "
        "trip steps instead.",
        cli="--autopilot-trip-ticks", config_key="autopilot.trip_ticks"),
    "autopilot_straggler_factor": Knob(
        "HOROVOD_AUTOPILOT_STRAGGLER_FACTOR", 4.0, float,
        "Preemptive-blacklist breach multiple: a rank is a chronic "
        "straggler when its heartbeat staleness exceeds this multiple of "
        "the fleet's lower median, sustained for "
        "HOROVOD_AUTOPILOT_TRIP_TICKS.",
        cli="--autopilot-straggler-factor",
        config_key="autopilot.straggler_factor"),
    "autopilot_straggler_floor": Knob(
        "HOROVOD_AUTOPILOT_STRAGGLER_FLOOR", 0.05, float,
        "Absolute lateness floor (seconds) below which the straggler "
        "rule never fires, whatever the relative factor.",
        cli="--autopilot-straggler-floor",
        config_key="autopilot.straggler_floor"),
    "autopilot_burn_threshold": Knob(
        "HOROVOD_AUTOPILOT_BURN_THRESHOLD", 2.0, float,
        "SLO-burn elastic trigger: the shrink rule arms when the fleet "
        "goodput alert fires and its burn rate (lost goodput over the "
        "SLO's headroom) holds at or above this value for "
        "HOROVOD_AUTOPILOT_TRIP_TICKS.  Needs HOROVOD_GOODPUT_SLO.",
        cli="--autopilot-burn-threshold",
        config_key="autopilot.burn_threshold"),
    "autopilot_comm_fraction": Knob(
        "HOROVOD_AUTOPILOT_COMM_FRACTION", 0.25, float,
        "Retune trigger: when the goodput ledger's exposed communication "
        "exceeds this fraction of exposed + compute for "
        "HOROVOD_AUTOPILOT_TRIP_TICKS commits, the autopilot proposes a "
        "comm-knob change (overlap chunks, or local SGD's H) through "
        "parameter_manager.apply_params.",
        cli="--autopilot-comm-fraction",
        config_key="autopilot.comm_fraction"),
    "platform": Knob(
        "HOROVOD_PLATFORM", "", str,
        "Where init() places this rank when the caller names no device: "
        "'cpu' (gloo) is an explicit request for the CPU; unset or a GPU "
        "name leaves cuda (which raises without a card).",
        cli="--platform", config_key="tpu.platform"),
    "coordinator_addr": Knob(
        "HOROVOD_COORDINATOR_ADDR", "", str,
        "host:port of rank 0's torch.distributed store (exported by "
        "hvdrun; required when HOROVOD_SIZE > 1)."),
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
    "aot_cache_dir": Knob(
        "HOROVOD_AOT_CACHE_DIR", "", str,
        "Persistent AOT cache (runtime/aot_cache.py): the CUDA kernel "
        "and host-library builds (nvcc, g++) are stored here keyed by "
        "source, flags, compiler identity and the torch/CUDA/Triton "
        "versions, and programs given to compile_or_load by (round-0 "
        "cfg vector, topology, versions, program key), so a restart "
        "or elastic re-form loads them instead of building again.  "
        "Fail-closed: an unreadable, version-skewed, wrong-key or "
        "hash-mismatched entry, or one that fails to load, is evicted "
        "and rebuilt; a stale artifact never runs.  Empty (default) "
        "disables.  Inspect/prune with `python -m "
        "horovod_tpu_torch.runtime.aot_cache list|info|prune|clear`.",
        cli="--aot-cache-dir", config_key="aot_cache.dir"),
    "aot_cache_mode": Knob(
        "HOROVOD_AOT_CACHE_MODE", "auto", str,
        "AOT cache format of programs: auto (default: 'exec'), exec (an "
        "AOTInductor package: warm loads skip compilation), export (a "
        "torch.export program: warm loads skip tracing only), off "
        "(disable even when HOROVOD_AOT_CACHE_DIR is set).  Libraries "
        "are stored as their bytes in every mode but off.",
        cli="--aot-cache-mode", config_key="aot_cache.mode"),
    "metrics_publish_interval": Knob(
        "HOROVOD_METRICS_PUBLISH_INTERVAL", 5.0, float,
        "Seconds between each rank's metric-snapshot publishes into the "
        "launcher's KV store (hvd<epoch>/metrics/<rank>, merged by the "
        "launcher's aggregate /metrics endpoint); 0 disables.",
        cli="--metrics-publish-interval",
        config_key="metrics.publish_interval"),
    "timeline": Knob(
        "HOROVOD_TIMELINE", "", str,
        "Chrome-trace timeline output path (rank 0 writes: per-tensor "
        "rows of NEGOTIATE_<KIND>, RANK<k>_READY and XLA_<KIND> events; "
        "reference operations.cc:403-411).",
        cli="--timeline-filename", config_key="profiling.timeline_filename"),
    "timeline_mark_cycles": Knob(
        "HOROVOD_TIMELINE_MARK_CYCLES", False, _parse_bool,
        "Emit background-cycle markers (CYCLE_START) into the timeline.",
        cli="--timeline-mark-cycles",
        config_key="profiling.timeline_mark_cycles"),
    "jax_profiler": Knob(
        "HOROVOD_TIMELINE_JAX_PROFILER", "", str,
        "Directory for a whole-run device capture: torch.profiler (CPU "
        "and CUDA activities) records every rank from init() to "
        "shutdown() and writes a Chrome trace under rank<k>/ "
        "(gen<g>/rank<k>/ after an elastic re-form).  The name is the "
        "JAX package's, kept for users' scripts.",
        cli="--jax-profiler-dir", config_key="profiling.jax_profiler_dir"),
    "profile_every_n": Knob(
        "HOROVOD_PROFILE_EVERY_N_STEPS", 0, int,
        "Sampled continuous device capture: every N-th hvd.trace_step() "
        "span is captured with torch.profiler into a rotating per-rank "
        "directory (HOROVOD_PROFILE_DIR), analyzed in the background by "
        "the stdlib Chrome-trace reader, and published as "
        "hvd_device_*/hvd_mfu gauges on the metrics plane.  0 (default) "
        "disables.  Yields to the whole-run "
        "HOROVOD_TIMELINE_JAX_PROFILER capture, which owns the profiler "
        "when set.",
        cli="--profile-every-n-steps", config_key="profiling.every_n_steps"),
    "profile_dir": Knob(
        "HOROVOD_PROFILE_DIR", "", str,
        "Root directory for sampled step captures "
        "(HOROVOD_PROFILE_EVERY_N_STEPS); each rank writes "
        "rank<k>/step<n>/ with the Chrome trace plus its analysis.json.  "
        "Empty (default) means ./hvd_profile.  Inspect with "
        "`python -m horovod_tpu_torch.perf report <dir>`.",
        cli="--profile-dir", config_key="profiling.profile_dir"),
    "profile_keep": Knob(
        "HOROVOD_PROFILE_KEEP", 4, int,
        "How many sampled step captures each rank keeps (oldest rotated "
        "out), bounding disk use on long runs.",
        cli="--profile-keep", config_key="profiling.keep"),
    "peak_flops": Knob(
        "HOROVOD_PEAK_FLOPS_PER_CHIP", 0.0, float,
        "Peak FLOP/s of one card used as the MFU denominator by the perf "
        "observatory; 0 (default) takes the dense bf16 tensor-core peak "
        "of the card's spec sheet (perf/attribution.py).  Set explicitly "
        "for a card the table lacks, or to give CPU runs an MFU number.",
        cli="--peak-flops-per-chip", config_key="profiling.peak_flops"),
    "autotune": Knob(
        "HOROVOD_AUTOTUNE", False, _parse_bool,
        "Bayesian autotuning of the eager plane's knobs on rank 0 "
        "(fusion threshold, cycle time, cache, hierarchical reductions, "
        "overlap and prefetch chunks, per-bucket compression modes; "
        "reference parameter_manager.h:42).",
        cli="--autotune", config_key="autotune.enabled"),
    "autotune_log": Knob(
        "HOROVOD_AUTOTUNE_LOG", "", str,
        "CSV log of autotune samples.",
        cli="--autotune-log-file", config_key="autotune.log_file"),
    "autotune_warmup_samples": Knob(
        "HOROVOD_AUTOTUNE_WARMUP_SAMPLES", 3, int,
        "Discarded warmup windows before scoring.",
        cli="--autotune-warmup-samples",
        config_key="autotune.warmup_samples"),
    "autotune_steps_per_sample": Knob(
        "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", 10, int,
        "Background cycles per autotune scoring window.",
        cli="--autotune-steps-per-sample",
        config_key="autotune.steps_per_sample"),
    "autotune_bayes_opt_max_samples": Knob(
        "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", 20, int,
        "Max Bayesian-optimization samples before pinning the best.",
        cli="--autotune-bayes-opt-max-samples",
        config_key="autotune.bayes_opt_max_samples"),
    "autotune_gaussian_process_noise": Knob(
        "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE", 0.8, float,
        "GP observation-noise prior.",
        cli="--autotune-gaussian-process-noise",
        config_key="autotune.gaussian_process_noise"),
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
