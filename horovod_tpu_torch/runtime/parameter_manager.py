"""Runtime parameter manager (autotune): this package's copy of
``horovod_tpu/runtime/parameter_manager.py``.

Parity with reference ``horovod/common/parameter_manager.{h,cc}``
(251+528 LoC): when ``HOROVOD_AUTOTUNE`` is on, the coordinator scores
each sample window, discards warmup windows, and drives Bayesian
optimization (GP + expected improvement, ``parameter_manager.h:186``)
over the eager plane's knobs, then pins the best setting after
``HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES`` samples.  The proposals ride
the controller's response list (``"t"``, reference
``SynchronizeParameters``, ``controller.cc:33-47``), and every rank,
rank 0 included, applies them on receipt, before any fusion of that
round: all ranks run the same knobs from the same round boundary, which
the per-rank fusion of the cache's fast path requires.

Tuned space (reference ``parameter_manager.h:42-246``): fusion
threshold, cycle time, response cache on/off, the hierarchical
allreduce and allgather on/off (only when the eager plane built its
(cross, local) pair at ``init()``: without it the knobs change
nothing), the overlap chunk count ``HOROVOD_OVERLAP_CHUNKS`` under
``HOROVOD_OVERLAP`` (power-of-two snapped, 1..32), the stage-3 prefetch
chunk count, and under ``HOROVOD_ADAPTIVE_COMPRESSION`` one wire mode
per overlap bucket slot behind the bounded-loss guardrail
(:meth:`ParameterManager._guard`).  The executor re-reads every one of
these knobs per response, so a retune takes effect at the next round.

Only rank 0 owns a ParameterManager; other ranks apply received
updates via :func:`apply_params`.
"""

from __future__ import annotations

import time

import numpy as np

from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common import logging as _log
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.ops.compression import MODE_LADDER as _MODE_LADDER
from horovod_tpu_torch.ops.compression import parse_bucket_modes
from horovod_tpu_torch.runtime.bayes_opt import BayesianOptimization

# Full tuned space, each dim mapped to the unit interval:
#   0: log2(fusion_threshold MB)   in [0, 7]   -> 1 MB .. 128 MB
#   1: cycle_time_ms               in [1, 25]
#   2: cache enabled               binary
#   3: hierarchical allreduce      binary
#   4: hierarchical allgather      binary
#   5: log2(overlap_chunks)        in [0, 5]   -> 1 .. 32 buckets
#      (tuned only when HOROVOD_OVERLAP is on; interacts with dim 0 —
#      the eager bucket payload is ~fusion_threshold / chunks, so the
#      GP sees both coordinates of that trade-off)
#   6: log2(zero_prefetch_chunks)  in [0, 5]   -> 1 .. 32 buckets
#      (tuned only when HOROVOD_ZERO_STAGE >= 3: the stage-3 forward's
#      parameter-prefetch granularity — more buckets hide transfers
#      under finer layer slices but pay more per-collective latency)
#   7+: per-bucket compression-mode slots (HOROVOD_ADAPTIVE_COMPRESSION;
#      one slot per overlap bucket, capped at _MAX_MODE_SLOTS; slot s
#      governs buckets b with b % slots == s, matching the cycling of
#      HOROVOD_BUCKET_COMPRESSION) — each dim walks the aggressiveness
#      ladder none->bf16->fp16->int8->int4->topk (docs/compression.md),
#      subject to the bounded-loss guardrail below.
_LOG2_MB_RANGE = (0.0, 7.0)
_CYCLE_RANGE = (1.0, 25.0)
_LOG2_CHUNKS_RANGE = (0.0, 5.0)
_KNOB_NAMES = ("fusion_threshold", "cycle_time_ms", "cache_enabled",
               "hierarchical_allreduce", "hierarchical_allgather",
               "overlap_chunks", "zero_prefetch_chunks")
_N_BASE_DIMS = len(_KNOB_NAMES)
_MAX_MODE_SLOTS = 8

# Aggressiveness ladder for the mode dims (index 3 = int8 is the
# guardrail's pin-back target).
_INT8_IDX = _MODE_LADDER.index("int8")


def _mode_to_unit(mode: str) -> float:
    try:
        idx = _MODE_LADDER.index(str(mode).lower())
    except ValueError:
        idx = 0
    return idx / (len(_MODE_LADDER) - 1)


def _unit_to_mode(u: float) -> str:
    idx = int(round(float(np.clip(u, 0.0, 1.0))
                    * (len(_MODE_LADDER) - 1)))
    return _MODE_LADDER[idx]


def _unit_log2_chunks(chunks: int) -> float:
    log2k = np.log2(max(int(chunks), 1))
    return float(
        (np.clip(log2k, *_LOG2_CHUNKS_RANGE) - _LOG2_CHUNKS_RANGE[0])
        / (_LOG2_CHUNKS_RANGE[1] - _LOG2_CHUNKS_RANGE[0]))


def params_to_unit(threshold_bytes: int, cycle_ms: float, cache: bool,
                   hier_ar: bool = False,
                   hier_ag: bool = False,
                   overlap_chunks: int = 4,
                   zero_prefetch_chunks: int = 4,
                   bucket_modes=()) -> np.ndarray:
    log2mb = np.log2(max(threshold_bytes, 1) / (1024.0 * 1024.0))
    u0 = (np.clip(log2mb, *_LOG2_MB_RANGE) - _LOG2_MB_RANGE[0]) / (
        _LOG2_MB_RANGE[1] - _LOG2_MB_RANGE[0])
    u1 = (np.clip(cycle_ms, *_CYCLE_RANGE) - _CYCLE_RANGE[0]) / (
        _CYCLE_RANGE[1] - _CYCLE_RANGE[0])
    return np.array([u0, u1, float(cache), float(hier_ar),
                     float(hier_ag), _unit_log2_chunks(overlap_chunks),
                     _unit_log2_chunks(zero_prefetch_chunks)] +
                    [_mode_to_unit(m) for m in bucket_modes])


def unit_to_params(u: np.ndarray) -> dict:
    """Unit coordinates -> physical knob values (binaries rounded,
    threshold snapped to a whole power-of-two MB so fusion buckets stay
    stable between nearby samples; chunk count snapped to a power of
    two so bucket shapes stay stable the same way)."""
    log2mb = round(_LOG2_MB_RANGE[0]
                   + float(u[0]) * (_LOG2_MB_RANGE[1] - _LOG2_MB_RANGE[0]))
    cycle = _CYCLE_RANGE[0] + float(u[1]) * (_CYCLE_RANGE[1] - _CYCLE_RANGE[0])
    def _bit(i):  # tolerate legacy 3-dim points (hier dims default off)
        return bool(round(float(u[i]))) if len(u) > i else False

    def _log2k(i):  # tolerate legacy points missing trailing dims
        return round(_LOG2_CHUNKS_RANGE[0] + (float(u[i]) if len(u) > i
                                              else 0.4)
                     * (_LOG2_CHUNKS_RANGE[1] - _LOG2_CHUNKS_RANGE[0]))

    params = {
        "fusion_threshold": int(2 ** log2mb * 1024 * 1024),
        "cycle_time_ms": round(cycle, 2),
        "cache_enabled": _bit(2),
        "hierarchical_allreduce": _bit(3),
        "hierarchical_allgather": _bit(4),
        "overlap_chunks": int(2 ** _log2k(5)),
        "zero_prefetch_chunks": int(2 ** _log2k(6)),
    }
    if len(u) > _N_BASE_DIMS:
        params["bucket_compression"] = ":".join(
            _unit_to_mode(u[i]) for i in range(_N_BASE_DIMS, len(u)))
    return params


def canonical_unit(u: np.ndarray) -> np.ndarray:
    """Snap a proposed point to the coordinates of the config that will
    actually run, so the GP is trained on what was measured (a sample at
    u2=0.51 and one at u2=0.95 both ran with the cache on)."""
    p = unit_to_params(u)
    modes = [m for m in p.get("bucket_compression", "").split(":") if m]
    return params_to_unit(*(p[k] for k in _KNOB_NAMES),
                          bucket_modes=modes)


def apply_params(params: dict) -> None:
    """Export received knob values to the process env (the single
    source of truth every config surface shares).  ``cache_enabled`` is
    applied by the controller, which owns the cache; the executor
    re-reads the others per response.  A value this rank cannot apply
    raises before any knob moves, so the round fails on this rank
    instead of running it with other knobs than its peers."""
    known = ("fusion_threshold", "cycle_time_ms",
             "hierarchical_allreduce", "hierarchical_allgather",
             "overlap_chunks", "zero_prefetch_chunks",
             # the outer-sync period of local SGD (the autopilot's
             # comm_retune may double it at a commit boundary)
             "local_sgd_h",
             # the per-bucket mode vector (adaptive compression)
             "bucket_compression")
    try:
        for k in known:
            if k in params and k != "bucket_compression":
                _config.knobs()[k].parse(str(params[k]))
        if "bucket_compression" in params:
            parse_bucket_modes(str(params["bucket_compression"]))
    except (ValueError, TypeError, HorovodTpuError) as exc:
        raise HorovodTpuError(
            f"autotune: cannot apply the coordinator's proposal "
            f"{params!r}: {exc}") from exc
    for k in known:
        if k in params:
            _config.set_knob(k, params[k])


def _default_comm_signal():
    """Measured comm-exposed seconds per step for the adaptive
    compression objective, or ``None`` when no signal exists yet: the
    device-truth ``hvd_device_comm_exposed_seconds`` gauge when a
    sampled capture has published one, else the ``blocked`` phase of
    the last ``hvd.trace_step`` span (seconds the schedule failed to
    hide).  The gauge is published by the sampled ``torch.profiler``
    capture (``HOROVOD_PROFILE_EVERY_N_STEPS``, ``perf/capture.py``);
    without it the lookup falls through to the ``blocked`` phase."""
    from horovod_tpu_torch.runtime import metrics as _metrics

    try:
        snap = _metrics.registry().snapshot()
    except Exception:  # noqa: BLE001 -- no signal is a valid answer
        return None
    dev = snap.get("hvd_device_comm_exposed_seconds",
                   {}).get("series", [])
    if dev:
        return max(0.0, float(dev[0]["value"]))
    for e in snap.get("hvd_step_phase_seconds_last",
                      {}).get("series", []):
        if e.get("labels", {}).get("phase") == "blocked":
            return max(0.0, float(e["value"]))
    return None


class ParameterManager:
    """Coordinator-side autotuner: feed per-cycle negotiated byte
    counts; every ``steps_per_sample`` cycles it closes a sample
    window, scores the objective (see :meth:`_window_score`), and
    proposes the next knob setting — including, under
    ``HOROVOD_ADAPTIVE_COMPRESSION``, the per-bucket wire-compression
    mode vector (``HOROVOD_BUCKET_COMPRESSION``) subject to the
    bounded-loss guardrail (:meth:`_guard`)."""

    def __init__(self, world: int = 1,
                 hier_possible: bool | None = None,
                 comm_signal=None) -> None:
        self.enabled = bool(_config.get("autotune"))
        self.steps_per_sample = max(
            1, _config.get("autotune_steps_per_sample"))
        self.warmup = _config.get("autotune_warmup_samples")
        self.max_samples = _config.get("autotune_bayes_opt_max_samples")
        self._comm_signal = (comm_signal if comm_signal is not None
                             else _default_comm_signal)
        self._guard_ceiling = float(
            _config.get("compression_guard_ratio"))
        self._world = max(1, int(world))
        # Dims that cannot change behavior are frozen out of the search
        # so the bounded sample budget is spent on knobs that matter:
        # the cache needs a multi-rank negotiation to skip, the
        # hierarchical decomposition needs a 2-level rank layout.
        cache_on = _config.get("cache_capacity") > 0
        if hier_possible is None:
            hier_possible = self._detect_hier_possible(world)
        tuned = [0, 1]
        if cache_on and world > 1:
            tuned.append(2)
        if hier_possible:
            tuned += [3, 4]
        # The chunk-count dim only matters when the overlap engine is
        # on and there is a wire to hide (world > 1); frozen otherwise
        # so the bounded sample budget is never spent splitting buffers
        # nobody transfers.
        if bool(_config.get("overlap")) and world > 1:
            tuned.append(5)
        # The stage-3 prefetch granularity only matters when parameters
        # actually live as shards and there is a wire to prefetch over.
        if int(_config.get("zero_stage")) >= 3 and world > 1:
            tuned.append(6)
        # Adaptive compression (docs/compression.md): one mode dim per
        # overlap bucket slot (capped — slot s governs buckets b with
        # b % slots == s, the HOROVOD_BUCKET_COMPRESSION cycling), one
        # uniform slot without the overlap engine.  Frozen when the
        # knob is off or there is no wire to compress.
        self._mode_slots = 0
        if bool(_config.get("adaptive_compression")) and world > 1:
            self._mode_slots = (
                min(_MAX_MODE_SLOTS,
                    max(1, int(_config.get("overlap_chunks"))))
                if bool(_config.get("overlap")) else 1)
            tuned += list(range(_N_BASE_DIMS,
                                _N_BASE_DIMS + self._mode_slots))
        self._tuned = tuned
        init_modes = [m for m in str(
            _config.get("bucket_compression")).lower().split(":") if m]
        if not init_modes:
            base_mode = str(_config.get("compression")).lower() or "none"
            init_modes = [base_mode if base_mode in _MODE_LADDER
                          else "none"]
        self._fixed_full = params_to_unit(
            _config.get("fusion_threshold"), _config.get("cycle_time_ms"),
            cache_on, bool(_config.get("hierarchical_allreduce")),
            bool(_config.get("hierarchical_allgather")),
            int(_config.get("overlap_chunks")),
            int(_config.get("zero_prefetch_chunks")),
            bucket_modes=[init_modes[s % len(init_modes)]
                          for s in range(self._mode_slots)])
        self.bo = BayesianOptimization(
            dims=len(tuned),
            noise=_config.get("autotune_gaussian_process_noise"))
        self._cycles = 0
        self._bytes = 0
        self._logical_bytes = 0
        self._objective = None  # decided at the first scored window
        self._window_start = time.monotonic()
        self._samples_seen = 0
        self._pinned = False
        self._current = self._fixed_full[self._tuned]
        self._log_path = _config.get("autotune_log")
        if self._log_path:
            with open(self._log_path, "w") as f:
                f.write("sample,score,objective," +
                        ",".join(_KNOB_NAMES) +
                        ",bucket_compression,pinned\n")

    @staticmethod
    def _detect_hier_possible(world: int) -> bool:
        """Whether the hierarchical knobs can change behavior: the
        eager plane built its (cross, local) pair at ``init()``
        (``basics._build_eager_groups``, under the layout rule
        ``parallel.mesh.hier_admissibility``); without the pair the
        executor reduces flat whatever the knobs say."""
        if world <= 1:
            return False
        from horovod_tpu_torch.common import basics as _basics

        return _basics.state().eager_pair is not None

    # -- hot-loop interface ------------------------------------------------

    def record_bytes(self, nbytes: int, logical_nbytes: int | None = None
                     ) -> None:
        self._bytes += int(nbytes)
        self._logical_bytes += int(nbytes if logical_nbytes is None
                                   else logical_nbytes)

    def _full(self, u: np.ndarray) -> np.ndarray:
        """BO-space point -> full unit coordinates (frozen dims filled
        from the job's configured values)."""
        full = self._fixed_full.copy()
        full[self._tuned] = u
        return full

    def _window_score(self, elapsed: float):
        """(score, objective) for the closing window.  With the mode
        dims in the search, bytes/sec is the WRONG objective —
        compression cuts counted wire bytes, so the GP would flee the
        very modes that help — hence the hierarchy (docs/autotune.md):

        * ``comm_exposed`` — 1 / measured comm-exposed seconds per step
          (device truth from a sampled capture, the step-span
          subtraction fallback otherwise), when the signal exists;
        * ``logical_bytes`` — application payload bytes/sec (invariant
          to the wire encoding) when the mode dims are tuned but no
          exposed-comm signal is available;
        * ``wire_bytes`` — the classic bytes/sec, mode dims frozen.

        The objective is chosen once at the first scored window and
        kept, so the GP never regresses on mixed units."""
        if self._objective is None:
            if self._mode_slots and self._comm_signal() is not None:
                self._objective = "comm_exposed"
            elif self._mode_slots:
                self._objective = "logical_bytes"
            else:
                self._objective = "wire_bytes"
        if self._objective == "comm_exposed":
            comm = self._comm_signal()
            if comm is not None and comm >= 0:
                # eps floors the perfectly-hidden case (comm == 0)
                # instead of skipping its window.
                return 1.0 / (comm + 1e-4), self._objective
            return 0.0, self._objective  # signal gap: skip the window
        if self._objective == "logical_bytes":
            return self._logical_bytes / elapsed, self._objective
        return self._bytes / elapsed, self._objective

    def _guard(self, params: dict) -> dict:
        """Bounded-loss guardrail: a mode slot whose reported
        error-feedback residual-to-gradient norm ratio
        (``hvd_compression_residual_ratio``, published by the
        optimizer's EF paths) exceeds the
        ``HOROVOD_COMPRESSION_MAX_RESIDUAL_RATIO`` ceiling is pinned
        back from int4/topk to int8 (ceiling 0 disables the aggressive
        modes for every reported slot) before the proposal is
        broadcast.  The GP is then trained on the guarded point — the
        config that actually ran."""
        spec = params.get("bucket_compression", "")
        if not spec or not self._mode_slots:
            return params
        modes = spec.split(":")
        # PRIMARY signal: the real loss trajectory from the health
        # plane (docs/health.md).  When the job feeds its loss to
        # hvd.health.observe_loss(), the guardrail trusts the actual
        # convergence signal — a diverged/nonfinite trajectory pins
        # EVERY aggressive slot back to int8, a healthy one lets the
        # tuner explore — and the residual-ratio proxy is demoted to
        # the fallback for jobs that never report a loss.
        loss_verdict = None
        try:
            from horovod_tpu_torch.runtime import health as _health

            loss_verdict = _health.loss_guard()
        except Exception:  # noqa: BLE001 -- no verdict: the fallback
            loss_verdict = None
        if loss_verdict is not None and loss_verdict.get("diverged"):
            ratios = {s: float("inf") for s in range(len(modes))}
        elif loss_verdict is not None and self._guard_ceiling > 0:
            ratios = {}  # residual proxy demoted: loss is in charge
        else:
            # No loss trajectory (the fallback), OR the explicit
            # ceiling-0 kill switch: the operator's "disable aggressive
            # modes for reported slots" contract outranks even a
            # healthy loss verdict.
            ratios = self._slot_residual_ratios(len(modes))
        # Topology clamp first: the block-scaled modes refuse axes with
        # no sum-safe headroom (7 // n for int4, 127 // n for int8 —
        # ops/quantization raises loudly), which is right for a
        # hand-set knob but must never let the tuner abort the very job
        # it is tuning mid-run.  The quantized axis is the world for a
        # flat proposal, the (smaller) cross axis when the same
        # proposal turns the hierarchical split on.  The GP then
        # trains on the clamped point.
        n_axis = (self._quantized_axis_size()
                  if params.get("hierarchical_allreduce")
                  else self._world)
        guarded = []
        for s, m in enumerate(modes):
            if m == "int4" and 7 // n_axis < 1:
                m = "int8"
            if m == "int8" and 127 // n_axis < 1:
                m = "fp16"
            r = ratios.get(s)
            if (r is not None and r > self._guard_ceiling
                    and _MODE_LADDER.index(m) > _INT8_IDX):
                m = "int8"
            guarded.append(m)
        params["bucket_compression"] = ":".join(guarded)
        return params

    def _quantized_axis_size(self) -> int:
        """Size of the axis a hierarchical proposal quantizes (the
        cross hop of the eager plane's pair), falling back to the world
        when the two-level layout is unknown -- the conservative answer
        for the clamp."""
        from horovod_tpu_torch.common import basics as _basics

        pair = _basics.state().eager_pair
        if pair is not None and self._world % pair.local.size == 0:
            return max(1, self._world // pair.local.size)
        return self._world

    @staticmethod
    def _slot_residual_ratios(slots: int) -> dict:
        """slot -> worst reported residual ratio (gauge series carry
        raw data-plane bucket indices; slot s owns b % slots == s)."""
        from horovod_tpu_torch.runtime import metrics as _metrics

        out: dict = {}
        try:
            series = _metrics.registry().snapshot().get(
                "hvd_compression_residual_ratio", {}).get("series", [])
        except Exception:  # noqa: BLE001 -- no series, no bound
            return out
        for entry in series:
            try:
                b = int(entry["labels"].get("bucket", 0))
            except (TypeError, ValueError):
                continue
            s = b % max(1, int(slots))
            v = float(entry["value"])
            if s not in out or v > out[s]:
                out[s] = v
        return out

    def tick(self) -> dict | None:
        """Called once per background cycle on rank 0.  Returns a knob
        dict to broadcast when the sample window closed with a new
        proposal, else None."""
        if not self.enabled or self._pinned:
            return None
        self._cycles += 1
        if self._cycles < self.steps_per_sample:
            return None
        now = time.monotonic()
        elapsed = max(now - self._window_start, 1e-6)
        busy = self._bytes > 0
        score, objective = self._window_score(elapsed)
        self._cycles = 0
        self._bytes = 0
        self._logical_bytes = 0
        self._window_start = now
        if score <= 0.0 or not busy:
            return None  # idle window (or signal gap): nothing to learn
        self._samples_seen += 1
        if self._samples_seen <= self.warmup:
            self._log(score, unit_to_params(self._full(self._current)),
                      pinned=False)
            return None
        self.bo.add_sample(self._current, score)
        if self._samples_seen - self.warmup >= self.max_samples:
            best_x, best_y = self.bo.best()
            self._pinned = True
            params = self._guard(unit_to_params(self._full(best_x)))
            self._log(best_y, params, pinned=True)
            _log.info(f"autotune converged: {params} "
                      f"(best {best_y:.4g} {objective}/s-score)", rank=0)
        else:
            nxt = canonical_unit(self._full(self.bo.next_sample()))
            params = self._guard(unit_to_params(nxt))
            # Train the GP on the guarded point — what actually runs.
            self._current = canonical_unit(params_to_unit(
                *(params[k] for k in _KNOB_NAMES),
                bucket_modes=[m for m in params.get(
                    "bucket_compression", "").split(":") if m])
                )[self._tuned]
            self._log(score, params, pinned=False)
        # NOT applied locally here: knobs take effect when the
        # coordinator's broadcast payload is received (all ranks,
        # rank 0 included, at the same round) — see BackgroundRuntime
        # for the world==1 direct-apply case.
        return params

    def _log(self, score: float, params: dict, pinned: bool) -> None:
        if not self._log_path:
            return
        with open(self._log_path, "a") as f:
            f.write(f"{self._samples_seen},{score:.4f},"
                    f"{self._objective}," +
                    ",".join(str(params[k]) for k in _KNOB_NAMES) +
                    f",{params.get('bucket_compression', '')}" +
                    f",{int(pinned)}\n")
