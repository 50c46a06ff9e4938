"""Closed-loop autopilot: the policy engine between the observability
planes and the recovery actuators (this package's copy of
``horovod_tpu/runtime/autopilot.py``; the same rules, gates, verdicts,
flight events and metric series).

==================== ============================== ==================
rule                 evidence                       action
==================== ============================== ==================
straggler_blacklist  heartbeat staleness per rank   blacklist host +
                     (the ranks' KV-published       coordinated shrink
                     ``hvd_heartbeat_staleness_
                     seconds{peer}``)
slo_burn_shrink      FleetGoodput alert firing +    elastic shrink
                     sustained burn_rate            (drop bottleneck)
slo_recover_grow     SLO healthy again after a      elastic grow
                     shrink this run                (respawn joiner)
health_rollback      health sentinel trip /         rollback to last
                     nonfinite culprit verdict      healthy commit
comm_retune          exposed-comm fraction of the   retune overlap
                     goodput ledger                 chunks (or double
                                                    local SGD's H)
                                                    through
                                                    parameter_manager
preempt_drain        advance preemption notice      graceful drain:
                     (``--preempt`` over the KV)    emergency commit,
                                                    no blacklist
==================== ============================== ==================

Every gated rule passes three gates before acting: **hysteresis** (the
same candidate must breach for ``HOROVOD_AUTOPILOT_TRIP_TICKS``
consecutive evaluations -- except ``health_rollback``, whose hysteresis
lives in the health sentinels' trip steps), a per-rule **cooldown**
(``HOROVOD_AUTOPILOT_COOLDOWN_SECONDS``), and a **global rate limit**
(``HOROVOD_AUTOPILOT_RATE_LIMIT`` actions per
``HOROVOD_AUTOPILOT_RATE_WINDOW_SECONDS``, all gated rules combined).
Suppressed verdicts are still recorded (outcome ``suppressed:cooldown``
/ ``suppressed:rate_limit``).  ``HOROVOD_AUTOPILOT_DRY_RUN`` evaluates
and paces everything but calls no actuator.  ``preempt_drain`` is
ungated: an announced departure is not a hypothesis.

Every verdict lands on the flight ring as an ``autopilot`` event with
its evidence tuple, and on ``hvd_autopilot_actions_total{rule,outcome}``.

Deployment is split by actuator locality: the elastic **launcher**
(``run/launcher.py``) owns the fleet actions -- blacklist, shrink, grow,
drain -- and feeds :func:`launcher_observe` every 2 s; the **rank side**
evaluates ``health_rollback`` / ``comm_retune`` once per elastic commit
(:func:`rank_tick`): rank 0 judges, its decision reaches every rank
(over the rendezvous KV in elastic mode, else a broadcast), and every
rank rolls back or retunes together.

The ``clock`` and per-observation ``now`` arguments make the engine run
on an injected clock, as the tests do.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common import logging as _log
from horovod_tpu_torch.runtime import flight as _flight

#: Rule names, in evaluation-priority order (stats/report ordering).
RULES = ("straggler_blacklist", "slo_burn_shrink", "slo_recover_grow",
         "health_rollback", "comm_retune", "preempt_drain")


@dataclass
class Action:
    """One autopilot verdict -- fired, dry-run, or suppressed -- with
    the evidence tuple that produced it."""

    rule: str
    kind: str                # blacklist | shrink | grow | rollback | retune
    target: str              # host / rank<k> / fleet / state / comm
    evidence: dict = field(default_factory=dict)
    outcome: str = "pending"
    seq: int = 0
    time: float = 0.0        # engine clock
    dry_run: bool = False

    def to_dict(self) -> dict:
        return {"rule": self.rule, "kind": self.kind,
                "target": self.target, "evidence": dict(self.evidence),
                "outcome": self.outcome, "seq": self.seq,
                "time": round(self.time, 6), "dry_run": self.dry_run}


class Autopilot:
    """The policy engine.  Construct with explicit thresholds or let
    ``None`` parameters resolve from the knobs.

    ``actuators`` maps rule name -> ``fn(action)``; a rule that fires
    with no actuator records outcome ``no_actuator`` (the engine still
    paces as if it acted, so a later wiring change does not unleash a
    backlog).  ``record=False`` silences the flight/metrics side
    channels (never the returned actions)."""

    def __init__(self, *, dry_run: bool | None = None, clock=None,
                 cooldown_s: float | None = None,
                 rate_limit: int | None = None,
                 rate_window_s: float | None = None,
                 trip_ticks: int | None = None,
                 straggler_factor: float | None = None,
                 straggler_floor_s: float | None = None,
                 burn_threshold: float | None = None,
                 comm_fraction: float | None = None,
                 actuators: dict | None = None, record: bool = True):
        def knob(value, name, cast):
            if value is not None:
                return value
            try:
                return cast(_config.get(name))
            except (TypeError, ValueError):
                return cast(0)

        self.dry_run = bool(knob(dry_run, "autopilot_dry_run", bool))
        self.clock = clock or time.monotonic
        self.cooldown_s = knob(cooldown_s, "autopilot_cooldown", float)
        self.rate_limit = knob(rate_limit, "autopilot_rate_limit", int)
        self.rate_window_s = knob(rate_window_s,
                                  "autopilot_rate_window", float)
        self.trip_ticks = max(1, knob(trip_ticks,
                                      "autopilot_trip_ticks", int))
        self.straggler_factor = knob(straggler_factor,
                                     "autopilot_straggler_factor", float)
        self.straggler_floor_s = knob(straggler_floor_s,
                                      "autopilot_straggler_floor", float)
        self.burn_threshold = knob(burn_threshold,
                                   "autopilot_burn_threshold", float)
        self.comm_fraction = knob(comm_fraction,
                                  "autopilot_comm_fraction", float)
        self.actuators = dict(actuators or {})
        self.record = record
        self.actions: list[Action] = []
        self._streak: dict[str, tuple[str, int]] = {}
        self._last_fired: dict[str, float] = {}
        self._fire_times: list[float] = []
        self._shrunk = 0
        if self.record:
            self._gauge("hvd_autopilot_dry_run",
                        "1 when the autopilot runs in dry-run (shadow) "
                        "mode — verdicts recorded, no actuator fires "
                        "(docs/autopilot.md)").set(int(self.dry_run))

    @classmethod
    def from_env(cls, env: dict, *, actuators: dict | None = None,
                 clock=None, record: bool = True) -> "Autopilot | None":
        """Launcher-side constructor: reads ``HOROVOD_AUTOPILOT*`` from
        the job's env dict (the launcher's ``base_env``, which may carry
        overrides the launcher's own environment does not).  Returns
        None when the autopilot is off."""
        def get(key, default, cast):
            raw = str(env.get(key, "") or "").strip()
            if not raw:
                return default
            try:
                return cast(raw)
            except ValueError:
                return default

        on = str(env.get("HOROVOD_AUTOPILOT", "") or "").strip().lower()
        if on not in ("1", "true", "yes", "on"):
            return None
        dry = str(env.get("HOROVOD_AUTOPILOT_DRY_RUN", "")
                  or "").strip().lower() in ("1", "true", "yes", "on")
        return cls(
            dry_run=dry, clock=clock, actuators=actuators, record=record,
            cooldown_s=get("HOROVOD_AUTOPILOT_COOLDOWN_SECONDS",
                           None, float),
            rate_limit=get("HOROVOD_AUTOPILOT_RATE_LIMIT", None, int),
            rate_window_s=get("HOROVOD_AUTOPILOT_RATE_WINDOW_SECONDS",
                              None, float),
            trip_ticks=get("HOROVOD_AUTOPILOT_TRIP_TICKS", None, int),
            straggler_factor=get("HOROVOD_AUTOPILOT_STRAGGLER_FACTOR",
                                 None, float),
            straggler_floor_s=get("HOROVOD_AUTOPILOT_STRAGGLER_FLOOR",
                                  None, float),
            burn_threshold=get("HOROVOD_AUTOPILOT_BURN_THRESHOLD",
                               None, float),
            comm_fraction=get("HOROVOD_AUTOPILOT_COMM_FRACTION",
                              None, float))

    # -- rule evaluation ---------------------------------------------------

    def observe_stragglers(self, lateness: dict, hosts: dict | None = None,
                           baseline: float | None = None,
                           now: float | None = None) -> Action | None:
        """Preemptive-blacklist rule.  ``lateness``: rank -> seconds
        behind the fleet (heartbeat staleness on the launcher).
        ``hosts``: rank -> host, to name the blacklist target;
        ``baseline`` overrides the fleet median."""
        now = self._now(now)
        if not lateness:
            self._disarm("straggler_blacklist")
            return None
        worst = max(sorted(lateness), key=lambda r: lateness[r])
        vals = sorted(lateness.values())
        # lower median: in a 2-host fleet the upper median IS the
        # straggler, which would set the budget from its own lateness
        med = vals[(len(vals) - 1) // 2] if baseline is None \
            else baseline
        threshold = max(self.straggler_floor_s,
                        self.straggler_factor * med)
        if lateness[worst] <= threshold:
            self._disarm("straggler_blacklist")
            return None
        host = (hosts or {}).get(worst)
        candidate = host if host is not None else f"rank{worst}"
        streak = self._arm("straggler_blacklist", candidate)
        evidence = {"rank": int(worst), "host": host,
                    "lateness_s": round(float(lateness[worst]), 6),
                    "baseline_s": round(float(med), 6),
                    "threshold_s": round(float(threshold), 6),
                    "streak": streak, "world": len(lateness)}
        if streak < self.trip_ticks:
            return None
        return self._fire("straggler_blacklist", "blacklist",
                          candidate, evidence, now)

    def observe_goodput(self, report: dict | None,
                        now: float | None = None) -> Action | None:
        """SLO-burn rule pair, fed a :class:`FleetGoodput` report
        (``report["alert"]`` / ``report["window"]``).  Sustained burn
        at or above the threshold -> shrink (dropping the dominant
        bottleneck); sustained recovery after a shrink -> grow."""
        now = self._now(now)
        alert = (report or {}).get("alert") or {}
        window = (report or {}).get("window") or {}
        burn = float(alert.get("burn_rate") or 0.0)
        if alert.get("firing") and burn >= self.burn_threshold:
            self._disarm("slo_recover_grow")
            dom = window.get("dominant_bottleneck") or {}
            rank = dom.get("rank")
            candidate = "fleet" if rank is None else f"rank{int(rank)}"
            streak = self._arm("slo_burn_shrink", candidate)
            evidence = {
                "goodput": round(float(window.get("goodput") or 0.0), 6),
                "slo": float(alert.get("slo") or 0.0),
                "burn_rate": round(burn, 4),
                "reason": alert.get("reason"),
                "bottleneck_phase": dom.get("phase"),
                "bottleneck_rank": rank, "streak": streak}
            if streak < self.trip_ticks:
                return None
            action = self._fire("slo_burn_shrink", "shrink", candidate,
                                evidence, now)
            if action is not None and action.outcome in ("applied",
                                                         "dry_run"):
                self._shrunk += 1
            return action
        self._disarm("slo_burn_shrink")
        if not alert or alert.get("firing") or self._shrunk <= 0:
            self._disarm("slo_recover_grow")
            return None
        streak = self._arm("slo_recover_grow", "fleet")
        evidence = {
            "goodput": round(float(window.get("goodput") or 0.0), 6),
            "slo": float(alert.get("slo") or 0.0),
            "burn_rate": round(burn, 4),
            "shrunk_this_run": self._shrunk, "streak": streak}
        if streak < self.trip_ticks:
            return None
        action = self._fire("slo_recover_grow", "grow", "fleet",
                            evidence, now)
        if action is not None and action.outcome in ("applied",
                                                     "dry_run"):
            self._shrunk -= 1
        return action

    def observe_health(self, active_alerts, nonfinite_events: int = 0,
                       culprits: dict | None = None,
                       now: float | None = None) -> Action | None:
        """Auto-rollback rule.  No hysteresis of its own -- the health
        sentinels already require ``HOROVOD_HEALTH_TRIP_STEPS``
        consecutive breaches before an alert goes active -- so the first
        active alert fires (the cooldown then prevents rollback loops
        while the alert drains)."""
        now = self._now(now)
        alerts = sorted(active_alerts or [])
        if not alerts:
            return None
        evidence = {"alerts": alerts,
                    "nonfinite_events": int(nonfinite_events)}
        if culprits:
            evidence["culprits"] = {str(k): int(v)
                                    for k, v in culprits.items()}
        return self._fire("health_rollback", "rollback", "state",
                          evidence, now)

    def observe_comm(self, exposed_s: float, compute_s: float,
                     now: float | None = None) -> Action | None:
        """Retune rule: sustained exposed communication above the
        budgeted fraction of exposed + compute proposes a knob change
        (the actuator calls ``parameter_manager.apply_params``)."""
        now = self._now(now)
        total = float(exposed_s) + float(compute_s)
        if total <= 0.0:
            self._disarm("comm_retune")
            return None
        fraction = float(exposed_s) / total
        if fraction <= self.comm_fraction:
            self._disarm("comm_retune")
            return None
        # Under local SGD the biggest exposed-comm lever is the outer
        # sync period itself: doubling H halves the cross-slice rounds.
        try:
            h = int(_config.get("local_sgd_h"))
        except (TypeError, ValueError):
            h = 0
        if h > 1:
            proposed_h = min(h * 2, 64)
            if proposed_h == h:
                self._disarm("comm_retune")
                return None
            proposal = {"local_sgd_h": proposed_h}
        else:
            try:
                current = int(_config.get("overlap_chunks"))
            except (TypeError, ValueError):
                current = 1
            # finer interleave within the autotuner's own 1..32 bounds
            proposed = min(max(current, 1) * 2, 32)
            if proposed == current:
                self._disarm("comm_retune")
                return None
            proposal = {"overlap_chunks": proposed}
        streak = self._arm("comm_retune", "comm")
        evidence = {"exposed_s": round(float(exposed_s), 6),
                    "compute_s": round(float(compute_s), 6),
                    "fraction": round(fraction, 4),
                    "budget_fraction": self.comm_fraction,
                    "proposal": proposal,
                    "streak": streak}
        if streak < self.trip_ticks:
            return None
        return self._fire("comm_retune", "retune", "comm", evidence,
                          now)

    def observe_preemption(self, rank: int, host: str | None = None,
                           source: str = "notice",
                           grace_s: float | None = None,
                           deadline: float | None = None,
                           now: float | None = None) -> Action | None:
        """Graceful-drain rule.  An advance preemption notice needs no
        hysteresis, cooldown or rate limit -- the host IS going away,
        and suppressing the drain would turn an announced departure
        back into a heartbeat-timeout stall -- so this rule fires
        ungated: every notice gives exactly one verdict, still recorded
        on the flight ring."""
        now = self._now(now)
        if rank is None:
            return None
        evidence = {"rank": int(rank), "host": host, "source": source}
        if grace_s is not None:
            evidence["grace_s"] = round(float(grace_s), 3)
        if deadline is not None:
            evidence["deadline"] = round(float(deadline), 3)
        return self._fire("preempt_drain", "drain", f"rank{int(rank)}",
                          evidence, now, gated=False)

    # -- gates + bookkeeping -----------------------------------------------

    def _now(self, now: float | None) -> float:
        return self.clock() if now is None else float(now)

    def _arm(self, rule: str, candidate: str) -> int:
        prev, streak = self._streak.get(rule, (None, 0))
        streak = streak + 1 if prev == candidate else 1
        self._streak[rule] = (candidate, streak)
        return streak

    def _disarm(self, rule: str) -> None:
        self._streak.pop(rule, None)

    def _fire(self, rule: str, kind: str, target: str, evidence: dict,
              now: float, gated: bool = True) -> Action:
        action = Action(rule=rule, kind=kind, target=str(target),
                        evidence=dict(evidence), seq=len(self.actions),
                        time=now, dry_run=self.dry_run)
        last = self._last_fired.get(rule)
        if gated and last is not None and now - last < self.cooldown_s:
            action.outcome = "suppressed:cooldown"
        else:
            self._fire_times = [t for t in self._fire_times
                                if now - t < self.rate_window_s]
            if gated and len(self._fire_times) >= self.rate_limit:
                action.outcome = "suppressed:rate_limit"
            else:
                # Ungated fires (preempt_drain) still stamp _last_fired
                # for the gauges but stay out of the shared rate window:
                # a preemption storm must not starve the gated rules
                if gated:
                    self._fire_times.append(now)
                self._last_fired[rule] = now
                if self.dry_run:
                    action.outcome = "dry_run"
                else:
                    fn = self.actuators.get(rule)
                    if fn is None:
                        action.outcome = "no_actuator"
                    else:
                        try:
                            fn(action)
                            action.outcome = "applied"
                        except Exception as exc:  # noqa: BLE001
                            action.outcome = \
                                f"failed:{type(exc).__name__}"
                            _log.warning(
                                f"autopilot {rule} actuator failed: "
                                f"{exc}")
        # The hysteresis streak resets after ANY verdict (fired or
        # suppressed): the condition must re-sustain trip_ticks before
        # the next attempt.
        self._disarm(rule)
        self.actions.append(action)
        self._emit(action)
        return action

    def _gauge(self, name: str, help: str):
        from horovod_tpu_torch.runtime import metrics as _metrics

        return _metrics.gauge(name, help)

    def _emit(self, action: Action) -> None:
        if not self.record:
            return
        try:
            # the event kind is "autopilot"; the action verb rides as
            # "act" (kind= would collide with flight.record's own arg)
            _flight.record("autopilot", rule=action.rule,
                           act=action.kind, target=action.target,
                           outcome=action.outcome,
                           evidence=action.evidence)
            from horovod_tpu_torch.runtime import metrics as _metrics

            _metrics.counter(
                "hvd_autopilot_actions_total",
                "Autopilot verdicts by rule and outcome — applied, "
                "dry_run, suppressed:cooldown, suppressed:rate_limit, "
                "no_actuator, failed:* (docs/autopilot.md)").inc(
                rule=action.rule, outcome=action.outcome)
            last = self._last_fired.get(action.rule)
            self._gauge(
                "hvd_autopilot_cooldown_active",
                "1 while the labeled rule sits in its post-fire "
                "cooldown window (docs/autopilot.md)").set(
                int(last is not None
                    and action.time - last < self.cooldown_s),
                rule=action.rule)
        except Exception:  # noqa: BLE001
            pass
        lvl = _log.info if action.outcome.startswith("suppressed") \
            else _log.warning
        lvl(f"autopilot: {action.rule} -> {action.kind} "
            f"{action.target} [{action.outcome}] {action.evidence}")

    def refresh_gauges(self, now: float | None = None) -> None:
        """Re-derive the per-rule cooldown gauge from the clock: the
        launcher calls this each evidence sweep, so an expired cooldown
        reads 0 without waiting for the next verdict."""
        if not self.record:
            return
        now = self._now(now)
        try:
            g = self._gauge("hvd_autopilot_cooldown_active", "")
            for rule in RULES:
                last = self._last_fired.get(rule)
                active = last is not None \
                    and now - last < self.cooldown_s
                g.set(int(active), rule=rule)
        except Exception:  # noqa: BLE001
            pass

    def stats(self) -> dict:
        """Verdict counts by rule and outcome, and the applied
        rollbacks."""
        by_rule: dict[str, int] = {}
        by_outcome: dict[str, int] = {}
        for a in self.actions:
            by_rule[a.rule] = by_rule.get(a.rule, 0) + 1
            by_outcome[a.outcome] = by_outcome.get(a.outcome, 0) + 1
        return {"actions_total": len(self.actions),
                "by_rule": by_rule, "by_outcome": by_outcome,
                "rollbacks": sum(
                    1 for a in self.actions
                    if a.rule == "health_rollback"
                    and a.outcome == "applied"),
                "dry_run": self.dry_run}


# ---------------------------------------------------------------------------
# Launcher-side evidence extraction
# ---------------------------------------------------------------------------


def launcher_observe(ap: Autopilot, snaps: list, fleet=None,
                     now: float | None = None, *,
                     hosts: dict | None = None, stragglers: bool = True,
                     stepped_only: bool = False) -> None:
    """One launcher evidence sweep: feed the KV-published per-rank
    metrics snapshots (``metrics.aggregate_snapshots``) into the engine.

    Straggler lateness is the heartbeat staleness each sweeping rank
    published for its peers (``hvd_heartbeat_staleness_seconds{peer=<
    rank>}``, worst observer wins): a chronically slow host shows up
    here long before its heartbeat timeout kills it.  ``fleet`` (a
    :class:`~horovod_tpu_torch.perf.goodput.FleetGoodput`) turns the
    same snapshots into the windowed SLO report for the burn rules.

    The keywords are the port's launcher's, and their defaults give the
    JAX package's sweep: ``hosts`` (rank -> the launcher's own name for
    its host) replaces the snapshots' ``host`` meta; ``stragglers=False``
    leaves the straggler rule unfed (every rank on one host, which the
    blacklist could only shed whole); ``stepped_only`` lets a rank into
    the SLO evidence once its ledger has booked compute, and judges a
    report only when its window spans two samples: the start (the
    model's build, the first steps) is booked outside any span, and no
    shed shortens it."""
    lateness: dict[int, float] = {}
    meta_hosts: dict[int, str] = {}
    for s in snaps:
        meta = (s or {}).get("meta") or {}
        try:
            r = int(meta.get("rank"))
        except (TypeError, ValueError):
            r = None
        if r is not None and meta.get("host"):
            meta_hosts[r] = str(meta["host"])
        series = (((s or {}).get("metrics") or {}).get(
            "hvd_heartbeat_staleness_seconds") or {}).get("series") or []
        for row in series:
            try:
                peer = int((row.get("labels") or {}).get("peer"))
                val = float(row.get("value") or 0.0)
            except (TypeError, ValueError):
                continue
            lateness[peer] = max(lateness.get(peer, 0.0), val)
    if lateness and stragglers:
        ap.observe_stragglers(lateness,
                              hosts=meta_hosts if hosts is None else hosts,
                              now=now)
    if fleet is not None and snaps:
        from horovod_tpu_torch.perf import goodput as _goodput

        ledgers = [led for led in
                   (_goodput.from_metrics_snapshot(s) for s in snaps)
                   if led is not None]
        if stepped_only:
            ledgers = [led for led in ledgers
                       if led["phases"].get("compute", 0.0) > 0.0]
        if ledgers:
            report = fleet.update(ledgers, now=now)
            if not stepped_only or report["window"]["seconds"] > 0.0:
                ap.observe_goodput(report, now=now)


# ---------------------------------------------------------------------------
# Rank-side driver (the elastic commit hook)
# ---------------------------------------------------------------------------

_rank_ap: Autopilot | None = None


def rank_autopilot() -> Autopilot:
    """The process's engine for the rank-local rules (health_rollback,
    comm_retune), configured from the knobs."""
    global _rank_ap
    if _rank_ap is None:
        _rank_ap = Autopilot()
    return _rank_ap


def reset() -> None:
    """Drop the rank-side engine (tests; a new run in one process)."""
    global _rank_ap
    _rank_ap = None


def rank_tick(state) -> dict:
    """One autopilot evaluation at an elastic commit boundary.

    Collective when the world is: rank 0 gathers the evidence (the
    health monitor's snapshot, the goodput ledger's phases) and judges;
    its decision reaches every rank (``elastic.share_from_rank0`` in
    elastic mode, else ``broadcast_object``) so every rank performs the
    SAME rollback / retune (a rollback is itself a collective restore).  Evidence
    gathering and the retune are advisory (a failure warns); a rollback
    the engine decided on is not: ``rollback_to_healthy``'s errors reach
    the caller.  Returns the decision dict."""
    from horovod_tpu_torch.common import basics as _basics

    ap = rank_autopilot()
    st = _basics.state()
    leader = (not st.initialized) or st.rank == 0
    decision: dict = {"rollback": False, "retune": None}
    if leader:
        if getattr(state, "checkpoint_dir", None):
            ap.actuators["health_rollback"] = \
                lambda a: decision.update(rollback=True)
            alerts: list = []
            nonfinite = 0
            culprits: dict = {}
            try:
                from horovod_tpu_torch.runtime import health as _health

                hsnap = _health.monitor().snapshot()
                alerts = list(hsnap.get("active_alerts") or [])
                nonfinite = int(hsnap.get("nonfinite_events") or 0)
                # the snapshot's culprits are a list of records, so a
                # non-empty list raises here and the evidence carries
                # none: the JAX package's verdicts do the same
                culprits = dict(hsnap.get("culprits") or {})
            except Exception:  # noqa: BLE001
                pass
            ap.observe_health(alerts, nonfinite, culprits=culprits)
        ap.actuators["comm_retune"] = \
            lambda a: decision.update(
                retune=dict(a.evidence.get("proposal") or {}))
        try:
            from horovod_tpu_torch.perf import goodput as _goodput

            phases = (_goodput.ledger().snapshot() or {}).get(
                "phases") or {}
            ap.observe_comm(float(phases.get("comm_exposed") or 0.0),
                            float(phases.get("compute") or 0.0))
        except Exception:  # noqa: BLE001
            pass
    if st.initialized and st.size > 1:
        from horovod_tpu_torch import elastic as _elastic

        if _elastic.enabled():
            # over the rendezvous KV, with the commit boundary's
            # liveness-checked wait: a gloo survivor blocked in a
            # broadcast whose root left on a dead peer would wait out the
            # gloo op timeout, past the re-form's settle window
            decision = _elastic.share_from_rank0(
                decision if leader else None)
        else:
            from horovod_tpu_torch.optim.distributed import \
                broadcast_object

            decision = broadcast_object(decision if leader else None,
                                        root_rank=0)
    if decision.get("retune"):
        try:
            from horovod_tpu_torch.runtime import parameter_manager as _pm

            _pm.apply_params(decision["retune"])
        except Exception as exc:  # noqa: BLE001
            _log.warning(f"autopilot retune failed: {exc}")
    if decision.get("rollback"):
        state.rollback_to_healthy()
    return decision
