"""Deterministic fault injection for the control-plane wire
(counterpart of ``horovod_tpu/runtime/faults.py``: the same grammar,
rules and error texts).

The reference has no equivalent — its fault-tolerance story (the
launcher killing the job when a rank dies, ``gloo_run.py:294-304``) is
only testable by killing real processes.  This module makes the failure
modes the fault-tolerant control plane must handle *injectable*: any
transport (JaxCoordTransport, KVStoreClient, or a test fake) can be
wrapped so that specific keys are delayed, specific writes are dropped,
or a specific rank crashes at a specific negotiation round — all
deterministic, so CI can assert exact behavior.

``preempt:`` delivers a notice to the preemption plane
(``runtime/preemption.py``) at the rank's first transport op touching
the round.  ``nan:``/``inf:`` poison the eager wire's
payloads (:func:`poison_entries`) and, in their round-less form, the
in-trace optimizer's gradients under ``HOROVOD_HEALTH``
(:func:`traced_poison`).

Spec grammar (``HOROVOD_FAULT_SPEC``, comma-separated)::

    delay:<keyglob>:<duration>     # sleep before matching ops
                                   #   delay:q/*:5s   delay:hb/*:250ms
    drop:<keyglob>[:<count>]       # swallow the first <count> (default
                                   # 1) matching WRITES (set/set_once):
                                   #   drop:p/3       drop:q/2/1:2
    die:rank<k>[:round<n>]         # rank k calls os._exit(137) at its
                                   # first transport op touching round
                                   # >= n (default 0 = first op):
                                   #   die:rank1:round4
    preempt:rank<k>[:round<n>][:grace<s>]
                                   # graceful advance notice instead of
                                   # die's hard exit: rank k receives a
                                   # preemption notice (runtime/
                                   # preemption.py) at its first
                                   # transport op touching round >= n
                                   # and DRAINS — emergency commit,
                                   # clean exit, proactive re-form —
                                   # inside the grace window (default
                                   # HOROVOD_PREEMPT_GRACE_SECONDS):
                                   #   preempt:rank1:round4:grace30s
    slow:<rank>:<delay>            # chronic straggler: rank k sleeps
                                   # <delay> before EVERY transport op
                                   # (key-independent, never expires) —
                                   # the signal the autopilot's
                                   # preemptive-blacklist rule keys on:
                                   #   slow:3:200ms   slow:rank3:200ms
    nan:<nameglob>[:round<n>]      # poison one element of matching
    inf:<nameglob>[:round<n>]      # float GRADIENT payloads to NaN/Inf
                                   # (docs/health.md culprit tests):
                                   #   nan@rank1:grad_buffer*:round2

``delay``, ``drop``, ``nan`` and ``inf`` accept an optional rank scope
— ``delay@rank<k>:...`` etc. — restricting the rule to one rank.  The
env spec is necessarily identical on every rank, so scoping is how a
test makes ONE rank slow/lossy/poisoned (a straggler, a NaN culprit)
while its peers stay healthy.

``nan``/``inf`` are DATA-plane rules: the glob matches payload names —
negotiated-wire buffer names (``grad_buffer.float32.6``,
``shard_rs.float32.128``) on the eager path, or the in-trace
pseudo-names ``grads.<dtype>`` the DistributedOptimizer's health tap
exposes.  With ``round<n>`` the rule fires ONCE at the first matching
dispatch of negotiation round >= n (deterministically testable culprit
attribution); without it, every matching payload is poisoned (in-trace
rules support only this round-less form — traced programs have no
negotiation round).

Key globs match against epoch-stripped keys (``q/<round>/<rank>``,
``p/<round>``, ``k/<round>``, ``hb/<rank>``, ``a``) via :mod:`fnmatch`,
so specs don't depend on the init generation.  Drops intercept only
mutations: a dropped write is the canonical lost-message fault (the
reader side then observes absence through its own deadline machinery).
"""

from __future__ import annotations

import fnmatch
import os
import re
import time
from dataclasses import dataclass, field

from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common import logging as _log

_EPOCH_PREFIX = re.compile(r"^hvd\d+/")
_DURATION = re.compile(r"^(\d+(?:\.\d+)?)(ms|s)?$")


class FaultSpecError(ValueError):
    """Malformed ``HOROVOD_FAULT_SPEC`` entry."""


def parse_duration(text: str) -> float:
    """``5s`` / ``250ms`` / ``0.5`` (seconds) -> seconds."""
    m = _DURATION.match(text.strip())
    if not m:
        raise FaultSpecError(f"bad duration {text!r} (want e.g. 5s, 250ms)")
    value = float(m.group(1))
    return value / 1000.0 if m.group(2) == "ms" else value


#: Rule kinds that act on the data plane (gradient payloads), not the
#: control-plane transport — FaultyTransport ignores them.
DATA_KINDS = ("nan", "inf")


@dataclass
class Rule:
    kind: str                 # delay | drop | die | slow | nan | inf
    pattern: str = "*"
    delay_s: float = 0.0
    remaining: int | None = None   # None = unlimited (delay); drop: count
    rank: int = -1            # die / slow
    round: int = 0            # die / nan / inf round gate
    only_rank: int = -1       # delay/drop/nan/inf @rank scope; -1 = all
    fired: int = field(default=0)

    def take(self) -> bool:
        """Consume one application; False once the budget is spent."""
        if self.remaining is None:
            self.fired += 1
            return True
        if self.remaining <= 0:
            return False
        self.remaining -= 1
        self.fired += 1
        return True


def parse_spec(spec: str) -> list[Rule]:
    rules: list[Rule] = []
    for raw in spec.split(","):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        kind = parts[0].strip().lower()
        only_rank = -1
        if "@" in kind and kind.split("@", 1)[0] in \
                ("delay", "drop") + DATA_KINDS:
            kind, scope = kind.split("@", 1)
            if not scope.startswith("rank") \
                    or not scope[len("rank"):].isdigit():
                raise FaultSpecError(
                    f"bad rank scope in {raw!r} (want e.g. "
                    "delay@rank1:<glob>:<duration>)")
            only_rank = int(scope[len("rank"):])
        if kind == "delay":
            if len(parts) != 3:
                raise FaultSpecError(
                    f"delay spec {raw!r} wants delay:<glob>:<duration>")
            rules.append(Rule("delay", pattern=parts[1],
                              delay_s=parse_duration(parts[2]),
                              only_rank=only_rank))
        elif kind == "drop":
            if len(parts) not in (2, 3):
                raise FaultSpecError(
                    f"drop spec {raw!r} wants drop:<glob>[:<count>]")
            count = 1
            if len(parts) == 3:
                if not parts[2].isdigit() or int(parts[2]) < 1:
                    raise FaultSpecError(
                        f"drop count {parts[2]!r} must be a positive int")
                count = int(parts[2])
            rules.append(Rule("drop", pattern=parts[1], remaining=count,
                              only_rank=only_rank))
        elif kind == "die":
            if len(parts) not in (2, 3) or not parts[1].startswith("rank"):
                raise FaultSpecError(
                    f"die spec {raw!r} wants die:rank<k>[:round<n>]")
            rank_s = parts[1][len("rank"):]
            if not rank_s.isdigit():
                raise FaultSpecError(f"bad die rank in {raw!r}")
            round_n = 0
            if len(parts) == 3:
                if not parts[2].startswith("round") \
                        or not parts[2][len("round"):].isdigit():
                    raise FaultSpecError(f"bad die round in {raw!r}")
                round_n = int(parts[2][len("round"):])
            rules.append(Rule("die", rank=int(rank_s), round=round_n,
                              remaining=1))
        elif kind == "preempt":
            # Rule shape mirrors die: (same determinism contract), plus
            # an optional grace window carried in delay_s — the notice
            # is delivered instead of the process being killed.
            if len(parts) not in (2, 3, 4) \
                    or not parts[1].startswith("rank"):
                raise FaultSpecError(
                    f"preempt spec {raw!r} wants "
                    "preempt:rank<k>[:round<n>][:grace<s>]")
            rank_s = parts[1][len("rank"):]
            if not rank_s.isdigit():
                raise FaultSpecError(f"bad preempt rank in {raw!r}")
            round_n = 0
            grace_s = 0.0  # 0 = use HOROVOD_PREEMPT_GRACE_SECONDS
            for extra in parts[2:]:
                if extra.startswith("round") \
                        and extra[len("round"):].isdigit():
                    round_n = int(extra[len("round"):])
                elif extra.startswith("grace"):
                    grace_s = parse_duration(extra[len("grace"):])
                else:
                    raise FaultSpecError(
                        f"bad preempt modifier {extra!r} in {raw!r} "
                        "(want round<n> and/or grace<s>)")
            rules.append(Rule("preempt", rank=int(rank_s),
                              round=round_n, delay_s=grace_s,
                              remaining=1))
        elif kind == "slow":
            if len(parts) != 3:
                raise FaultSpecError(
                    f"slow spec {raw!r} wants slow:<rank>:<delay> "
                    "(e.g. slow:3:200ms)")
            rank_s = parts[1].strip()
            if rank_s.startswith("rank"):
                rank_s = rank_s[len("rank"):]
            if not rank_s.isdigit():
                raise FaultSpecError(f"bad slow rank in {raw!r}")
            rules.append(Rule("slow", rank=int(rank_s),
                              delay_s=parse_duration(parts[2])))
        elif kind in DATA_KINDS:
            if len(parts) not in (2, 3):
                raise FaultSpecError(
                    f"{kind} spec {raw!r} wants "
                    f"{kind}:<nameglob>[:round<n>]")
            round_n = 0
            remaining = None  # round-less: poison every matching payload
            if len(parts) == 3:
                if not parts[2].startswith("round") \
                        or not parts[2][len("round"):].isdigit():
                    raise FaultSpecError(f"bad {kind} round in {raw!r}")
                round_n = int(parts[2][len("round"):])
                remaining = 1  # round-scoped: fire once, deterministic
            rules.append(Rule(kind, pattern=parts[1], round=round_n,
                              remaining=remaining, only_rank=only_rank))
        else:
            raise FaultSpecError(
                f"unknown fault kind {kind!r} in {raw!r} "
                "(delay | drop | die | preempt | slow | nan | inf)")
    return rules


def strip_epoch(key: str) -> str:
    return _EPOCH_PREFIX.sub("", key)


def round_of(key: str) -> int | None:
    """Negotiation round a (stripped) controller key belongs to, or
    None for non-round keys (heartbeats, abort, run-func payloads).
    Covers both the flat keys (``q/<r>/<rank>``, ``p/<r>``,
    ``k/<r>``) and the hierarchical control plane's
    (``sq/<slice>/<r>/<rank>``, ``sp/<slice>/<r>``,
    ``sk/<slice>/<r>``, ``gq/<r>/<slice>``) so round-scoped rules
    (``die:rankK:roundN``) keep firing under either mode."""
    parts = key.split("/")
    if len(parts) >= 2 and parts[0] in ("q", "p", "k", "gq") \
            and parts[1].isdigit():
        return int(parts[1])
    if len(parts) >= 3 and parts[0] in ("sq", "sp", "sk") \
            and parts[2].isdigit():
        return int(parts[2])
    return None


class FaultyTransport:
    """Wraps any controller transport, applying the parsed rules.

    ``die`` rules fire on *any* transport op (read or write) of the
    matching rank once the op's key reaches the target round; ``delay``
    rules sleep on every matching op; ``slow`` rules sleep on EVERY op
    of the scoped rank (a chronic straggler); ``drop`` rules swallow
    matching writes while their budget lasts.  The wrapper is transparent
    otherwise — unknown attributes forward to the inner transport, so
    optional surfaces (``set_overwrite``, ``close``, ``ping``) survive
    wrapping.
    """

    def __init__(self, inner, rank: int, rules: list[Rule]):
        self.inner = inner
        self.rank = rank
        self.rules = rules

    # -- rule engine -------------------------------------------------------

    def _intercept(self, key: str, write: bool) -> bool:
        """Apply rules for one op; returns True when the op must be
        dropped."""
        stripped = strip_epoch(key)
        rnd = round_of(stripped)
        dropped = False
        for rule in self.rules:
            if rule.kind in DATA_KINDS:
                continue  # gradient poisoning never touches transport
            if rule.kind == "die":
                if rule.rank == self.rank and rule.remaining \
                        and (rule.round == 0
                             or (rnd is not None and rnd >= rule.round)):
                    _log.error(
                        f"[fault] die:rank{rule.rank}:round{rule.round} "
                        f"firing on key {stripped!r}", rank=self.rank)
                    os._exit(137)
                continue
            if rule.kind == "preempt":
                # die:'s graceful sibling -- deliver the advance notice
                # (the rank publishes and drains at its next step
                # boundary) and let the op proceed; take() so the rule
                # fires exactly once
                if rule.rank == self.rank \
                        and (rule.round == 0
                             or (rnd is not None and rnd >= rule.round)) \
                        and rule.remaining and rule.take():
                    _log.warning(
                        f"[fault] preempt:rank{rule.rank}:"
                        f"round{rule.round} delivering notice on key "
                        f"{stripped!r}", rank=self.rank)
                    from horovod_tpu_torch.runtime import preemption

                    preemption.notice(source="fault",
                                      grace_s=rule.delay_s or None)
                continue
            if rule.kind == "slow":
                # chronic straggler: key-independent, never expires —
                # every transport op of the scoped rank pays the tax
                if rule.rank == self.rank:
                    rule.fired += 1
                    time.sleep(rule.delay_s)
                continue
            if rule.only_rank >= 0 and rule.only_rank != self.rank:
                continue
            if not fnmatch.fnmatch(stripped, rule.pattern):
                continue
            if rule.kind == "delay":
                time.sleep(rule.delay_s)
            elif rule.kind == "drop" and write and rule.take():
                _log.warning(
                    f"[fault] dropping write of {stripped!r} "
                    f"({rule.remaining} drops left)", rank=self.rank)
                dropped = True
        return dropped

    # -- transport surface -------------------------------------------------

    def set(self, key: str, value: str) -> None:
        if self._intercept(key, write=True):
            return
        self.inner.set(key, value)

    def set_once(self, key: str, value: str) -> None:
        if self._intercept(key, write=True):
            return
        self.inner.set_once(key, value)

    def set_overwrite(self, key: str, value: str) -> None:
        if self._intercept(key, write=True):
            return
        fn = getattr(self.inner, "set_overwrite", None)
        if fn is not None:
            fn(key, value)
        else:
            self.inner.set(key, value)

    def get_blocking(self, key: str, timeout_s: float) -> str:
        self._intercept(key, write=False)
        return self.inner.get_blocking(key, timeout_s)

    def try_get(self, key: str):
        self._intercept(key, write=False)
        return self.inner.try_get(key)

    def delete(self, key: str) -> None:
        self._intercept(key, write=False)
        self.inner.delete(key)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def check_spec() -> None:
    """Parse ``HOROVOD_FAULT_SPEC`` (``init()`` calls this at every
    world size): a malformed spec raises :class:`FaultSpecError`."""
    spec = str(_config.get("fault_spec") or "").strip()
    if spec:
        parse_spec(spec)


def maybe_wrap(transport, rank: int):
    """Wrap ``transport`` when ``HOROVOD_FAULT_SPEC`` is set (the single
    hook :func:`controller.make_controller` calls); identity otherwise."""
    spec = str(_config.get("fault_spec") or "").strip()
    if not spec:
        return transport
    rules = parse_spec(spec)
    _log.warning(
        f"HOROVOD_FAULT_SPEC active ({spec!r}): injecting "
        f"{len(rules)} fault rule(s) into the control-plane transport "
        "— testing mode, never production", rank=rank)
    return FaultyTransport(transport, rank, rules)


# ---------------------------------------------------------------------------
# Data-plane gradient poisoning (nan:/inf: — docs/health.md)
# ---------------------------------------------------------------------------

# Parsed nan/inf rules, cached per spec string: the background loop
# consults this on every dispatch and the common case (no spec) must be
# one string compare.  Rule state (remaining budgets) lives in the
# cached list, so round-scoped rules fire exactly once per process.
_data_cache: tuple[str, list[Rule]] = ("", [])


def data_rules() -> list[Rule]:
    """The active nan/inf poisoning rules ([] when no spec is set).

    A malformed spec RAISES (FaultSpecError) instead of degrading to
    no rules: in the single-process in-trace regime no FaultyTransport
    exists to surface the parse error, and a typo'd injection spec
    silently becoming a no-op would turn the very test that proves
    NaN detection into a vacuous pass."""
    global _data_cache
    spec = str(_config.get("fault_spec") or "").strip()
    cached_spec, cached = _data_cache
    if spec == cached_spec:
        return cached
    rules = [r for r in parse_spec(spec)
             if r.kind in DATA_KINDS] if spec else []
    _data_cache = (spec, rules)
    return rules


def _poison_value(kind: str) -> float:
    return float("nan") if kind == "nan" else float("inf")


def poison_entries(entries: list, rank: int, rnd: int) -> list:
    """Eager-wire poisoning hook (the background cycle, before
    dispatch): for each pending entry whose name matches an active
    nan/inf rule for this rank at this negotiation round, set element 0
    of its floating payload to NaN/Inf -- on a copy, on the tensor's own
    device, so the caller's tensor is untouched and the reduction sees
    the poison from this rank."""
    rules = data_rules()
    if not rules:
        return entries
    for entry in entries:
        t = entry.tensor
        if t is None or not t.is_floating_point():
            continue
        for rule in rules:
            if rule.only_rank >= 0 and rule.only_rank != rank:
                continue
            if not fnmatch.fnmatch(entry.name, rule.pattern):
                continue
            if rule.round and rnd < rule.round:
                continue
            if not rule.take():
                continue
            if not t.numel():
                continue
            ready = getattr(entry, "ready", None)
            if t.is_cuda:
                import torch

                stream = torch.cuda.current_stream(t.device)
                if ready is not None:
                    stream.wait_event(ready)
            poisoned = t.clone()
            poisoned.view(-1)[0] = _poison_value(rule.kind)
            entry.tensor = poisoned
            if t.is_cuda:
                # the executor's stream waits on the entry's event: it
                # must now cover the copy
                entry.ready = torch.cuda.Event()
                entry.ready.record(stream)
            _log.warning(
                f"[fault] {rule.kind}-poisoning payload "
                f"{entry.name!r} at round {rnd}", rank=rank)
            break
    return entries


def traced_poison(leaf, name: str, rank_index):
    """In-trace poisoning hook (the DistributedOptimizer health tap):
    returns ``leaf``, or a copy of it with element 0 set to NaN/Inf when
    a ROUND-LESS nan/inf rule matches ``name`` (``grads.<dtype>``) and
    its rank scope is ``rank_index`` (this rank's index over the
    reduction's axis).  Round-scoped rules never apply here: no
    negotiation round exists inside a step."""
    rules = [r for r in data_rules()
             if not r.round and fnmatch.fnmatch(name, r.pattern)
             and (r.only_rank < 0 or r.only_rank == rank_index)]
    if not rules or not leaf.numel():
        return leaf
    out = leaf.clone()  # keeps the layout (channels-last stays so)
    for rule in rules:
        out[(0,) * out.dim()] = _poison_value(rule.kind)
    return out
