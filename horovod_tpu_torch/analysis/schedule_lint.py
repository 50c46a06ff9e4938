"""Structural checker over recorded schedules (the port's counterpart of
``horovod_tpu/analysis/hlo_lint.py``, rule family ``SCHED-*``).

The port has no HLO; what HLO stood for is the stream of operations a
rank runs, with shapes, dtypes and groups.  :func:`record` captures that
stream for the calling thread as a :class:`Program` of
:class:`Record` s:

* every aten op with its result shapes (a ``TorchDispatchMode``);
* every ``c10d`` op with its process group's global ranks;
* every transfer of the data plane's hops
  (:class:`horovod_tpu_torch.parallel.mesh.Hop` and the emulated hop of
  :mod:`horovod_tpu_torch.parallel.emulated`) with the hop's ranks: a
  hop's transfer is seen whether or not it issues a ``c10d`` op;
* one record per hand-kernel launch (``hvd.<module>.<kind>``), where the
  wrapper counts it in ``LAUNCHES`` (pybind calls pass no dispatcher).

The last two arrive through the data plane's own hooks
(:mod:`horovod_tpu_torch.common.events`): :func:`record` opens its
program there as the receiver, and the data plane knows nothing of
this module.

The rules are the reference's, with its parameters and factory names;
a rule id is ``SCHED-`` plus the reference's ``HLO-`` suffix.  Shapes
use the reference's dtype names (``f32``, ``s8``, ...), so the rules
read the same.  Library surface::

    from horovod_tpu_torch.analysis import schedule_lint as SL
    with SL.record(local_size=4) as prog:
        opt.step()
    assert SL.check_program(prog, SL.zero2_rules(padded=384, k=4)) == []

What the recorder cannot see: a hop transfer or a kernel launch made on
a thread the recording thread did not hand its dispatch mode to (the
hooks find the program through the calling thread, or through the mode
autograd carries to its device threads), and aten ops dispatched from
inside a ``c10d`` op's own implementation.  The collective rules read
the hop records when the program has any (every data-plane transfer
passes a hop; a hop's own ``c10d`` op would count twice), else the
``c10d`` records.  When no recorder is open anywhere in the process,
a hook costs its byte or launch count plus one read of a module
global.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
from dataclasses import dataclass, field
from typing import Callable, Iterable

from horovod_tpu_torch.analysis.findings import Finding
from horovod_tpu_torch.common import events as _events

# Opcodes that move bytes between ranks (the reference's, plus the
# broadcast a hop issues).
COLLECTIVE_OPCODES = ("all-reduce", "reduce-scatter", "all-gather",
                      "all-to-all", "collective-permute", "broadcast")

# Wire dtypes that carry lossy-codec payloads: packed int8/int4 bodies
# and the top-k int32 index sidecar.  These must ride ONLY the cross
# hop under hierarchical mode.  fp16/bf16 CASTS are deliberately
# excluded: the cast modes run every hop at wire width by design.
LOSSY_DTYPES = frozenset({"s8", "u8", "s4", "u4", "s32", "u32"})

#: torch dtype names -> the reference's short names (others keep
#: torch's).
DTYPE_NAMES = {
    "float64": "f64", "float32": "f32", "float16": "f16", "bfloat16": "bf16",
    "int64": "s64", "int32": "s32", "int16": "s16", "int8": "s8",
    "uint8": "u8", "bool": "pred",
}

#: ``c10d`` op packets of the transfers the port issues -> opcodes (the
#: names of torch 2.11 and 2.13); any other packet records as
#: ``c10d.<packet>``.
C10D_OPCODES = {
    "allreduce_": "all-reduce",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "broadcast_": "broadcast",
    "send": "send", "recv_": "recv",
}


# ---------------------------------------------------------------------------
# The program model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Shape:
    dtype: str                    # "f32", "s8", "pred", ...
    dims: tuple                   # () for scalars

    @property
    def elems(self) -> int:
        return int(math.prod(self.dims)) if self.dims else 1


@dataclass(frozen=True)
class Record:
    name: str                     # "<opcode or op>.<index>"
    opcode: str                   # an aten/c10d op, a collective, a kernel
    shapes: tuple = ()            # result Shape(s)
    ranks: tuple = ()             # a transfer's member ranks (global)
    pairs: tuple = ()             # a permute's (source, target) ranks
    via: str = ""                 # aten | c10d | hop | kernel | parameter
    line: int = 0                 # position in the program

    def to_dict(self) -> dict:
        return {"name": self.name, "opcode": self.opcode,
                "shapes": [[s.dtype, list(s.dims)] for s in self.shapes],
                "ranks": list(self.ranks),
                "pairs": [list(p) for p in self.pairs], "via": self.via}

    @staticmethod
    def from_dict(d: dict, line: int = 0) -> "Record":
        return Record(name=d["name"], opcode=d["opcode"],
                      shapes=tuple(Shape(t, tuple(dims))
                                   for t, dims in d.get("shapes", ())),
                      ranks=tuple(d.get("ranks", ())),
                      pairs=tuple(tuple(p) for p in d.get("pairs", ())),
                      via=d.get("via", ""), line=line)


@dataclass
class Program:
    records: list = field(default_factory=list)
    local_size: int = 0
    label: str = ""

    def by_opcode(self, opcode: str) -> list:
        return [r for r in self.transfers() if r.opcode == opcode] \
            if opcode in COLLECTIVE_OPCODES else \
            [r for r in self.records if r.opcode == opcode]

    def transfers(self) -> list:
        """Hop records when the program has any, else c10d records."""
        hop = [r for r in self.records if r.via == "hop"]
        return hop if hop else [r for r in self.records if r.via != "hop"]

    def collectives(self) -> list:
        return [r for r in self.transfers()
                if r.opcode in COLLECTIVE_OPCODES]

    def kernels(self, prefix: str = "hvd.") -> list:
        return [r for r in self.records
                if r.via == "kernel" and r.opcode.startswith(prefix)]

    def add(self, opcode: str, shapes=(), ranks=(), pairs=(),
            via: str = "", name: str = "") -> Record:
        rec = Record(name=f"{name or opcode}.{len(self.records)}",
                     opcode=opcode,
                     shapes=tuple(shapes), ranks=tuple(ranks),
                     pairs=tuple(pairs), via=via, line=len(self.records))
        self.records.append(rec)
        return rec

    def on_transfer(self, ranks, opcode: str, out, pairs) -> None:
        """A hop's transfer, as :mod:`horovod_tpu_torch.common.events`
        reports it (``pairs`` as the hop's member indices)."""
        ranks = tuple(ranks)
        gpairs = tuple((ranks[s], ranks[d]) for s, d in pairs) \
            if pairs else ()
        self.add(opcode, [shape_of(out)] if out is not None else [],
                 ranks, gpairs, via="hop")

    def on_launch(self, module: str, kind: str, n: int) -> None:
        """``n`` launches of the hand kernel ``hvd.<module>.<kind>``."""
        for _ in range(n):
            self.add(f"hvd.{module}.{kind}", via="kernel")

    def add_input(self, t) -> Record:
        """Mark a tensor handed to the program (the reference's entry
        parameter): its shape is exempt from :func:`no_full_buffer`."""
        return self.add("parameter", [shape_of(t)], via="parameter")

    def to_json(self) -> str:
        return json.dumps({"local_size": self.local_size,
                           "label": self.label,
                           "records": [r.to_dict() for r in self.records]})

    @staticmethod
    def from_json(text: str) -> "Program":
        d = json.loads(text)
        return Program([Record.from_dict(r, i)
                        for i, r in enumerate(d.get("records", ()))],
                       int(d.get("local_size", 0)), d.get("label", ""))


def dtype_name(dtype) -> str:
    name = str(dtype).removeprefix("torch.")
    return DTYPE_NAMES.get(name, name)


def shape_of(t) -> Shape:
    return Shape(dtype_name(t.dtype), tuple(int(d) for d in t.shape))


def group_axis_kind(groups: Iterable, local_size: int) -> str:
    """Classify a transfer's member ranks on a (cross, local) layout
    with ``local_size`` ranks per local block (cross major, local
    minor); ``groups`` is one tuple of ranks per group (a recorded
    transfer has its own group only).

    * every group a consecutive run inside one local block -> "local";
    * every group strided across blocks (one member per block) ->
      "cross";
    * one group spanning more than one local block, consecutively ->
      "world";
    * anything else -> "mixed".
    """
    groups = [tuple(g) for g in groups]
    if not groups:
        return "world"
    sizes = {len(g) for g in groups}
    total = sum(len(g) for g in groups)
    if len(groups) == 1 and len(groups[0]) == total and total > local_size:
        return "world"

    def is_local(g):
        return (g == tuple(range(g[0], g[0] + len(g)))
                and g[0] // local_size == g[-1] // local_size)

    def is_cross(g):
        strides = {b - a for a, b in zip(g, g[1:])}
        return strides == {local_size} if len(g) > 1 else False

    if sizes and all(is_local(g) for g in groups):
        return "local"
    if sizes and all(is_cross(g) for g in groups):
        return "cross"
    return "mixed"


def permute_axis_kind(pairs: Iterable, local_size: int) -> str:
    """Classify permute (source, target) pairs the same way: every hop
    inside one local block -> "local"; every hop between blocks ->
    "cross"; else "mixed"."""
    pairs = [tuple(p) for p in pairs]
    if not pairs:
        return "mixed"
    kinds = {"local" if s // local_size == t // local_size else "cross"
             for s, t in pairs}
    return kinds.pop() if len(kinds) == 1 else "mixed"


def _axis_kind(rec: Record, local_size: int) -> str:
    if rec.opcode == "collective-permute":
        return permute_axis_kind(rec.pairs, local_size)
    return group_axis_kind([rec.ranks] if rec.ranks else [], local_size)


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------

_mode_cls = None


def _carried_program() -> "Program | None":
    """The program of a recording mode autograd carried to this thread
    (a thread with no recorder of its own)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in reversed(_get_current_dispatch_mode_stack()):
        if type(mode) is _mode_cls:
            return mode.program
    return None


def _group_ranks(args) -> tuple:
    """The global ranks of the process group among a ``c10d`` op's
    arguments (the dispatcher hands it over as a boxed ScriptObject)."""
    import torch
    import torch.distributed as dist

    for a in args:
        pg = a if isinstance(a, dist.ProcessGroup) else None
        if pg is None and isinstance(a, torch.ScriptObject) and \
                a._type().qualified_name().endswith(".ProcessGroup"):
            pg = dist.ProcessGroup.unbox(a)
        if pg is not None:
            try:
                return tuple(dist.get_process_group_ranks(pg))
            except (ValueError, RuntimeError, KeyError):
                return ()
    return ()


def _tensors(x) -> list:
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


def _note_op(prog: Program, func, args, out) -> None:
    ns = getattr(func, "namespace", "")
    packet = func._overloadpacket.__name__ if hasattr(
        func, "_overloadpacket") else str(func)
    if ns == "c10d":
        first = next((a for a in args if _tensors(a)), None)
        prog.add(C10D_OPCODES.get(packet, f"c10d.{packet}"),
                 [shape_of(t) for t in _tensors(first)][:1],
                 _group_ranks(args), via="c10d", name=f"c10d.{packet}")
    else:
        prog.add(f"{ns}.{packet}", [shape_of(t) for t in _tensors(out)],
                 via="aten")


def _mode_class():
    global _mode_cls
    if _mode_cls is None:
        from torch.utils._python_dispatch import TorchDispatchMode

        class _RecordMode(TorchDispatchMode):
            def __init__(self, program):
                super().__init__()
                self.program = program

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                _note_op(self.program, func, args, out)
                return out

        _mode_cls = _RecordMode
    return _mode_cls


@contextlib.contextmanager
def record(local_size: int = 0, label: str = "", inputs=()):
    """Record the calling thread's schedule into a :class:`Program`
    (yielded); ``inputs`` are the tensors handed to the program."""
    prog = Program([], int(local_size), label)
    for t in inputs:
        prog.add_input(t)
    with _events.listening(prog, carried=_carried_program):
        with _mode_class()(prog):
            yield prog


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Rule:
    id: str
    check: Callable            # Program -> list[Finding]
    describe: str = ""

    def __call__(self, prog: Program) -> list:
        return self.check(prog)


def _finding(rule_id: str, msg: str, hint: str = "",
             label: str = "") -> Finding:
    return Finding(rule=rule_id, severity="error",
                   location=f"program:{label or 'schedule'}",
                   message=msg, fix_hint=hint, pass_name="schedule")


def no_full_buffer(elems: int, dtype: str = "f32",
                   label: str = "schedule") -> Rule:
    """SCHED-FULLBUF: no record materializes the full-size fused buffer
    — ``elems`` elements of ``dtype`` in ANY rank/shape.  The program's
    inputs are exempt (the reference's entry parameters)."""
    rid = "SCHED-FULLBUF"

    def check(prog: Program) -> list:
        out = []
        for rec in prog.records:
            if rec.via == "parameter":
                continue
            for s in rec.shapes:
                if s.dtype == dtype and s.elems == elems and s.dims:
                    out.append(_finding(
                        rid,
                        f"{rec.name} ({rec.opcode}, line {rec.line}) "
                        f"materializes a full-size {dtype}[{elems}] "
                        f"buffer as {dtype}{list(s.dims)} — the "
                        "shard-residency contract says it must never "
                        "exist",
                        "assemble/consume the buffer bucket-wise "
                        "(collectives.leaf_from_buckets)", label))
        return out

    return Rule(rid, check, f"no {dtype}[{elems}] anywhere")


def min_collectives(opcode: str, k: int, label: str = "schedule",
                    dtype: str | None = None) -> Rule:
    """SCHED-BUCKETS: at least ``k`` ``opcode`` transfers (the bucketed
    pipeline really decomposed)."""
    rid = "SCHED-BUCKETS"

    def check(prog: Program) -> list:
        got = [r for r in prog.by_opcode(opcode)
               if dtype is None or any(s.dtype == dtype for s in r.shapes)]
        if len(got) < k:
            return [_finding(
                rid,
                f"expected >= {k} {opcode} ops"
                + (f" ({dtype})" if dtype else "")
                + f", found {len(got)} — the bucket pipeline "
                "collapsed into a monolithic schedule",
                "check the bucket loop (HOROVOD_ZERO_PREFETCH_CHUNKS / "
                "HOROVOD_OVERLAP_CHUNKS)", label)]
        return []

    return Rule(rid, check, f">= {k} {opcode}")


def no_collective(opcode: str, label: str = "schedule",
                  dtype: str | None = None) -> Rule:
    """SCHED-MONOLITHIC: zero ``opcode`` transfers (e.g. the overlap
    schedule must contain no full-buffer all-reduce)."""
    rid = "SCHED-MONOLITHIC"

    def check(prog: Program) -> list:
        out = []
        for rec in prog.by_opcode(opcode):
            if dtype is not None and not any(s.dtype == dtype
                                             for s in rec.shapes):
                continue
            out.append(_finding(
                rid,
                f"{rec.name} (line {rec.line}) is a {opcode}"
                + (f" ({dtype})" if dtype else "")
                + " — this program must not contain one",
                "the bucket schedule failed to replace the monolithic "
                "collective", label))
        return out

    return Rule(rid, check, f"zero {opcode}")


def lossy_cross_only(local_size: int, label: str = "schedule",
                     lossy: frozenset = LOSSY_DTYPES) -> Rule:
    """SCHED-LOSSY-PLACEMENT: under hierarchical mode every lossy-codec
    payload (packed int8/int4, top-k index sidecar) rides ONLY the
    cross hop."""
    rid = "SCHED-LOSSY-PLACEMENT"

    def check(prog: Program) -> list:
        out = []
        for rec in prog.collectives():
            kind = _axis_kind(rec, local_size)
            dtypes = {s.dtype for s in rec.shapes}
            if dtypes & lossy and kind != "cross":
                out.append(_finding(
                    rid,
                    f"{rec.name} (line {rec.line}): lossy payload "
                    f"{sorted(dtypes & lossy)} rides the {kind} axis — "
                    "compressed bytes must cross only the cross hop",
                    "route the lossy codec through the cross hop "
                    "(ops/collectives.py two-level path)", label))
        return out

    return Rule(rid, check, "lossy payloads cross-axis only")


def no_cross_collectives(local_size: int, label: str = "schedule") -> Rule:
    """SCHED-LOCALSGD-INNER: every transfer rides the local hop only —
    the local-SGD inner step must be provably cross-silent."""
    rid = "SCHED-LOCALSGD-INNER"

    def check(prog: Program) -> list:
        out = []
        for rec in prog.collectives():
            kind = _axis_kind(rec, local_size)
            if kind != "local":
                out.append(_finding(
                    rid,
                    f"{rec.name} ({rec.opcode}, line {rec.line}) rides "
                    f"the {kind} axis — a local-SGD inner step must "
                    "contain zero cross-slice collectives",
                    "scope the reduction to the local hop (hvd.LocalSGD "
                    "inner update, docs/local-sgd.md) and keep the outer "
                    "sync a separate program", label))
        return out

    return Rule(rid, check, "zero cross-slice collectives")


def has_cross_collective(local_size: int, k: int = 1,
                         label: str = "schedule") -> Rule:
    """SCHED-LOCALSGD-OUTER: >= ``k`` cross-hop transfers — the outer
    sync's positive control."""
    rid = "SCHED-LOCALSGD-OUTER"

    def check(prog: Program) -> list:
        n = sum(1 for rec in prog.collectives()
                if _axis_kind(rec, local_size) == "cross")
        if n < k:
            return [_finding(
                rid,
                f"expected >= {k} cross-axis collective(s) in the "
                f"outer-sync program, found {n} — the pseudo-gradient "
                "exchange is missing",
                "the outer sync must reduce the pseudo-gradients over "
                "the cross hop (docs/local-sgd.md)", label)]
        return []

    return Rule(rid, check, f">= {k} cross-axis collective(s)")


def dp_subgroups(world: int, label: str = "schedule") -> Rule:
    """SCHED-MESH-PLACEMENT: on a multi-axis data mesh every transfer
    rides a PROPER subgroup of the ``world`` ranks (the dp islands); a
    group of every rank, or a transfer with no recorded group, means
    the reduction averaged across the model-parallel axes."""
    rid = "SCHED-MESH-PLACEMENT"

    def check(prog: Program) -> list:
        out = []
        for rec in prog.collectives():
            if rec.opcode == "collective-permute":
                continue          # pairwise by construction
            if not rec.ranks:
                out.append(_finding(
                    rid,
                    f"{rec.name} ({rec.opcode}, line {rec.line}) has no "
                    "group — the implicit all-ranks group spans the "
                    f"whole {world}-rank world instead of the dp islands",
                    "bind the collective to the dp axis of the named "
                    "mesh (parallel/mesh.py resolve_axis)", label))
            elif len(rec.ranks) >= world:
                out.append(_finding(
                    rid,
                    f"{rec.name} ({rec.opcode}, line {rec.line}) group "
                    f"of size {len(rec.ranks)} spans the whole "
                    f"{world}-rank world — on a multi-axis mesh it must "
                    "be a proper dp subgroup",
                    "bind the collective to the dp axis of the named "
                    "mesh (parallel/mesh.py resolve_axis)", label))
        return out

    return Rule(rid, check, f"proper dp subgroups of {world}")


def single_fused_kernel(kernels: int = 1, label: str = "schedule",
                        targets: tuple = ("hvd.fused_update.",)) -> Rule:
    """SCHED-FUSED-TAIL: the fused optimizer tail ran as exactly
    ``kernels`` launches of the hand kernel (one per dtype group) —
    zero means the fusion fell open, more means the tail split into a
    chain.  Only meaningful on the card (on the CPU the wrappers run
    their plain versions by contract)."""
    rid = "SCHED-FUSED-TAIL"

    def check(prog: Program) -> list:
        calls = [r for r in prog.records if r.via == "kernel"
                 and any(r.opcode.startswith(t) for t in targets)]
        if len(calls) != kernels:
            return [_finding(
                rid,
                f"expected exactly {kernels} fused-update kernel "
                f"launch(es), found {len(calls)}",
                "HOROVOD_FUSED_UPDATE fell open (0) or the tail "
                "unfused into a chain (> expected)", label)]
        return []

    return Rule(rid, check, f"exactly {kernels} fused kernel(s)")


# Named rule sets (parameters stay explicit at the call site).


def zero2_rules(padded: int, k: int, label: str = "zero2") -> list:
    """Stage-2 residency: no full-size fused gradient buffer, >= k
    bucket reduce-scatters AND >= k bucket all-gathers."""
    return [no_full_buffer(padded, label=label),
            min_collectives("reduce-scatter", k, label=label),
            min_collectives("all-gather", k, label=label)]


def zero3_rules(padded: int, k: int, label: str = "zero3") -> list:
    """Stage-3 residency: >= k bucket all-gathers, never the full-size
    fused parameter buffer."""
    return [no_full_buffer(padded, label=label),
            min_collectives("all-gather", k, label=label)]


def overlap_rules(k: int, label: str = "overlap") -> list:
    """Overlap schedule: >= k bucket reduce-scatters and >= k bucket
    all-gathers, zero monolithic all-reduce.  (The reference counts
    ``collective-permute`` ring stages; the port's overlap engine runs
    each bucket as one reduce-scatter and one all-gather.)"""
    return [min_collectives("reduce-scatter", k, label=label),
            min_collectives("all-gather", k, label=label),
            no_collective("all-reduce", label=label)]


def hierarchical_lossy_rules(local_size: int, label: str = "hier") -> list:
    return [lossy_cross_only(local_size, label=label)]


def mesh_placement_rules(world: int, label: str = "mesh") -> list:
    """Multi-axis mesh placement: every gradient collective confined to
    proper dp subgroups of the ``world`` ranks."""
    return [dp_subgroups(world, label=label)]


def local_sgd_inner_rules(local_size: int,
                          label: str = "localsgd-inner") -> list:
    """Local-SGD inner step: every transfer local-hop only."""
    return [no_cross_collectives(local_size, label=label)]


def local_sgd_outer_rules(local_size: int, k: int = 1,
                          label: str = "localsgd-outer") -> list:
    """Local-SGD outer sync: >= k cross-hop pseudo-gradient transfers,
    and any lossy payload confined to the cross hop."""
    return [has_cross_collective(local_size, k, label=label),
            lossy_cross_only(local_size, label=label)]


def check_program(program: Program, rules: Iterable) -> list:
    """Evaluate ``rules`` against ``program``, returning findings
    (empty == compliant)."""
    out = []
    for rule in rules:
        out.extend(rule(program))
    return out


# ---------------------------------------------------------------------------
# Fixture-file directives
# ---------------------------------------------------------------------------

_DIRECTIVE_RE = re.compile(r"hvd-lint:\s*(\w+)\(([^)]*)\)")

_DIRECTIVES = {
    "no_full_buffer": lambda a: no_full_buffer(int(a[0]),
                                               *(a[1:] or ["f32"])),
    "min_collectives": lambda a: min_collectives(a[0], int(a[1])),
    "no_collective": lambda a: no_collective(*a),
    "lossy_cross_only": lambda a: lossy_cross_only(int(a[0])),
    "single_fused_kernel": lambda a: single_fused_kernel(
        int(a[0]) if a else 1),
    "dp_subgroups": lambda a: dp_subgroups(int(a[0])),
    "no_cross_collectives": lambda a: no_cross_collectives(int(a[0])),
    "has_cross_collective": lambda a: has_cross_collective(
        int(a[0]), int(a[1]) if len(a) > 1 else 1),
}


def rules_from_directives(lines: Iterable, where: str) -> list:
    """The rules named by ``hvd-lint: rule(arg, ...)`` directives."""
    rules = []
    for line in lines:
        for name, argtext in _DIRECTIVE_RE.findall(line):
            if name not in _DIRECTIVES:
                raise ValueError(f"{where}: unknown lint directive {name!r}")
            args = [a.strip() for a in argtext.split(",") if a.strip()]
            rules.append(_DIRECTIVES[name](args))
    if not rules:
        raise ValueError(
            f"{where}: no 'hvd-lint: rule(...)' directives — a fixture "
            "without rules would pass vacuously")
    return rules


def check_file(path: str) -> list:
    """Lint a recorded program saved as JSON (:meth:`Program.to_json`)
    that declares its own rules in a ``"directives"`` list of
    ``"hvd-lint: rule(arg, ...)"`` strings."""
    with open(path) as f:
        text = f.read()
    doc = json.loads(text)
    rules = rules_from_directives(doc.get("directives", ()), path)
    findings = check_program(Program.from_json(text), rules)
    return [Finding(rule=f.rule, severity=f.severity,
                    location=f"{path}:{f.location}", message=f.message,
                    fix_hint=f.fix_hint, pass_name="schedule")
            for f in findings]
