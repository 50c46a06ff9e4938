"""The program set the ``schedule`` pass lints (counterpart of
``horovod_tpu/analysis/programs.py``).

Runs the representative data-plane programs over eight emulated ranks
(:class:`horovod_tpu_torch.parallel.emulated.EmulatedWorld`, threads of
one process on one device: the counterpart of the reference's eight
virtual CPU devices), with the reference's parameters — 4 leaves x 96
(384 padded), world 8 as (cross 2, local 4) — records every rank's
schedule (each rank thread opens its own recorder: dispatch modes are
per thread) and evaluates the schedule_lint presets on each:

* ZeRO-2 update        — no full fused gradient buffer, bucketed RS/AG
* ZeRO-3 forward       — bucketed parameter gathers, no full buffer
* overlap schedule     — >= K bucket RS/AG, zero all-reduce
* hierarchical int8    — lossy payload on the cross hop only
* hierarchical top-k   — sparse payload on the cross hop only
* dp mesh (dp:4,tp:2)  — stages 0 and 2 on proper dp subgroups

Every preset also runs a POSITIVE CONTROL: the stage-1 update (which
carries the full buffer), the overlap-off update (monolithic by
contract), a flat lossy sum and the flat-world update must be FLAGGED;
a checker that stops seeing violations fails its own pass
(``SCHED-SELFCHECK``) instead of passing vacuously.

``run(device=None)`` runs on the card unless the caller asks for the
CPU (``device="cpu"``).
"""

from __future__ import annotations

import contextlib
import os

from horovod_tpu_torch.analysis import schedule_lint as SL
from horovod_tpu_torch.analysis.findings import Finding

_LEAVES, _LEAF = 4, 96
_PADDED = _LEAVES * _LEAF
_N, _LOCAL = 8, 4      # world 8 as (cross 2, local 4), cross major
_TP = 2               # the dp:4,tp:2 mesh, tp minor
_QBUF = 1024          # the hierarchical programs' buffer, per rank


def _selfcheck(label: str, violated: list) -> list:
    if violated:
        return []
    return [Finding(
        rule="SCHED-SELFCHECK", severity="error",
        location=f"program:{label}",
        message=f"positive control '{label}' produced zero findings — "
                "the checker can no longer see the violation class it "
                "exists to catch",
        fix_hint="the recorder or a rule drifted from what the port "
                 "runs; fix schedule_lint before trusting any green "
                 "result",
        pass_name="schedule")]


def check_ranks(progs: list, rules: list) -> list:
    """``rules`` over every rank's program; each finding once."""
    out: list = []
    for prog in progs:
        for f in SL.check_program(prog, rules):
            if f not in out:
                out.append(f)
    return out


@contextlib.contextmanager
def _knob_env(env: dict):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def device_of(device=None):
    """The device the program set runs on: the card unless ``device``
    names another."""
    import torch

    from horovod_tpu_torch.common.types import HorovodTpuError

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise HorovodTpuError(
            "the schedule pass runs on the card by default and none is "
            "visible; pass device='cpu' (CLI: --device cpu) to run it on "
            "the CPU")
    return dev


def record_world(dev, make, label: str) -> list:
    """Every emulated rank's recorded program: ``make(world, r)``
    prepares rank ``r``'s inputs and returns ``(thunk, inputs)``; the
    recorder is open around ``thunk()`` only."""
    import torch

    from horovod_tpu_torch.parallel.emulated import EmulatedWorld

    world = EmulatedWorld(torch, _N, sync=dev.type == "cuda")

    def body(r):
        thunk, inputs = make(world, r)
        with SL.record(_LOCAL, label, inputs) as prog:
            thunk()
        return prog

    return world.run(body)


def _opt_program(dev, stage: int, overlap: bool, axis):
    """The DistributedOptimizer update of 4 leaves x 96 over ``axis(world,
    r)`` (the reference's ``opt_hlo``)."""
    import torch

    from horovod_tpu_torch.optim.distributed import DistributedOptimizer

    def make(world, r):
        ps = [torch.nn.Parameter(torch.full((_LEAF,), float(i + 1),
                                            device=dev))
              for i in range(_LEAVES)]
        opt = DistributedOptimizer(torch.optim.SGD(ps, lr=0.1),
                                   zero_stage=stage, overlap=overlap,
                                   axis_name=axis(world, r))
        for p in ps:
            p.grad = p.detach() * (r + 1)
        return opt.step, [p.grad for p in ps]

    return make


def _zero3_program(dev):
    """The stage-3 forward: the shards gathered bucket-wise into every
    leaf, and a sum over them."""
    import torch

    from horovod_tpu_torch.optim.distributed import (zero3_full_params,
                                                     zero3_shard_params)

    def make(world, r):
        params = {f"l{i}": torch.ones(_LEAF, device=dev)
                  for i in range(_LEAVES)}
        zp = zero3_shard_params(params, axis_name=world.flat(r))

        def fwd():
            with torch.no_grad():
                full = zero3_full_params(zp)
                return sum(leaf.sum() for leaf in full.values())

        return fwd, list(zp.shards)

    return make


def _lossy_program(dev, mode: str, pair: bool):
    """A two-level lossy sum over the (cross, local) pair, or (the
    control) a flat one over the whole world."""
    import torch

    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import quantization as Q

    def make(world, r):
        gen = torch.Generator().manual_seed(r)
        x = torch.randn(_QBUF, generator=gen).to(dev)
        if pair:
            thunk = (lambda: C.quantized_allreduce(
                x, op=C.Sum, mode=mode, axis_name=world.pair(r, _LOCAL)))
        else:
            thunk = (lambda: Q.lossy_psum(x, mode, 256,
                                          axis_name=world.flat(r)))
        return thunk, [x]

    return make


def run(device=None, programs: dict | None = None) -> list:
    """Record and lint the program set; returns the findings (empty:
    every preset clean and every control flagged).  ``programs``, when
    given, receives each label's per-rank :class:`~.schedule_lint.
    Program` list."""
    from horovod_tpu_torch.common import config as _config

    dev = device_of(device)
    k = max(1, int(_config.get("zero_prefetch_chunks")))
    ok = max(1, int(_config.get("overlap_chunks")))
    out = programs if programs is not None else {}
    findings: list = []

    def rec(label, make):
        out[label] = record_world(dev, make, label)
        return out[label]

    def flat(world, r):
        return world.flat(r)

    def dp(world, r):
        return world.hop(r, range(r % _TP, _N, _TP), "dp")

    # -- ZeRO-2 residency ------------------------------------------------
    findings += check_ranks(
        rec("zero2-update", _opt_program(dev, 2, False, flat)),
        SL.zero2_rules(_PADDED, k, label="zero2-update"))
    findings += _selfcheck(
        "zero1-full-buffer-control",
        check_ranks(rec("zero1-control", _opt_program(dev, 1, False, flat)),
                    [SL.no_full_buffer(_PADDED, label="zero1-control")]))

    # -- ZeRO-3 residency ------------------------------------------------
    findings += check_ranks(
        rec("zero3-forward", _zero3_program(dev)),
        SL.zero3_rules(_PADDED, k, label="zero3-forward"))

    # -- overlap schedule ------------------------------------------------
    findings += check_ranks(
        rec("overlap", _opt_program(dev, 0, True, flat)),
        SL.overlap_rules(ok, label="overlap"))
    hoff = rec("overlap-off", _opt_program(dev, 0, False, flat))
    findings += _selfcheck(
        "overlap-off-monolithic-control",
        check_ranks(hoff, [SL.no_collective("all-reduce",
                                            label="overlap-control")]))

    # -- hierarchical lossy placement ------------------------------------
    with _knob_env({"HOROVOD_HIERARCHICAL_ALLREDUCE": "1"}):
        for mode in ("int8", "topk"):
            findings += check_ranks(
                rec(f"hier-{mode}", _lossy_program(dev, mode, True)),
                SL.hierarchical_lossy_rules(_LOCAL, label=f"hier-{mode}"))
    # positive control: a flat (whole-world) int8 sum must be flagged
    findings += _selfcheck(
        "flat-lossy-placement-control",
        check_ranks(rec("flat-lossy", _lossy_program(dev, "int8", False)),
                    [SL.lossy_cross_only(_LOCAL,
                                         label="placement-control")]))

    # -- mesh-native dp placement ----------------------------------------
    # On a dp:4,tp:2 mesh (dp major, tp minor) every gradient transfer
    # rides a dp island ({0,2,4,6} or {1,3,5,7}), never the whole world.
    for stage in (0, 2):
        findings += check_ranks(
            rec(f"mesh-dp-z{stage}", _opt_program(dev, stage, False, dp)),
            SL.mesh_placement_rules(_N, label=f"mesh-dp-z{stage}"))
    # positive control: the flat-world monolithic update spans all 8
    # ranks, so the dp-subgroup rule must flag it
    findings += _selfcheck(
        "flat-world-placement-control",
        check_ranks(hoff, [SL.dp_subgroups(
            _N, label="mesh-placement-control")]))
    return findings
