"""Worker of ``tests/test_torch_analysis.py`` and
``tests/test_torch_cuda.py::test_four_cards_schedule_lint``: one rank of
a real ``torch.distributed`` world (gloo on the CPU, NCCL on cards)
recording its own schedules with ``analysis.schedule_lint.record``.

Mode ``schedule`` (spawned through ``_torch_collectives_worker``):

* every world: the flat world hop's all-reduce, reduce-scatter and
  all-gather, and an all-reduce over a subgroup built with
  ``torch.distributed.new_group`` (the last rank alone);
* a world of four, as the (cross 2, local 2) pair of
  ``hierarchical_mesh(2)``: ZeRO-2 at k = 4 with its stage-1 control,
  overlap on and off, hierarchical int8 with the flat int8 control, and
  local SGD's inner step and outer sync, each recorded with the lint
  presets' findings, its hop and c10d transfers and its kernel records.

Prints one JSON line: the rank and, per case, ``rules`` (the preset's
findings' rule ids), ``hop`` and ``c10d`` (opcode and ranks of each
transfer, in order) and ``kernels`` (kernel records by opcode).
"""

from __future__ import annotations

import collections
import json
import os

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.analysis import schedule_lint as SL

LEAVES, LEAF, K = 4, 96, 4
LOCAL = 2


def _summary(prog, rules) -> dict:
    return {"rules": sorted({f.rule for f in SL.check_program(prog, rules)}),
            "hop": [[r.opcode, list(r.ranks)] for r in prog.records
                    if r.via == "hop"],
            "c10d": [[r.opcode, list(r.ranks)] for r in prog.records
                     if r.via == "c10d"],
            "kernels": dict(collections.Counter(
                r.opcode for r in prog.kernels()))}


def _opt(dev, r, stage, overlap, axis):
    ps = [torch.nn.Parameter(torch.full((LEAF,), float(i + 1), device=dev))
          for i in range(LEAVES)]
    opt = hvd.DistributedOptimizer(torch.optim.SGD(ps, lr=0.1),
                                   zero_stage=stage, overlap=overlap,
                                   axis_name=axis)
    for p in ps:
        p.grad = p.detach() * (r + 1)
    return opt


def _basic(dev, r, n) -> dict:
    from horovod_tpu_torch.parallel import mesh as M

    hop = M.resolve_hops("hvd")
    sub = torch.distributed.new_group([n - 1])
    x = torch.full((8 * n,), float(r + 1), device=dev)
    out = torch.empty(8, device=dev)
    gat = torch.empty(8 * n, device=dev)
    with SL.record(n) as prog:
        hop.all_reduce(x)
        hop.reduce_scatter(out, x)
        hop.all_gather(gat, out)
        if r == n - 1:
            torch.distributed.all_reduce(out, group=sub)
    return {"hop": [[q.opcode, list(q.ranks)] for q in prog.records
                    if q.via == "hop"],
            "c10d": [[q.opcode, list(q.ranks)] for q in prog.records
                     if q.via == "c10d"],
            "sum": x.tolist()}


def _pair_cases(dev, r, n) -> dict:
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import quantization as Q
    from horovod_tpu_torch.parallel import mesh as M

    pair = M.hierarchical_mesh(LOCAL).pair("cross", "local")
    padded = LEAVES * LEAF
    out, progs = {}, {}

    def rec(label, fn, rules):
        with SL.record(LOCAL, label) as prog:
            fn()
        progs[label] = prog
        out[label] = _summary(prog, rules)

    os.environ["HOROVOD_ZERO_PREFETCH_CHUNKS"] = str(K)
    os.environ["HOROVOD_OVERLAP_CHUNKS"] = str(K)
    zero2 = _opt(dev, r, 2, False, pair.flat)
    rec("zero2", zero2.step, SL.zero2_rules(padded, K))
    zero1 = _opt(dev, r, 1, False, pair.flat)
    rec("zero1-control", zero1.step, [SL.no_full_buffer(padded)])
    ovl = _opt(dev, r, 0, True, pair.flat)
    rec("overlap", ovl.step, SL.overlap_rules(K))
    off = _opt(dev, r, 0, False, pair.flat)
    rec("overlap-off-control", off.step,
        [SL.no_collective("all-reduce"), SL.dp_subgroups(n)])

    gen = torch.Generator().manual_seed(r)
    q = torch.randn(1024, generator=gen).to(dev)
    os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1"
    rec("hier-int8", lambda: C.quantized_allreduce(
        q, op=C.Sum, mode="int8", axis_name=pair),
        SL.hierarchical_lossy_rules(LOCAL))
    os.environ.pop("HOROVOD_HIERARCHICAL_ALLREDUCE")
    rec("flat-int8-control", lambda: Q.lossy_psum(
        q, "int8", 256, axis_name=pair.flat),
        [SL.lossy_cross_only(LOCAL)])

    ps = [torch.nn.Parameter(torch.full((LEAF,), float(i + 1), device=dev))
          for i in range(LEAVES)]
    ls = hvd.LocalSGD(torch.optim.SGD(ps, lr=0.1), h=2, axis_name=pair)
    for p in ps:
        p.grad = p.detach() * (r + 1)
    rec("localsgd-inner", ls.step, SL.local_sgd_inner_rules(LOCAL))
    rec("localsgd-outer", ls.outer_sync, SL.local_sgd_outer_rules(LOCAL))
    # each preset's control: the other program under it
    for label, other, rules in (
            ("localsgd-inner-control", "localsgd-outer",
             SL.local_sgd_inner_rules(LOCAL)),
            ("localsgd-outer-control", "localsgd-inner",
             SL.local_sgd_outer_rules(LOCAL))):
        out[label] = {"rules": sorted({
            f.rule for f in SL.check_program(progs[other], rules)})}
    return out


def schedule_main(device: str):
    hvd.init(device=device)
    dev = hvd.device()
    r, n = hvd.rank(), hvd.size()
    res = {"rank": r, "basic": _basic(dev, r, n)}
    if n == 4:
        res.update(_pair_cases(dev, r, n))
    hvd.shutdown()
    print(json.dumps(res))
