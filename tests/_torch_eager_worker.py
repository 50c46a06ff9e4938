"""One rank of the eager plane's multi-process tests
(``tests/test_torch_eager_multiproc.py``), spawned through
``_torch_collectives_worker.spawn(..., mode="eager")``: a gloo world of
4 ranks runs the eager ops, the lossy wire on fused responses and the
frontend's optimizer, re-initializes under ``HOROVOD_MESH=dp:2,tp:2``,
then splits into two worlds of 2 ranks.  Inputs are numpy arrays seeded
by rank (:func:`eager_inputs`), so the parent recomputes every expected
value; the results print as one JSON line.  Mode ``eager_cards``
(:func:`eager_cards_main`) trains ResNet-50 on four cards through the
frontend (``tests/test_torch_cuda.py``)."""

import json
import os

import numpy as np
import torch

import horovod_tpu_torch as hvd
import horovod_tpu_torch.torch as thvd
from horovod_tpu_torch.ops import eager as E
from horovod_tpu_torch.ops import quantization as Q

#: the tensors of the fused lossy responses: float32, one fusion bucket
LOSSY_SHAPES = ((300,), (17, 5), (1000,))
SGD_STEPS = 3


def eager_inputs(rank: int) -> dict:
    rng = np.random.RandomState(300 + rank)
    return {
        "x": rng.standard_normal((5, 3)).astype(np.float32),
        "i": rng.randint(-50, 50, (6,)).astype(np.int32),
        "bf": rng.standard_normal(8).astype(np.float32),
        "rs": rng.standard_normal((9, 5)).astype(np.float32),
        "a2a": rng.standard_normal((8, 3)).astype(np.float32),
        "ada": (np.arange(8) + 1 + rank).astype(np.float32),
        "lossy": [rng.standard_normal(s).astype(np.float32)
                  for s in LOSSY_SHAPES],
        "batch": rng.standard_normal((8, 6)).astype(np.float32),
        "target": rng.standard_normal((8, 2)).astype(np.float32),
    }


def enc(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().tolist()
    if isinstance(v, (list, tuple)):
        return [enc(x) for x in v]
    if isinstance(v, dict):
        return {k: enc(x) for k, x in v.items()}
    return v


def _model():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(6, 4), torch.nn.Tanh(),
                               torch.nn.Linear(4, 2))


def sgd_runs(inp) -> dict:
    """The frontend's hook-driven optimizer and the in-trace one (stage
    0, the same SGD, the none wire), 3 steps each from the same weights
    on this rank's batch: each one's weights after every step."""
    x, y = torch.from_numpy(inp["batch"]), torch.from_numpy(inp["target"])
    out = {}
    for which in ("eager", "intrace"):
        model = _model()
        sgd = torch.optim.SGD(model.parameters(), lr=0.1)
        if which == "eager":
            opt = thvd.DistributedOptimizer(
                sgd, named_parameters=model.named_parameters())
        else:
            opt = hvd.DistributedOptimizer(sgd, zero_stage=0)
        steps = []
        for _ in range(SGD_STEPS):
            opt.zero_grad()
            torch.nn.functional.mse_loss(model(x), y).backward()
            opt.step()
            steps.append([p.detach().clone() for p in model.parameters()])
        out[which] = steps
    return out


def _record(rt) -> list:
    """Every allreduce response the runtime executes: its names and
    outputs."""
    log = []
    dispatch = rt._dispatch

    def rec(resp, entries):
        outs = dispatch(resp, entries)
        if resp.kind == "allreduce":
            log.append((list(resp.names), [o.clone() for o in outs]))
        return outs

    rt._dispatch = rec
    return log


def lossy_case(inp, mode: str, rt, log) -> dict:
    """The three tensors of :data:`LOSSY_SHAPES` submitted together on
    the ``mode`` wire until one response fuses two or more of them
    (every rank sees the same responses, so all decide alike)."""
    os.environ["HOROVOD_COMPRESSION"] = mode
    for attempt in range(10):
        del log[:]
        names = [f"{mode}.{attempt}.{i}" for i in range(len(LOSSY_SHAPES))]
        hs = [hvd.allreduce_async(torch.from_numpy(t), name=n)
              for t, n in zip(inp["lossy"], names)]
        for h in hs:
            hvd.synchronize(h)
        if any(len(n) > 1 for n, _ in log):
            break
    os.environ["HOROVOD_COMPRESSION"] = "none"
    return {"attempt": attempt, "responses": [
        {"names": n, "outs": o} for n, o in log]}


def _split_world(r: int) -> None:
    """Re-initialize as two worlds of 2 ranks: {0, 1} and {2, 3}."""
    import torch.distributed as dist
    from horovod_tpu_torch.common.util import free_port

    ports = torch.tensor([free_port(), free_port()] if r == 0 else [0, 0])
    dist.broadcast(ports, src=0)
    hvd.shutdown()
    os.environ.update({
        "HOROVOD_SIZE": "2", "HOROVOD_RANK": str(r % 2),
        "HOROVOD_LOCAL_SIZE": "2", "HOROVOD_LOCAL_RANK": str(r % 2),
        "HOROVOD_COORDINATOR_ADDR": f"127.0.0.1:{int(ports[r // 2])}"})
    hvd.init(device="cpu")


def eager_main(device: str):
    from _torch_collectives_worker import _reinit_shutdown

    hvd.init(device=device)
    r, n = hvd.rank(), hvd.size()
    inp = eager_inputs(r)
    t = {k: torch.from_numpy(v) for k, v in inp.items() if k != "lossy"}
    out = {"rank": r}
    # the positional second argument is average= (the JAX package's
    # signature): truthy, so Average
    out["positional"] = hvd.allreduce(t["x"], hvd.Sum)
    out["sum"] = hvd.allreduce(t["x"], op=hvd.Sum, name="x.sum")
    out["avg_int"] = hvd.allreduce(t["i"], name="i.avg")
    out["avg_int_dtype"] = str(out["avg_int"].dtype)
    out["bf16"] = hvd.allreduce(t["bf"].to(torch.bfloat16), op=hvd.Sum)
    # out-of-order async submission: negotiation reorders
    if r % 2 == 0:
        ha = hvd.allreduce_async(torch.ones(8), op=hvd.Sum, name="a")
        hb = hvd.allreduce_async(torch.ones(8) * 2, op=hvd.Sum, name="b")
    else:
        hb = hvd.allreduce_async(torch.ones(8) * 2, op=hvd.Sum, name="b")
        ha = hvd.allreduce_async(torch.ones(8), op=hvd.Sum, name="a")
    out["ab"] = [hvd.synchronize(ha), hvd.synchronize(hb)]
    buf = t["x"].clone()
    out["inplace_is_input"] = hvd.allreduce_(buf, op=hvd.Sum) is buf
    out["inplace"] = buf
    out["ragged"] = hvd.allgather(torch.full((r + 1, 3), float(r)))
    out["bcast"] = hvd.broadcast(torch.full((5,), float(r * 10)), 1)
    flags = torch.tensor([r % 2 == 0, True, False])
    out["bcast_bool"] = hvd.broadcast(flags, 1)
    out["object"] = thvd.broadcast_object({"x": 42, "r": r}, 0)
    try:
        hvd.allreduce(torch.ones(4 if r == 0 else 5), name="bad")
        out["mismatch"] = None
    except hvd.HorovodTpuError as e:
        out["mismatch"] = str(e)
    out["after"] = hvd.allreduce(torch.ones(2), op=hvd.Sum, name="after")
    out["rs"] = hvd.reducescatter(t["rs"])
    out["rs_avg"] = hvd.reducescatter(t["rs"], op=hvd.Average, name="rs.avg")
    out["a2a"] = hvd.alltoall(t["a2a"])
    out["adasum"] = hvd.allreduce(t["ada"], op=hvd.Adasum)
    rt = E._runtime()
    log = _record(rt)
    out["int8"] = lossy_case(inp, "int8", rt, log)
    out["int4"] = lossy_case(inp, "int4", rt, log)
    out["sgd4"] = sgd_runs(inp)
    out["fast_rounds"] = rt.controller.fast_rounds
    # join with uneven work: rank 3 reduces twice more, the others join
    extra = []
    if r == n - 1:
        extra = [hvd.allreduce(torch.full((3,), 6.0), op=hvd.Sum,
                               name=f"uneven.{k}") for k in range(2)]
    out["extra"] = extra
    out["join"] = hvd.join()
    _reinit_shutdown()

    os.environ["HOROVOD_MESH"] = "dp:2,tp:2"
    hvd.init(device=device)
    try:
        hvd.allreduce(torch.ones(2))
        out["mesh_refusal"] = None
    except hvd.HorovodTpuError as e:
        out["mesh_refusal"] = str(e)
    del os.environ["HOROVOD_MESH"]
    _split_world(r)
    out["pair_positional"] = hvd.allreduce(t["x"], hvd.Sum)
    out["sgd2"] = sgd_runs(inp)
    hvd.shutdown()
    print(json.dumps({k: enc(v) for k, v in out.items()}))


#: the four-card run: (case, HOROVOD_COMPRESSION); "intrace" is the
#: port's in-trace DistributedOptimizer the eager steps are held against
CARD_CASES = (("intrace", "none"), ("eager none", "none"),
              ("eager int8", "int8"))
CARD_STEPS, CARD_BATCH = 6, 256


def _flat_params(model) -> torch.Tensor:
    return torch.cat([p.detach().float().reshape(-1)
                      for p in model.parameters()])


#: the four-card join check: elements of each of the last rank's sums
JOIN_N, JOIN_EXTRA = 1 << 22, 2


def uneven_join_on_card(r: int, n: int) -> dict:
    """Join with uneven work on the cards: the last rank sums
    ``JOIN_EXTRA`` tensors of 6s more while the others have joined and
    contribute zeros.  A joined rank first frees a block of 7s of the
    zeros' size and queues seconds of matrix products on its default
    stream, so zeros filled off the executor's stream would read as 7s
    (or not yet be written) in the last rank's sums.  Returns the join's
    result and, on the last rank, each sum's largest distance from 6."""
    dev = hvd.device()
    res = {"extra": []}
    if r == n - 1:
        for k in range(JOIN_EXTRA):
            got = hvd.allreduce(torch.full((JOIN_N,), 6.0, device=dev),
                                op=hvd.Sum, name=f"uneven.{k}")
            res["extra"].append(float((got - 6.0).abs().max()))
    else:
        torch.full((JOIN_N,), 7.0, device=dev)
        a = torch.randn(8192, 8192, device=dev)
        busy = [a @ a for _ in range(8)]
        del busy
    res["join"] = hvd.join()
    return res


def eager_cards_main(device: str):
    """ResNet-50 at full width (224 px, batch 256 per card, bf16) trained
    by the frontend's hook-driven ``DistributedOptimizer(torch.optim.SGD(
    0.1, momentum=0.9))`` over NCCL, 6 steps on the none and the int8
    wire, beside the in-trace ``DistributedOptimizer`` (stage 0, the same
    SGD, the none wire); deterministic cuDNN, so only the reductions
    differ.  Per case: losses, a digest of the weights after every step,
    the step-1 weights' relative L2 distance from the in-trace run's,
    step times, rounds, fast rounds and responses per step, B4/B5
    launches per step and the peak memory; then
    :func:`uneven_join_on_card`."""
    import hashlib
    import time

    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    os.environ.pop("HOROVOD_FUSED_UPDATE", None)
    hvd.init(device=device)
    r = hvd.rank()
    images, labels = synthetic_batch(CARD_BATCH, 224, 1000, seed=100 + r)
    out = {"rank": r}
    ref = None
    for case, wire in CARD_CASES:
        os.environ["HOROVOD_COMPRESSION"] = wire
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0)
        sgd = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        if case == "intrace":
            opt = hvd.DistributedOptimizer(sgd, zero_stage=0)
        else:
            opt = thvd.DistributedOptimizer(
                sgd, named_parameters=model.named_parameters())
        rt = None if case == "intrace" else E._runtime()
        res = {"losses": [], "digests": [], "step_s": [], "rounds": [],
               "fast_rounds": [], "responses": [], "explicit": [],
               "launches": []}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for step in range(CARD_STEPS):
            Q.reset_launch_counts()
            before = rt and (rt.rounds, rt.controller.fast_rounds,
                             rt.responses, rt.controller.explicit_requests)
            t0 = time.perf_counter()
            loss = train_step(model, opt, images, labels)
            torch.cuda.synchronize()
            res["step_s"].append(time.perf_counter() - t0)
            res["losses"].append(float(loss))
            flat = _flat_params(model)
            res["digests"].append(hashlib.sha256(
                flat.cpu().numpy().tobytes()).hexdigest())
            if step == 0:
                if case == "intrace":
                    ref = flat
                res["step1_rel_l2"] = float(
                    (flat - ref).norm() / ref.norm())
            res["launches"].append({k: Q.LAUNCHES[k] for k in
                                    ("quantize", "dequantize")})
            if rt is not None:
                after = (rt.rounds, rt.controller.fast_rounds,
                         rt.responses, rt.controller.explicit_requests)
                for key, a, b in zip(("rounds", "fast_rounds", "responses",
                                      "explicit"), after, before):
                    res[key].append(a - b)
        res["median_step_s"] = sorted(res["step_s"][1:])[
            (CARD_STEPS - 1) // 2]
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
        if rt is not None:
            res["round_ms"] = sorted(rt.round_seconds)[
                len(rt.round_seconds) // 2] * 1e3
        out[case] = res
        del model, sgd, opt
        torch.cuda.empty_cache()
    os.environ["HOROVOD_COMPRESSION"] = "none"
    out["join"] = uneven_join_on_card(r, hvd.size())
    hvd.shutdown()
    print(json.dumps(enc(out)))
