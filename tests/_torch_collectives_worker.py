"""One rank of the port's collective tests: runs the collectives on
``sys.argv[1]`` (``cpu`` over gloo, or ``cuda`` over NCCL) and prints its
results as one JSON line.  Inputs are numpy arrays seeded by rank, so the
parent can recompute every expected value; :func:`spawn` starts a world
of such ranks with the launcher's env contract.

``sys.argv[2]`` picks another case set: ``resnet`` trains ResNet-50 at
full width for a few steps with the int8 and then the int4 wire and
error feedback, and prints launch counts, losses, step times and a
digest of the reduced gradient; ``overlap`` runs the bucketed schedules
of ``ops/overlap.py`` (:func:`overlap_main`); ``zero`` the ZeRO stages
(:func:`zero_main`); ``zero_resnet`` ResNet-50 at full width through
stages 0-3 on the card (:func:`zero_resnet_main`); ``sp`` the sequence
parallel attention and the LM at dp x sp (:func:`sp_main`);
``sp_cards`` the LM at full width at sp = 4 and at dp = 2 x sp = 2 on four
cards (:func:`sp_cards_main`), ``sp_cards_ref`` its one-card run
(:func:`sp_cards_ref_main`); ``mp`` the tensor- and expert-parallel
cases (:func:`mp_main`), ``mp_cards`` the bench LM under the
model-parallel meshes on four cards (:func:`mp_cards_main`),
``mp_cards_ref`` its one-card tp = 1 run (:func:`mp_cards_ref_main`);
``pp`` the pipeline cases (:func:`pp_main`), ``pp_cards`` the bench
LM under pipeline parallelism on four cards (:func:`pp_cards_main`),
``pp_cards_ref`` its one-card pp = 1 run (:func:`pp_cards_ref_main`);
``mesh`` the named data mesh and the broadcast and alltoall refusals
(:func:`mesh_main`), ``data_plane`` the hierarchical reductions and Adasum
(:func:`data_plane_main`), ``dp_cards`` ResNet-50 through them on four
cards (:func:`dp_cards_main`); ``local_sgd`` and ``ls_cards`` the
local-SGD cases of ``tests/_torch_local_sgd_worker.py``; ``eager`` and
``eager_cards`` the eager plane's cases of
``tests/_torch_eager_worker.py``; ``eager_training``,
``eager_training_cards`` and ``eager_kill_cards`` the eager regimes of
ZeRO and local SGD and the coordinated abort, and
``observability_cards`` eager stage 2 under ``hvd.trace_step``, of
``tests/_torch_eager_training_worker.py``; ``timeline_ticks``,
``autotune_sync`` and ``tuning_cards`` the timeline's and the
autotuner's, of ``tests/_torch_tuning_worker.py``; ``autopilot_rollback``
the autopilot's rollback, of ``tests/_torch_autopilot_worker.py``;
``perf`` and ``perf_cards`` the perf observatory's sampled captures, of
``tests/_torch_perf_worker.py``; ``schedule`` the schedule recorder over
the world, of ``tests/_torch_analysis_worker.py``.
``HVD_TEST_FEEDBACK`` may name a ``.npy`` file of per-rank residuals
that the lossy optimizer case loads before its second step;
``HVD_TEST_INTEROP`` a pickle, written by ``tests/test_torch_zero.py``,
of the JAX package's stage-1 state that the zero cases carry over
(:func:`interop_case`)."""

import gc
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import interop
from horovod_tpu_torch.ops import quantization as Q
from horovod_tpu_torch.optim import fused_update as TF

WORKER = os.path.abspath(__file__)


def inputs(rank: int):
    rng = np.random.RandomState(100 + rank)
    return {
        "x": rng.standard_normal((5, 3)).astype(np.float32),
        "a": rng.standard_normal(4).astype(np.float32),
        "b": rng.standard_normal((3, 2)).astype(np.float32),
        "c": rng.randint(-50, 50, (5,)).astype(np.int32),
        "d": rng.standard_normal((2, 2)).astype(np.float32),
    }


def lossy_inputs(rank: int, n: int):
    """Per-rank inputs of the lossy-wire cases."""
    rng = np.random.RandomState(200 + rank)
    qm = 127 // n
    # integers with block absmax 127 // n on every rank: the shared scale
    # is exactly 1, so the int8 wire is lossless
    grid = (np.arange(n * 512) % (2 * qm + 1) - qm).astype(np.float32)
    return {
        "v": rng.standard_normal(1000).astype(np.float32),
        "ga": rng.standard_normal((40, 3)).astype(np.float32),
        "gb": rng.standard_normal(17).astype(np.float32),
        "gd": rng.standard_normal(8).astype(np.float32),  # sent as bf16
        "gc": rng.randint(-50, 50, (5,)).astype(np.int32),
        "rs": rng.standard_normal((9, 5)).astype(np.float32),
        "ag": rng.standard_normal((3, 2)).astype(np.float32),
        "a2a": rng.standard_normal((2 * n, 3)).astype(np.float32),
        "opt_g": rng.standard_normal(256).astype(np.float32),
        "grid": grid.reshape(n, 512)[rank],
    }


RS_MODES = ("none", "int8", "int4")


#: what a rank's stderr shows when its store could not bind the port
BIND_FAILURE = ("EADDRINUSE", "address already in use")


class PortTaken(AssertionError):
    """Rank 0's store found the world's port taken."""


def spawn(n: int, device: str = "cpu", timeout: float = 120.0,
          mode: str = "collectives", env_extra=None):
    """Run ``n`` ranks of this script on a fresh port; their results.
    The port is held (``util.reserve_port``) until the ranks exit, so no
    other test's socket takes it before rank 0's store binds it; a world
    whose rank shows a bind failure all the same runs once more, on a
    port picked the plain way."""
    from horovod_tpu_torch.common.util import free_port, reserve_port

    held, port = reserve_port()
    try:
        return _spawn_world(n, device, timeout, mode, env_extra, port)
    except PortTaken:
        pass
    finally:
        held.close()
    return _spawn_world(n, device, timeout, mode, env_extra, free_port())


def _spawn_world(n, device, timeout, mode, env_extra, port):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for r in range(n):
        env = dict(os.environ)
        env.update({
            "HOROVOD_RANK": str(r), "HOROVOD_SIZE": str(n),
            "HOROVOD_LOCAL_RANK": str(r), "HOROVOD_LOCAL_SIZE": str(n),
            "HOROVOD_CROSS_RANK": "0", "HOROVOD_CROSS_SIZE": "1",
            "HOROVOD_COORDINATOR_ADDR": f"127.0.0.1:{port}",
            "PYTHONPATH": repo + os.pathsep + env.get("PYTHONPATH", ""),
        })
        if device == "cpu":
            # torch's intra-op pool would take every core in every rank:
            # under a loaded test run (six workers, each spawning worlds
            # of up to four ranks) a world then starves its peers
            env["OMP_NUM_THREADS"] = "1"
        env.update(env_extra or {})
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, device, mode], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for r, p in enumerate(procs):
            try:
                so, se = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                _, se = p.communicate()
                raise AssertionError(f"rank {r} did not finish within "
                                     f"{timeout} s:\n{se[-3000:]}")
            if p.returncode != 0 and any(m in se for m in BIND_FAILURE):
                raise PortTaken(f"port {port} taken:\n{se[-3000:]}")
            assert p.returncode == 0, f"rank failed:\n{se[-3000:]}"
            outs.append(json.loads(so.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def main(device: str):
    hvd.init(device=device)
    dev = hvd.device()
    r = hvd.rank()
    inp = inputs(r)
    t = {k: torch.from_numpy(v).to(dev) for k, v in inp.items()}
    out = {"topology": [hvd.rank(), hvd.size(), hvd.local_rank(),
                        hvd.local_size(), hvd.cross_rank(),
                        hvd.cross_size()]}
    out["avg"] = hvd.collectives.allreduce(t["x"], op=hvd.Average)
    out["sum"] = hvd.collectives.allreduce(t["x"], op=hvd.Sum)
    assert torch.equal(t["x"].cpu(), torch.from_numpy(inp["x"])), \
        "input modified"
    out["fp16"] = hvd.collectives.allreduce(t["x"], compression=hvd.Compression.fp16)
    grouped = hvd.grouped_allreduce(
        [t["a"], t["b"].to(torch.bfloat16), t["c"], t["d"]], op=hvd.Sum)
    out["grouped_dtypes"] = [str(g.dtype) for g in grouped]
    out["grouped"] = grouped
    out["grouped_avg"] = hvd.grouped_allreduce([t["a"], t["d"]])
    out["bcast"] = hvd.collectives.broadcast(t["x"], root_rank=1)

    model = torch.nn.Linear(3, 2).to(dev)
    with torch.no_grad():
        model.weight.fill_(float(r + 1))
        model.bias.fill_(float(-r))
    opt = TF.adam(model.parameters(), 0.1)
    opt.state[model.weight]["mu"].fill_(float(10 + r))
    opt.state[model.weight]["count"] = 7 + r
    hvd.broadcast_parameters(model, root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    out["bparams"] = [model.weight.detach(), model.bias.detach()]
    out["bstate"] = [opt.state[model.weight]["mu"],
                     opt.state[model.weight]["count"]]
    out["bobject"] = hvd.broadcast_object({"rank": r, "x": [r, "s"]},
                                          root_rank=1)

    # one DistributedOptimizer step: gradients averaged across ranks
    w = torch.nn.Parameter(torch.zeros(4, device=dev))
    w.grad = t["a"].clone()
    dopt = hvd.DistributedOptimizer(TF.sgd([w], 1.0))
    dopt.step()
    out["dopt"] = w.detach()
    out["lossy"] = lossy(dev, r, hvd.size())
    hvd.shutdown()
    print(json.dumps({k: enc(v) for k, v in out.items()}))


def enc(v):
    if isinstance(v, torch.Tensor):
        return v.float().tolist()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [enc(x) for x in v]
    if isinstance(v, dict):
        return {k: enc(x) for k, x in v.items()}
    return v


class _W(torch.nn.Module):
    def __init__(self, dev):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(256, device=dev))


def lossy(dev, r: int, n: int) -> dict:
    """The lossy wire: int8, int4 and top-k allreduce (Sum, Average, with
    error feedback), the scale grid, the grouped reduction with an int
    leaf, reducescatter, allgather, alltoall and two optimizer steps."""
    t = {k: torch.from_numpy(v).to(dev) for k, v in lossy_inputs(r, n).items()}
    out = {}
    for mode in ("int8", "int4", "topk"):
        comp = hvd.Compression.lookup(mode)
        out[f"{mode}_sum"] = hvd.collectives.allreduce(t["v"], op=hvd.Sum,
                                           compression=comp)
        out[f"{mode}_avg"] = hvd.collectives.allreduce(t["v"], compression=comp)
        out[f"{mode}_ef"] = list(hvd.quantized_allreduce(
            t["v"], op=hvd.Sum, with_error=True, mode=mode))
    out["grid"] = hvd.collectives.allreduce(t["grid"], op=hvd.Sum,
                                compression=hvd.Compression.int8)
    leaves = [t["ga"], t["gb"], t["gd"].to(torch.bfloat16), t["gc"]]
    outs, errs = hvd.grouped_quantized_allreduce(leaves, op=hvd.Sum,
                                                 with_error=True)
    out["grouped"], out["grouped_err"] = outs, errs
    out["grouped_dtypes"] = [str(o.dtype) for o in outs]
    out["grouped_avg"] = hvd.grouped_allreduce(
        leaves, compression=hvd.Compression.int4)
    for mode in RS_MODES:
        comp = hvd.Compression.lookup(mode)
        out[f"rs_{mode}"] = hvd.collectives.reducescatter(t["rs"], compression=comp)
    out["rs_int8_avg"] = hvd.collectives.reducescatter(
        t["rs"], op=hvd.Average, compression=hvd.Compression.int8)
    out["allgather"] = hvd.collectives.allgather(t["ag"])
    out["alltoall"] = hvd.collectives.alltoall(t["a2a"])

    # two DistributedOptimizer(sgd(0.1), compression=int8) steps
    m = _W(dev)
    opt = hvd.DistributedOptimizer(TF.sgd(m.parameters(), 0.1),
                                   compression=hvd.Compression.int8)
    for step in (1, 2):
        if step == 2 and os.environ.get("HVD_TEST_FEEDBACK"):
            res = np.load(os.environ["HVD_TEST_FEEDBACK"])[r]
            interop.feedback_from_jax({"w": res}, m, opt)
        m.w.grad = t["opt_g"].clone()
        opt.step()
        out[f"opt_u{step}"] = TF.sgd_plain(m.w.grad, 1, -0.1)
        out[f"opt_res{step}"] = interop.feedback_to_jax(m, opt)["w"]
    return out


def _digest(ts) -> str:
    h = hashlib.sha256()
    for x in ts:
        h.update(x.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def resnet_main(device: str, steps: int = 3):
    """ResNet-50, 224x224, batch 256 per rank (seeded by rank), bf16,
    fused momentum SGD with the int8 and then the int4 wire and error
    feedback."""
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    hvd.init(device=device)
    r = hvd.rank()
    images, labels = synthetic_batch(256, 224, 1000, seed=r, device=device)
    if device == "cuda":
        torch.backends.cudnn.benchmark = True
    out = {"rank": r}
    for mode in ("int8", "int4"):
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0,
                         device=device)
        opt = hvd.DistributedOptimizer(
            hvd.fused_update.sgd(model.parameters(), 0.1, momentum=0.9),
            compression=hvd.Compression.lookup(mode))
        res = {"launches": [], "losses": [], "times": []}
        for _ in range(steps):
            Q.reset_launch_counts()
            TF.reset_launch_counts()
            t0 = time.perf_counter()
            loss = train_step(model, opt, images, labels)
            if device == "cuda":
                torch.cuda.synchronize()
            res["times"].append(time.perf_counter() - t0)
            res["losses"].append(float(loss))
            res["launches"].append({**Q.LAUNCHES,
                                    "momentum": TF.LAUNCHES["momentum"]})
        res["grad_digest"] = _digest(p.grad for p in model.parameters())
        res["residual_digest"] = _digest(opt.residuals.values())
        out[mode] = res
    hvd.shutdown()
    print(json.dumps(out))


# ---------------------------------------------------------------------------
# The overlap engine (tests/test_torch_overlap.py)
# ---------------------------------------------------------------------------

OVL_LEN = 1003            # no multiple of 2 or 4: the padded tail
OVL_CHUNKS = (1, 3, 4)
OVL_LOSSY = ("int8", "int4", "topk")
OVL_MODES = "int8:none:topk"   # HOROVOD_BUCKET_COMPRESSION, 3 buckets
OVL_LEAVES = ((40, 3), (17,))


def overlap_inputs(rank: int, n: int):
    rng = np.random.RandomState(300 + rank)
    return {
        "int": rng.randint(-20, 21, OVL_LEN).astype(np.float32),
        "rand": rng.standard_normal(OVL_LEN).astype(np.float32),
        "ga": rng.standard_normal((40, 3)).astype(np.float32),
        "gb": rng.standard_normal(17).astype(np.float32),
        "gc": rng.randint(-50, 50, (5,)).astype(np.int32),
        "rs": rng.standard_normal((9, 5)).astype(np.float32),
        "opt_g": [[rng.standard_normal(s).astype(np.float32)
                   for s in OVL_LEAVES] for _ in range(2)],
    }


def overlap_main(device: str):
    """The bucketed schedules against the JAX package's: the flat reduce
    (dense, lossy, per-bucket modes), the grouped and single entry
    points under ``overlap=True``, and ``DistributedOptimizer`` with the
    overlap on and off at stages 0 and 1."""
    from horovod_tpu_torch.ops import overlap as O

    hvd.init(device=device)
    dev = hvd.device()
    inp = overlap_inputs(hvd.rank(), hvd.size())
    t = {k: torch.from_numpy(v).to(dev) for k, v in inp.items()
         if k != "opt_g"}
    out = {}
    for op in (hvd.Sum, hvd.Average):
        for k in OVL_CHUNKS:
            for data in ("int", "rand"):
                out[f"dense_{op}_{k}_{data}"] = O.overlapped_flat_reduce(
                    t[data], op=op, chunks=k)[0]
    for mode in OVL_LOSSY:
        out[f"lossy_{mode}"] = list(O.overlapped_flat_reduce(
            t["rand"], op=hvd.Sum, quantized=mode, with_error=True,
            chunks=3))
    os.environ["HOROVOD_BUCKET_COMPRESSION"] = OVL_MODES
    out["modes"] = list(O.overlapped_flat_reduce(
        t["rand"], op=hvd.Sum, with_error=True, chunks=3))
    del os.environ["HOROVOD_BUCKET_COMPRESSION"]
    out["grouped"] = hvd.grouped_allreduce([t["ga"], t["gb"], t["gc"]],
                                           overlap=True)
    out["grouped_q"] = list(hvd.grouped_quantized_allreduce(
        [t["ga"], t["gb"]], op=hvd.Sum, with_error=True, overlap=True))
    out["rs"] = hvd.collectives.reducescatter(t["rs"], overlap=True)
    out["allreduce"] = hvd.collectives.allreduce(t["rand"], overlap=True)
    for stage in (0, 1):
        for ovl in (False, True):
            ws = [torch.nn.Parameter(torch.zeros(s, device=dev))
                  for s in OVL_LEAVES]
            opt = hvd.DistributedOptimizer(TF.sgd(ws, 0.1, 0.9),
                                           zero_stage=stage, overlap=ovl)
            for grads in inp["opt_g"]:
                for w, g in zip(ws, grads):
                    w.grad = torch.from_numpy(g).to(dev)
                opt.step()
            out[f"opt_{stage}_{ovl}"] = [w.detach() for w in ws]
    hvd.shutdown()
    print(json.dumps({k: enc(v) for k, v in out.items()}))


# ---------------------------------------------------------------------------
# ZeRO stages 1-3 (tests/test_torch_zero.py)
# ---------------------------------------------------------------------------

ZERO_LEAVES = (("a", (40, 3)), ("b", (17,)), ("c", (5, 7)), ("d", (3,)))
ZERO_STEPS = 3
ZERO_KINDS = ("sgd", "momentum", "adam")
# dyadic hyperparameters keep every operation of SGD and momentum exact
# on integer-valued data; the defaults are what users run
ZERO_HYPER = {
    "dyadic": dict(lr=0.5, momentum=0.5, b1=0.5, b2=0.25, eps=2.0 ** -10),
    "random": dict(lr=0.1, momentum=0.9, b1=0.9, b2=0.999, eps=1e-8),
}
EF_LEN, EF_STEPS, EF_LR = 512, 5, 0.01


def zero_inputs(rank: int, n: int, data: str):
    """Initial weights (the same on every rank) and ``ZERO_STEPS`` steps
    of per-rank gradients, leaf by leaf."""
    rng = np.random.RandomState(500)
    if data == "dyadic":
        init = [rng.randint(-8, 9, s).astype(np.float32)
                for _, s in ZERO_LEAVES]
    else:
        init = [rng.standard_normal(s).astype(np.float32)
                for _, s in ZERO_LEAVES]
    rng = np.random.RandomState(600 + rank)
    if data == "dyadic":
        grads = [[rng.randint(-4, 5, s).astype(np.float32)
                  for _, s in ZERO_LEAVES] for _ in range(ZERO_STEPS)]
    else:
        grads = [[rng.standard_normal(s).astype(np.float32)
                  for _, s in ZERO_LEAVES] for _ in range(ZERO_STEPS)]
    return init, grads


def ef_grad(rank: int) -> np.ndarray:
    return np.random.RandomState(700 + rank).standard_normal(
        EF_LEN).astype(np.float32)


def _zero_opt(kind: str, params, h: dict):
    if kind == "adam":
        return TF.adam(params, h["lr"], b1=h["b1"], b2=h["b2"], eps=h["eps"])
    return TF.sgd(params, h["lr"], h["momentum"] if kind == "momentum"
                  else None)


def zero_run(kind: str, stage: int, data: str, dev, steps=None,
             compression=None, **kw):
    """``ZERO_STEPS`` steps of a ``DistributedOptimizer`` at ``stage``
    over the ``ZERO_LEAVES``; stage 3 through ``zero3_full_params``
    (under ``compression``, in the optimizer's regime) with a loss linear in the weights (its
    cotangents are the gradients).  Returns the weights, leaf by leaf,
    and the optimizer."""
    init, grads = zero_inputs(hvd.rank(), hvd.size(), data)
    grads = grads if steps is None else steps
    h = ZERO_HYPER[data]
    ws = [torch.nn.Parameter(torch.from_numpy(a).to(dev)) for a in init]
    if stage == 3:
        zp = hvd.zero3_shard_params(
            [(name, w) for (name, _), w in zip(ZERO_LEAVES, ws)])
        opt = hvd.DistributedOptimizer(_zero_opt(kind, zp.shards, h),
                                       zero_stage=3, **kw)
        eager = kw.get("eager", False)
        for gs in grads:
            opt.zero_grad()
            full = hvd.zero3_full_params(zp, compression=compression,
                                         eager=eager)
            loss = sum((full[name] * torch.from_numpy(g).to(dev)).sum()
                       for (name, _), g in zip(ZERO_LEAVES, gs))
            loss.backward()
            opt.step()
        full = hvd.zero3_full_params(zp, eager=eager)
        return [full[name].detach() for name, _ in ZERO_LEAVES], opt
    opt = hvd.DistributedOptimizer(_zero_opt(kind, ws, h), zero_stage=stage,
                                   **kw)
    for gs in grads:
        for w, g in zip(ws, gs):
            w.grad = torch.from_numpy(g).to(dev)
        opt.step()
    return [w.detach() for w in ws], opt


def zero_main(device: str):
    """Stages 1-3 against the JAX package's ``DistributedOptimizer
    (zero_stage=k)``: every kind with and without the fused tail, on
    dyadic and random data; int8 with error feedback at stages 1 and 2;
    accumulation over two passes at stage 1; at two ranks also a small
    ResNet through ``zero3_train_step`` against stage 0 and the carried
    JAX state (``HVD_TEST_INTEROP``)."""
    hvd.init(device=device)
    dev = hvd.device()
    r, n = hvd.rank(), hvd.size()
    out = {}
    for fused in ("0", "1"):
        os.environ["HOROVOD_FUSED_UPDATE"] = fused
        for kind in ZERO_KINDS:
            for stage in (0, 1, 2, 3):
                for data in ZERO_HYPER:
                    ws, opt = zero_run(kind, stage, data, dev)
                    out[f"{kind}_{stage}_{fused}_{data}"] = ws
                    if stage in (1, 2):
                        out[f"bytes_{kind}_{stage}_{fused}"] = \
                            opt.state_bytes()
    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    g = torch.from_numpy(ef_grad(r)).to(dev)
    for stage, comp in ((1, "int8"), (2, "int8"), (1, "none")):
        w = torch.nn.Parameter(torch.zeros(EF_LEN, device=dev))
        opt = hvd.DistributedOptimizer(
            TF.sgd([w], EF_LR), zero_stage=stage,
            compression=hvd.Compression.lookup(comp))
        for _ in range(EF_STEPS):
            w.grad = g.clone()
            opt.step()
        out[f"ef_{stage}_{comp}"] = w.detach()
        if comp != "none":
            out[f"ef_res_{stage}"] = opt.residual[0]
    # stage 3 with the backward's scatter on the int8 wire (no feedback)
    out["zero3_int8"] = zero_run("sgd", 3, "random", dev,
                                 compression=hvd.Compression.int8)[0]
    # two backward passes per update at stage 1: four steps, two updates
    _, grads = zero_inputs(r, n, "dyadic")
    out["accum"] = zero_run("momentum", 1, "dyadic", dev,
                            steps=grads + grads[:1],
                            backward_passes_per_step=2)[0]
    if n == 2:
        out["resnet"] = zero3_resnet_case(dev)
        if os.environ.get("HVD_TEST_INTEROP"):
            out["interop"] = interop_case(dev,
                                          os.environ["HVD_TEST_INTEROP"])
    hvd.shutdown()
    print(json.dumps({k: enc(v) for k, v in out.items()}))


def small_resnet(dev):
    from horovod_tpu_torch.models.resnet import BottleneckBlock, ResNet

    return ResNet(stage_sizes=[1, 1, 1, 1], block_cls=BottleneckBlock,
                  num_classes=10, num_filters=8, dtype=torch.float32, seed=7,
                  device=dev)


def zero3_resnet_case(dev, steps: int = 2) -> dict:
    """The small ResNet (``tests/test_torch_resnet.py``'s config, f32)
    trained ``steps`` steps on this rank's batch through
    ``zero3_train_step`` and through ``train_step`` at stage 0, fused
    momentum SGD: both weight sets, gathered, and the losses."""
    from horovod_tpu_torch.train_step import (synthetic_batch, train_step,
                                              zero3_train_step)

    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    x, y = synthetic_batch(4, 32, 10, seed=3 + hvd.rank(), device=dev)
    m0 = small_resnet(dev)
    o0 = hvd.DistributedOptimizer(TF.sgd(m0.parameters(), 0.1, 0.9))
    l0 = [float(train_step(m0, o0, x, y)) for _ in range(steps)]
    m3 = small_resnet(dev)
    names = [name for name, _ in m3.named_parameters()]
    zp = hvd.zero3_shard_params(m3)
    o3 = hvd.DistributedOptimizer(TF.sgd(zp.shards, 0.1, 0.9), zero_stage=3)
    l3 = [float(zero3_train_step(m3, zp, o3, x, y)) for _ in range(steps)]
    full = hvd.zero3_full_params(zp)
    return {"loss0": l0, "loss3": l3,
            "w0": torch.cat([p.detach().reshape(-1)
                             for p in m0.parameters()]),
            "w3": torch.cat([full[k].detach().reshape(-1) for k in names]),
            "bn0": m0.bn_init.mean, "bn3": m3.bn_init.mean,
            "bytes0": o0.state_bytes(), "bytes3": o3.state_bytes(),
            "numel3": sum(s.numel() for s in zp.shards)}


def interop_case(dev, path: str) -> dict:
    """The JAX package's stage-1 run of the small ResNet, carried over
    after two steps (weights and ``_ShardedState``), then one more step
    here: returns the weights in the flax layout's names."""
    import pickle

    with open(path, "rb") as f:
        saved = pickle.load(f)
    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    model = small_resnet(dev)
    interop.cnn_from_flax(saved["params"], saved["batch_stats"], model)
    opt = hvd.DistributedOptimizer(TF.sgd(model.parameters(), 0.1, 0.9),
                                   zero_stage=1)
    interop.sharded_state_from_jax(
        saved["state"], types.SimpleNamespace(**saved["layout"]),
        saved["params"], model, opt)
    grads = {name: torch.zeros_like(p) for name, p in
             model.named_parameters()}
    interop._load(grads, saved["grads"][hvd.rank()], "grads")
    for name, p in model.named_parameters():
        p.grad = grads[name]
    opt.step()
    return interop.cnn_to_flax(model)[0]


# ---------------------------------------------------------------------------
# ZeRO stages on four cards (tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------

# (name, zero_stage, overlap, compression)
ZERO_RESNET = (("stage 0", 0, False, "none"),
               ("stage 0 + overlap", 0, True, "none"),
               ("stage 1", 1, False, "none"),
               ("stage 2", 2, False, "none"),
               ("stage 3", 3, False, "none"),
               ("stage 2 + overlap + int8", 2, True, "int8"))
ZERO_RESNET_STEPS = 4


def zero_resnet_main(device: str, steps: int = ZERO_RESNET_STEPS):
    """ResNet-50, 224x224, batch 256 per rank (seeded by rank), bf16,
    fused momentum SGD from the same seeded weights, ``steps`` steps at
    each of ``ZERO_RESNET``, after a warm-up that autotunes cuDNN: per
    step the launches, loss, time and (stages 1-2) a digest of the
    weights; per configuration the peak memory and the optimizer-state
    bytes.  The configurations then run again in reverse order, and
    their step times are kept beside the first pass's (``times2``); and a
    third time for two steps with a synchronize around the optimizer's
    step, for the peaks of the forward and backward and of the step
    apart (``peak_fwd_bwd``, ``peak_step``) and the bytes allocated as
    the step begins (``resident_step``).
    Stage 3's weights after one step are held against stage 1's here
    (rtol 2e-5, atol 1e-7)."""
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import batch_norm as BN
    from horovod_tpu_torch.train_step import (synthetic_batch, train_step,
                                              zero3_train_step)

    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    hvd.init(device=device)
    r = hvd.rank()
    images, labels = synthetic_batch(256, 224, 1000, seed=r, device=device)
    torch.backends.cudnn.benchmark = True
    first = {}

    def run(stage, ovl, comp, steps, split_peaks=False):
        gc.collect()                 # the last configuration's cycles
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0,
                         device=device)
        zp = hvd.zero3_shard_params(model) if stage == 3 else None
        opt = hvd.DistributedOptimizer(
            hvd.fused_update.sgd(zp.shards if zp else model.parameters(),
                                 0.1, momentum=0.9),
            zero_stage=stage, overlap=ovl,
            compression=hvd.Compression.lookup(comp))
        res = {"launches": [], "losses": [], "times": [], "digests": [],
               "peak_fwd_bwd": 0, "peak_step": 0, "resident_step": 0}
        if split_peaks:
            step_fn = opt.step

            def step(closure=None):
                torch.cuda.synchronize()
                res["peak_fwd_bwd"] = max(res["peak_fwd_bwd"],
                                          torch.cuda.max_memory_allocated())
                res["resident_step"] = max(res["resident_step"],
                                           torch.cuda.memory_allocated())
                torch.cuda.reset_peak_memory_stats()
                step_fn(closure)
                torch.cuda.synchronize()
                res["peak_step"] = max(res["peak_step"],
                                       torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()

            opt.step = step
        for step in range(steps):
            Q.reset_launch_counts()
            TF.reset_launch_counts()
            BN.reset_launch_counts()
            t0 = time.perf_counter()
            if zp is None:
                loss = train_step(model, opt, images, labels)
            else:
                loss = zero3_train_step(model, zp, opt, images, labels)
            torch.cuda.synchronize()
            res["times"].append(time.perf_counter() - t0)
            res["losses"].append(float(loss))
            res["launches"].append({**Q.LAUNCHES, **BN.LAUNCHES,
                                    "momentum": TF.LAUNCHES["momentum"]})
            if zp is None:
                res["digests"].append(_digest(model.parameters()))
            if step == 0 and stage in (1, 3) and stage not in first:
                w = (torch.cat([t.detach().reshape(-1) for t in
                                hvd.zero3_full_params(zp).values()])
                     if zp else torch.cat([p.detach().reshape(-1)
                                           for p in model.parameters()]))
                first[stage] = w.clone()
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
        res["state_bytes"] = opt.state_bytes()
        return res

    run(0, False, "none", 2)                     # cuDNN autotuning
    out = {"rank": r}
    for name, stage, ovl, comp in ZERO_RESNET:
        out[name] = run(stage, ovl, comp, steps)
    for name, stage, ovl, comp in reversed(ZERO_RESNET):
        out[name]["times2"] = run(stage, ovl, comp, steps)["times"]
    for name, stage, ovl, comp in ZERO_RESNET:
        res = run(stage, ovl, comp, 2, split_peaks=True)
        out[name]["peak_fwd_bwd"] = res["peak_fwd_bwd"]
        out[name]["peak_step"] = res["peak_step"]
        out[name]["resident_step"] = res["resident_step"]
    a, b = first[3], first[1]
    out["stage3_vs_stage1"] = float(((a - b).abs() - 2e-5 * b.abs())
                                    .max())
    out["stage3_close"] = bool(torch.allclose(a, b, rtol=2e-5, atol=1e-7))
    hvd.shutdown()
    print(json.dumps(out))


# ---------------------------------------------------------------------------
# Sequence parallelism (tests/test_torch_sequence_parallel.py)
# ---------------------------------------------------------------------------

#: (B, L, H, D) of the attention cases, as the reference's tests
SP_SHAPE = (2, 64, 8, 16)
#: (name, function, layout) of the attention cases; every case runs
#: causal and not, and the ring cases also in bfloat16 (forward)
SP_CASES = (("ring", "ring", "contiguous"), ("zigzag", "ring", "zigzag"),
            ("ulysses", "ulysses", "contiguous"))
#: the small LM (tests/test_transformer.py's widths) and its SGD run
SP_LM = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=4,
             d_ff=64, max_seq=64)
SP_LM_BATCH, SP_LM_STEPS, SP_LM_LR = 4, 3, 0.5


def sp_inputs() -> dict:
    """Global q, k, v and the loss's cotangent g, (B, L, H, D) float32."""
    rng = np.random.RandomState(0)
    return {n: (rng.randn(*SP_SHAPE) * 0.3).astype(np.float32)
            for n in "qkvg"}


def sp_lm_layout(n: int) -> tuple[int, int]:
    """The (dp, sp) the LM runs at in a world of ``n``."""
    return {2: (1, 2), 4: (2, 2)}[n]


def sp_attention_case(fn, layout, causal, dtype, group, sp, s) -> dict:
    """This rank's output and input gradients of ``sum(out * g)``."""
    from horovod_tpu_torch.parallel.ring_attention import (ring_attention,
                                                           zigzag_shard)
    from horovod_tpu_torch.parallel.ulysses import ulysses_attention

    lc = SP_SHAPE[1] // sp
    x = {}
    for n, a in sp_inputs().items():
        t = torch.from_numpy(a)
        if layout == "zigzag":
            t = zigzag_shard(t, sp)
        x[n] = t[:, s * lc:(s + 1) * lc].to(dtype).requires_grad_(n != "g")
    if fn == "ring":
        out = ring_attention(x["q"], x["k"], x["v"], group, causal, layout)
    else:
        out = ulysses_attention(x["q"], x["k"], x["v"], group, causal)
    (out.float() * x["g"].float()).sum().backward()
    return {"out": out, "dq": x["q"].grad, "dk": x["k"].grad,
            "dv": x["v"].grad}


def sp_lm_run(group, dp: int, sp: int, d: int, s: int) -> dict:
    """The small LM, SGD, on rank (d, s)'s block of the global batch:
    the initial logits, the world-averaged losses and the weights."""
    from horovod_tpu_torch.models import transformer as TT
    from horovod_tpu_torch.train_step import (lm_train_step, shard_tokens,
                                              synthetic_tokens)

    cfg = TT.TransformerConfig(**SP_LM, dtype="float32")
    model = TT.Transformer(cfg, seed=0, device="cpu")
    opt = hvd.DistributedOptimizer(TF.sgd(model.parameters(), SP_LM_LR))
    tok, tgt = (shard_tokens(t, dp, sp, d, s) for t in synthetic_tokens(
        SP_LM_BATCH, SP_LM["max_seq"], cfg.vocab, seed=1, device="cpu"))
    with torch.no_grad():
        logits = model(tok, group)
    losses = [float(lm_train_step(model, opt, tok, tgt, group))
              for _ in range(SP_LM_STEPS)]
    return {"logits": logits, "losses": losses,
            "weights": {k: v for k, v in model.state_dict().items()}}


def sp_main(device: str):
    """Every attention case at sp = world size, then the LM at
    :func:`sp_lm_layout`."""
    from horovod_tpu_torch.parallel.mesh import sequence_groups

    hvd.init(device=device)
    n, r = hvd.size(), hvd.rank()
    group, (_, s) = sequence_groups(1, n)
    dp, sp = sp_lm_layout(n)
    lm_group, (ld, ls) = sequence_groups(dp, sp)
    out = {"rank": r}
    for name, fn, layout in SP_CASES:
        for causal in (True, False):
            out[f"{name} causal={causal}"] = sp_attention_case(
                fn, layout, causal, torch.float32, group, n, s)
        if fn == "ring":
            out[f"{name} bf16"] = {"out": sp_attention_case(
                fn, layout, True, torch.bfloat16, group, n, s)["out"]}
    out["lm"] = sp_lm_run(lm_group, dp, sp, ld, ls)
    try:
        sequence_groups(n, 2)
        out["groups_refused"] = False
    except hvd.HorovodTpuError:
        out["groups_refused"] = True
    hvd.shutdown()
    print(json.dumps(enc(out)))


#: the long-context LM at sp = 4 and the bench LM at dp = 2 x sp = 2 on
#: four cards: (name, seq, global batch, dp, sp)
SP_CARD_CONFIGS = (("long-context sp4", 8192, 1, 1, 4),
                   ("bench dp2 x sp2", 1024, 16, 2, 2))
SP_CARD_LM = dict(vocab=32768, d_model=768, n_heads=12, head_dim=64,
                  n_layers=12, d_ff=3072)
SP_CARD_STEPS = 3
#: the attention of the sequence group over NCCL: (B, L, H, D) bf16
SP_CARD_ATTN = (1, 8192, 12, 64)


def _progress(msg: str) -> None:
    """Append ``msg`` to this rank's progress file in the directory
    ``HVD_TEST_PROGRESS`` names (if set): what a hung world reached."""
    d = os.environ.get("HVD_TEST_PROGRESS")
    if d:
        with open(os.path.join(d, f"progress_rank{hvd.rank()}.txt"),
                  "a") as f:
            f.write(f"{time.strftime('%H:%M:%S')} {msg}\n")


def _flat_grads(model) -> torch.Tensor:
    return torch.cat([p.grad.reshape(-1).float() for p in model.parameters()])


def sp_card_lm(cfg, group, seq, batch, dp, sp, d, s) -> tuple:
    """``SP_CARD_STEPS`` fused-Adam steps of the LM on rank (d, s)'s block
    through ``lm_train_step``: per step the launches, global loss, time
    and a digest of the weights; the peak memory; and the world-averaged
    gradient of step 1 (which the optimizer writes back to ``.grad``).
    With ``HVD_TEST_PROFILE`` (a directory) two more steps run under
    ``torch.profiler`` (``chip_smoke.profile_steps``: the table per rank
    in that directory, the summary in the progress file)."""
    from horovod_tpu_torch.models import transformer as TT
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.train_step import (lm_train_step, shard_tokens,
                                              synthetic_tokens)

    model = TT.Transformer(cfg, seed=0)
    opt = hvd.DistributedOptimizer(hvd.fused_update.adam(model.parameters(),
                                                         3e-4))
    tok, tgt = (shard_tokens(t, dp, sp, d, s)
                for t in synthetic_tokens(batch, seq, cfg.vocab, seed=1))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = {"launches": [], "losses": [], "times": [], "digests": []}
    for step in range(SP_CARD_STEPS):
        FA.reset_launch_counts()
        TF.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = lm_train_step(model, opt, tok, tgt, group)
        torch.cuda.synchronize()
        res["times"].append(time.perf_counter() - t0)
        res["losses"].append(float(loss))
        res["launches"].append({**FA.LAUNCHES, "adam": TF.LAUNCHES["adam"]})
        if step == 0:
            g1 = _flat_grads(model)
        res["digests"].append(_digest(model.parameters()))
        _progress(f"seq {seq} dp {dp} sp {sp}: step {step} "
                  f"{res['times'][-1]:.4f} s")
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    prof = os.environ.get("HVD_TEST_PROFILE")
    if prof:
        import chip_smoke

        chip_smoke.log = _progress
        tag = f"seq{seq}_dp{dp}_sp{sp}_rank{hvd.rank()}"
        chip_smoke.profile_steps(
            torch, lambda: lm_train_step(model, opt, tok, tgt, group),
            statistics.median(res["times"][1:]),
            os.path.join(prof, f"profile_{tag}.txt"), chip_smoke.LM_CLASSES,
            tag, steps=2)
    return res, g1


def _ref_path(i: int) -> str:
    return os.path.join(os.environ["HVD_TEST_REF_DIR"], f"grad{i}.pt")


def sp_cards_ref_main(device: str):
    """One card's sp = 1 run of each of ``SP_CARD_CONFIGS`` (world 1, the
    same global batch, weights and fused Adam): its results, and its
    step-1 gradient saved under ``HVD_TEST_REF_DIR`` for
    :func:`sp_cards_main`."""
    from horovod_tpu_torch.models import transformer as TT

    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    hvd.init(device=device)
    out = {}
    for i, (name, seq, batch, _, _) in enumerate(SP_CARD_CONFIGS):
        cfg = TT.TransformerConfig(**SP_CARD_LM, max_seq=seq)
        out[name], g1 = sp_card_lm(cfg, None, seq, batch, 1, 1, 0, 0)
        torch.save(g1.cpu(), _ref_path(i))
        del g1
    hvd.shutdown()
    print(json.dumps(out))


def sp_card_attention(group, sp: int, s: int) -> dict:
    """The contiguous ring, the zigzag ring and Ulysses at
    ``SP_CARD_ATTN`` bf16, causal, over ``group`` (NCCL), forward and
    backward, against the one-call kernels over the whole sequence: the
    largest errors, this rank's launches and its median time of three
    forward + backward passes (CUDA events, after one warm-up)."""
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.parallel.ring_attention import (ring_attention,
                                                           zigzag_shard)
    from horovod_tpu_torch.parallel.ulysses import ulysses_attention

    gen = torch.Generator(device="cuda").manual_seed(31)
    x = {n: torch.randn(*SP_CARD_ATTN, device="cuda", generator=gen)
         .bfloat16() for n in "qkvg"}

    def run(fn, inputs, grp):
        q, k, v = (inputs[n].detach().clone().requires_grad_()
                   for n in "qkv")
        out = fn(q, k, v, grp)
        out.backward(inputs["g"])
        return [out.detach(), q.grad, k.grad, v.grad]

    ring = lambda q, k, v, g: ring_attention(q, k, v, g)  # noqa: E731
    want = run(ring, x, None)
    lc = SP_CARD_ATTN[1] // sp
    cases = {
        "contiguous": (ring, False),
        "zigzag": (lambda q, k, v, g: ring_attention(q, k, v, g,
                                                     layout="zigzag"), True),
        "ulysses": (ulysses_attention, False),
    }
    out = {}
    for name, (fn, zig) in cases.items():
        shard = (lambda t: zigzag_shard(t, sp)) if zig else (lambda t: t)
        mine = {n: shard(t)[:, s * lc:(s + 1) * lc].contiguous()
                for n, t in x.items()}
        FA.reset_launch_counts()
        got = run(fn, mine, group)
        launches = dict(FA.LAUNCHES)
        errs = {}
        for what, a, b in zip(("out", "dq", "dk", "dv"), got, want):
            b = shard(b)[:, s * lc:(s + 1) * lc]
            torch.testing.assert_close(a.float(), b.float(), rtol=2e-2,
                                       atol=2e-2, msg=lambda m: f"{name} "
                                       f"{what}: {m}")
            errs[what] = FA.errors(a, b)
        times = []
        for _ in range(4):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            run(fn, mine, group)
            ev[1].record()
            torch.cuda.synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        out[name] = {"launches": launches, "errors": errs,
                     "ms": statistics.median(times[1:])}
        _progress(f"attention {name}: {out[name]}")
    return out


def sp_cards_main(device: str):
    """``SP_CARD_CONFIGS`` on four cards and the attention of the long
    group over NCCL; rank 0 holds the world-averaged gradient of step 1
    against the one card's that :func:`sp_cards_ref_main` saved (relative
    L2 error)."""
    import torch.distributed as dist

    from horovod_tpu_torch.models import transformer as TT
    from horovod_tpu_torch.parallel.mesh import sequence_groups

    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    hvd.init(device=device)
    r = hvd.rank()
    groups = {name: sequence_groups(dp, sp)
              for name, _, _, dp, sp in SP_CARD_CONFIGS}
    _progress("groups built")
    out, grads = {"rank": r}, {}
    for name, seq, batch, dp, sp in SP_CARD_CONFIGS:
        group, (d, s) = groups[name]
        cfg = TT.TransformerConfig(**SP_CARD_LM, max_seq=seq)
        out[name], grads[name] = sp_card_lm(cfg, group, seq, batch, dp, sp,
                                            d, s)
        out[name]["place"] = [d, s]
        if r:
            del grads[name]
    long_name, _, _, _, long_sp = SP_CARD_CONFIGS[0]
    group, (_, s) = groups[long_name]
    out["attention"] = sp_card_attention(group, long_sp, s)
    if r == 0:
        for i, (name, *_) in enumerate(SP_CARD_CONFIGS):
            g1 = torch.load(_ref_path(i)).cuda()
            out[name]["grad_rel_err"] = float(
                (grads.pop(name) - g1).norm() / g1.norm())
            del g1
    dist.barrier()
    hvd.shutdown()
    print(json.dumps(out))


# ---------------------------------------------------------------------------
# Tensor and expert parallelism (tests/test_torch_model_parallel.py)
# ---------------------------------------------------------------------------

#: the LM cases: (name, world, mesh axes, moe_every, how the place is
#: named, whether each dp rank trains on the same rows); "data" is the
#: data mesh of ``init(mesh=...)``, "make" ``make_mesh``
MP_CASES = (
    ("tp2", 2, dict(dp=1, tp=2, sp=1), 0, "sizes", False),
    ("moe dp2", 2, dict(dp=2, tp=1, sp=1), 2, "make", False),
    ("moe dp2 same rows", 2, dict(dp=2, tp=1, sp=1), 2, "make", True),
    ("dp2 x tp2", 4, dict(dp=2, tp=2, sp=1), 0, "make", False),
    ("tp2 x sp2", 4, dict(dp=1, tp=2, sp=2), 0, "make", False),
    ("HOROVOD_MESH=dp:2,sp:2", 4, dict(dp=2, tp=1, sp=2), 0, "data",
     False),
    ("moe dp2 x sp2", 4, dict(dp=2, tp=1, sp=2), 2, "make", False),
)
MP_BATCH, MP_STEPS, MP_LR = 4, 3, 0.5
#: the moe_layer case: tokens per rank, width, hidden width, experts per
#: rank, capacity factor (tests/test_pipeline_moe.py's)
MOE_T, MOE_D, MOE_FF, MOE_E_LOCAL, MOE_CAP = 32, 8, 16, 2, 1.5


def mp_tokens(case) -> tuple:
    """The global (tokens, targets) of an LM case: ``MP_BATCH`` rows of
    ``synthetic_tokens`` (seed 1), or for a same-rows case its first
    ``MP_BATCH / dp`` rows repeated on every dp rank."""
    from horovod_tpu_torch.train_step import synthetic_tokens

    _, _, axes, _, _, same = case
    tok, tgt = synthetic_tokens(MP_BATCH, SP_LM["max_seq"], SP_LM["vocab"],
                                seed=1, device="cpu")
    if same:
        rows = MP_BATCH // axes["dp"]
        tok, tgt = (t[:rows].repeat(axes["dp"], 1) for t in (tok, tgt))
    return tok, tgt


def fg_inputs(r: int) -> dict:
    """The f/g case: ``x`` and ``c`` shared, ``w`` this rank's."""
    rng = np.random.RandomState(40)
    x, c = (rng.randn(3, 4).astype(np.float32) for _ in range(2))
    w = np.random.RandomState(41 + r).randn(3, 4).astype(np.float32)
    return {"x": x, "c": c, "w": w}


def moe_inputs(ep: int) -> dict:
    """The moe_layer case's global arrays (tests/test_pipeline_moe.py's
    draw): router (D, E), w_in (E, D, FF), w_out (E, FF, D), x (ep, T,
    D)."""
    rng = np.random.RandomState(2)
    e = ep * MOE_E_LOCAL
    return {"router": rng.randn(MOE_D, e).astype(np.float32) * 0.5,
            "w_in": rng.randn(e, MOE_D, MOE_FF).astype(np.float32) * 0.3,
            "w_out": rng.randn(e, MOE_FF, MOE_D).astype(np.float32) * 0.3,
            "x": rng.randn(ep, MOE_T, MOE_D).astype(np.float32)}


def fg_case(hop, r: int) -> dict:
    """``out = reduce_from_tp(copy_to_tp(x) * w)``, ``sum(out * c)``
    differentiated: out, dx, dw."""
    from horovod_tpu_torch.parallel.sharding import (copy_to_tp,
                                                     reduce_from_tp)

    a = {k: torch.from_numpy(v) for k, v in fg_inputs(r).items()}
    x = a["x"].clone().requires_grad_()
    w = a["w"].clone().requires_grad_()
    out = reduce_from_tp(copy_to_tp(x, hop) * w, hop)
    (out * a["c"]).sum().backward()
    return {"out": out.detach(), "dx": x.grad, "dw": w.grad}


def moe_case(hop, r: int, dtype) -> dict:
    """This rank's ``moe_layer`` over ``hop`` on its tokens and experts:
    out, aux, the routes (expert, keep) and, in float32, the gradients of
    ``sum(out**2) + 0.01 * aux``."""
    from horovod_tpu_torch.parallel.moe import moe_layer, route

    g = moe_inputs(hop.size)
    lo, hi = r * MOE_E_LOCAL, (r + 1) * MOE_E_LOCAL
    x = torch.from_numpy(g["x"][r]).to(dtype).requires_grad_()
    router = torch.from_numpy(g["router"]).requires_grad_()
    w_in = torch.from_numpy(g["w_in"][lo:hi].copy()).requires_grad_()
    w_out = torch.from_numpy(g["w_out"][lo:hi].copy()).requires_grad_()
    out, aux = moe_layer(x, router, w_in, w_out, hop,
                         capacity_factor=MOE_CAP)
    _, idx, _, _, _, keep, _ = route(x.detach(), router.detach(), MOE_CAP)
    res = {"out": out.detach(), "aux": float(aux), "idx": idx,
           "keep": keep.any(-1).int()}
    if dtype == torch.float32:
        ((out.float() ** 2).sum() + 0.01 * aux).backward()
        res.update(dx=x.grad, drouter=router.grad, dw_in=w_in.grad,
                   dw_out=w_out.grad)
    return res


def mp_lm_case(case) -> dict:
    """An LM case on this rank: ``MP_STEPS`` SGD steps (lr ``MP_LR``)
    through ``lm_train_step`` with ``lm_optimizer`` on the rank's block of
    the batch: the losses, the rank's coordinate and local weights (JAX
    layout), and the reduction groups."""
    from horovod_tpu_torch.models import transformer as TT
    from horovod_tpu_torch.parallel.mesh import make_mesh
    from horovod_tpu_torch.train_step import (lm_optimizer, lm_train_step,
                                              shard_tokens)

    _, _, axes, moe_every, how, _ = case
    cfg = TT.TransformerConfig(**SP_LM, dtype="float32",
                               moe_every=moe_every)
    if how == "sizes":
        model = TT.Transformer(cfg, seed=0, device="cpu", tp=axes["tp"])
    else:
        mesh = hvd.data_mesh() if how == "data" else make_mesh(
            dp=axes["dp"], tp=axes["tp"], sp=axes["sp"])
        model = TT.Transformer(cfg, seed=0, device="cpu", mesh=mesh)
    opt = lm_optimizer(model, TF.sgd(model.parameters(), MP_LR))
    coord = model.coord()
    (d, _), (s, _) = coord["dp"], coord["sp"]
    tok, tgt = (shard_tokens(t, axes["dp"], axes["sp"], d, s)
                for t in mp_tokens(case))
    losses = [float(lm_train_step(model, opt, tok, tgt))
              for _ in range(MP_STEPS)]
    place = model.place
    hops = dict(zip(("dp", "pp", "tp", "sp", "dp*sp"),
                    (*place[:4], place.data.flat)))
    return {"losses": losses, "coord": coord,
            "groups": [list(a) for a in opt.axes],
            "hops": {k: list(h.ranks) for k, h in hops.items()},
            "weights": interop.transformer_to_jax(model)}


def mp_main(device: str):
    """Every case of this world size: the f/g pair and ``moe_layer`` (f32
    and bf16 tokens) over the world, then each LM case of
    :data:`MP_CASES`, the data-mesh case after a re-init under its
    ``HOROVOD_MESH``."""
    from horovod_tpu_torch.parallel.mesh import make_mesh

    hvd.init(device=device)
    n, r = hvd.size(), hvd.rank()
    out = {"rank": r}
    if n == 2:
        hop = make_mesh(tp=2).hops["tp"]
        out["fg"] = fg_case(hop, r)
        ep = make_mesh(dp=2).hops["dp"]
        out["moe f32"] = moe_case(ep, r, torch.float32)
        out["moe bf16"] = moe_case(ep, r, torch.bfloat16)
    for case in MP_CASES:
        if case[1] != n:
            continue
        if case[4] == "data":
            _reinit_shutdown()
            hvd.init(device=device, mesh=case[2])
        out[case[0]] = mp_lm_case(case)
    _reinit_shutdown()
    print(json.dumps(enc(out)))


#: the bench LM on four cards (test_four_cards_model_parallel_lm):
#: (name, HOROVOD_MESH or None for the sequence_groups run, moe_every)
MP_CARD_CASES = (("sequence_groups dp2 x sp2", None, 0),
                 ("HOROVOD_MESH=dp:2,sp:2", "dp:2,sp:2", 0),
                 ("HOROVOD_MESH=dp:2,tp:2", "dp:2,tp:2", 0),
                 ("HOROVOD_MESH=dp:4 MoE", "dp:4", 2))
MP_CARD_SEQ, MP_CARD_BATCH, MP_CARD_STEPS = 1024, 16, 3


def _save_tree(path: str, tree: dict, coord=None) -> None:
    """A JAX-layout tree of numpy arrays (and the rank's coordinate) as
    one ``.npz`` file."""
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = np.asarray(v, np.float32)

    walk(tree, "")
    if coord is not None:
        flat["coord"] = np.asarray([coord[a] for a in ("dp", "pp", "tp",
                                                       "sp")])
    np.savez(path, **flat)


def mp_card_lm(model, opt, tok, tgt, sp_group, grads_path: str) -> dict:
    """``MP_CARD_STEPS`` steps of ``lm_train_step``: per step the launches,
    global loss, time and a digest of the replicated weights (every leaf
    but the experts); the peak memory; the step-1 gradient (after the
    reduction) saved at ``grads_path``."""
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.train_step import lm_train_step

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    shared = [p for n, p in model.named_parameters()
              if not n.startswith("moe.") or n.endswith("router")]
    res = {"launches": [], "losses": [], "times": [], "digests": []}
    for step in range(MP_CARD_STEPS):
        FA.reset_launch_counts()
        TF.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = lm_train_step(model, opt, tok, tgt, sp_group)
        torch.cuda.synchronize()
        res["times"].append(time.perf_counter() - t0)
        res["losses"].append(float(loss))
        res["launches"].append({**FA.LAUNCHES, "adam": TF.LAUNCHES["adam"]})
        if step == 0:
            _save_tree(grads_path, interop.transformer_to_jax(model,
                                                              grads=True),
                       model.coord())
        res["digests"].append(_digest(shared))
        _progress(f"{grads_path}: step {step} {res['times'][-1]:.4f} s")
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    return res


def mp_cards_ref_main(device: str):
    """One card at tp = 1 running the dp:2,tp:2 case's function: the same
    full weights with ``wqkv`` permuted by ``tp_equivalent_wqkv``, the
    global batch, fused Adam; its step-1 gradient saved (in that
    layout) under ``HVD_TEST_REF_DIR``."""
    from horovod_tpu_torch.models import transformer as TT
    from horovod_tpu_torch.train_step import synthetic_tokens

    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    hvd.init(device=device)
    cfg = TT.TransformerConfig(**SP_CARD_LM, max_seq=MP_CARD_SEQ)
    params = TT.init_params(np.random.RandomState(0), cfg)
    params["layers"]["wqkv"] = TT.tp_equivalent_wqkv(
        params["layers"]["wqkv"], 2)
    model = TT.Transformer(cfg, params=params)
    opt = hvd.DistributedOptimizer(hvd.fused_update.adam(model.parameters(),
                                                         3e-4))
    tok, tgt = synthetic_tokens(MP_CARD_BATCH, MP_CARD_SEQ, cfg.vocab, seed=1)
    out = mp_card_lm(model, opt, tok, tgt, None, os.path.join(
        os.environ["HVD_TEST_REF_DIR"], "ref_tp1.npz"))
    hvd.shutdown()
    print(json.dumps(out))


def mp_cards_main(device: str):
    """``MP_CARD_CASES`` on four cards, the world re-initialized under each
    case's mesh; each rank's step-1 gradient saved under
    ``HVD_TEST_REF_DIR`` (``<case index>_<rank>.npz``)."""
    import torch.distributed as dist

    from horovod_tpu_torch.models import transformer as TT
    from horovod_tpu_torch.parallel.mesh import sequence_groups
    from horovod_tpu_torch.train_step import (lm_optimizer, shard_tokens,
                                              synthetic_tokens)

    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    out = {}
    for i, (name, spec, moe_every) in enumerate(MP_CARD_CASES):
        os.environ.pop("HOROVOD_MESH", None)
        hvd.init(device=device, mesh=spec)
        r = hvd.rank()
        cfg = TT.TransformerConfig(**SP_CARD_LM, max_seq=MP_CARD_SEQ,
                                   moe_every=moe_every)
        batch = synthetic_tokens(MP_CARD_BATCH, MP_CARD_SEQ, cfg.vocab,
                                 seed=1)
        if spec is None:
            group, (d, s) = sequence_groups(2, 2)
            dp, sp = 2, 2
            model = TT.Transformer(cfg, seed=0)
            opt = hvd.DistributedOptimizer(hvd.fused_update.adam(
                model.parameters(), 3e-4))
        else:
            group = None
            model = TT.Transformer(cfg, seed=0, mesh=hvd.data_mesh())
            opt = lm_optimizer(model, hvd.fused_update.adam(
                model.parameters(), 3e-4))
            c = model.coord()
            (d, dp), (s, sp) = c["dp"], c["sp"]
        tok, tgt = (shard_tokens(t, dp, sp, d, s) for t in batch)
        out[name] = mp_card_lm(model, opt, tok, tgt, group, os.path.join(
            os.environ["HVD_TEST_REF_DIR"], f"{i}_{r}.npz"))
        out[name]["coord"] = dict(model.coord(), dp=(d, dp), sp=(s, sp))
        del model, opt
        dist.barrier()
        _reinit_shutdown()
    out["rank"] = r
    print(json.dumps(out))


# ---------------------------------------------------------------------------
# Pipeline parallelism (tests/test_torch_pipeline.py)
# ---------------------------------------------------------------------------

#: the generic pipeline cases: (name, schedule, n_virtual, layers per
#: chunk, remat, broadcast_result); every world size runs each
PIPE_CASES = (("gpipe", "gpipe", 1, 2, False, True),
              ("gpipe remat", "gpipe", 1, 2, True, True),
              ("gpipe unbroadcast", "gpipe", 1, 2, False, False),
              ("interleaved", "interleaved", 2, 1, False, True),
              ("interleaved remat", "interleaved", 2, 1, True, True))
PIPE_M, PIPE_MB, PIPE_F = 4, 2, 3
#: the LM cases: (name, world, mesh axes, config fields, how the place
#: is named: "make" ``make_mesh``, "data" the data mesh of ``init``)
PP_CASES = (
    ("pp2 gpipe", 2, dict(dp=1, pp=2, tp=1, sp=1), {}, "make"),
    ("pp2 interleaved", 2, dict(dp=1, pp=2, tp=1, sp=1),
     dict(n_layers=8, pp_schedule="interleaved", pp_virtual=2), "make"),
    ("pp2 remat", 2, dict(dp=1, pp=2, tp=1, sp=1), dict(pp_remat=True),
     "make"),
    ("dp2 x pp2", 4, dict(dp=2, pp=2, tp=1, sp=1), {}, "make"),
    ("pp2 x tp2", 4, dict(dp=1, pp=2, tp=2, sp=1), {}, "make"),
    ("pp2 x sp2", 4, dict(dp=1, pp=2, tp=1, sp=2), {}, "make"),
    ("HOROVOD_MESH=dp:2,pp:2", 4, dict(dp=2, pp=2, tp=1, sp=1), {},
     "data"),
)


def pipe_inputs(case, nstages: int) -> dict:
    """A generic case's arrays: the layer stack ``w`` (P*V*L, F, F), the
    microbatches ``x`` (M, MB, F) and the loss's cotangent ``c``."""
    _, _, v, per, _, _ = case
    rng = np.random.RandomState(7)
    return {"w": rng.randn(nstages * v * per, PIPE_F, PIPE_F).astype(
                np.float32) * 0.5,
            "x": rng.randn(PIPE_M, PIPE_MB, PIPE_F).astype(np.float32),
            "c": rng.randn(PIPE_M, PIPE_MB, PIPE_F).astype(np.float32)}


def pipe_case(case, hop) -> dict:
    """``sum(out * c)`` through the case's pipeline over ``hop``: the
    output and the gradients of this rank's stage weights and of the
    microbatches."""
    from horovod_tpu_torch.parallel import pipeline as PL

    _, schedule, v, _, remat, bcast = case
    a = pipe_inputs(case, hop.size)
    w = torch.from_numpy(a["w"])
    if schedule == "gpipe":
        w = PL.stage_split({"w": w}, hop.size, hop.index)["w"]
    else:
        w = PL.interleaved_stage_split({"w": w}, hop.size, v,
                                       hop.index)["w"]
    w = w.clone().requires_grad_()
    x = torch.from_numpy(a["x"]).requires_grad_()

    def stage(wp, h):
        for layer in wp:
            h = torch.tanh(h @ layer)
        return h

    out = PL.pipeline(stage, w, x, hop, schedule=schedule, n_virtual=v,
                      broadcast_result=bcast, remat=remat)
    (out * torch.from_numpy(a["c"])).sum().backward()
    return {"out": out.detach(), "dw": w.grad, "dx": x.grad}


def pp_lm_case(case) -> dict:
    """An LM case on this rank: ``MP_STEPS`` SGD steps (lr ``MP_LR``) of
    the small LM through ``lm_train_step`` with ``lm_optimizer`` on the
    rank's block of ``MP_BATCH`` x 64 tokens: the losses, the coordinate,
    the local weights (JAX layout, storage order), the step-1 gradient,
    the hops of the place and of each optimizer group."""
    from horovod_tpu_torch.models import transformer as TT
    from horovod_tpu_torch.parallel.mesh import flat_hop, make_mesh
    from horovod_tpu_torch.train_step import (lm_optimizer, lm_train_step,
                                              shard_tokens)

    _, _, axes, fields, how = case
    cfg = TT.TransformerConfig(**dict(SP_LM, **fields), dtype="float32")
    mesh = hvd.data_mesh() if how == "data" else make_mesh(**axes)
    model = TT.Transformer(cfg, seed=0, device="cpu", mesh=mesh)
    opt = lm_optimizer(model, TF.sgd(model.parameters(), MP_LR))
    coord = model.coord()
    (d, _), (s, _) = coord["dp"], coord["sp"]
    tok, tgt = (shard_tokens(t, axes["dp"], axes["sp"], d, s)
                for t in mp_tokens((None, None, axes, 0, None, False)))
    losses, grads = [], None
    for step in range(MP_STEPS):
        losses.append(float(lm_train_step(model, opt, tok, tgt)))
        if step == 0:
            grads = interop.transformer_to_jax(model, grads=True)
    place = model.place
    hops = dict(zip(("dp", "pp", "tp", "sp", "dp*sp"),
                    (*place[:4], place.data.flat)))
    return {"losses": losses, "coord": coord, "grads": grads,
            "groups": [list(a) for a in opt.axes],
            "group_ranks": [list(flat_hop(o.axis_name).ranks)
                            for o in opt.optimizers],
            "hops": {k: list(h.ranks) for k, h in hops.items()},
            "layers": len(model.layers),
            "weights": interop.transformer_to_jax(model)}


def pp_main(device: str):
    """Every generic case at pp = world size, then each LM case of
    :data:`PP_CASES` of this world size, the data-mesh case after a
    re-init under its ``HOROVOD_MESH``."""
    from horovod_tpu_torch.parallel.mesh import make_mesh

    hvd.init(device=device)
    n, r = hvd.size(), hvd.rank()
    out = {"rank": r}
    hop = make_mesh(pp=n).hops["pp"]
    for case in PIPE_CASES:
        out[case[0]] = pipe_case(case, hop)
    for case in PP_CASES:
        if case[1] != n:
            continue
        if case[4] == "data":
            _reinit_shutdown()
            hvd.init(device=device, mesh=case[2])
        out[case[0]] = pp_lm_case(case)
    _reinit_shutdown()
    print(json.dumps(enc(out)))


#: the bench LM under pipeline parallelism on four cards
#: (test_four_cards_pipeline_lm): (name, make_mesh axes, config fields)
PP_CARD_CASES = (
    ("dp2 x pp2 gpipe", dict(dp=2, pp=2), {}),
    ("pp4 interleaved v3 m4", dict(pp=4),
     dict(pp_schedule="interleaved", pp_virtual=3, pp_microbatches=4)),
    ("pp2 x sp2 gpipe", dict(pp=2, sp=2), {}),
)
PP_CARD_SEQ, PP_CARD_BATCH = 1024, 16


def pp_cards_ref_main(device: str):
    """One card at pp = 1: the bench LM (``SP_CARD_LM``, seq
    ``PP_CARD_SEQ``, batch ``PP_CARD_BATCH``, fused Adam 3e-4) through
    :func:`mp_card_lm`; its step-1 gradient saved as ``ref_pp1.npz``
    under ``HVD_TEST_REF_DIR``."""
    from horovod_tpu_torch.models import transformer as TT
    from horovod_tpu_torch.train_step import synthetic_tokens

    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    hvd.init(device=device)
    cfg = TT.TransformerConfig(**SP_CARD_LM, max_seq=PP_CARD_SEQ)
    model = TT.Transformer(cfg, seed=0)
    opt = hvd.DistributedOptimizer(hvd.fused_update.adam(model.parameters(),
                                                         3e-4))
    tok, tgt = synthetic_tokens(PP_CARD_BATCH, PP_CARD_SEQ, cfg.vocab, seed=1)
    out = mp_card_lm(model, opt, tok, tgt, None, os.path.join(
        os.environ["HVD_TEST_REF_DIR"], "ref_pp1.npz"))
    hvd.shutdown()
    print(json.dumps(out))


def pp_cards_main(device: str):
    """``PP_CARD_CASES`` on four cards, one world, a ``make_mesh`` per
    case: :func:`mp_card_lm` on the model built on it with
    ``lm_optimizer``; each rank's step-1 gradient saved under
    ``HVD_TEST_REF_DIR`` (``pp<case index>_<rank>.npz``)."""
    import torch.distributed as dist

    from horovod_tpu_torch.models import transformer as TT
    from horovod_tpu_torch.parallel.mesh import make_mesh
    from horovod_tpu_torch.train_step import (lm_optimizer, shard_tokens,
                                              synthetic_tokens)

    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    hvd.init(device=device)
    r = hvd.rank()
    out = {"rank": r}
    for i, (name, axes, fields) in enumerate(PP_CARD_CASES):
        cfg = TT.TransformerConfig(**SP_CARD_LM, max_seq=PP_CARD_SEQ,
                                   **fields)
        model = TT.Transformer(cfg, seed=0, mesh=make_mesh(**axes))
        opt = lm_optimizer(model, hvd.fused_update.adam(model.parameters(),
                                                        3e-4))
        c = model.coord()
        (d, dp), (s, sp) = c["dp"], c["sp"]
        tok, tgt = (shard_tokens(t, dp, sp, d, s) for t in synthetic_tokens(
            PP_CARD_BATCH, PP_CARD_SEQ, cfg.vocab, seed=1))
        out[name] = mp_card_lm(model, opt, tok, tgt, None, os.path.join(
            os.environ["HVD_TEST_REF_DIR"], f"pp{i}_{r}.npz"))
        out[name]["coord"] = c
        del model, opt
        dist.barrier()
    _reinit_shutdown()
    print(json.dumps(out))


# ---------------------------------------------------------------------------
# The data plane: named mesh axes (tests/test_torch_mesh.py), hierarchical
# reductions and Adasum (tests/test_torch_data_plane.py)
# ---------------------------------------------------------------------------

MESH_LR, MESH_STEPS = 0.5, 2
#: (zero_stage, overlap, compression) of the dp-axis parity grid
MESH_GRID = tuple((st, ov, comp) for st in (0, 1, 2, 3) for ov in (False, True)
                  for comp in ("none", "int8"))
HIER_SIZES = (16, 10, 1)
HIER_EF_STEPS = 24
#: the two-level world of tests/test_torch_data_plane.py
DP_CROSS, DP_LOCAL = 2, 2
#: leaf shapes of the fused Adasum and ZeRO cases
DP_LEAVES = ((40, 3), (17,), (5, 7), (3,))


class Recorder:
    """Records every ``torch.distributed`` transfer while active: (name,
    payload dtype, payload elements, the group's global ranks)."""

    NAMES = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor",
             "broadcast", "all_to_all_single", "batch_isend_irecv")

    def __init__(self):
        self.calls = []
        self._saved = {}

    def __enter__(self):
        import torch.distributed as dist

        def ranks(group):
            return (list(range(dist.get_world_size())) if group is None
                    else dist.get_process_group_ranks(group))

        def wrap(name, fn):
            def call(*args, **kw):
                if name == "batch_isend_irecv":
                    for op in args[0]:
                        self.calls.append((name, str(op.tensor.dtype),
                                           op.tensor.numel(),
                                           ranks(op.group)))
                else:
                    t = args[1] if name in ("reduce_scatter_tensor",
                                            "all_gather_into_tensor",
                                            "all_to_all_single") \
                        else args[0]
                    self.calls.append((name, str(t.dtype), t.numel(),
                                       ranks(kw.get("group"))))
                return fn(*args, **kw)
            return call

        for name in self.NAMES:
            self._saved[name] = getattr(dist, name)
            setattr(dist, name, wrap(name, self._saved[name]))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, fn in self._saved.items():
            setattr(dist, name, fn)


def _mesh_params(dev):
    return {"b": torch.ones((3, 3), device=dev),
            "w": torch.arange(-10.0, 11.0, device=dev)}


def mesh_grid_run(stage: int, overlap: bool, comp: str, d: int, dev,
                  axis_name=None):
    """``MESH_STEPS`` steps of ``DistributedOptimizer(fused sgd)`` at
    ``stage`` over ``axis_name`` on the reference's fixed integer
    gradients: leaf ``i`` (sorted names) gets ``(i + 1) * (d - 3)``, ``d``
    this rank's dp index (``tests/test_mesh.py:_run_steps_fixed``).
    Returns the weights by name."""
    names = sorted(_mesh_params(dev))
    params = _mesh_params(dev)
    comp_ = hvd.Compression.lookup(comp)
    if stage == 3:
        zp = hvd.zero3_shard_params([(k, params[k]) for k in names],
                                    axis_name=axis_name)
        opt = hvd.DistributedOptimizer(TF.sgd(zp.shards, MESH_LR),
                                       zero_stage=3, overlap=overlap,
                                       compression=comp_,
                                       axis_name=axis_name)
        for _ in range(MESH_STEPS):
            opt.zero_grad()
            full = hvd.zero3_full_params(zp)
            loss = sum((i + 1.0) * (d - 3.0) * full[k].sum()
                       for i, k in enumerate(names))
            loss.backward()
            opt.step()
        full = hvd.zero3_full_params(zp)
        return {k: full[k].detach() for k in names}
    ws = {k: torch.nn.Parameter(params[k]) for k in names}
    opt = hvd.DistributedOptimizer(TF.sgd([ws[k] for k in names], MESH_LR),
                                   zero_stage=stage, overlap=overlap,
                                   compression=comp_, axis_name=axis_name)
    for _ in range(MESH_STEPS):
        for i, k in enumerate(names):
            ws[k].grad = torch.full(ws[k].shape, (i + 1.0) * (d - 3.0),
                                    device=dev)
        opt.step()
    return {k: w.detach() for k, w in ws.items()}


def mesh_main(device: str):
    """The dp-axis parity grid at this world's dp index (a flat world of
    2, or ``HOROVOD_MESH=dp:2,tp:2`` given as a ``DeviceMesh``), and at
    the mesh: the resolver, the dp-scoped entries and the data mesh's
    layouts."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from horovod_tpu_torch.parallel import mesh as M

    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    spec = os.environ.get("HOROVOD_MESH", "")
    r, n = int(os.environ["HOROVOD_RANK"]), int(os.environ["HOROVOD_SIZE"])
    out = {}
    if spec:
        coord = os.environ["HOROVOD_COORDINATOR_ADDR"]
        dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                                world_size=n, rank=r)
        dm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("dp", "tp"))
        hvd.init(device=device, mesh=dm)
    else:
        hvd.init(device=device)
    dev = hvd.device()
    d = M.shard_index()
    out["grid"] = {f"{st}_{ov}_{comp}": mesh_grid_run(st, ov, comp, d, dev)
                   for st, ov, comp in MESH_GRID}
    if spec:
        hops = {a: [list(M.resolve_hops(a).ranks), M.resolve_hops(a).index]
                for a in ("dp", "tp", "hvd")}
        out["hops"] = hops
        out["default"] = str(M.resolve_axis())
        out["sizes"] = [M.data_parallel_size(), M.model_parallel_size(),
                        hvd.data_parallel_size()]
        x = torch.tensor([float(d), float(r)], device=dev)
        out["sum"] = hvd.collectives.allreduce(x, op=hvd.Sum)
        out["avg_world"] = hvd.collectives.allreduce(x, axis_name="hvd")
        out["bcast"] = hvd.collectives.broadcast(x, root_rank=1)
        out["gather"] = hvd.collectives.allgather(x[None])
        out["rs"] = hvd.collectives.reducescatter(torch.arange(4.0, device=dev) * (r + 1))
        out["a2a"] = hvd.collectives.alltoall(torch.arange(4.0, device=dev) + 10 * r)
        built = M.build_data_mesh({"dp": 2, "tp": 2})
        out["built"] = [list(built.axis_names), list(built.shape)]
        os.environ.update({"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
                           "HOROVOD_HIERARCHICAL_LOCAL_SIZE": "2"})
        split = M.build_data_mesh({"dp": 4})
        out["split"] = [list(split.axis_names), list(split.shape),
                        list(split.pair("dpc", "dpl").flat.ranks),
                        split.pair("dpc", "dpl").flat.index]
        os.environ["HOROVOD_HIERARCHICAL_LOCAL_SIZE"] = "3"
        out["nosplit"] = list(M.build_data_mesh({"dp": 4}).axis_names)
        del os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"]
        del os.environ["HOROVOD_HIERARCHICAL_LOCAL_SIZE"]
    if spec:
        _rotate_coordinator()
    hvd.shutdown()
    if spec:
        out["sequence_mesh"] = sequence_mesh_forms(device)
        out["queue_c"] = queue_c_checks(device, r)
        out["lm_without_mesh"] = lm_without_mesh_checks(device)
        os.environ["HOROVOD_MESH"] = spec
    print(json.dumps({k: enc(v) for k, v in out.items()}))


def _rotate_coordinator() -> None:
    """Point ``HOROVOD_COORDINATOR_ADDR`` at a port rank 0 picks now, so
    that the world's next ``init()`` does not meet the store of the one
    about to shut down (call it before ``shutdown``)."""
    import torch.distributed as dist

    port = torch.tensor([held_port() if dist.get_rank() == 0 else 0],
                        device=hvd.device())
    dist.broadcast(port, src=0)
    os.environ["HOROVOD_COORDINATOR_ADDR"] = f"127.0.0.1:{int(port)}"


_HELD_PORTS = []


def held_port() -> int:
    """A port this process holds until it exits (``util.reserve_port``),
    for the store of a world's next ``init()``."""
    from horovod_tpu_torch.common.util import reserve_port

    sock, port = reserve_port()
    _HELD_PORTS.append(sock)
    return port


def _reinit_shutdown() -> None:
    _rotate_coordinator()
    hvd.shutdown()


#: how a data mesh with a sequence axis is named (tests/test_torch_mesh.py)
SEQ_MESH_FORMS = ("knob", "spec", "dict", "build")


def sequence_mesh_forms(device: str) -> dict:
    """``dp:2,sp:2`` named each way of :data:`SEQ_MESH_FORMS`: the mesh's
    axes, this rank's dp and sp hops, the ``("dp", "sp")`` pair that
    ``resolve_hops`` gives, the default axis and the model-parallel
    extent."""
    from horovod_tpu_torch.parallel import mesh as M

    out = {}
    for form in SEQ_MESH_FORMS:
        os.environ["HOROVOD_MESH"] = "dp:2,sp:2" if form == "knob" else ""
        arg = {"spec": "dp:2,sp:2", "dict": {"dp": 2, "sp": 2}}.get(form)
        hvd.init(device=device, mesh=arg)
        mesh = (M.build_data_mesh({"dp": 2, "sp": 2}) if form == "build"
                else hvd.data_mesh())
        pair = mesh.pair("dp", "sp")
        place = mesh.place()
        out[form] = {
            "axes": [list(mesh.axis_names), list(mesh.shape)],
            "dp": [list(mesh.hops["dp"].ranks), mesh.hops["dp"].index],
            "sp": [list(mesh.hops["sp"].ranks), mesh.hops["sp"].index],
            "pair": [list(pair.flat.ranks), pair.flat.index,
                     list(pair.cross.ranks), list(pair.local.ranks)],
            "place_data": list(place.data.flat.ranks),
        }
        if form != "build":
            hops = M.resolve_hops(("dp", "sp"))
            out[form]["resolved"] = [list(hops.flat.ranks), hops.flat.index]
            out[form]["default"] = str(M.resolve_axis())
            out[form]["mp"] = M.model_parallel_size()
        _reinit_shutdown()
    return out


def _refused(fn):
    """The message of the ``HorovodTpuError`` that ``fn()`` raises, or
    ``None`` when it returns."""
    try:
        fn()
    except hvd.HorovodTpuError as exc:
        return str(exc)
    return None


def queue_c_checks(device: str, r: int) -> dict:
    """ROADMAP Queue C's two repairs on this world of 4: under ``dp:2,
    tp:2`` and ``dp:2,sp:2``, with weights seeded differently on every
    rank, ``broadcast_parameters``, ``broadcast_optimizer_state`` and
    ``broadcast_object`` raise and leave the weights alone; under
    ``dp:4`` split (cross 2, local 2), ``alltoall`` over the default
    axis (the pair) and over the named pair raises, and over one axis of
    it runs."""
    from horovod_tpu_torch.parallel import mesh as M

    out = {}
    for spec in ("dp:2,tp:2", "dp:2,sp:2"):
        os.environ["HOROVOD_MESH"] = spec
        hvd.init(device=device)
        torch.manual_seed(1000 + r)
        model = torch.nn.Linear(3, 2)
        opt = TF.adam(model.parameters(), 0.1)
        before = [p.detach().clone() for p in model.parameters()]
        out[spec] = {
            "params": _refused(
                lambda: hvd.broadcast_parameters(model, root_rank=0)),
            "state": _refused(
                lambda: hvd.broadcast_optimizer_state(opt, root_rank=0)),
            "object": _refused(
                lambda: hvd.broadcast_object({"rank": r}, root_rank=0)),
            "skipping": _refused(
                lambda: hvd.broadcast_skipping_shards(opt, root_rank=0)),
            "weights": model.weight.detach(),
            "unchanged": all(torch.equal(a, b) for a, b in
                             zip(before, model.parameters())),
        }
        _reinit_shutdown()
    os.environ.update({"HOROVOD_MESH": "dp:4",
                       "HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
                       "HOROVOD_HIERARCHICAL_LOCAL_SIZE": "2"})
    hvd.init(device=device)
    x = torch.arange(4.0) + 10 * r
    out["alltoall"] = {
        "default_axis": list(M.resolve_axis()),
        "default": _refused(lambda: hvd.collectives.alltoall(x)),
        "pair": _refused(lambda: hvd.collectives.alltoall(x, axis_name=("dpc", "dpl"))),
        "hop_pair": _refused(lambda: hvd.collectives.alltoall(
            x, axis_name=M.resolve_hops(("dpc", "dpl")))),
        "local": hvd.collectives.alltoall(x[:2], axis_name="dpl"),
    }
    _reinit_shutdown()
    del os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"]
    del os.environ["HOROVOD_HIERARCHICAL_LOCAL_SIZE"]
    return out


def lm_without_mesh_checks(device: str) -> dict:
    """Under ``HOROVOD_MESH=dp:2,sp:2``, one step of an LM without a mesh
    on the data mesh's sequence group: ``lm_train_step`` refuses a
    ``DistributedOptimizer`` over the default dp axis (the sp replicas
    would drift apart) and a plain optimizer, and trains with one over
    ``("dp", "sp")``, the world."""
    from horovod_tpu_torch.models import transformer as TT
    from horovod_tpu_torch.train_step import (lm_train_step, shard_tokens,
                                              synthetic_tokens)

    os.environ["HOROVOD_MESH"] = "dp:2,sp:2"
    hvd.init(device=device)
    mesh = hvd.data_mesh()
    d, s = mesh.hops["dp"].index, mesh.hops["sp"].index
    model = TT.Transformer(TT.TransformerConfig(**SP_LM, dtype="float32"),
                           seed=0, device="cpu")
    tok, tgt = (shard_tokens(t, 2, 2, d, s) for t in synthetic_tokens(
        MP_BATCH, SP_LM["max_seq"], SP_LM["vocab"], device="cpu"))

    def step(axis_name=None, wrap=True):
        opt = TF.sgd(model.parameters(), MP_LR)
        if wrap:
            opt = hvd.DistributedOptimizer(opt, axis_name=axis_name)
        return float(lm_train_step(model, opt, tok, tgt,
                                   mesh.hops["sp"].group))

    out = {"default": _refused(step),
           "plain": _refused(lambda: step(wrap=False)),
           "pair": step(("dp", "sp"))}
    _reinit_shutdown()
    return out


def dp_inputs(rank: int) -> dict:
    """Per-rank inputs of the data-plane cases, seeded by rank."""
    rng = np.random.RandomState(800 + rank)
    return {
        "q": rng.standard_normal(2048).astype(np.float32),
        "qr": rng.standard_normal((8, 300)).astype(np.float32),
        "ef": rng.standard_normal(512).astype(np.float32),
        "leaves": [rng.standard_normal(s).astype(np.float32)
                   for s in DP_LEAVES],
        "zint": [rng.randint(-4, 5, s).astype(np.float32)
                 for s in DP_LEAVES],
    }


def _knob(on: bool) -> None:
    os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1" if on else "0"


def _zero_pair_run(stage: int, overlap: bool, comp: str, dev, axis_name,
                   grads, op=hvd.Average):
    """Steps of fused momentum SGD at ``stage`` over ``axis_name`` on the
    per-rank gradients ``grads`` (a list of leaves per step)."""
    init = [np.linspace(-1, 1, int(np.prod(s)), dtype=np.float32).reshape(s)
            for s in DP_LEAVES]
    comp_ = hvd.Compression.lookup(comp)
    names = [f"l{i}" for i in range(len(DP_LEAVES))]
    ws = [torch.nn.Parameter(torch.from_numpy(a).to(dev)) for a in init]
    if stage == 3:
        zp = hvd.zero3_shard_params(list(zip(names, ws)),
                                    axis_name=axis_name)
        opt = hvd.DistributedOptimizer(TF.sgd(zp.shards, 0.5, 0.5),
                                       zero_stage=3, overlap=overlap,
                                       compression=comp_,
                                       axis_name=axis_name)
        for gs in grads:
            opt.zero_grad()
            full = hvd.zero3_full_params(zp)
            sum((full[k] * torch.from_numpy(g).to(dev)).sum()
                for k, g in zip(names, gs)).backward()
            opt.step()
        full = hvd.zero3_full_params(zp)
        return [full[k].detach() for k in names], None
    opt = hvd.DistributedOptimizer(TF.sgd(ws, 0.5, 0.5), zero_stage=stage,
                                   overlap=overlap, compression=comp_,
                                   axis_name=axis_name, op=op)
    for gs in grads:
        for w, g in zip(ws, gs):
            # a copy: the optimizer writes the reduced gradient into it
            w.grad = torch.tensor(g, device=dev)
        opt.step()
    res = None
    if comp != "none":
        res = (list(opt.residuals.values()) if stage == 0
               else opt.residual[0])
    return [w.detach() for w in ws], res


def data_plane_main(device: str):
    """Hierarchical reductions and Adasum over a (cross 2, local 2) pair
    built by ``hierarchical_mesh`` with no data mesh, then (a second
    ``init`` on ``HVD_TEST_COORD2``) under ``HOROVOD_MESH=dp:4`` with the
    hierarchical split, where every default resolves to (dpc, dpl)."""
    from horovod_tpu_torch.ops import adasum as A
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.optim import distributed as D
    from horovod_tpu_torch.parallel import mesh as M

    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    hvd.init(device=device)
    dev = hvd.device()
    r, n = hvd.rank(), hvd.size()
    inp = dp_inputs(r)
    t = {k: torch.from_numpy(v).to(dev) for k, v in inp.items()
         if not isinstance(v, list)}
    pair = M.hierarchical_mesh(DP_LOCAL).pair("cross", "local")
    out = {"pair": [list(pair.cross.ranks), list(pair.local.ranks),
                    list(pair.flat.ranks), pair.flat.index,
                    C.shard_index(pair)]}
    # the knob alone (HOROVOD_HIERARCHICAL_LOCAL_SIZE=2 is set too, no
    # mesh): the default axis stays the flat world
    _knob(True)
    out["alone_axis"] = str(M.resolve_axis())
    out["alone"] = hvd.quantized_allreduce(t["q"], op=hvd.Sum)
    out["alone_world"] = hvd.quantized_allreduce(t["q"], op=hvd.Sum,
                                                 axis_name="hvd")
    out["alone_pair"] = hvd.quantized_allreduce(t["q"], op=hvd.Sum,
                                                axis_name=pair)
    for size in HIER_SIZES:
        x = torch.from_numpy((np.arange(n * size, dtype=np.float32)
                              .reshape(n, size) % 7)[r]).to(dev)
        for op in (hvd.Sum, hvd.Average):
            out[f"hier_{size}_{op}"] = C.hierarchical_allreduce(
                x, pair.local, pair.cross, op=op)
            _knob(False)
            out[f"flat_{size}_{op}"] = hvd.collectives.allreduce(x, op=op,
                                                     axis_name=pair)
            _knob(True)
    h = C.hierarchical_allreduce(torch.full((3, 5), 2.0, dtype=torch.bfloat16,
                                            device=dev),
                                 pair.local, pair.cross, op=hvd.Sum)
    out["bf16"] = [h, str(h.dtype), list(h.shape)]
    xg = torch.from_numpy((np.arange(n * 12, dtype=np.float32)
                           .reshape(n, 12) % 5)[r]).to(dev)
    with Recorder() as rec:
        out["knob_grouped"] = hvd.grouped_allreduce([xg], op=hvd.Sum,
                                                    axis_name=pair)[0]
    out["knob_calls"] = rec.calls
    _knob(False)
    with Recorder() as rec:
        hvd.grouped_allreduce([xg], op=hvd.Sum, axis_name=pair)
    out["flat_calls"] = rec.calls
    _knob(True)
    out["gather"] = C.hierarchical_allgather(
        torch.full((1, 3), float(r), device=dev), pair.local, pair.cross)
    out["gather_default"] = hvd.collectives.allgather(
        torch.full((1, 3), float(r), device=dev), axis_name=pair)
    # the lossy wire: flat over the pair (knob off), cross hop only (on)
    adasum_x = torch.from_numpy(np.random.RandomState(3).randn(n, 32)
                                .astype(np.float32)[r]).to(dev)
    out["hier_adasum"] = hvd.collectives.allreduce(adasum_x, op=hvd.Adasum,
                                       axis_name=pair)
    for on in (False, True):
        _knob(on)
        out[f"q_avg_{on}"] = hvd.quantized_allreduce(t["q"], axis_name=pair)
        for mode in ("int8", "int4"):
            with Recorder() as rec:
                out[f"q_{mode}_{on}"] = list(hvd.quantized_allreduce(
                    t["q"], op=hvd.Sum, with_error=True, mode=mode,
                    axis_name=pair))
            out[f"q_{mode}_{on}_calls"] = rec.calls
            out[f"rs_{mode}_{on}"] = hvd.collectives.reducescatter(
                t["qr"], compression=hvd.Compression.lookup(mode),
                axis_name=pair)
        out[f"rs_none_{on}"] = hvd.collectives.reducescatter(t["qr"], axis_name=pair)
        # error feedback over the pair: the running mean of the reduced
        # gradient converges to the exact mean
        res = [torch.zeros(512, device=dev)]
        steps = []
        for _ in range(HIER_EF_STEPS):
            (red,), res = D.allreduce_gradients_with_feedback(
                [t["ef"]], res, op=hvd.Average, axis_name=pair)
            steps.append(red)
        out[f"ef_{on}"] = steps
    _knob(False)
    out["q_exact"] = hvd.collectives.allreduce(t["q"], axis_name=pair)
    # Adasum: flat over the world, identical vectors, fused leaves with
    # per-leaf segments (f32 and bf16), and over the pair
    ad = torch.from_numpy(np.random.RandomState(0).randn(n, 32)
                          .astype(np.float32)[r]).to(dev)
    out["adasum"] = hvd.collectives.allreduce(ad, op=hvd.Adasum)
    out["adasum_same"] = hvd.collectives.allreduce(torch.full((16,), 3.0, device=dev),
                                       op=hvd.Adasum)
    leaves = [torch.from_numpy(a).to(dev) for a in inp["leaves"]]
    for dt in (torch.float32, torch.bfloat16):
        ls = [x.to(dt) for x in leaves]
        out[f"adasum_leaves_{dt}"] = hvd.grouped_allreduce(ls, op=hvd.Adasum)
        out[f"adasum_leaves_pair_{dt}"] = hvd.grouped_allreduce(
            ls, op=hvd.Adasum, axis_name=pair)
    out["adasum_opt"] = _zero_pair_run(0, False, "none", dev, None,
                                       [inp["leaves"]], op=hvd.Adasum)[0]
    # ZeRO over the pair, two-level, against the flat world
    grads = [[dp_inputs(r)["zint"][i] * (s + 1) for i in range(len(DP_LEAVES))]
             for s in range(3)]
    for stage in (0, 1, 2, 3):
        for ov in (False, True):
            out[f"zero_flat_{stage}_{ov}"] = _zero_pair_run(
                stage, ov, "none", dev, None, grads)[0]
            _knob(True)
            out[f"zero_pair_{stage}_{ov}"] = _zero_pair_run(
                stage, ov, "none", dev, pair, grads)[0]
            _knob(False)
    _knob(True)
    for stage in (0, 1, 2):
        for mode in ("int8", "int4"):
            w, res = _zero_pair_run(stage, False, mode, dev, pair, grads)
            out[f"zero_{mode}_{stage}"] = [w, res]
    hvd.shutdown()

    # the data mesh's own split: HOROVOD_MESH=dp:4 with the knobs
    os.environ["HOROVOD_COORDINATOR_ADDR"] = os.environ["HVD_TEST_COORD2"]
    os.environ["HOROVOD_HIERARCHICAL_LOCAL_SIZE"] = "2"
    hvd.init(device=device, mesh="dp:4")
    axis = M.resolve_axis()
    hops = M.resolve_hops()
    out["mesh_axis"] = list(axis)
    out["mesh_pair"] = [list(hops.cross.ranks), list(hops.local.ranks),
                        list(hops.flat.ranks), M.data_parallel_size()]
    with Recorder() as rec:
        out["mesh_q"] = hvd.quantized_allreduce(t["q"], op=hvd.Sum)
    out["mesh_q_calls"] = rec.calls
    for stage in (0, 2):
        out[f"mesh_zero_{stage}"] = _zero_pair_run(stage, False, "int8", dev,
                                                   None, grads)[0]
    hvd.shutdown()
    print(json.dumps({k: enc(v) for k, v in out.items()}))


#: the four-card data-plane cases (tests/test_torch_cuda.py::
#: test_four_cards_data_plane): (name, init mesh, hierarchical knob,
#: zero_stage, compression, op); the world is re-initialized when the mesh
#: or the knob changes
DP_CARD_CASES = (
    ("flat", None, False, 0, "none", "avg"),
    ("adasum flat", None, False, 0, "none", "adasum"),
    ("hier", "dp:4", True, 0, "none", "avg"),
    ("hier int8 stage 0", "dp:4", True, 0, "int8", "avg"),
    ("hier int4 stage 0", "dp:4", True, 0, "int4", "avg"),
    ("hier int8 stage 2", "dp:4", True, 2, "int8", "avg"),
    ("hier int4 stage 2", "dp:4", True, 2, "int4", "avg"),
    ("adasum hier", "dp:4", True, 0, "none", "adasum"),
    ("dp2 x tp2", "dp:2,tp:2", False, 0, "none", "avg"),
)
DP_CARD_STEPS = 3


def _dp_card_case(device: str, name: str, stage: int, comp: str, op: str,
                  seed: int, want_grad=None) -> dict:
    """``DP_CARD_STEPS`` steps of ResNet-50 (224 px, batch 256, bf16, fused
    momentum SGD) on this rank's batch (seed ``seed``); step 1's
    transfers recorded, and (``want_grad``) its reduced gradient against
    another run's."""
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import batch_norm as BN
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    images, labels = synthetic_batch(256, 224, 1000, seed=seed, device=device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0,
                     device=device)
    opt = hvd.DistributedOptimizer(
        hvd.fused_update.sgd(model.parameters(), 0.1, momentum=0.9),
        compression=hvd.Compression.lookup(comp), zero_stage=stage,
        op=hvd.Adasum if op == "adasum" else hvd.Average)
    res = {"launches": [], "losses": [], "times": [], "digests": [],
           "axis": str(opt.axis_name)}
    grad = None
    for step in range(DP_CARD_STEPS):
        Q.reset_launch_counts()
        TF.reset_launch_counts()
        BN.reset_launch_counts()
        t0 = time.perf_counter()
        if step == 0:
            with Recorder() as rec:
                loss = train_step(model, opt, images, labels)
            res["calls"] = sorted({(c[0], c[1], tuple(c[3]))
                                   for c in rec.calls})
            if stage == 0:
                grad = torch.cat([p.grad.reshape(-1)
                                  for p in model.parameters()])
        else:
            loss = train_step(model, opt, images, labels)
        torch.cuda.synchronize()
        res["times"].append(time.perf_counter() - t0)
        res["losses"].append(float(loss))
        res["launches"].append({**Q.LAUNCHES,
                                "momentum": TF.LAUNCHES["momentum"],
                                **BN.LAUNCHES})
        res["digests"].append(_digest(model.parameters()))
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    if want_grad is not None:
        res["grad_rel_err"] = float((grad - want_grad).norm()
                                    / want_grad.norm())
        res["grad_max_rel"] = float((grad - want_grad).abs().max()
                                    / want_grad.abs().max())
    del model, opt, images, labels
    return res, grad


def dp_cards_main(device: str):
    """The data plane on four cards (``DP_CARD_CASES``), or, at world 2,
    the flat two-rank run the dp:2,tp:2 case is held against.
    Deterministic cuDNN throughout: runs that must agree bit for bit
    pick the same convolution algorithms."""
    from horovod_tpu_torch.parallel import mesh as M

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    os.environ["HOROVOD_HIERARCHICAL_LOCAL_SIZE"] = "2"
    n = int(os.environ["HOROVOD_SIZE"])
    coords = [os.environ["HOROVOD_COORDINATOR_ADDR"]] + \
        os.environ.get("HVD_TEST_COORDS", "").split(",")
    out, flat_grad, current = {}, None, "none"
    cases = DP_CARD_CASES if n == 4 else (("flat2", None, False, 0, "none",
                                           "avg"),)
    for name, mesh, hier, stage, comp, op in cases:
        if (mesh, hier) != current:
            if current != "none":
                hvd.shutdown()
                os.environ["HOROVOD_COORDINATOR_ADDR"] = coords.pop(1)
            os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1" if hier else "0"
            os.environ.pop("HOROVOD_MESH", None)
            hvd.init(device=device, mesh=mesh)
            current = (mesh, hier)
        seed = M.shard_index()          # the dp index: tp columns share data
        _progress(f"[dp cards] rank {hvd.rank()} {name}")
        out[name], grad = _dp_card_case(
            device, name, stage, comp, op, seed,
            want_grad=flat_grad if name == "hier" else None)
        if name == "flat":
            flat_grad = grad
        out[name]["place"] = [hvd.rank(), seed]
        out[name]["hops"] = {
            k: list(h.ranks) for k, h in zip(
                ("cross", "local", "flat"), M.resolve_hops())} \
            if mesh == "dp:4" else list(M.resolve_hops().ranks)
    hvd.shutdown()
    print(json.dumps({"rank": int(os.environ["HOROVOD_RANK"]), **out}))


def local_sgd_main(device: str):
    from _torch_local_sgd_worker import local_sgd_main as run

    run(device)


def ls_cards_main(device: str):
    from _torch_local_sgd_worker import ls_cards_main as run

    run(device)


def eager_main(device: str):
    from _torch_eager_worker import eager_main as run

    run(device)


def eager_cards_main(device: str):
    from _torch_eager_worker import eager_cards_main as run

    run(device)


def eager_training_main(device: str):
    from _torch_eager_training_worker import eager_training_main as run

    run(device)


def eager_training_cards_main(device: str):
    from _torch_eager_training_worker import eager_training_cards_main as run

    run(device)


def eager_kill_cards_main(device: str):
    from _torch_eager_training_worker import eager_kill_cards_main as run

    run(device)


def observability_cards_main(device: str):
    from _torch_eager_training_worker import observability_cards_main as run

    run(device)


def tuning_modes(mode: str):
    """The timeline's and the autotuner's worker modes
    (``_torch_tuning_worker``)."""
    import _torch_tuning_worker as W

    return {"timeline_ticks": W.timeline_ticks_main,
            "autotune_sync": W.autotune_sync_main,
            "tuning_cards": W.tuning_cards_main}[mode]


def perf_modes(mode: str):
    """The perf observatory's worker modes (``_torch_perf_worker``)."""
    import _torch_perf_worker as W

    return {"perf": W.perf_main, "perf_cards": W.perf_cards_main}[mode]


def schedule_main(device: str):
    """The schedule recorder over a real world (``_torch_analysis_worker``)."""
    from _torch_analysis_worker import schedule_main as main_

    main_(device)


def autopilot_rollback_main(device: str):
    from _torch_autopilot_worker import rollback_main

    rollback_main(device)


def health_modes(mode: str):
    """The health plane's and the checkpoint's worker modes
    (``_torch_health_worker``)."""
    import _torch_health_worker as W

    return {"health": W.health_main, "health_culprit": W.culprit_main,
            "checkpoint": W.checkpoint_main,
            "health_cards": W.health_cards_main,
            "health_cards_restore": W.health_cards_restore_main}[mode]


if __name__ == "__main__":
    dev = sys.argv[1] if len(sys.argv) > 1 else "cpu"
    mode = sys.argv[2] if len(sys.argv) > 2 else "collectives"
    {"collectives": main, "resnet": resnet_main, "overlap": overlap_main,
     "zero": zero_main, "zero_resnet": zero_resnet_main,
     "sp": sp_main, "sp_cards": sp_cards_main,
     "sp_cards_ref": sp_cards_ref_main, "mesh": mesh_main, "mp": mp_main,
     "mp_cards": mp_cards_main, "mp_cards_ref": mp_cards_ref_main,
     "pp": pp_main, "pp_cards": pp_cards_main,
     "pp_cards_ref": pp_cards_ref_main,
     "data_plane": data_plane_main, "dp_cards": dp_cards_main,
     "local_sgd": local_sgd_main, "ls_cards": ls_cards_main,
     "eager": eager_main, "eager_cards": eager_cards_main,
     "eager_training": eager_training_main,
     "eager_training_cards": eager_training_cards_main,
     "eager_kill_cards": eager_kill_cards_main,
     "observability_cards": observability_cards_main,
     **{m: lambda d, m=m: health_modes(m)(d)
        for m in ("health", "health_culprit", "checkpoint",
                  "health_cards", "health_cards_restore")},
     **{m: lambda d, m=m: tuning_modes(m)(d)
        for m in ("timeline_ticks", "autotune_sync", "tuning_cards")},
     **{m: lambda d, m=m: perf_modes(m)(d) for m in ("perf", "perf_cards")},
     "autopilot_rollback": autopilot_rollback_main,
     "schedule": schedule_main}[mode](dev)
