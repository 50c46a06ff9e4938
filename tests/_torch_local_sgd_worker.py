"""The local-SGD cases of one rank (``tests/_torch_collectives_worker.py``
modes ``local_sgd`` and ``ls_cards``).

``local_sgd`` (a gloo world of 4, :func:`local_sgd_main`) runs
``LocalSGD`` over the ``(cross 2, local 2)`` pair of
``hierarchical_mesh(2)``, then under ``HOROVOD_MESH=dp:4`` with the
hierarchical split, on inputs :func:`ls_inputs` seeds by rank so the
parent recomputes every case with the JAX package
(``tests/test_torch_local_sgd.py``).  ``ls_cards`` (:func:`ls_cards_main`)
trains ResNet-50 at full width under ``LocalSGD`` on four cards
(``tests/test_torch_cuda.py::test_four_cards_local_sgd_resnet50``)."""

import os
import pickle
import statistics
import time
import warnings

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import interop
from horovod_tpu_torch.optim import fused_update as TF
from horovod_tpu_torch.parallel import mesh as M

from _torch_collectives_worker import Recorder, _digest, _progress, enc

LS_CROSS, LS_LOCAL = 2, 2
LS_N = LS_CROSS * LS_LOCAL
LS_ENVS = ("HOROVOD_LOCAL_SGD_H", "HOROVOD_OUTER_LR",
           "HOROVOD_OUTER_MOMENTUM", "HOROVOD_LOCAL_SGD_COMPRESSION",
           "HOROVOD_COMPRESSION", "HOROVOD_MESH",
           "HOROVOD_HIERARCHICAL_ALLREDUCE",
           "HOROVOD_HIERARCHICAL_LOCAL_SIZE")
#: the lossy outer wires, and the stages they run at
LS_LOSSY = tuple((mode, st) for mode in ("int8", "int4", "topk")
                 for st in (0, 2))
#: the lossy cases' leaves (JAX flatten order: sorted names)
LS_LOSSY_LEAVES = (("b", (300,)), ("w", (40, 13)))
#: the whole-slice SmallCNN cases: (zero_stage, outer wire)
LS_CNN = ((0, "none"), (2, "none"), (0, "int8"), (2, "int8"))
LS_CNN_BATCH, LS_CNN_SIZE, LS_CNN_CLASSES, LS_CNN_STEPS = 8, 32, 10, 4


def ls_inputs(r: int) -> dict:
    """Per-rank inputs of the lossy cases: gradients and initial weights
    on a grid of 2^-8 (the inner steps at lr 0.25 are exact, so both
    packages reach the outer sync with the same pseudo-gradients)."""
    rng = np.random.RandomState(900 + r)
    grid = np.random.RandomState(901)     # the same weights on every rank

    def q(a):
        return (np.round(a * 256) / 256).astype(np.float32)

    return {"init": [q(grid.standard_normal(s)) for _, s in LS_LOSSY_LEAVES],
            "grads": [[q(rng.standard_normal(s) * (1 + r)) for _, s in
                       LS_LOSSY_LEAVES] for _ in range(2)]}


def _params(dev, arrays):
    return [torch.nn.Parameter(torch.from_numpy(np.array(a)).to(dev))
            for a in arrays]


def h1_case(dev, stage: int, overlap: bool, local_sgd: bool):
    """``tests/test_local_sgd.py::_train`` over the flat world: params
    b (3, 3) ones and w arange(-8, 8), ``optax.sgd(0.1)``, two steps of
    gradients ``(i + 1) * (r - 1)``."""
    r = hvd.rank()
    ws = _params(dev, [np.ones((3, 3), np.float32),
                       np.arange(-8.0, 8.0, dtype=np.float32)])
    inner = TF.sgd(ws, 0.1)
    if local_sgd:
        opt = hvd.LocalSGD(inner, axis_name="hvd", zero_stage=stage,
                           overlap=overlap)
        assert not opt.active and opt.outer is None
    else:
        opt = hvd.DistributedOptimizer(inner, axis_name="hvd",
                                       zero_stage=stage, overlap=overlap)
    for _ in range(2):
        for i, w in enumerate(ws):
            w.grad = torch.full(w.shape, (i + 1.0) * (r - 1.0), device=dev)
        opt.step()
    return [w.detach() for w in ws]


def diloco_case(dev, axis):
    """``tests/test_local_sgd.py::test_diloco_outer_math_matches_reference``
    at (cross 2, local 2): inner ``sgd(0.25)``, outer lr and momentum
    0.5, H = 2, 4 steps, gradient ``r + 1`` (r the flat index)."""
    r = hvd.rank()
    w = torch.nn.Parameter(torch.arange(8.0, device=dev))
    opt = hvd.LocalSGD(TF.sgd([w], 0.25), h=2, axis_name=axis,
                       outer_lr=0.5, outer_momentum=0.5,
                       compression=hvd.Compression.none, zero_stage=0)
    windows = []
    for s in range(1, 5):
        w.grad = torch.full((8,), r + 1.0, device=dev)
        opt.step()
        windows.append(opt.inner_steps)
        opt.maybe_outer_sync(s)
        windows.append(opt.inner_steps)
    return w.detach(), windows


def stage_case(dev, axis, stage: int, steps: int = 4, h: int = 2):
    """``tests/test_local_sgd.py::_run_ls_stage``: b full(8, 2.0) and w
    arange(16), inner ``sgd(0.25)``, outer 0.5 / 0.5, gradient ``(i + 1)
    * (r + 1)``; stage 3 through ``zero3_full_params`` over the local
    hop.  Returns the full weights [b, w]."""
    r = hvd.rank()
    names = ["b", "w"]
    ws = _params(dev, [np.full(8, 2.0, np.float32),
                       np.arange(16.0, dtype=np.float32)])
    kw = dict(h=h, axis_name=axis, outer_lr=0.5, outer_momentum=0.5,
              compression=hvd.Compression.none, zero_stage=stage)
    if stage == 3:
        local = axis.local if isinstance(axis, M.HopPair) else axis[1]
        zp = hvd.zero3_shard_params(list(zip(names, ws)), axis_name=local)
        opt = hvd.LocalSGD(TF.sgd(zp.shards, 0.25), **kw)
        for s in range(1, steps + 1):
            opt.zero_grad()
            full = hvd.zero3_full_params(zp)
            sum((i + 1.0) * (r + 1.0) * full[k].sum()
                for i, k in enumerate(names)).backward()
            opt.step()
            opt.maybe_outer_sync(s)
        full = hvd.zero3_full_params(zp)
        return [full[k].detach() for k in names], opt.outer_state_bytes()
    opt = hvd.LocalSGD(TF.sgd(ws, 0.25), **kw)
    for s in range(1, steps + 1):
        for i, w in enumerate(ws):
            w.grad = torch.full(w.shape, (i + 1.0) * (r + 1.0), device=dev)
        opt.step()
        opt.maybe_outer_sync(s)
    return [w.detach() for w in ws], opt.outer_state_bytes()


def lossy_case(dev, pair, mode: str, stage: int) -> dict:
    """Two inner steps (``sgd(0.25)``, exact on the inputs' grid) and one
    outer sync on the ``mode`` wire with error feedback, outer lr and
    momentum 0.5 (exact products: only the wire differs between the
    packages).  Returns the weights, the residual (its local shard at
    stage 2) and the pseudo-gradient."""
    inp = ls_inputs(hvd.rank())
    ws = _params(dev, inp["init"])
    opt = hvd.LocalSGD(TF.sgd(ws, 0.25), h=2, axis_name=pair, outer_lr=0.5,
                       outer_momentum=0.5,
                       compression=hvd.Compression.lookup(mode),
                       zero_stage=stage)
    for s, gs in enumerate(inp["grads"], 1):
        for w, g in zip(ws, gs):
            w.grad = torch.from_numpy(g.copy()).to(dev)
        opt.step()
        if s == 2:
            delta = opt.outer.anchor[0] - opt._current_bufs()[0]
        opt.maybe_outer_sync(s)
    return {"w": [w.detach() for w in ws], "res": opt.outer.residual[0],
            "delta": delta, "vel": opt.outer.velocity[0]}


def calls_case(dev, pair, stage: int, mode: str) -> dict:
    """Two float32 leaves and one bfloat16 (two dtype groups): the
    ``torch.distributed`` calls of two inner steps and of the sync."""
    r = hvd.rank()
    ws = [torch.nn.Parameter(torch.linspace(-1, 1, 24, device=dev)),
          torch.nn.Parameter(torch.ones(7, 3, device=dev)),
          torch.nn.Parameter(torch.ones(10, device=dev,
                                        dtype=torch.bfloat16))]
    opt = hvd.LocalSGD(torch.optim.SGD(ws, lr=0.125), h=2, axis_name=pair,
                       zero_stage=stage,
                       compression=hvd.Compression.lookup(mode))
    out = {}
    with Recorder() as rec:
        for _ in range(2):
            for w in ws:
                w.grad = torch.full(w.shape, r + 1.0, device=dev,
                                    dtype=w.dtype)
            opt.step()
    out["inner"] = rec.calls
    with Recorder() as rec:
        opt.maybe_outer_sync(2)
    out["sync"] = rec.calls
    out["w"] = [w.detach().float() for w in ws]
    return out


def _cnn_model(dev, init):
    from horovod_tpu_torch.models.mnist import SmallCNN

    m = SmallCNN(num_classes=LS_CNN_CLASSES, device=dev)
    interop.cnn_from_flax(init["params"], init["batch_stats"], m)
    return m


def cnn_case(dev, pair, init, stage: int, comp: str) -> dict:
    """The slice: SmallCNN through ``train_step`` and
    ``maybe_outer_sync``, fused momentum SGD (0.1, 0.9), H = 2, 4 steps,
    this rank's batch (seed 100 + rank)."""
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    m = _cnn_model(dev, init)
    opt = hvd.LocalSGD(TF.sgd(m.parameters(), 0.1, momentum=0.9), h=2,
                       axis_name=pair, zero_stage=stage,
                       compression=hvd.Compression.lookup(comp))
    x, y = synthetic_batch(LS_CNN_BATCH, LS_CNN_SIZE, LS_CNN_CLASSES,
                           seed=100 + hvd.rank(), device=dev)
    losses, gl1, dmax = [], [], 0.0
    for s in range(1, LS_CNN_STEPS + 1):
        losses.append(float(train_step(m, opt, x, y)))
        gl1.append(float(sum(p.grad.abs().sum() for p in m.parameters())))
        if opt.should_sync(s):
            dmax = max(dmax, float((opt.outer.anchor[0]
                                    - opt._current_bufs()[0]).abs().max()))
        opt.maybe_outer_sync(s)
    params, stats = interop.cnn_to_flax(m)
    return {"losses": losses, "params": params, "stats": stats,
            "dmax": dmax, "grad_l1": gl1, "model": m, "opt": opt}


def interop_cases(dev, pair, init) -> dict:
    """``local_sgd_to_jax`` / ``local_sgd_from_jax``: the JAX package's
    end state of the stage-0 and stage-2 int8 SmallCNN runs loaded here
    and written back out; and this package's state out and into a fresh
    optimizer."""
    out = {}
    for stage in (0, 2):
        run = cnn_case(dev, pair, init, stage, "int8")
        m2 = _cnn_model(dev, init)
        opt2 = hvd.LocalSGD(TF.sgd(m2.parameters(), 0.1, momentum=0.9),
                            h=2, axis_name=pair, zero_stage=stage,
                            compression=hvd.Compression.int8)
        state = interop.local_sgd_to_jax(run["model"], run["opt"])
        interop.local_sgd_from_jax(state, m2, opt2)
        a, b = run["opt"], opt2
        same = [torch.equal(x, y) for x, y in zip(
            a.outer.anchor + a.outer.velocity + a.outer.residual,
            b.outer.anchor + b.outer.velocity + b.outer.residual)]
        inner_a = [st["trace"] for st in (
            a.shard_state if stage else a.state.values())]
        inner_b = [st["trace"] for st in (
            b.shard_state if stage else b.state.values())]
        same += [torch.equal(x, y) for x, y in zip(inner_a, inner_b)]
        out[f"port_round_trip_{stage}"] = [all(same),
                                           b.inner_steps == a.inner_steps]
        jax_state = init.get(f"jax_state_{stage}")
        if jax_state is not None:
            m3 = _cnn_model(dev, init)
            opt3 = hvd.LocalSGD(TF.sgd(m3.parameters(), 0.1, momentum=0.9),
                                h=2, axis_name=pair, zero_stage=stage,
                                compression=hvd.Compression.int8)
            interop.local_sgd_from_jax(jax_state[hvd.rank()], m3, opt3)
            back = interop.local_sgd_to_jax(m3, opt3)
            out[f"jax_round_trip_{stage}"] = _state_np(back)
    return out


def _state_np(state) -> dict:
    o = state.outer
    return {"anchor": o.anchor, "velocity": o.velocity,
            "residual": o.residual, "inner": state.inner_state,
            "inner_steps": int(state.inner_steps), "kind": o.kind}


def refusal_cases(dev) -> dict:
    """The single-slice warning (no split: ``HOROVOD_LOCAL_SIZE`` is the
    world) and the refusal without a pair (a split from
    ``HOROVOD_HIERARCHICAL_LOCAL_SIZE=2`` but no pair to run on, where
    the eager regime would run but ``init()`` built no (cross, local)
    groups for it: ``HOROVOD_LOCAL_SGD_H`` was not set then)."""
    from horovod_tpu_torch.optim import local_sgd as LS

    out = {}
    w = torch.nn.Parameter(torch.ones(4, device=dev))
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        opt = hvd.LocalSGD(TF.sgd([w], 0.1), h=4,
                           compression=hvd.Compression.none)
    out["single_slice"] = [str(x.message) for x in got]
    out["degenerate"] = [opt.degenerate, opt.outer is None,
                         opt.should_sync(4), LS.local_sgd_topology()]
    w.grad = torch.full((4,), float(hvd.rank()), device=dev)
    opt.step()
    opt.outer_sync()
    out["degenerate_w"] = w.detach()
    os.environ["HOROVOD_HIERARCHICAL_LOCAL_SIZE"] = str(LS_LOCAL)
    out["topology"] = list(LS.local_sgd_topology())
    try:
        hvd.LocalSGD(TF.sgd([w], 0.1), h=4)
        out["no_pair"] = None
    except hvd.HorovodTpuError as exc:
        out["no_pair"] = str(exc)
    del os.environ["HOROVOD_HIERARCHICAL_LOCAL_SIZE"]
    return out


def local_sgd_main(device: str):
    for e in LS_ENVS:
        os.environ.pop(e, None)
    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    with open(os.environ["HVD_TEST_LS_INIT"], "rb") as f:
        init = pickle.load(f)
    hvd.init(device=device)
    dev = hvd.device()
    out = {"refusals": refusal_cases(dev)}
    for stage in (0, 1):
        for ov in (False, True):
            out[f"h1_{stage}_{ov}"] = [
                h1_case(dev, stage, ov, True),
                h1_case(dev, stage, ov, False)]
    pair = M.hierarchical_mesh(LS_LOCAL).pair("cross",
                                                              "local")
    out["diloco"] = diloco_case(dev, pair)
    for stage in (0, 1, 2, 3):
        out[f"stage_{stage}"] = stage_case(dev, pair, stage)
    for mode, stage in LS_LOSSY:
        out[f"lossy_{mode}_{stage}"] = lossy_case(dev, pair, mode, stage)
    for stage in (0, 2):
        for mode in ("none", "int8"):
            out[f"calls_{stage}_{mode}"] = calls_case(dev, pair, stage, mode)
    for stage, comp in LS_CNN:
        run = cnn_case(dev, pair, init, stage, comp)
        del run["model"], run["opt"]
        out[f"cnn_{stage}_{comp}"] = run
    out["interop"] = interop_cases(dev, pair, init)
    out["pair"] = [list(pair.cross.ranks), list(pair.local.ranks)]
    from _torch_collectives_worker import _rotate_coordinator

    _rotate_coordinator()
    hvd.shutdown()

    # the data mesh's (dpc, dpl) split is the default pair
    os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1"
    os.environ["HOROVOD_HIERARCHICAL_LOCAL_SIZE"] = str(LS_LOCAL)
    hvd.init(device=device, mesh=f"dp:{LS_N}")
    opt = hvd.LocalSGD(TF.sgd([torch.nn.Parameter(torch.ones(2))], 0.1),
                       h=2)
    out["mesh_axis"] = [list(M.resolve_axis()),
                        str(opt.inner_axis), opt.degenerate]
    out["mesh_diloco"] = diloco_case(dev, None)
    out["mesh_stage_2"] = stage_case(dev, None, 2)
    hvd.shutdown()
    print(__import__("json").dumps({k: enc(v) for k, v in out.items()}))


# ---------------------------------------------------------------------------
# Four cards: ResNet-50 at full width under LocalSGD
# ---------------------------------------------------------------------------

#: (name, H, zero_stage, outer wire); H = 1 is DistributedOptimizer
LS_CARD_CASES = (("H1", 1, 0, "none"), ("stage 0 none", 2, 0, "none"),
                 ("stage 0 int8", 2, 0, "int8"),
                 ("stage 2 int8", 2, 2, "int8"))
LS_CARD_STEPS, LS_CARD_H = 6, 2


def _ls_card_case(device: str, name: str, h: int, stage: int, comp: str,
                  seed: int, sync: bool) -> dict:
    """``LS_CARD_STEPS`` steps of ResNet-50 (224 px, batch 256 per card,
    bf16, fused momentum SGD) under ``LocalSGD`` (``sync``: the
    synchronous two-level ``DistributedOptimizer`` on the same wire) on
    this rank's batch; per step the transfers, the launches, the inner
    and the sync time, and the digest of the weights."""
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import quantization as Q
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    images, labels = synthetic_batch(256, 224, 1000, seed=seed, device=device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0,
                     device=device)
    inner = hvd.fused_update.sgd(model.parameters(), 0.1, momentum=0.9)
    wire = hvd.Compression.lookup(comp)
    if sync:
        opt = hvd.DistributedOptimizer(inner, compression=wire,
                                       zero_stage=stage)
    else:
        opt = hvd.LocalSGD(inner, h=h, compression=wire, zero_stage=stage)
    res = {"losses": [], "inner_s": [], "sync_s": [], "calls": [],
           "sync_calls": [], "launches": [], "digests": []}
    for step in range(1, LS_CARD_STEPS + 1):
        Q.reset_launch_counts()
        TF.reset_launch_counts()
        with Recorder() as rec:
            t0 = time.perf_counter()
            loss = train_step(model, opt, images, labels)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        res["calls"].append([list(c) for c in rec.calls])
        res["inner_s"].append(t1 - t0)
        if not sync and opt.should_sync(step):
            with Recorder() as rec:
                t1 = time.perf_counter()
                opt.maybe_outer_sync(step)
                torch.cuda.synchronize()
                res["sync_s"].append(time.perf_counter() - t1)
            res["sync_calls"].append([(c[0], c[1], c[2], c[3])
                                      for c in rec.calls])
        res["losses"].append(float(loss))
        res["launches"].append({**Q.LAUNCHES,
                                "momentum": TF.LAUNCHES["momentum"]})
        res["digests"].append(_digest(model.parameters()))
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["outer_bytes"] = 0 if sync else opt.outer_state_bytes()
    res["state_bytes"] = opt.state_bytes()
    res["median_inner_s"] = statistics.median(res["inner_s"][1:])
    if res["sync_s"]:
        res["median_sync_s"] = statistics.median(res["sync_s"])
    del model, opt, images, labels
    return res


def ls_cards_main(device: str):
    """``LS_CARD_CASES`` on four cards under ``HOROVOD_MESH=dp:4`` with
    the hierarchical split (cross 2, local 2), each beside the
    synchronous two-level ``DistributedOptimizer`` on the same wire.
    Deterministic cuDNN: the H = 1 case must equal the synchronous run
    bit for bit."""
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    for e in LS_ENVS:
        os.environ.pop(e, None)
    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1"
    os.environ["HOROVOD_HIERARCHICAL_LOCAL_SIZE"] = str(LS_LOCAL)
    hvd.init(device=device, mesh=f"dp:{LS_N}")
    hops = M.resolve_hops()
    out = {"rank": hvd.rank(), "cross": list(hops.cross.ranks),
           "local": list(hops.local.ranks)}
    seed = M.shard_index()
    for name, h, stage, comp in LS_CARD_CASES:
        _progress(f"[ls cards] rank {hvd.rank()} {name}")
        out[name] = _ls_card_case(device, name, h, stage, comp, seed,
                                  sync=False)
        key = f"sync {stage} {comp}"
        if key not in out:
            _progress(f"[ls cards] rank {hvd.rank()} {key}")
            out[key] = _ls_card_case(device, key, 1, stage, comp, seed,
                                     sync=True)
    hvd.shutdown()
    print(__import__("json").dumps(enc(out)))
