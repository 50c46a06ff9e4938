"""Worker modes of ``tests/test_torch_health.py`` and
``tests/test_torch_checkpoint.py``, spawned through
``_torch_collectives_worker.spawn``:

* ``health`` (four ranks): the stat tap's gathered verdict on fixed
  per-rank gradients; the skip step at stages 0-3 and under int8 error
  feedback; stats on against off at stages 0-3 x overlap x wire; the
  recorded collectives and buffer sizes of one step with the tap;
* ``checkpoint`` (four ranks): stage 2 saved ``all_ranks`` with a
  ring-buddy replica and restored, the host forms, ``resync``;
* ``health_culprit`` (two ranks): ``nan@rank1:grad_buffer*:round2`` on
  the eager wire and ``nan@rank1:grads*`` in-trace, both under the skip
  knob, with the flight and health dumps;
* ``health_cards`` (four cards): the bench ResNet-50 step at stage 2 on
  the eager wire (``nan@rank1:shard_rs*:round3``) and in-trace
  (``nan@rank1:grads*`` for one step) with the skip knob,
  then an ``all_ranks`` save and a restore at world 4;
  ``health_cards_restore`` (two cards) restores the same directory
  through the host forms.

Every rank prints one JSON line.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import checkpoint as ckpt  # noqa: E402
from horovod_tpu_torch.optim import distributed as D  # noqa: E402
from horovod_tpu_torch.optim import fused_update as TF  # noqa: E402
from horovod_tpu_torch.parallel import mesh as PM  # noqa: E402
from horovod_tpu_torch.runtime import faults as F  # noqa: E402
from horovod_tpu_torch.runtime import health as H  # noqa: E402
from horovod_tpu_torch.runtime import metrics as M  # noqa: E402
from _torch_collectives_worker import enc  # noqa: E402

#: the tap's leaves: two float32 groups' worth and one bfloat16 leaf
VERDICT_LEAVES = (("a", (31,), "float32"), ("b", (3, 3), "float32"),
                  ("c", (6,), "bfloat16"))
#: (name, {rank: (leaf, flat index, value)}) of the verdict cases
VERDICT_CASES = (
    ("clean", {}),
    ("nan", {2: ("a", 3, "nan")}),
    ("inf", {1: ("b", 4, "inf"), 3: ("c", 0, "-inf")}),
    ("both", {0: ("a", 0, "nan"), 2: ("b", 8, "inf")}),
)
#: the optimizer cases' leaves (41 elements, padded to 44 at four ranks)
OPT_LEAVES = (("w", (31,)), ("b", (2, 5)))
STEPS = 3
WIRES = ("none", "int8", "int4", "topk")
#: (stage, wire) of the skip cases
SKIP_CASES = ((0, "none"), (1, "none"), (2, "none"), (3, "none"),
              (0, "int8"), (2, "int8"))


def verdict_grads(rank: int, case: str) -> dict:
    """Rank ``rank``'s gradients of verdict case ``case`` (numpy)."""
    rng = np.random.RandomState(900 + rank)
    out = {name: rng.standard_normal(shape).astype(np.float32)
           for name, shape, _ in VERDICT_LEAVES}
    poison = dict(VERDICT_CASES)[case].get(rank)
    if poison is not None:
        leaf, i, v = poison
        out[leaf].reshape(-1)[i] = float(v)
    return out


def _to_torch(name: str, a: np.ndarray, dev):
    dtype = dict((n, d) for n, _, d in VERDICT_LEAVES)[name]
    t = torch.from_numpy(a.copy()).to(dev)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def opt_grads(rank: int, step: int) -> list:
    """Rank ``rank``'s gradients at ``step`` (small integers: every
    reduction exact)."""
    rng = np.random.RandomState(1000 + 10 * rank + step)
    return [rng.randint(-4, 5, s).astype(np.float32) for _, s in OPT_LEAVES]


def _digest(ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _state_tensors(opt) -> list:
    """Every tensor of the optimizer's state: the wrapped optimizer's,
    the shard state, the error-feedback residuals."""
    out = []
    if opt.zero_stage in (1, 2):
        for st in opt.shard_state:
            out += [v for v in st.values() if isinstance(v, torch.Tensor)]
        out += list(opt.residual or [])
    else:
        for st in opt.optimizer.state.values():
            out += [v for v in st.values() if isinstance(v, torch.Tensor)]
        out += list((opt.residuals or {}).values())
    return out


def _build(stage: int, wire: str, overlap: bool, dev):
    ws = [torch.nn.Parameter(torch.from_numpy(
        np.arange(np.prod(s), dtype=np.float32).reshape(s) / 8).to(dev))
        for _, s in OPT_LEAVES]
    comp = getattr(hvd.Compression, wire)
    if stage == 3:
        zp = hvd.zero3_shard_params(
            [(name, w) for (name, _), w in zip(OPT_LEAVES, ws)])
        opt = hvd.DistributedOptimizer(TF.sgd(zp.shards, 0.5, 0.5),
                                       zero_stage=3, compression=comp,
                                       overlap=overlap)
        return opt, zp
    opt = hvd.DistributedOptimizer(TF.sgd(ws, 0.5, 0.5), zero_stage=stage,
                                   compression=comp, overlap=overlap)
    return opt, ws


def _params(opt, obj) -> list:
    if isinstance(obj, D.Zero3Params):
        full = hvd.zero3_full_params(obj)
        return [full[name].detach() for name, _ in OPT_LEAVES]
    return [w.detach() for w in obj]


def _set_grads(opt, obj, gs, dev) -> None:
    if isinstance(obj, D.Zero3Params):
        # stage 3's step reads the summed shard gradients its backward
        # leaves; a loss linear in the weights gives them
        opt.zero_grad()
        full = hvd.zero3_full_params(obj)
        loss = sum((full[name] * torch.from_numpy(g).to(dev)).sum()
                   for (name, _), g in zip(OPT_LEAVES, gs))
        loss.backward()
        return
    for w, g in zip(obj, gs):
        w.grad = torch.from_numpy(g).to(dev)


def run_steps(stage: int, wire: str, overlap: bool, dev, steps=STEPS):
    opt, obj = _build(stage, wire, overlap, dev)
    for k in range(steps):
        _set_grads(opt, obj, opt_grads(hvd.rank(), k), dev)
        opt.step()
    return _digest(_params(opt, obj)), _digest(_state_tensors(opt))


@contextlib.contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def verdict_part(dev) -> dict:
    out = {}
    hop = PM.flat_hop(None)
    for case, _ in VERDICT_CASES:
        g = verdict_grads(hvd.rank(), case)
        ts = [_to_torch(n, g[n], dev) for n, _, _ in VERDICT_LEAVES]
        out[case] = H.tap_gradients(ts, hop).cpu().numpy().tolist()
    return out


def skip_part(dev) -> dict:
    """Per skip case: the digests of the parameters and the optimizer
    state before the poisoned step, after it, and after one more clean
    step; the skipped-step count."""
    out = {}
    with _env(HOROVOD_HEALTH=1, HOROVOD_HEALTH_SKIP_NONFINITE=1):
        for stage, wire in SKIP_CASES:
            H.reset()
            opt, obj = _build(stage, wire, False, dev)
            for k in range(2):
                _set_grads(opt, obj, opt_grads(hvd.rank(), k), dev)
                opt.step()
            before = (_digest(_params(opt, obj)),
                      _digest(_state_tensors(opt)))
            _set_grads(opt, obj, opt_grads(hvd.rank(), 2), dev)
            with _env(HOROVOD_FAULT_SPEC="nan@rank1:grads*"):
                opt.step()
            after = (_digest(_params(opt, obj)),
                     _digest(_state_tensors(opt)))
            _set_grads(opt, obj, opt_grads(hvd.rank(), 3), dev)
            opt.step()
            moved = (_digest(_params(opt, obj)),
                     _digest(_state_tensors(opt)))
            H.flush()
            snap = H.monitor().snapshot()
            out[f"{stage} {wire}"] = {
                "before": before, "after": after, "moved": moved,
                "skipped": snap["skipped_steps"],
                "culprits": snap["culprits"],
                "finite": bool(all(torch.isfinite(p).all()
                                   for p in _params(opt, obj)))}
    return out


def parity_part(dev) -> dict:
    """Stats on against off at stages 0-3 x overlap x wire: the
    digests of the weights and the state after ``STEPS`` steps."""
    out = {}
    for stage in (0, 1, 2, 3):
        for overlap in (False, True):
            for wire in WIRES:
                key = f"{stage} {int(overlap)} {wire}"
                with _env(HOROVOD_HEALTH=1):
                    on = run_steps(stage, wire, overlap, dev)
                with _env(HOROVOD_HEALTH=0):
                    off = run_steps(stage, wire, overlap, dev)
                out[key] = [on, off]
    return out


class _Record(torch.utils._python_dispatch.TorchDispatchMode):
    """The element counts of every tensor an operation returns."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        res = func(*args, **(kwargs or {}))
        for r in (res if isinstance(res, (list, tuple)) else (res,)):
            if isinstance(r, torch.Tensor):
                self.sizes.append(r.numel())
        return res


def record_part(dev) -> dict:
    """One stage-2 step and one stage-0 step with the tap off and on:
    the collectives each issues (kind, elements) and the largest tensor
    an operation returns, against the padded fused length."""
    out = {}
    calls = []
    real = {k: getattr(dist, k) for k in
            ("all_reduce", "all_gather_into_tensor",
             "reduce_scatter_tensor", "broadcast")}

    def wrap(kind):
        def fn(t, *a, **k):
            src = a[0] if kind in ("all_gather_into_tensor",
                                   "reduce_scatter_tensor") else t
            calls.append((kind, int(src.numel())))
            return real[kind](t, *a, **k)
        return fn

    for stage in (0, 2):
        for flag in ("0", "1"):
            opt, obj = _build(stage, "none", False, dev)
            _set_grads(opt, obj, opt_grads(hvd.rank(), 0), dev)
            calls.clear()
            rec = _Record()
            for k in real:
                setattr(dist, k, wrap(k))
            try:
                with _env(HOROVOD_HEALTH=flag), rec:
                    opt.step()
            finally:
                for k, f in real.items():
                    setattr(dist, k, f)
            out[f"{stage} {flag}"] = {"calls": list(calls),
                                      "max_numel": max(rec.sizes),
                                      "padded": opt.layout.padded[0]
                                      if stage else 44}
    return out


def checkpoint_part(dev, path: str) -> dict:
    """Stage 2 at world 4: an ``all_ranks`` save of the shard state with
    the default two replicas, rank 1's shard corrupted and restored from
    its replica, then the host forms saved by rank 0; ``resync`` of a
    tree whose parameters differ by rank."""
    out = {}
    r = hvd.rank()
    opt, ws = _build(2, "none", False, dev)
    for k in range(2):
        _set_grads(opt, ws, opt_grads(r, k), dev)
        opt.step()
    tree = {"params": [w.detach() for w in ws],
            "opt": opt.sharded_state(), "step": 2}
    ckpt.save(path, tree, 2, all_ranks=True, verdict="healthy")
    step_dir = os.path.join(path, "step_2")
    out["replica_dirs"] = sorted(d for d in os.listdir(step_dir)
                                 if d.startswith("rep_"))
    dist.barrier()
    if r == 1:
        with open(os.path.join(step_dir, "rank_1", "tree.pkl"), "ab") as f:
            f.write(b"CORRUPTION")
    dist.barrier()
    back = ckpt.restore(path, 2, all_ranks=True)
    dist.barrier()
    out["restored_equal"] = bool(
        all(torch.equal(a, b.to(a.device)) for a, b in
            zip(_state_tensors(opt)[:1], [back["opt"].inner[0]["trace"]]))
        and all(torch.equal(w.detach().cpu(), b)
                for w, b in zip(ws, back["params"])))
    out["quarantined"] = sorted(d for d in os.listdir(step_dir)
                                if d.endswith(".corrupt"))
    out["shard_digest"] = _digest([opt.shard_state[0]["trace"]])
    # the host form (gathered at world 4) and the full parameters
    host = D.sharded_state_to_host(opt)
    zp = hvd.zero3_shard_params(
        [(name, w) for (name, _), w in zip(OPT_LEAVES, ws)])
    zhost = D.zero3_params_to_host(zp)
    if r == 0:
        ckpt.save(path, {"opt": host, "zp": zhost}, 3)
    out["full_trace"] = host.inner[0]["trace"].tolist()
    out["zero3_shard"] = zp.shards[0].detach().cpu().tolist()
    # resync: every rank's params differ, the shard state must not move
    mine = {"p": torch.full((3,), float(r), device=dev),
            "opt": opt.sharded_state(), "n": r}
    got = ckpt.resync(mine)
    out["resync"] = [got["p"].cpu().tolist(), got["n"],
                     got["opt"] is mine["opt"]]
    dist.barrier()
    return out


def health_main(device: str):
    hvd.init(device=device)
    dev = hvd.device()
    out = {"rank": hvd.rank()}
    with _env(HOROVOD_HEALTH=1):
        out["verdict"] = verdict_part(dev)
    out["skip"] = skip_part(dev)
    out["parity"] = parity_part(dev)
    out["record"] = record_part(dev)
    hvd.shutdown()
    print(json.dumps(enc(out)))


def checkpoint_main(device: str):
    hvd.init(device=device)
    out = {"rank": hvd.rank(),
           "checkpoint": checkpoint_part(hvd.device(),
                                         os.environ["HVD_TEST_CKPT"])}
    hvd.shutdown()
    print(json.dumps(enc(out)))


def culprit_main(device: str):
    """The acceptance scenario on two ranks, eager then in-trace, under
    ``HOROVOD_HEALTH=1`` and the skip knob (set by the caller), six
    steps each of ``w -= 0.1 * mean(g)`` with ``g = 0.5 + rank``."""
    hvd.init(device=device)
    dev = hvd.device()
    r = hvd.rank()
    out = {"rank": r}
    for regime, spec in (("eager", "nan@rank1:grad_buffer*:round2"),
                         ("intrace", "nan@rank1:grads*")):
        H.reset()
        M.counter("hvd_nonfinite_total").reset()
        w = torch.nn.Parameter(torch.ones(8, device=dev))
        opt = hvd.DistributedOptimizer(TF.sgd([w], 0.1),
                                       eager=regime == "eager")
        for step in range(6):
            # the in-trace rule has no round: it poisons while set
            spec_now = spec if regime == "eager" or step == 2 else ""
            with _env(HOROVOD_FAULT_SPEC=spec_now):
                w.grad = torch.full((8,), 0.5 + r, device=dev)
                opt.step()
        H.flush()
        snap = M.metrics()["metrics"]
        nf = snap.get("hvd_nonfinite_total", {}).get("series", [])
        alerts = snap.get("hvd_health_alert", {}).get("series", [])
        out[regime] = {
            "w": w.detach().cpu().tolist(),
            "nonfinite": sorted((s["labels"].get("rank"),
                                 s["labels"].get("group"), s["value"])
                                for s in nf),
            "alert": any(s["labels"].get("reason") == "nonfinite"
                         and s["value"] == 1 for s in alerts),
            "skipped": H.monitor().snapshot()["skipped_steps"]}
        F._data_cache = ("", [])
    out["flight"] = hvd.dump_flight_recorder()
    hvd.shutdown()
    print(json.dumps(enc(out)))


# ---------------------------------------------------------------------------
# Four cards: the bench ResNet-50 step
# ---------------------------------------------------------------------------

CARD_STEPS = 8
CARD_BATCH = 256


def _card_case(eager: bool, poison, images, labels,
               steps: int = CARD_STEPS):
    """Stage 2 of the bench step under the health knobs (set by the
    caller), eager or in-trace; ``poison(step)`` is the fault spec of
    each step.  Per step the time and the loss; the rank's nonfinite
    series, skipped steps, and the final weights' finiteness and
    digest."""
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.train_step import train_step

    H.reset()
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0)
    opt = hvd.DistributedOptimizer(
        TF.sgd(model.parameters(), 0.1, momentum=0.9), zero_stage=2,
        eager=eager)
    times, losses = [], []
    for step in range(steps):
        with _env(HOROVOD_FAULT_SPEC=poison(step)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(train_step(model, opt, images, labels)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    F._data_cache = ("", [])
    H.flush()
    snap = M.metrics()["metrics"]
    nf = snap.get("hvd_nonfinite_total", {}).get("series", [])
    params = [p.detach() for p in model.parameters()]
    return model, opt, {
        "times": times, "losses": losses,
        "nonfinite": sorted((s["labels"].get("rank"),
                             s["labels"].get("group"), s["value"])
                            for s in nf),
        "skipped": H.monitor().snapshot()["skipped_steps"],
        "finite": bool(all(torch.isfinite(p).all() for p in params)),
        "digest": _digest(params)}


def _trace_digest(host) -> str:
    """The digest of a host form's full momentum trace, trimmed to the
    parameters' true size (the padding depends on the world)."""
    total = sum(host.layout.sizes[0])
    return hashlib.sha256(np.ascontiguousarray(
        host.inner[0]["trace"][:total]).tobytes()).hexdigest()


def health_cards_main(device: str):
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    hvd.init(device=device)
    r = hvd.rank()
    images, labels = synthetic_batch(CARD_BATCH, 224, 1000, seed=100 + r)
    out = {"rank": r}
    for flag in ("0", "1", "0", "1"):  # eager stage 2, health off / on
        with _env(HOROVOD_HEALTH=flag):
            _, _, res = _card_case(True, lambda s: "", images, labels, 6)
        out.setdefault(f"eager clean health={flag}", []).extend(
            res["times"][1:])
    with _env(HOROVOD_HEALTH=1, HOROVOD_HEALTH_SKIP_NONFINITE=1):
        # stage 2's eager wire names its bucket reduce-scatters
        # shard_rs.<dtype>.<padded>.<k>of<K> (grad_buffer.* is stage 0's)
        _, _, out["eager"] = _card_case(
            True, lambda s: "nan@rank1:shard_rs*:round3", images, labels)
        model, opt, out["intrace"] = _card_case(
            False, lambda s: "nan@rank1:grads*" if s == 3 else "", images,
            labels)
    path = os.environ["HVD_TEST_CKPT"]
    state = {"model": model.state_dict(), "opt": opt.sharded_state(),
             "step": CARD_STEPS}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save(path, state, CARD_STEPS, all_ranks=True)
    out["save_s"] = time.perf_counter() - t0
    host = D.sharded_state_to_host(opt)
    if r == 0:
        ckpt.save(path, {"model": model.state_dict(), "opt": host},
                  CARD_STEPS + 1)
    out["full_trace_digest"] = _trace_digest(host)
    dist.barrier()
    t0 = time.perf_counter()
    back = ckpt.restore(path, CARD_STEPS, all_ranks=True)
    out["restore_s"] = time.perf_counter() - t0
    fresh = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=1)
    fresh.load_state_dict(back["model"])
    fopt = hvd.DistributedOptimizer(
        TF.sgd(fresh.parameters(), 0.1, momentum=0.9), zero_stage=2)
    fopt.load_sharded_state(back["opt"])
    out["restored_equal"] = bool(
        all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                              fresh.state_dict().values()))
        and torch.equal(opt.shard_state[0]["trace"],
                        fopt.shard_state[0]["trace"]))
    out["resumed_losses"] = [float(train_step(fresh, fopt, images, labels))
                             for _ in range(2)]
    hvd.shutdown()
    print(json.dumps(enc(out)))


def health_cards_restore_main(device: str):
    """World 2: the world-4 host forms re-cut through
    ``sharded_state_from_host``, gathered again, and one step."""
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    hvd.init(device=device)
    r = hvd.rank()
    path = os.environ["HVD_TEST_CKPT"]
    back = ckpt.restore(path, CARD_STEPS + 1)
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=1)
    model.load_state_dict(back["model"])
    opt = hvd.DistributedOptimizer(
        TF.sgd(model.parameters(), 0.1, momentum=0.9), zero_stage=2)
    opt.load_sharded_state(D.sharded_state_from_host(back["opt"]))
    host = D.sharded_state_to_host(opt)
    out = {"rank": r, "full_trace_digest": _trace_digest(host),
           "saved_trace_digest": _trace_digest(back["opt"])}
    images, labels = synthetic_batch(CARD_BATCH, 224, 1000, seed=100 + r)
    out["loss"] = float(train_step(model, opt, images, labels))
    hvd.shutdown()
    print(json.dumps(enc(out)))
