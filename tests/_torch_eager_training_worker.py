"""One rank of ``tests/test_torch_eager_training.py``: the training paths
that ride the eager plane, spawned through
``tests/_torch_collectives_worker.py``'s mode ``eager_training``.

* ``DistributedOptimizer(..., eager=True)`` at stages 0-3 beside the
  in-trace stages on dyadic data (:data:`ZERO_KINDS`, fused tail on and
  off), the reference's replicated-optax problem (``tests/
  test_zero23.py:676-716``) at every stage, stage 3's resident shard,
  and per step the calls of the fused tail's multi-leaf wrappers (B1-B3
  on the card) and of the codec wrappers on the int8 wire (B4/B5)
  beside the negotiated responses that carried them;
* at four ranks, the eager stages again under
  ``HOROVOD_CONTROL_FANOUT=2`` (the hierarchical control plane), and
  local SGD's eager regime (cross 2 x local 2, H = 2, no pair) beside
  the in-trace ``LocalSGD`` over the ``(dpc, dpl)`` pair of
  ``HOROVOD_MESH=dp:4``, with every transfer's group recorded.

Each rank prints one JSON line."""

import hashlib
import json
import os
import statistics

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import quantization as Q
from horovod_tpu_torch.optim import fused_update as TF

from _torch_collectives_worker import (ZERO_KINDS, ZERO_LEAVES, Recorder,
                                       _reinit_shutdown, enc, zero_inputs,
                                       zero_run)

#: the reference's replicated problem: w, b and the target
OPTAX_STEPS = 3
LS_STEPS, LS_H = 4, 2
LS_HYPER = dict(lr=0.5, momentum=0.5, outer_lr=0.5, outer_momentum=0.5)


def optax_problem(dev):
    w = torch.linspace(-1.0, 1.0, 5, device=dev)
    b = torch.zeros(3, device=dev)
    target = torch.arange(1.0, 6.0, device=dev) / 4.0
    return w, b, target


def optax_case(stage: int, dev) -> dict:
    """``OPTAX_STEPS`` Adam(0.1) steps at ``stage`` on the eager wire:
    ``g_w = 2 (w - target)``, ``g_b = 1`` on every rank (at stage 3
    through ``zero3_full_params`` and autograd).  The final weights and,
    at stage 3, the resident shard's element count."""
    w0, b0, target = optax_problem(dev)
    w = torch.nn.Parameter(w0.clone())
    b = torch.nn.Parameter(b0.clone())
    out = {}
    if stage == 3:
        zp = hvd.zero3_shard_params([("w", w), ("b", b)])
        out["resident"] = sum(int(s.numel()) for s in zp.shards)
        opt = hvd.DistributedOptimizer(TF.adam(zp.shards, 0.1),
                                       zero_stage=3, eager=True)
        for _ in range(OPTAX_STEPS):
            opt.zero_grad()
            full = hvd.zero3_full_params(zp, eager=True)
            loss = ((full["w"] - target) ** 2).sum() + full["b"].sum()
            loss.backward()
            opt.step()
        full = hvd.zero3_full_params(zp, eager=True)
        out["w"], out["b"] = full["w"].detach(), full["b"].detach()
        return out
    opt = hvd.DistributedOptimizer(TF.adam([w, b], 0.1), zero_stage=stage,
                                   eager=True)
    for _ in range(OPTAX_STEPS):
        w.grad = 2.0 * (w.detach() - target)
        b.grad = torch.ones_like(b)
        opt.step()
    out["w"], out["b"] = w.detach(), b.detach()
    return out


class Counting:
    """Counts the calls of the fused tail's multi-leaf wrappers and the
    codec wrappers while active (on the card each call is one launch of
    B1-B3 or B4-B7; on the CPU each runs the plain version)."""

    NAMES = ((TF, "sgd_update"), (TF, "momentum_update"),
             (TF, "adam_update"), (TF, "sgd_update_multi"),
             (TF, "momentum_update_multi"), (TF, "adam_update_multi"),
             (Q, "quantize_values"),
             (Q, "dequantize_values"), (Q, "quantize_pack4_values"),
             (Q, "unpack_dequantize4_values"))

    def __init__(self):
        self.calls = {name: 0 for _, name in self.NAMES}
        self._saved = []

    def __enter__(self):
        for mod, name in self.NAMES:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))

            def call(*a, _fn=fn, _name=name, **k):
                self.calls[_name] += 1
                return _fn(*a, **k)
            setattr(mod, name, call)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def launch_case(stage: int, comp: str, dev) -> dict:
    """One fused momentum step of ``zero_run``'s problem at ``stage`` on
    the ``comp`` eager wire: the wrapper calls and the negotiated
    responses of that step (at stage 3 the forward's gathers and the
    backward's scatters included)."""
    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    init, grads = zero_inputs(hvd.rank(), hvd.size(), "dyadic")
    ws = [torch.nn.Parameter(torch.from_numpy(a).to(dev)) for a in init]
    gs = [torch.from_numpy(g).to(dev) for g in grads[0]]
    if stage == 3:
        zp = hvd.zero3_shard_params(
            [(name, w) for (name, _), w in zip(ZERO_LEAVES, ws)])
        params = zp.shards
    else:
        params = ws
    opt = hvd.DistributedOptimizer(TF.sgd(params, 0.5, 0.5),
                                   zero_stage=stage, eager=True)
    bg = hvd.common.basics._state.background
    before = bg.responses
    os.environ["HOROVOD_COMPRESSION"] = comp
    try:
        with Counting() as c:
            if stage == 3:
                full = hvd.zero3_full_params(zp, eager=True)
                sum((full[name] * g).sum()
                    for (name, _), g in zip(ZERO_LEAVES, gs)).backward()
            else:
                for w, g in zip(ws, gs):
                    w.grad = g.clone()
            opt.step()
    finally:
        os.environ["HOROVOD_COMPRESSION"] = "none"
    return {"calls": c.calls, "responses": bg.responses - before}


def one_response_calls(kind: str, dev) -> dict:
    """The wrapper calls of one negotiated int8 ``kind`` response."""
    n = hvd.size()
    os.environ["HOROVOD_COMPRESSION"] = "int8"
    try:
        with Counting() as c:
            getattr(hvd, kind)(torch.ones(64 * n, device=dev),
                               name=f"one.{kind}")
    finally:
        os.environ["HOROVOD_COMPRESSION"] = "none"
    return c.calls


def stage_cases(dev) -> dict:
    """Every kind, stage and tail, in-trace and eager, dyadic data."""
    out = {}
    for fused in ("0", "1"):
        os.environ["HOROVOD_FUSED_UPDATE"] = fused
        for kind in ZERO_KINDS:
            for stage in (0, 1, 2, 3):
                key = f"{kind}_{stage}_{fused}"
                out["trace_" + key] = zero_run(kind, stage, "dyadic", dev)[0]
                ws, opt = zero_run(kind, stage, "dyadic", dev, eager=True)
                out["eager_" + key] = ws
                if stage in (1, 2):
                    out["bytes_" + key] = opt.state_bytes()
    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    return out


def _ls_model(dev):
    rng = np.random.RandomState(900)
    return [torch.nn.Parameter(torch.from_numpy(
        rng.randint(-8, 9, s).astype(np.float32)).to(dev))
        for s in ((6, 4), (9,))]


def _ls_grads(step: int, dev):
    rng = np.random.RandomState(1000 + 10 * hvd.rank() + step)
    return [torch.from_numpy(rng.randint(-4, 5, s).astype(np.float32)).to(dev)
            for s in ((6, 4), (9,))]


def local_sgd_run(dev, record: bool) -> dict:
    """``LS_STEPS`` momentum steps under ``LocalSGD(h=LS_H)`` with the
    default axis (the pair under ``HOROVOD_MESH=dp:4``, none in the flat
    world), an outer sync at every boundary; per step the groups of the
    transfers (inner step, then outer sync)."""
    ws = _ls_model(dev)
    opt = hvd.LocalSGD(TF.sgd(ws, LS_HYPER["lr"], LS_HYPER["momentum"]),
                       h=LS_H, outer_lr=LS_HYPER["outer_lr"],
                       outer_momentum=LS_HYPER["outer_momentum"],
                       compression=hvd.Compression.none)
    groups = []
    for step in range(1, LS_STEPS + 1):
        for w, g in zip(ws, _ls_grads(step, dev)):
            w.grad = g
        with Recorder() as inner:
            opt.step()
        with Recorder() as outer:
            synced = opt.maybe_outer_sync(step)
        groups.append({"inner": sorted({tuple(c[3]) for c in inner.calls}),
                       "outer": sorted({tuple(c[3]) for c in outer.calls}),
                       "synced": synced})
    return {"w": [w.detach() for w in ws], "eager": opt.eager,
            "groups": groups if record else None}


def eager_training_main(device: str):
    hvd.init(device=device)
    dev = hvd.device()
    r, n = hvd.rank(), hvd.size()
    out = {"rank": r}
    out["stages"] = stage_cases(dev)
    out["optax"] = {s: optax_case(s, dev) for s in (0, 1, 2, 3)}
    out["launches"] = {f"{s}_{c}": launch_case(s, c, dev)
                       for s in (0, 1, 2, 3) for c in ("none", "int8")}
    out["one_response"] = {k: one_response_calls(k, dev)
                           for k in ("reducescatter", "allreduce")}
    if n == 4:
        _reinit_shutdown()
        os.environ["HOROVOD_CONTROL_FANOUT"] = "2"
        hvd.init(device=device)
        out["hier"] = stage_cases(dev)
        ctl = hvd.common.basics._state.background.controller
        out["hier_slice"] = [ctl._hier.slice_size, ctl._hier.n_slices]
        os.environ.pop("HOROVOD_CONTROL_FANOUT")
        # local SGD: in-trace over the (dpc, dpl) pair, then eager
        _reinit_shutdown()
        os.environ.update({"HOROVOD_LOCAL_SGD_H": str(LS_H),
                           "HOROVOD_MESH": "dp:4",
                           "HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
                           "HOROVOD_HIERARCHICAL_LOCAL_SIZE": "2"})
        hvd.init(device=device)
        out["ls_trace"] = local_sgd_run(dev, record=False)
        _reinit_shutdown()
        for k in ("HOROVOD_MESH", "HOROVOD_HIERARCHICAL_ALLREDUCE",
                  "HOROVOD_HIERARCHICAL_LOCAL_SIZE"):
            os.environ.pop(k)
        os.environ.update({"HOROVOD_LOCAL_SIZE": "2",
                           "HOROVOD_LOCAL_RANK": str(r % 2),
                           "HOROVOD_CROSS_SIZE": "2",
                           "HOROVOD_CROSS_RANK": str(r // 2)})
        hvd.init(device=device)
        out["ls_eager"] = local_sgd_run(dev, record=True)
        for stage in (1, 2, 3):
            try:
                hvd.LocalSGD(TF.sgd([torch.nn.Parameter(
                    torch.zeros(4, device=dev))], 0.1), h=LS_H,
                    zero_stage=stage)
                out[f"ls_refuse_{stage}"] = None
            except hvd.HorovodTpuError as exc:
                out[f"ls_refuse_{stage}"] = str(exc)
    hvd.shutdown()
    print(json.dumps({k: enc(v) for k, v in out.items()}))


# ---------------------------------------------------------------------------
# Four cards (tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------

#: steps per case: CARD_WARM of warm-up, then the timed ones (an even
#: count: local SGD's last step is an outer sync)
CARD_BATCH, CARD_STEPS, CARD_WARM, KILL_AFTER = 256, 12, 2, 3
#: the case that runs the eager plane's rounds through the pure-Python
#: codec (the module without its native one)
PY_CODEC_CASE = "eager 2 none, Python codec"
#: (case, regime, zero stage, wire); each eager case beside the in-trace
#: run of its stage on the none wire
CARD_CASES = (("intrace 2", "intrace", 2, "none"),
              ("eager 2 none", "eager", 2, "none"),
              (PY_CODEC_CASE, "eager", 2, "none"),
              ("eager 2 int8", "eager", 2, "int8"),
              ("intrace 3", "intrace", 3, "none"),
              ("eager 3 none", "eager", 3, "none"),
              ("eager 3 int8", "eager", 3, "int8"))
HB_CARD = {"HOROVOD_HEARTBEAT_INTERVAL": "0.2",
           "HOROVOD_HEARTBEAT_TIMEOUT_SECONDS": "2"}


def _flat_weights(model, zp=None, eager=False):
    if zp is not None:
        full = hvd.zero3_full_params(zp, eager=eager)
        return torch.cat([full[k].detach().reshape(-1) for k in zp.names])
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def _card_run(case, regime, stage, wire, images, labels, refs, ls=False):
    """``CARD_STEPS`` bench steps of ResNet-50 (224 px, bf16, fused
    momentum SGD) at ``stage`` (``ls``: under ``LocalSGD(h=2)`` with the
    default axis, an outer sync at every boundary): per step its time,
    loss, B1/B4/B5 launches; the median, least and most time of the
    steps after ``CARD_WARM`` (under ``ls`` also the median of the inner
    and of the sync steps apart); the peak memory, the optimizer-state
    bytes, the step-1 weights' relative L2 distance from ``refs``' run
    and the median of the process runtime's rounds in this case."""
    import time

    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.runtime import wire as W
    from horovod_tpu_torch.train_step import train_step, zero3_train_step

    os.environ["HOROVOD_COMPRESSION"] = wire
    rt = hvd.common.basics._state.background
    rounds0 = len(rt.round_seconds) if rt is not None else 0
    W.native_loaded()
    loaded = W._native
    if case == PY_CODEC_CASE:
        W._native = None
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0)
    zp = None
    if ls:
        opt = hvd.LocalSGD(TF.sgd(model.parameters(), 0.1, momentum=0.9),
                           h=2, compression=hvd.Compression.none)
    elif stage == 3:
        zp = hvd.zero3_shard_params(model)
        opt = hvd.DistributedOptimizer(TF.sgd(zp.shards, 0.1, momentum=0.9),
                                       zero_stage=3,
                                       eager=regime == "eager")
    else:
        opt = hvd.DistributedOptimizer(
            TF.sgd(model.parameters(), 0.1, momentum=0.9), zero_stage=stage,
            eager=regime == "eager")
    res = {"step_s": [], "losses": [], "launches": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for step in range(1, CARD_STEPS + 1):
        TF.reset_launch_counts()
        Q.reset_launch_counts()
        t0 = time.perf_counter()
        if zp is not None:
            loss = zero3_train_step(model, zp, opt, images, labels)
        else:
            loss = train_step(model, opt, images, labels)
            if ls:
                opt.maybe_outer_sync(step)
        torch.cuda.synchronize()
        res["step_s"].append(time.perf_counter() - t0)
        res["losses"].append(float(loss))
        res["launches"].append({"B1": TF.LAUNCHES["momentum"],
                                "B4": Q.LAUNCHES["quantize"],
                                "B5": Q.LAUNCHES["dequantize"]})
        if step == 1:
            flat = _flat_weights(model, zp, regime == "eager")
            key = case.split()[0] + (" " + str(stage) if not ls else "")
            if regime == "intrace":
                refs[key] = flat
            ref = refs[key.replace("eager", "intrace")]
            res["step1_rel_l2"] = float((flat - ref).norm() / ref.norm())
            del flat
    # after the last step (an outer sync under ls): every rank the same
    res["digest"] = hashlib.sha256(
        _flat_weights(model, zp, regime == "eager").cpu().numpy()
        .tobytes()).hexdigest()
    W._native = loaded
    timed = res["step_s"][CARD_WARM:]
    res["median_step_s"] = statistics.median(timed)
    res["min_step_s"], res["max_step_s"] = min(timed), max(timed)
    if ls:
        # steps CARD_WARM + 1, ...: the even ones end with an outer sync
        res["median_inner_s"] = statistics.median(timed[::2])
        res["median_sync_s"] = statistics.median(timed[1::2])
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["state_bytes"] = (opt.outer_state_bytes() + opt.inner.state_bytes()
                          if ls else opt.state_bytes())
    rt = hvd.common.basics._state.background
    rounds = list(rt.round_seconds)[rounds0:] if rt is not None else []
    res["rounds"] = len(rounds)
    res["round_ms"] = statistics.median(rounds) * 1e3 if rounds else None
    if ls:
        res["eager"] = opt.eager
    os.environ["HOROVOD_COMPRESSION"] = "none"
    del model, opt, zp
    torch.cuda.empty_cache()
    return res


def eager_training_cards_main(device: str):
    """ResNet-50 at full width on four cards: ``CARD_CASES`` (the eager
    regime at stages 2 and 3 on the none and int8 wires, beside the
    in-trace stage), then local SGD (H = 2, (cross 2, local 2)) in-trace
    over the ``(dpc, dpl)`` pair of ``HOROVOD_MESH=dp:4`` and in its eager
    regime under ``HOROVOD_LOCAL_SIZE=2`` (each rank on its own card)."""
    from horovod_tpu_torch.train_step import synthetic_batch

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    hvd.init(device=device)
    r = hvd.rank()
    images, labels = synthetic_batch(CARD_BATCH, 224, 1000, seed=100 + r)
    out, refs = {"rank": r}, {}
    for case, regime, stage, wire in CARD_CASES:
        out[case] = _card_run(case, regime, stage, wire, images, labels,
                              refs)
    _reinit_shutdown()
    os.environ.update({"HOROVOD_LOCAL_SGD_H": "2", "HOROVOD_MESH": "dp:4",
                       "HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
                       "HOROVOD_HIERARCHICAL_LOCAL_SIZE": "2"})
    hvd.init(device=device)
    out["ls intrace"] = _card_run("intrace", "intrace", 0, "none", images,
                                  labels, refs, ls=True)
    _reinit_shutdown()
    for k in ("HOROVOD_MESH", "HOROVOD_HIERARCHICAL_ALLREDUCE",
              "HOROVOD_HIERARCHICAL_LOCAL_SIZE"):
        os.environ.pop(k)
    os.environ.update({"HOROVOD_LOCAL_SIZE": "2",
                       "HOROVOD_LOCAL_RANK": str(r % 2),
                       "HOROVOD_CROSS_SIZE": "2",
                       "HOROVOD_CROSS_RANK": str(r // 2)})
    # HOROVOD_LOCAL_RANK would pick card r % 2: each rank keeps its own
    hvd.init(device=f"{device}:{r}" if device == "cuda" else device)
    out["ls eager"] = _card_run("eager", "eager", 0, "none", images, labels,
                                refs, ls=True)
    del refs
    hvd.shutdown()
    print(json.dumps(enc(out)))


def eager_kill_cards_main(device: str):
    """The eager regime at stage 2 on four cards with liveness at 0.2 s /
    2 s: rank 3 SIGKILLs itself after step ``KILL_AFTER``; ranks 0-2 take
    one more step, which must raise ``RanksDownError`` naming ``[3]``.
    Every rank prints one JSON line (rank 3 before it dies)."""
    import signal
    import time

    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    os.environ.update(HB_CARD)
    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    hvd.init(device=device)
    r = hvd.rank()
    images, labels = synthetic_batch(CARD_BATCH, 224, 1000, seed=100 + r)
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0)
    opt = hvd.DistributedOptimizer(
        TF.sgd(model.parameters(), 0.1, momentum=0.9), zero_stage=2,
        eager=True)
    for step in range(1, KILL_AFTER + 2):
        if r == 3 and step == KILL_AFTER + 1:
            torch.cuda.synchronize()
            time.sleep(0.5)
            print(json.dumps({"rank": r, "killed_at": time.time()}),
                  flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        try:
            train_step(model, opt, images, labels)
            torch.cuda.synchronize()
        except hvd.RanksDownError as exc:
            print(json.dumps({"rank": r, "raised_at": time.time(),
                              "step": step, "ranks": list(exc.ranks),
                              "msg": str(exc)}), flush=True)
            os._exit(0)
    print(json.dumps({"rank": r, "no_error": True}), flush=True)
    os._exit(0)


def spawn_kill(n: int, device: str, mode: str, timeout: float = 600.0):
    """``n`` ranks of ``mode`` on a held port, one of which is expected to
    die: per rank ``(returncode, last JSON line or None, stderr tail)``."""
    import subprocess
    import sys

    from horovod_tpu_torch.common.util import reserve_port

    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_torch_collectives_worker.py")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    held, port = reserve_port()
    procs = []
    try:
        for rank in range(n):
            env = dict(os.environ)
            env.update({
                "HOROVOD_RANK": str(rank), "HOROVOD_SIZE": str(n),
                "HOROVOD_LOCAL_RANK": str(rank),
                "HOROVOD_LOCAL_SIZE": str(n),
                "HOROVOD_COORDINATOR_ADDR": f"127.0.0.1:{port}",
                "PYTHONPATH": repo + os.pathsep + env.get("PYTHONPATH", "")})
            procs.append(subprocess.Popen(
                [sys.executable, worker, device, mode], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = []
        for p in procs:
            so, se = p.communicate(timeout=timeout)
            lines = so.strip().splitlines()
            outs.append((p.returncode,
                         json.loads(lines[-1]) if lines else None,
                         se[-3000:]))
        return outs
    finally:
        held.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
