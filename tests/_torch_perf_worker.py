"""One rank of the perf observatory's spawned cases (through
``_torch_collectives_worker``'s modes ``perf`` and ``perf_cards``).

``perf`` (a gloo world on the CPU): three steps of
``overlapped_allreduce`` plus a matmul under ``hvd.trace_step`` with
``HOROVOD_PROFILE_EVERY_N_STEPS=1``, each sampled span's analysis joined
before the next; prints the rank, its last analysis and its capture
root.

``perf_cards`` (four cards): the bench ResNet-50 step (224 px, batch
``CARD_BATCH`` per card, bf16, fused momentum SGD) ``PERF_STEPS`` steps
under ``hvd.trace_step`` with the knob at 2, at stage 0 with the overlap
engine and at ZeRO stage 2 with overlap on; per case the last analysis,
the capture count, the goodput ledger's exposed sources and the tuner's
comm signal beside the device gauge."""

import json
import os

import numpy as np
import torch

import horovod_tpu_torch as hvd

#: steps per four-card case (the knob at 2 samples spans 2, 4 and 6)
PERF_STEPS = 8
#: (case, zero stage, overlap, the scope family its comm resolves to)
PERF_CASES = (("stage 0 + overlap", 0, True, "hvd_overlap_"),
              ("stage 2 + overlap", 2, True, "hvd_zero2_"))


def _summary(la: dict) -> dict:
    """What a parent reads of an analysis: the totals, and per step its
    scopes and comm kinds."""
    return {"totals": la["totals"], "op_events": la["op_events"],
            "scopes_resolved": la["scopes_resolved"],
            "captured_step": la.get("captured_step"),
            "steps": [{k: s[k] for k in ("step", "scopes", "comm_by_kind",
                                         "wall_s", "compute_s", "comm_s")}
                       for s in la["steps"]]}


def perf_main(device: str):
    from horovod_tpu_torch.ops import overlap as O
    from horovod_tpu_torch.perf import capture as C

    root = os.environ["HOROVOD_PROFILE_DIR"]
    os.environ["HOROVOD_PROFILE_EVERY_N_STEPS"] = "1"
    hvd.init(device=device)
    r = hvd.rank()
    rng = np.random.RandomState(10 + r)
    x = torch.from_numpy(rng.standard_normal(1 << 16).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((192, 192)).astype(np.float32))
    total = 0.0
    for step in range(3):
        with hvd.trace_step(step=step):
            out, _ = O.overlapped_allreduce(x, op=hvd.Average)
            total += float(out.sum()) + float((w @ w).sum())
        C.drain(120)
    la = C.last_analysis()
    hvd.shutdown()
    print(json.dumps({"rank": r, "root": root, "analysis": _summary(la),
                      "total": total}))


def perf_cards_main(device: str):
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.perf import capture as C
    from horovod_tpu_torch.perf import goodput as GP
    from horovod_tpu_torch.runtime import metrics as M
    from horovod_tpu_torch.runtime import parameter_manager as PM
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    from _torch_eager_training_worker import CARD_BATCH

    root = os.environ["HOROVOD_PROFILE_DIR"]
    os.environ.update(HOROVOD_FUSED_UPDATE="1",
                      HOROVOD_PROFILE_EVERY_N_STEPS="2",
                      HOROVOD_PROFILE_KEEP="2")
    torch.backends.cudnn.benchmark = True
    hvd.init(device=device)
    r = hvd.rank()
    images, labels = synthetic_batch(CARD_BATCH, 224, 1000, seed=100 + r)
    out = {"rank": r}
    for case, stage, overlap, _ in PERF_CASES:
        C.reset()
        GP.reset()
        os.environ["HOROVOD_PROFILE_DIR"] = os.path.join(
            root, case.replace(" ", "").replace("+", "_"))
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0)
        opt = hvd.DistributedOptimizer(
            TF.sgd(model.parameters(), 0.1, momentum=0.9), zero_stage=stage,
            overlap=overlap)
        captures0 = M.counter("hvd_profile_captures_total").total()
        losses = []
        for step in range(1, PERF_STEPS + 1):
            with hvd.trace_step(step=step):
                losses.append(float(train_step(model, opt, images, labels)))
            # each sampled span's analysis lands before the next is due
            C.drain(120)
        snap = M.registry().snapshot()
        gauge = snap["hvd_device_comm_exposed_seconds"]["series"][0]["value"]
        out[case] = {
            "analysis": _summary(C.last_analysis()),
            "captures": M.counter("hvd_profile_captures_total").total()
            - captures0,
            "exposed_source": GP.ledger().snapshot()["exposed_source"],
            "tuner_signal": PM._default_comm_signal(),
            "gauge": gauge, "losses": losses}
        del model, opt
        torch.cuda.empty_cache()
    os.environ["HOROVOD_PROFILE_DIR"] = root
    hvd.shutdown()
    print(json.dumps(out))
