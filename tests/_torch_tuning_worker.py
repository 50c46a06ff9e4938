"""Worker modes of the timeline's and the autotuner's spawned tests
(through ``_torch_collectives_worker``'s ``spawn``): each prints one JSON
line.

``timeline_ticks``: rank 1 sleeps ``HVD_TEST_STRAGGLE`` seconds (default
1) before one allreduce named ``tickme`` (``tests/test_timeline.py``); rank 0's
``HOROVOD_TIMELINE`` trace then carries both ranks' ready ticks.
``autotune_sync``: 60 allreduces under ``HOROVOD_AUTOTUNE``
(``tests/test_multiprocess.py::test_autotune_param_sync_2proc``); each
rank reports whether its knobs changed, the rounds and values of every
proposal its controller applied, and the knobs each op's response
executed under.
"""

import json
import os
import time

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.ops import eager as E

TUNED = ("fusion_threshold", "cycle_time_ms", "overlap_chunks",
         "bucket_compression", "hierarchical_allreduce")


def knobs() -> list:
    return [_config.get(k) for k in TUNED]


def timeline_ticks_main(device: str):
    hvd.init(device=device)
    r = hvd.rank()
    if r == 1:
        time.sleep(STRAGGLE_S)
    out = hvd.allreduce(torch.ones(3), op=hvd.Sum, name="tickme")
    assert torch.equal(out, torch.full((3,), float(hvd.size()))), out
    hvd.shutdown()
    print(json.dumps({"rank": r, "completed": True}))


def autotune_sync_main(device: str):
    hvd.init(device=device)
    r = hvd.rank()
    rt = E._runtime()
    # The knobs each op ran under, read by the background thread as the
    # op's response executes: a proposal is applied on the receipt of
    # its round's response list, before that round's responses execute,
    # so this read is ordered with the round on every rank.  (A read on
    # this thread after the op returns is not: the background thread may
    # already have joined the next round and applied its proposal.)
    ran_under = {}
    execute = rt._execute

    def recording_execute(resp):
        now = knobs()
        for name in resp.names:
            ran_under[name] = now
        execute(resp)

    rt._execute = recording_execute
    start = knobs()
    changed = False
    # every rank submits the same ops (SPMD): leaving early on a change
    # would shut down while peers still have pending tensors
    for i in range(60):
        out = hvd.allreduce(torch.ones(1024), op=hvd.Sum, name=f"t{i}")
        assert torch.equal(out, torch.full((1024,), 2.0))
        changed = changed or knobs() != start
    seen = [ran_under[f"t{i}"] for i in range(60)]
    res = {"rank": r, "changed": changed,
           "tunes": [[rnd, t] for rnd, t in rt.controller.tunes],
           "pm": None if rt.pm is None else rt.pm._samples_seen,
           "pinned": bool(rt.pm is not None and rt.pm._pinned)}
    hvd.shutdown()
    # the knobs each op ran under: a rank that applied a proposal a
    # round late would show it at another op here
    res["knobs"] = seen
    print(json.dumps(res))


#: the four-card scenario: steps per phase, warm-up steps left out of
#: the medians, the straggling step (1-based) and rank 1's sleep
CARD_STEPS, CARD_WARM, STRAGGLE_STEP = 10, 2, 5
STRAGGLE_S = float(os.environ.get("HVD_TEST_STRAGGLE", "1.0"))
CARD_BATCH = 256


def _card_phase(device, images, labels, trace: str = "",
                straggle: bool = False, tune: bool = False) -> dict:
    """One ``init()`` .. ``shutdown()`` of the bench ResNet-50 step (224
    px, bf16, fused momentum SGD) under ``DistributedOptimizer(eager=
    True)`` at ZeRO stage 2: ``trace`` is ``HOROVOD_TIMELINE`` (rank 0
    writes it), ``straggle`` makes rank 1 sleep ``STRAGGLE_S`` before
    step ``STRAGGLE_STEP``, ``tune`` runs under ``HOROVOD_AUTOTUNE`` and
    reads this rank's tuned knobs after every step (then a barrier, so
    no rank starts the next step's rounds before every rank read).  Per
    step its time, loss and B1 launches; the median step over the steps
    after ``CARD_WARM`` but the straggling one."""
    import statistics

    import torch.distributed as dist

    from _torch_collectives_worker import _rotate_coordinator
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import train_step

    os.environ["HOROVOD_TIMELINE"] = trace
    os.environ["HOROVOD_AUTOTUNE"] = "1" if tune else "0"
    hvd.init(device=device)
    r = hvd.rank()
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0,
                     device=hvd.device())
    opt = hvd.DistributedOptimizer(
        TF.sgd(model.parameters(), 0.1, momentum=0.9), zero_stage=2,
        eager=True)
    res = {"step_s": [], "losses": [], "B1": [], "knobs": []}
    for step in range(1, CARD_STEPS + 1):
        if straggle and step == STRAGGLE_STEP and r == 1:
            time.sleep(STRAGGLE_S)
        TF.reset_launch_counts()
        t0 = time.perf_counter()
        loss = train_step(model, opt, images, labels)
        torch.cuda.synchronize()
        res["step_s"].append(time.perf_counter() - t0)
        res["losses"].append(float(loss))
        res["B1"].append(TF.LAUNCHES["momentum"])
        if tune:
            res["knobs"].append(knobs())
            dist.barrier()
    timed = [s for i, s in enumerate(res["step_s"], 1)
             if i > CARD_WARM and not (straggle and i == STRAGGLE_STEP)]
    res["median_step_s"] = statistics.median(timed)
    rt = E._runtime()
    if tune:
        res["tunes"] = [[rnd, t] for rnd, t in rt.controller.tunes]
        res["samples"] = None if rt.pm is None else rt.pm._samples_seen
        res["pinned"] = bool(rt.pm is not None and rt.pm._pinned)
    del model, opt
    _rotate_coordinator()
    hvd.shutdown()
    torch.cuda.empty_cache()
    return res


def tuning_cards_main(device: str):
    """Four cards: the eager stage-2 bench step without the timeline,
    with it (rank 1 straggling once; the trace lands at
    ``HVD_TEST_TRACE``), without it again, and under the tuner; each
    phase its own world generation.  Prints this rank's phases."""
    from horovod_tpu_torch.train_step import synthetic_batch

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    r = int(os.environ["HOROVOD_RANK"])
    dev = f"cuda:{r}" if device == "cuda" else device
    images, labels = synthetic_batch(CARD_BATCH, 224, 1000, seed=100 + r,
                                     device=dev)
    trace = os.environ["HVD_TEST_TRACE"]
    out = {"rank": r,
           "off": _card_phase(dev, images, labels),
           "on": _card_phase(dev, images, labels, trace=trace,
                             straggle=True),
           "off2": _card_phase(dev, images, labels),
           "on2": _card_phase(dev, images, labels, trace=trace + ".2"),
           "tune": _card_phase(dev, images, labels, tune=True)}
    print(json.dumps(out))
