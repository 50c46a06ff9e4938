"""Worker mode of the autopilot's spawned test (through
``_torch_collectives_worker``'s ``spawn``, mode ``autopilot_rollback``):
prints one JSON line.

The reference's ``tests/test_autopilot.py::test_autopilot_rollback_2proc``
on the port's negotiated plane: ``DistributedOptimizer(eager=True)`` over
``fused_update.sgd(0.1, momentum=0.9)`` (optax's momentum SGD, op for
op), a commit every 2 steps under ``HOROVOD_HEALTH``,
``HOROVOD_AUTOPILOT`` and the caller's ``HOROVOD_FAULT_SPEC``, 10 steps
of ``g = (w - target) * (0.5 + 0.1 * step)``.  Each rank reports its
final ``w``, the rank-side engine's applied rollbacks and outcomes, and
the flight ring's ``autopilot`` events.
"""

import json
import os

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import elastic
from horovod_tpu_torch.optim import fused_update as TF
from horovod_tpu_torch.runtime import autopilot as AP
from horovod_tpu_torch.runtime import flight

TOTAL = 10


def rollback_main(device: str):
    hvd.init(device=device)
    r = hvd.rank()
    w = torch.nn.Parameter(torch.zeros(4, dtype=torch.float32))
    opt = hvd.DistributedOptimizer(TF.sgd([w], 0.1, momentum=0.9),
                                   eager=True)
    state = elastic.ElasticState(params={"w": w}, opt_state=opt, step=0,
                                 checkpoint_dir=os.environ["APX_CKPT"])
    target = torch.arange(1.0, 5.0)
    guard = 0
    while state.step < TOTAL:
        guard += 1
        assert guard < 4 * TOTAL, "rollback loop never converged"
        if state.step % 2 == 0:
            state.commit()   # the verdict and the autopilot tick ride it
        w.grad = (w.detach() - target) * (0.5 + 0.1 * state.step)
        opt.step()
        state.step += 1
    ap = AP.rank_autopilot()
    events = [e for e in flight.recorder().snapshot()
              if e["kind"] == "autopilot"]
    hvd.shutdown()
    print(json.dumps({"rank": r, "w": w.detach().tolist(),
                      "rollbacks": ap.stats()["rollbacks"],
                      "outcomes": ap.stats()["by_outcome"],
                      "events": [{k: e.get(k) for k in
                                  ("rule", "act", "outcome", "evidence")}
                                 for e in events]}))
