"""One rank of the port's collective tests: runs the collectives on
``sys.argv[1]`` (``cpu`` over gloo, or ``cuda`` over NCCL) and prints its
results as one JSON line.  Inputs are numpy arrays seeded by rank, so the
parent can recompute every expected value; :func:`spawn` starts a world
of such ranks with the launcher's env contract."""

import json
import os
import subprocess
import sys

import numpy as np
import torch

import horovod_tpu_torch as hvd
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


def spawn(n: int, device: str = "cpu", timeout: float = 120.0):
    """Run ``n`` ranks of this script on a fresh port; their results."""
    from horovod_tpu_torch.common.util import free_port

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = free_port()
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
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, device], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=timeout)
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
    out["avg"] = hvd.allreduce(t["x"], op=hvd.Average)
    out["sum"] = hvd.allreduce(t["x"], op=hvd.Sum)
    assert torch.equal(t["x"].cpu(), torch.from_numpy(inp["x"])), \
        "input modified"
    out["fp16"] = hvd.allreduce(t["x"], compression=hvd.Compression.fp16)
    grouped = hvd.grouped_allreduce(
        [t["a"], t["b"].to(torch.bfloat16), t["c"], t["d"]], op=hvd.Sum)
    out["grouped_dtypes"] = [str(g.dtype) for g in grouped]
    out["grouped"] = grouped
    out["grouped_avg"] = hvd.grouped_allreduce([t["a"], t["d"]])
    out["bcast"] = hvd.broadcast(t["x"], root_rank=1)

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
    hvd.shutdown()

    def enc(v):
        if isinstance(v, torch.Tensor):
            return v.float().tolist()
        if isinstance(v, list):
            return [enc(x) for x in v]
        return v

    print(json.dumps({k: enc(v) for k, v in out.items()}))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cpu")
