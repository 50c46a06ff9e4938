"""One rank of the port's collective tests: runs the collectives on
``sys.argv[1]`` (``cpu`` over gloo, or ``cuda`` over NCCL) and prints its
results as one JSON line.  Inputs are numpy arrays seeded by rank, so the
parent can recompute every expected value; :func:`spawn` starts a world
of such ranks with the launcher's env contract.

``sys.argv[2] == "resnet"`` instead trains ResNet-50 at full width for a
few steps with the int8 and then the int4 wire and error feedback, and
prints launch counts, losses, step times and a digest of the reduced
gradient.  ``HVD_TEST_FEEDBACK`` may name a ``.npy`` file of per-rank
residuals that the lossy optimizer case loads before its second step."""

import hashlib
import json
import os
import subprocess
import sys
import time

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


def spawn(n: int, device: str = "cpu", timeout: float = 120.0,
          mode: str = "collectives", env_extra=None):
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
        env.update(env_extra or {})
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, device, mode], env=env,
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
        out[f"{mode}_sum"] = hvd.allreduce(t["v"], op=hvd.Sum,
                                           compression=comp)
        out[f"{mode}_avg"] = hvd.allreduce(t["v"], compression=comp)
        out[f"{mode}_ef"] = list(hvd.quantized_allreduce(
            t["v"], op=hvd.Sum, with_error=True, mode=mode))
    out["grid"] = hvd.allreduce(t["grid"], op=hvd.Sum,
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
        out[f"rs_{mode}"] = hvd.reducescatter(t["rs"], compression=comp)
    out["rs_int8_avg"] = hvd.reducescatter(
        t["rs"], op=hvd.Average, compression=hvd.Compression.int8)
    out["allgather"] = hvd.allgather(t["ag"])
    out["alltoall"] = hvd.alltoall(t["a2a"])

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


if __name__ == "__main__":
    dev = sys.argv[1] if len(sys.argv) > 1 else "cpu"
    if len(sys.argv) > 2 and sys.argv[2] == "resnet":
        resnet_main(dev)
    else:
        main(dev)
