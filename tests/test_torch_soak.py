"""Randomized negotiation soak on the port's eager plane, the
counterpart of ``tests/test_soak.py``: 40 seeded rounds of mixed
collectives (allreduce Sum and Average, ragged allgather, broadcast with
flipping roots) over two CPU ranks, submitted asynchronously in a
rank-dependent order (negotiation must reassemble), every result checked
exactly; a last round re-runs the first round's names through the
response cache.  The op sequence is the reference soak's: the same
``RandomState(1234)`` stream drawn in the same order."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.multiprocess

_SOAK = r"""
import numpy as np
import torch

import horovod_tpu_torch as hvd

hvd.init()
rank = hvd.rank()
rng = np.random.RandomState(1234)  # SAME stream on both ranks
ROUNDS = 40


def make_round(i):
    ops = []
    for j in range(rng.randint(1, 6)):
        kind = rng.choice(["ar_sum", "ar_avg", "ag", "bcast"])
        size = int(rng.randint(1, 64))
        root = int(rng.randint(0, 2))
        ops.append((f"soak.{i}.{j}.{kind}", kind, size, root))
    return ops


rounds = [make_round(i) for i in range(ROUNDS)]


def submit(name, kind, size, root):
    if kind == "ar_sum":
        return hvd.allreduce_async(torch.full((size,), float(rank + 1)),
                                   op=hvd.Sum, name=name)
    if kind == "ar_avg":
        return hvd.allreduce_async(torch.full((size,), float(10 * rank)),
                                   op=hvd.Average, name=name)
    if kind == "ag":  # ragged: rank r contributes r+1 rows
        return hvd.allgather_async(torch.full((rank + 1, size), float(rank)),
                                   name=name)
    return hvd.broadcast_async(torch.full((size,), float(rank * 7)),
                               root_rank=root, name=name)


def check(op, out):
    name, kind, size, root = op
    a = out.numpy()
    if kind == "ar_sum":
        want = np.full((size,), 3.0, np.float32)
    elif kind == "ar_avg":
        want = np.full((size,), 5.0, np.float32)
    elif kind == "ag":
        want = np.concatenate([np.zeros((1, size), np.float32),
                               np.ones((2, size), np.float32)])
    else:
        want = np.full((size,), root * 7.0, np.float32)
    assert a.dtype == np.float32 and a.shape == want.shape, (op, a.shape)
    np.testing.assert_array_equal(a, want, err_msg=str(op))


n_ops = 0
for i, ops in enumerate(rounds):
    order = list(range(len(ops)))
    if rank == 1:  # reversed submission order on rank 1
        order = order[::-1]
    handles = {}
    for idx in order:
        handles[idx] = submit(*ops[idx])
    for idx, op in enumerate(ops):
        check(op, hvd.synchronize(handles[idx]))
    n_ops += len(ops)

# cache interplay: round-0 names again after the negotiations above --
# the cached fast path must still return exact results
for op in rounds[0]:
    check(op, hvd.synchronize(submit(*op)))
print(f"SOAK-OK rank {rank} rounds {ROUNDS} ops {n_ops}", flush=True)
hvd.shutdown()
"""


def test_negotiation_soak_2proc(tmp_path):
    script = tmp_path / "soak.py"
    script.write_text(_SOAK)
    env = dict(os.environ)
    env.update({"HOROVOD_PLATFORM": "cpu", "OMP_NUM_THREADS": "1",
                "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", "")})
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
         sys.executable, str(script)], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout[-4000:], proc.stderr[-4000:])
    oks = [ln for ln in proc.stdout.splitlines() if "SOAK-OK" in ln]
    assert len(oks) == 2, proc.stdout[-4000:]
    assert {ln.split("SOAK-OK ")[1].split()[1] for ln in oks} == {"0", "1"}
