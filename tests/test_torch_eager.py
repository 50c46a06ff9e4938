"""The port's eager plane and its PyTorch frontend at world 1, in one
process, against the JAX package's.

1. The handle layer, as ``tests/test_eager_single.py`` asserts it: the
   uninitialized error, identity at one rank (results are copies, the
   in-place spellings return their input), async handles, ``poll``, a
   handle cleared by ``synchronize``, duplicate names in the tensor
   queue, ``average=``/``op=`` (and their conflict), the per-call
   quantized compressor's refusal, ``join`` and ``barrier``; each error
   message equal to the JAX package's.
2. ``horovod_tpu_torch.torch`` against ``horovod_tpu.torch``, run as
   ``tests/test_torch_frontend.py:31-170`` runs it: the dtype matrix,
   allreduce/broadcast autograd, fp16 and bf16 compression, exact int64
   and float64, ``DistributedOptimizer`` against the plain optimizer (and
   its hooks, name validation, ``backward_passes_per_step`` and the
   ``zero_grad`` race error, driven by hand at one rank),
   ``broadcast_optimizer_state`` over the optimizer matrix and
   ``broadcast_object``: each output equal to the JAX frontend's.
3. The executor's one fusion buffer, over a hop whose peer mirrors this
   rank: responses of every size and dtype share it, and it grows only
   past the fusion threshold.
"""

import time

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu.torch as jt
from horovod_tpu.common.types import DuplicateNameError as JDuplicate
from horovod_tpu.common.types import HorovodTpuError as JError
from horovod_tpu.ops.compression import Compression as JCompression
from horovod_tpu.runtime import background as jbg

import horovod_tpu_torch as hvd
import horovod_tpu_torch.torch as tt
from horovod_tpu_torch.common.types import DuplicateNameError
from horovod_tpu_torch.runtime import background as tbg

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.float64,
          torch.int32, torch.int64, torch.uint8]


def _message(fn, exc):
    with pytest.raises(exc) as e:
        fn()
    return str(e.value)


def test_uninitialized_raises():
    if hvd.is_initialized():
        hvd.shutdown()
    with pytest.raises(hvd.HorovodTpuError):
        hvd.rank()
    with pytest.raises(hvd.HorovodTpuError,
                       match="has not been initialized; use hvd.init"):
        hvd.allreduce(torch.ones(3))


@pytest.fixture(scope="module")
def both():
    jt.init()
    tt.init(device="cpu")
    yield jt, tt
    tt.shutdown()
    jt.shutdown()


def test_identity_copies_and_inplace(both):
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    for op in (hvd.Average, hvd.Sum):
        out = hvd.allreduce(x, op=op)
        assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    assert torch.equal(hvd.allreduce(x, average=True), x)
    assert torch.equal(hvd.allreduce(x, hvd.Sum), x)
    buf = x.clone()
    assert hvd.allreduce_(buf, op=hvd.Sum) is buf
    assert hvd.broadcast_(buf, 0) is buf
    for fn in (hvd.allgather, hvd.alltoall, hvd.reducescatter,
               lambda t: hvd.broadcast(t, 0)):
        out = fn(x)
        assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    assert hvd.join() == 0 == jhvd.join()
    hvd.barrier()


def test_async_handles_poll_and_clear(both):
    handles = [hvd.allreduce_async(torch.full((4,), float(i)), op=hvd.Sum,
                                   name=f"t{i}") for i in range(10)]
    for i, h in enumerate(handles):
        assert torch.equal(hvd.synchronize(h), torch.full((4,), float(i)))
    h = hvd.allreduce_async(torch.ones(8), name="pollme")
    deadline = time.time() + 10
    while not hvd.poll(h) and time.time() < deadline:
        time.sleep(0.005)
    assert hvd.poll(h)
    hvd.synchronize(h)
    jh = jhvd.allreduce_async(np.ones(8, np.float32), name="pollme")
    jhvd.synchronize(jh)
    assert _message(lambda: hvd.synchronize(h), hvd.HorovodTpuError) == \
        _message(lambda: jhvd.synchronize(jh), JError).replace(
            str(jh), str(h))
    for _ in range(3):
        assert torch.equal(hvd.allreduce(torch.ones(4), name="reused"),
                           torch.ones(4))


def test_duplicate_name_in_the_queue():
    tq, jq = tbg.TensorQueue(), jbg.TensorQueue()
    tq.add(tbg._Entry("dup", "allreduce", 2, -1, torch.ones(4), 0, None))
    jq.add(jbg._Entry("dup", "allreduce", 2, -1, np.ones(4), 0, None))
    tm = _message(lambda: tq.add(tbg._Entry("dup", "allreduce", 2, -1,
                                            torch.ones(4), 1, None)),
                  DuplicateNameError)
    jm = _message(lambda: jq.add(jbg._Entry("dup", "allreduce", 2, -1,
                                            np.ones(4), 1, None)),
                  JDuplicate)
    assert tm == jm
    tq.finalize("dup")
    tq.add(tbg._Entry("dup", "allreduce", 2, -1, torch.ones(4), 2, None))


def test_op_conflicts_and_quantized_refusal(both):
    assert _message(lambda: hvd.allreduce(torch.ones(3), average=True,
                                          op=hvd.Sum), hvd.HorovodTpuError) \
        == _message(lambda: jhvd.allreduce(np.ones(3), average=True,
                                           op=jhvd.Sum), JError)
    assert _message(lambda: hvd.allreduce(
        torch.ones(3), compression=hvd.Compression.int8),
        hvd.HorovodTpuError) == _message(lambda: jhvd.allreduce(
            np.ones(3, np.float32), compression=JCompression.int8), JError)
    assert _message(lambda: hvd.reducescatter(torch.ones(3), op=hvd.Adasum),
                    hvd.HorovodTpuError) == _message(
        lambda: jhvd.reducescatter(np.ones(3), op=jhvd.Adasum), JError)
    assert "rank >= 1" in _message(
        lambda: hvd.reducescatter(torch.tensor(1.0)), hvd.HorovodTpuError)


# ---------------------------------------------------------------------------
# The frontend against the JAX frontend
# ---------------------------------------------------------------------------


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    assert torch.equal(a, b), (a, b)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_allreduce_dtype_matrix(both, dtype):
    gen = torch.Generator().manual_seed(DTYPES.index(dtype))
    for dims in [(17,), (3, 4), (2, 3, 4)]:
        if dtype.is_floating_point:
            t = torch.rand(*dims, generator=gen).to(dtype)
        else:
            t = torch.randint(0, 100, dims, dtype=dtype, generator=gen)
        for op in (tt.Sum, tt.Average):
            if op == tt.Average and not dtype.is_floating_point:
                continue
            _same(tt.allreduce(t.clone(), op=op),
                  jt.allreduce(t.clone(), op=op))
        buf = t.clone()
        assert tt.allreduce_(buf, op=tt.Sum) is buf
        _same(buf, t)


def test_int64_and_float64_exact(both):
    t = torch.tensor([3_000_000_000, -5_000_000_000], dtype=torch.int64)
    f = torch.tensor([1.0 + 2 ** -40], dtype=torch.float64)
    for op in (tt.Sum, tt.Average):
        _same(tt.allreduce(t.clone(), op=op), jt.allreduce(t.clone(), op=op))
        _same(tt.allreduce(f.clone(), op=op), jt.allreduce(f.clone(), op=op))
    _same(tt.allgather(t), jt.allgather(t))
    _same(tt.broadcast(t, root_rank=0), jt.broadcast(t, root_rank=0))
    _same(tt.alltoall(t), jt.alltoall(t))


def test_autograd(both):
    x = torch.rand(5)
    grads = []
    for m in (tt, jt):
        xi = x.clone().requires_grad_(True)
        m.allreduce(xi, op=m.Average).pow(2).sum().backward()
        b = x.clone().requires_grad_(True)
        (m.broadcast(b, root_rank=0) * 3).sum().backward()
        g = torch.rand(3, 2, generator=torch.Generator().manual_seed(1))
        a = g.clone().requires_grad_(True)
        (m.allgather(a) * 2).sum().backward()
        grads.append([xi.grad, b.grad, a.grad])
    for a, b in zip(*grads):
        _same(a, b)


def test_compression(both):
    t = torch.rand(32, generator=torch.Generator().manual_seed(2)) + 1.0
    for name in ("fp16", "bf16", "none"):
        _same(tt.allreduce(t.clone(), op=tt.Sum,
                           compression=getattr(tt.Compression, name)),
              jt.allreduce(t.clone(), op=jt.Sum,
                           compression=getattr(jt.Compression, name)))
    buf = t.clone()
    tt.allreduce_(buf, op=tt.Sum, compression=tt.Compression.fp16)
    _same(buf, t.half().float())


def _train(m, model, x, y, steps=2):
    opt = m.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                 named_parameters=model.named_parameters())
    for _ in range(steps):
        opt.zero_grad()
        torch.nn.functional.mse_loss(model(x), y).backward()
        opt.step()
    return [p.detach().clone() for p in model.parameters()]


def test_distributed_optimizer_matches_plain_and_jax(both):
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 2)
    x, y = torch.rand(8, 4), torch.rand(8, 2)
    states = {}
    for key in ("port", "jax", "plain"):
        m = torch.nn.Linear(4, 2)
        m.load_state_dict(model.state_dict())
        if key == "plain":
            opt = torch.optim.SGD(m.parameters(), lr=0.1)
            for _ in range(2):
                opt.zero_grad()
                torch.nn.functional.mse_loss(m(x), y).backward()
                opt.step()
            states[key] = [p.detach().clone() for p in m.parameters()]
        else:
            states[key] = _train(tt if key == "port" else jt, m, x, y)
    for a, b, c in zip(states["port"], states["jax"], states["plain"]):
        _same(a, b)
        _same(a, c)


def test_distributed_optimizer_hooks_and_errors(both):
    """The hooks are registered at world > 1 only; driven by hand here,
    they raise the JAX frontend's errors."""
    msgs = {}
    for key, m in (("port", tt), ("jax", jt)):
        torch.manual_seed(0)
        model = torch.nn.Linear(3, 1)
        with pytest.raises(ValueError) as e:
            m.DistributedOptimizer(torch.optim.SGD(model.parameters(), 0.1),
                                   named_parameters=[("w", model.weight),
                                                     ("w", model.bias)])
        with pytest.raises(ValueError) as e2:
            m.DistributedOptimizer(torch.optim.SGD(model.parameters(), 0.1),
                                   named_parameters=[("w", model.weight)])
        opt = m.DistributedOptimizer(torch.optim.SGD(model.parameters(), 0.1),
                                     named_parameters=model.named_parameters())
        opt._register_hooks()
        model(torch.ones(2, 3)).sum().backward()
        with pytest.raises(AssertionError) as e3:
            opt.zero_grad()
        with pytest.raises(AssertionError) as e4:
            model(torch.ones(2, 3)).sum().backward()
        opt.synchronize()
        opt.step()
        msgs[key] = [str(e.value), str(e2.value), str(e3.value),
                     str(e4.value),
                     [p.detach().clone() for p in model.parameters()]]
    for a, b in zip(msgs["port"][:4], msgs["jax"][:4]):
        assert a == b
    for a, b in zip(msgs["port"][4], msgs["jax"][4]):
        _same(a, b)


OPTIMIZERS = {
    "sgd": lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.9),
    "adam-amsgrad": lambda p: torch.optim.Adam(p, lr=1e-3, amsgrad=True),
    "adamw": lambda p: torch.optim.AdamW(p, lr=1e-3),
    "adamax": lambda p: torch.optim.Adamax(p, lr=1e-3),
    "adadelta": lambda p: torch.optim.Adadelta(p, lr=0.5),
    "adagrad": lambda p: torch.optim.Adagrad(p, lr=0.1),
    "asgd": lambda p: torch.optim.ASGD(p, lr=0.1),
    "rmsprop-centered": lambda p: torch.optim.RMSprop(p, lr=0.01,
                                                      momentum=0.9,
                                                      centered=True),
    "rprop": lambda p: torch.optim.Rprop(p, lr=0.01),
    "sgd-wd-fresh": lambda p: torch.optim.SGD(p, lr=0.5, momentum=0.9,
                                              weight_decay=0.1),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_broadcast_optimizer_state_matrix(both, name):
    out = {}
    for key, m in (("port", tt), ("jax", jt)):
        torch.manual_seed(3)
        model = torch.nn.Linear(3, 3)
        opt = OPTIMIZERS[name](model.parameters())
        x = torch.rand(2, 3)
        if name != "sgd-wd-fresh":
            model(x).sum().backward()
            opt.step()
        m.broadcast_optimizer_state(opt, root_rank=0)
        opt.zero_grad()
        model(x).sum().backward()
        opt.step()
        sd = opt.state_dict()
        out[key] = ([p.detach().clone() for p in model.parameters()],
                    sd["state"], sd["param_groups"])
    for a, b in zip(out["port"][0], out["jax"][0]):
        _same(a, b)
    assert out["port"][2] == out["jax"][2]
    for pid, s in out["port"][1].items():
        for k, v in s.items():
            w = out["jax"][1][pid][k]
            if torch.is_tensor(v):
                _same(v, w)
            else:
                assert v == w and type(v) is type(w), k


def test_broadcast_parameters_object_and_lbfgs(both):
    model = torch.nn.Linear(3, 3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tt.broadcast_parameters(model.state_dict(), root_rank=0)
    for k, v in model.state_dict().items():
        _same(v, before[k])
    obj = {"epoch": 3, "lr": 0.1, "sched": [1, 2, 3]}
    assert tt.broadcast_object(obj, root_rank=0) == \
        jt.broadcast_object(obj, root_rank=0) == obj
    with pytest.raises(ValueError):
        tt.broadcast_optimizer_state(torch.optim.LBFGS(model.parameters()))
    assert (tt.mpi_built(), tt.ddl_built(), tt.ccl_built(),
            tt.mpi_threads_supported()) == (jt.mpi_built(), jt.ddl_built(),
                                            jt.ccl_built(),
                                            jt.mpi_threads_supported())
    assert tt.gloo_enabled() and tt.is_homogeneous()


class _MirrorHop:
    """A hop of two ranks whose peer holds this rank's tensor: a sum
    doubles, a broadcast keeps."""
    size, index = 2, 0

    def all_reduce(self, t, op="sum"):
        return t.mul_(2)

    def broadcast(self, t, root):
        return t


def test_executor_keeps_one_fusion_buffer(monkeypatch):
    from horovod_tpu_torch.ops.eager_exec import EagerExecutor

    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "1024")
    ex = EagerExecutor(_MirrorHop(), "cpu")
    rng = np.random.RandomState(7)
    first = None
    for shapes, dtype in [(((5,), (3, 4)), torch.float32),
                          (((100,),), torch.float32),
                          (((7, 2),), torch.float64),
                          (((60,), (4,)), torch.int32),
                          (((33,),), torch.bfloat16)]:
        ts = [torch.from_numpy(rng.randn(*s)).to(dtype) for s in shapes]
        got = ex.fused_allreduce(ts, 2)  # Sum
        for t, g in zip(ts, got):
            assert torch.equal(g, t * 2)
        assert ex.fused_broadcast(ts, 0)[0].equal(ts[0])
        if first is None:
            first = ex._buffer
        assert ex._buffer is first and first.numel() == 1024
    big = [torch.ones(300)]  # 1200 B: past the threshold, grows once
    assert torch.equal(ex.fused_allreduce(big, 2)[0], big[0] * 2)
    grown = ex._buffer
    assert grown.numel() == 1200
    ex.fused_allreduce([torch.ones(10)], 1)  # Average
    assert ex._buffer is grown
