"""``horovod_tpu_torch.mxnet`` against ``horovod_tpu.mxnet``, case by case
against the oracle ``tests/test_mxnet_frontend.py``.  MXNet is retired
and not installed, so both frontends run against one minimal in-memory
stub of the ``mxnet`` API surface they touch (``nd.array``/``asnumpy``,
``optimizer.Optimizer``, ``gluon.Trainer``), copied here from the
oracle's pattern: the same NDArrays through both at world 1 give the same
values, dtypes and contexts; a gloo world of 2 of the port runs the
in-place ops, the optimizer and the Gluon trainer over the numpy bridge
against the sums the JAX package's semantics give."""

from __future__ import annotations

import json
import os
import sys
import types

import numpy as np
import pytest

STUB = r'''
import sys, types
import numpy as np


class FakeNDArray:
    """The slice of mx.nd.NDArray the frontends use."""

    def __init__(self, arr, ctx=None):
        self._a = np.array(arr)
        self.context = ctx

    def asnumpy(self):
        return self._a.copy()

    @property
    def dtype(self):
        return self._a.dtype

    @property
    def shape(self):
        return self._a.shape

    def __setitem__(self, key, value):
        self._a[key] = value._a if isinstance(value, FakeNDArray) else value

    def __getitem__(self, key):
        return self._a[key]


def make_fake_mxnet():
    mx = types.ModuleType("mxnet")
    nd = types.ModuleType("mxnet.nd")
    nd.NDArray = FakeNDArray
    nd.array = lambda a, ctx=None, dtype=None: FakeNDArray(
        np.asarray(a, dtype=dtype), ctx)
    opt_mod = types.ModuleType("mxnet.optimizer")

    class Optimizer:
        def __init__(self, learning_rate=0.1, rescale_grad=1.0):
            self.lr = learning_rate
            self.rescale_grad = rescale_grad
            self.updates = []

        def update(self, index, weight, grad, state):
            self.updates.append(index)
            if isinstance(index, (tuple, list)):  # grouped update
                return
            weight[:] = weight.asnumpy() - self.lr * (
                self.rescale_grad * grad.asnumpy())

        def update_multi_precision(self, index, weight, grad, state):
            self.update(index, weight, grad, state)

        def create_state_multi_precision(self, index, weight):
            return None

        def set_learning_rate(self, lr):
            self.lr = lr

    gluon = types.ModuleType("mxnet.gluon")

    class Trainer:
        """The slice of gluon.Trainer the DistributedTrainer touches."""

        def __init__(self, params, optimizer, optimizer_params=None,
                     kvstore="device"):
            self._params = list(params)
            self._optimizer = optimizer
            self._scale = 1.0
            self.kvstore = kvstore

        def step(self, batch_size):
            # as gluon: the step's scale becomes the gradient rescale
            self._optimizer.rescale_grad = self._scale / batch_size
            self._allreduce_grads()
            for i, p in enumerate(self._params):
                if p.grad_req != "null":
                    self._optimizer.update(i, p.data(), p.list_grad()[0],
                                           None)

    class Parameter:
        def __init__(self, name, value, grad, grad_req="write"):
            self.name = name
            self._data = FakeNDArray(value)
            self._grad = FakeNDArray(grad)
            self.grad_req = grad_req

        def data(self):
            return self._data

        def list_grad(self):
            return [self._grad]

    gluon.Trainer = Trainer
    gluon.Parameter = Parameter
    opt_mod.Optimizer = Optimizer
    mx.nd = nd
    mx.optimizer = opt_mod
    mx.gluon = gluon
    return mx


def install():
    mx = make_fake_mxnet()
    sys.modules.update({"mxnet": mx, "mxnet.nd": mx.nd,
                        "mxnet.optimizer": mx.optimizer,
                        "mxnet.gluon": mx.gluon})
    return mx
'''

_stub = types.ModuleType("_mxnet_stub")
exec(STUB, _stub.__dict__)


@pytest.fixture()
def fake_mx(monkeypatch):
    mx = _stub.make_fake_mxnet()
    for name, mod in (("mxnet", mx), ("mxnet.nd", mx.nd),
                      ("mxnet.optimizer", mx.optimizer),
                      ("mxnet.gluon", mx.gluon)):
        monkeypatch.setitem(sys.modules, name, mod)
    return mx


@pytest.fixture()
def both(hvd_single):
    import horovod_tpu.mxnet as jmx

    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.mxnet as pmx

    hvd.init(device="cpu")
    yield pmx, jmx
    hvd.shutdown()


#: JAX's default 32-bit mode narrows these on the JAX package's wire; the
#: port keeps the NDArray's own dtype, as the reference does
_JAX_NARROWS = {np.dtype("float64"): np.dtype("float32"),
                np.dtype("int64"): np.dtype("int32")}


def _same(a, b):
    """``a`` (the port's) equals ``b`` (the JAX package's): the same
    values and context, the same dtype but where JAX narrows it."""
    assert isinstance(a, _stub.FakeNDArray) and type(a) is type(b)
    assert b.dtype in (a.dtype, _JAX_NARROWS.get(a.dtype))
    assert a.context == b.context
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_probe_and_gate_without_mxnet(monkeypatch):
    import horovod_tpu_torch.mxnet as pmx

    monkeypatch.setitem(sys.modules, "mxnet", None)
    assert pmx.mxnet_built() is False
    with pytest.raises(ImportError, match="PyTorch frontend"):
        pmx.DistributedOptimizer(object())
    with pytest.raises(ImportError, match="horovod_tpu_torch"):
        pmx.broadcast_parameters({}, root_rank=0)
    with pytest.raises(ImportError, match="MXNet"):
        pmx.DistributedTrainer([], None)
    with pytest.raises(AttributeError):
        pmx.no_such_name  # noqa: B018


@pytest.mark.parametrize("dtype", ["float32", "float64", "float16", "int32",
                                   "int64"])
def test_ops_match_the_jax_package(fake_mx, both, dtype):
    pmx, jmx = both
    a = np.arange(6).reshape(2, 3).astype(dtype)
    assert pmx.allreduce(fake_mx.nd.array(a)).dtype == np.dtype(dtype)
    for name, args, kw in (("allreduce", (), {"average": False}),
                           ("allgather", (), {}),
                           ("broadcast", (0,), {}), ("alltoall", (), {})):
        x = fake_mx.nd.array(a, ctx="cpu(0)")
        _same(getattr(pmx, name)(x, *args, **kw),
              getattr(jmx, name)(x, *args, **kw))
    for name, args in (("allreduce_", ()), ("broadcast_", (0,))):
        x, y = fake_mx.nd.array(a), fake_mx.nd.array(a)
        kw = {"name": f"ip.{name}"}
        if name == "allreduce_":
            kw["average"] = dtype.startswith("int") is False
        assert getattr(pmx, name)(x, *args, **kw) is x
        getattr(jmx, name)(y, *args, **kw)
        _same(x, y)


def test_distributed_optimizer_matches_the_jax_package(fake_mx, both):
    pmx, jmx = both
    ws = []
    for m in (pmx, jmx):
        base = fake_mx.optimizer.Optimizer(learning_rate=0.5)
        opt = m.DistributedOptimizer(base)
        assert base.rescale_grad == 1.0
        w = fake_mx.nd.array([1.0, 1.0])
        g = fake_mx.nd.array([1.0, 2.0])
        opt.update(0, w, g, None)
        opt.set_learning_rate(0.1)
        assert base.lr == 0.1 and opt.lr == 0.1
        opt.update_multi_precision([1, 2], w, [g, g], None)
        assert base.updates == [0, [1, 2]]
        ws.append(w)
    _same(*ws)
    np.testing.assert_allclose(ws[0].asnumpy(), [0.5, 0.0])


def test_broadcast_parameters_matches_the_jax_package(fake_mx, both):
    from horovod_tpu_torch.common.types import HorovodTpuError

    pmx, jmx = both
    outs = []
    for m in (pmx, jmx):
        params = {"w": fake_mx.nd.array([1.0, 2.0]),
                  "b": fake_mx.nd.array([3], dtype=np.int32)}
        m.broadcast_parameters(params, root_rank=0)
        outs.append(params)
    for k in outs[1]:
        _same(outs[0][k], outs[1][k])
    with pytest.raises(HorovodTpuError, match="Cannot broadcast"):
        pmx.broadcast_parameters([1, 2, 3])


def test_distributed_trainer_unwraps_and_scales(fake_mx, both):
    pmx, _ = both
    p = fake_mx.gluon.Parameter("w", [1.0, 1.0], [1.0, 2.0])
    base = fake_mx.optimizer.Optimizer(learning_rate=0.5)
    with pytest.warns(UserWarning, match="unwrapped"):
        tr = pmx.DistributedTrainer([p], pmx.DistributedOptimizer(base))
    assert tr._scale == 1.0 and tr.kvstore is None
    tr.step(1)
    np.testing.assert_allclose(p.data().asnumpy(), [0.5, 0.0])


_WORLD = STUB + r'''
import json
mx = install()
import horovod_tpu_torch as hvd
import horovod_tpu_torch.mxnet as pmx

hvd.init()
r, n = hvd.rank(), hvd.size()
out = {}
x = mx.nd.array(np.full((3,), r + 1.0, np.float32), ctx="cpu(0)")
out["sum"] = pmx.allreduce(x, average=False).asnumpy().tolist()
out["avg"] = pmx.allreduce(x, average=True).asnumpy().tolist()
y = mx.nd.array(np.full((2,), float(r), np.float64))
pmx.allreduce_(y, average=False, name="ip")
out["inplace"] = [str(y.dtype)] + y.asnumpy().tolist()
out["gather"] = pmx.allgather(mx.nd.array(np.full((r + 1, 2), r, np.int64))
                              ).asnumpy().tolist()
out["bcast"] = pmx.broadcast(mx.nd.array([float(r)] * 2), 1).asnumpy().tolist()
params = {"w": mx.nd.array(np.full((2,), 10.0 * r, np.float32))}
pmx.broadcast_parameters(params, root_rank=1)
out["params"] = params["w"].asnumpy().tolist()
base = mx.optimizer.Optimizer(learning_rate=1.0)
opt = pmx.DistributedOptimizer(base)
out["rescale"] = base.rescale_grad
w = mx.nd.array([1.0, 1.0])
opt.update(0, w, mx.nd.array([float(r + 1)] * 2), None)
out["opt"] = w.asnumpy().tolist()
p = mx.gluon.Parameter("v", [0.0, 0.0], [float(r + 1), 2.0 * (r + 1)])
tr = pmx.DistributedTrainer([p], mx.optimizer.Optimizer(learning_rate=1.0))
tr.step(1)
out["trainer"] = p.data().asnumpy().tolist()
hvd.shutdown()
print(json.dumps(out), flush=True)
'''


def test_world_of_two_over_the_bridge(tmp_path):
    """Two gloo ranks through the stubbed frontend: the values the JAX
    package's semantics give (sums, averages, ragged gathers, the root's
    broadcast, averaging folded into ``rescale_grad`` and the trainer's
    scale)."""
    import subprocess

    from horovod_tpu_torch.common.util import free_port

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "mx_world.py"
    script.write_text(_WORLD)
    port = free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ)
        env.update({"HOROVOD_PLATFORM": "cpu", "HOROVOD_RANK": str(r),
                    "HOROVOD_SIZE": "2", "HOROVOD_LOCAL_RANK": str(r),
                    "HOROVOD_LOCAL_SIZE": "2",
                    "HOROVOD_COORDINATOR_ADDR": f"127.0.0.1:{port}",
                    "OMP_NUM_THREADS": "1",
                    "PYTHONPATH": repo + os.pathsep
                    + env.get("PYTHONPATH", "")})
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=180)
            assert p.returncode == 0, se[-3000:]
            outs.append(json.loads(so.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, o in enumerate(outs):
        assert o["sum"] == [3.0] * 3 and o["avg"] == [1.5] * 3
        assert o["inplace"] == ["float64", 1.0, 1.0]
        assert o["gather"] == [[0, 0], [1, 1], [1, 1]]
        assert o["bcast"] == [1.0, 1.0] and o["params"] == [10.0, 10.0]
        assert o["rescale"] == 0.5
        # grads 1 and 2 summed (3), times rescale 1/2: 1 - 1.5
        assert o["opt"] == [-0.5, -0.5]
        # grads summed (3, 6), times the scale 1/2
        assert o["trainer"] == [-1.5, -3.0]
