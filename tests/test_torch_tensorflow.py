"""``horovod_tpu_torch.tensorflow`` (and its ``keras``) against
``horovod_tpu.tensorflow``, case by case against the oracles
``tests/test_tf_frontend.py`` and ``tests/test_tf_keras.py``: the same TF
tensors through both packages' frontends at world 1 in this process
(sync and async collectives over the numpy bridge, the sparse
``IndexedSlices`` path, gradients under the tape, the optimizers, the
variable broadcast, graph mode, the tf.keras callbacks), and one scenario
script on a gloo world of 2 of each package (the collectives, a bfloat16
tensor, the tape, the optimizers and ``model.fit`` with the callback
trio): every rank's results equal, the fit's weights and logs within
rtol 1e-6.  Skips only without tensorflow."""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

pytestmark = pytest.mark.multiprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def both(hvd_single):
    """Both packages' TF frontends, initialized at world 1."""
    import horovod_tpu.tensorflow as jtf

    import horovod_tpu_torch.tensorflow as ptf

    ptf.init(device="cpu")
    yield ptf, jtf
    ptf.shutdown()


def _same(a, b):
    if isinstance(b, tf.IndexedSlices):
        assert isinstance(a, tf.IndexedSlices)
        _same(a.values, b.values)
        _same(a.indices, b.indices)
        return
    assert type(a) is type(b) or (isinstance(a, tf.Tensor)
                                  and isinstance(b, tf.Tensor))
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_built_probe(both):
    ptf, jtf = both
    assert ptf.tensorflow_built() is jtf.tensorflow_built() is True


@pytest.mark.parametrize("dtype,op", [
    (d, "Sum") for d in ("float32", "float16", "float64", "int32", "int64",
                         "bfloat16")] + [
    (d, "Average") for d in ("float32", "float16", "float64", "bfloat16")])
def test_allreduce_tf_tensors(both, dtype, op):
    ptf, jtf = both
    dt = getattr(tf, dtype)
    t = tf.constant(np.arange(6).reshape(2, 3), dtype=dt)
    _same(ptf.allreduce(t, op=getattr(ptf, op)),
          jtf.allreduce(t, op=getattr(jtf, op)))


def test_async_handles(both):
    ptf, jtf = both
    t = tf.constant([[1.5, 2.5]])
    outs = []
    for m in (ptf, jtf):
        hs = [m.allreduce_async(t, name="a.r", op=m.Sum),
              m.allgather_async(t, name="a.g"),
              m.broadcast_async(t, 0, name="a.b")]
        deadline = time.monotonic() + 60
        while not all(m.poll(h) for h in hs):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        outs.append([m.synchronize(h) for h in hs])
    for a, b in zip(*outs):
        _same(a, b)


def test_fp16_compression(both):
    ptf, jtf = both
    t = tf.constant([1.5, -2.25], dtype=tf.float32)
    _same(ptf.allreduce(t, op=ptf.Sum, compression=ptf.Compression.fp16),
          jtf.allreduce(t, op=jtf.Sum, compression=jtf.Compression.fp16))


def test_indexed_slices_sparse_path(both):
    ptf, jtf = both
    slices = tf.IndexedSlices(tf.constant([[1.0, 2.0], [3.0, 4.0]]),
                              tf.constant([0, 3], dtype=tf.int64),
                              dense_shape=tf.constant([5, 2], tf.int64))
    _same(ptf.allreduce(slices, op=ptf.Average),
          jtf.allreduce(slices, op=jtf.Average))
    with pytest.raises(NotImplementedError, match="Adasum"):
        ptf.allreduce(slices, op=ptf.Adasum)


def test_allgather_broadcast_alltoall(both):
    ptf, jtf = both
    t = tf.constant([[1.0, 2.0]])
    _same(ptf.allgather(t), jtf.allgather(t))
    _same(ptf.broadcast(t, root_rank=0), jtf.broadcast(t, root_rank=0))
    _same(ptf.alltoall(t), jtf.alltoall(t))


@pytest.mark.parametrize("which", ["allreduce", "allgather", "broadcast"])
def test_gradients_under_the_tape(both, which):
    ptf, jtf = both
    grads = []
    for m in (ptf, jtf):
        x = tf.Variable([1.0, 2.0, 3.0])
        with tf.GradientTape() as tape:
            if which == "allreduce":
                y = m.allreduce(x, op=m.Sum)
            elif which == "allgather":
                y = m.allgather(tf.reshape(x, [3, 1]))
            else:
                y = m.broadcast(x, 0)
            loss = tf.reduce_sum(y * y)
        grads.append(tape.gradient(loss, x))
    _same(*grads)


def test_distributed_gradient_tape(both):
    ptf, jtf = both
    grads = []
    for m in (ptf, jtf):
        x = tf.Variable([2.0, -1.0])
        tape = m.DistributedGradientTape(tf.GradientTape())
        with tape:
            loss = tf.reduce_sum(x * x)
        grads.append(tape.gradient(loss, [x])[0])
    _same(*grads)


@pytest.mark.parametrize("kind", ["plain", "adasum"])
def test_keras_optimizers(both, kind):
    ptf, jtf = both
    vals = []
    for m in (ptf, jtf):
        v = tf.Variable([1.0, 1.0])
        wrap = (m.DistributedOptimizer if kind == "plain"
                else m.DistributedAdasumOptimizer)
        opt = wrap(tf.keras.optimizers.SGD(learning_rate=0.5))
        assert type(opt).__name__ == "SGD"
        opt.apply_gradients([(tf.constant([1.0, 2.0]), v)])
        vals.append(v.numpy())
    np.testing.assert_array_equal(*vals)
    np.testing.assert_allclose(vals[0], [0.5, 0.0])


def test_v1_optimizer_wrap_and_refusals(both):
    from horovod_tpu_torch.common.types import HorovodTpuError

    ptf, _ = both
    opt = ptf.DistributedOptimizer(
        tf.compat.v1.train.GradientDescentOptimizer(0.1))
    assert isinstance(opt, tf.compat.v1.train.Optimizer)
    assert "compute_gradients" in type(opt).__dict__
    with pytest.raises(HorovodTpuError, match="Cannot wrap"):
        ptf.DistributedOptimizer(object())
    with pytest.raises(HorovodTpuError, match="backward_passes_per_step"):
        ptf.DistributedOptimizer(tf.keras.optimizers.SGD(0.1),
                                 backward_passes_per_step=2)


def test_broadcast_variables(both):
    ptf, jtf = both
    vs = [tf.Variable([5.0, 6.0]), tf.Variable([[1, 2]], dtype=tf.int32)]
    ws = [tf.Variable([5.0, 6.0]), tf.Variable([[1, 2]], dtype=tf.int32)]
    ptf.broadcast_variables(vs, root_rank=0)
    jtf.broadcast_variables(ws, root_rank=0)
    for a, b in zip(vs, ws):
        _same(tf.convert_to_tensor(a), tf.convert_to_tensor(b))


def test_graph_mode(both):
    ptf, jtf = both
    outs = []
    for m in (ptf, jtf):
        @tf.function(input_signature=[
            tf.TensorSpec(shape=[None, 2], dtype=tf.float32)])
        def gather_fn(x):
            return m.allgather(x, name="graph.ag")

        @tf.function(input_signature=[
            tf.TensorSpec(shape=[None, 2], dtype=tf.float32)])
        def grad_fn(x):
            with tf.GradientTape() as tape:
                tape.watch(x)
                loss = tf.reduce_sum(m.allgather(x, name="graph.ag.g") ** 2)
            return tape.gradient(loss, x)

        @tf.function
        def step(x):
            return m.allreduce(x, op=m.Sum, name="graph.ar")

        outs.append((gather_fn(tf.ones([3, 2])), grad_fn(tf.ones([2, 2])),
                     step(tf.constant([1.0, 2.0]))))
    for a, b in zip(*outs):
        _same(a, b)


# ---------------------------------------------------------------------------
# tf.keras (oracle: tests/test_tf_keras.py)
# ---------------------------------------------------------------------------


class _FakeVar:
    def __init__(self, v):
        self.v = v

    def assign(self, v):
        self.v = float(v)

    def numpy(self):
        return self.v


def _fake_model(lr=0.2, momentum=None):
    class FakeOpt:
        learning_rate = _FakeVar(lr)

    class FakeModel:
        optimizer = FakeOpt()

    if momentum is not None:
        FakeOpt.momentum = momentum
    return FakeModel()


def _epoch(cb, epoch, batches=1, seen=None):
    cb.on_epoch_begin(epoch)
    for b in range(batches):
        cb.on_batch_begin(b)
        if seen is not None:
            opt = cb.model.optimizer
            mom = getattr(opt, "momentum", None)
            seen.append((opt.learning_rate.v,
                         mom.v if isinstance(mom, _FakeVar) else mom))
        cb.on_batch_end(b)
    cb.on_epoch_end(epoch, logs={})


def _keras_cases(k):
    return {
        "staircase": lambda: [k.LearningRateScheduleCallback(
            multiplier=lambda e: 0.1 ** (e // 2), start_epoch=0)],
        "stacked": lambda: [
            k.LearningRateScheduleCallback(1.0, start_epoch=0, end_epoch=2),
            k.LearningRateScheduleCallback(1e-1, start_epoch=2, end_epoch=4),
            k.LearningRateScheduleCallback(1e-2, start_epoch=4)],
        "window": lambda: [k.LearningRateScheduleCallback(
            5.0, start_epoch=1, end_epoch=2)],
        "warmup": lambda: [k.LearningRateWarmupCallback(
            warmup_epochs=2, steps_per_epoch=2)],
        "momentum": lambda: [k.LearningRateScheduleCallback(
            0.5, start_epoch=0)],
    }


@pytest.mark.parametrize("case", ["staircase", "stacked", "window",
                                  "warmup", "momentum"])
def test_keras_schedules_match_the_jax_package(both, case):
    """The oracle's fake-model cases: every callback of each package
    drives its own fake optimizer; the rate and momentum seen in every
    batch are equal."""
    import horovod_tpu.tensorflow.keras as jk

    import horovod_tpu_torch.tensorflow.keras as pk

    seen = []
    for k in (pk, jk):
        model = _fake_model(0.2, momentum=_FakeVar(0.9)
                            if case == "momentum" else None)
        cbs = _keras_cases(k)[case]()
        for cb in cbs:
            cb.set_model(model)
            cb.on_train_begin()
        s = []
        for epoch in (0, 1, 2, 4, 5):
            for cb in cbs:
                _epoch(cb, epoch, batches=2, seen=s)
        seen.append(s)
    assert seen[0] == seen[1]


def test_keras_refusals(both):
    import horovod_tpu_torch.tensorflow.keras as pk

    with pytest.raises(TypeError, match="positive integer"):
        pk.LearningRateWarmupCallback(0.001, 1)
    pk.LearningRateWarmupCallback(warmup_epochs=np.int64(5))

    class FakeOpt:
        learning_rate = object()

    class FakeModel:
        optimizer = FakeOpt()

    cb = pk.LearningRateScheduleCallback(0.5)
    cb.set_model(FakeModel())
    with pytest.raises(ValueError, match="LearningRateSchedule"):
        cb.on_train_begin()


def _tiny_model(seed=0):
    model = tf.keras.Sequential([tf.keras.layers.Input(shape=(4,)),
                                 tf.keras.layers.Dense(2,
                                                       activation="softmax")])
    rng = np.random.RandomState(seed)
    model.set_weights([rng.randn(4, 2).astype(np.float32) * 0.5,
                       np.zeros(2, np.float32)])
    return model


def test_fit_with_the_callbacks_matches_the_jax_package(both):
    import horovod_tpu.tensorflow.keras as jk

    import horovod_tpu_torch.tensorflow.keras as pk

    x = np.random.RandomState(0).rand(16, 4).astype(np.float32)
    y = (x.sum(axis=1) > 2).astype(np.int32)
    out = []
    for k in (pk, jk):
        model = _tiny_model()
        model.compile(optimizer=k.DistributedOptimizer(
            tf.keras.optimizers.SGD(0.01, momentum=0.9)),
            loss="sparse_categorical_crossentropy")
        hist = model.fit(x, y, epochs=2, batch_size=8, verbose=0,
                         shuffle=False,
                         callbacks=[k.BroadcastGlobalVariablesCallback(0),
                                    k.MetricAverageCallback(),
                                    k.LearningRateWarmupCallback(
                                        warmup_epochs=1)])
        out.append((hist.history, model.get_weights()))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_array_equal(a, b)


def test_load_model_rewraps_the_optimizer(both, tmp_path):
    import horovod_tpu_torch.tensorflow.keras as pk

    model = _tiny_model()
    model.compile(optimizer=pk.DistributedOptimizer(
        tf.keras.optimizers.SGD(0.25)), loss="mse")
    x = np.random.RandomState(1).rand(8, 4).astype(np.float32)
    y = np.zeros((8, 2), dtype=np.float32)
    model.fit(x, y, epochs=1, batch_size=4, verbose=0)
    path = str(tmp_path / "model.keras")
    model.save(path)
    for load in (pk.load_model,
                 __import__("horovod_tpu_torch.keras",
                            fromlist=["load_model"]).load_model):
        loaded = load(path)
        opt = loaded.optimizer
        assert getattr(opt, "_horovod_tpu_distributed", False)
        assert type(opt).__name__ == "SGD"
        assert np.isclose(float(opt.learning_rate.numpy()), 0.25)


# ---------------------------------------------------------------------------
# A world of 2 of each package, the same script
# ---------------------------------------------------------------------------

_SCENARIO = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import tensorflow as tf
    PKG = sys.argv[1]
    if PKG == "horovod_tpu":
        import horovod_tpu.tensorflow as tfhvd
        import horovod_tpu.tensorflow.keras as tfk
    else:
        import horovod_tpu_torch.tensorflow as tfhvd
        import horovod_tpu_torch.tensorflow.keras as tfk
    tfhvd.init()
    rank, size = tfhvd.rank(), tfhvd.size()
    out = {}

    def put(k, t):
        if isinstance(t, tf.IndexedSlices):
            out[k] = [put(k + ".v", t.values), put(k + ".i", t.indices)]
            return out[k]
        a = np.asarray(t.numpy() if hasattr(t, "numpy") else t)
        out[k] = [str(a.dtype), a.astype(np.float64).tolist()]
        return out[k]

    t = tf.fill([4], float(rank + 1))
    put("sum", tfhvd.allreduce(t, op=tfhvd.Sum))
    put("avg", tfhvd.allreduce(t, op=tfhvd.Average))
    put("bf16", tfhvd.allreduce(tf.cast(tf.fill([5], 0.5 + rank), tf.bfloat16),
                                op=tfhvd.Sum))
    put("ag", tfhvd.allgather(tf.fill([rank + 1, 2], float(rank))))
    put("bc", tfhvd.broadcast(tf.fill([3], float(rank * 7)), root_rank=1))
    h = tfhvd.allreduce_async(tf.fill([2, 2], float(rank)), op=tfhvd.Sum,
                              name="async")
    put("async", tfhvd.synchronize(h))
    put("sparse", tfhvd.allreduce(tf.IndexedSlices(
        tf.fill([1, 2], float(rank + 1)), tf.constant([rank], tf.int64)),
        op=tfhvd.Average))
    v = tf.Variable([float(rank), float(rank)])
    tfhvd.broadcast_variables([v], root_rank=0)
    put("bvar", v)
    tape = tfhvd.DistributedGradientTape(tf.GradientTape())
    with tape:
        loss = tf.reduce_sum(v * float(rank + 1))
    put("tape", tape.gradient(loss, [v])[0])
    x = tf.Variable([[1.0 + rank], [2.0]])
    with tf.GradientTape() as g:
        loss = tf.reduce_sum(tfhvd.allgather(x) ** 2)
    put("ag_grad", g.gradient(loss, x))
    opt = tfhvd.DistributedOptimizer(
        tf.keras.optimizers.SGD(learning_rate=1.0))
    opt.apply_gradients([(tf.fill([2], float(rank + 1)), v)])
    put("opt", v)
    w = tf.Variable([4.0, 4.0])
    tfhvd.DistributedAdasumOptimizer(
        tf.keras.optimizers.SGD(learning_rate=1.0)).apply_gradients(
        [(tf.constant([1.0, 2.0]), w)])
    put("adasum", w)

    model = tf.keras.Sequential([tf.keras.layers.Input(shape=(4,)),
                                 tf.keras.layers.Dense(2)])
    rng = np.random.RandomState(rank)  # differs by rank: broadcast fixes it
    model.set_weights([rng.randn(4, 2).astype(np.float32),
                       rng.randn(2).astype(np.float32)])
    model.compile(optimizer=tfk.DistributedOptimizer(
        tf.keras.optimizers.SGD(0.1, momentum=0.9)), loss="mse")
    xs = np.random.RandomState(10 + rank).rand(8, 4).astype(np.float32)
    ys = np.zeros((8, 2), dtype=np.float32)
    hist = model.fit(xs, ys, epochs=2, batch_size=4, verbose=0,
                     shuffle=False,
                     callbacks=[tfk.BroadcastGlobalVariablesCallback(0),
                                tfk.MetricAverageCallback(),
                                tfk.LearningRateWarmupCallback(
                                    warmup_epochs=1)])
    out["fit_history"] = {k: [float(x) for x in v]
                          for k, v in hist.history.items()}
    out["fit_weights"] = [a.astype(np.float64).tolist()
                          for a in model.get_weights()]
    tfhvd.shutdown()
    print(json.dumps(out), flush=True)
""")


def _world(pkg: str, n: int = 2, timeout: float = 300.0) -> list:
    sys.path.insert(0, os.path.dirname(__file__))
    from horovod_tpu_torch.common.util import free_port

    port = free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ)
        env.update({
            "HOROVOD_PLATFORM": "cpu", "HOROVOD_RANK": str(r),
            "HOROVOD_SIZE": str(n), "HOROVOD_LOCAL_RANK": str(r),
            "HOROVOD_LOCAL_SIZE": str(n), "HOROVOD_CROSS_RANK": "0",
            "HOROVOD_CROSS_SIZE": "1",
            "HOROVOD_COORDINATOR_ADDR": f"127.0.0.1:{port}",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
            # importing tensorflow holds the interpreter for seconds
            "HOROVOD_HEARTBEAT_TIMEOUT_SECONDS": "120",
            "OMP_NUM_THREADS": "1", "TF_NUM_INTEROP_THREADS": "1",
            "TF_NUM_INTRAOP_THREADS": "1",
            "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _SCENARIO, pkg], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def _collect(procs, timeout=300.0) -> list:
    outs = []
    try:
        for r, p in enumerate(procs):
            try:
                so, se = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                _, se = p.communicate()
                raise AssertionError(f"rank {r} timed out:\n{se[-3000:]}")
            assert p.returncode == 0, f"rank {r} failed:\n{se[-3000:]}"
            outs.append(json.loads(so.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_world_of_two_matches_the_jax_package():
    """Both packages' worlds of 2 run side by side; the values the
    oracle's two-process scenarios assert hold on the port's ranks, and
    every result equals the JAX package's rank for rank (the fit within
    rtol 1e-6)."""
    mine = _world("horovod_tpu_torch")
    theirs = _world("horovod_tpu")
    mine, theirs = _collect(mine), _collect(theirs)
    # both of the port's ranks end the fit on the same weights
    assert mine[0]["fit_weights"] == mine[1]["fit_weights"]
    for r, (a, b) in enumerate(zip(mine, theirs)):
        fit_a = (a.pop("fit_history"), a.pop("fit_weights"))
        fit_b = (b.pop("fit_history"), b.pop("fit_weights"))
        assert a == b, r
        assert fit_a[0].keys() == fit_b[0].keys()
        for k in fit_b[0]:
            np.testing.assert_allclose(fit_a[0][k], fit_b[0][k], rtol=1e-6)
        for u, v in zip(fit_a[1], fit_b[1]):
            np.testing.assert_allclose(u, v, rtol=1e-6, atol=1e-7)
        # the oracle's expected values (tests/test_tf_frontend.py)
        assert a["sum"][1] == [3.0] * 4 and a["avg"][1] == [1.5] * 4
        assert a["bf16"] == ["bfloat16", [2.0] * 5]
        assert a["bc"][1] == [7.0] * 3 and a["tape"][1] == [1.5, 1.5]
        assert a["opt"][1] == [-1.5, -1.5]
        assert a["adasum"][1] == [3.0, 2.0]
