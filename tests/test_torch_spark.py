"""``horovod_tpu_torch.spark`` against ``horovod_tpu.spark``, case by case
against the oracles ``tests/test_spark_barrier.py`` and the spark cases
of ``tests/test_estimator.py`` / ``tests/test_estimator_dataframe.py``:
the slot environment, the gate without pyspark, the barrier path end to
end through the contract-faithful fake of ``tests/fake_pyspark`` (real
per-task processes, a real synchronizing ``allGather``), the
reused-worker refusal, and the adapters' spellings."""

import os
import sys

import pytest
import torch

from horovod_tpu_torch.estimator import JaxEstimator, TorchEstimator

pytestmark = pytest.mark.multiprocess

_FAKE_DIR = os.path.join(os.path.dirname(__file__), "fake_pyspark")

ADDRESSES = [
    ["nodeA:35001", "nodeA:35002", "nodeB:35001", "nodeB:35002"],
    ["h", "h"],
    ["a:1", "a:2", "a:3", "b:1"],
    ["a:1", "a:2", "b:1", "b:2"],
    ["x:1", "y:1", "x:2", "z:9", "y:2"],
    ["10.0.0.1:7", "10.0.0.2:7"],
]


@pytest.mark.parametrize("addrs", ADDRESSES)
def test_slot_env_matches_the_jax_package(addrs):
    """Every rank's topology environment equals the JAX package's, less
    its ``HOROVOD_CONTROLLER`` (the port's controller is the KV
    negotiation over the world's store, chosen by nothing)."""
    from horovod_tpu.spark import _slot_env as jslot

    from horovod_tpu_torch.spark import _slot_env

    for r in range(len(addrs)):
        want = dict(jslot(r, addrs))
        assert want.pop("HOROVOD_CONTROLLER") == "xla"
        assert _slot_env(r, addrs) == want


def test_slot_env_reads_as_init_reads_it(monkeypatch):
    """The environment ``init()`` reads: rank 2 of two hosts of two."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.spark import _slot_env

    env = _slot_env(2, ADDRESSES[0])
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert basics._env_int("HOROVOD_RANK", -1) == 2
    assert basics._env_int("HOROVOD_SIZE", -1) == 4
    assert (env["HOROVOD_LOCAL_RANK"], env["HOROVOD_LOCAL_SIZE"],
            env["HOROVOD_CROSS_RANK"], env["HOROVOD_CROSS_SIZE"],
            env["HOROVOD_IS_HOMOGENEOUS"]) == ("0", "2", "1", "2", "1")


def test_gate_without_pyspark(monkeypatch):
    import horovod_tpu.spark as jspark

    import horovod_tpu_torch.spark as hspark

    monkeypatch.setitem(sys.modules, "pyspark", None)
    with pytest.raises(ImportError, match="horovod_tpu_torch.estimator"):
        hspark.run(lambda: None, num_proc=1)
    with pytest.raises(ImportError, match="horovod_tpu.estimator"):
        jspark.run(lambda: None, num_proc=1)


def test_unsupported_options_raise():
    import horovod_tpu_torch.spark as hspark

    with pytest.raises(TypeError, match="unsupported options"):
        hspark.run(lambda: None, num_proc=1, start_timeout=5)


@pytest.fixture()
def fake_pyspark(monkeypatch):
    monkeypatch.syspath_prepend(_FAKE_DIR)
    for mod in [m for m in sys.modules if m.startswith("pyspark")]:
        monkeypatch.delitem(sys.modules, mod, raising=False)
    import pyspark

    assert getattr(pyspark, "__fake__", False)
    yield pyspark
    pyspark.SparkContext._active_spark_context = None
    for mod in [m for m in sys.modules if m.startswith("pyspark")]:
        sys.modules.pop(mod, None)


def test_spark_run_barrier_end_to_end(fake_pyspark):
    """The oracle's scenario with the port's ranks: two barrier tasks,
    each one gloo rank, the same real all-reduce, results in rank order,
    the topology the slot environment gave."""
    import horovod_tpu_torch.spark as hvd_spark

    # defined here so cloudpickle ships it by value to the task processes
    def train(scale):
        import os as _os

        import torch as _torch

        import horovod_tpu_torch as hvd

        hvd.init()
        rank, size = hvd.rank(), hvd.size()
        s = hvd.allreduce(_torch.full((3,), float(rank + 1) * scale),
                          op=hvd.Sum)
        topo = (hvd.local_size(), hvd.cross_size(),
                _os.environ["HOROVOD_IS_HOMOGENEOUS"])
        hvd.shutdown()
        return {"rank": rank, "size": size, "sum": float(s.sum()),
                "topo": topo}

    fake_pyspark.SparkContext(defaultParallelism=2)
    results = hvd_spark.run(train, args=(2.0,), num_proc=2,
                            env={"HOROVOD_PLATFORM": "cpu",
                                 "OMP_NUM_THREADS": "1"})
    assert [r["rank"] for r in results] == [0, 1]
    for r in results:
        assert r["size"] == 2
        assert r["sum"] == 18.0
        assert r["topo"] == (2, 1, "1")


def test_spark_run_without_context_raises(fake_pyspark):
    import horovod_tpu_torch.spark as hvd_spark

    fake_pyspark.SparkContext._active_spark_context = None
    with pytest.raises(RuntimeError, match="No active SparkContext"):
        hvd_spark.run(lambda: None, num_proc=2)


def test_spark_run_task_failure_propagates(fake_pyspark):
    import horovod_tpu_torch.spark as hvd_spark

    fake_pyspark.SparkContext(defaultParallelism=2)

    def boom():
        raise RuntimeError("rank exploded")

    with pytest.raises(RuntimeError, match="barrier stage failed"):
        hvd_spark.run(boom, num_proc=2, env={"HOROVOD_PLATFORM": "cpu"})


def test_reused_worker_is_refused(fake_pyspark, monkeypatch):
    """A Spark python worker whose process already holds an initialized
    world refuses to run a second rank (reference ``spark.python.worker.
    reuse``), before touching the environment."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.spark import _barrier_task

    class Ctx:
        def partitionId(self):
            return 0

        def getTaskInfos(self):
            return []

    monkeypatch.setattr(fake_pyspark.BarrierTaskContext, "_current", Ctx())
    hvd.init(device="cpu")
    try:
        task = _barrier_task(lambda: 1, (), {})
        with pytest.raises(RuntimeError, match="worker.reuse"):
            list(task(iter(())))
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# The adapters (spark.keras, spark.torch)
# ---------------------------------------------------------------------------


def _tiny():
    return torch.nn.Linear(2, 3)


@pytest.mark.parametrize("loss", ["sparse_categorical_crossentropy",
                                  "categorical_crossentropy",
                                  "softmax_cross_entropy", "mse",
                                  "mean_squared_error", "huber"])
def test_keras_adapter_maps_loss_names_as_the_jax_package(tmp_path, loss):
    from horovod_tpu.spark.keras import KerasEstimator as JKeras

    from horovod_tpu_torch.spark.keras import KerasEstimator

    try:
        want = JKeras(model=None, loss=loss, store=str(tmp_path)).loss
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            KerasEstimator(model=_tiny(), loss=loss, store=str(tmp_path))
        assert str(got.value) == str(exc)
        return
    assert KerasEstimator(model=_tiny(), loss=loss,
                          store=str(tmp_path)).loss == want


@pytest.mark.parametrize("param", ["sample_weight_col",
                                   "partitions_per_process",
                                   "shuffle_buffer_size",
                                   "transformation_fn", "custom_objects",
                                   "loss_weights", "input_shapes",
                                   "metrics"])
def test_adapters_refuse_what_the_jax_package_refuses(tmp_path, param):
    """Each Petastorm-only parameter: refused by the port's adapter
    exactly when the JAX package's refuses it."""
    from horovod_tpu.spark.keras import KerasEstimator as JKeras
    from horovod_tpu.spark.torch import TorchEstimator as JTorch

    from horovod_tpu_torch.spark.keras import KerasEstimator
    from horovod_tpu_torch.spark.torch import TorchEstimator as STorch

    value = ["acc"] if param == "metrics" else "x"
    for mine, theirs, model in ((KerasEstimator, JKeras, None),
                                (STorch, JTorch, _tiny())):
        try:
            theirs(model=model, store=str(tmp_path), **{param: value})
            refused = None
        except (NotImplementedError, TypeError) as exc:
            refused = type(exc)
        if refused is None:
            mine(model=_tiny(), store=str(tmp_path), **{param: value})
        else:
            with pytest.raises(refused):
                mine(model=_tiny(), store=str(tmp_path), **{param: value})


def test_adapters_spellings_and_namespaces(tmp_path):
    import horovod_tpu_torch.spark.keras as sk
    import horovod_tpu_torch.spark.torch as st

    assert issubclass(sk.KerasEstimator, JaxEstimator)
    assert sk.KerasEstimator is not JaxEstimator
    assert issubclass(st.TorchEstimator, TorchEstimator)
    assert st.TorchEstimator is not TorchEstimator
    assert hasattr(sk, "LocalStore") and hasattr(st, "LocalStore")
    assert sk.KerasModel is sk.JaxTrainedModel
    assert st.TorchModel is st.TorchTrainedModel
    est = sk.KerasEstimator(model=_tiny(), optimizer="sgd",
                            store=str(tmp_path), feature_cols=["a"],
                            label_cols=["y"])
    assert (est.loss, est.optimizer, est.feature_cols) == (
        "softmax_cross_entropy", "sgd", ["a"])
    with pytest.raises(ValueError, match="optimizer"):
        sk.KerasEstimator(model=_tiny(), store=str(tmp_path),
                          optimizer="rmsprop")
    mse = torch.nn.functional.mse_loss
    est = st.TorchEstimator(model=_tiny(), loss=mse, optimizer="adamw",
                            store=str(tmp_path), feature_cols=["a", "b"],
                            label_cols=["y"])
    assert est.loss_fn is mse and est.optimizer == "adamw"
