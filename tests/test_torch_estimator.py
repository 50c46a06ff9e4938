"""``horovod_tpu_torch.estimator`` against ``horovod_tpu.estimator``, case
by case against the oracles ``tests/test_estimator.py`` and
``tests/test_estimator_dataframe.py``: the stores (a KV-store round trip
with no shared filesystem, the local layout), the DataFrame's columns and
its one-shot and chunked ingest (the same blobs, byte for byte), the
validation split (uneven shards included), and the estimators' ``fit``.

Estimator parity: the port's in-trace ``JaxEstimator`` trains the
reference's MLP (``tests/test_estimator.py:109-113``) and ``MnistCNN``
from the flax initialization the JAX package's rank draws from ``seed``
(carried across with ``interop.cnn_from_flax``), for ``sgd``, ``adam``
and ``adamw`` at worlds of 1 and 2, 2 epochs, float32.  The JAX package
runs at world 1 in this process (``_jax_remote_train``: the function its
launched rank runs, bit for bit the launched history) and at world 2
through its own ``fit``.  Tolerance (``EST_RTOL``/``EST_ATOL``): the
per-epoch losses and the final parameters within rtol 2e-4 / atol 2e-5,
the loss tolerance ``tests/test_torch_cnn_models.py`` holds ``MnistCNN``
to, applied after the training steps too (XLA's and PyTorch's float32
matmul and convolution sums differ in order); under Adam and AdamW at
most ``ADAM_SHARE`` (1e-3) of the parameters may lie outside it, each
within ``2 * lr * steps`` (see ``hold_params``).  The ``TorchEstimator``s
of both packages train the same torch module at world 1: bit for bit.
"""

import io
import os
import pickle
import sys
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch import nn

from horovod_tpu_torch import interop
from horovod_tpu_torch.estimator import (JaxEstimator, KVStore, LocalStore,
                                         Store, TorchEstimator)
from horovod_tpu_torch.estimator import estimator as E
from horovod_tpu_torch.models.layers import Dense, init_weights
from horovod_tpu_torch.models.mnist import MnistCNN

pytestmark = pytest.mark.multiprocess

EST_RTOL, EST_ATOL = 2e-4, 2e-5
ADAM_SHARE = 1e-3
OPTIMIZERS = ["sgd", "adam", "adamw"]


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    # the launched ranks inherit it: torch's intra-op pool in every rank
    # starves the loaded test run's other worlds
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def port_mlp(seed: int = 0):
    """The reference's MLP as the port's layers, named as flax scopes
    it: ``Dense(3)(relu(Dense(16)(x)))`` builds the outer ``Dense(3)``
    first, so it is ``Dense_0`` and the 8 -> 16 layer ``Dense_1``.
    Seeded weights."""
    m = nn.Sequential(OrderedDict(Dense_1=Dense(8, 16), relu=nn.ReLU(),
                                  Dense_0=Dense(16, 3)))
    init_weights(m, torch.Generator().manual_seed(seed))
    return m


def flax_models():
    """The JAX side's models, built inside a function so cloudpickle
    sends the MLP's class by value to the JAX package's ranks."""
    import flax.linen as fnn

    from horovod_tpu.models.mnist import MnistCNN as FlaxMnist

    class MLP(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Dense(3)(fnn.relu(fnn.Dense(16)(x)))

    return {"mlp": MLP(), "mnist": FlaxMnist()}


def case_data(model: str):
    """Seeded inputs: the MLP's as ``tests/test_estimator.py`` draws
    them (scored on a 0.25 validation split), MnistCNN's 28x28x1 images
    (no split)."""
    if model == "mlp":
        rng = np.random.RandomState(0)
        return dict(x=rng.rand(64, 8).astype(np.float32),
                    y=rng.randint(0, 3, 64), batch_size=16, lr=1e-2,
                    validation=0.25)
    rng = np.random.RandomState(1)
    return dict(x=rng.rand(32, 28, 28, 1).astype(np.float32),
                y=rng.randint(0, 10, 32), batch_size=8, lr=1e-3,
                validation=0.0)


def flax_init(fmodel, x, seed: int = 0) -> dict:
    import jax

    params = fmodel.init(jax.random.PRNGKey(seed), x[:1])["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def port_model(model: str, params: dict):
    m = port_mlp() if model == "mlp" else MnistCNN(device="cpu")
    return interop.cnn_from_flax(params, {}, m)


def jax_world1(fmodel, d: dict, optimizer: str, tmp) -> tuple:
    """The JAX package's rank function at world 1, in this process."""
    from horovod_tpu.estimator import JaxEstimator as JEst
    from horovod_tpu.estimator import LocalStore as JLocal
    from horovod_tpu.estimator.estimator import (_jax_remote_train,
                                                 _shard_to_store)

    est = JEst(model=fmodel, lr=d["lr"], store=JLocal(str(tmp)),
               num_proc=1, batch_size=d["batch_size"], epochs=2,
               validation=d["validation"], optimizer=optimizer)
    train = est.store.get_train_data_path("w1")
    _shard_to_store(est.store, train, d["x"], d["y"], 1)
    spec = est._remote_spec(train, est.store.get_checkpoint_path("w1"))
    spec["store"] = est.store
    return _jax_remote_train(spec)


def jax_world2(fmodel, d: dict, optimizer: str, tmp) -> tuple:
    from horovod_tpu.estimator import JaxEstimator as JEst
    from horovod_tpu.estimator import LocalStore as JLocal

    est = JEst(model=fmodel, lr=d["lr"], store=JLocal(str(tmp)),
               num_proc=2, batch_size=d["batch_size"], epochs=2,
               validation=d["validation"], optimizer=optimizer)
    m = est.fit(d["x"], d["y"])
    return m.params, m.history, m.val_history


def port_params(model: str, state: dict) -> dict:
    m = port_mlp() if model == "mlp" else MnistCNN(device="cpu")
    m.load_state_dict(state)
    return interop.cnn_to_flax(m)[0]


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def hold_params(got: dict, want: dict, optimizer: str, lr: float,
                steps: int) -> tuple:
    """Every parameter within rtol/atol; under Adam (and AdamW), which
    scales each element's step to about ``lr`` whatever its gradient,
    an element whose gradient is at rounding level on both sides may
    move by up to ``lr`` per step in either run: there at most
    ``ADAM_SHARE`` of the elements lie outside rtol/atol, each within
    ``2 * lr * steps``.  Returns (largest difference, share outside)."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    worst, outside, total = 0.0, 0, 0
    for k in w:
        diff = np.abs(g[k] - w[k])
        bad = diff > EST_ATOL + EST_RTOL * np.abs(w[k])
        if optimizer == "sgd":
            assert not bad.any(), (k, float(diff.max()))
        else:
            assert float(diff.max()) <= 2 * lr * steps, (k, float(diff.max()))
        outside += int(bad.sum())
        total += bad.size
        worst = max(worst, float(diff.max()))
    assert outside <= ADAM_SHARE * total, (outside, total)
    return worst, outside / total


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("model", ["mlp", "mnist"])
def test_intrace_estimator_matches_the_jax_estimator(model, optimizer, world,
                                                     tmp_path):
    d = case_data(model)
    fmodel = flax_models()[model]
    params = flax_init(fmodel, d["x"])
    est = JaxEstimator(model=port_model(model, params), lr=d["lr"],
                       store=LocalStore(str(tmp_path / "port")),
                       num_proc=world, batch_size=d["batch_size"], epochs=2,
                       validation=d["validation"], optimizer=optimizer,
                       run_id="parity")
    # the two packages' runs are independent: run them side by side
    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(jax_world1 if world == 1 else jax_world2,
                          fmodel, d, optimizer, tmp_path / "jax")
        trained = est.fit(d["x"], d["y"])
        ref = ref.result()
    want_params, want_hist, want_val = ref[0], list(ref[1]), list(ref[2])
    np.testing.assert_allclose(trained.history, want_hist, rtol=EST_RTOL,
                               atol=EST_ATOL)
    np.testing.assert_allclose(trained.val_history, want_val,
                               rtol=EST_RTOL, atol=EST_ATOL)
    assert len(trained.history) == 2
    assert len(trained.val_history) == (2 if d["validation"] else 0)
    world_rows = len(d["x"]) // world
    steps = 2 * max(1, (world_rows - (int(world_rows * d["validation"])
                                      if d["validation"] else 0))
                    // d["batch_size"])
    worst, share = hold_params(port_params(model, trained.params),
                               want_params, optimizer, d["lr"], steps)
    # every rank ends on the same state, and rank 0's checkpoint in the
    # store is it, bit for bit
    for r in est.rank_results_[1:]:
        for k, v in r[0].items():
            assert torch.equal(v, est.rank_results_[0][0][k]), k
    ckpt = torch.load(io.BytesIO(est.store.read_bytes(
        f"{est.store.get_checkpoint_path('parity')}/last.ckpt")))
    assert ckpt["epoch"] == 1 and ckpt["history"] == trained.history
    for k, v in ckpt["params"].items():
        assert torch.equal(v, trained.params[k]), k
    # predict: the forward of the returned state
    preds = trained.predict(d["x"][:10])
    with torch.no_grad():
        want = port_model(model, port_params(model, trained.params))(
            torch.from_numpy(d["x"][:10])).numpy()
    np.testing.assert_array_equal(preds, want)
    print(f"[estimator parity] {model} {optimizer} world {world}: largest "
          f"parameter difference {worst:.3e}, share outside rtol/atol "
          f"{share:.2e}; history {trained.history} against {want_hist}")


def test_torch_estimators_agree_bit_for_bit_at_world_1(tmp_path):
    """The same torch module, seed and data through both packages'
    ``TorchEstimator`` (the JAX package's rank function in this process,
    the port's through its launcher): the same bits."""
    from horovod_tpu.estimator import TorchEstimator as JTorchEst
    from horovod_tpu.estimator import LocalStore as JLocal
    from horovod_tpu.estimator.estimator import (_shard_to_store,
                                                 _torch_remote_train)

    torch.manual_seed(3)
    base = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
    rng = np.random.RandomState(1)
    x = rng.rand(48, 4).astype(np.float32)
    y = rng.randint(0, 2, 48)
    for optimizer in OPTIMIZERS:
        start = {k: v.clone() for k, v in base.state_dict().items()}
        mine = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
        mine.load_state_dict(start)
        est = TorchEstimator(model=mine, lr=1e-2, optimizer=optimizer,
                             store=LocalStore(str(tmp_path / optimizer)),
                             num_proc=1, batch_size=8, epochs=2,
                             validation=0.25)
        trained = est.fit(x, y)
        theirs = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
        theirs.load_state_dict(start)
        jest = JTorchEst(model=theirs, lr=1e-2, optimizer=optimizer,
                         store=JLocal(str(tmp_path / f"j{optimizer}")),
                         num_proc=1, batch_size=8, epochs=2,
                         validation=0.25)
        train = jest.store.get_train_data_path("w1")
        _shard_to_store(jest.store, train, x, y, 1)
        spec = jest._remote_spec(train, jest.store.get_checkpoint_path("w1"))
        spec["store"] = jest.store
        state, hist, val = _torch_remote_train(spec)
        assert trained.history == hist, optimizer
        assert trained.val_history == val, optimizer
        for k, v in state.items():
            assert torch.equal(trained.model.state_dict()[k].cpu(), v), \
                (optimizer, k)


def test_optax_adamw_counterpart_step_by_step():
    """``OptaxAdamW`` against ``optax.adamw`` (weight decay 1e-4) over five
    steps on the same seeded gradients, float32: within 1e-6 relative
    (the update is one expression per element on both sides)."""
    import jax.numpy as jnp
    import optax

    rng = np.random.RandomState(5)
    p0 = rng.randn(3, 7).astype(np.float32)
    grads = [rng.randn(3, 7).astype(np.float32) for _ in range(5)]
    tx = optax.adamw(3e-2)
    jp = jnp.asarray(p0)
    st = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = E.OptaxAdamW([tp], 3e-2)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-7)


def test_optimizer_and_loss_by_name(tmp_path):
    from horovod_tpu_torch.optim import fused_update

    ps = [torch.nn.Parameter(torch.zeros(3))]
    sgd = E._make_optimizer("sgd", ps, 0.1)
    assert isinstance(sgd, fused_update.SGD)
    assert sgd.fused_spec == fused_update.FusedSpec("momentum", 0.1, 0.9)
    adam = E._make_optimizer("adam", ps, 0.1)
    assert isinstance(adam, fused_update.Adam)
    assert fused_update.spec_of(E._make_optimizer("adamw", ps, 0.1)) is None
    with pytest.raises(ValueError, match="optimizer"):
        JaxEstimator(model=port_mlp(), store=LocalStore(str(tmp_path)),
                     optimizer="rmsprop")
    logits = torch.tensor([[2.0, -1.0, 0.5], [0.1, 0.2, 0.3]])
    target = torch.tensor([0, 2])
    import jax.numpy as jnp
    import optax

    want = optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits.numpy()), jnp.asarray(target.numpy())).mean()
    np.testing.assert_allclose(float(E.softmax_cross_entropy(logits, target)),
                               float(want), rtol=1e-6)
    np.testing.assert_allclose(float(E.mse(logits, logits * 2)),
                               float(jnp.mean(jnp.asarray(logits.numpy())
                                              ** 2)), rtol=1e-6)


# ---------------------------------------------------------------------------
# The cloudpickle trap: the card has no cloudpickle
# ---------------------------------------------------------------------------


def test_without_cloudpickle_default_loss_trains_and_lambda_is_refused(
        tmp_path, monkeypatch):
    """cloudpickle's import blocked, as on the card: ``fit`` with the
    default loss trains at a world of 1 (``pickle`` takes the module-level
    training function and loss by reference); a lambda loss raises on the
    driver, before any data is sharded and with no rank launched."""
    import horovod_tpu_torch.run as hrun

    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    with pytest.raises(ImportError):
        import cloudpickle  # noqa: F401
    rng = np.random.RandomState(2)
    x = rng.rand(32, 8).astype(np.float32)
    y = rng.randint(0, 3, 32)
    launches = []
    real = hrun.launch
    monkeypatch.setattr(hrun, "launch",
                        lambda *a, **k: launches.append(a) or real(*a, **k))
    trained = JaxEstimator(model=port_mlp(), lr=1e-2,
                           store=LocalStore(str(tmp_path / "ok")),
                           num_proc=1, batch_size=8, epochs=1).fit(x, y)
    assert len(launches) == 1 and np.isfinite(trained.history).all()
    trained = TorchEstimator(model=port_mlp(), lr=1e-2,
                             store=LocalStore(str(tmp_path / "ok2")),
                             num_proc=1, batch_size=8, epochs=1).fit(x, y)
    assert len(launches) == 2 and np.isfinite(trained.history).all()
    for est in (JaxEstimator(model=port_mlp(), loss=lambda o, t: o.sum(),
                             store=LocalStore(str(tmp_path / "bad")),
                             num_proc=1),
                TorchEstimator(model=port_mlp(),
                               loss_fn=lambda o, t: o.sum(),
                               store=LocalStore(str(tmp_path / "bad2")),
                               num_proc=1)):
        with pytest.raises(TypeError, match="module-level"):
            est.fit(x, y)
    assert len(launches) == 2
    assert not (tmp_path / "bad" / "intermediate_data").exists()
    assert not (tmp_path / "bad2" / "intermediate_data").exists()


# ---------------------------------------------------------------------------
# Stores
# ---------------------------------------------------------------------------


def _kv_roundtrip(store) -> dict:
    """``test_kv_store_blob_roundtrip``'s operations, their results."""
    out = {}
    train = store.get_train_data_path("r1")
    ckpt = store.get_checkpoint_path("r1")
    out["paths"] = (train, ckpt, store.get_logs_path("r1"),
                    store.get_val_data_path("r1"))
    store.write_bytes(f"{train}/part.0.npz", b"\x00shardbytes\xff")
    store.write_bytes(f"{ckpt}/last.ckpt", b"ckptbytes")
    out["read"] = store.read_bytes(f"{train}/part.0.npz")
    out["exists"] = (store.exists(f"{train}/part.0.npz"),
                     store.exists(train), store.exists("nope"))
    remote = pickle.loads(pickle.dumps(store))
    out["remote_server"] = remote._server is None
    out["remote_read"] = remote.read_bytes(f"{ckpt}/last.ckpt")
    store.cleanup_run("r1")
    out["after"] = (store._kv().try_get(f"{train}/part.0.npz"),
                    store.read_bytes(f"{ckpt}/last.ckpt"))
    remote.stop()
    return out


def test_kv_store_roundtrip_matches_the_jax_package(monkeypatch):
    """The KV store with no shared filesystem: both packages' stores do
    the same operations with the same results, and the port's store
    speaks the JAX package's wire (a JAX-side client reads a blob the
    port's server holds)."""
    from horovod_tpu.estimator import KVStore as JKV

    monkeypatch.delenv("HOROVOD_SECRET_KEY", raising=False)
    mine, theirs = KVStore(), JKV()
    try:
        assert _kv_roundtrip(mine) == _kv_roundtrip(theirs)
        mine.write_bytes("checkpoints/x/blob", bytes(range(256)) * 3)
        peer = JKV(addr="127.0.0.1", port=mine.port, secret=mine.secret)
        assert peer.read_bytes("checkpoints/x/blob") == \
            bytes(range(256)) * 3
        peer.stop()
        assert KVStore.MAX_BLOB_BYTES == JKV.MAX_BLOB_BYTES
        with pytest.raises(ValueError, match="caps one value"):
            mine.write_bytes("big", b"\x00" * (KVStore.MAX_BLOB_BYTES + 1))
    finally:
        mine.stop()
        theirs.stop()


@pytest.mark.parametrize("url", ["kv://host", "kv://:12", "kv://h:p"])
def test_store_create_refuses_bad_kv_urls(url):
    from horovod_tpu.estimator import Store as JStore

    with pytest.raises(ValueError) as mine:
        Store.create(url)
    with pytest.raises(ValueError) as theirs:
        JStore.create(url)
    assert str(mine.value) == str(theirs.value)


def test_kv_url_attach_needs_the_secret(monkeypatch):
    monkeypatch.delenv("HOROVOD_SECRET_KEY", raising=False)
    with pytest.raises(ValueError, match="secret"):
        Store.create("kv://127.0.0.1:1")


def test_local_store_layout_matches_the_jax_package(tmp_path):
    from horovod_tpu.estimator import Store as JStore

    mine = Store.create(str(tmp_path / "a"))
    theirs = JStore.create(str(tmp_path / "b"))
    assert isinstance(mine, LocalStore)
    for get in ("get_checkpoint_path", "get_logs_path",
                "get_train_data_path", "get_val_data_path"):
        assert os.path.relpath(getattr(mine, get)("run1"),
                               mine.prefix_path) == \
            os.path.relpath(getattr(theirs, get)("run1"),
                            theirs.prefix_path)
    for s in (mine, theirs):
        for p in (s.get_checkpoint_path("run1"), s.get_logs_path("run1"),
                  s.get_train_data_path("run1")):
            s.make_dir(p)
            assert s.exists(p)
        s.cleanup_run("run1")
        assert not s.exists(s.get_train_data_path("run1"))
        assert s.exists(s.get_checkpoint_path("run1"))


def test_kvstore_fit_needs_no_filesystem(tmp_path, monkeypatch):
    """Two ranks fit with every shard and checkpoint in the KV store: the
    working directory stays empty, the checkpoint is read back from the
    store equal to the returned state, the shards are cleaned up."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("HOROVOD_SECRET_KEY", raising=False)
    rng = np.random.RandomState(1)
    x = rng.rand(64, 8).astype(np.float32)
    y = rng.randint(0, 3, 64)
    store = KVStore()
    try:
        est = JaxEstimator(model=port_mlp(), lr=1e-2, store=store,
                           num_proc=2, batch_size=16, epochs=2,
                           run_id="kvrun")
        model = est.fit(x, y)
        assert model.predict(x).shape == (64, 3)
        assert len(model.history) == 2 and np.isfinite(model.history).all()
        ckpt = torch.load(io.BytesIO(store.read_bytes(
            f"{store.get_checkpoint_path('kvrun')}/last.ckpt")))
        assert ckpt["epoch"] == 1
        for k, v in ckpt["params"].items():
            assert torch.equal(v, model.params[k])
        assert store._kv().try_get(
            f"{store.get_train_data_path('kvrun')}/part.0.npz") is None
        assert not [p for p in tmp_path.rglob("*") if p.is_file()]
    finally:
        store.stop()


# ---------------------------------------------------------------------------
# Validation split, shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,fraction", [(0, 0.25), (1, 0.25), (3, 0.25),
                                        (40, 0.2), (7, 0.5), (10, 0.0),
                                        (2, 0.99)])
def test_split_validation_matches_the_jax_package(n, fraction):
    from horovod_tpu.estimator.estimator import _split_validation as jsplit

    x = np.arange(n * 2).reshape(n, 2)
    y = np.arange(n)
    mine, theirs = E._split_validation(x, y, fraction), \
        jsplit(x, y, fraction)
    for a, b in zip(mine, theirs):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)


def test_shards_match_the_jax_package(tmp_path):
    from horovod_tpu.estimator.estimator import (_load_shard,
                                                 _shard_to_store)

    rng = np.random.RandomState(0)
    x, y = rng.rand(11, 3), rng.randint(0, 4, 11)
    mine, theirs = LocalStore(str(tmp_path / "a")), \
        LocalStore(str(tmp_path / "b"))
    E._shard_to_store(mine, mine.get_train_data_path("r"), x, y, 3)
    _shard_to_store(theirs, theirs.get_train_data_path("r"), x, y, 3)
    for r in range(3):
        a = E._load_shard(mine, mine.get_train_data_path("r"), r)
        b = _load_shard(theirs, theirs.get_train_data_path("r"), r)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


def test_validation_uneven_shards_no_deadlock(tmp_path):
    """3 samples over 2 ranks with validation=0.25: one rank's split is
    empty, and the (sum, count) all-reduce runs on every rank anyway."""
    rng = np.random.RandomState(4)
    x = rng.rand(3, 8).astype(np.float32)
    y = rng.randint(0, 3, 3)
    est = JaxEstimator(model=port_mlp(), lr=1e-2,
                       store=LocalStore(str(tmp_path / "s")), num_proc=2,
                       batch_size=2, epochs=1, validation=0.25)
    model = est.fit(x, y)
    assert len(model.val_history) == 1
    assert np.isfinite(model.val_history[0])


def test_estimator_rejects_bad_validation(tmp_path):
    with pytest.raises(ValueError, match="validation"):
        JaxEstimator(model=port_mlp(), store=LocalStore(str(tmp_path)),
                     validation=1.5)
    with pytest.raises(ValueError, match="validation"):
        TorchEstimator(model=port_mlp(), store=LocalStore(str(tmp_path)),
                       validation=-0.1)


# ---------------------------------------------------------------------------
# DataFrame ingest (oracle: tests/test_estimator_dataframe.py)
# ---------------------------------------------------------------------------


def _df(n=12):
    pd = pytest.importorskip("pandas")
    rng = np.random.RandomState(0)
    return pd.DataFrame({
        "f1": rng.rand(n).astype(np.float32),
        "f2": rng.rand(n).astype(np.float32),
        "label": rng.randint(0, 3, n),
        "img": [rng.rand(4, 4).astype(np.float32) for _ in range(n)],
    })


@pytest.mark.parametrize("cols", [["f1", "f2"], ["img"], ["label"], ["f1"],
                                  ["img", "f1"], ["nope"]])
def test_assemble_columns_matches_the_jax_package(cols):
    from horovod_tpu.estimator.dataframe import assemble_columns as jasm

    from horovod_tpu_torch.estimator.dataframe import assemble_columns

    df = _df()
    try:
        want = jasm(df, cols)
    except Exception as exc:  # noqa: BLE001 -- the same error expected
        with pytest.raises(type(exc)) as got:
            assemble_columns(df, cols)
        assert str(got.value) == str(exc)
        return
    got = assemble_columns(df, cols)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_ragged_cells_rejected():
    pd = pytest.importorskip("pandas")
    from horovod_tpu_torch.estimator.dataframe import assemble_columns

    df = pd.DataFrame({"r": [np.zeros(2), np.zeros(3)], "y": [0, 1]})
    with pytest.raises(ValueError, match="ragged"):
        assemble_columns(df, ["r"])


class _Recording(LocalStore):
    """Every blob written, by path relative to the prefix."""

    def __init__(self, prefix):
        super().__init__(prefix)
        self.blobs = {}

    def write_bytes(self, path, data):
        self.blobs[os.path.relpath(path, self.prefix_path)] = data
        super().write_bytes(path, data)


@pytest.mark.parametrize("rows_per_chunk,shuffle", [(None, False),
                                                    (None, True),
                                                    (256, False),
                                                    (256, True), (100, False)])
def test_materialize_writes_the_jax_packages_blobs(tmp_path, rows_per_chunk,
                                                   shuffle):
    """One-shot and chunked ingest: the same blobs, byte for byte, the
    same metadata, and the rank-side reader gets the same rows."""
    pd = pytest.importorskip("pandas")
    from horovod_tpu.estimator.dataframe import \
        materialize_dataframe as jmat
    from horovod_tpu.estimator.estimator import _load_shard as jload

    from horovod_tpu_torch.estimator.dataframe import materialize_dataframe

    n, num_proc = 1000, 3
    rng = np.random.RandomState(3)
    df = pd.DataFrame({"f1": rng.rand(n).astype(np.float32),
                       "f2": rng.rand(n).astype(np.float32),
                       "label": rng.randint(0, 5, n)})
    mine, theirs = _Recording(str(tmp_path / "a")), \
        _Recording(str(tmp_path / "b"))
    metas = [fn(s, s.get_train_data_path("r"), df, ["f1", "f2"], ["label"],
                num_proc, shuffle=shuffle, seed=7,
                rows_per_chunk=rows_per_chunk)
             for fn, s in ((materialize_dataframe, mine), (jmat, theirs))]
    assert metas[0] == metas[1]
    assert mine.blobs.keys() == theirs.blobs.keys()
    for k in mine.blobs:
        if k.endswith(".json"):
            assert mine.blobs[k] == theirs.blobs[k]
        else:
            a = np.load(io.BytesIO(mine.blobs[k]))
            b = np.load(io.BytesIO(theirs.blobs[k]))
            for name in ("x", "y"):
                np.testing.assert_array_equal(a[name], b[name])
    for r in range(num_proc):
        a = E._load_shard(mine, mine.get_train_data_path("r"), r)
        b = jload(theirs, theirs.get_train_data_path("r"), r)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("case", ["small_chunk", "empty", "too_few_rows",
                                  "no_columns"])
def test_materialize_refusals_match_the_jax_package(tmp_path, case):
    pytest.importorskip("pandas")
    from horovod_tpu.estimator.dataframe import \
        materialize_dataframe as jmat

    from horovod_tpu_torch.estimator.dataframe import materialize_dataframe

    args = {"small_chunk": (_df(), ["f1"], ["label"], 4, 2),
            "empty": (_df(0), ["f1"], ["label"], 2, None),
            "too_few_rows": (_df(2), ["f1"], ["label"], 3, 3),
            "no_columns": (_df(), [], ["label"], 2, None)}[case]
    df, fc, lc, num_proc, rpc = args
    errs = []
    for fn in (materialize_dataframe, jmat):
        s = LocalStore(str(tmp_path / fn.__module__))
        with pytest.raises(ValueError) as e:
            fn(s, s.get_train_data_path("r"), df, fc, lc, num_proc,
               rows_per_chunk=rpc)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_fit_dataframe_chunked_trains_two_ranks(tmp_path):
    """``fit(df)`` with ``rows_per_chunk``: two ranks read the chunked
    layout through the manifest; the DataFrame's metadata is kept."""
    pd = pytest.importorskip("pandas")
    n = 120
    rng = np.random.RandomState(4)
    df = pd.DataFrame({"f1": rng.rand(n).astype(np.float32),
                       "f2": rng.rand(n).astype(np.float32),
                       "label": rng.randint(0, 3, n)})
    model = nn.Sequential(OrderedDict(Dense_0=Dense(2, 3)))
    init_weights(model, torch.Generator().manual_seed(0))
    est = JaxEstimator(model=model, store=LocalStore(str(tmp_path)),
                       num_proc=2, batch_size=16, epochs=1, lr=1e-2,
                       feature_cols=["f1", "f2"], label_cols=["label"],
                       rows_per_chunk=32, run_id="chunkrun")
    trained = est.fit(df)
    assert est.data_meta_["train_rows"] == n
    assert trained.predict(np.stack([df["f1"], df["f2"]], 1)).shape == \
        (n, 3)
    assert np.isfinite(trained.history).all()


def test_fit_df_without_columns_raises(tmp_path):
    est = JaxEstimator(model=port_mlp(), store=str(tmp_path))
    with pytest.raises(ValueError, match="feature_cols"):
        est.fit(_df())
