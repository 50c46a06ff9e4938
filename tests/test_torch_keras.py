"""``horovod_tpu_torch.keras`` against ``horovod_tpu.keras``, case by case
against the oracle ``tests/test_keras_callbacks.py``: the same schedules
drive a torch optimizer's ``param_groups`` under the port's
``DistributedOptimizer`` and an ``optax.inject_hyperparams`` state under
the JAX package's, and the rate and momentum each batch sees are equal.
Tolerance: rtol 1e-6 (the JAX package keeps the hyperparameters as
float32 arrays, the port as Python floats).  The fused tail's optimizers,
whose rates are frozen at construction, are refused."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import keras as pk
from horovod_tpu_torch.optim import fused_update

RTOL = 1e-6


@pytest.fixture()
def worlds(hvd_single):
    hvd.init(device="cpu")
    yield hvd_single
    hvd.shutdown()


def _jax_state(lr=0.1, momentum=0.9):
    import horovod_tpu.keras as jk

    opt = hvd_jax().DistributedOptimizer(
        optax.inject_hyperparams(optax.sgd)(learning_rate=lr,
                                            momentum=momentum))
    params = {"w": jnp.ones((4,))}
    return opt, jk.TrainingState(params, opt.init(params))


def hvd_jax():
    import horovod_tpu

    return horovod_tpu


def _port_state(lr=0.1, momentum=0.9, wrap=True):
    model = torch.nn.Linear(4, 1, bias=False)
    torch.nn.init.ones_(model.weight)
    base = torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum)
    opt = hvd.DistributedOptimizer(base) if wrap else base
    return opt, pk.TrainingState(model, opt)


def _jhp(state):
    from horovod_tpu.keras import find_hyperparams

    hp = find_hyperparams(state.opt_state)
    return (float(np.asarray(hp["learning_rate"])),
            float(np.asarray(hp["momentum"])))


def _php(state):
    hp = pk.find_hyperparams(state.optimizer)
    return float(hp["learning_rate"]), float(hp["momentum"])


def _drive(make_cbs, jk_mod, state, epochs, steps, read):
    """Run a callback list over ``epochs`` x ``steps`` batches; the
    (rate, momentum) inside every batch and after it, and the epoch
    logs."""
    cbs = make_cbs(jk_mod, state)
    seen, logs_all = [], []
    cbs.on_train_begin()
    for epoch in range(epochs):
        cbs.on_epoch_begin(epoch)
        for b in range(steps):
            cbs.on_batch_begin(b)
            during = read(state)
            cbs.on_batch_end(b)
            seen.append((during, read(state)))
        logs = {}
        cbs.on_epoch_end(epoch, logs)
        logs_all.append(logs)
    return seen, logs_all


SCHEDULES = {
    "staircase": lambda m: [m.LearningRateScheduleCallback(
        lambda epoch: 0.5 ** epoch, staircase=True,
        momentum_correction=False)],
    "window": lambda m: [m.LearningRateScheduleCallback(
        10.0, start_epoch=2, end_epoch=3, momentum_correction=False)],
    "momentum_correction": lambda m: [m.LearningRateScheduleCallback(
        2.0, momentum_correction=True)],
    "fractional": lambda m: [m.LearningRateScheduleCallback(
        lambda epoch: 1.0 / (1.0 + epoch), staircase=False,
        steps_per_epoch=3)],
    "warmup": lambda m: [m.LearningRateWarmupCallback(
        warmup_epochs=3, steps_per_epoch=3, momentum_correction=False)],
    "warmup_then_decay": lambda m: [
        m.LearningRateWarmupCallback(warmup_epochs=2, steps_per_epoch=3),
        m.LearningRateScheduleCallback(0.1, start_epoch=2, end_epoch=3),
        m.LearningRateScheduleCallback(0.01, start_epoch=3)],
}


@pytest.mark.parametrize("size", [1, 4])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_rates_and_momentum_per_batch_equal_the_jax_packages(
        worlds, monkeypatch, name, size):
    """Each schedule over 4 epochs of 3 batches: the rate and momentum
    inside every batch and after it, and the logged rate; at a faked
    size of 4 too (the warmup's multiplier reads it)."""
    import horovod_tpu.common.basics as jbasics
    import horovod_tpu.keras as jk

    from horovod_tpu_torch.common import basics as pbasics

    monkeypatch.setattr(jbasics, "size", lambda: size)
    monkeypatch.setattr(pbasics, "size", lambda: size)

    def make(mod, state):
        return mod.CallbackList(SCHEDULES[name](mod), state)

    _, jstate = _jax_state(lr=0.4, momentum=0.9)
    _, pstate = _port_state(lr=0.4, momentum=0.9)
    want, wlogs = _drive(make, jk, jstate, 4, 3, _jhp)
    got, glogs = _drive(make, pk, pstate, 4, 3, _php)
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=RTOL)
    for a, b in zip(glogs, wlogs):
        assert a.keys() == b.keys()
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=RTOL)


def test_find_hyperparams_through_the_wrappers(worlds):
    """Through the in-trace ``DistributedOptimizer``, the eager frontend's
    wrapper and a bare torch optimizer: the values the JAX package finds
    in its injected state."""
    import horovod_tpu_torch.torch as thvd

    _, jstate = _jax_state()
    want = _jhp(jstate)
    for wrap in (True, False):
        _, st = _port_state(wrap=wrap)
        assert _php(st) == pytest.approx(want, rel=RTOL)
    model = torch.nn.Linear(2, 2)
    eager = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    assert _php(pk.TrainingState(model, eager)) == pytest.approx(want,
                                                                 rel=RTOL)
    assert pk.find_hyperparams({"no": "hyperparams"}) is None
    hp = pk.find_hyperparams(eager)
    hp["learning_rate"] = 0.5
    assert eager.param_groups[0]["lr"] == 0.5


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam", "plain"])
def test_schedules_refuse_frozen_or_missing_rates(worlds, kind):
    """The fused tail's optimizers freeze their rates in ``fused_spec``
    (a write to ``param_groups`` would be ignored without a word), so the
    schedule refuses them with the error the JAX package raises for an
    optax optimizer without injected hyperparameters."""
    import horovod_tpu.keras as jk

    model = torch.nn.Linear(2, 1)
    if kind == "plain":
        opt = object()
    elif kind == "adam":
        opt = hvd.DistributedOptimizer(fused_update.adam(
            model.parameters(), 0.1))
    else:
        opt = hvd.DistributedOptimizer(fused_update.sgd(
            model.parameters(), 0.1,
            momentum=0.9 if kind == "momentum" else None))
    for mod, state in (
            (pk, pk.TrainingState(model, opt)),
            (jk, jk.TrainingState({"w": jnp.ones(2)},
                                  hvd_jax().DistributedOptimizer(
                                      optax.sgd(0.1)).init(
                                      {"w": jnp.ones(2)})))):
        cbs = mod.CallbackList([mod.LearningRateScheduleCallback(0.5)],
                               state)
        with pytest.raises(ValueError):
            cbs.on_train_begin()


def test_warmup_multiplier_math_multirank(worlds, monkeypatch):
    from horovod_tpu_torch.common import basics

    cb = pk.LearningRateWarmupCallback(warmup_epochs=5, steps_per_epoch=10)
    monkeypatch.setattr(basics, "size", lambda: 4)
    assert cb.multiplier(0.0) == pytest.approx((1 / 4) * ((0.1 * 3 / 5) + 1))
    assert cb.multiplier(5.0 - 1.0 / 10) == pytest.approx(1.0)


def test_warmup_guard():
    pk.LearningRateWarmupCallback(warmup_epochs=np.int64(3))
    pk.LearningRateWarmupCallback(warmup_epochs=3.0)
    with pytest.raises(TypeError, match="positive integer"):
        pk.LearningRateWarmupCallback(0.001, 1)


def test_steps_per_epoch_required():
    _, st = _port_state(wrap=False)
    cbs = pk.CallbackList([pk.LearningRateScheduleCallback(
        lambda e: 1.0, staircase=False)], st)
    with pytest.raises(ValueError, match="steps_per_epoch"):
        cbs.on_train_begin()


def test_metric_average_matches_the_jax_package(worlds):
    import horovod_tpu.keras as jk

    logs = {"loss": 2.5, "acc": np.float32(0.75), "n": 3,
            "t": torch.tensor(1.25), "name": "skipme"}
    jlogs = {"loss": 2.5, "acc": np.float32(0.75), "n": 3, "t": 1.25,
             "name": "skipme"}
    _, st = _port_state()
    pk.CallbackList([pk.MetricAverageCallback()], st).on_epoch_end(0, logs)
    _, jst = _jax_state()
    jk.CallbackList([jk.MetricAverageCallback()], jst).on_epoch_end(0, jlogs)
    assert logs == jlogs


def test_broadcast_callback_runs_once(worlds, monkeypatch):
    from horovod_tpu_torch.optim import distributed

    calls = []
    real = distributed.broadcast_parameters
    monkeypatch.setattr(distributed, "broadcast_parameters",
                        lambda *a: calls.append(a) or real(*a))
    _, st = _port_state()
    cb = pk.BroadcastGlobalVariablesCallback(0)
    cbs = pk.CallbackList([cb], st)
    assert not cb.broadcast_done
    cbs.on_batch_end(0)
    assert cb.broadcast_done and len(calls) == 1
    cbs.on_batch_end(1)
    assert len(calls) == 1
    assert torch.equal(st.model.weight, torch.ones(1, 4))


def test_full_loop_matches_the_jax_package(worlds):
    """The oracle's loop (warmup, metric averaging, broadcast) on
    ``sum(w ** 2)``: momentum SGD through ``torch.optim.SGD`` under the
    port's wrapper and ``optax.sgd`` under the JAX package's take the
    same steps (rtol 1e-6), and the loss falls tenfold."""
    import horovod_tpu.keras as jk

    jopt = hvd_jax().DistributedOptimizer(
        optax.inject_hyperparams(optax.sgd)(learning_rate=0.3,
                                            momentum=0.5))
    jparams = {"w": jnp.array([2.0, -3.0])}
    jstate = jk.TrainingState(jparams, jopt.init(jparams))
    w = torch.nn.Parameter(torch.tensor([2.0, -3.0]))
    holder = torch.nn.Module()
    holder.w = w
    popt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.3,
                                                    momentum=0.5))
    pstate = pk.TrainingState(holder, popt)

    def cbs_for(mod, state):
        return mod.CallbackList([mod.BroadcastGlobalVariablesCallback(0),
                                 mod.MetricAverageCallback(),
                                 mod.LearningRateWarmupCallback(
                                     warmup_epochs=2, steps_per_epoch=4)],
                                state)

    def jloss(p):
        return jnp.sum(p["w"] ** 2)

    jcbs, pcbs = cbs_for(jk, jstate), cbs_for(pk, pstate)
    jcbs.on_train_begin()
    pcbs.on_train_begin()
    losses = []
    for epoch in range(3):
        jcbs.on_epoch_begin(epoch)
        pcbs.on_epoch_begin(epoch)
        for b in range(4):
            jcbs.on_batch_begin(b)
            grads = jax.grad(jloss)(jstate.params)
            upd, jstate.opt_state = jopt.update(grads, jstate.opt_state,
                                                jstate.params)
            jstate.params = optax.apply_updates(jstate.params, upd)
            jcbs.on_batch_end(b)
            pcbs.on_batch_begin(b)
            popt.zero_grad()
            (w ** 2).sum().backward()
            popt.step()
            pcbs.on_batch_end(b)
            np.testing.assert_allclose(w.detach().numpy(),
                                       np.asarray(jstate.params["w"]),
                                       rtol=RTOL)
        jlogs = {"loss": float(jloss(jstate.params))}
        plogs = {"loss": float((w ** 2).sum())}
        jcbs.on_epoch_end(epoch, jlogs)
        pcbs.on_epoch_end(epoch, plogs)
        np.testing.assert_allclose(plogs["loss"], jlogs["loss"], rtol=RTOL)
        losses.append(plogs["loss"])
    assert losses[-1] < losses[0] * 0.1


def test_keras_namespace(worlds):
    """The JAX package's public names resolve in the port's module."""
    import horovod_tpu.keras as jk

    for name in ("BroadcastGlobalVariablesCallback", "Callback",
                 "CallbackList", "LearningRateScheduleCallback",
                 "LearningRateWarmupCallback", "MetricAverageCallback",
                 "TrainingState", "find_hyperparams", "DistributedOptimizer",
                 "broadcast_global_variables", "Compression", "allgather",
                 "allreduce", "broadcast", "init", "local_rank",
                 "local_size", "rank", "shutdown", "size", "load_model"):
        assert hasattr(jk, name) and hasattr(pk, name), name
    assert pk.rank() == 0 and pk.size() == 1
    m = torch.nn.Linear(2, 2)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    pk.broadcast_global_variables(m, 0)
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k])
