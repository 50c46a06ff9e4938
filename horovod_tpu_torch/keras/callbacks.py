"""Training-loop callbacks (counterpart of
``horovod_tpu/keras/callbacks.py``; reference
``horovod/_keras/callbacks.py``): ``BroadcastGlobalVariablesCallback``
(sync every rank to the root's model and optimizer state once, after the
first batch), ``MetricAverageCallback`` (all-reduce the epoch-end metric
logs so every rank reports the same numbers),
``LearningRateScheduleCallback`` / ``LearningRateWarmupCallback`` (the
epoch or fractional-epoch rate schedule with the momentum correction of
the large-minibatch SGD recipe).

The JAX package's callbacks rewrite an ``optax.inject_hyperparams``
state; here the mutable hyperparameters are the torch optimizer's own
``param_groups`` (``lr``, ``momentum``), found through the port's
``DistributedOptimizer`` wrapper (:func:`find_hyperparams`, which names
them as optax does: ``learning_rate`` and ``momentum``).  A
:class:`TrainingState` holds the ``(model, optimizer)`` pair an explicit
loop trains::

    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9))
    state = hvd.keras.TrainingState(model, opt)
    cbs = hvd.keras.CallbackList(
        [hvd.keras.BroadcastGlobalVariablesCallback(0),
         hvd.keras.MetricAverageCallback(),
         hvd.keras.LearningRateWarmupCallback(warmup_epochs=5,
                                              steps_per_epoch=steps)],
        state)
    cbs.on_train_begin()
    for epoch in range(epochs):
        cbs.on_epoch_begin(epoch)
        for batch in range(steps):
            cbs.on_batch_begin(batch)
            opt.zero_grad(); loss_fn(model(x), y).backward(); opt.step()
            cbs.on_batch_end(batch, logs)
        cbs.on_epoch_end(epoch, logs)

The fused tail's optimizers (``fused_update.sgd``/``adam``) freeze their
rates at construction, and their step never reads ``param_groups``: a
schedule would be ignored without a word, so they are refused.
"""

from __future__ import annotations

import numpy as np
import torch


class TrainingState:
    """The ``(model, optimizer)`` pair the callbacks act on, in place of
    Keras' model and optimizer objects (the JAX package's ``(params,
    opt_state)``)."""

    def __init__(self, model, optimizer) -> None:
        self.model = model
        self.optimizer = optimizer


class Hyperparams:
    """The optimizer's hyperparameters under optax's names:
    ``learning_rate`` is every parameter group's ``lr``, any other key
    the group's own.  A read takes the first group's value; a write sets
    every group's."""

    _NAMES = {"learning_rate": "lr"}

    def __init__(self, param_groups) -> None:
        self.param_groups = param_groups

    def _key(self, name: str) -> str:
        return self._NAMES.get(name, name)

    def __contains__(self, name) -> bool:
        return self._key(name) in self.param_groups[0]

    def __getitem__(self, name):
        return self.param_groups[0][self._key(name)]

    def __setitem__(self, name, value) -> None:
        for group in self.param_groups:
            group[self._key(name)] = value


def _unwrap(optimizer):
    """The torch optimizer inside the port's wrappers (the in-trace
    ``DistributedOptimizer`` and ``LocalSGD`` hold it as ``optimizer``
    or ``inner``; the eager frontend's wrapper is the optimizer)."""
    seen = set()
    while id(optimizer) not in seen:
        seen.add(id(optimizer))
        if isinstance(optimizer, torch.optim.Optimizer):
            return optimizer
        inner = getattr(optimizer, "__dict__", {})
        nxt = inner.get("optimizer", inner.get("inner"))
        if nxt is None:
            return None
        optimizer = nxt
    return None


def find_hyperparams(optimizer):
    """The mutable hyperparameters of ``optimizer`` (a torch optimizer,
    possibly wrapped), as a :class:`Hyperparams`; ``None`` when there are
    none the step reads: no torch optimizer inside, or a fused-tail
    optimizer whose rates are frozen in its ``fused_spec``."""
    opt = _unwrap(optimizer)
    if opt is None or not opt.param_groups:
        return None
    if getattr(opt, "fused_spec", None) is not None:
        return None
    return Hyperparams(opt.param_groups)


class Callback:
    """The hook protocol (the subset of the Keras callback surface the
    reference implements)."""

    state: TrainingState | None = None

    def set_state(self, state: TrainingState) -> None:
        self.state = state

    def on_train_begin(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_batch_begin(self, batch, logs=None):
        pass

    def on_batch_end(self, batch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks, state: TrainingState) -> None:
        self.callbacks = list(callbacks)
        for cb in self.callbacks:
            cb.set_state(state)

    def __iter__(self):
        return iter(self.callbacks)

    def on_train_begin(self, logs=None):
        for cb in self.callbacks:
            cb.on_train_begin(logs)

    def on_epoch_begin(self, epoch, logs=None):
        for cb in self.callbacks:
            cb.on_epoch_begin(epoch, logs)

    def on_batch_begin(self, batch, logs=None):
        for cb in self.callbacks:
            cb.on_batch_begin(batch, logs)

    def on_batch_end(self, batch, logs=None):
        for cb in self.callbacks:
            cb.on_batch_end(batch, logs)

    def on_epoch_end(self, epoch, logs=None):
        for cb in self.callbacks:
            cb.on_epoch_end(epoch, logs)


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast rank ``root_rank``'s model state and optimizer state to
    every rank once, after the first processed batch (reference
    ``BroadcastGlobalVariablesCallbackImpl.on_batch_end``: deferred past
    batch 0 so any data-dependent initialization has happened)."""

    def __init__(self, root_rank: int = 0) -> None:
        self.root_rank = root_rank
        self.broadcast_done = False

    def on_batch_end(self, batch, logs=None):
        if self.broadcast_done:
            return
        from horovod_tpu_torch.optim.distributed import (
            broadcast_optimizer_state, broadcast_parameters)

        broadcast_parameters(self.state.model, self.root_rank)
        broadcast_optimizer_state(self.state.optimizer, self.root_rank)
        self.broadcast_done = True


class MetricAverageCallback(Callback):
    """All-reduce-average the epoch-end metrics across ranks in place,
    sorted by name so every rank issues the same collectives in the same
    order (reference ``MetricAverageCallbackImpl.
    _average_metrics_in_place``).  Entries that are not numbers stay."""

    def on_epoch_end(self, epoch, logs=None):
        if not logs:
            return
        from horovod_tpu_torch.common.basics import device
        from horovod_tpu_torch.ops.eager import allreduce

        reduced = {}
        for metric in sorted(logs):
            value = logs[metric]
            if not isinstance(value, (int, float, np.floating, np.integer,
                                      np.ndarray, torch.Tensor)):
                continue
            t = torch.as_tensor(value, dtype=torch.float32).to(device())
            out = allreduce(t, name=f"metric.{metric}.{epoch}")
            reduced[metric] = float(out)
        logs.update(reduced)


class LearningRateScheduleCallback(Callback):
    """Multiply the optimizer's rate at ``on_train_begin`` by
    ``multiplier(epoch)`` within ``[start_epoch, end_epoch)``; with
    ``staircase=False`` the multiplier sees fractional epochs per batch.
    ``momentum_correction`` rescales the momentum by ``new_lr / old_lr``
    for the batch the rate changed on and restores it after (reference
    ``LearningRateScheduleCallbackImpl``, after the momentum-correction
    note of the large-minibatch SGD paper)."""

    def __init__(self, multiplier, start_epoch: int = 0, end_epoch=None,
                 staircase: bool = True, momentum_correction: bool = True,
                 steps_per_epoch=None) -> None:
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.momentum_correction = momentum_correction
        self.steps_per_epoch = steps_per_epoch
        self.initial_lr = None
        self.restore_momentum = None
        self.current_epoch = 0
        if not callable(multiplier):
            self.staircase = True
            self.multiplier = lambda epoch: multiplier
        else:
            self.multiplier = multiplier

    def _hp(self) -> Hyperparams:
        hp = find_hyperparams(self.state.optimizer)
        if hp is None or "learning_rate" not in hp:
            raise ValueError(
                "LearningRateScheduleCallback requires a torch optimizer "
                "whose param_groups' 'lr' its step reads (torch.optim.*), "
                "so the LR is a mutable hyperparameter; the fused tail's "
                "fused_update.sgd/adam freeze their rates at "
                "construction.")
        return hp

    def _adjust_learning_rate(self, epoch) -> None:
        hp = self._hp()
        old_lr = float(hp["learning_rate"])
        new_lr = self.initial_lr * self.multiplier(epoch)
        hp["learning_rate"] = new_lr
        if self.momentum_correction and "momentum" in hp and old_lr > 0:
            self.restore_momentum = float(hp["momentum"])
            hp["momentum"] = self.restore_momentum * new_lr / old_lr

    def _restore_momentum_if_needed(self) -> None:
        if self.restore_momentum is not None:
            self._hp()["momentum"] = self.restore_momentum
            self.restore_momentum = None

    def on_train_begin(self, logs=None):
        self.initial_lr = float(self._hp()["learning_rate"])
        if not self.staircase and not self.steps_per_epoch:
            raise ValueError(
                "Could not autodetect the number of steps per epoch. Please "
                "specify the steps_per_epoch parameter to the "
                f"{self.__class__.__name__}().")

    def on_epoch_begin(self, epoch, logs=None):
        self.current_epoch = epoch

    def on_batch_begin(self, batch, logs=None):
        if (self.current_epoch < self.start_epoch or
                (self.end_epoch is not None and
                 self.current_epoch >= self.end_epoch)):
            return
        if self.staircase and batch == 0:
            self._adjust_learning_rate(self.current_epoch)
        elif not self.staircase:
            epoch = self.current_epoch + float(batch) / self.steps_per_epoch
            self._adjust_learning_rate(epoch)

    def on_batch_end(self, batch, logs=None):
        self._restore_momentum_if_needed()

    def on_epoch_end(self, epoch, logs=None):
        if logs is not None:
            logs["lr"] = float(self._hp()["learning_rate"])


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Gradual warmup from ``lr / size`` to ``lr`` over ``warmup_epochs``
    (reference ``LearningRateWarmupCallbackImpl``; the multiplier is
    ``1/size * (epoch * (size-1)/warmup + 1)``, with the ``+1/steps``
    nudge that rounds the end-of-epoch value)."""

    def __init__(self, warmup_epochs: int = 5,
                 momentum_correction: bool = True, steps_per_epoch=None,
                 verbose: int = 0) -> None:
        from horovod_tpu_torch.common.util import validate_warmup_epochs

        validate_warmup_epochs(warmup_epochs)

        def multiplier(epoch):
            from horovod_tpu_torch.common.basics import size

            epoch += 1.0 / self.steps_per_epoch
            return 1.0 / size() * (epoch * (size() - 1) / warmup_epochs + 1)

        super().__init__(multiplier, start_epoch=0, end_epoch=warmup_epochs,
                         staircase=False,
                         momentum_correction=momentum_correction,
                         steps_per_epoch=steps_per_epoch)
        self.verbose = verbose

    def on_epoch_end(self, epoch, logs=None):
        super().on_epoch_end(epoch, logs)
        if epoch == self.end_epoch - 1 and self.verbose > 0:
            new_lr = float(self._hp()["learning_rate"])
            print(f"\nEpoch {epoch + 1}: finished gradual learning rate "
                  f"warmup to {new_lr:g}.")
