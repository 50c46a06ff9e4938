"""tf.keras callbacks (counterpart of
``horovod_tpu/tensorflow/keras/callbacks.py``; reference
``horovod/_keras/callbacks.py`` through
``horovod/tensorflow/keras/callbacks.py``).

* ``BroadcastGlobalVariablesCallback``: broadcast the model's and the
  optimizer's variables from the root rank after the first batch (the
  reference waits for batch 0 so deferred variable creation has
  happened, ``_keras/callbacks.py:28-44``);
* ``MetricAverageCallback``: all-reduce-average the epoch metrics across
  ranks before other callbacks (checkpointers, schedulers) read them
  (``:46-84``);
* ``LearningRateWarmupCallback``: linear warmup from a base rate to the
  size-scaled rate over the first epochs (``:120-185``).
"""

from __future__ import annotations

import tensorflow as tf

from horovod_tpu_torch.common import logging as _log
from horovod_tpu_torch.common.basics import rank, size
from horovod_tpu_torch.ops.eager import Average
from horovod_tpu_torch.tensorflow import allreduce, broadcast_variables

_warned_momentum = False


class BroadcastGlobalVariablesCallback(tf.keras.callbacks.Callback):
    """Sync every rank to the root's initial state on the first batch
    — after Keras has materialized model and optimizer variables."""

    def __init__(self, root_rank: int = 0, device: str = ""):
        super().__init__()
        self.root_rank = root_rank
        self.broadcast_done = False

    def on_batch_end(self, batch, logs=None):
        if self.broadcast_done:
            return
        if hasattr(self.model, "variables"):
            broadcast_variables(self.model.variables,
                                root_rank=self.root_rank)
            opt = getattr(self.model, "optimizer", None)
            if opt is not None:
                opt_vars = (opt.variables() if callable(
                    getattr(opt, "variables", None)) else
                    getattr(opt, "variables", []))
                broadcast_variables(list(opt_vars),
                                    root_rank=self.root_rank)
        self.broadcast_done = True


class MetricAverageCallback(tf.keras.callbacks.Callback):
    """Average epoch-end metrics over ranks in place, so downstream
    callbacks see the same value everywhere."""

    def on_epoch_end(self, epoch, logs=None):
        if logs is None or size() == 1:
            return
        for metric, value in sorted(logs.items()):
            try:
                avg = allreduce(tf.constant(float(value), tf.float32),
                                op=Average, name=f"metric.{metric}")
            except (TypeError, ValueError):
                continue  # non-scalar entry (e.g. nested dict)
            logs[metric] = float(avg.numpy())


def _get_lr(opt) -> float:
    cur = opt.learning_rate
    if hasattr(cur, "numpy"):
        return float(cur.numpy())
    if isinstance(cur, (int, float)):
        return float(cur)
    raise ValueError(
        f"the optimizer's learning_rate is a {type(cur).__name__}, not a "
        "scalar — the LR schedule/warmup callbacks drive the rate "
        "themselves and cannot compose with a LearningRateSchedule "
        "object; compile the optimizer with a plain float LR.")


def _assign_lr(opt, lr: float) -> None:
    try:
        opt.learning_rate.assign(lr)
    except AttributeError:
        opt.learning_rate = lr


class LearningRateScheduleCallback(tf.keras.callbacks.Callback):
    """Multiply the optimizer's compile-time LR by ``multiplier(epoch)``
    within [start_epoch, end_epoch); ``staircase=False`` feeds
    fractional epochs per batch (requires ``steps_per_epoch``).
    ``momentum_correction`` rescales SGD momentum by new_lr/old_lr for
    the batch the LR changed on and restores it after (reference
    ``_keras/callbacks.py`` LearningRateScheduleCallbackImpl; same
    structure as the sibling in ``horovod_tpu_torch/keras/callbacks.py``).
    The base LR is captured once at ``on_train_begin`` so stacked
    schedule instances (the standard step-decay recipe) don't compound
    each other's multipliers."""

    def __init__(self, multiplier, start_epoch: int = 0, end_epoch=None,
                 staircase: bool = True, momentum_correction: bool = True,
                 steps_per_epoch=None):
        super().__init__()
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

    def _adjust_learning_rate(self, epoch) -> None:
        opt = self.model.optimizer
        old_lr = _get_lr(opt)
        new_lr = self.initial_lr * float(self.multiplier(epoch))
        _assign_lr(opt, new_lr)
        momentum = getattr(opt, "momentum", None)
        if (self.momentum_correction and momentum is not None
                and not callable(momentum) and old_lr > 0
                and new_lr != old_lr):
            if hasattr(momentum, "assign"):  # mutable variable: works
                self.restore_momentum = float(momentum.numpy())
                momentum.assign(self.restore_momentum * new_lr / old_lr)
            else:
                # Keras 3 stores SGD momentum as a plain float that the
                # traced train_function bakes in as a constant —
                # mutating the attribute would silently do nothing
                # under model.fit.  Be honest: warn once and skip.
                global _warned_momentum
                if not _warned_momentum:
                    _warned_momentum = True
                    _log.warning(
                        "momentum_correction requested but this "
                        "optimizer's momentum is a compile-time "
                        "constant (Keras 3); the correction cannot be "
                        "applied under a traced train step and is "
                        "skipped.")

    def _restore_momentum_if_needed(self) -> None:
        if self.restore_momentum is not None:
            self.model.optimizer.momentum.assign(self.restore_momentum)
            self.restore_momentum = None

    def on_train_begin(self, logs=None):
        # unconditional recapture, matching the reference and the
        # sibling: a second fit() re-bases on the current LR
        self.initial_lr = _get_lr(self.model.optimizer)
        if not self.staircase and not self.steps_per_epoch:
            self.steps_per_epoch = (self.params or {}).get("steps")
            if not self.steps_per_epoch:
                raise ValueError(
                    "Could not autodetect the number of steps per epoch. "
                    "Please specify the steps_per_epoch parameter to the "
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
            logs["lr"] = _get_lr(self.model.optimizer)


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Gradual warmup from lr/size to the compile-time (already
    size-scaled) lr over ``warmup_epochs`` — the reference's
    ``LearningRateWarmupCallbackImpl`` semantics and multiplier math:
    ``1/size * (epoch * (size-1)/warmup + 1)``.  Being a Schedule with
    window [0, warmup_epochs), it never touches the LR after warmup —
    resuming training past warmup leaves a restored/decayed LR alone."""

    def __init__(self, warmup_epochs: int = 5,
                 momentum_correction: bool = True, steps_per_epoch=None,
                 verbose: int = 0):
        from horovod_tpu_torch.common.util import validate_warmup_epochs

        validate_warmup_epochs(warmup_epochs)

        def multiplier(epoch):
            epoch += 1.0 / self.steps_per_epoch
            return 1.0 / size() * (epoch * (size() - 1) / warmup_epochs + 1)

        super().__init__(multiplier, start_epoch=0,
                         end_epoch=warmup_epochs, staircase=False,
                         momentum_correction=momentum_correction,
                         steps_per_epoch=steps_per_epoch)
        self.verbose = verbose

    def on_epoch_end(self, epoch, logs=None):
        super().on_epoch_end(epoch, logs)
        if epoch == self.end_epoch - 1 and self.verbose and rank() == 0:
            print(f"\nEpoch {epoch + 1}: finished gradual learning rate "
                  f"warmup to {_get_lr(self.model.optimizer):g}.")
