"""Estimator API (counterpart of ``horovod_tpu/estimator/estimator.py``;
reference ``horovod/spark/common/estimator.py:28-60``): ``fit``
materializes the data into a :class:`Store`, launches distributed
training through the launcher's run-function mode
(:func:`horovod_tpu_torch.run.run`, one process per card), keeps a
checkpoint per run and returns a trained model for inference.

Two estimators mirror the JAX package's pair:

- :class:`JaxEstimator` keeps the JAX package's name, which
  ``spark/keras.py`` and users' import lines name.  It drives the port's
  **in-trace plane**: an ``nn.Module`` trained under the top-level
  :func:`horovod_tpu_torch.DistributedOptimizer` over an optimizer named
  as optax names it (``"sgd"`` is :func:`fused_update.sgd` with momentum
  0.9, ``"adam"`` :func:`fused_update.adam`, so under
  ``HOROVOD_FUSED_UPDATE=1`` kernels B1 and B3 run the update;
  ``"adamw"`` is optax's ``adamw`` in plain PyTorch operations).  The
  JAX package builds the weights on every rank from ``seed``; a torch
  module carries its own, so the driver sends the module and the ranks
  broadcast rank 0's parameters.
- :class:`TorchEstimator` trains over the hook-driven frontend
  :mod:`horovod_tpu_torch.torch` (the eager plane) with a
  ``torch.optim`` optimizer.

Every rank trains on ``hvd.device()`` (the card unless
``HOROVOD_PLATFORM=cpu``), and the trained models predict on the
driver's device by the same rule.

The training functions, losses and optimizers below are module-level:
without ``cloudpickle`` (the card's machine has none) the launcher
pickles the training function with ``pickle``, which takes functions by
reference only.  A loss that ``pickle`` cannot take (a lambda, a closure)
is refused on the driver before any data moves or any rank starts.
"""

from __future__ import annotations

import io
import pickle
import time
import uuid

import numpy as np
import torch

from horovod_tpu_torch.estimator.store import Store


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _shard_to_store(store: Store, path: str, x, y, num_proc: int) -> None:
    store.make_dir(path)
    x = np.asarray(x)
    y = np.asarray(y)
    for r in range(num_proc):
        store.write_bytes(f"{path}/part.{r}.npz",
                          _npz_bytes(x=x[r::num_proc], y=y[r::num_proc]))


def _load_shard(store: Store, path: str, rank: int):
    """One rank's training shard: the single ``part.{rank}.npz`` of the
    array and one-shot paths, or the concatenation of this rank's
    ``part.{rank}.c{i}.npz`` chunks when the streaming DataFrame ingest
    wrote a manifest (``dataframe.materialize_dataframe``)."""

    def _npz(key):
        return np.load(io.BytesIO(store.read_bytes(key)),
                       allow_pickle=False)

    if store.exists(f"{path}/manifest.json"):
        import json

        man = json.loads(store.read_bytes(f"{path}/manifest.json"))
        n = man["chunks_per_rank"][rank]
        if n == 0:
            raise RuntimeError(
                f"rank {rank} received no data chunks — dataset too "
                f"small for {len(man['chunks_per_rank'])} ranks")
        xs, ys = [], []
        for i in range(n):
            with _npz(f"{path}/part.{rank}.c{i}.npz") as z:
                xs.append(z["x"])
                ys.append(z["y"])
        return np.concatenate(xs), np.concatenate(ys)
    with _npz(f"{path}/part.{rank}.npz") as z:
        return z["x"], z["y"]


def _split_validation(x, y, fraction: float):
    """Hold the shard's tail out for validation (the reference
    estimator's ``validation``: a fraction of the training data scored
    every epoch and never trained on)."""
    if not fraction:
        return x, y, None, None
    n_val = max(1, int(len(x) * fraction)) if len(x) else 0
    if n_val == 0 or n_val >= len(x):
        return x, y, None, None
    return x[:-n_val], y[:-n_val], x[-n_val:], y[-n_val:]


def _pickler():
    """What :func:`horovod_tpu_torch.run.run` pickles the training
    function with: ``cloudpickle`` where installed, else ``pickle``."""
    try:
        import cloudpickle as pickler  # type: ignore
    except ImportError:
        pickler = pickle
    return pickler


def _require_picklable(what: str, obj) -> None:
    try:
        _pickler().dumps(obj)
    except Exception as exc:  # noqa: BLE001 -- re-raised with the cause
        raise TypeError(
            f"{what}={obj!r} cannot be pickled for the ranks ({exc}); "
            "without cloudpickle the launcher sends functions by "
            "reference only: pass a module-level function (or install "
            "cloudpickle on the driver and every host)") from exc


def _device(device=None) -> torch.device:
    """Where a rank trains and a trained model predicts: ``device`` when
    given; else the device :func:`~horovod_tpu_torch.init` bound this
    process to; else the card, unless ``HOROVOD_PLATFORM=cpu`` asks for
    the CPU."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.util import resolve_device

    if device is not None:
        return resolve_device(device)
    if basics.is_initialized():
        return basics.device()
    return resolve_device(basics._platform_device())


def _inputs(x: np.ndarray) -> torch.Tensor:
    """Model inputs on the host: floating data as float32 (as JAX takes
    a float64 array under its default 32-bit mode), anything else as
    it is."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.float() if t.is_floating_point() else t


def _launch_counts() -> dict:
    """This process's hand-kernel launches so far, by kernel (each
    wrapper counts its own launches on the card; the CPU runs the plain
    versions and counts none), and the flight ring's event count."""
    from horovod_tpu_torch.ops import batch_norm, flash_attention, \
        quantization
    from horovod_tpu_torch.optim import fused_update
    from horovod_tpu_torch.runtime import flight

    counts = {k: v for mod in (fused_update, quantization, batch_norm,
                               flash_attention)
              for k, v in mod.LAUNCHES.items()}
    counts["flight_seq"] = flight.recorder().recorded_total()
    return counts


def _launches_since(before: dict) -> dict:
    """The launches since ``before``, and ``allreduce_responses``: the
    eager plane's all-reduce responses this process executed since then
    (its flight ring's ``dispatch`` spans; ``None`` where the ring
    wrapped past them)."""
    from horovod_tpu_torch.runtime import flight

    now = _launch_counts()
    out = {k: v - before[k] for k, v in now.items() if k != "flight_seq"}
    ring = flight.recorder()
    if now["flight_seq"] - before["flight_seq"] > ring.capacity:
        out["allreduce_responses"] = None
    else:
        out["allreduce_responses"] = sum(
            1 for e in ring.snapshot()
            if e["seq"] >= before["flight_seq"] and e["kind"] == "dispatch"
            and e["ph"] == "B" and e.get("collective") == "allreduce")
    return out


class EstimatorBase:
    """Shared ``fit()`` orchestration (reference ``HorovodEstimator``).
    After a fit, ``rank_results_`` holds every rank's returned
    ``(state, history, val_history, counts)`` in rank order, where
    ``counts`` holds that rank's hand-kernel launches during its
    training, by kernel, and its eager ``allreduce_responses``."""

    def __init__(self, *, store: Store | str, num_proc: int = 1,
                 batch_size: int = 32, epochs: int = 1,
                 validation: float = 0.0, run_id: str | None = None,
                 verbose: bool = False, feature_cols=None,
                 label_cols=None, rows_per_chunk: int | None = None):
        self.store = (Store.create(store) if isinstance(store, str)
                      else store)
        # the DataFrame ingest's column selection (reference estimator
        # params, ``spark/common/params.py``: feature_cols/label_cols)
        self.feature_cols = list(feature_cols) if feature_cols else None
        self.label_cols = list(label_cols) if label_cols else None
        # bounded-memory streaming ingest for fit(df), see
        # dataframe.materialize_dataframe
        self.rows_per_chunk = rows_per_chunk
        self.num_proc = num_proc
        self.batch_size = batch_size
        self.epochs = epochs
        if not 0.0 <= validation < 1.0:
            raise ValueError(
                f"validation must be a fraction in [0, 1), got "
                f"{validation!r} (the reference estimator's validation "
                "split parameter)")
        self.validation = validation
        self.run_id = run_id
        self.verbose = verbose

    def _new_run_id(self) -> str:
        return self.run_id or (
            time.strftime("%Y%m%d-%H%M%S") + "-" + uuid.uuid4().hex[:6])

    def fit(self, x, y=None):
        """Shard the data into the store, train on ``num_proc`` ranks,
        checkpoint every epoch (rank 0), return a trained model.

        Two input forms (reference ``HorovodEstimator.fit``): ``fit(x,
        y)`` with arrays, or ``fit(df)`` with a DataFrame and
        ``feature_cols``/``label_cols`` set on the estimator; the
        DataFrame materializes into the store first
        (``spark/common/util.py:360-608``)."""
        from horovod_tpu_torch.run import run as run_fn

        for what, obj in self._callables().items():
            _require_picklable(what, obj)
        run_id = self._new_run_id()
        train_path = self.store.get_train_data_path(run_id)
        ckpt_path = self.store.get_checkpoint_path(run_id)
        self.store.make_dir(ckpt_path)
        if y is None:
            if not (self.feature_cols and self.label_cols):
                raise ValueError(
                    "fit(df) requires feature_cols and label_cols on the "
                    "estimator (reference estimator params); or call "
                    "fit(x, y) with arrays")
            from horovod_tpu_torch.estimator.dataframe import \
                materialize_dataframe

            self.data_meta_ = materialize_dataframe(
                self.store, train_path, x, self.feature_cols,
                self.label_cols, self.num_proc,
                rows_per_chunk=self.rows_per_chunk)
        else:
            _shard_to_store(self.store, train_path, x, y, self.num_proc)
        spec = self._remote_spec(train_path, ckpt_path)
        # the ranks do all artifact IO through the store object, so a
        # KVStore needs no shared filesystem: it travels in the spec as
        # (addr, port, secret) and each rank connects at its first IO
        spec["store"] = self.store
        try:
            results = run_fn(self._remote_fn(), args=(spec,),
                             np=self.num_proc, verbose=self.verbose)
        finally:
            self.store.cleanup_run(run_id)
        self.rank_results_ = results
        return self._wrap_model(results[0], run_id)

    # subclass hooks -------------------------------------------------------
    def _callables(self) -> dict:
        """The spec's user callables, checked for picklability first."""
        return {}

    def _remote_spec(self, train_path: str, ckpt_path: str) -> dict:
        raise NotImplementedError

    def _remote_fn(self):
        raise NotImplementedError

    def _wrap_model(self, result, run_id: str):
        raise NotImplementedError


def _save_checkpoint(spec: dict, blob: dict) -> None:
    buf = io.BytesIO()
    torch.save(blob, buf)
    spec["store"].write_bytes(f"{spec['ckpt_path']}/last.ckpt",
                              buf.getvalue())


def _host_state(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in
            model.state_dict().items()}


def _validation_loss(model, loss_fn, vx, vy, batch: int, dev):
    """``(sum, count)`` of the per-sample validation loss on this rank,
    in eval mode (dropout and BatchNorm statistics untouched)."""
    vsum = vcount = 0.0
    if vx is None:
        return vsum, vcount
    model.eval()
    with torch.no_grad():
        for i in range(0, len(vx), batch):
            bx = vx[i:i + batch].to(dev)
            vsum += float(loss_fn(model(bx), vy[i:i + batch].to(dev))) \
                * len(bx)
            vcount += len(bx)
    model.train()
    return vsum, vcount


def _reduced_validation(allreduce, sum_op, vsum, vcount, epoch, dev):
    """The (sum, count) all-reduce that EVERY rank issues, even with an
    empty local split: a collective on some ranks only would deadlock
    the ranks that do have validation data."""
    tot = allreduce(torch.tensor([vsum, vcount], dtype=torch.float32,
                                 device=dev), op=sum_op,
                    name=f"est_val_loss.{epoch}")
    tot = tot.cpu().numpy()
    return float(tot[0] / tot[1]) if tot[1] else float("nan")


# ---------------------------------------------------------------------------
# The in-trace estimator (the JAX package's JaxEstimator)
# ---------------------------------------------------------------------------


#: Optimizer choices travel by name in the spec, as optax's do in the
#: JAX package (``_make_optax``).
_OPTIMIZERS = ("adam", "adamw", "sgd")


class OptaxAdamW(torch.optim.Optimizer):
    """``optax.adamw(lr)`` in plain PyTorch operations:
    ``scale_by_adam`` (as :func:`fused_update.adam_plain` computes it),
    then ``add_decayed_weights(weight_decay)`` on the parameters before
    the step, then ``scale_by_learning_rate``: ``u = -lr * (m_hat /
    (sqrt(v_hat + eps_root) + eps) + weight_decay * p)``.  optax's
    defaults, weight decay 1e-4 included (``torch.optim.AdamW`` decays
    by 1e-2 and multiplies the weights by ``1 - lr * wd`` instead).
    State: ``state[p]["mu"]``, ``["nu"]`` and ``["count"]``."""

    def __init__(self, params, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0, weight_decay: float = 1e-4):
        from horovod_tpu_torch.optim import fused_update as _fu

        # the Adam direction alone: scale(-lr) with lr = -1 multiplies
        # by one, exactly
        self._adam = _fu.FusedSpec("adam", -1.0, 0.0, float(b1),
                                   float(b2), float(eps), float(eps_root))
        self.learning_rate = float(lr)
        self.weight_decay = float(weight_decay)
        super().__init__(params, {"lr": float(lr)})
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                st["mu"] = torch.zeros_like(p)
                st["nu"] = torch.zeros_like(p)
                st["count"] = 0

    @torch.no_grad()
    def step(self, closure=None):
        from horovod_tpu_torch.optim import fused_update as _fu

        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                count = min(st["count"] + 1, 2 ** 31 - 1)
                bc1, bc2 = _fu.bias_corrections(self._adam, count)
                u, st["mu"], st["nu"] = _fu.adam_plain(
                    p.grad, st["mu"], st["nu"], bc1, bc2, 1, self._adam)
                st["count"] = count
                d = p.dtype
                u = (u + p * _fu._round(self.weight_decay, d)) \
                    * _fu._round(-self.learning_rate, d)
                p.add_(u)
        return loss


def _make_optimizer(name: str, params, lr: float):
    """The JAX package's ``_make_optax``: ``sgd`` with momentum 0.9 and
    ``adam`` as the fused tail's tagged optimizers (B1, B3 under
    ``HOROVOD_FUSED_UPDATE=1``), ``adamw`` as optax's."""
    from horovod_tpu_torch.optim import fused_update

    if name == "adamw":
        return OptaxAdamW(params, lr)
    if name == "sgd":
        return fused_update.sgd(params, lr, momentum=0.9)
    return fused_update.adam(params, lr)


def softmax_cross_entropy(logits, target):
    """``optax.softmax_cross_entropy_with_integer_labels(...).mean()``."""
    return torch.nn.functional.cross_entropy(logits.float(), target.long())


def mse(logits, target):
    """``jnp.mean((logits - target) ** 2)``."""
    return torch.mean((logits - target) ** 2)


_LOSSES = {"softmax_cross_entropy": softmax_cross_entropy, "mse": mse}


def _intrace_remote_train(spec: dict):
    """One rank of :class:`JaxEstimator` (``_jax_remote_train``)."""
    import horovod_tpu_torch as hvd

    hvd.init()
    dev = hvd.device()
    model = spec["model"].to(dev)
    model.train()
    loss = spec["loss"]
    loss_fn = _LOSSES[loss] if isinstance(loss, str) else loss
    x, y = _load_shard(spec["store"], spec["train_path"], hvd.rank())
    x, y, vx, vy = _split_validation(x, y, spec.get("validation", 0.0))
    x, y = _inputs(x), _inputs(y)
    if vx is not None:
        vx, vy = _inputs(vx), _inputs(vy)

    hvd.broadcast_parameters(model, root_rank=0)
    opt = hvd.DistributedOptimizer(_make_optimizer(
        spec.get("optimizer", "adam"), model.parameters(),
        spec["lr"] * hvd.size()))

    batch = spec["batch_size"]
    validating = spec.get("validation", 0.0) > 0
    history, val_history = [], []
    before = _launch_counts()
    for epoch in range(spec["epochs"]):
        losses = []
        for i in range(max(1, len(x) // batch)):
            bx = x[i * batch:(i + 1) * batch]
            if len(bx) == 0:
                continue
            by = y[i * batch:(i + 1) * batch]
            opt.zero_grad()
            step_loss = loss_fn(model(bx.to(dev)), by.to(dev))
            step_loss.backward()
            opt.step()
            losses.append(step_loss.item())
        epoch_loss = float(np.mean(losses)) if losses else float("nan")
        avg = hvd.allreduce(torch.tensor(epoch_loss, dtype=torch.float32,
                                         device=dev),
                            op=hvd.Average, name=f"est_loss.{epoch}")
        history.append(float(avg))
        if validating:
            vsum, vcount = _validation_loss(model, loss_fn, vx, vy, batch,
                                            dev)
            val_history.append(_reduced_validation(
                hvd.allreduce, hvd.Sum, vsum, vcount, epoch, dev))
        if hvd.rank() == 0:
            _save_checkpoint(spec, {"params": _host_state(model),
                                    "epoch": epoch, "history": history,
                                    "val_history": val_history})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return _host_state(model), history, val_history, \
        _launches_since(before)


class JaxTrainedModel:
    """Inference wrapper (reference ``HorovodModel``/``KerasModel``):
    the module with the trained state, on ``device`` (see
    :func:`_device`).  ``params`` is that state on the host."""

    def __init__(self, model, params, run_id: str, history,
                 val_history=(), device=None):
        self.model = model
        self.params = params
        self.model.load_state_dict(params)
        self.device = _device(device)
        self.model.to(self.device).eval()
        self.run_id = run_id
        self.history = history
        self.val_history = list(val_history)

    def predict(self, x, batch_size: int = 256):
        xs = _inputs(np.asarray(x))
        outs = []
        with torch.no_grad():
            for i in range(0, len(xs), batch_size):
                out = self.model(xs[i:i + batch_size].to(self.device))
                outs.append(out.float().cpu().numpy())
        return np.concatenate(outs, axis=0)

    transform = predict  # the reference's Spark-ML spelling


class JaxEstimator(EstimatorBase):
    """Train an ``nn.Module`` data-parallel on the port's **in-trace
    plane** (the JAX package's flax estimator; the reference's
    KerasEstimator shape: model, optimizer and loss declared up front,
    ``fit`` returns the trained model).  ``optimizer`` is ``"sgd"``
    (momentum 0.9), ``"adam"`` or ``"adamw"`` at ``lr * size``; ``loss``
    is ``"softmax_cross_entropy"``, ``"mse"`` or a module-level
    callable ``loss(outputs, targets)``.  The module's own weights are
    the start: the ranks broadcast rank 0's (``seed`` is kept for the
    JAX package's signature and draws nothing)."""

    def __init__(self, *, model, loss="softmax_cross_entropy",
                 lr: float = 1e-3, seed: int = 0, optimizer: str = "adam",
                 **kw):
        super().__init__(**kw)
        self.model = model
        self.loss = loss
        self.lr = lr
        self.seed = seed
        if optimizer not in _OPTIMIZERS:
            raise ValueError(f"optimizer must be one of "
                             f"{sorted(_OPTIMIZERS)}, got {optimizer!r}")
        self.optimizer = optimizer

    def _callables(self):
        return {} if isinstance(self.loss, str) else {"loss": self.loss}

    def _remote_spec(self, train_path, ckpt_path):
        return {"model": self.model, "loss": self.loss, "lr": self.lr,
                "seed": self.seed, "batch_size": self.batch_size,
                "epochs": self.epochs, "validation": self.validation,
                "optimizer": self.optimizer,
                "train_path": train_path, "ckpt_path": ckpt_path}

    def _remote_fn(self):
        return _intrace_remote_train

    def _wrap_model(self, result, run_id):
        params, history, val_history = result[:3]
        return JaxTrainedModel(self.model, params, run_id, history,
                               val_history)


# ---------------------------------------------------------------------------
# The torch estimator (the reference's spark/torch), on the eager plane
# ---------------------------------------------------------------------------


def _torch_remote_train(spec: dict):
    """One rank of :class:`TorchEstimator`."""
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import basics

    hvd.init()
    dev = basics.device()
    torch.manual_seed(spec["seed"])
    model = spec["model"].to(dev)
    x, y = _load_shard(spec["store"], spec["train_path"], hvd.rank())
    x, y, vx, vy = _split_validation(x, y, spec.get("validation", 0.0))
    x = torch.from_numpy(x).float()
    y = torch.from_numpy(y)
    if vx is not None:
        vx = torch.from_numpy(vx).float()
        vy = torch.from_numpy(vy)

    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt_name = spec.get("optimizer", "adam")
    lr = spec["lr"] * hvd.size()
    if opt_name == "sgd":
        base_opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)
    elif opt_name == "adamw":
        base_opt = torch.optim.AdamW(model.parameters(), lr=lr)
    else:
        base_opt = torch.optim.Adam(model.parameters(), lr=lr)
    opt = hvd.DistributedOptimizer(
        base_opt, named_parameters=model.named_parameters())
    loss_fn = spec["loss_fn"]

    batch = spec["batch_size"]
    history, val_history = [], []
    before = _launch_counts()
    for epoch in range(spec["epochs"]):
        losses = []
        for i in range(max(1, len(x) // batch)):
            bx, by = x[i * batch:(i + 1) * batch], y[i * batch:(i + 1) * batch]
            if len(bx) == 0:
                continue
            opt.zero_grad()
            loss = loss_fn(model(bx.to(dev)), by.to(dev))
            loss.backward()
            opt.step()
            losses.append(loss.item())
        epoch_loss = float(np.mean(losses)) if losses else float("nan")
        avg = hvd.allreduce(torch.tensor(epoch_loss, device=dev),
                            op=hvd.Average, name=f"est_loss.{epoch}")
        history.append(float(avg))
        if spec.get("validation", 0.0) > 0:
            vsum, vcount = _validation_loss(model, loss_fn, vx, vy, batch,
                                            dev)
            val_history.append(_reduced_validation(
                hvd.allreduce, hvd.Sum, vsum, vcount, epoch, dev))
        if hvd.rank() == 0:
            _save_checkpoint(spec, {"model": _host_state(model),
                                    "epoch": epoch, "history": history,
                                    "val_history": val_history})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return _host_state(model), history, val_history, \
        _launches_since(before)


class TorchTrainedModel:
    """The torch estimator's trained model, on ``device`` (see
    :func:`_device`)."""

    def __init__(self, model, state_dict, run_id: str, history,
                 val_history=(), device=None):
        self.model = model
        self.model.load_state_dict(state_dict)
        self.device = _device(device)
        self.model.to(self.device).eval()
        self.run_id = run_id
        self.history = history
        self.val_history = list(val_history)

    def predict(self, x, batch_size: int = 256):
        xs = torch.from_numpy(np.asarray(x)).float()
        outs = []
        with torch.no_grad():
            for i in range(0, len(xs), batch_size):
                out = self.model(xs[i:i + batch_size].to(self.device))
                outs.append(out.float().cpu().numpy())
        return np.concatenate(outs, axis=0)

    transform = predict


class TorchEstimator(EstimatorBase):
    """Train an ``nn.Module`` with a ``torch.optim`` optimizer (``"sgd"``
    with momentum 0.9, ``"adam"``, ``"adamw"``) through the hook-driven
    frontend :mod:`horovod_tpu_torch.torch`."""

    def __init__(self, *, model, loss_fn=None, lr: float = 1e-3,
                 seed: int = 0, optimizer: str = "adam", **kw):
        super().__init__(**kw)
        self.model = model
        self.loss_fn = loss_fn or torch.nn.functional.cross_entropy
        self.lr = lr
        self.seed = seed
        if optimizer not in _OPTIMIZERS:
            raise ValueError(f"optimizer must be one of "
                             f"{sorted(_OPTIMIZERS)}, got {optimizer!r}")
        self.optimizer = optimizer

    def _callables(self):
        return {"loss_fn": self.loss_fn}

    def _remote_spec(self, train_path, ckpt_path):
        return {"model": self.model, "loss_fn": self.loss_fn,
                "lr": self.lr, "seed": self.seed,
                "batch_size": self.batch_size, "epochs": self.epochs,
                "validation": self.validation,
                "optimizer": self.optimizer,
                "train_path": train_path, "ckpt_path": ckpt_path}

    def _remote_fn(self):
        return _torch_remote_train

    def _wrap_model(self, result, run_id):
        state, history, val_history = result[:3]
        return TorchTrainedModel(self.model, state, run_id, history,
                                 val_history)
