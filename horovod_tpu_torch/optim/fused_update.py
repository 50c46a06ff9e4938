"""Fused optimizer tail (``HOROVOD_FUSED_UPDATE=1``), kernels B1-B3.

The counterpart of ``horovod_tpu/optim/fused_update.py``.  After the
gradient reduction, the update of an optimizer built by :func:`sgd` or
:func:`adam` runs as CUDA kernels (``csrc/fused_update.cu``) instead of
a chain of elementwise PyTorch ops, each a full pass over device memory:
one launch over all the leaves of one dtype (:func:`sgd_update_multi`,
:func:`momentum_update_multi`, :func:`adam_update_multi`), whose leaf
table travels in the kernel's parameters (:func:`leaf_table`).  At ZeRO
stages 1-3 the tail runs over each dtype group's flat shard, one launch
per group (:func:`fused_update_groups`).

**Bit-exactness contract.**  The kernels and their plain versions below
compute optax's update expressions (``optax.sgd`` / ``optax.trace`` /
``optax.scale_by_adam`` + ``scale_by_learning_rate``) operation by
operation, in the order the JAX package writes them
(``fused_update.py:208-232``).  Constants are rounded to the working
dtype first, as JAX rounds a Python scalar to an array's dtype, and
every operation rounds to that dtype.  Divisions are true divisions
(PyTorch divides by a Python scalar through its reciprocal, which would
round differently).

**Kernel selection follows the tensor's device.**  Each wrapper
(the one-buffer :func:`sgd_update`, :func:`momentum_update`,
:func:`adam_update` and the multi-leaf ones) launches its CUDA kernel for
CUDA tensors and counts each launch in :data:`LAUNCHES`; for CPU tensors
it runs its plain version (:func:`sgd_plain`, :func:`momentum_plain`,
:func:`adam_plain`) leaf by leaf.  A failed build or launch raises.

The port updates optimizer state in place (the JAX package returns new
state); updates come back as new tensors, as ``optax`` returns them.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from horovod_tpu_torch import _build
from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common import events as _events
from horovod_tpu_torch.common import logging as _log
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.common.util import true_divide
from horovod_tpu_torch.runtime import metrics as _metrics

_INT32_MAX = 2 ** 31 - 1
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: Elements that one block of a multi-leaf launch takes from a leaf (the
#: kernel's ``kChunk``).
_CHUNK = 4096
#: The kinds' codes in ``hvd_multi_capacity``.
_KIND_CODES = {"sgd": 0, "momentum": 1, "adam": 2}

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`.
LAUNCHES = {"sgd": 0, "momentum": 0, "adam": 0}

_warned: set = set()
_M_FUSED = _metrics.gauge(
    "hvd_fused_update",
    "1 when the Pallas-fused optimizer tail is active for the "
    "last-constructed DistributedOptimizer, 0 when requested but "
    "unavailable (untagged optimizer / unrecognized state).")


class FusedSpec(NamedTuple):
    """Hyperparameters of a fusable update (kind: ``sgd`` | ``momentum``
    | ``adam``)."""
    kind: str
    lr: float
    momentum: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _require_float(name: str, v) -> None:
    if callable(v):
        raise TypeError(
            f"fused_update.{name} must be a float (schedules change per "
            "step and cannot be baked into the fused kernel)")


# ---------------------------------------------------------------------------
# The optimizers: optax's update with plain torch ops, tagged with a spec
# ---------------------------------------------------------------------------


class SGD(torch.optim.Optimizer):
    """``optax.sgd``: ``u = -lr * g`` or, with momentum (any value but
    ``None``, as optax adds the trace for ``0.0`` too), ``t' = g +
    momentum * t; u = -lr * t'``.  State: ``state[p]["trace"]``, created
    as zeros like ``optax.trace``'s init.  The spec's hyperparameters
    apply to every parameter group."""

    def __init__(self, params, learning_rate: float,
                 momentum: float | None = None):
        _require_float("learning_rate", learning_rate)
        if momentum is not None:
            _require_float("momentum", momentum)
        self.fused_spec = FusedSpec(
            "sgd" if momentum is None else "momentum",
            float(learning_rate), float(momentum or 0.0))
        super().__init__(params, {"lr": float(learning_rate),
                                  "momentum": momentum})
        if self.fused_spec.kind == "momentum":
            for p in _params(self):
                self.state[p]["trace"] = torch.zeros_like(
                    p, memory_format=torch.contiguous_format)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        spec = self.fused_spec
        for p in _params(self):
            if p.grad is None:
                continue
            if spec.kind == "sgd":
                u = sgd_plain(p.grad, 1, -spec.lr)
            else:
                st = self.state[p]
                u, st["trace"] = momentum_plain(p.grad, st["trace"], 1,
                                                spec.momentum, -spec.lr)
            p.add_(u)
        return loss


class Adam(torch.optim.Optimizer):
    """``optax.adam`` (not ``torch.optim.Adam``, whose denominator
    ``sqrt(v)/sqrt(bc2) + eps`` orders the operations differently).
    State: ``state[p]["mu"]``, ``["nu"]`` and ``["count"]`` (optax's one
    step count, kept per parameter as a Python int)."""

    def __init__(self, params, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0):
        for name, v in (("learning_rate", learning_rate), ("b1", b1),
                        ("b2", b2), ("eps", eps), ("eps_root", eps_root)):
            _require_float(name, v)
        self.fused_spec = FusedSpec("adam", float(learning_rate), 0.0,
                                    float(b1), float(b2), float(eps),
                                    float(eps_root))
        super().__init__(params, {"lr": float(learning_rate)})
        for p in _params(self):
            st = self.state[p]
            st["mu"] = torch.zeros_like(
                p, memory_format=torch.contiguous_format)
            st["nu"] = torch.zeros_like(
                p, memory_format=torch.contiguous_format)
            st["count"] = 0

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        spec = self.fused_spec
        for p in _params(self):
            if p.grad is None:
                continue
            st = self.state[p]
            count = min(st["count"] + 1, _INT32_MAX)
            bc1, bc2 = bias_corrections(spec, count)
            u, st["mu"], st["nu"] = adam_plain(p.grad, st["mu"], st["nu"],
                                               bc1, bc2, 1, spec)
            st["count"] = count
            p.add_(u)
        return loss


def _params(opt: torch.optim.Optimizer):
    return [p for g in opt.param_groups for p in g["params"]]


def sgd(params, learning_rate: float, momentum: float | None = None) -> SGD:
    """``optax.sgd`` over ``params``, tagged for the fused tail."""
    return SGD(params, learning_rate, momentum)


def adam(params, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> Adam:
    """``optax.adam`` over ``params``, tagged for the fused tail."""
    return Adam(params, learning_rate, b1, b2, eps, eps_root)


def bias_corrections(spec: FusedSpec, count_inc: int):
    """``(1 - b1**t, 1 - b2**t)`` as float32 values, as optax's
    ``tree_bias_correction`` computes them."""
    t = np.float32(count_inc)
    one = np.float32(1.0)
    return (float(one - np.float32(spec.b1) ** t),
            float(one - np.float32(spec.b2) ** t))


# ---------------------------------------------------------------------------
# Selection: knob on AND a tagged optimizer
# ---------------------------------------------------------------------------


def spec_of(optimizer) -> FusedSpec | None:
    return getattr(optimizer, "fused_spec", None)


def enabled() -> bool:
    return bool(_config.get("fused_update"))


def active() -> bool:
    """Whether the fused tail ran for the last-constructed optimizer
    (``enabled()`` records the request, this the outcome: the
    ``hvd_fused_update`` gauge)."""
    return bool(_M_FUSED.value())


def _set_active(on: bool) -> None:
    _M_FUSED.set(1 if on else 0)


def _warn_once(category: str, msg: str) -> None:
    if category not in _warned:
        _warned.add(category)
        _log.warning(f"fused-update: {msg}")


def resolve_spec(optimizer) -> FusedSpec | None:
    """The spec to fuse with, or ``None`` (knob off, or an optimizer
    without a spec: warned once, and the unfused step runs -- the knob
    can fuse results but never change them)."""
    if not enabled():
        _set_active(False)
        return None
    spec = spec_of(optimizer)
    if spec is None:
        _set_active(False)
        _warn_once(
            "untagged",
            "HOROVOD_FUSED_UPDATE=1 but the wrapped optimizer carries no "
            "FusedSpec; construct it with fused_update.sgd/adam to fuse. "
            "Running the unfused step.")
        return None
    _set_active(True)
    return spec


# ---------------------------------------------------------------------------
# Plain versions: the kernels' arithmetic in PyTorch ops
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def _round(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype`` (JAX's weak-typed scalar promotion).
    Cached: the wrappers round the same few constants at every launch."""
    return torch.tensor(c, dtype=dtype).item()


def _prep_plain(g: torch.Tensor, navg: int) -> torch.Tensor:
    # the unfused chain's ``g / n`` (Average only)
    return true_divide(g, _round(navg, g.dtype)) if navg > 1 else g


def sgd_plain(g, navg: int, neg_lr: float):
    """``u = neg_lr * (g / navg)``."""
    g = _prep_plain(g, navg)
    return g * _round(neg_lr, g.dtype)


def momentum_plain(g, t, navg: int, decay: float, neg_lr: float):
    """``t' = g/navg + decay * t; u = neg_lr * t'`` -> ``(u, t')``."""
    g = _prep_plain(g, navg)
    t2 = g + t * _round(decay, g.dtype)
    return t2 * _round(neg_lr, g.dtype), t2


def adam_plain(g, mu, nu, bc1: float, bc2: float, navg: int,
               spec: FusedSpec):
    """optax.scale_by_adam + scale(-lr) -> ``(u, mu', nu')``."""
    d = g.dtype
    g = _prep_plain(g, navg)
    mu2 = g * _round(1 - spec.b1, d) + mu * _round(spec.b1, d)
    nu2 = (g * g) * _round(1 - spec.b2, d) + nu * _round(spec.b2, d)
    mu_hat = true_divide(mu2, _round(bc1, d))
    nu_hat = true_divide(nu2, _round(bc2, d))
    # correctly rounded square root: PyTorch's CPU sqrt may be off by an
    # ulp, while a float64 root rounds to float32 exactly
    root = torch.sqrt((nu_hat + _round(spec.eps_root, d)).double()).float()
    den = root.to(d) + _round(spec.eps, d)
    return (mu_hat / den) * _round(-spec.lr, d), mu2, nu2


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_lib = None


def _kernels():
    """The built library, with its C signatures declared."""
    global _lib
    if _lib is None:
        lib = _build.load("fused_update")
        p, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                            ctypes.c_float)
        lib.hvd_sgd.argtypes = [i32, p, p, i64, i32, f32, f32, p]
        lib.hvd_momentum.argtypes = [i32, p, p, p, p, i64, i32, f32, f32,
                                     f32, p]
        lib.hvd_adam.argtypes = [i32, p, p, p, p, p, p, i64, i32, f32,
                                 *[f32] * 9, p]
        # (dtype, host rows, rows, chunk, divide, navg, constants...,
        # stream)
        lib.hvd_sgd_multi.argtypes = [i32, p, i32, i32, i32, f32, f32, p]
        lib.hvd_momentum_multi.argtypes = [i32, p, i32, i32, i32, f32, f32,
                                           f32, p]
        lib.hvd_adam_multi.argtypes = [i32, p, i32, i32, i32, f32,
                                       *[f32] * 9, p]
        lib.hvd_multi_capacity.argtypes = [i32]
        for fn in (lib.hvd_sgd, lib.hvd_momentum, lib.hvd_adam,
                   lib.hvd_sgd_multi, lib.hvd_momentum_multi,
                   lib.hvd_adam_multi, lib.hvd_multi_capacity):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, *ts: torch.Tensor) -> None:
    ref = ts[0]
    if ref.device.type not in ("cpu", "cuda"):
        raise HorovodTpuError(f"{name}: unsupported device {ref.device}")
    if ref.dtype not in _DTYPE_CODES:
        raise HorovodTpuError(
            f"{name}: dtype {ref.dtype} is not float32 or bfloat16")
    for t in ts:
        if t.device != ref.device or t.dtype != ref.dtype:
            raise HorovodTpuError(
                f"{name}: all tensors must share device and dtype (got "
                f"{t.device}/{t.dtype} beside {ref.device}/{ref.dtype}); "
                "cast the gradient to the moment dtype first")
        if t.numel() != ref.numel():
            raise HorovodTpuError(
                f"{name}: sizes differ ({t.numel()} vs {ref.numel()})")
        if not t.is_contiguous():
            raise HorovodTpuError(f"{name}: tensors must be contiguous")


def _launch(name: str, fn, g: torch.Tensor, *args) -> None:
    if g.numel() == 0:
        return
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = fn(_DTYPE_CODES[g.dtype], *args, stream)
    if rc != 0:
        raise HorovodTpuError(f"{name} kernel launch failed: CUDA error {rc}")
    _events.note_launch(LAUNCHES, "fused_update", name)


def sgd_update(g, navg: int, neg_lr: float, out=None):
    """B2: ``u = neg_lr * (g / navg)``; returns ``u``."""
    u = torch.empty_like(g) if out is None else out
    _check("sgd", g, u)
    if g.device.type == "cpu":
        return u.copy_(sgd_plain(g, navg, neg_lr))
    d = g.dtype
    _launch("sgd", _kernels().hvd_sgd, g, g.data_ptr(), u.data_ptr(),
            g.numel(), int(navg > 1), _round(navg, d), _round(neg_lr, d))
    return u


def leaf_table(ptrs, sizes, capacity: int, chunk: int = _CHUNK):
    """The rows of a multi-leaf launch.  ``ptrs`` holds one list of data
    pointers per operand (gradients, state, outputs), leaf by leaf, and
    ``sizes`` the leaves' element counts.  Per non-empty leaf, a row of
    its pointers, ``n`` and its first chunk (of ``chunk`` elements), in
    one C-ordered int64 array that ctypes hands to the C entry, which
    copies the rows into the kernel's parameters.  Rows go into launches
    of at most ``capacity`` rows, each launch numbering its first chunks
    from 0.  Returns ``(table, launches)``."""
    n = np.asarray(sizes, np.int64)
    keep = np.flatnonzero(n)
    rows = len(keep)
    table = np.empty((rows, len(ptrs) + 2), np.int64)
    table[:, :-2] = np.asarray(ptrs, np.int64).T[keep]
    n = n[keep]
    table[:, -2] = n
    chunks = -(-n // chunk)
    first = np.cumsum(chunks) - chunks
    table[:, -1] = first - first[np.arange(rows) // capacity * capacity]
    return table, -(-rows // capacity)


@functools.lru_cache(maxsize=None)
def capacity(kind: str) -> int:
    """Rows one launch of the multi-leaf kernel takes for ``kind`` (its
    parameter table's size, fixed in ``csrc/fused_update.cu``)."""
    return _kernels().hvd_multi_capacity(_KIND_CODES[kind])


def _check_leaves(kind: str, ts, ref, what: str) -> None:
    """Raise unless every tensor of ``ts`` is contiguous and of ``ref``'s
    dtype and device (one pass; the message names the first that is
    not)."""
    dev, dt = ref.device, ref.dtype
    if all(t.device == dev and t.dtype is dt and t.is_contiguous()
           for t in ts):
        return
    i, t = next((i, t) for i, t in enumerate(ts)
                if t.device != dev or t.dtype != dt or not t.is_contiguous())
    if t.device != dev or t.dtype != dt:
        raise HorovodTpuError(
            f"{kind}: {what} {i} is {t.dtype} on {t.device}, the first leaf "
            f"{dt} on {dev}; one launch takes one dtype on one device")
    raise HorovodTpuError(f"{kind}: {what} {i} is not contiguous")


def _multi(kind: str, grads, ins, outs, plain, launch) -> list:
    """One update over the list of leaves ``grads``.  ``ins`` and
    ``outs`` are ``(name, tensors)`` pairs, the state read and the
    outputs written, leaf by leaf (``None`` outputs: new tensors like
    the leaves; an output list that is an input list is updated in
    place).  Checks all one launch takes -- one device, float32 or
    bfloat16 throughout, contiguous tensors of each leaf's size, no two
    leaves writing one pointer -- then on the CPU runs ``plain(g,
    *state)`` leaf by leaf into the outputs, on the card ``launch(dtype,
    table, rows)``.  Returns the output lists."""
    ref = grads[0]
    if ref.device.type not in ("cpu", "cuda"):
        raise HorovodTpuError(f"{kind}: unsupported device {ref.device}")
    if ref.dtype not in _DTYPE_CODES:
        raise HorovodTpuError(
            f"{kind}: dtype {ref.dtype} is not float32 or bfloat16")
    sizes = [g.numel() for g in grads]
    _check_leaves(kind, grads, ref, "leaf")
    checked = [grads]

    def check(name, ts):
        if any(ts is c for c in checked):
            return ts
        ts = ts if isinstance(ts, list) else list(ts)
        if len(ts) != len(grads):
            raise HorovodTpuError(
                f"{kind}: {len(ts)} {name}s for {len(grads)} leaves")
        _check_leaves(kind, ts, ref, name)
        if [t.numel() for t in ts] != sizes:
            raise HorovodTpuError(
                f"{kind}: a {name}'s size differs from its leaf's")
        checked.append(ts)
        return ts

    state = [check(name, ts) for name, ts in ins]
    given = [check(name, ts) for name, ts in outs if ts is not None]
    ptrs: dict = {}

    def ptrs_of(ts):
        if id(ts) not in ptrs:
            ptrs[id(ts)] = [t.data_ptr() for t in ts]
        return ptrs[id(ts)]

    written = [p for ts in given for p, n in zip(ptrs_of(ts), sizes) if n]
    if len(set(written)) != len(written):
        raise HorovodTpuError(
            f"{kind}: two leaves write one pointer, and one launch updates "
            "the leaves in no order")
    given_it = iter(given)
    new = [next(given_it) if ts is not None else
           [torch.empty_like(g) for g in grads] for _, ts in outs]
    if ref.device.type == "cpu":
        k = len(state)
        for g, *rest in zip(grads, *state, *new):
            for o, v in zip(rest[k:], plain(g, *rest[:k])):
                o.copy_(v)
        return new
    table, launches = leaf_table(
        [ptrs_of(ts) for ts in (grads, *state, *new)], sizes,
        capacity(kind))
    if launches:
        rc = launch(_DTYPE_CODES[ref.dtype], table.ctypes.data, len(table),
                    torch.cuda.current_stream(ref.device).cuda_stream)
        if rc != 0:
            raise HorovodTpuError(
                f"{kind} kernel launch failed: CUDA error {rc}")
        _events.note_launch(LAUNCHES, "fused_update", kind, launches)
    return new


def sgd_update_multi(grads, navg: int, neg_lr: float, outs=None):
    """B2 over a list of leaves of one dtype on one device, in one
    launch (one per :func:`capacity` rows): ``u = neg_lr * (g / navg)``
    for each ``g``, bit for bit what :func:`sgd_update` gives leaf by
    leaf.  ``outs`` (a tensor of each leaf's size, dtype and device)
    receive the updates; by default they are new tensors like the
    leaves.  Empty leaves are skipped.  Returns the updates."""
    grads = list(grads)
    if not grads:
        return []
    d = grads[0].dtype
    return _multi(
        "sgd", grads, (), (("output", outs),),
        lambda g: (sgd_plain(g, navg, neg_lr),),
        lambda code, table, rows, stream: _kernels().hvd_sgd_multi(
            code, table, rows, _CHUNK, int(navg > 1), _round(navg, d),
            _round(neg_lr, d), stream))[0]


def momentum_update_multi(grads, traces, navg: int, decay: float,
                          neg_lr: float, outs=None, t_outs=None):
    """B1 over a list of leaves of one dtype on one device, in one
    launch (one per :func:`capacity` rows), bit for bit what
    :func:`momentum_update` gives leaf by leaf.  ``outs`` and ``t_outs``
    receive ``u`` and ``t'`` (new tensors by default; ``t_outs`` may be
    ``traces`` itself, the in-place trace).  Returns ``(us, t_outs)``."""
    grads = list(grads)
    if not grads:
        return [], []
    d = grads[0].dtype
    us, ts = _multi(
        "momentum", grads, (("trace", traces),),
        (("output", outs), ("trace output", t_outs)),
        lambda g, t: momentum_plain(g, t, navg, decay, neg_lr),
        lambda code, table, rows, stream: _kernels().hvd_momentum_multi(
            code, table, rows, _CHUNK, int(navg > 1), _round(navg, d),
            _round(decay, d), _round(neg_lr, d), stream))
    return us, ts


def adam_update_multi(grads, mus, nus, bc1: float, bc2: float, navg: int,
                      spec: FusedSpec, outs=None, mu_outs=None,
                      nu_outs=None):
    """B3 over a list of leaves of one dtype on one device, in one
    launch (one per :func:`capacity` rows), bit for bit what
    :func:`adam_update` gives leaf by leaf.  ``mu_outs`` / ``nu_outs``
    may be ``mus`` / ``nus`` themselves.  Returns ``(us, mu_outs,
    nu_outs)``."""
    grads = list(grads)
    if not grads:
        return [], [], []
    d = grads[0].dtype
    consts = [_round(c, d) for c in (1 - spec.b1, spec.b1, 1 - spec.b2,
                                     spec.b2, bc1, bc2, spec.eps_root,
                                     spec.eps, -spec.lr)]
    us, ms, vs = _multi(
        "adam", grads, (("mu", mus), ("nu", nus)),
        (("output", outs), ("mu output", mu_outs), ("nu output", nu_outs)),
        lambda g, m, v: adam_plain(g, m, v, bc1, bc2, navg, spec),
        lambda code, table, rows, stream: _kernels().hvd_adam_multi(
            code, table, rows, _CHUNK, int(navg > 1), _round(navg, d),
            *consts, stream))
    return us, ms, vs


def momentum_update(g, t, navg: int, decay: float, neg_lr: float,
                    out=None, t_out=None):
    """B1: ``t' = g/navg + decay * t; u = neg_lr * t'``; returns
    ``(u, t')``.  ``t_out`` may be ``t`` itself (in-place trace)."""
    u = torch.empty_like(t) if out is None else out
    t_out = torch.empty_like(t) if t_out is None else t_out
    _check("momentum", g, t, u, t_out)
    if g.device.type == "cpu":
        u2, t2 = momentum_plain(g, t, navg, decay, neg_lr)
        return u.copy_(u2), t_out.copy_(t2)
    d = g.dtype
    _launch("momentum", _kernels().hvd_momentum, g, g.data_ptr(),
            t.data_ptr(), u.data_ptr(), t_out.data_ptr(), g.numel(),
            int(navg > 1), _round(navg, d), _round(decay, d),
            _round(neg_lr, d))
    return u, t_out


def adam_update(g, mu, nu, bc1: float, bc2: float, navg: int,
                spec: FusedSpec, out=None, mu_out=None, nu_out=None):
    """B3: optax's Adam step; returns ``(u, mu', nu')``.  ``mu_out`` /
    ``nu_out`` may be ``mu`` / ``nu`` themselves."""
    u = torch.empty_like(mu) if out is None else out
    mu_out = torch.empty_like(mu) if mu_out is None else mu_out
    nu_out = torch.empty_like(nu) if nu_out is None else nu_out
    _check("adam", g, mu, nu, u, mu_out, nu_out)
    if g.device.type == "cpu":
        u2, m2, v2 = adam_plain(g, mu, nu, bc1, bc2, navg, spec)
        return u.copy_(u2), mu_out.copy_(m2), nu_out.copy_(v2)
    d = g.dtype
    r = [_round(c, d) for c in (1 - spec.b1, spec.b1, 1 - spec.b2, spec.b2,
                                bc1, bc2, spec.eps_root, spec.eps,
                                -spec.lr)]
    _launch("adam", _kernels().hvd_adam, g, g.data_ptr(), mu.data_ptr(),
            nu.data_ptr(), u.data_ptr(), mu_out.data_ptr(),
            nu_out.data_ptr(), g.numel(), int(navg > 1), _round(navg, d),
            *r)
    return u, mu_out, nu_out


# ---------------------------------------------------------------------------
# The stage-0 entry point the DistributedOptimizer calls
# ---------------------------------------------------------------------------


def _check_state(spec: FusedSpec, grads, states) -> None:
    """Raise unless every leaf's state has the layout the kernels take
    (a tensor of the gradient's shape and dtype per moment; ``grads``
    need only ``shape``, ``dtype`` and ``device``)."""
    if len(grads) != len(states):
        raise HorovodTpuError(
            f"fused {spec.kind} update: {len(grads)} gradients but "
            f"{len(states)} state entries")
    keys = {"sgd": (), "momentum": ("trace",), "adam": ("mu", "nu")}[
        spec.kind]
    for i, (g, st) in enumerate(zip(grads, states)):
        for k in keys:
            m = st.get(k)
            if not isinstance(m, torch.Tensor) or m.shape != g.shape \
                    or m.dtype != g.dtype or m.device != g.device:
                got = (f"{tuple(m.shape)} {m.dtype} on {m.device}"
                       if isinstance(m, torch.Tensor) else repr(m))
                raise HorovodTpuError(
                    f"fused {spec.kind} update: state[{k!r}] of leaf {i} is "
                    f"{got}, expected {tuple(g.shape)} {g.dtype} on "
                    f"{g.device} like its gradient")
        if spec.kind == "adam" and not isinstance(st.get("count"), int):
            raise HorovodTpuError(
                f"fused adam update: state['count'] of leaf {i} is "
                f"{st.get('count')!r}, expected a Python int")


def fused_update_tree(spec: FusedSpec, grads, states):
    """Fused replacement for the replicated (stage 0) update (gradients
    already reduced, so no unscale): one multi-leaf launch per dtype
    (and device) of the gradients, whatever the kind.  ``states`` are
    the optimizer's per-parameter state dicts, updated in place.
    Returns the list of updates.  A state of another layout (say a trace
    loaded in another dtype) raises :class:`HorovodTpuError`: the fused
    tail was asked for, so nothing else runs in its place."""
    _check_state(spec, grads, states)
    if not grads:
        return []
    if spec.kind == "adam":
        count = min(states[0]["count"] + 1, _INT32_MAX)
        bc1, bc2 = bias_corrections(spec, count)
    outs = [None] * len(grads)
    groups: dict = {}
    for i, g in enumerate(grads):
        groups.setdefault((g.device, g.dtype), []).append(i)
    for idx in groups.values():
        gs = [grads[i] for i in idx]
        sts = [states[i] for i in idx]
        if spec.kind == "sgd":
            us = sgd_update_multi(gs, 1, -spec.lr)
        elif spec.kind == "momentum":
            tr = [st["trace"] for st in sts]
            us, _ = momentum_update_multi(gs, tr, 1, spec.momentum,
                                          -spec.lr, t_outs=tr)
        else:
            mus = [st["mu"] for st in sts]
            nus = [st["nu"] for st in sts]
            us, _, _ = adam_update_multi(gs, mus, nus, bc1, bc2, 1, spec,
                                         mu_outs=mus, nu_outs=nus)
        for i, u in zip(idx, us):
            outs[i] = u
    if spec.kind == "adam":
        for st in states:
            st["count"] = count
    return outs


# ---------------------------------------------------------------------------
# The ZeRO (stage >= 1) entry point: raw post-scatter shard buffers
# ---------------------------------------------------------------------------


def init_group_state(spec: FusedSpec, shards) -> list:
    """Zero state of the kinds' layout over flat shard buffers, one dict
    per group (``trace``; ``mu``, ``nu`` and ``count``; nothing for
    plain SGD), as :func:`fused_update_groups` takes it."""
    out = []
    for s in shards:
        if spec.kind == "momentum":
            out.append({"trace": torch.zeros_like(s)})
        elif spec.kind == "adam":
            out.append({"mu": torch.zeros_like(s), "nu": torch.zeros_like(s),
                        "count": 0})
        else:
            out.append({})
    return out


def fused_update_groups(spec: FusedSpec, shards, states, navg: int,
                        dtypes) -> list:
    """Fused tail of the ZeRO paths: ``shards`` are the raw post-scatter
    flat buffers of the dtype groups (summed in the wire dtype),
    ``states`` one state dict per group (:func:`init_group_state`,
    updated in place), ``dtypes`` the groups' dtypes and ``navg`` the
    Average divisor (1 for Sum).  One launch per group: the kernel
    unscales by ``navg`` itself when the shard is in its group's dtype;
    a shard in another wire dtype (a lossy wire's float32 under a
    bfloat16 group) is divided in that dtype and cast first, the
    unfused chain's ``shard / n`` then ``astype``.  Returns the update
    shards in the group dtypes."""
    shards = list(shards)
    # moments live in the group dtype: hold them to the shard's shape in
    # that dtype
    _check_state(spec, [SimpleNamespace(shape=s.shape, dtype=d,
                                        device=s.device)
                        for s, d in zip(shards, dtypes)], states)
    if not shards:
        return []
    if spec.kind == "adam":
        counts = {st["count"] for st in states}
        if len(counts) != 1:
            raise HorovodTpuError(
                f"fused adam update: the groups disagree on the step count "
                f"({sorted(counts)})")
        count = min(counts.pop() + 1, _INT32_MAX)
        bc1, bc2 = bias_corrections(spec, count)
    outs = []
    for g, st, d in zip(shards, states, dtypes):
        div = navg
        if g.dtype != d:
            g = (true_divide(g, navg) if navg > 1 else g).to(d)
            div = 1
        if spec.kind == "sgd":
            outs.append(sgd_update(g, div, -spec.lr))
        elif spec.kind == "momentum":
            tr = st["trace"]
            outs.append(momentum_update(g, tr, div, spec.momentum, -spec.lr,
                                        t_out=tr)[0])
        else:
            mu, nu = st["mu"], st["nu"]
            outs.append(adam_update(g, mu, nu, bc1, bc2, div, spec,
                                    mu_out=mu, nu_out=nu)[0])
    if spec.kind == "adam":
        for st in states:
            st["count"] = count
    return outs
