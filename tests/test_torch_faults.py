"""The port's fault injection (``horovod_tpu_torch/runtime/faults.py``,
``HOROVOD_FAULT_SPEC``) against the JAX package's
(``tests/test_fault_tolerance.py:92-196,354-392``).

* A table of specs, valid and invalid, parses to the same rules and
  raises the same ``FaultSpecError`` texts in both packages.
* ``FaultyTransport`` over a recording fake, driven by the same key
  sequence, gives the same delays, drops, ``die`` exits and inner calls.
* ``poison_entries`` on the same seeded numpy payloads poisons the same
  element the same way (a torch tensor here, a JAX array there), at the
  same round, once per round-scoped rule.
* ``preempt:`` raises ``NotImplementedError`` naming ROADMAP item 12f at
  every hook that would act on it, and at ``init()``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from horovod_tpu.runtime import faults as jfaults

from horovod_tpu_torch.runtime import faults as tfaults

MODS = {"jax": jfaults, "port": tfaults}

SPECS = [
    "delay:q/*:5s",
    "delay:hb/*:250ms, drop:p/3, die:rank1:round4",
    "drop:q/0/1:3",
    "delay@rank1:q/*:1s,delay@rank1:p/*:0.5s",
    "drop@rank0:p/*",
    "slow:3:200ms, slow:rank2:0.05",
    "die:rank0",
    "nan@rank1:grad_buffer*:round2, inf:shard_rs.*",
    "nan:grads.*",
    "preempt:rank1:round4:grace30s",
    "preempt:rank2",
    " , delay:a:1ms ,",
]

BAD = [
    "warp:q/*", "delay:q/*", "die:rank1:roundx", "delay:q/*:5parsecs",
    "drop:p/3:0", "drop:p/3:x", "delay@rankx:q/*:1s", "delay@1:q/*:1s",
    "die:1", "die:rankx", "slow:3", "slow:x:1s", "nan:a:round",
    "nan:a:b:c", "preempt:rank1:soon", "preempt:x", "die:rank1:round2:x",
]


@pytest.mark.parametrize("spec", SPECS)
def test_rules_match_jax(spec):
    rules = {n: [dataclasses.asdict(r) for r in m.parse_spec(spec)]
             for n, m in MODS.items()}
    assert rules["port"] == rules["jax"] and rules["port"]


@pytest.mark.parametrize("spec", BAD)
def test_errors_match_jax(spec):
    texts = {}
    for name, mod in MODS.items():
        with pytest.raises(mod.FaultSpecError) as ei:
            mod.parse_spec(spec)
        texts[name] = str(ei.value)
    assert texts["port"] == texts["jax"]


def test_durations_and_keys_match_jax():
    for text in ("5s", "250ms", "0.5", "12"):
        assert tfaults.parse_duration(text) == jfaults.parse_duration(text)
    for key in ("hvd3/q/7/1", "hvd12/p/4", "hvd1/hb/0", "hvd1/a",
                "hvd2/sq/1/9/3", "hvd2/gq/5/1", "q/x/1"):
        s = tfaults.strip_epoch(key)
        assert s == jfaults.strip_epoch(key)
        assert tfaults.round_of(s) == jfaults.round_of(s)


class _Recorder:
    """A transport that records every call it receives."""

    def __init__(self):
        self.calls = []
        self.data = {}

    def set(self, k, v):
        self.calls.append(("set", k))
        self.data[k] = v

    def set_once(self, k, v):
        self.calls.append(("set_once", k))
        self.data.setdefault(k, v)

    def get_blocking(self, k, timeout_s):
        self.calls.append(("get_blocking", k))
        return self.data.get(k, "")

    def try_get(self, k):
        self.calls.append(("try_get", k))
        return self.data.get(k)

    def delete(self, k):
        self.calls.append(("delete", k))
        self.data.pop(k, None)


OPS = [("set", "hvd1/q/0/1"), ("try_get", "hvd1/p/0"),
       ("set", "hvd1/hb/1"), ("set_once", "hvd1/k/1"),
       ("set", "hvd1/q/1/1"), ("get_blocking", "hvd1/p/1"),
       ("set", "hvd1/q/2/1"), ("set_overwrite", "hvd1/q/2/1"),
       ("delete", "hvd1/q/0/1"), ("set", "hvd1/q/3/1"),
       ("try_get", "hvd1/p/4"), ("set", "hvd1/q/4/1"),
       ("set", "hvd1/q/5/1")]


def _drive(mod, spec: str, rank: int, monkeypatch) -> tuple:
    sleeps, exits = [], []

    def fake_exit(code):
        exits.append(code)
        raise SystemExit(code)

    monkeypatch.setattr(mod.time, "sleep", sleeps.append)
    monkeypatch.setattr(mod.os, "_exit", fake_exit)
    inner = _Recorder()
    ft = mod.FaultyTransport(inner, rank, mod.parse_spec(spec))
    log = []
    for op, key in OPS:
        n0 = len(sleeps)
        try:
            if op == "get_blocking":
                ft.get_blocking(key, 1.0)
            elif op in ("try_get", "delete"):
                getattr(ft, op)(key)
            else:
                getattr(ft, op)(key, "v")
        except SystemExit:
            log.append((op, key, "died"))
            break
        log.append((op, key, tuple(sleeps[n0:])))
    return log, inner.calls, exits


@pytest.mark.parametrize("spec,rank", [
    ("delay@rank1:q/*:1s,delay:p/*:250ms", 1),
    ("delay@rank1:q/*:1s,delay:p/*:250ms", 0),
    ("drop:q/*:2, drop@rank1:hb/*", 1),
    ("die:rank1:round3", 1),
    ("die:rank1:round3", 0),
    ("slow:1:200ms, drop:q/2/*", 1),
    ("nan:grad*:round1, delay:k/*:5ms", 1),
])
def test_faulty_transport_matches_jax(spec, rank, monkeypatch):
    got = {n: _drive(m, spec, rank, monkeypatch) for n, m in MODS.items()}
    assert got["port"] == got["jax"]


class _Entry:
    def __init__(self, name, tensor):
        self.name = name
        self.tensor = tensor


def _payloads():
    rng = np.random.default_rng(7)
    return [("grad_buffer.float32.6", rng.standard_normal((3, 4))
             .astype(np.float32)),
            ("grad_buffer.int32.1", np.arange(5, dtype=np.int32)),
            ("shard_rs.float32.128", rng.standard_normal(7)
             .astype(np.float32)),
            ("other.float32.2", rng.standard_normal(2).astype(np.float32))]


@pytest.mark.parametrize("spec,rank,rounds", [
    ("nan@rank1:grad_buffer*:round2", 1, [1, 2, 3]),
    ("nan@rank1:grad_buffer*:round2", 0, [2]),
    ("inf:shard_rs.*", 0, [0, 1]),
    ("nan:*.float32.*:round1, inf:other*", 2, [1, 1]),
])
def test_poison_entries_matches_jax(spec, rank, rounds, monkeypatch):
    import jax.numpy as jnp

    monkeypatch.setenv("HOROVOD_FAULT_SPEC", spec)
    jfaults._data_cache = ("", [])
    tfaults._data_cache = ("", [])
    for rnd in rounds:
        base = _payloads()
        jents = [_Entry(n, jnp.asarray(a)) for n, a in base]
        tents = [_Entry(n, torch.from_numpy(a.copy())) for n, a in base]
        jfaults.poison_entries(jents, rank, rnd)
        tfaults.poison_entries(tents, rank, rnd)
        for (n, a), je, te in zip(base, jents, tents):
            jv, tv = np.asarray(je.tensor), te.tensor.numpy()
            assert jv.dtype == tv.dtype and jv.shape == tv.shape, n
            np.testing.assert_array_equal(tv, jv, err_msg=f"{n} r{rnd}")
    # the caller's tensor is never written
    t = torch.ones(3)
    monkeypatch.setenv("HOROVOD_FAULT_SPEC", "nan:x")
    tfaults._data_cache = ("", [])
    e = _Entry("x", t)
    tfaults.poison_entries([e], 0, 0)
    assert torch.isnan(e.tensor[0]) and torch.equal(t, torch.ones(3))


def test_preempt_raises_naming_12f(monkeypatch):
    monkeypatch.setenv("HOROVOD_FAULT_SPEC", "delay:q/*:1ms,preempt:rank1")
    for fn in (tfaults.check_spec, tfaults.data_rules,
               lambda: tfaults.maybe_wrap(_Recorder(), 1)):
        tfaults._data_cache = ("", [])
        with pytest.raises(NotImplementedError, match="12f"):
            fn()
    ft = tfaults.FaultyTransport(_Recorder(), 1,
                                 tfaults.parse_spec("preempt:rank1"))
    with pytest.raises(NotImplementedError, match="12f"):
        ft.set("hvd1/q/0/1", "v")
    tfaults._data_cache = ("", [])


def test_init_refuses_preempt_and_bad_specs(monkeypatch):
    import horovod_tpu_torch as hvd

    for k in ("HOROVOD_SIZE", "HOROVOD_RANK"):
        monkeypatch.delenv(k, raising=False)
    for spec, err in (("preempt:rank0", NotImplementedError),
                      ("delay:q/*", tfaults.FaultSpecError)):
        monkeypatch.setenv("HOROVOD_FAULT_SPEC", spec)
        hvd.shutdown()
        try:
            with pytest.raises(err):
                hvd.init(device="cpu")
        finally:
            hvd.shutdown()


def test_maybe_wrap_reads_knob(monkeypatch):
    monkeypatch.delenv("HOROVOD_FAULT_SPEC", raising=False)
    t = _Recorder()
    assert tfaults.maybe_wrap(t, 0) is t
    monkeypatch.setenv("HOROVOD_FAULT_SPEC", "delay:q/*:1ms")
    wrapped = tfaults.maybe_wrap(t, 0)
    assert isinstance(wrapped, tfaults.FaultyTransport)
    assert wrapped.inner is t
    from horovod_tpu_torch.runtime.controller import KVController

    ctl = KVController(wrapped, rank=0, world=2, epoch=1)
    assert ctl.t is wrapped
