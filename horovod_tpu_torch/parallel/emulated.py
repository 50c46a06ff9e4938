"""Emulated ranks on one device: the transport of the port's
single-card checks (``chip_smoke.py`` phases 10, 14a, 15-27 and 29) and
of the schedule pass's program set (:mod:`horovod_tpu_torch.analysis.
programs`).

:class:`EmulatedWorld` runs ``n`` ranks as threads of one process, each
calling the port's own functions over emulated hops (a :class:`~horovod_
tpu_torch.parallel.mesh.Hop` subclass whose transfers meet in the world
instead of in ``torch.distributed``).  It is the counterpart of the
reference's virtual CPU devices: one thread runs at a time, so a run is
deterministic and stays steady under a loaded host.  The emulated hops
report their transfers to the data plane's event hooks as the real ones
do.
"""

from __future__ import annotations

import time


class EmulatedWorld:
    """``n`` emulated ranks on one device, each a thread running the
    port's own functions over emulated hops (:meth:`pair`, :meth:`flat`).
    Only the transport is emulated: one thread runs at a time, and a
    transfer completes when every member of its group has reached it,
    its result computed in member order (sums as ``x0 + x1 + ...``).  Per
    rank it keeps the kernel launches (``counters``: the wrappers'
    ``LAUNCHES`` dicts), the time of the work before each transfer
    (``ms``, keyed by the hop and transfer it ends at; the device is
    synchronized there), the transfers it joined (``calls``, keyed
    likewise) and the payload bytes sent per hop (``wire``).  With
    ``memory`` it keeps each rank's own peak device memory (``peak``):
    one rank runs at a time, so what is allocated between two of its
    transfers is its own (the transfer's result is counted to nobody,
    at most one payload per rank).

    With ``free`` the ranks start off the device: any thread then takes
    rank ``r``'s turn for a span with :meth:`hold` (the eager plane's
    background threads hold it while they execute a response, and
    negotiate between their spans without it)."""

    def __init__(self, torch, n: int, counters=(), sync: bool = True,
                 memory: bool = False, free: bool = False):
        import collections
        import threading

        self.torch, self.n, self.counters, self.sync = torch, n, counters, sync
        self.memory = memory
        self.held, self.peak, self._mem0 = [0] * n, [0] * n, [0] * n
        self.calls = [collections.Counter() for _ in range(n)]
        self.cond = threading.Condition()
        self.turn = None if free else 0
        self.state = ["free" if free else "run"] * n
        self.slots, self.outs, self.seq = {}, {}, {}
        self.launches = [collections.Counter() for _ in range(n)]
        self.ms = [collections.Counter() for _ in range(n)]
        self.wire = [collections.Counter() for _ in range(n)]
        self.error = None
        self._t0, self._snap = [0.0] * n, [{}] * n
        self._hop_cls = _emu_hop_class()

    def _counts(self) -> dict:
        return {k: v for c in self.counters for k, v in c.items()}

    def _start(self, r: int) -> None:
        self._t0[r], self._snap[r] = time.perf_counter(), self._counts()
        if self.memory:
            self._mem0[r] = self.torch.cuda.memory_allocated()
            self.torch.cuda.reset_peak_memory_stats()

    def _stop(self, r: int, label: str) -> None:
        if self.sync:
            self.torch.cuda.synchronize()
        self.ms[r][label] += (time.perf_counter() - self._t0[r]) * 1e3
        if self.memory:
            top = self.torch.cuda.max_memory_allocated() - self._mem0[r]
            self.peak[r] = max(self.peak[r], self.held[r] + top)
            self.held[r] += self.torch.cuda.memory_allocated() - self._mem0[r]
        for k, v in self._counts().items():
            if v != self._snap[r][k]:
                self.launches[r][k] += v - self._snap[r][k]

    def busy_ms(self, r: int) -> float:
        """Rank ``r``'s work so far, called from its own thread (which
        holds the device): its time between transfers, the open interval
        to now included, the device synchronized first."""
        if self.sync:
            self.torch.cuda.synchronize()
        return (sum(self.ms[r].values())
                + (time.perf_counter() - self._t0[r]) * 1e3)

    def _pass(self, r: int) -> None:
        """Hand the device to the next runnable rank after ``r``."""
        for k in range(1, self.n + 1):
            nxt = (r + k) % self.n
            if self.state[nxt] == "run":
                self.turn = nxt
                self.cond.notify_all()
                return
        if any(s == "wait" for s in self.state) \
                and "free" not in self.state and self.error is None:
            self.error = RuntimeError("emulated transfers deadlocked: "
                                      f"rank states {self.state}")
        self.turn = None
        self.cond.notify_all()

    def _wait_turn(self, r: int) -> None:
        while self.turn != r and self.error is None:
            self.cond.wait()
        if self.error is not None:
            raise RuntimeError("another emulated rank failed")

    def hold(self, r: int):
        """Rank ``r``'s turn on the device for the span of a ``with``
        block, taken by whatever thread runs it: it waits its turn, its
        transfers pass the device as :meth:`run`'s do, and at the end the
        rank is free again (off the rota until its next span)."""
        import contextlib

        @contextlib.contextmanager
        def span():
            with self.cond:
                self.state[r] = "run"
                if self.turn is None:
                    self.turn = r
                self._wait_turn(r)
                self._start(r)
            try:
                yield
            finally:
                with self.cond:
                    self._stop(r, "end")
                    self.state[r] = "free"
                    self._pass(r)

        return span()

    def transfer(self, hop, label: str, payload, nbytes: int, combine):
        """One member's part of a transfer over ``hop``: its payload in,
        its result (from ``combine(payloads in member order)``) out."""
        r = hop.rank
        with self.cond:
            self._stop(r, f"{hop.name}.{label}")
            self.calls[r][f"{hop.name}.{label}"] += 1
            self.wire[r][hop.name] += nbytes
            n = self.seq.get((r, hop.key), 0)
            self.seq[(r, hop.key)] = n + 1
            k = (hop.key, n)
            self.slots.setdefault(k, {})[hop.index] = payload
            if len(self.slots[k]) == hop.size:
                slot = self.slots.pop(k)
                self.outs[k] = dict(enumerate(combine(
                    [slot[i] for i in range(hop.size)])))
                if self.sync:  # the transport's own work, timed by nobody
                    self.torch.cuda.synchronize()
                for m in hop.ranks:
                    self.state[m] = "run"
            else:
                self.state[r] = "wait"
            self._pass(r)
            self._wait_turn(r)
            out = self.outs[k].pop(hop.index)
            if not self.outs[k]:
                del self.outs[k]
            self._start(r)
            return out

    def run(self, fn) -> list:
        """``fn(rank)`` on every emulated rank; their results."""
        import threading

        results = [None] * self.n

        def body(r):
            with self.cond:
                try:
                    self._wait_turn(r)
                except RuntimeError:
                    return
                self._start(r)
            try:
                res = fn(r)
            except BaseException as exc:  # noqa: BLE001 -- re-raised below
                with self.cond:
                    self.error = self.error or exc
                    self.state[r] = "done"
                    self.cond.notify_all()
                return
            with self.cond:
                self._stop(r, "end")
                results[r] = res
                self.state[r] = "done"
                self._pass(r)

        threads = [threading.Thread(target=body, args=(r,), daemon=True)
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        if self.error is not None:
            raise self.error
        if any(t.is_alive() for t in threads):
            raise AssertionError("an emulated rank did not finish")
        return results

    def hop(self, r: int, ranks, name: str):
        return self._hop_cls(self, r, ranks, name)

    def flat(self, r: int):
        """Rank ``r``'s hop over the whole emulated world."""
        return self.hop(r, range(self.n), "flat")

    def pair(self, r: int, local: int):
        """Rank ``r``'s ``(cross, local)`` pair: ``local`` consecutive
        ranks per local group, cross-major (``r = c * local + l``)."""
        from horovod_tpu_torch.parallel.mesh import HopPair

        c, l_ = divmod(r, local)
        return HopPair(self.hop(r, range(l_, self.n, local), "cross"),
                       self.hop(r, range(c * local, (c + 1) * local),
                                "local"),
                       self.flat(r))


def _emu_hop_class():
    """The ``Hop`` of an :class:`EmulatedWorld` (built when the port is
    importable)."""
    import torch

    from horovod_tpu_torch.common import events as _events
    from horovod_tpu_torch.parallel.mesh import Hop

    def _sum(xs):
        acc = xs[0].clone()
        for x in xs[1:]:
            acc.add_(x)
        return acc

    class EmuHop(Hop):
        def __init__(self, world, r, ranks, name):
            ranks = list(ranks)
            super().__init__(ranks, ranks.index(r), None, name)
            self.world, self.rank, self.key = world, r, (name, tuple(ranks))

        def _go(self, label, t, combine, payload=None, opcode=None,
                out=None, pairs=None):
            # the emulated transport reports each transfer as the real
            # one does: its bytes (the eager plane's
            # hvd_data_wire_bytes_total) and its record
            _events.note_transfer(self, opcode, t, out, pairs)
            return self.world.transfer(
                self, label, t if payload is None else payload,
                t.numel() * t.element_size(), combine)

        def all_reduce(self, t, op="sum"):
            if self.size > 1:
                def combine(xs):
                    if op == "max":
                        acc = xs[0].clone()
                        for x in xs[1:]:
                            torch.maximum(acc, x, out=acc)
                    else:
                        acc = _sum(xs)
                    return [acc] * len(xs)
                t.copy_(self._go(f"all_reduce({op})", t, combine,
                                 opcode="all-reduce"))
            return t

        def reduce_scatter(self, out, src, async_op=False):
            out.copy_(self._go("reduce_scatter", src, lambda xs: list(
                _sum(xs).reshape(len(xs), -1)), opcode="reduce-scatter",
                out=out).reshape(out.shape))

        def all_gather(self, out, src, async_op=False):
            out.copy_(self._go("all_gather", src, lambda xs: [torch.cat(
                [x.reshape(-1) for x in xs])] * len(xs), opcode="all-gather",
                out=out).reshape(out.shape))

        def all_to_all(self, out, src):
            out.copy_(self._go("all_to_all", src, lambda xs: [torch.cat(
                [x.reshape(len(xs), -1)[j] for x in xs])
                for j in range(len(xs))], opcode="all-to-all",
                out=out).reshape(out.shape))

        def broadcast(self, t, root):
            t.copy_(self._go("broadcast", t,
                             lambda xs: [xs[root]] * len(xs),
                             opcode="broadcast"))
            return t

        def exchange(self, t, peer):
            # every member exchanges at an Adasum level: one transfer of
            # the group, each member taking its peer's vector
            return self._go("exchange", t, lambda xs: [
                xs[xs[i][1]][0].clone() for i in range(len(xs))],
                payload=(t, peer), opcode="collective-permute",
                pairs=[(self.index, peer), (peer, self.index)])

        def permute(self, t, pairs, like=None):
            # every member calls it with the same pairs: one transfer of
            # the group, the bytes counted to the pairs' sources only
            pairs = [(int(a), int(b)) for a, b in pairs]
            if not pairs:
                return None
            sent = t if any(a == self.index for a, _ in pairs) else None
            _events.note_transfer(self, "collective-permute", sent,
                                  t if t is not None else like, pairs)

            def combine(xs):
                outs = [None] * len(xs)
                for a, b in pairs:
                    outs[b] = xs[a].clone()
                return outs

            return self.world.transfer(
                self, "permute", sent,
                0 if sent is None else sent.numel() * sent.element_size(),
                combine)

    return EmuHop
