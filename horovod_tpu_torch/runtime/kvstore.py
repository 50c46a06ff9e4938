"""Python bindings (ctypes) for the native KV-store wire: the copy of
``horovod_tpu/runtime/kvstore.py`` in this package.

The server side plays the reference launcher's ``RendezvousServer``
(``horovod/run/http/http_server.py:108-210``); the client side plays the
``HTTPStore``/gloo store C++ client (``horovod/common/gloo/http_store.h``)
and implements the transport interface the KV controller needs
(set/set_once/get_blocking/try_get/delete).  The wire is the JAX
package's byte for byte, so a client of either package talks to a server
of the other.  The library (``csrc/kvstore.cc``) builds at first use with
``g++`` into ``horovod_tpu_torch/_build/libhvdtorchkv_<hash>.so``
(:func:`horovod_tpu_torch._build.load_host_library`); a failed build
raises.
"""

from __future__ import annotations

import ctypes
import os
import random
import socket
import threading
import time

from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common import logging as _log
from horovod_tpu_torch.runtime import flight as _flight
from horovod_tpu_torch.runtime import metrics as _metrics

LIB_NAME = "hvdtorchkv"

# Wire-layer observability (docs/metrics.md).  Counter increments are
# in-memory only; every op below already pays a TCP roundtrip, so the
# accounting cost is noise.
_M_RETRIES = _metrics.counter(
    "hvd_wire_retries_total",
    "Control-plane wire retries, labeled by op: KV client "
    "reconnect-and-retry attempts plus controller blocking-get slice "
    "expiries.")
_M_BACKOFF = _metrics.counter(
    "hvd_wire_backoff_seconds_total",
    "Seconds slept in KV wire retry backoff.")
_M_FAILURES = _metrics.counter(
    "hvd_wire_failures_total",
    "KV wire ops that exhausted their retry budget, labeled by op.")
_M_TX = _metrics.counter(
    "hvd_wire_tx_bytes_total", "KV payload bytes written (set/set_once).")
_M_RX = _metrics.counter(
    "hvd_wire_rx_bytes_total", "KV payload bytes read (get).")
_M_SRV_CONNS = _metrics.gauge(
    "hvd_kv_server_connections",
    "Live client connections on the in-process KV server, labeled by "
    "port.  Sampled when KVStoreServer.connections() is called.")
_M_SRV_PENDING = _metrics.gauge(
    "hvd_kv_server_pending_gets",
    "Clients parked in a blocking GET_WAIT on the in-process KV "
    "server, labeled by port.  Sampled when "
    "KVStoreServer.pending_gets() is called.")

_lib = None
_load_lock = threading.Lock()


def decode_secret(value: str) -> bytes:
    """Canonical secret-string → bytes decode, shared by the launcher
    (server side) and ranks (client side) so the two ends can never
    disagree on how ``HOROVOD_SECRET_KEY`` is parsed."""
    try:
        return bytes.fromhex(value)
    except ValueError:
        return value.encode()


def job_secret() -> bytes:
    """The per-job wire-auth secret (reference
    ``run/common/util/secret.py:26``): hex in ``HOROVOD_SECRET_KEY``,
    injected into every rank's env by the launcher.  Empty = no auth
    (single-user unit-test mode)."""
    return decode_secret(os.environ.get("HOROVOD_SECRET_KEY", ""))


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        from horovod_tpu_torch import _build

        lib = _build.load_host_library(LIB_NAME, "kvstore.cc")
        lib.hvd_kv_server_start.restype = ctypes.c_void_p
        lib.hvd_kv_server_start.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                            ctypes.c_int]
        lib.hvd_kv_server_port.restype = ctypes.c_int
        lib.hvd_kv_server_port.argtypes = [ctypes.c_void_p]
        lib.hvd_kv_server_stop.argtypes = [ctypes.c_void_p]
        lib.hvd_kv_server_connections.restype = ctypes.c_long
        lib.hvd_kv_server_connections.argtypes = [ctypes.c_void_p]
        lib.hvd_kv_server_pending_gets.restype = ctypes.c_long
        lib.hvd_kv_server_pending_gets.argtypes = [ctypes.c_void_p]
        lib.hvd_kv_connect.restype = ctypes.c_void_p
        lib.hvd_kv_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_char_p,
                                       ctypes.c_int]
        lib.hvd_kv_close.argtypes = [ctypes.c_void_p]
        lib.hvd_kv_set.restype = ctypes.c_int
        lib.hvd_kv_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_int]
        lib.hvd_kv_get.restype = ctypes.c_int
        lib.hvd_kv_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_char_p),
                                   ctypes.POINTER(ctypes.c_int)]
        lib.hvd_kv_delete.restype = ctypes.c_int
        lib.hvd_kv_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.hvd_kv_ping.restype = ctypes.c_int
        lib.hvd_kv_ping.argtypes = [ctypes.c_void_p]
        lib.hvd_kv_free.argtypes = [ctypes.c_char_p]
        _lib = lib
        return _lib


def library_path() -> str:
    """Path of the loaded KV-store library (builds it first)."""
    from horovod_tpu_torch import _build

    _load()
    return _build.build_info[LIB_NAME]["path"]


class KVStoreServer:
    """Native rendezvous server (launcher side).  ``secret=None`` reads
    ``HOROVOD_SECRET_KEY``; pass ``b""`` explicitly to disable auth."""

    def __init__(self, port: int = 0, secret: bytes | None = None):
        lib = _load()
        secret = job_secret() if secret is None else secret
        self._handle = lib.hvd_kv_server_start(port, secret, len(secret))
        if not self._handle:
            raise OSError(f"KV server failed to bind port {port}")
        self.port = lib.hvd_kv_server_port(self._handle)

    def connections(self) -> int:
        """Live client connections; also publishes the
        ``hvd_kv_server_connections`` gauge."""
        if not self._handle:
            return 0
        n = int(_load().hvd_kv_server_connections(self._handle))
        _M_SRV_CONNS.set(n, port=str(self.port))
        return n

    def pending_gets(self) -> int:
        """Clients currently parked in a blocking GET_WAIT; also
        publishes the ``hvd_kv_server_pending_gets`` gauge.  At steady
        state this tracks how many ranks are blocked on the
        coordinator — a persistently high value at pod scale is the
        flat control plane's O(world) star showing up as server
        load (docs/control-plane.md)."""
        if not self._handle:
            return 0
        n = int(_load().hvd_kv_server_pending_gets(self._handle))
        _M_SRV_PENDING.set(n, port=str(self.port))
        return n

    def stop(self) -> None:
        if self._handle:
            _load().hvd_kv_server_stop(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.stop()
        except Exception:
            pass


class KVStoreClient:
    """Transport for
    :class:`horovod_tpu_torch.runtime.controller.KVController`.

    Wire failures (rc=-1: the TCP stream died mid-roundtrip) are
    retried with a bounded exponential backoff + jitter, reconnecting
    between attempts — a rendezvous-server blip or a dropped
    connection must not take the whole rank down when the job is
    otherwise healthy (``HOROVOD_KV_RETRIES`` bounds the attempts)."""

    def __init__(self, addr: str, port: int, connect_timeout_s: float = 60.0,
                 secret: bytes | None = None, retries: int | None = None):
        self._lib = _load()
        self._addr = addr
        self._host = socket.gethostbyname(addr or "127.0.0.1")
        self._port = int(port)
        self._connect_timeout_s = connect_timeout_s
        self._secret = job_secret() if secret is None else secret
        self._retries = (max(0, int(_config.get("kv_retries")))
                         if retries is None else max(0, retries))
        self._lock = threading.Lock()  # one wire, serialized roundtrips
        self._handle = self._connect(connect_timeout_s)
        if not self._handle:
            raise OSError(
                f"KV client could not reach {addr}:{port} (network, or "
                "HOROVOD_SECRET_KEY mismatch with the launcher)")

    def _connect(self, timeout_s: float):
        return self._lib.hvd_kv_connect(
            self._host.encode(), self._port, int(timeout_s * 1000),
            self._secret, len(self._secret))

    def _backoff(self, attempt: int) -> None:
        """Exponential backoff with ±50% jitter, capped at 2 s: 50 ms,
        100 ms, 200 ms, ... — jitter decorrelates a whole job's ranks
        retrying against the same recovering server."""
        base = min(2.0, 0.05 * (2 ** attempt))
        slept = base * random.uniform(0.5, 1.5)
        _M_BACKOFF.inc(slept)
        time.sleep(slept)

    def _reconnect(self, attempt: int) -> None:
        self._backoff(attempt)
        with self._lock:
            if self._handle:
                self._lib.hvd_kv_close(self._handle)
            # short per-attempt budget; the attempt loop bounds the total
            self._handle = self._connect(min(self._connect_timeout_s, 5.0))

    def close(self) -> None:
        # Under the lock: a background thread may be mid-roundtrip on
        # this handle (it holds the lock for the duration), and closing
        # underneath it would free the C client while in use.
        with self._lock:
            if self._handle:
                self._lib.hvd_kv_close(self._handle)
                self._handle = None

    def _set(self, key: str, value: str, once: bool) -> None:
        op = "set_once" if once else "set"
        rc = -1
        for attempt in range(self._retries + 1):
            with self._lock:
                # handle re-read under the lock: _reconnect (another
                # thread) may have swapped it to NULL after a failed
                # attempt, and the C side dereferences it unchecked
                rc = (self._lib.hvd_kv_set(
                    self._handle, key.encode(), value.encode(),
                    len(value.encode()), 1 if once else 0)
                    if self._handle else -1)
            if rc == 0 or (once and rc == 2):  # 2 = EXISTS: benign
                _M_TX.inc(len(value.encode()))
                return
            if rc > 0:
                raise OSError(f"kv {op}({key}) failed rc={rc}")
            if attempt < self._retries:
                _M_RETRIES.inc(op=op)
                _flight.record("kv_retry", op=op, key=key,
                               attempt=attempt + 1)
                _log.warning(
                    f"kv {op}({key}) wire failure; reconnect attempt "
                    f"{attempt + 1}/{self._retries}")
                try:
                    self._reconnect(attempt)
                except OSError:
                    continue
        _M_FAILURES.inc(op=op)
        _flight.record("kv_fail", op=op, key=key)
        raise OSError(
            f"kv {op}({key}) failed after {self._retries + 1} attempt(s) "
            f"(wire rc={rc}; rendezvous {self._addr}:{self._port} down?)")

    def set(self, key: str, value: str) -> None:
        self._set(key, value, once=False)

    def set_once(self, key: str, value: str) -> None:
        self._set(key, value, once=True)

    # Mutable heartbeat writes: the native store's SET always overwrites.
    set_overwrite = set

    def _get(self, key: str, timeout_ms: int, try_only: bool):
        deadline = time.monotonic() + timeout_ms / 1000.0
        for attempt in range(self._retries + 1):
            buf = ctypes.c_char_p()
            n = ctypes.c_int()
            remaining_ms = max(0, int(
                (deadline - time.monotonic()) * 1000))
            with self._lock:
                rc = (self._lib.hvd_kv_get(
                    self._handle, key.encode(), remaining_ms,
                    1 if try_only else 0,
                    ctypes.byref(buf), ctypes.byref(n))
                    if self._handle else -1)
            if rc == 0:
                try:
                    _M_RX.inc(int(n.value))
                    return ctypes.string_at(buf, n.value).decode()
                finally:
                    self._lib.hvd_kv_free(buf)
            if rc > 0:
                return None  # NOT_FOUND / timed out: a real verdict
            if attempt < self._retries:
                _M_RETRIES.inc(op="get")
                _flight.record("kv_retry", op="get", key=key,
                               attempt=attempt + 1)
                try:
                    self._reconnect(attempt)
                except OSError:
                    continue
        _M_FAILURES.inc(op="get")
        _flight.record("kv_fail", op="get", key=key)
        raise OSError(
            f"kv get({key}) wire failure after {self._retries + 1} "
            f"attempt(s) (rendezvous {self._addr}:{self._port} down?)")

    def get_blocking(self, key: str, timeout_s: float) -> str:
        out = self._get(key, int(timeout_s * 1000), False)
        if out is None:
            raise TimeoutError(
                f"kv get({key}) timed out after {timeout_s:.0f}s")
        return out

    def try_get(self, key: str):
        return self._get(key, 0, True)

    def delete(self, key: str) -> None:
        with self._lock:
            if self._handle:
                self._lib.hvd_kv_delete(self._handle, key.encode())

    def ping(self) -> bool:
        with self._lock:
            return bool(self._handle) and \
                self._lib.hvd_kv_ping(self._handle) == 0
