"""The port's native KV store (``horovod_tpu_torch/runtime/kvstore.py``,
``csrc/kvstore.cc``) against the JAX package's.

1. Authentication (``tests/test_kv_auth.py``'s six cases): a client with
   the job secret works, a wrong secret is refused, a raw socket that
   skips the handshake cannot SET, the C++ HMAC is RFC 2104's, garbage
   after the handshake drops only that connection, an empty secret
   turns auth off.
2. The bounded retry and reconnect (``test_fault_tolerance.py:472``).
3. The wire is the JAX package's byte for byte: the port's client
   against the reference's server and the reference's client against
   the port's, with and without a secret, give the same values and the
   same refusals.
4. The build: the library is the port's own (``libhvdtorchkv_<hash>``
   under ``horovod_tpu_torch/_build/``), loaded beside the JAX package's
   in one process; the metrics publisher rides it.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import random
import socket
import struct
import time

import pytest

from horovod_tpu_torch.runtime import kvstore

SECRET = b"job-secret-123"


@pytest.fixture()
def server():
    srv = kvstore.KVStoreServer(secret=SECRET)
    yield srv
    srv.stop()


def test_authenticated_client_roundtrip(server):
    c = kvstore.KVStoreClient("127.0.0.1", server.port,
                              connect_timeout_s=5, secret=SECRET)
    c.set("k", "v")
    assert c.try_get("k") == "v"
    c.set_once("k", "other")          # EXISTS is benign and keeps v
    assert c.get_blocking("k", 1.0) == "v"
    c.delete("k")
    assert c.try_get("k") is None
    with pytest.raises(TimeoutError):
        c.get_blocking("k", 0.2)
    assert c.ping()
    assert server.connections() >= 1
    assert server.pending_gets() == 0
    c.close()


def test_wrong_secret_rejected(server):
    with pytest.raises(OSError, match="SECRET_KEY mismatch|could not reach"):
        kvstore.KVStoreClient("127.0.0.1", server.port,
                              connect_timeout_s=2, secret=b"wrong")


def test_unauthenticated_raw_socket_cannot_set(server):
    """A client that skips the handshake and fires a SET frame must not
    mutate the store."""
    s = socket.create_connection(("127.0.0.1", server.port), timeout=5)
    key, val = b"poison", b"1"
    s.sendall(struct.pack("<BI", 1, len(key)) + key +
              struct.pack("<I", len(val)) + val)
    s.settimeout(5)
    leftover = b""
    try:
        while True:
            chunk = s.recv(4096)
            if not chunk:
                break
            leftover += chunk
    except (ConnectionResetError, socket.timeout):
        pass
    s.close()
    # only the 20-byte challenge may have been sent
    assert len(leftover) <= 20
    good = kvstore.KVStoreClient("127.0.0.1", server.port,
                                 connect_timeout_s=5, secret=SECRET)
    assert good.try_get("poison") is None
    good.close()


def _authed_socket(port: int, secret: bytes = SECRET):
    """A raw socket through the HVK2 challenge-response, the MAC made
    with Python's hmac."""
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    challenge = b""
    while len(challenge) < 20:
        chunk = s.recv(20 - len(challenge))
        assert chunk, "server closed during challenge"
        challenge += chunk
    assert challenge[:4] == b"HVK2"
    s.sendall(hmac.new(secret, challenge[4:], hashlib.sha256).digest())
    assert s.recv(1) == b"\x00", "python HMAC rejected by the C++ verifier"
    return s


def test_cpp_hmac_matches_python_hmac(server):
    s = _authed_socket(server.port)
    key, val = b"from-python", b"yes"
    s.sendall(struct.pack("<BI", 1, len(key)) + key +
              struct.pack("<I", len(val)) + val)
    assert s.recv(1) == b"\x00"
    s.close()


def test_malformed_frames_after_auth_do_not_kill_server(server):
    rng = random.Random(0)
    for _ in range(10):
        s = _authed_socket(server.port)
        s.sendall(bytes(rng.randrange(256)
                        for _ in range(rng.randrange(1, 64))))
        s.close()
    good = kvstore.KVStoreClient("127.0.0.1", server.port,
                                 connect_timeout_s=5, secret=SECRET)
    good.set("alive", "yes")
    assert good.try_get("alive") == "yes"
    good.close()


def test_no_secret_server_accepts_any_client():
    srv = kvstore.KVStoreServer(secret=b"")
    try:
        c = kvstore.KVStoreClient("127.0.0.1", srv.port,
                                  connect_timeout_s=5, secret=b"")
        c.set("a", "b")
        assert c.try_get("a") == "b"
        c.close()
    finally:
        srv.stop()


def test_kv_client_bounded_retry_and_recovery():
    """A dead server fails fast with attempt context; a server back on
    the same port is reconnected to within the retry budget."""
    srv = kvstore.KVStoreServer(secret=b"")
    port = srv.port
    client = kvstore.KVStoreClient("127.0.0.1", port, connect_timeout_s=2.0,
                                   secret=b"", retries=2)
    client.set("k", "v1")
    assert client.try_get("k") == "v1"
    srv.stop()
    t0 = time.monotonic()
    with pytest.raises(OSError) as ei:
        client.set("k", "v2")
    assert time.monotonic() - t0 < 20
    assert "attempt" in str(ei.value)
    client.delete("k")          # a dead handle degrades, never segfaults
    assert client.ping() is False
    srv2 = kvstore.KVStoreServer(port=port, secret=b"")
    try:
        client.set("k", "v3")
        assert client.try_get("k") == "v3"
        assert client.ping() is True
    finally:
        client.close()
        srv2.stop()


def _ops(client) -> list:
    """One fixed sequence of ops; what each returned."""
    out = []
    client.set("a", "1")
    client.set_once("a", "2")
    client.set_once("b", "x" * 1000)
    out.append(client.try_get("a"))
    out.append(client.try_get("b"))
    out.append(client.get_blocking("a", 1.0))
    client.set_overwrite("a", "3")
    out.append(client.try_get("a"))
    client.delete("b")
    out.append(client.try_get("b"))
    out.append(client.try_get("missing"))
    try:
        client.get_blocking("missing", 0.1)
        out.append("no-timeout")
    except TimeoutError:
        out.append("timeout")
    out.append(client.ping())
    return out


@pytest.mark.parametrize("secret", [b"", SECRET], ids=["open", "secret"])
def test_wire_parity_with_the_jax_package(secret):
    """Each package's client against each package's server: the same
    values, and the same refusal of a wrong secret."""
    from horovod_tpu.runtime import kvstore as jkv

    results = {}
    for sname, smod in (("port", kvstore), ("jax", jkv)):
        srv = smod.KVStoreServer(secret=secret)
        try:
            for cname, cmod in (("port", kvstore), ("jax", jkv)):
                c = cmod.KVStoreClient("127.0.0.1", srv.port,
                                       connect_timeout_s=5, secret=secret)
                try:
                    results[(sname, cname)] = _ops(c)
                    c.delete("a")
                finally:
                    c.close()
                if secret:
                    with pytest.raises(OSError):
                        cmod.KVStoreClient("127.0.0.1", srv.port,
                                           connect_timeout_s=2,
                                           secret=b"wrong")
            # a value one package wrote reads back through the other
            a = kvstore.KVStoreClient("127.0.0.1", srv.port, secret=secret)
            b = jkv.KVStoreClient("127.0.0.1", srv.port, secret=secret)
            a.set("cross", "from-port")
            assert b.get_blocking("cross", 1.0) == "from-port"
            b.set("cross", "from-jax")
            assert a.try_get("cross") == "from-jax"
            a.close()
            b.close()
        finally:
            srv.stop()
    first = results[("port", "port")]
    assert first == ["1", "x" * 1000, "1", "3", None, None, "timeout", True]
    for k, v in results.items():
        assert v == first, k


def test_library_is_the_ports_own_and_loads_beside_the_jax_one():
    from horovod_tpu.runtime import kvstore as jkv
    from horovod_tpu_torch import _build

    path = kvstore.library_path()
    assert os.path.basename(path).startswith("libhvdtorchkv_")
    assert os.path.dirname(path) == _build.BUILD_DIR
    jkv._load()
    assert jkv._LIB_PATH != path and kvstore._load() is not jkv._load()
    with open(os.path.join(_build.CSRC, "kvstore.cc")) as f:
        port_src = f.read()
    with open(os.path.join(os.path.dirname(jkv.__file__), os.pardir,
                           "csrc", "kvstore.cc")) as f:
        jax_src = f.read()
    # the same wire: only the build note differs
    strip = [ln for ln in port_src.splitlines() if "g++" not in ln
             and "Built at first use" not in ln and "Build:" not in ln]
    assert strip == [ln for ln in jax_src.splitlines()
                     if "g++" not in ln and "Build:" not in ln]


def test_secret_decode_matches_the_jax_package(monkeypatch):
    from horovod_tpu.runtime import kvstore as jkv

    for raw in ("", "00ff10", "not-hex", "ABCDEF"):
        assert kvstore.decode_secret(raw) == jkv.decode_secret(raw)
        monkeypatch.setenv("HOROVOD_SECRET_KEY", raw)
        assert kvstore.job_secret() == jkv.job_secret()


def test_metrics_publisher_rides_the_kv_store(monkeypatch):
    from horovod_tpu_torch.runtime import metrics as TM

    srv = kvstore.KVStoreServer(secret=b"")
    try:
        monkeypatch.setenv("HOROVOD_GLOO_RENDEZVOUS_ADDR", "127.0.0.1")
        monkeypatch.setenv("HOROVOD_GLOO_RENDEZVOUS_PORT", str(srv.port))
        monkeypatch.setenv("HOROVOD_SECRET_KEY", "")
        monkeypatch.setenv("HOROVOD_METRICS_PUBLISH_INTERVAL", "0.05")
        pub = TM.maybe_start_kv_publisher(0, 2, 3)
        assert isinstance(pub, TM.KVSnapshotPublisher)
        TM.counter("torch_kv_pub_probe_total", "probe").inc()
        pub.stop()
        c = kvstore.KVStoreClient("127.0.0.1", srv.port, secret=b"")
        assert json.loads(c.try_get(TM.INDEX_KEY)) == {"epoch": 3,
                                                       "size": 2}
        snap = json.loads(c.try_get("hvd3/metrics/0"))
        assert snap["meta"]["rank"] == 0 and snap["meta"]["size"] == 2
        assert "torch_kv_pub_probe_total" in snap["metrics"]
        snaps, idx = TM.aggregate_snapshots(c.try_get)
        assert idx["size"] == 2 and snaps[0]["meta"]["generation"] == 3
        c.close()
        monkeypatch.setenv("HOROVOD_METRICS_PUBLISH_INTERVAL", "0")
        assert TM.maybe_start_kv_publisher(0, 2, 3) is None
    finally:
        srv.stop()
