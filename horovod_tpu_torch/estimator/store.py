"""Training artifact store (counterpart of
``horovod_tpu/estimator/store.py``; reference
``horovod/spark/common/store.py:30-175``): a ``Store`` holds
intermediate training data, per-run checkpoints and logs under a common
prefix; the estimators read and write through it, so the training ranks
find everything by ``run_id``.

Two concrete stores mirror the reference's Local/HDFS pair:
:class:`LocalStore` (filesystem paths; a multi-host run needs a shared
filesystem, as the reference's ``LocalStore`` does) and :class:`KVStore`
(artifacts live in an authed server of the port's native KV store,
:mod:`horovod_tpu_torch.runtime.kvstore`: the reference's ``HDFSStore``
role, with no shared filesystem; the ranks reach it over TCP).
"""

from __future__ import annotations

import base64
import os
import shutil


class Store:
    """Abstract artifact layout (reference ``Store`` base)."""

    def get_train_data_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_val_data_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_checkpoint_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_logs_path(self, run_id: str) -> str:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def make_dir(self, path: str) -> None:
        raise NotImplementedError

    # blob IO: every artifact moves through these two, so a store can
    # back them with anything the ranks reach (files, the KV store, ...)
    def write_bytes(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def read_bytes(self, path: str, timeout_s: float = 120.0) -> bytes:
        raise NotImplementedError

    def cleanup_run(self, run_id: str) -> None:
        """Drop a run's intermediate data (checkpoints and logs stay)."""

    @staticmethod
    def create(prefix_path: str) -> "Store":
        """Reference ``Store.create``: a ``kv://host:port`` URL attaches
        to a running KV store server, anything else is a local
        filesystem prefix."""
        if prefix_path.startswith("kv://"):
            hostport = prefix_path[5:].rstrip("/")
            host, _, port = hostport.partition(":")
            if not host or not port.isdigit():
                raise ValueError(
                    f"KV store URL must be kv://host:port, got "
                    f"{prefix_path!r}")
            return KVStore(addr=host, port=int(port))
        return LocalStore(prefix_path)


class LocalStore(Store):
    """Filesystem store (reference ``LocalStore``), laid out as

    ``<prefix>/intermediate_data/<run_id>/{train,val}/part.<rank>.npz``
    ``<prefix>/checkpoints/<run_id>/``
    ``<prefix>/logs/<run_id>/``
    """

    def __init__(self, prefix_path: str):
        self.prefix_path = os.path.abspath(prefix_path)
        os.makedirs(self.prefix_path, exist_ok=True)

    def get_train_data_path(self, run_id: str) -> str:
        return os.path.join(self.prefix_path, "intermediate_data",
                            run_id, "train")

    def get_val_data_path(self, run_id: str) -> str:
        return os.path.join(self.prefix_path, "intermediate_data",
                            run_id, "val")

    def get_checkpoint_path(self, run_id: str) -> str:
        return os.path.join(self.prefix_path, "checkpoints", run_id)

    def get_logs_path(self, run_id: str) -> str:
        return os.path.join(self.prefix_path, "logs", run_id)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def make_dir(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def write_bytes(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic: a reader never sees half a blob

    def read_bytes(self, path: str, timeout_s: float = 120.0) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def cleanup_run(self, run_id: str) -> None:
        shutil.rmtree(os.path.join(self.prefix_path, "intermediate_data",
                                   run_id), ignore_errors=True)


class KVStore(Store):
    """A store with no shared filesystem: artifacts live in the memory
    of a :class:`~horovod_tpu_torch.runtime.kvstore.KVStoreServer`,
    keyed by their virtual path (reference ``HDFSStore`` role,
    ``spark/common/store.py:30-175``).

    Built with no ``addr`` it starts a fresh authed server on this host
    (the driver).  The object pickles into the training spec as
    ``(addr, port, secret)`` only, and each rank connects its own client
    at its first IO: the HMAC challenge-response rides the carried
    secret, not the environment.  Values cross the server's string wire
    base64-coded, whose length field caps one value at ``1 << 28``
    bytes (``csrc/kvstore.cc``).
    """

    def __init__(self, addr: str | None = None, port: int = 0,
                 secret: bytes | None = None):
        from horovod_tpu_torch.runtime.kvstore import job_secret

        self._server = None
        self._client = None
        self._written: list[str] = []  # the driver's cleanup index
        if secret is None:
            secret = job_secret()
            if not secret:
                if addr is not None:
                    # attaching: a made-up secret could never pass the
                    # server's handshake, so fail here, not at first IO
                    raise ValueError(
                        "attaching to a KV store server requires its "
                        "secret: pass secret=... or set "
                        "HOROVOD_SECRET_KEY to the server's value")
                secret = os.urandom(16)
        self.secret = secret
        if addr is None:
            import socket

            from horovod_tpu_torch.runtime.kvstore import KVStoreServer

            self._server = KVStoreServer(port=port, secret=secret)
            self.addr = socket.gethostname()
            self.port = self._server.port
        else:
            self.addr = addr
            self.port = port

    # -- pickling: a rank gets (addr, port, secret), never handles ------
    def __getstate__(self):
        return {"addr": self.addr, "port": self.port,
                "secret": self.secret}

    def __setstate__(self, state):
        self.addr = state["addr"]
        self.port = state["port"]
        self.secret = state["secret"]
        self._server = None
        self._client = None
        self._written = []

    def _kv(self):
        if self._client is None:
            from horovod_tpu_torch.runtime.kvstore import KVStoreClient

            self._client = KVStoreClient(self.addr, self.port,
                                         secret=self.secret)
        return self._client

    def stop(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None
        if self._server is not None:
            self._server.stop()
            self._server = None

    # -- layout: virtual paths, shaped as LocalStore's ------------------
    def get_train_data_path(self, run_id: str) -> str:
        return f"intermediate_data/{run_id}/train"

    def get_val_data_path(self, run_id: str) -> str:
        return f"intermediate_data/{run_id}/val"

    def get_checkpoint_path(self, run_id: str) -> str:
        return f"checkpoints/{run_id}"

    def get_logs_path(self, run_id: str) -> str:
        return f"logs/{run_id}"

    def exists(self, path: str) -> bool:
        if self._kv().try_get(path) is not None:
            return True
        # a directory is any tracked key under the prefix
        return any(k.startswith(path.rstrip("/") + "/")
                   for k in self._written)

    def make_dir(self, path: str) -> None:
        pass  # directories are implicit in the keys

    #: the largest raw blob whose base64 form fits the server's cap of
    #: ``1 << 28`` bytes per value: ``ceil(n / 3) * 4 <= 1 << 28``
    MAX_BLOB_BYTES = (1 << 28) // 4 * 3

    def write_bytes(self, path: str, data: bytes) -> None:
        if len(data) > self.MAX_BLOB_BYTES:
            raise ValueError(
                f"blob {path!r} is {len(data) / 2**20:.0f} MiB; KVStore "
                f"caps one value at {self.MAX_BLOB_BYTES // 2**20} MiB — "
                "lower rows_per_chunk (streaming ingest) or use a "
                "filesystem store for shards this large")
        self._kv().set(path, base64.b64encode(data).decode())
        self._written.append(path)

    def read_bytes(self, path: str, timeout_s: float = 120.0) -> bytes:
        return base64.b64decode(self._kv().get_blocking(path, timeout_s))

    def cleanup_run(self, run_id: str) -> None:
        prefix = f"intermediate_data/{run_id}/"
        kept = []
        for k in self._written:
            if k.startswith(prefix):
                self._kv().delete(k)
            else:
                kept.append(k)
        self._written = kept
