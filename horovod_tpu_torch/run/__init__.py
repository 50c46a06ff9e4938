"""horovod_tpu_torch.run — the launcher package (the copy of
``horovod_tpu/run/``).

``python -m horovod_tpu_torch.run -np N ...`` is ``hvdrun``
(:mod:`horovod_tpu_torch.run.launcher`).  ``run(fn, args=(), kwargs=None,
np=2, ...)`` is the run-function mode (reference ``horovod.run.run()``,
``run/runner.py:719``): pickle ``fn``, launch it on every rank through
the launcher, collect the ranks' return values in rank order.  The
function and its results travel over the job's KV store (reference
``run/runner.py:631-657`` returns results through its rendezvous server
the same way), so no rank needs a shared filesystem; a KV store that
fails to build raises.  ``cloudpickle`` pickles the function when it is
installed, ``pickle`` otherwise.
"""

from __future__ import annotations

import base64
import os
import pickle
import sys

from horovod_tpu_torch.run.launcher import launch, main  # noqa: F401

# KV key namespace for run-func payloads (distinct from the controller's
# negotiation keys, which are epoch/round-prefixed)
FN_KEY = "runfunc/fn"
RESULT_KEY = "runfunc/result/{rank}"


def run(fn, args=(), kwargs=None, np: int = 1, hosts=None,
        env=None, verbose=False, use_gloo=None, use_mpi=None):
    """Execute ``fn(*args, **kwargs)`` on ``np`` ranks; returns the list
    of per-rank return values (rank order).  ``use_gloo``/``use_mpi``
    are accepted for reference-API compatibility and ignored."""
    try:
        import cloudpickle as pickler  # type: ignore
    except ImportError:
        pickler = pickle
    import secrets as _secrets

    from horovod_tpu_torch.runtime.kvstore import (KVStoreClient,
                                                   KVStoreServer,
                                                   decode_secret)

    env = dict(os.environ if env is None else env)
    job_secret = env.get("HOROVOD_SECRET_KEY") or _secrets.token_hex(32)
    env["HOROVOD_SECRET_KEY"] = job_secret
    server = KVStoreServer(secret=decode_secret(job_secret))
    client = None
    try:
        client = KVStoreClient("127.0.0.1", server.port,
                               secret=decode_secret(job_secret))
        payload = pickler.dumps((fn, tuple(args), dict(kwargs or {})))
        client.set(FN_KEY, base64.b64encode(payload).decode())
        cmd = [sys.executable, "-m", "horovod_tpu_torch.run.exec_fn"]
        rc = launch(np, cmd, hosts=hosts, env=env, verbose=verbose,
                    kv_server=server)
        if rc != 0:
            raise RuntimeError(f"hvdrun function job failed (rc={rc})")
        results = []
        for r in range(np):
            blob = client.try_get(RESULT_KEY.format(rank=r))
            if blob is None:
                raise RuntimeError(f"rank {r} produced no result")
            results.append(pickle.loads(base64.b64decode(blob)))
        return results
    finally:
        if client is not None:
            client.close()
        server.stop()
