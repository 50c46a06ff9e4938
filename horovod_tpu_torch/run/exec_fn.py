"""Per-rank entry of the run-function mode (the copy of
``horovod_tpu/run/exec_fn.py``): load the function from the job's KV
store, ``init()``, run it, and send the return value back to the
launcher over the same store, base64-coded over its string wire
(reference ``run/runner.py:631-657``)."""

from __future__ import annotations

import base64
import os
import pickle
import sys

FN_KEY = "runfunc/fn"
RESULT_KEY = "runfunc/result/{rank}"


def _load(raw: bytes):
    """Unpickle the function.  The launcher pickles it with cloudpickle
    when it has it; a host without cloudpickle gets a clear diagnosis
    (a missing user module is raised as it is)."""
    try:
        return pickle.loads(raw)
    except Exception as e:
        if isinstance(e, ModuleNotFoundError) \
                and "cloudpickle" not in str(e):
            raise
        try:
            import cloudpickle  # noqa: F401
            has_cloudpickle = True
        except ImportError:
            has_cloudpickle = False
        if not has_cloudpickle or "cloudpickle" in str(e):
            raise RuntimeError(
                "cloudpickle required on every host for run-func mode: "
                "the launcher serialized the function with cloudpickle "
                f"and this host ({os.uname().nodename}) could not "
                f"deserialize it ({type(e).__name__}: {e}). Install "
                "'cloudpickle' on every host in the job.") from e
        raise


def main() -> int:
    from horovod_tpu_torch.common import config
    from horovod_tpu_torch.runtime.kvstore import KVStoreClient

    kv = KVStoreClient(config.get("rendezvous_addr"),
                       int(config.get("rendezvous_port")))
    try:
        fn, args, kwargs = _load(base64.b64decode(
            kv.get_blocking(FN_KEY, timeout_s=60.0)))
        import horovod_tpu_torch as hvd

        hvd.init()
        rank = hvd.rank()
        try:
            result = fn(*args, **kwargs)
        finally:
            hvd.shutdown()
        kv.set(RESULT_KEY.format(rank=rank),
               base64.b64encode(pickle.dumps(result)).decode())
    finally:
        kv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
