"""Pod environment discovery (the copy of
``horovod_tpu/run/pod.py``) — the analog of the reference's cluster
integrations (``run/util/lsf.py`` LSF introspection,
``run/js_run.py`` jsrun): when a process starts under a TPU pod
orchestrator (GCE TPU VM workers, GKE megascale), rank/size/coordinator
come from the pod metadata environment instead of launcher-exported
``HOROVOD_*`` vars or hostfiles.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

# the coordinator port of the pod convention (the JAX package's cluster
# auto-detect uses it too), so mixed launches agree
_COORD_PORT = 8476


@dataclass
class PodInfo:
    rank: int
    size: int
    coordinator: str      # host:port of rank 0 ("" when auto)
    source: str           # which metadata convention matched
    auto: bool = False    # multislice: needs a cluster resolver


def detect(env=None) -> PodInfo | None:
    """Return pod topology if this process runs inside a TPU pod
    orchestrator, else None.  Checked conventions, most specific first:

    * GKE megascale (multislice): ``MEGASCALE_*`` present — topology is
      multi-dimensional (slice × host), so detection returns
      ``auto=True``: the JAX package hands off to its cluster resolution,
      which ``torch.distributed`` does not have, so this package's
      ``init()`` raises.  Checked FIRST: multislice
      workers also carry slice-local ``TPU_WORKER_*`` vars, which would
      otherwise split the job into per-slice worlds.
    * GCE TPU VM workers: ``TPU_WORKER_ID`` + ``TPU_WORKER_HOSTNAMES``
      (comma-separated, index = worker id).
    * Generic cloud: ``CLOUD_TPU_TASK_ID`` + ``TPU_PROCESS_ADDRESSES``.
    """
    env = os.environ if env is None else env
    if ("MEGASCALE_COORDINATOR_ADDRESS" in env
            and "MEGASCALE_NUM_SLICES" in env):
        return PodInfo(-1, -1, "", "megascale", auto=True)
    # Malformed metadata (empty/non-numeric ids) means "not a pod", not
    # a crash: callers fall back to single-process init.
    if "TPU_WORKER_ID" in env and "TPU_WORKER_HOSTNAMES" in env:
        try:
            hosts = [h.strip()
                     for h in env["TPU_WORKER_HOSTNAMES"].split(",")
                     if h.strip()]
            rank = int(env["TPU_WORKER_ID"])
            if hosts and 0 <= rank < len(hosts):
                return PodInfo(rank, len(hosts),
                               f"{hosts[0]}:{_COORD_PORT}", "tpu_worker")
        except ValueError:
            pass
    if "CLOUD_TPU_TASK_ID" in env and "TPU_PROCESS_ADDRESSES" in env:
        try:
            addrs = [a.strip()
                     for a in env["TPU_PROCESS_ADDRESSES"].split(",")
                     if a.strip()]
            rank = int(env["CLOUD_TPU_TASK_ID"])
            if addrs and 0 <= rank < len(addrs):
                coord = addrs[0]
                if ":" not in coord:
                    coord = f"{coord}:{_COORD_PORT}"
                return PodInfo(rank, len(addrs), coord, "cloud_tpu")
        except ValueError:
            pass
    return None
