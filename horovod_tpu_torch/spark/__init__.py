"""Spark integration (counterpart of ``horovod_tpu/spark/``): the parity
surface of ``horovod.spark`` (reference ``spark/runner.py:115-220``: run
a training function as Spark tasks; Keras/Torch estimators over a
Store).

The reference's driver launches ``num_proc`` Spark tasks, each task
registers with a driver service, tasks are grouped by host into ranks,
and every task then runs the pickled training function as one Horovod
rank (``spark/runner.py:115-220``, the rank environment at
``spark/gloo_run.py``).  Here the same shape rides Spark *barrier
execution*: one barrier stage of ``num_proc`` tasks, each task one rank.
The rank topology (local, cross) comes from the barrier tasks'
addresses, and rank 0 advertises the address of the world's
``torch.distributed`` store to the others with
``BarrierTaskContext.allGather``, in place of the reference's
driver/task RPC and NIC probing.  Every task exports the environment
:func:`horovod_tpu_torch.init` reads (``HOROVOD_RANK``/``SIZE``/
``LOCAL_*``/``CROSS_*``, ``HOROVOD_IS_HOMOGENEOUS``,
``HOROVOD_COORDINATOR_ADDR``).

pyspark is an optional dependency, so the module is import-gated:
without pyspark a clear ImportError points at the Spark-free
equivalents (:func:`horovod_tpu_torch.run.run` and
:mod:`horovod_tpu_torch.estimator`).
"""

from __future__ import annotations

import os


def _require_pyspark():
    try:
        import pyspark  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.spark requires pyspark, which is not "
            "installed. For launcher-based distributed runs use "
            "horovod_tpu_torch.run.run(fn, np=N); for the Estimator/Store "
            "workflow use horovod_tpu_torch.estimator "
            "(JaxEstimator/TorchEstimator), which provides the same "
            "fit()/checkpoint/store shape without Spark.") from e


def _slot_env(rank: int, addresses: list[str]) -> dict:
    """The rank topology's environment from the barrier stage's task
    addresses.  A pure function, testable without Spark.  It mirrors the
    reference's host-hash grouping (``spark/runner.py:187-201`` ->
    ``gloo_run.py:54-112``): tasks on one host form a local group; one
    group per host forms the cross dimension."""
    hosts = [a.rsplit(":", 1)[0] if ":" in a else a for a in addresses]
    size = len(hosts)
    my_host = hosts[rank]
    local_peers = [r for r, h in enumerate(hosts) if h == my_host]
    uniq_hosts = list(dict.fromkeys(hosts))
    return {
        "HOROVOD_RANK": str(rank),
        "HOROVOD_SIZE": str(size),
        "HOROVOD_LOCAL_RANK": str(local_peers.index(rank)),
        "HOROVOD_LOCAL_SIZE": str(len(local_peers)),
        "HOROVOD_CROSS_RANK": str(uniq_hosts.index(my_host)),
        "HOROVOD_CROSS_SIZE": str(len(uniq_hosts)),
        # a global answer, as the launcher gives: one rank's local view
        # cannot see unequal rank counts per host
        "HOROVOD_IS_HOMOGENEOUS":
            "1" if len({hosts.count(h) for h in uniq_hosts}) == 1
            else "0",
    }


def _barrier_task(fn, args, kwargs, extra_env=None):
    """The body of one Spark barrier task, which is one Horovod rank."""

    def task(_iterator):
        from pyspark import BarrierTaskContext

        ctx = BarrierTaskContext.get()
        rank = ctx.partitionId()
        infos = ctx.getTaskInfos()
        addresses = [i.address for i in infos]

        # A reused Spark python worker keeps the previous run's
        # initialized world: init() would return at once with run 1's
        # rank while the results are keyed by this run's partitionId
        # (silent misattribution, or a hang waiting on a dead store).
        from horovod_tpu_torch.common import basics as _basics

        if _basics.is_initialized():
            raise RuntimeError(
                "this Spark python worker already ran a "
                "horovod_tpu_torch rank in an earlier "
                "horovod_tpu_torch.spark.run of the same SparkContext "
                "(spark.python.worker.reuse=true). Set "
                "spark.python.worker.reuse=false, or restart the "
                "SparkContext between runs.")

        env = dict(extra_env or {})
        env.update(_slot_env(rank, addresses))
        # rank 0 picks a free port on its own host for the world's store
        # and shares the address with everyone (in place of the
        # reference's driver-service NIC negotiation)
        import socket

        if rank == 0:
            s = socket.socket()
            s.bind(("0.0.0.0", 0))
            port = s.getsockname()[1]
            s.close()
            host = addresses[0].rsplit(":", 1)[0] or socket.gethostname()
            coord = f"{host}:{port}"
        else:
            coord = ""
        coord = [c for c in ctx.allGather(coord) if c][0]
        env["HOROVOD_COORDINATOR_ADDR"] = coord
        os.environ.update(env)

        result = fn(*args, **kwargs)
        yield (rank, result)

    return task


def run(fn, args=(), kwargs=None, num_proc=None, env=None,
        verbose=0, use_gloo=None, use_mpi=None, **kw):
    """Run ``fn`` as ``num_proc`` Spark barrier tasks, one Horovod rank
    per task (reference ``horovod.spark.run``, ``spark/runner.py:115``),
    and return the ranks' results in rank order.  ``env`` is merged into
    every task's environment; ``use_gloo``/``use_mpi`` are accepted for
    the reference's signature and ignored (the backend follows the
    device: NCCL on the card, gloo on the CPU); unknown options raise
    rather than being dropped."""
    if kw:
        raise TypeError(
            f"horovod_tpu_torch.spark.run got unsupported options "
            f"{sorted(kw)}; supported: args, kwargs, num_proc, env, "
            "verbose, use_gloo, use_mpi.")
    _require_pyspark()
    from pyspark import SparkContext

    sc = SparkContext._active_spark_context
    if sc is None:
        raise RuntimeError("No active SparkContext; start one first.")
    num_proc = num_proc or sc.defaultParallelism
    kwargs = dict(kwargs or {})

    rdd = sc.parallelize(range(num_proc), num_proc)
    try:
        barrier = rdd.barrier()
    except Exception as exc:
        # a user who asked for a Spark job must not get a single-host
        # run without knowing
        raise RuntimeError(
            "Spark barrier execution is unavailable on this cluster "
            f"({exc!r}); horovod_tpu_torch.spark.run requires it to fan "
            "ranks out as tasks. Use horovod_tpu_torch.run.run(fn, np=N) "
            "for a launcher-based (non-Spark) run instead.") from exc
    pairs = barrier.mapPartitions(
        _barrier_task(fn, tuple(args), kwargs,
                      extra_env=dict(env or {}))).collect()
    return [r for _, r in sorted(pairs)]
