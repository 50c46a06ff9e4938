"""Checkpoint / resume helpers (counterpart of
``horovod_tpu/checkpoint.py``, with its on-disk layout file for file).

Horovod's convention is rank-0-only saving plus ``broadcast_parameters``
/ ``broadcast_optimizer_state`` / ``broadcast_object`` to restore and
resynchronize.  This module packages it as a host-side pickle snapshot
store:

* :func:`save` -- rank-0-gated save of a tree (dicts, lists, tuples) of
  tensors and Python values; ``all_ranks=True`` has every rank write its
  own shard-local state (ZeRO) under ``rank_<r>/`` with a
  ``shard_meta.json`` (world size, dp size, ZeRO stage), ring-buddy
  replicas under ``HOROVOD_CHECKPOINT_REPLICAS`` and one step-level
  ``DONE`` marker;
* :func:`restore` -- load on every rank (or rank 0, then :func:`resync`);
  tensors come back as CPU ``torch.Tensor``s, for ``load_state_dict`` or
  ``copy_``;
* :func:`resync` -- broadcast a restored tree from rank 0 so every rank
  resumes bit-identical, shard-local subtrees left alone;
* :func:`latest_step` / :func:`latest_complete` -- resume discovery;
* :func:`latest_healthy` / ``restore(healthy_only=True)`` -- rollback
  discovery over the last-K ring (``HOROVOD_CHECKPOINT_KEEP``), reading
  the health verdict stamped in each ``DONE`` marker.

A step dir is staged under a ``.tmp`` name and moved into place with
``os.replace``; an overwritten step is renamed aside as ``.old`` first
and removed only after the swap.  Every save stamps ``MANIFEST.json``
(per-file SHA-256 and size) inside the staged dir, and restore and
discovery verify it (``HOROVOD_CHECKPOINT_VERIFY``): a corrupt snapshot
is quarantined as ``step_<N>.corrupt``.

Leaves are pickled as numpy arrays, so a directory written by either
package reads in the other.  A bfloat16 tensor is stored as a tagged
uint16 view (``{"__hvd_dtype__": "bfloat16", "bits": uint16 array}``):
``ml_dtypes``, which the JAX package pickles bfloat16 arrays with, is
not a dependency of the port.  The port reads such an array back when
``ml_dtypes`` is installed; the JAX package sees the tagged dict.  The
two-way parity holds for float32 and integer leaves.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pickle
import time

import numpy as np
import torch

from horovod_tpu_torch.common import basics as _basics
from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common import logging as _log
from horovod_tpu_torch.common.types import HorovodTpuError

_FILE = "tree.pkl"
_SHARD_META = "shard_meta.json"
_DONE = "DONE"  # atomic completeness marker; see latest_complete()
_MANIFEST = "MANIFEST.json"  # per-file integrity stamps; see verify_snapshot()


@contextlib.contextmanager
def _goodput_span():
    """Attribute save/restore wall to the goodput ledger's
    ``checkpoint`` phase (docs/goodput.md).  Advisory — a ledger
    failure must never cost a checkpoint."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        try:
            from horovod_tpu_torch.perf import goodput as _goodput

            _goodput.observe("checkpoint", time.perf_counter() - t0)
        except Exception:
            pass


def _world() -> tuple[int, int]:
    """(rank, size) — 0/1 before init so rank-0 tooling can still read
    checkpoints."""
    st = _basics.state()
    return (st.rank, st.size) if st.initialized else (0, 1)


def _dp_size() -> int:
    """dp-scoped shard count stamped into ``shard_meta.json``: the
    named mesh's dp extent when one is configured (shard layouts follow
    it, docs/mesh.md), else the flat world size.  Restore validates
    against the SAME resolution, so a mesh job refuses a flat-world
    snapshot of a different shard count and vice versa."""
    from horovod_tpu_torch.parallel import mesh as _pmesh

    dp = _pmesh.data_parallel_size()
    if dp is not None:
        return int(dp)
    return _world()[1]


def _zero_stage() -> int:
    """Knob-resolved ZeRO stage (the restore side's expectation; the
    save side stamps from tree CONTENT, see :func:`_tree_zero_stage` —
    a stage-3 snapshot's tree holds shard-resident ``Zero3Params``, a
    lower stage's holds full parameter replicas, and restoring one as
    the other silently corrupts the run)."""
    from horovod_tpu_torch.optim.distributed import _resolve_zero_stage

    return int(_resolve_zero_stage(None, None))


def _tree_zero_stage(tree) -> int:
    """Stage stamped into ``shard_meta.json``, from tree CONTENT: 3
    whenever the tree actually holds shard-resident params (robust for
    jobs that pass ``zero_stage=`` as an explicit optimizer argument
    with the env knob unset), else the knob-resolved stage capped at 2
    — a zp-free tree (e.g. sharded optimizer state committed alone by
    a stage-3 job) is layout-identical across stages 1-3 and must stay
    restorable by any of them."""
    from horovod_tpu_torch.optim.distributed import (HostZero3Params,
                                                     Zero3Params)

    if any(isinstance(x, (Zero3Params, HostZero3Params))
           for x in _nodes(tree)):
        return 3
    return min(_zero_stage(), 2)


def save(path: str, tree, step: int, *, all_ranks: bool = False,
         verdict: str | None = None) -> str:
    """Save ``tree`` under ``path/step_<N>``.  Only rank 0 writes unless
    ``all_ranks`` (per-rank sharded state, e.g. the ZeRO-1 sharded
    optimizer's shard-local moments) — the reference's rank-0
    convention (``README.rst:197-244``).  ``all_ranks`` snapshots stamp
    a ``shard_meta.json`` sidecar with (rank, world_size) so
    :func:`restore` can refuse a world-size change instead of silently
    handing rank ``r`` a shard that belongs to a different layout.

    ``verdict`` (``"healthy"`` / ``"poisoned"``) is the health plane's
    judgment of the training state at save time, stamped into the DONE
    marker; :func:`latest_healthy` is the rollback primitive that reads
    it back (docs/autopilot.md).  ``None`` stamps nothing — and an
    absent verdict counts as healthy on the read side, so pre-ring
    snapshots stay eligible."""
    with _goodput_span():
        return _save(path, tree, step, all_ranks=all_ranks,
                     verdict=verdict)


def _save(path: str, tree, step: int, *, all_ranks: bool = False,
          verdict: str | None = None) -> str:
    rank, size = _world()
    if not all_ranks:
        # A rank-0-only snapshot of shard-resident (Zero3Params) state
        # would silently persist only rank 0's 1/world segment — every
        # later restore hands all ranks the wrong 7/8ths of the model.
        from horovod_tpu_torch.optim.distributed import Zero3Params

        if any(isinstance(x, Zero3Params) or getattr(x, "_hvd_zero3", False)
               for x in _nodes(tree)):
            raise HorovodTpuError(
                "checkpoint.save(all_ranks=False) on zero_stage=3 "
                "shard-resident params (Zero3Params): rank 0 holds "
                "only its 1/world segment, so a single-writer "
                "snapshot cannot capture the model. Use "
                "save(..., all_ranks=True) (each rank writes its "
                "shard) or snapshot the world-independent full tree "
                "via params_to_host first (docs/zero.md).")
    suffix = (f"step_{step}" if not all_ranks
              else os.path.join(f"step_{step}", f"rank_{rank}"))
    target = os.path.join(os.path.abspath(path), suffix)
    if not all_ranks and rank != 0:
        return target
    host = _to_host(tree)
    if all_ranks:
        # Overwriting a previously-complete step: the old step-level
        # DONE marker must fall BEFORE any rank replaces its shard dir,
        # or a crash mid-overwrite would leave mixed-generation shards
        # that latest_complete still vouches for.  Every rank attempts
        # the unlink (idempotent); the post-barrier stamp below
        # re-marks the step only once every new shard has landed.
        try:
            os.remove(os.path.join(os.path.abspath(path),
                                   f"step_{step}", _DONE))
        except OSError:
            pass
    tmp = target + f".tmp.{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, _FILE), "wb") as f:
        pickle.dump(host, f, protocol=pickle.HIGHEST_PROTOCOL)
    if all_ranks:
        with open(os.path.join(tmp, _SHARD_META), "w") as f:
            json.dump({"rank": rank, "world_size": size,
                       "dp_size": _dp_size(),
                       "zero_stage": _tree_zero_stage(tree)}, f)
    else:
        # Single-writer snapshot: the dir rename below is atomic, so
        # the DONE marker can ride inside it — present iff the whole
        # snapshot is.  (all_ranks snapshots get their marker from the
        # post-barrier stamp at the bottom: each rank dir landing
        # independently is exactly the torn state DONE exists to veto.)
        done = {"step": step, "world_size": size}
        if verdict is not None:
            done["verdict"] = verdict
        with open(os.path.join(tmp, _DONE), "w") as f:
            json.dump(done, f)
    # Integrity manifest, stamped INSIDE the staging dir so it rides
    # the atomic rename with the data it vouches for: per-file SHA-256
    # + size of every data file.  DONE is excluded — mark_complete may
    # legitimately re-stamp it (verdicts, external writers) after the
    # manifest is sealed.
    _write_manifest(tmp, step)
    olds = []
    for _ in range(8):  # bounded: racing recoverers can re-adopt at most
        # Rename aside instead of rmtree-before-replace: a crash
        # between the two renames leaves the previous data intact under
        # the .old name; an rmtree-first window would destroy it.
        # Uniquified so a stale .old from an earlier failed cleanup
        # can't make the rename raise ENOTEMPTY forever after; looped
        # because a concurrent latest_step() may adopt the .old dir
        # back to the step name between our two renames.
        if os.path.isdir(target):
            old = target + f".old.{os.getpid()}.{len(olds)}"
            while os.path.exists(old):
                old += "x"
            os.replace(target, old)
            olds.append(old)
        try:
            os.replace(tmp, target)
            break
        except OSError:
            continue
    else:
        raise OSError(f"could not move checkpoint into place at {target} "
                      "(concurrent recoverers kept re-adopting the old "
                      "step dir)")
    import shutil

    for old in olds:
        shutil.rmtree(old, ignore_errors=True)
    if all_ranks:
        # Ring-buddy shard replication (HOROVOD_CHECKPOINT_REPLICAS)
        # BEFORE the completeness stamp: a step vouched for by DONE
        # must already hold its replicas, or the durability guarantee
        # would have a window exactly when it matters (host loss
        # mid-save).
        _replicate_shards(os.path.abspath(path), step, target, rank,
                          size)
        # The step is complete only once EVERY rank's shard landed:
        # barrier, then rank 0 stamps the step-level DONE marker.  A
        # crash before the stamp leaves the step discoverable by
        # latest_step (debugging) but invisible to latest_complete
        # (restart discovery) — torn snapshots never get resumed.
        if _basics.state().initialized and size > 1:
            from horovod_tpu_torch.ops import eager as _eager

            _eager.barrier()
        if rank == 0:
            mark_complete(path, step, verdict=verdict)
    if rank == 0:
        _prune_ring(os.path.abspath(path), step)
    return target


def mark_complete(path: str, step: int,
                  verdict: str | None = None) -> str:
    """Atomically stamp ``path/step_<N>`` as complete (``DONE`` marker
    written via tmp-file + rename).  :func:`save` calls this itself;
    exposed for external writers (e.g. orbax flows) that want their
    snapshots visible to the launcher's restart discovery.  ``verdict``
    records the health judgment at save time (see :func:`save`)."""
    rank, size = _world()
    step_dir = os.path.join(os.path.abspath(path), f"step_{step}")
    marker = os.path.join(step_dir, _DONE)
    tmp = marker + f".tmp.{os.getpid()}"
    done = {"step": step, "world_size": size, "rank": rank}
    if verdict is not None:
        done["verdict"] = verdict
    with open(tmp, "w") as f:
        json.dump(done, f)
    os.replace(tmp, marker)
    return marker


# ---------------------------------------------------------------------------
# Integrity manifests, quarantine, ring-buddy replication
# (docs/checkpoint.md — the durability half of the preemption plane)
# ---------------------------------------------------------------------------


def _verify_enabled() -> bool:
    try:
        return bool(_config.get("checkpoint_verify"))
    except Exception:
        return True


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_manifest(dirpath: str, step: int) -> None:
    """Stamp ``MANIFEST.json`` (per-file SHA-256 + size) over the data
    files in ``dirpath``.  DONE is excluded (re-stampable, see _save);
    the manifest cannot hash itself."""
    files = {}
    for name in sorted(os.listdir(dirpath)):
        if name in (_DONE, _MANIFEST):
            continue
        p = os.path.join(dirpath, name)
        if os.path.isfile(p):
            files[name] = {"sha256": _sha256(p),
                           "size": os.path.getsize(p)}
    with open(os.path.join(dirpath, _MANIFEST), "w") as f:
        json.dump({"step": int(step), "files": files}, f, sort_keys=True)


def _verify_dir(dirpath: str) -> list[str] | None:
    """Check ``dirpath`` against its manifest.  ``None`` = no manifest
    (a pre-manifest snapshot — the caller decides whether that warns or
    fails); ``[]`` = verified; else the list of problems."""
    manifest = os.path.join(dirpath, _MANIFEST)
    if not os.path.exists(manifest):
        return None
    try:
        with open(manifest) as f:
            man = json.load(f)
    except (OSError, ValueError) as exc:
        return [f"{_MANIFEST}: unreadable ({exc})"]
    problems = []
    for name, rec in sorted((man.get("files") or {}).items()):
        p = os.path.join(dirpath, name)
        if not os.path.isfile(p):
            problems.append(f"{name}: missing")
            continue
        size = os.path.getsize(p)
        if int(rec.get("size", -1)) != size:
            problems.append(
                f"{name}: size {size} != recorded {rec.get('size')}")
            continue
        if _sha256(p) != rec.get("sha256"):
            problems.append(f"{name}: sha256 mismatch")
    return problems


def verify_snapshot(path: str, step: int) -> bool:
    """Integrity-check ``step_<N>`` against its ``MANIFEST.json``
    stamps (the step dir itself plus every ``rank_<r>`` shard and
    ``rep_<o>_<h>`` replica).  Corruption logs loudly and returns
    False.  A snapshot with NO manifests anywhere (saved before
    manifest stamping existed) warns and passes — pre-manifest
    backward compatibility; see docs/checkpoint.md."""
    step_dir = os.path.join(os.path.abspath(path), f"step_{step}")
    if not os.path.isdir(step_dir):
        return False
    dirs = [step_dir]
    for d in sorted(os.listdir(step_dir)):
        full = os.path.join(step_dir, d)
        if os.path.isdir(full) and (d.startswith("rank_")
                                    or d.startswith("rep_")) \
                and ".corrupt" not in d and ".tmp." not in d \
                and ".old." not in d:
            dirs.append(full)
    results = {d: _verify_dir(d) for d in dirs}
    bad = {d: p for d, p in results.items() if p}
    if bad:
        for d, p in bad.items():
            _log.error(
                f"checkpoint: integrity verification FAILED for {d}: "
                f"{'; '.join(p[:4])}")
        return False
    if all(p is None for p in results.values()):
        _log.warning(
            f"checkpoint: step_{step} under {path} predates integrity "
            "manifests; accepting unverified (pre-manifest compat, "
            "docs/checkpoint.md)")
    return True


def _quarantine(path: str, step: int, why: str) -> None:
    """Set a corrupt snapshot aside as ``step_<N>.corrupt`` — the name
    fails every discovery filter, so it can never be restored, while
    the bytes stay on disk for the postmortem.  Loud by design."""
    step_dir = os.path.join(os.path.abspath(path), f"step_{step}")
    dst = step_dir + ".corrupt"
    while os.path.exists(dst):
        dst += "x"
    try:
        os.replace(step_dir, dst)
    except OSError:
        return
    _log.error(
        f"checkpoint: QUARANTINED corrupt snapshot step_{step} -> "
        f"{os.path.basename(dst)} ({why}); falling back to the next "
        "complete snapshot")
    try:
        from horovod_tpu_torch.runtime import flight as _flight

        _flight.record("checkpoint", event="quarantine", step=int(step),
                       why=why)
    except Exception:
        pass
    try:
        from horovod_tpu_torch.runtime import metrics as _metrics

        _metrics.counter(
            "hvd_checkpoint_corrupt_total",
            "Snapshots quarantined after failing manifest "
            "verification (docs/checkpoint.md).").inc()
    except Exception:
        pass


def _replicate_shards(path: str, step: int, shard_dir: str, rank: int,
                      size: int) -> None:
    """Ring-buddy replication of ``all_ranks`` shard dirs
    (``HOROVOD_CHECKPOINT_REPLICAS`` total copies, default 2): every
    rank broadcasts its landed shard's file payloads in turn, and the
    R-1 ring buddies (``(owner + k) % size``) write verbatim copies
    under ``step_<N>/rep_<owner>_<holder>/`` — on a per-host storage
    layout the buddy's host now holds the shard, so one host loss
    never takes the only copy of ZeRO shard-local state with it.
    Restore prefers the local ``rank_<r>`` dir and falls back to any
    verified replica.  Cost: one broadcast_object per owner per save
    (O(world) collectives); set the knob to 0/1 to disable."""
    try:
        replicas = int(_config.get("checkpoint_replicas"))
    except (TypeError, ValueError):
        replicas = 0
    if replicas <= 1 or size <= 1 or not _basics.state().initialized:
        return
    from horovod_tpu_torch.optim.distributed import broadcast_object

    replicas = min(replicas, size)
    payload = {}
    for name in sorted(os.listdir(shard_dir)):
        p = os.path.join(shard_dir, name)
        if os.path.isfile(p):
            with open(p, "rb") as f:
                payload[name] = f.read()
    step_dir = os.path.join(path, f"step_{step}")
    import shutil

    for owner in range(size):
        blob = broadcast_object(payload if rank == owner else None,
                                root_rank=owner)
        holders = {(owner + k) % size for k in range(1, replicas)}
        if rank not in holders or rank == owner or not blob:
            continue
        rep = os.path.join(step_dir, f"rep_{owner}_{rank}")
        tmp = rep + f".tmp.{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        for name, data in blob.items():
            with open(os.path.join(tmp, name), "wb") as f:
                f.write(data)
        if os.path.isdir(rep):
            shutil.rmtree(rep, ignore_errors=True)
        os.replace(tmp, rep)


def _find_replica(step_dir: str, rank: int, verify: bool) -> str | None:
    """Newest-holder verified replica dir for ``rank``'s shard, or
    None."""
    try:
        entries = sorted(os.listdir(step_dir))
    except OSError:
        return None
    for d in entries:
        parts = d.split("_")
        if len(parts) != 3 or parts[0] != "rep" \
                or parts[1] != str(rank) or not parts[2].isdigit():
            continue
        full = os.path.join(step_dir, d)
        if not os.path.isdir(full):
            continue
        if verify and _verify_dir(full):
            _log.error(
                f"checkpoint: replica {full} failed verification; "
                "trying the next holder")
            continue
        return full
    return None


def _resolve_shard_source(path: str, step: int, step_dir: str,
                          rank: int) -> str:
    """Shard dir an ``all_ranks`` restore should read for ``rank``:
    the local ``rank_<r>`` copy when it verifies, else any verified
    ring-buddy replica (loudly — a replica restore means a host lost
    its tree).  A corrupt local shard is set aside first so nothing
    can silently restore it later."""
    primary = os.path.join(step_dir, f"rank_{rank}")
    verify = _verify_enabled()
    if os.path.isdir(primary):
        problems = _verify_dir(primary) if verify else []
        if problems is None:
            _log.warning(
                f"checkpoint: shard {primary} predates integrity "
                "manifests; restoring unverified (pre-manifest compat)")
            return primary
        if not problems:
            return primary
        aside = primary + ".corrupt"
        while os.path.exists(aside):
            aside += "x"
        try:
            os.replace(primary, aside)
        except OSError:
            pass
        _log.error(
            f"checkpoint: QUARANTINED corrupt shard rank_{rank} of "
            f"step_{step} ({'; '.join(problems[:4])}); falling back "
            "to a ring-buddy replica")
        try:
            from horovod_tpu_torch.runtime import flight as _flight

            _flight.record("checkpoint", event="shard_quarantine",
                           step=int(step), rank=int(rank),
                           why="; ".join(problems[:4]))
        except Exception:
            pass
        try:
            from horovod_tpu_torch.runtime import metrics as _metrics

            _metrics.counter(
                "hvd_checkpoint_corrupt_total",
                "Snapshots quarantined after failing manifest "
                "verification (docs/checkpoint.md).").inc()
        except Exception:
            pass
    rep = _find_replica(step_dir, rank, verify)
    if rep is None:
        raise HorovodTpuError(
            f"sharded checkpoint step_{step} under {path}: rank "
            f"{rank}'s shard is missing or corrupt and no verified "
            "ring-buddy replica exists (HOROVOD_CHECKPOINT_REPLICAS "
            "was <= 1 at save time, or every holder is gone too). "
            "The elastic re-shard path — restoring the full host-form "
            "snapshot at the new world size — is the remaining "
            "fallback; see docs/checkpoint.md.")
    _log.warning(
        f"checkpoint: restoring rank {rank}'s shard of step_{step} "
        f"from ring-buddy replica {os.path.basename(rep)} — the local "
        "copy was missing or corrupt (docs/checkpoint.md)")
    try:
        from horovod_tpu_torch.runtime import flight as _flight

        _flight.record("checkpoint", event="replica_restore",
                       step=int(step), rank=int(rank),
                       replica=os.path.basename(rep))
    except Exception:
        pass
    try:
        from horovod_tpu_torch.runtime import metrics as _metrics

        _metrics.counter(
            "hvd_checkpoint_replica_restores_total",
            "Shard restores served from a ring-buddy replica instead "
            "of the owner's copy (docs/checkpoint.md).").inc()
    except Exception:
        pass
    return rep


def _complete_steps(path: str) -> list[int]:
    """All complete (DONE-marked) steps under ``path``, sorted."""
    if not os.path.isdir(path):
        return []
    return sorted(
        int(d.split("_", 1)[1]) for d in os.listdir(path)
        if d.startswith("step_") and d.split("_", 1)[1].isdigit()
        and os.path.exists(os.path.join(path, d, _DONE)))


def _prune_ring(path: str, current_step: int) -> None:
    """Last-K retention (``HOROVOD_CHECKPOINT_KEEP``): after a save,
    drop complete steps beyond the newest K — but never the step just
    written, and never incomplete dirs (a torn ``all_ranks`` save mid-
    flight on another rank is not ours to delete).  Advisory: a prune
    failure must never fail the save that triggered it."""
    try:
        keep = int(_config.get("checkpoint_keep"))
    except (TypeError, ValueError):
        keep = 0
    depth = len(_complete_steps(path))
    if keep > 0:
        import shutil

        steps = _complete_steps(path)
        for s in steps[:-keep] if len(steps) > keep else []:
            if s == current_step:
                continue
            shutil.rmtree(os.path.join(path, f"step_{s}"),
                          ignore_errors=True)
        depth = len(_complete_steps(path))
    try:
        from horovod_tpu_torch.runtime import metrics as _metrics

        _metrics.gauge(
            "hvd_checkpoint_ring_depth",
            "Complete snapshots currently retained in the checkpoint "
            "ring (docs/autopilot.md)").set(depth)
    except Exception:
        pass


def verdict_of(path: str, step: int) -> str | None:
    """Health verdict stamped in ``step``'s DONE marker, or None when
    the snapshot is incomplete or predates verdict stamping."""
    marker = os.path.join(os.path.abspath(path), f"step_{step}", _DONE)
    try:
        with open(marker) as f:
            return json.load(f).get("verdict")
    except (OSError, ValueError):
        return None


def latest_healthy(path: str) -> int | None:
    """Newest complete step whose verdict is not ``"poisoned"`` — the
    rollback target.  Snapshots without a verdict (pre-ring, or saved
    with the health plane off) count as healthy.  Under
    ``HOROVOD_CHECKPOINT_VERIFY`` (default on) candidates are also
    integrity-checked; corrupt ones are quarantined and skipped."""
    if not os.path.isdir(path):
        return None
    _recover_orphans(os.path.abspath(path))
    for s in reversed(_complete_steps(os.path.abspath(path))):
        if verdict_of(path, s) == "poisoned":
            continue
        if _verify_enabled() and not verify_snapshot(path, s):
            _quarantine(path, s, "manifest verification failed")
            continue
        return s
    return None


def is_complete(path: str, step: int) -> bool:
    return os.path.exists(os.path.join(
        os.path.abspath(path), f"step_{step}", _DONE))


def latest_complete(path: str) -> int | None:
    """Latest step whose snapshot finished completely — the restart
    discovery the launcher uses (``HOROVOD_RESTART_ATTEMPTS``).  Unlike
    :func:`latest_step`, torn snapshots (an ``all_ranks`` save some
    rank never finished, a crash before the DONE stamp) are skipped, so
    a resume can never load a half-written state.

    Under ``HOROVOD_CHECKPOINT_VERIFY`` (default on) the candidate is
    also integrity-checked against its ``MANIFEST.json``: a bit-rotted
    snapshot is quarantined (``step_<N>.corrupt``) and the next
    complete one is returned instead — DONE vetoes torn writes, the
    manifest vetoes rotted ones.  Pre-manifest snapshots (no
    ``MANIFEST.json``) still pass, with a warning, so an old
    checkpoint dir keeps resuming."""
    if not os.path.isdir(path):
        return None
    _recover_orphans(os.path.abspath(path))
    while True:
        steps = _complete_steps(os.path.abspath(path))
        if not steps:
            return None
        s = steps[-1]
        if not _verify_enabled() or verify_snapshot(path, s):
            return s
        _quarantine(path, s, "manifest verification failed")


def restore(path: str, step: int | None = None, *,
            all_ranks: bool = False, healthy_only: bool = False):
    """Load the pytree saved at ``path`` (``step=None`` → latest).

    ``all_ranks`` restores this rank's own shard and validates the
    snapshot's ``shard_meta.json``: restoring shard-local state onto a
    different world size is layout corruption (rank ``r``'s moments
    would pair with a differently-sized parameter shard), so a changed
    shard count fails with a clear error — re-shard offline or restart
    at the recorded world size.

    ``healthy_only`` with ``step=None`` targets the newest snapshot
    whose stamped health verdict is not ``"poisoned"``
    (:func:`latest_healthy`) — the rollback primitive, usable even
    with the autopilot off."""
    with _goodput_span():
        return _restore(path, step, all_ranks=all_ranks,
                        healthy_only=healthy_only)


class _CorruptSnapshot(Exception):
    """Internal: the snapshot failed verification and was quarantined;
    discovery-driven restores retry the next one."""


def _restore(path: str, step: int | None = None, *,
             all_ranks: bool = False, healthy_only: bool = False):
    explicit = step is not None
    if explicit:
        _recover_orphans(os.path.abspath(path))
    while True:
        s = step
        if s is None:
            # latest_healthy verifies + quarantines itself; latest_step
            # deliberately does not (it sees torn steps for debugging),
            # so _restore_step's own verification covers that path.
            s = latest_healthy(path) if healthy_only \
                else latest_step(path)
            if s is None:
                raise FileNotFoundError(
                    f"no {'healthy ' if healthy_only else ''}"
                    f"checkpoints under {path}")
        try:
            return _restore_step(path, s, all_ranks=all_ranks)
        except _CorruptSnapshot as exc:
            if explicit:
                raise HorovodTpuError(
                    f"checkpoint step_{s} under {path} failed "
                    f"integrity verification ({exc}) and was "
                    "quarantined as step_"
                    f"{s}.corrupt. Restore another step, or set "
                    "HOROVOD_CHECKPOINT_VERIFY=0 to load unverified "
                    "bytes at your own risk.") from None
            # discovered step: it is quarantined now, re-discover


def _restore_step(path: str, step: int, *, all_ranks: bool = False):
    rank, size = _world()
    suffix = (f"step_{step}" if not all_ranks
              else os.path.join(f"step_{step}", f"rank_{rank}"))
    target = os.path.join(os.path.abspath(path), suffix)
    if not all_ranks and _verify_enabled():
        problems = _verify_dir(target)
        if problems is None:
            _log.warning(
                f"checkpoint: step_{step} under {path} predates "
                "integrity manifests; restoring unverified "
                "(pre-manifest compat, docs/checkpoint.md)")
        elif problems:
            why = "; ".join(problems[:4])
            _quarantine(path, step, why)
            raise _CorruptSnapshot(why)
    if all_ranks:
        # Verified source resolution: the local shard when it checks
        # out, else a ring-buddy replica — BEFORE the topology
        # validation below, which must read the meta we will actually
        # load.
        target = _resolve_shard_source(
            path, step, os.path.dirname(target), rank)
    if all_ranks and _basics.state().initialized:
        # Only a live job has a real topology to validate against;
        # pre-init tooling (offline inspection / re-sharding — the
        # consumer the mismatch error points at) reads rank_0's shard
        # without tripping the placeholder (0, 1) world.
        step_dir = os.path.dirname(target)
        saved_ranks = [d for d in (os.listdir(step_dir)
                                   if os.path.isdir(step_dir) else [])
                       if d.startswith("rank_")
                       and d.split("_", 1)[1].isdigit()]
        meta_path = os.path.join(target, _SHARD_META)
        meta = None
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        saved_world = (int(meta["world_size"]) if meta
                       else len(saved_ranks) or None)
        if saved_world is not None and saved_world != size:
            raise HorovodTpuError(
                f"sharded checkpoint at {step_dir} was saved from "
                f"world size {saved_world} but this job runs "
                f"{size} ranks; restoring would silently corrupt "
                "shard-local state (each rank holds 1/world of the "
                "fused buffers). Restart at the recorded world size "
                "or re-shard the snapshot offline.")
        saved_dp = int(meta["dp_size"]) if meta and "dp_size" in meta \
            else saved_world  # pre-mesh snapshots: shards spanned the world
        if saved_dp is not None and saved_dp != _dp_size():
            raise HorovodTpuError(
                f"sharded checkpoint at {step_dir} was saved with "
                f"{saved_dp} data-parallel shards but this job's "
                f"shard count is {_dp_size()} (ZeRO layouts follow "
                "the dp extent of the named mesh, docs/mesh.md); "
                "restoring would misassign shard-local state. Match "
                "the recorded dp extent or re-shard the snapshot "
                "offline.")
        if meta is not None and int(meta["rank"]) != rank:
            raise HorovodTpuError(
                f"sharded checkpoint dir {target} records rank "
                f"{meta['rank']} but rank {rank} is restoring it; "
                "the per-rank layout would be misassigned.")
        saved_stage = int(meta.get("zero_stage", 0)) if meta else 0
        # One-directional stage-3 residency guard: a snapshot stamped
        # >= 3 genuinely CONTAINS Zero3Params (content-based stamp),
        # so a job explicitly configured below stage 3 must not load
        # it; the reverse (a stage-3 job loading a zp-free snapshot)
        # is layout-compatible and allowed.  Checked only when this
        # job's intent is explicit (HOROVOD_ZERO_STAGE set): a job
        # configured purely via the zero_stage= optimizer argument
        # leaves the knob empty, and refusing its own correctly
        # stamped snapshot would be a false positive.
        env_explicit = _config.is_set("zero_stage")
        if env_explicit and saved_stage >= 3 and _zero_stage() < 3:
            raise HorovodTpuError(
                f"sharded checkpoint at {step_dir} was saved under "
                f"zero_stage={saved_stage} (it holds shard-resident "
                f"Zero3Params) but this job resolves "
                f"zero_stage={_zero_stage()}, which expects full "
                "parameter replicas — restoring across that boundary "
                "corrupts the run. Set HOROVOD_ZERO_STAGE=3 to match "
                "the snapshot (zp-free snapshots from stages 1 and 2 "
                "interchange freely at any stage).")
    with open(os.path.join(target, _FILE), "rb") as f:
        return _from_host(pickle.load(f))


def _recover_orphans(path: str) -> None:
    """Adopt ``step_N.old.*`` dirs whose ``step_N`` is missing: a crash
    between save()'s two renames leaves the previous checkpoint only
    under the aside name — it must stay discoverable for resume."""
    try:
        entries = os.listdir(path)
    except OSError:
        return
    present = {d for d in entries
               if d.startswith("step_") and d.split("_", 1)[1].isdigit()}
    orphans: dict[str, list[str]] = {}
    for d in entries:
        stem = d.split(".old.", 1)[0]
        if ".old." in d and stem.startswith("step_") \
                and stem.split("_", 1)[1].isdigit() and stem not in present:
            orphans.setdefault(stem, []).append(d)
    for stem, cands in orphans.items():
        try:  # racing recoverers: first replace wins, ENOENT is fine
            os.replace(os.path.join(path, sorted(cands)[-1]),
                       os.path.join(path, stem))
        except OSError:
            pass


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    _recover_orphans(path)
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(path)
             if d.startswith("step_") and d.split("_", 1)[1].isdigit()]
    return max(steps) if steps else None


def resync(tree, root_rank: int = 0):
    """Broadcast ``tree`` from ``root_rank`` so every rank resumes from
    identical state -- the restore-then-broadcast idiom.  Tensors are
    broadcast fused per dtype on this rank's device (a CPU tensor of a
    CUDA job goes there and back) and every other leaf by one object
    broadcast; a ``ShardedState`` (a DistributedOptimizer's stage-1/2
    shard state), ``Zero3Params`` and the host forms pass through
    untouched: each rank's shard is authoritative (it came from its own
    ``all_ranks`` snapshot), and a broadcast would overwrite every
    rank's moments with rank 0's segment.  Returns the new tree."""
    from horovod_tpu_torch.ops import collectives as _coll
    from horovod_tpu_torch.optim.distributed import (_refuse_model_parallel,
                                                     broadcast_object)

    st = _basics.state()
    if not st.initialized or st.size == 1:
        return tree
    _refuse_model_parallel()
    local = _shard_local_types()
    tensors, others = [], []

    def collect(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x)
        elif not isinstance(x, local):
            others.append(x)
        return x

    _map(collect, tree, leaves=local)
    dev = _basics.device()
    moved = [t.detach().to(dev, copy=True) for t in tensors]
    _coll.broadcast_(moved, root_rank)
    root_others = broadcast_object(others, root_rank)
    it_t, it_o = iter(zip(tensors, moved)), iter(root_others)

    def put(x):
        if isinstance(x, torch.Tensor):
            t, m = next(it_t)
            return m.to(t.device)
        return x if isinstance(x, local) else next(it_o)

    return _map(put, tree, leaves=local)


# ---------------------------------------------------------------------------
# Host conversion: tensors <-> numpy, bfloat16 as tagged bits
# ---------------------------------------------------------------------------

_BF16_TAG = "__hvd_dtype__"


def _shard_local_types() -> tuple:
    """The values :func:`resync` passes through (shard-local or
    world-independent host forms)."""
    from horovod_tpu_torch.optim import distributed as _dist

    return (_dist.ShardedState, _dist.Zero3Params, _dist.HostShardedState,
            _dist.HostZero3Params)


def _map(fn, tree, leaves=()):
    """``fn`` over the leaves of a tree of dicts, lists and tuples
    (NamedTuples keep their type); instances of ``leaves`` are leaves
    too, whatever they hold."""
    if leaves and isinstance(tree, leaves):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _map(fn, v, leaves))
                          for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, leaves) for v in tree)
    return fn(tree)


def _nodes(tree):
    """Every node of a tree (containers included; a ``Zero3Params`` and
    a host form are leaves)."""
    yield tree
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _nodes(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _nodes(v)


def to_numpy(t: torch.Tensor):
    """A tensor as what a snapshot holds: a numpy array on the host, a
    bfloat16 tensor as the tagged dict of its bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return {_BF16_TAG: "bfloat16",
                "bits": t.view(torch.int16).numpy().view(np.uint16)}
    return t.numpy()


def from_numpy(a):
    """The inverse of :func:`to_numpy`: a CPU tensor (a numpy bfloat16
    array of ``ml_dtypes`` too), or ``a`` unchanged when torch has no
    such dtype."""
    if isinstance(a, dict) and a.get(_BF16_TAG) == "bfloat16":
        bits = np.ascontiguousarray(a["bits"]).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    try:
        return torch.from_numpy(np.array(a, copy=True))
    except TypeError:  # a dtype torch does not have
        return a


def _to_host(tree):
    """Tensors -> host numpy (:func:`to_numpy`); a ``Zero3Params`` keeps
    its type with host shards and a ShardedState its type with host
    state; everything else passes through unchanged."""
    from horovod_tpu_torch.optim import distributed as _dist

    def one(x):
        if isinstance(x, torch.Tensor):
            return to_numpy(x)
        if isinstance(x, _dist.Zero3Params):
            return _dist.Zero3Params([to_numpy(s) for s in x.shards],
                                     x.layout, x.names, x.shapes,
                                     x.axis_name
                                     if isinstance(x.axis_name, str)
                                     else None)
        if isinstance(x, _dist.ShardedState):
            return _dist.ShardedState(_to_host(x.inner),
                                      _to_host(x.residual), x.layout)
        return x

    return _map(one, tree, leaves=(_dist.Zero3Params, _dist.ShardedState))


def _from_host(tree):
    """Host numpy leaves (and tagged bfloat16 dicts) -> CPU tensors; a
    ``Zero3Params``'s shards and a ShardedState's state too."""
    from horovod_tpu_torch.optim import distributed as _dist

    def one(x):
        if isinstance(x, np.ndarray):
            return from_numpy(x)
        if isinstance(x, _dist.Zero3Params):
            return _dist.Zero3Params([from_numpy(s) for s in x.shards],
                                     x.layout, x.names, x.shapes,
                                     x.axis_name)
        if isinstance(x, _dist.ShardedState):
            return _dist.ShardedState(_from_host(x.inner),
                                      _from_host(x.residual), x.layout)
        return x

    def walk(t):
        if isinstance(t, dict) and t.get(_BF16_TAG) == "bfloat16":
            return from_numpy(t)
        if isinstance(t, (_dist.Zero3Params, _dist.ShardedState)):
            return one(t)
        if isinstance(t, dict):
            return type(t)((k, walk(v)) for k, v in t.items())
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return one(t)

    return walk(tree)
