"""``hvdrun`` — the launcher (``python -m horovod_tpu_torch.run``; the
copy of ``horovod_tpu/run/launcher.py`` in this package).

Parity with ``horovodrun`` (reference ``horovod/run/runner.py:221-453``
CLI; ``run/gloo_run.py`` process model): allocate
rank/local_rank/cross_rank from a ``host:slots`` spec
(``gloo_run.py:54-112``), start the rendezvous KV server, export the
``HOROVOD_*`` env per rank (``gloo_run.py:152-163``), spawn ranks
(localhost: subprocess; remote hosts: ssh, as the reference does at
``gloo_run.py:189-234``), capture per-rank output
(``--output-filename`` → ``dir/rank.N/stdout|stderr``, reference
``gloo_run.py:204-217``), and kill the job when any rank fails
(``gloo_run.py:294-304``).  ``horovod_tpu_torch.run.run(fn)`` is the
run-function mode (reference ``run/runner.py:719``).

No NIC-probe/driver-service fan-out: rank 0's ``torch.distributed``
TCP store (``HOROVOD_COORDINATOR_ADDR``) and the launcher's own native
KV server (``HOROVOD_GLOO_RENDEZVOUS_ADDR/PORT``, started for every job)
replace it.  A KV server that fails to build raises.  The perf
observatory's knobs (``--profile-every-n-steps``, ``--profile-dir``,
``--profile-keep``, ``--peak-flops-per-chip``, ``--jax-profiler-dir``)
reach the ranks through the environment, as every knob's flag does.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading
from dataclasses import dataclass

from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common import logging as _log


def _start_metrics_aggregator(base_env: dict, kv, local_only: bool,
                              kv_addr: str, job_secret: str):
    """Fleet-wide ``/metrics`` (docs/metrics.md): when the operator set
    ``HOROVOD_METRICS_PORT``, the launcher serves the aggregate on that
    port — merging every rank's KV-published snapshot with ``rank`` /
    ``host`` labels, following the rank-0 index across elastic
    generations — and exports ``base + 1`` to ranks so per-rank
    endpoints (base+1+rank) never collide with the aggregate on a
    shared host.  Returns (server, kv_client) or None."""
    try:
        port = int(base_env.get("HOROVOD_METRICS_PORT") or 0)
    except ValueError:
        port = 0
    if port <= 0:
        return None
    base_env["HOROVOD_METRICS_PORT"] = str(port + 1)
    from horovod_tpu_torch.runtime import metrics as _metrics
    from horovod_tpu_torch.runtime.kvstore import KVStoreClient, decode_secret

    try:
        kvc = KVStoreClient("127.0.0.1" if local_only else kv_addr,
                            kv.port, connect_timeout_s=10.0,
                            secret=decode_secret(job_secret))
    except Exception as exc:
        print(f"[hvdrun] metrics aggregation disabled: {exc}",
              file=sys.stderr)
        return None
    host = socket.gethostname()
    # Fleet goodput plane (docs/goodput.md): merged per-rank wall-clock
    # ledgers -> fleet goodput ratio, sliding-window dominant-bottleneck
    # naming, and the SLO burn-rate alert gauges, all riding the same
    # aggregate /metrics page.
    try:
        from horovod_tpu_torch.perf import goodput as _goodput

        fleet = _goodput.FleetGoodput()
    except Exception:
        fleet = None

    def render() -> str:
        mine = {"meta": {"rank": "launcher", "host": host},
                "metrics": _metrics.registry().snapshot()}
        return _metrics.aggregate_render(kvc.try_get, [mine],
                                         fleet=fleet)

    try:
        srv = _metrics.MetricsHTTPServer(render, port)
    except OSError as exc:
        print(f"[hvdrun] metrics aggregation disabled: port {port}: "
              f"{exc}", file=sys.stderr)
        kvc.close()
        return None
    print(f"[hvdrun] fleet metrics: http://{host}:{port}/metrics "
          f"(per-rank endpoints at {port + 1}+rank)", file=sys.stderr)
    return srv, kvc, fleet


def _stop_metrics_aggregator(agg) -> None:
    if agg is None:
        return
    srv, kvc, fleet = agg
    srv.close()
    try:
        kvc.close()
    except Exception:
        pass
    # Wrap-up evidence line (docs/goodput.md): the last fleet goodput
    # report the aggregate computed — one number plus one named culprit
    # for the operator scrolling the launcher log.
    try:
        if fleet is not None and fleet.last:
            from horovod_tpu_torch.perf import goodput as _goodput

            print("[hvdrun] " + _goodput.evidence_line(
                fleet.last, window_s=fleet.window_s), file=sys.stderr)
    except Exception:
        pass


def _sweep_flight_dir(base_env: dict, context: str) -> list[str]:
    """Flight-recorder sweep (docs/flight-recorder.md): when the job
    ran with ``--flight-dir``, report which per-rank dumps landed there
    — at wrap-up and after observed re-forms — and print the one-liner
    that merges them into a fleet trace.  Purely informational: the
    dumps are the ranks' own atomic writes; the launcher just makes
    sure nobody has to remember where the black boxes fell."""
    d = base_env.get("HOROVOD_FLIGHT_DIR") or ""
    if not d:
        return []
    from horovod_tpu_torch.runtime import flight as _flight

    dumps = _flight.sweep(d)
    if dumps:
        print(f"[hvdrun] flight recorder ({context}): "
              f"{len(dumps)} dump(s) under {d}: "
              + ", ".join(os.path.basename(p) for p in dumps),
              file=sys.stderr)
        print(f"[hvdrun] merge + analyze with: python -m "
              f"horovod_tpu_torch.trace merge {d}", file=sys.stderr)
    return dumps


def _sweep_health_dir(base_env: dict) -> None:
    """Training-health sweep (docs/health.md): when ranks dumped
    health snapshots (``HOROVOD_HEALTH_DIR``, falling back to the
    flight dir), surface any nonfinite culprits / active alerts at
    wrap-up and print the report one-liner.  Informational only, like
    the flight sweep above — the fleet ``/metrics`` merge carried the
    live gauges; this is the after-the-fact pointer."""
    d = base_env.get("HOROVOD_HEALTH_DIR") \
        or base_env.get("HOROVOD_FLIGHT_DIR") or ""
    if not d or not os.path.isdir(d):
        return
    try:
        from horovod_tpu_torch.runtime import health as _health

        rep = _health.load_report(d)
    except Exception:
        return
    if not rep.get("ranks"):
        return
    culprits = rep.get("culprits") or []
    if culprits:
        who = ", ".join(f"rank {c['rank']}/{c['group']} "
                        f"({c['count']:g})" for c in culprits[:8])
        print(f"[hvdrun] training health: NONFINITE gradients observed "
              f"pre-reduction — culprit(s): {who}", file=sys.stderr)
    alerts = sorted({a for s in rep["ranks"]
                     for a in (s.get("active_alerts") or [])})
    if alerts:
        print(f"[hvdrun] training health: active alert(s) at exit: "
              f"{', '.join(alerts)}", file=sys.stderr)
    if culprits or alerts:
        print(f"[hvdrun] health report: python -m horovod_tpu_torch.perf "
              f"health {d}", file=sys.stderr)


#: Why the autopilot's actuators never shed rank 0's process
_RANK0_HELD = ("its process holds the default group's store, so its "
               "death would end the job")


def _shed_label(rank, live_label) -> str:
    """The live process ``slo_burn_shrink`` sheds for the evidence's
    bottleneck ``rank``, where ``live_label`` maps a rank of the current
    generation to its live process's label (``None`` when it has none).
    Raises, and the verdict is ``failed:*``, when the evidence names no
    rank, the rank has no live process, or it is rank 0's."""
    if rank is None:
        raise LookupError("the evidence names no bottleneck rank")
    label = live_label(rank)
    if label is None:
        raise LookupError(f"no live process at rank {rank}")
    if label == live_label(0):
        raise RuntimeError(f"the bottleneck is rank 0: {_RANK0_HELD}")
    return label


@dataclass
class SlotInfo:
    """Rank allocation record (reference ``gloo_run.py:54-112``)."""
    hostname: str
    rank: int
    local_rank: int
    cross_rank: int
    size: int
    local_size: int
    cross_size: int
    homogeneous: bool = True


def parse_host_spec(spec: str | None, np_: int) -> list[tuple[str, int]]:
    """``host1:4,host2:4`` -> [(host, slots)]; default localhost:np."""
    if not spec:
        return [("localhost", np_)]
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            host, slots = part.rsplit(":", 1)
            out.append((host, int(slots)))
        else:
            out.append((part, 1))
    return out


def parse_hostfile(path: str) -> list[tuple[str, int]]:
    """Reference hostfile format: ``hostname slots=N`` per line
    (``runner.py:518-545``)."""
    hosts = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            slots = 1
            for p in parts[1:]:
                if p.startswith("slots="):
                    slots = int(p.split("=", 1)[1])
            hosts.append((parts[0], slots))
    return hosts


def allocate(hosts: list[tuple[str, int]], np_: int) -> list[SlotInfo]:
    """Round-robin-free block allocation identical in spirit to the
    reference ``_allocate``: fill each host's slots in order."""
    slots: list[SlotInfo] = []
    host_names = [h for h, _ in hosts]
    rank = 0
    for host, nslots in hosts:
        for local in range(nslots):
            if rank >= np_:
                break
            slots.append(SlotInfo(host, rank, local,
                                  host_names.index(host), np_, 0, 0))
            rank += 1
    if rank < np_:
        raise ValueError(
            f"not enough slots ({rank}) for -np {np_}; add hosts/slots")
    per_host: dict[str, int] = {}
    for s in slots:
        per_host[s.hostname] = per_host.get(s.hostname, 0) + 1
    used_hosts = [h for h in host_names if per_host.get(h)]
    homogeneous = len(set(per_host.values())) == 1
    for s in slots:
        s.local_size = per_host[s.hostname]
        s.cross_size = len(used_hosts)
        s.cross_rank = used_hosts.index(s.hostname)
        s.homogeneous = homogeneous
    return slots


# libc handle resolved at import time: preexec_fn runs between fork and
# exec while the parent may hold allocator/import locks in other threads
# (the KV server is live by spawn time) — importing ctypes there can
# deadlock the child.  Prewarm prctl with a harmless PR_GET_PDEATHSIG so
# the first post-fork call does no FFI setup.
_LIBC = None
if sys.platform.startswith("linux"):
    try:
        import ctypes as _ctypes

        _LIBC = _ctypes.CDLL(None, use_errno=True)
        _LIBC.prctl(2, _ctypes.byref(_ctypes.c_int()), 0, 0, 0)
    except Exception:
        _LIBC = None


def _rank_preexec():
    """Run in each rank child between fork and exec.

    Reference ``run/common/util/safe_shell_exec.py:1-120`` runs every
    child in its own process group and kills the whole group on
    termination, so a rank's forked helpers die with it.  Additionally,
    ``PR_SET_PDEATHSIG`` makes the kernel SIGKILL the rank if the
    launcher itself dies abnormally (SIGKILL) — the reference gets the
    same effect from its in-process middleman watching the parent.

    SIGKILL, not SIGTERM: libraries in the rank (PJRT plugins, coord
    services) register Python-level SIGTERM handlers, and a rank whose
    main thread is parked in a C++ futex (a dead peer's barrier, a
    wedged tunnel) never runs them — observed as multi-hour 2 GB
    orphans surviving a launcher kill -9.  PDEATHSIG fires only when
    the launcher is already gone, so there is nobody left to escalate
    TERM → KILL; every launcher-alive path still sends SIGTERM first
    (graceful drain) before the KILL deadline.
    """
    os.setpgid(0, 0)
    if _LIBC is not None:
        try:
            PR_SET_PDEATHSIG = 1
            _LIBC.prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)
        except Exception:
            pass  # group-kill paths below still apply


def _group_has_members(pgid: int) -> bool:
    """True if any live process sits in process group ``pgid`` within
    this launcher's session.

    Guards the dead-leader killpg: once a rank has been ``wait()``ed its
    PID is free for reuse, and an unrelated new group could claim the
    same pgid.  Ranks never ``setsid``, so their helpers stay in our
    session — a same-pgid group in a different session is a stranger.
    """
    try:
        my_sid = os.getsid(0)
        entries = os.listdir("/proc")
    except OSError:
        return False  # no /proc: skip dead-leader group kills
    for d in entries:
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat", "rb") as f:
                st = f.read()
        except OSError:
            continue
        # fields after the parenthesised comm (may contain spaces):
        # state ppid pgrp session ...
        rest = st[st.rfind(b")") + 2:].split()
        try:
            if int(rest[2]) == pgid and int(rest[3]) == my_sid:
                return True
        except (IndexError, ValueError):
            continue
    return False


def _pid_is_live(pid: int) -> bool:
    """True if a live (or zombie) process currently holds ``pid``."""
    try:
        return os.path.exists(f"/proc/{pid}")
    except OSError:
        return False


def _proc_starttime(pid: int) -> str | None:
    """Kernel start-tick of ``pid`` (``/proc/<pid>/stat`` field 22) —
    the cheap process-identity stamp: a recycled pid necessarily has a
    different starttime.  None when unreadable (gone, or no /proc)."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            st = f.read()
        rest = st[st.rfind(b")") + 2:].split()
        return rest[19].decode()
    except (OSError, IndexError, ValueError):
        return None


def _stamp_identity(proc) -> None:
    """Record the group leader's /proc starttime at spawn so later
    signals can verify the pid still names OUR rank (ADVICE round 4: a
    recycled pid claimed by a new same-session group must not be
    killpg'd by the final cleanup loop)."""
    pid = getattr(proc, "pid", None)
    if pid:
        try:
            proc._hvd_starttime = _proc_starttime(pid)
        except AttributeError:
            pass  # minimal fake process without settable attributes


def _signal_rank(proc: subprocess.Popen, sig: int) -> None:
    """Signal a rank's whole process group, falling back to the PID.

    Pid-reuse guards, in order of strength: (1) the leader's /proc
    starttime recorded at spawn — a live holder of the pid whose
    starttime differs recycled the number, so nothing about that pid
    is ours and the signal is skipped entirely; (2) while the rank is
    un-reaped its zombie pins the PID, so the pgid is unambiguously
    ours; (3) once reaped with no identity stamp to compare, a live
    holder is conservatively treated as a stranger, and a leaderless
    group is killed only when its members sit in this launcher's
    session (``_group_has_members``).

    ``getattr`` guards let tests substitute minimal fake processes."""
    pid = getattr(proc, "pid", None)
    if pid:
        reaped = getattr(proc, "returncode", None) is not None
        if _pid_is_live(pid):
            recorded = getattr(proc, "_hvd_starttime", None)
            current = _proc_starttime(pid)
            if recorded is not None and current is not None \
                    and current != recorded:
                return  # pid recycled by a stranger: not our group
            if reaped and (recorded is None or current is None):
                return  # reaped + unverifiable identity: assume stranger
        if not reaped or _group_has_members(pid):
            try:
                os.killpg(pid, sig)
                return
            except OSError:
                pass
        elif reaped:
            return  # leader reaped, group empty: nothing to signal
    sender = getattr(proc, "send_signal", None)
    if sender is None:
        return
    try:
        sender(sig)
    except OSError:
        pass


class HostUnreachableError(RuntimeError):
    """A remote host failed the pre-spawn reachability check."""


# one lock per console stream: every rank's pump writes a whole line
# under it, so two ranks' long lines never interleave (a write of a line
# longer than the stream's buffer goes out in pieces)
_STREAM_LOCKS: dict = {}
_STREAM_LOCKS_GUARD = threading.Lock()


def _stream_lock(dst) -> threading.Lock:
    with _STREAM_LOCKS_GUARD:
        return _STREAM_LOCKS.setdefault(id(dst), threading.Lock())


def _forward_stream(src, dst, rank: int, tag: str,
                    timestamp: bool = False) -> threading.Thread:
    """Pump one rank's pipe to the console, line-buffered, each line
    prefixed ``[rank]<stdout|stderr>:`` (reference
    ``safe_shell_exec.py:61-94``; timestamps with
    ``--prefix-output-with-timestamp``), whole lines at a time."""
    import time as _time

    lock = _stream_lock(dst)

    def pump():
        for line in iter(src.readline, b""):
            ctx = (_time.strftime("%a %b %d %H:%M:%S %Y ")
                   if timestamp else "")
            with lock:
                dst.write(f"{ctx}[{rank}]<{tag}>:"
                          f"{line.decode(errors='replace')}")
                dst.flush()
        try:
            src.close()
        except OSError:
            pass

    t = threading.Thread(target=pump, daemon=True,
                         name=f"hvd-out-{rank}-{tag}")
    t.start()
    return t


def preflight_hosts(host_list: list[tuple[str, int]], start_timeout: float,
                    this_host: str | None = None) -> None:
    """Probe every remote host over ssh in parallel before spawning the
    world (reference ``run/runner.py:61-112``: threaded reachability
    check honoring ``--start-timeout``).  An unreachable host fails the
    job in seconds with its name, instead of hanging until the KV
    negotiation timeout."""
    this_host = this_host or socket.gethostname()
    remote = sorted({h for h, _ in host_list
                     if h not in ("localhost", this_host, "127.0.0.1")})
    if not remote:
        return
    errors: dict[str, str] = {}

    def check(h: str) -> None:
        connect_t = max(1, min(int(start_timeout), 30))
        try:
            rc = subprocess.run(
                ["ssh", "-o", "BatchMode=yes",
                 "-o", "StrictHostKeyChecking=no",
                 "-o", f"ConnectTimeout={connect_t}", h, "true"],
                capture_output=True, timeout=start_timeout)
            if rc.returncode != 0:
                detail = rc.stderr.decode(errors="replace").strip()
                errors[h] = detail.splitlines()[-1] if detail else \
                    f"ssh exited {rc.returncode}"
        except subprocess.TimeoutExpired:
            errors[h] = f"no ssh response within {start_timeout:.0f}s"
        except OSError as exc:
            errors[h] = str(exc)

    threads = [threading.Thread(target=check, args=(h,), daemon=True)
               for h in remote]
    for t in threads:
        t.start()
    import time as _time

    deadline = _time.monotonic() + start_timeout + 5
    for t in threads:
        t.join(timeout=max(0.1, deadline - _time.monotonic()))
    for h, t in zip(remote, threads):
        if t.is_alive():
            errors.setdefault(h, f"probe still running after "
                                 f"{start_timeout:.0f}s")
    if errors:
        detail = "; ".join(f"{h}: {msg}" for h, msg in sorted(errors.items()))
        raise HostUnreachableError(
            f"host(s) unreachable before start-timeout "
            f"({start_timeout:.0f}s): {detail}")


def _free_port() -> int:
    from horovod_tpu_torch.common.util import free_port

    return free_port()


def _coordinator(coord_host: str, local_only: bool, held: list) -> str:
    """``host:port`` for rank 0's ``torch.distributed`` store.  On one
    host the port is held (``util.reserve_port``) until the attempt
    ends, so nothing else takes it before rank 0 binds it."""
    if local_only:
        from horovod_tpu_torch.common.util import reserve_port

        sock, port = reserve_port()
        held.append(sock)
        return f"{coord_host}:{port}"
    return f"{coord_host}:{_free_port()}"


def _release(held: list) -> None:
    for sock in held:
        try:
            sock.close()
        except OSError:
            pass
    held.clear()


def _package_root() -> str:
    import horovod_tpu_torch as _pkg

    return os.path.dirname(os.path.dirname(os.path.abspath(
        _pkg.__file__)))


def _base_env(env, job_secret: str, extra_env: dict) -> dict:
    """The env every rank of an attempt inherits: the job secret, the
    package root on ``PYTHONPATH`` (ranks import the package even when
    it is not installed and the command is ``python script.py``), and
    this attempt's restart metadata."""
    base_env = dict(os.environ if env is None else env)
    base_env["HOROVOD_SECRET_KEY"] = job_secret
    pkg_root = _package_root()
    existing = base_env.get("PYTHONPATH", "")
    if pkg_root not in existing.split(os.pathsep):
        base_env["PYTHONPATH"] = (pkg_root + os.pathsep + existing
                                  if existing else pkg_root)
    for stale in ("HOROVOD_RESTART_ATTEMPT", "HOROVOD_RESUME_STEP"):
        base_env.pop(stale, None)
    base_env.update(extra_env)
    return base_env


def check_build() -> str:
    """``hvdrun --check-build`` report (reference ``runner.py:115-150``):
    what this installation provides -- torch and its CUDA, ``nvcc``,
    NCCL, gloo, and whether the native KV store builds."""
    import shutil

    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd

    def mark(v):
        return "X" if v else " "

    cuda = torch.version.cuda
    nvcc = shutil.which("nvcc") or (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"))
    nvcc_ok = os.path.exists(nvcc)
    try:
        from horovod_tpu_torch.runtime import kvstore as _kv

        kv_lib = _kv.library_path()
        kv_ok = True
    except Exception as exc:  # noqa: BLE001 -- reported, not raised
        kv_lib = f"does not build: {exc}"
        kv_ok = False
    return f"""\
horovod_tpu_torch v{hvd.__version__}:

Available Frontends:
    [X] PyTorch {torch.__version__}

Available Controllers:
    [X] torch.distributed TCP store
    [{mark(kv_ok)}] Native KV store (C++): {kv_lib}

Available Tensor Operations:
    [{mark(dist.is_nccl_available())}] NCCL
    [{mark(dist.is_gloo_available())}] gloo
    [{mark(cuda)}] CUDA {cuda or 'none'} (cards visible: \
{torch.cuda.device_count()})
    [{mark(nvcc_ok)}] nvcc {nvcc if nvcc_ok else 'not found'}"""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hvdrun",
        description="Launch a horovod_tpu_torch job "
                    "(horovodrun-compatible).")
    p.add_argument("-np", "--num-proc", type=int, required=False,
                   dest="np")
    p.add_argument("-cb", "--check-build", action="store_true",
                   help="show which frontends/transports are available "
                        "and exit (reference horovodrun --check-build)")
    p.add_argument("-H", "--hosts", default=None,
                   help="host1:slots,host2:slots (default localhost)")
    p.add_argument("--hostfile", default=None)
    p.add_argument("--output-filename", default=None,
                   help="per-rank output dir (rank.N/stdout|stderr)")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--config-file", default=None)
    p.add_argument("--gloo", action="store_true",
                   help="accepted for horovodrun compatibility (gloo "
                        "on the CPU, NCCL on the card)")
    p.add_argument("--mpi", action="store_true",
                   help="accepted for compatibility; ignored")
    p.add_argument("--start-timeout", type=int, default=120)
    p.add_argument("--preempt", default=None, metavar="RANK[:GRACE]",
                   help="actuator mode: address a graceful preemption "
                        "notice to RANK of an already-running elastic "
                        "job (rendezvous via HOROVOD_GLOO_RENDEZVOUS_"
                        "ADDR/PORT + HOROVOD_SECRET_KEY) and exit; an "
                        "optional :GRACE overrides the grace window in "
                        "seconds, e.g. --preempt 1:45")
    p.add_argument("--prefix-output-with-timestamp", action="store_true",
                   help="prepend a timestamp to each forwarded rank "
                        "output line (reference runner.py flag)")
    # knob flags (reference runner.py:279-415 subset)
    for knob in _config.knobs().values():
        if knob.cli:
            if isinstance(knob.default, bool):
                # --flag / --no-flag so default-true knobs are disablable
                p.add_argument(knob.cli,
                               action=argparse.BooleanOptionalAction,
                               default=None, help=knob.help)
            else:
                p.add_argument(knob.cli, default=None, help=knob.help)
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="training command")
    return p


def _rank_env(slot: SlotInfo, coord_addr: str, kv_addr: str, kv_port: int,
              base_env: dict) -> dict:
    env = dict(base_env)
    env.update({
        "HOROVOD_RANK": str(slot.rank),
        "HOROVOD_SIZE": str(slot.size),
        "HOROVOD_LOCAL_RANK": str(slot.local_rank),
        "HOROVOD_LOCAL_SIZE": str(slot.local_size),
        "HOROVOD_CROSS_RANK": str(slot.cross_rank),
        "HOROVOD_CROSS_SIZE": str(slot.cross_size),
        "HOROVOD_IS_HOMOGENEOUS": "1" if slot.homogeneous else "0",
        "HOROVOD_COORDINATOR_ADDR": coord_addr,
    })
    if kv_port:
        env["HOROVOD_GLOO_RENDEZVOUS_ADDR"] = kv_addr
        env["HOROVOD_GLOO_RENDEZVOUS_PORT"] = str(kv_port)
    else:
        env.pop("HOROVOD_GLOO_RENDEZVOUS_ADDR", None)
        env.pop("HOROVOD_GLOO_RENDEZVOUS_PORT", None)
    return env


def launch(np_: int, command: list[str], hosts=None, hostfile=None,
           output_filename=None, verbose=False, start_timeout=120,
           env=None, kv_server=None,
           prefix_timestamp: bool = False, restart_attempts=None,
           checkpoint_dir=None) -> int:
    """Launch ``command`` on np_ ranks; returns the job exit code.

    ``kv_server``: a caller-owned :class:`KVStoreServer` to use for the
    rendezvous instead of creating one (the caller keeps it alive after
    the job, e.g. ``run()`` collecting run-func results — reference
    ``run/runner.py:631-657`` returns results through its rendezvous
    server the same way).  The caller must also have put the matching
    ``HOROVOD_SECRET_KEY`` into ``env``.

    Recovery (docs/fault-tolerance.md): when a rank dies the whole job
    is torn down within the shutdown deadline; with
    ``restart_attempts > 0`` (``HOROVOD_RESTART_ATTEMPTS``) the job is
    relaunched — on a fresh rendezvous server, so no stale negotiation
    key survives — with ``HOROVOD_RESTART_ATTEMPT`` exported, plus
    ``HOROVOD_RESUME_STEP`` pointing at the latest *complete* snapshot
    under ``checkpoint_dir`` (``HOROVOD_CHECKPOINT_DIR``; torn
    snapshots are refused via :func:`checkpoint.latest_complete`)."""
    host_list = (parse_hostfile(hostfile) if hostfile
                 else parse_host_spec(hosts, np_))
    slots = allocate(host_list, np_)
    this_host = socket.gethostname()
    preflight_hosts(host_list, start_timeout, this_host)
    local_only = all(h in ("localhost", this_host, "127.0.0.1")
                     for h, _ in host_list)
    # The KV rendezvous server runs here (launcher host); rank 0's
    # torch.distributed store runs inside RANK 0's process, so its
    # advertised address must be rank 0's host — the first host in the
    # spec — not the launcher's.  The port is picked here and assumed
    # free on that host (the reference launcher makes the same bet for
    # its rendezvous ports).
    kv_addr = "127.0.0.1" if local_only else this_host
    rank0_host = host_list[0][0]
    coord_host = ("127.0.0.1" if local_only else
                  (this_host if rank0_host in ("localhost", this_host)
                   else rank0_host))

    attempts = (max(0, _config.get("restart_attempts"))
                if restart_attempts is None
                else max(0, int(restart_attempts)))
    ckpt_dir = (checkpoint_dir if checkpoint_dir is not None
                else (_config.get("checkpoint_dir") or None))
    if kv_server is not None and attempts:
        # A caller-owned rendezvous server cannot be recycled: the dead
        # attempt's negotiation keys would collide with the restarted
        # ranks' epoch-0 keys.
        print("[hvdrun] restart attempts disabled: caller-owned KV "
              "server cannot be recycled across attempts",
              file=sys.stderr)
        attempts = 0

    def _envtruthy(key: str) -> bool:
        raw = (os.environ if env is None else env).get(key, "")
        return _config._parse_bool(str(raw))

    elastic = _envtruthy("HOROVOD_ELASTIC")
    extra_env: dict[str, str] = {}
    rc = 1
    for attempt in range(attempts + 1):
        if elastic:
            # Survivor-continue mode: a dead rank is blacklisted and
            # re-formed around instead of killing the job; a restart
            # attempt only fires when the world shrank below
            # --min-ranks (docs/elastic.md).
            rc = _launch_elastic(command, slots, this_host, local_only,
                                 kv_addr, coord_host, output_filename,
                                 verbose, env, kv_server,
                                 prefix_timestamp, extra_env, host_list)
        else:
            rc = _launch_once(command, slots, this_host, local_only,
                              kv_addr, coord_host, output_filename,
                              verbose, env, kv_server, prefix_timestamp,
                              extra_env)
        if rc == 0:
            return 0
        if attempt >= attempts:
            break
        resume = None
        if ckpt_dir:
            from horovod_tpu_torch import checkpoint as _ckpt

            try:
                resume = _ckpt.latest_complete(ckpt_dir)
            except OSError as exc:
                print(f"[hvdrun] checkpoint discovery under {ckpt_dir} "
                      f"failed: {exc}", file=sys.stderr)
        extra_env = {"HOROVOD_RESTART_ATTEMPT": str(attempt + 1)}
        if resume is not None:
            extra_env["HOROVOD_RESUME_STEP"] = str(resume)
        print(f"[hvdrun] job failed; restart attempt {attempt + 1}/"
              f"{attempts}"
              + (f" resuming from complete checkpoint step {resume}"
                 if resume is not None else
                 (" (no complete checkpoint found under "
                  f"{ckpt_dir})" if ckpt_dir else "")),
              file=sys.stderr)
    return rc


def _spawn_proc(command: list[str], renv: dict, hostname: str,
                rank_label, this_host: str, output_filename,
                prefix_timestamp: bool, pumps: list) -> subprocess.Popen:
    """Spawn one rank process (local subprocess or ssh) with output
    capture wired up; shared by the classic fail-fast path and the
    elastic monitor."""
    if output_filename:
        d = os.path.join(output_filename, f"rank.{rank_label}")
        os.makedirs(d, exist_ok=True)
        stdout = open(os.path.join(d, "stdout"), "w")
        stderr = open(os.path.join(d, "stderr"), "w")
    else:
        # console mode: rank-prefixed line forwarding (reference
        # safe_shell_exec.py:61-94)
        stdout = stderr = subprocess.PIPE

    def attach(proc):
        if output_filename:
            return
        # getattr guards: tests substitute minimal fake processes
        if getattr(proc, "stdout", None) is not None:
            pumps.append(_forward_stream(proc.stdout, sys.stdout,
                                         rank_label, "stdout",
                                         prefix_timestamp))
        if getattr(proc, "stderr", None) is not None:
            pumps.append(_forward_stream(proc.stderr, sys.stderr,
                                         rank_label, "stderr",
                                         prefix_timestamp))

    if hostname in ("localhost", this_host, "127.0.0.1"):
        proc = subprocess.Popen(command, env=renv, stdout=stdout,
                                stderr=stderr, preexec_fn=_rank_preexec)
        _stamp_identity(proc)
        attach(proc)
        return proc
    # remote: ssh with env exported inline (reference gloo_run.py:189)
    # — except the job secret, which must never ride argv (any local
    # user could read it via ps/procfs and defeat the KV auth); it is
    # shipped over ssh stdin instead.
    exports = " ".join(
        f"{k}={subprocess.list2cmdline([v])}"
        for k, v in renv.items()
        if k.startswith(("HOROVOD_", "CUDA_", "NCCL_", "TORCH_", "PYTHON"))
        and k != "HOROVOD_SECRET_KEY")
    import shlex

    remote = ("read -r HOROVOD_SECRET_KEY; export HOROVOD_SECRET_KEY; "
              f"cd {shlex.quote(os.getcwd())} && "
              f"env {exports} {subprocess.list2cmdline(command)}")
    # `sh -c` wrapper: the remote login shell may be csh/fish where
    # `read -r`/`export` are not valid; sh is POSIX everywhere.
    proc = subprocess.Popen(
        ["ssh", "-o", "StrictHostKeyChecking=no", hostname,
         "sh -c " + shlex.quote(remote)],
        stdin=subprocess.PIPE, stdout=stdout, stderr=stderr,
        preexec_fn=_rank_preexec)
    _stamp_identity(proc)
    try:
        proc.stdin.write(
            (renv.get("HOROVOD_SECRET_KEY", "") + "\n").encode())
        proc.stdin.close()
    except (BrokenPipeError, OSError):
        pass  # rank died instantly; the reaper reports it
    attach(proc)
    return proc


def _drain_pumps(pumps: list, deadline_s: float = 30.0) -> None:
    """Join output pumps once every rank is reaped (pipes EOF quickly
    after child exit) with a generous shared deadline; a pump that is
    still draining at exit is abandoned with a warning NAMING the rank
    and stream, so a dropped output tail is never silent."""
    import time as _time

    pump_deadline = _time.monotonic() + deadline_s
    for t in pumps:
        t.join(timeout=max(0.0, pump_deadline - _time.monotonic()))
    abandoned = [t.name for t in pumps if t.is_alive()]
    if abandoned:
        print("[hvdrun] warning: abandoning output pump(s) still "
              f"draining at exit: {', '.join(abandoned)}; trailing "
              "output from those ranks may be lost", file=sys.stderr)


def _job_kv(env, kv_server):
    """The job's KV server (started here unless the caller owns one),
    whether this attempt owns it, and the job secret.  A fresh HMAC
    secret per job (reference ``run/common/util/secret.py:26``) rides the
    ranks' env: a stray TCP client without it cannot touch negotiation
    state.  A server that fails to build or bind raises."""
    import secrets as _secrets

    from horovod_tpu_torch.runtime.kvstore import (KVStoreServer,
                                                   decode_secret)

    if kv_server is not None:
        return kv_server, False, (env or os.environ).get(
            "HOROVOD_SECRET_KEY", "")
    job_secret = os.environ.get("HOROVOD_SECRET_KEY") or \
        _secrets.token_hex(32)
    return KVStoreServer(secret=decode_secret(job_secret)), True, job_secret


def _launch_once(command: list[str], slots: list[SlotInfo], this_host: str,
                 local_only: bool, kv_addr: str, coord_host: str,
                 output_filename, verbose, env, kv_server,
                 prefix_timestamp: bool, extra_env: dict) -> int:
    """One job attempt: fresh rendezvous + coordinator port, spawn every
    rank, fan failures in, tear the world down on the shutdown
    deadline."""
    kv, owns_kv, job_secret = _job_kv(env, kv_server)
    held: list = []
    coord = _coordinator(coord_host, local_only, held)
    kv_port = kv.port
    base_env = _base_env(env, job_secret, extra_env)
    metrics_agg = _start_metrics_aggregator(base_env, kv, local_only,
                                            kv_addr, job_secret)
    procs: list[subprocess.Popen] = []
    pumps: list[threading.Thread] = []
    failed = threading.Event()
    exit_codes: dict[int, int] = {}

    def spawn(slot: SlotInfo) -> subprocess.Popen:
        renv = _rank_env(slot, coord, kv_addr, kv_port, base_env)
        return _spawn_proc(command, renv, slot.hostname, slot.rank,
                           this_host, output_filename, prefix_timestamp,
                           pumps)

    for slot in slots:
        if verbose:
            print(f"[hvdrun] starting rank {slot.rank} on {slot.hostname}",
                  file=sys.stderr)
        procs.append(spawn(slot))

    def reap(rank: int, proc: subprocess.Popen):
        rc = proc.wait()
        exit_codes[rank] = rc
        if rc != 0:
            failed.set()

    threads = [threading.Thread(target=reap, args=(s.rank, p), daemon=True)
               for s, p in zip(slots, procs)]
    for t in threads:
        t.start()

    try:
        while any(t.is_alive() for t in threads):
            if failed.is_set():
                # one dead rank kills the job (reference gloo_run.py:294)
                # Signal every rank's GROUP, even ranks that already
                # exited — a dead group leader can still leave live
                # helpers in its group (killpg targets the pgid, which
                # outlives the leader while members remain).
                for p in procs:
                    _signal_rank(p, signal.SIGTERM)
                break
            for t in threads:
                t.join(timeout=0.2)
        # TERM -> KILL escalation on one shared deadline (a rank stuck
        # in a shutdown barrier must not stall the whole job); the
        # deadline is HOROVOD_SHUTDOWN_TIMEOUT_SECONDS, the same knob
        # bounding the ranks' own distributed-shutdown barrier.
        import time as _time

        deadline = _time.monotonic() + max(
            1, _config.get("shutdown_timeout"))
        for t in threads:
            t.join(timeout=max(0.0, deadline - _time.monotonic()))
        for p in procs:
            _signal_rank(p, signal.SIGKILL)
        for t in threads:
            t.join(timeout=5)
        _drain_pumps(pumps)
    finally:
        _release(held)
        _sweep_flight_dir(base_env, "wrap-up")
        _sweep_health_dir(base_env)
        _stop_metrics_aggregator(metrics_agg)
        if owns_kv:
            kv.stop()
    bad = {r: c for r, c in exit_codes.items() if c != 0}
    if bad:
        print(f"[hvdrun] ranks failed: {bad}", file=sys.stderr)
        return 1
    return 0


class Blacklist:
    """Elastic-mode host blacklist with cooldown
    (``HOROVOD_BLACKLIST_COOLDOWN_SECONDS``): a host whose rank died is
    inadmissible for replacement spawns until the cooldown expires —
    a flapping host must not churn respawn/die cycles.  ``clock`` is
    injectable for tests."""

    def __init__(self, cooldown_s: float, clock=None):
        import time as _time

        self.cooldown_s = float(cooldown_s)
        self._clock = clock if clock is not None else _time.monotonic
        self._until: dict[str, float] = {}

    def add(self, host: str) -> None:
        self._until[host] = self._clock() + self.cooldown_s

    def admissible(self, host: str) -> bool:
        return self._clock() >= self._until.get(host, 0.0)

    def active(self) -> list[str]:
        now = self._clock()
        return sorted(h for h, t in self._until.items() if t > now)


def _exit_disposition(rc: int, *, cancelled: bool = False,
                      preempted: bool = False,
                      joiner_gave_up: bool = False) -> str:
    """Classify one elastic rank exit.  Exactly one disposition
    blacklists the host: ``died``.  A ``preempted`` exit — the rank's
    ``el/preempt/u/<uid>`` marker was present when it went away — is an
    announced departure from a HEALTHY host: not a death, not a job
    finish, and never a blacklist (the whole point of the graceful
    plane, docs/fault-tolerance.md; blacklisting it would bar the
    capacity that comes back after the maintenance event)."""
    if preempted:
        return "preempted"
    if rc == 0:
        return "finished"
    if cancelled:
        return "cancelled"
    if joiner_gave_up:
        return "join_timeout"
    return "died"


@dataclass
class _ElasticProc:
    proc: subprocess.Popen
    host: str
    label: str          # "0".."N-1" for seed ranks, "j<k>" for joiners
    uid: str
    joiner: bool
    slot: int = 0             # slot index on its host (its card)
    cancelled: bool = False   # TERM'd waiting-room joiner, not a death


def _launch_elastic(command: list[str], slots: list[SlotInfo],
                    this_host: str, local_only: bool, kv_addr: str,
                    coord_host: str, output_filename, verbose, env,
                    kv_server, prefix_timestamp: bool,
                    extra_env: dict, host_list: list) -> int:
    """Elastic job attempt (``--elastic``): a dead rank does NOT kill
    the job.  The launcher keeps the rendezvous KV server alive across
    re-forms (survivors re-negotiate generations through it), blacklists
    the dead rank's host for the cooldown, and — once a non-blacklisted
    slot frees up — respawns a replacement process that registers as a
    joiner and is admitted at the survivors' next commit boundary,
    growing the world back toward the original ``-np``.  The job fails
    only when live membership falls below ``--min-ranks`` (at which
    point ``--restart-attempts`` is the fallback, as before).

    A joiner takes the card of the slot it replaces: its
    ``HOROVOD_LOCAL_RANK`` is that slot's index on the host, which its
    first ``init()`` binds (``cuda:<slot>``) and every re-init keeps, so
    no two processes ever share a card."""
    import json
    import time as _time

    from horovod_tpu_torch.runtime import metrics as _metrics
    from horovod_tpu_torch.runtime import preemption as _preemption
    from horovod_tpu_torch.runtime.kvstore import (KVStoreClient,
                                                   decode_secret)

    kv, owns_kv, job_secret = _job_kv(env, kv_server)
    kv_port = kv.port
    np_ = len(slots)
    held: list = []
    coord = _coordinator(coord_host, local_only, held)
    base_env = _base_env(env, job_secret, extra_env)
    base_env["HOROVOD_ELASTIC"] = "1"
    base_env["HOROVOD_ELASTIC_NP"] = str(np_)
    metrics_agg = _start_metrics_aggregator(base_env, kv, local_only,
                                            kv_addr, job_secret)
    # Launcher-side fleet-health metrics: merged into the aggregate
    # /metrics with rank="launcher" (docs/metrics.md) and mirrored by
    # the structured el/status log lines below.
    m_deaths = _metrics.counter(
        "hvd_launcher_rank_deaths_total",
        "Rank processes the elastic launcher saw die.")
    m_respawns = _metrics.counter(
        "hvd_launcher_respawns_total",
        "Replacement joiner processes the elastic launcher spawned.")
    m_blacklist = _metrics.gauge(
        "hvd_elastic_blacklist_size",
        "Hosts currently under the elastic blacklist cooldown.")
    m_reforms = _metrics.counter(
        "hvd_launcher_reforms_total",
        "Re-forms observed via el/status.")
    m_gen = _metrics.gauge(
        "hvd_launcher_reform_generation",
        "Latest generation reported on el/status.")
    m_size = _metrics.gauge(
        "hvd_launcher_reform_size",
        "World size of the latest re-form on el/status.")
    m_reform_s = _metrics.gauge(
        "hvd_launcher_last_reform_seconds",
        "Latency of the latest re-form on el/status.")
    m_preempted = _metrics.counter(
        "hvd_launcher_preempted_total",
        "Ranks that exited after a graceful preemption drain (host "
        "NOT blacklisted; docs/fault-tolerance.md).")

    def _env_float(key: str, default: float) -> float:
        try:
            return float(base_env.get(key) or default)
        except ValueError:
            return default

    try:
        min_ranks = max(1, int(base_env.get("HOROVOD_MIN_RANKS") or 1))
    except ValueError:
        min_ranks = 1
    cooldown = _env_float("HOROVOD_BLACKLIST_COOLDOWN_SECONDS", 120.0)
    blacklist = Blacklist(cooldown)
    capacity: dict[str, int] = {}
    for s in slots:
        capacity[s.hostname] = capacity.get(s.hostname, 0) + 1

    pumps: list[threading.Thread] = []
    live: dict[str, _ElasticProc] = {}
    finished: list[str] = []
    deaths: list[str] = []
    preempted: list[str] = []
    join_seq = 0
    spawn_budget = np_ * 3  # bound replacement churn
    aborted: str | None = None

    for slot in slots:
        renv = _rank_env(slot, coord, kv_addr, kv_port, base_env)
        renv["HOROVOD_ELASTIC_UID"] = f"rank{slot.rank}"
        if verbose:
            print(f"[hvdrun] starting rank {slot.rank} on {slot.hostname}",
                  file=sys.stderr)
        proc = _spawn_proc(command, renv, slot.hostname, slot.rank,
                           this_host, output_filename, prefix_timestamp,
                           pumps)
        live[str(slot.rank)] = _ElasticProc(
            proc, slot.hostname, str(slot.rank), f"rank{slot.rank}", False,
            slot=slot.local_rank)

    def free_slot(host: str) -> int:
        """The lowest slot index on ``host`` no live process holds."""
        taken = {r.slot for r in live.values() if r.host == host}
        return next(i for i in range(capacity.get(host, 0) + len(taken))
                    if i not in taken)

    def spawn_joiner(host: str, seq: int) -> None:
        uid = f"joiner{seq}"
        slot = free_slot(host)
        renv = dict(base_env)
        renv.update({
            "HOROVOD_RANK": "0", "HOROVOD_SIZE": "1",
            # the freed slot's card: init() binds cuda:<local rank>
            "HOROVOD_LOCAL_RANK": str(slot),
            "HOROVOD_LOCAL_SIZE": str(capacity.get(host, 1)),
            "HOROVOD_CROSS_RANK": "0", "HOROVOD_CROSS_SIZE": "1",
            "HOROVOD_IS_HOMOGENEOUS": "1",
            "HOROVOD_ELASTIC_JOINER": "1",
            "HOROVOD_ELASTIC_UID": uid,
            "HOROVOD_GLOO_RENDEZVOUS_ADDR": kv_addr,
            "HOROVOD_GLOO_RENDEZVOUS_PORT": str(kv_port),
        })
        renv.pop("HOROVOD_COORDINATOR_ADDR", None)
        label = f"j{seq}"
        proc = _spawn_proc(command, renv, host, label, this_host,
                           output_filename, prefix_timestamp, pumps)
        live[label] = _ElasticProc(proc, host, label, uid, True, slot=slot)
        m_respawns.inc()
        print(f"[hvdrun elastic] respawned replacement {label} on {host} "
              f"slot {slot} (admitted at the survivors' next commit "
              "boundary)", file=sys.stderr)

    kvc = KVStoreClient("127.0.0.1" if local_only else kv_addr, kv_port,
                        connect_timeout_s=10.0,
                        secret=decode_secret(job_secret))

    def admitted(uid: str) -> bool:
        try:
            return kvc.try_get(f"el/admitted/{uid}") is not None
        except OSError:
            return True

    def joiner_timed_out(uid: str) -> bool:
        """True when the joiner retracted itself on the admission
        deadline (it writes the 'timeout' mark before exiting)."""
        try:
            return kvc.try_get(f"el/admitted/{uid}") == "timeout"
        except OSError:
            return False

    def retract_joiner(uid: str) -> None:
        """Mark a dead/cancelled waiting-room joiner consumed: a later
        grow re-form scanning the join registry must never admit a
        ghost into the roster (the survivors would hang their re-init
        on a process that can never connect)."""
        try:
            kvc.set(f"el/admitted/{uid}", "dead")
        except OSError:
            pass

    def live_members() -> int:
        return sum(1 for r in live.values()
                   if not r.joiner or admitted(r.uid))

    want = {"np": np_}
    returns: list[float] = []  # when each preempted slot comes back

    def _roster() -> dict:
        """The current generation's rank -> stable elastic uid, as the
        last re-form published it (empty before the first re-form)."""
        try:
            status = kvc.try_get("el/status")
            if status:
                gen = json.loads(status).get("gen")
                roster = kvc.try_get(f"el/g{gen}/roster")
                if roster:
                    return {int(m["rank"]): str(m["uid"]) for m in
                            json.loads(roster).get("members") or []}
        except (OSError, ValueError, TypeError, KeyError):
            pass
        return {}

    def _resolve_uid(rank: int, roster: dict | None = None) -> str:
        """Current-generation rank -> stable elastic uid (the address
        ``request_drain`` wants).  Seed ranks start life as uid
        ``rank<k>``, so that is also the safe fallback before the
        first re-form publishes a roster."""
        roster = _roster() if roster is None else roster
        return roster.get(int(rank), f"rank{rank}")

    # The closed-loop autopilot (runtime/autopilot.py): the policy engine
    # that turns the evidence this loop aggregates -- the ranks'
    # KV-published heartbeat staleness, the FleetGoodput SLO burn -- into
    # fleet actions through the machinery above: preemptive host
    # blacklist + coordinated shrink, SLO-burn shrink, recovery grow, and
    # the graceful drain.  ``want`` is the elastic target size the respawn
    # sweep steers toward; shrink and grow move it between --min-ranks
    # and -np.
    from horovod_tpu_torch.runtime import autopilot as _autopilot

    def _live_label(rank, roster: dict | None = None) -> str | None:
        """The live process at ``rank`` of the current generation: the
        evidence numbers ranks as the ranks' snapshots do, the table is
        keyed by the seed's labels, and a re-form renumbers."""
        uid = _resolve_uid(int(rank), roster)
        return next((lb for lb, r in live.items()
                     if r.uid == uid and r.proc.poll() is None), None)

    def _ap_blacklist(action) -> None:
        host = action.evidence.get("host")
        if host is None:
            rec = live.get(_live_label(action.evidence.get("rank")) or "")
            if rec is None:
                raise LookupError(
                    f"no live process for {action.target}")
            host = rec.host
        doomed = [lb for lb, r in live.items()
                  if r.host == host and r.proc.poll() is None]
        if live_members() - len(doomed) < min_ranks:
            raise RuntimeError(
                f"shedding {host} would drop below --min-ranks "
                f"{min_ranks}")
        if _live_label(0) in doomed:
            raise RuntimeError(f"{host} holds rank 0: {_RANK0_HELD}")
        blacklist.add(host)
        m_blacklist.set(len(blacklist.active()))
        for lb in doomed:
            # not cancelled: the reap path records the death and
            # stamps the blacklist again, so the audit story holds
            _signal_rank(live[lb].proc, signal.SIGKILL)
        action.evidence["killed"] = doomed
        print(f"[hvdrun autopilot] preemptive blacklist of straggler "
              f"host {host}: killed {doomed or 'no'} process(es); "
              f"survivors re-form without it", file=sys.stderr)

    def _ap_shrink(action) -> None:
        if live_members() <= min_ranks:
            raise RuntimeError(f"at the --min-ranks {min_ranks} floor")
        roster = _roster()
        label = _shed_label(action.evidence.get("bottleneck_rank"),
                            lambda r: _live_label(r, roster))
        rec = live[label]
        rec.cancelled = True  # a deliberate shed: the host stays admissible
        _signal_rank(rec.proc, signal.SIGKILL)
        want["np"] = max(min_ranks, want["np"] - 1)
        action.evidence["killed"] = [label]
        action.evidence["target_np"] = want["np"]
        print(f"[hvdrun autopilot] SLO-burn shrink: shed rank {label} "
              f"on {rec.host} (elastic target now {want['np']})",
              file=sys.stderr)

    def _ap_grow(action) -> None:
        if want["np"] >= np_:
            raise RuntimeError(f"already at the launched -np {np_}")
        want["np"] += 1
        action.evidence["target_np"] = want["np"]
        print(f"[hvdrun autopilot] SLO recovered: elastic target back "
              f"to {want['np']} (respawn sweep grows on its next "
              f"pass)", file=sys.stderr)

    def _ap_preempt(action) -> None:
        rank = int(action.evidence.get("rank"))
        uid = _resolve_uid(rank)
        _preemption.request_drain(
            kvc, uid, grace_s=action.evidence.get("grace_s"),
            source=str(action.evidence.get("source") or "launcher"))
        action.evidence["uid"] = uid
        print(f"[hvdrun autopilot] graceful drain ordered for rank "
              f"{rank} (uid {uid})", file=sys.stderr)

    ap = _autopilot.Autopilot.from_env(base_env, actuators={
        "straggler_blacklist": _ap_blacklist,
        "slo_burn_shrink": _ap_shrink,
        "slo_recover_grow": _ap_grow,
        "preempt_drain": _ap_preempt,
    })
    ap_fleet = None
    ap_next = 0.0
    if ap is not None:
        from horovod_tpu_torch.perf import goodput as _goodput

        # A FleetGoodput of its own on the job's SLO: the aggregate
        # /metrics fleet updates only when scraped, and the autopilot
        # must not depend on someone polling a dashboard.
        ap_fleet = _goodput.FleetGoodput(
            slo=_env_float("HOROVOD_GOODPUT_SLO", 0.0),
            window_s=_env_float("HOROVOD_GOODPUT_WINDOW_SECONDS", 300.0))
        print(f"[hvdrun autopilot] engaged"
              f"{' (dry-run)' if ap.dry_run else ''}: rules "
              f"{', '.join(_autopilot.RULES[:3] + ('preempt_drain',))}",
              file=sys.stderr)

    # The launcher's OWN SIGTERM triggers a fleet-wide grace drain —
    # notice every live rank over the rendezvous KV, wait out
    # min(grace, shutdown deadline) for clean drain exits, and only then
    # fall through to the TERM -> KILL escalation below.  A second
    # SIGTERM skips the wait.
    grace_s = _env_float("HOROVOD_PREEMPT_GRACE_SECONDS", 30.0)
    shutdown_s = _env_float("HOROVOD_SHUTDOWN_TIMEOUT_SECONDS",
                            float(_config.get("shutdown_timeout")))
    term_signals = {"n": 0}
    drain = {"on": False, "deadline": 0.0}
    term_installed = False
    prev_term = None
    if threading.current_thread() is threading.main_thread():
        try:
            prev_term = signal.signal(
                signal.SIGTERM,
                lambda signum, frame: term_signals.__setitem__(
                    "n", term_signals["n"] + 1))
            term_installed = True
        except (ValueError, OSError):
            term_installed = False

    preempt_req = {"last": None}
    last_status = None
    try:
        while live:
            _time.sleep(0.25)
            for label, rec in list(live.items()):
                rc = rec.proc.poll()
                if rc is None:
                    continue
                del live[label]
                disp = _exit_disposition(
                    rc, cancelled=rec.cancelled,
                    preempted=_preemption.drain_requested(kvc, rec.uid),
                    joiner_gave_up=(rec.joiner
                                    and joiner_timed_out(rec.uid)))
                if disp == "preempted":
                    preempted.append(label)
                    m_preempted.inc()
                    # Announced departure: the host stays admissible,
                    # and the elastic target shrinks so the respawn
                    # sweep doesn't re-place a rank on doomed capacity.
                    # With the autopilot engaged the capacity comes back
                    # only through its recovery grow, as in the JAX
                    # package; without it, once the cooldown has passed
                    # (the maintenance event is over)
                    want["np"] = max(min_ranks, want["np"] - 1)
                    if ap is None:
                        returns.append(_time.monotonic() + cooldown)
                    print(f"[hvdrun elastic] rank {label} on {rec.host} "
                          f"exited after graceful preemption drain "
                          f"(rc={rc}); host NOT blacklisted, elastic "
                          f"target now {want['np']}"
                          + ("" if ap is not None
                             else f" for {cooldown:.0f}s"),
                          file=sys.stderr)
                    continue
                if disp == "finished":
                    finished.append(label)
                    if verbose:
                        print(f"[hvdrun elastic] rank {label} finished",
                              file=sys.stderr)
                elif disp == "cancelled":
                    pass  # waiting-room joiner we TERM'd at wrap-up
                elif disp == "join_timeout":
                    # Admission-timeout exit: the joiner self-retracted
                    # because no commit boundary came within its
                    # deadline — a cadence mismatch, not a host fault.
                    print(f"[hvdrun elastic] replacement {label} gave "
                          "up waiting for admission (commit cadence > "
                          "HOROVOD_ELASTIC_JOIN_TIMEOUT_SECONDS?); "
                          f"host {rec.host} NOT blacklisted",
                          file=sys.stderr)
                else:
                    deaths.append(label)
                    blacklist.add(rec.host)
                    m_deaths.inc()
                    m_blacklist.set(len(blacklist.active()))
                    if rec.joiner and not admitted(rec.uid):
                        retract_joiner(rec.uid)
                    # a dead leader can leave live helpers in its group
                    _signal_rank(rec.proc, signal.SIGKILL)
                    wrapup = (" — died during wrap-up, no survivor "
                              "loop left to re-form around it"
                              if finished else "")
                    print(f"[hvdrun elastic] rank {label} on {rec.host} "
                          f"died (rc={rc}); blacklisting {rec.host} for "
                          f"{cooldown:.0f}s; {len(live)} process(es) "
                          f"still live (min-ranks {min_ranks}){wrapup}",
                          file=sys.stderr)
            try:
                status = kvc.try_get("el/status")
            except OSError:
                status = None
            if status and status != last_status:
                last_status = status
                try:
                    d = json.loads(status)
                except ValueError:
                    d = None
                if d is not None:
                    # Structured re-form record: key=value fields
                    # (machine-parseable, docs/metrics.md).
                    fields = dict(d, blacklist=blacklist.active())
                    print("[hvdrun elastic] elastic re-form complete "
                          + " ".join(f"{k}={json.dumps(v)}"
                                     for k, v in sorted(fields.items())),
                          file=sys.stderr)
                    m_reforms.inc()
                    for gauge, key in ((m_gen, "gen"), (m_size, "size"),
                                       (m_reform_s, "reform_s")):
                        try:
                            gauge.set(float(d.get(key) or 0))
                        except (TypeError, ValueError):
                            pass
                    m_blacklist.set(len(blacklist.active()))
                    # Re-forming ranks dumped their old-generation
                    # rings just before teardown — surface them now
                    # so the postmortem exists before the job ends.
                    _sweep_flight_dir(base_env,
                                      f"re-form gen {d.get('gen')}")
            if ap is not None:
                nowm = _time.monotonic()
                if nowm >= ap_next:
                    # The evidence sweep on its own cadence (the 0.25 s
                    # poll is for reaping): pull the ranks' KV-published
                    # snapshots, derive lateness and the SLO report, let
                    # the engine judge.  A failure costs this sweep only.
                    ap_next = nowm + 2.0
                    try:
                        snaps, _ = _metrics.aggregate_snapshots(
                            kvc.try_get)
                    except Exception:  # noqa: BLE001
                        snaps = []
                    # The blacklist's host names are this launcher's,
                    # from the roster; on one host it could only shed
                    # the whole job, so the straggler rule is not fed
                    roster = _roster()
                    by_uid = {r.uid: r.host for r in live.values()
                              if r.proc.poll() is None}
                    hosts = {}
                    for snap in snaps:
                        try:
                            rk = int(((snap or {}).get("meta")
                                      or {})["rank"])
                        except (KeyError, TypeError, ValueError):
                            continue
                        host = by_uid.get(_resolve_uid(rk, roster))
                        if host is not None:
                            hosts[rk] = host
                    try:
                        _autopilot.launcher_observe(
                            ap, snaps, fleet=ap_fleet, hosts=hosts,
                            stragglers=len(set(by_uid.values())) > 1,
                            stepped_only=True)
                    except Exception as exc:  # noqa: BLE001
                        print(f"[hvdrun autopilot] sweep failed: "
                              f"{exc}", file=sys.stderr)
                    ap.refresh_gauges()
            # --preempt actuator requests posted over the KV: resolve
            # the current rank to its stable uid and order the graceful
            # drain (through the autopilot's ungated preempt_drain rule
            # when engaged, so the verdict and its evidence land on the
            # audit trail; directly otherwise).
            try:
                req = kvc.try_get("el/preempt_req")
            except OSError:
                req = None
            if req and req != preempt_req["last"]:
                preempt_req["last"] = req
                try:
                    d = json.loads(req)
                    rank = int(d["rank"])
                except (ValueError, TypeError, KeyError):
                    d, rank = {}, None
                if rank is not None:
                    if ap is not None:
                        ap.observe_preemption(
                            rank, source=str(d.get("source") or "cli"),
                            grace_s=d.get("grace_s"))
                    else:
                        _preemption.request_drain(
                            kvc, _resolve_uid(rank),
                            grace_s=d.get("grace_s"),
                            source=str(d.get("source") or "cli"))
                        print(f"[hvdrun elastic] graceful drain ordered "
                              f"for rank {rank} (--preempt)",
                              file=sys.stderr)
            if term_signals["n"] and not drain["on"]:
                drain["on"] = True
                wait_s = max(0.0, min(grace_s, shutdown_s))
                drain["deadline"] = _time.monotonic() + wait_s
                print(f"[hvdrun elastic] SIGTERM: fleet-wide graceful "
                      f"drain — noticing {len(live)} rank(s), waiting "
                      f"up to {wait_s:.0f}s for clean drain exits "
                      f"before TERM/KILL escalation", file=sys.stderr)
                for rec in live.values():
                    try:
                        _preemption.request_drain(
                            kvc, rec.uid, grace_s=grace_s,
                            source="launcher:SIGTERM")
                    except OSError:
                        pass
            if drain["on"] and live \
                    and (term_signals["n"] > 1
                         or _time.monotonic() >= drain["deadline"]):
                aborted = (f"graceful drain window closed with "
                           f"{len(live)} rank(s) still live")
                break
            if not live:
                break
            while returns and _time.monotonic() >= returns[0]:
                returns.pop(0)
                want["np"] = min(np_, want["np"] + 1)
                print(f"[hvdrun elastic] preempted capacity is back: "
                      f"elastic target {want['np']}", file=sys.stderr)
            members = live_members()
            if deaths and members < min_ranks and not finished:
                aborted = (f"live membership {members} fell below "
                           f"--min-ranks {min_ranks}")
                break
            if finished:
                # Job is wrapping up: a joiner still in the admission
                # waiting room will never be admitted — release it so
                # the launcher doesn't wait out its rendezvous timeout.
                for rec in live.values():
                    if rec.joiner and not rec.cancelled \
                            and not admitted(rec.uid):
                        rec.cancelled = True
                        retract_joiner(rec.uid)
                        _signal_rank(rec.proc, signal.SIGTERM)
            elif spawn_budget > 0 and not drain["on"]:
                waiting = sum(1 for r in live.values()
                              if r.joiner and not admitted(r.uid))
                missing = want["np"] - (members + waiting)
                per_host = {h: 0 for h in capacity}
                for r in live.values():
                    per_host[r.host] = per_host.get(r.host, 0) + 1
                for _ in range(max(0, missing)):
                    host = next(
                        (h for h, _n in host_list
                         if per_host.get(h, 0) < capacity.get(h, 0)
                         and blacklist.admissible(h)), None)
                    if host is None:
                        break
                    join_seq += 1
                    spawn_budget -= 1
                    per_host[host] = per_host.get(host, 0) + 1
                    spawn_joiner(host, join_seq)
        if aborted:
            print(f"[hvdrun elastic] aborting job: {aborted}",
                  file=sys.stderr)
            for rec in live.values():
                _signal_rank(rec.proc, signal.SIGTERM)
            deadline = _time.monotonic() + max(
                1, _config.get("shutdown_timeout"))
            for rec in live.values():
                while rec.proc.poll() is None \
                        and _time.monotonic() < deadline:
                    _time.sleep(0.1)
            for rec in live.values():
                _signal_rank(rec.proc, signal.SIGKILL)
        _drain_pumps(pumps)
    finally:
        if term_installed:
            try:
                signal.signal(signal.SIGTERM,
                              prev_term or signal.SIG_DFL)
            except (ValueError, OSError):
                pass
        _release(held)
        if ap is not None and ap.actions:
            # The verdicts live on the launcher's own flight ring: land
            # them beside the rank dumps, so the merged trace carries
            # every autopilot action with its evidence tuple.
            from horovod_tpu_torch.runtime import flight as _flight

            _flight.dump("launcher wrap-up",
                         directory=base_env.get("HOROVOD_FLIGHT_DIR")
                         or None)
            ap_stats = ap.stats()
            print(f"[hvdrun autopilot] {ap_stats['actions_total']} "
                  f"verdict(s): {ap_stats['by_outcome']}", file=sys.stderr)
        _sweep_flight_dir(base_env, "wrap-up")
        _sweep_health_dir(base_env)
        _stop_metrics_aggregator(metrics_agg)
        try:
            kvc.close()
        except Exception:  # noqa: BLE001
            pass
        if owns_kv:
            kv.stop()
    if deaths:
        print(f"[hvdrun elastic] job saw {len(deaths)} rank death(s) "
              f"({deaths}); blacklisted host(s): "
              f"{blacklist.active() or 'none (cooldowns expired)'}",
              file=sys.stderr)
    if preempted:
        print(f"[hvdrun elastic] {len(preempted)} rank(s) left via "
              f"graceful preemption drain ({preempted}); their hosts "
              "were NOT blacklisted", file=sys.stderr)
    if aborted is None and finished:
        return 0
    if aborted is None and preempted and not deaths:
        # Every exit was a clean announced drain (the launcher-SIGTERM
        # fleet drain ends exactly here): a successful wrap-up, with
        # the emergency commit on disk for the resume.
        return 0
    if aborted is None:
        print("[hvdrun elastic] no rank finished successfully",
              file=sys.stderr)
    return 1


def preempt_request(spec: str, env: dict) -> int:
    """``hvdrun --preempt RANK[:GRACE]`` — the operator actuator:
    connect to a RUNNING elastic job's rendezvous KV (address, port and
    secret from the environment, exactly what the job exported to its
    ranks) and post the preemption request the launcher's monitor loop
    turns into a graceful drain.  Returns immediately; the drain
    itself is asynchronous (watch the job log / flight trace)."""
    import json as _json
    import time as _time

    from horovod_tpu_torch.runtime.kvstore import KVStoreClient, decode_secret

    part = spec.split(":", 1)
    try:
        rank = int(part[0])
        grace = float(part[1]) if len(part) > 1 else None
    except ValueError:
        print(f"hvdrun: bad --preempt spec {spec!r} (want RANK or "
              "RANK:GRACE_SECONDS)", file=sys.stderr)
        return 2
    addr = env.get("HOROVOD_GLOO_RENDEZVOUS_ADDR") or "127.0.0.1"
    try:
        port = int(env.get("HOROVOD_GLOO_RENDEZVOUS_PORT") or 0)
    except ValueError:
        port = 0
    if port <= 0:
        print("hvdrun: --preempt needs HOROVOD_GLOO_RENDEZVOUS_ADDR/"
              "PORT (and HOROVOD_SECRET_KEY) of the running job",
              file=sys.stderr)
        return 2
    try:
        kvc = KVStoreClient(addr, port, connect_timeout_s=10.0,
                            secret=decode_secret(
                                env.get("HOROVOD_SECRET_KEY", "")))
    except Exception as exc:
        print(f"hvdrun: cannot reach the job rendezvous at "
              f"{addr}:{port}: {exc}", file=sys.stderr)
        return 1
    try:
        kvc.set_overwrite("el/preempt_req", _json.dumps(
            {"rank": rank, "grace_s": grace, "source": "cli",
             "wall": _time.time()}, sort_keys=True))
    except OSError as exc:
        print(f"hvdrun: preemption request failed: {exc}",
              file=sys.stderr)
        return 1
    finally:
        try:
            kvc.close()
        except Exception:
            pass
    print(f"[hvdrun] graceful preemption requested for rank {rank}"
          + (f" (grace {grace:.0f}s)" if grace is not None else ""),
          file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.check_build:
        print(check_build())
        return 0
    if args.preempt is not None:
        if args.config_file:
            _config.load_config_file(args.config_file)
        return preempt_request(
            args.preempt, _config.set_env_from_args(args,
                                                    dict(os.environ)))
    if args.np is None:
        print("hvdrun: -np is required (unless --check-build)",
              file=sys.stderr)
        return 2
    if args.config_file:
        _config.load_config_file(args.config_file)
    env = _config.set_env_from_args(args, dict(os.environ))
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        print("hvdrun: no command given", file=sys.stderr)
        return 2
    # Restart knobs ride the launch env dict (set_env_from_args exports
    # CLI flags there, not into os.environ, which _config.get reads) —
    # resolve them here so --restart-attempts/--checkpoint-dir work.
    try:
        restart_attempts = int(
            env.get("HOROVOD_RESTART_ATTEMPTS") or 0)
    except ValueError:
        restart_attempts = 0
    return launch(args.np, command, hosts=args.hosts,
                  hostfile=args.hostfile,
                  output_filename=args.output_filename,
                  verbose=args.verbose,
                  start_timeout=args.start_timeout, env=env,
                  prefix_timestamp=args.prefix_output_with_timestamp,
                  restart_attempts=restart_attempts,
                  checkpoint_dir=env.get("HOROVOD_CHECKPOINT_DIR") or None)


if __name__ == "__main__":
    sys.exit(main())
