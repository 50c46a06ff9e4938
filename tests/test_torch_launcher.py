"""The port's launcher (``python -m horovod_tpu_torch.run``,
``horovod_tpu_torch/run/``) against the JAX package's.

1. ``tests/test_launcher.py``'s cases: host specs, hostfiles and
   allocation (compared with ``horovod_tpu.run.launcher`` on the same
   inputs), the knob flags and the config file through the port's knob
   registry, the ssh spawn keeping the secret off argv, ``--check-build``,
   output files, rank-prefixed console output and timestamps, a failing
   rank killing the job, the preflight, and ``pod.detect()`` against the
   JAX package's on the same environments (and ``init()``'s refusal of
   megascale discovery).
2. ``tests/test_launcher_cleanup.py``'s three cases: a SIGKILLed launcher
   reaps its ranks (TERM-immune ones too), and a rank's helpers die with
   the job.
3. Restart and resume (``test_fault_tolerance.py:547-585``): a failed job
   relaunches with ``HOROVOD_RESUME_STEP`` at the newest complete
   checkpoint (the port's ``checkpoint.latest_complete``); exhausted
   attempts fail the job.
4. A gloo world of 2 started by ``python -m horovod_tpu_torch.run -np 2``
   gives the topology and sums of ``test_jax_launcher_spawns_port_ranks``,
   with the rank env contract and the eager plane on the launcher's KV
   store; ``run(fn, np=2)`` returns each rank's value.
"""

from __future__ import annotations

import io
import json
import os
import pickle
import re
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from horovod_tpu.run import launcher as JL
from horovod_tpu.run import pod as jpod

from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.run import launcher as L
from horovod_tpu_torch.run import pod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_collectives_worker import WORKER, inputs  # noqa: E402


def _f(x):
    return np.asarray(x, dtype=np.float32)


def _env(**extra) -> dict:
    env = dict(os.environ)
    env.update({"PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
                "HOROVOD_PLATFORM": "cpu"})
    env.update(extra)
    return env


def _hvdrun(args, timeout=120, **extra):
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", *args],
        env=_env(**extra), capture_output=True, text=True, timeout=timeout)


# ---------------------------------------------------------------------------
# Allocation, hosts, flags
# ---------------------------------------------------------------------------

ALLOCATIONS = [([("a", 2), ("b", 2)], 4), ([("a", 4)], 3),
               ([("a", 3), ("b", 2), ("c", 1)], 6), ([("h", 1)], 1)]


@pytest.mark.parametrize("hosts,np_", ALLOCATIONS)
def test_allocate_matches_the_jax_package(hosts, np_):
    mine = [vars(s) for s in L.allocate(hosts, np_)]
    ref = [vars(s) for s in JL.allocate(hosts, np_)]
    assert mine == ref
    env = L._rank_env(L.allocate(hosts, np_)[-1], "h:1", "k", 7, {})
    jenv = JL._rank_env(JL.allocate(hosts, np_)[-1], "h:1", "k", 7, {})
    jenv.pop("HOROVOD_CONTROLLER")   # the JAX package's "xla" marker
    assert env == jenv


def test_allocate_refuses_too_few_slots():
    with pytest.raises(ValueError):
        L.allocate([("a", 2)], 4)


def test_parse_host_spec_and_hostfile(tmp_path):
    for spec, n in (("h1:4,h2:2", 6), (None, 3), ("solo", 1)):
        assert L.parse_host_spec(spec, n) == JL.parse_host_spec(spec, n)
    f = tmp_path / "hosts"
    f.write_text("nodeA slots=4  # gpu box\nnodeB slots=2\n\n")
    assert L.parse_hostfile(str(f)) == [("nodeA", 4), ("nodeB", 2)]


def test_allocate_heterogeneous_sets_flag():
    slots = L.allocate([("a", 3), ("b", 2), ("c", 1)], 6)
    assert all(not s.homogeneous for s in slots)
    assert L._rank_env(slots[3], "localhost:1", "", 0,
                       {})["HOROVOD_IS_HOMOGENEOUS"] == "0"
    slots = L.allocate([("a", 2), ("b", 2)], 4)
    assert L._rank_env(slots[0], "localhost:1", "", 0,
                       {})["HOROVOD_IS_HOMOGENEOUS"] == "1"


def test_cli_knobs_to_env():
    args = L.build_parser().parse_args(
        ["-np", "2", "--fusion-threshold-mb", "32",
         "--cycle-time-ms", "2.5", "--elastic", "--min-ranks", "2",
         "--restart-attempts", "1", "--checkpoint-dir", "/tmp/ck",
         "--preempt-grace-seconds", "9", "--no-checkpoint-verify",
         "python", "x.py"])
    env: dict = {}
    _config.set_env_from_args(args, env)
    assert env["HOROVOD_FUSION_THRESHOLD"] == str(32 * 1024 * 1024)
    assert env["HOROVOD_CYCLE_TIME"] == "2.5"
    assert env["HOROVOD_ELASTIC"] == "1"
    assert env["HOROVOD_MIN_RANKS"] == "2"
    assert env["HOROVOD_RESTART_ATTEMPTS"] == "1"
    assert env["HOROVOD_CHECKPOINT_DIR"] == "/tmp/ck"
    assert env["HOROVOD_PREEMPT_GRACE_SECONDS"] == "9"
    assert env["HOROVOD_CHECKPOINT_VERIFY"] == "0"
    # every flag of the port is the JAX package's flag for the same knob
    from horovod_tpu.common import config as jconfig

    jk = jconfig.knobs()
    for name, k in _config.knobs().items():
        assert (k.env, k.cli, k.config_key) == (
            jk[name].env, jk[name].cli, jk[name].config_key), name


def test_config_file_round_trip(tmp_path, monkeypatch):
    cfg = {"tensor_fusion": {"threshold": 1234567},
           "stall_check": {"warning_time_seconds": 7},
           "fault_tolerance": {"min_ranks": 3}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    for k in ("HOROVOD_FUSION_THRESHOLD", "HOROVOD_STALL_CHECK_TIME_SECONDS",
              "HOROVOD_MIN_RANKS"):
        monkeypatch.delenv(k, raising=False)
    applied = _config.load_config_file(str(path))
    assert applied == {"fusion_threshold": 1234567,
                       "stall_warning_time": 7, "min_ranks": 3}
    assert _config.get("fusion_threshold") == 1234567
    assert _config.get("min_ranks") == 3
    # an env value already set wins over the file
    monkeypatch.setenv("HOROVOD_MIN_RANKS", "5")
    assert "min_ranks" not in _config.load_config_file(str(path))
    for k in ("HOROVOD_FUSION_THRESHOLD", "HOROVOD_STALL_CHECK_TIME_SECONDS"):
        monkeypatch.delenv(k, raising=False)


def test_remote_spawn_command_keeps_secret_off_argv(monkeypatch):
    """The ssh rank spawn exports env inline but ships
    HOROVOD_SECRET_KEY over stdin only (argv is world-readable)."""
    captured = {}

    class FakeProc:
        def __init__(self, argv, **kw):
            captured["argv"] = argv
            self.stdin = io.BytesIO()
            self.stdin.close = lambda: captured.__setitem__(
                "stdin_data", self.stdin.getvalue())

        def wait(self):
            return 0

        def poll(self):
            return 0

    real_popen = subprocess.Popen

    def fake_popen(argv, **kw):
        if argv and argv[0] == "ssh":
            return FakeProc(argv, **kw)
        return real_popen(argv, **kw)

    monkeypatch.setattr(L.subprocess, "Popen", fake_popen)
    monkeypatch.setattr(L, "preflight_hosts", lambda *a, **kw: None)
    rc = L.launch(1, ["python", "train.py"], hosts="farawayhost:1",
                  env=dict(os.environ))
    assert rc == 0
    joined = " ".join(captured["argv"])
    assert "sh -c" in joined
    assert "HOROVOD_RANK=0" in joined
    assert "HOROVOD_GLOO_RENDEZVOUS_PORT=" in joined
    secret = captured.get("stdin_data", b"").decode().strip()
    assert secret and len(secret) >= 32
    assert secret not in joined


def test_check_build_flag():
    rc = _hvdrun(["--check-build"])
    assert rc.returncode == 0, rc.stderr
    out = rc.stdout
    assert "Available Frontends" in out and "PyTorch" in out
    assert re.search(r"\[X\] Native KV store \(C\+\+\): .*libhvdtorchkv_",
                     out), out
    assert "[X] gloo" in out and "NCCL" in out and "nvcc" in out
    assert "CUDA" in out
    assert _hvdrun([]).returncode == 2   # no -np, no --check-build


def test_preflight_unreachable_host_fails_fast_with_name():
    t0 = time.monotonic()
    with pytest.raises(L.HostUnreachableError, match="bogus-host-zz"):
        L.launch(2, ["true"], hosts="bogus-host-zz.invalid:2",
                 start_timeout=5, env=dict(os.environ))
    assert time.monotonic() - t0 < 30
    L.preflight_hosts([("localhost", 2), ("127.0.0.1", 1)], 5)


def test_output_files_console_prefixes_and_failing_rank(tmp_path):
    out_dir = tmp_path / "out"
    prog = ("import os, sys\n"
            "print('hello from', os.environ['HOROVOD_RANK'])\n"
            "print('oops', file=sys.stderr)\n")
    rc = _hvdrun(["-np", "2", "--output-filename", str(out_dir), "--",
                  sys.executable, "-c", prog])
    assert rc.returncode == 0, rc.stderr
    for r in range(2):
        assert f"hello from {r}" in (out_dir / f"rank.{r}" /
                                     "stdout").read_text()
        assert "oops" in (out_dir / f"rank.{r}" / "stderr").read_text()
    rc = _hvdrun(["-np", "2", "--", sys.executable, "-c", prog])
    assert rc.returncode == 0, (rc.stdout, rc.stderr)
    for r in range(2):
        assert f"[{r}]<stdout>:hello from {r}" in rc.stdout
        assert f"[{r}]<stderr>:oops" in rc.stderr
    rc = _hvdrun(["-np", "1", "--prefix-output-with-timestamp", "--",
                  sys.executable, "-c", "print('tick')"])
    assert rc.returncode == 0, rc.stderr
    assert re.search(r"\w{3} \w{3} +\d+ [\d:]{8} \d{4} \[0\]<stdout>:tick",
                     rc.stdout), rc.stdout
    rc = _hvdrun(["-np", "2", "--", sys.executable, "-c",
                  "import os, sys\n"
                  "sys.exit(3 if os.environ['HOROVOD_RANK'] == '1' else 0)"])
    assert rc.returncode == 1 and "ranks failed" in rc.stderr


def test_unported_knobs_are_named_once():
    rc = _hvdrun(["-np", "1", "--", sys.executable, "-c", "pass"],
                 HOROVOD_PROFILE_EVERY_N_STEPS="5", HOROVOD_AUTOPILOT="1")
    assert rc.returncode == 0, rc.stderr
    assert rc.stderr.count("profile sweep is not ported") == 1
    assert rc.stderr.count("autopilot is not ported") == 1


# ---------------------------------------------------------------------------
# Pod discovery
# ---------------------------------------------------------------------------

POD_ENVS = [
    {"TPU_WORKER_ID": "2",
     "TPU_WORKER_HOSTNAMES": "w0.local, w1.local, w2.local"},
    {"MEGASCALE_SLICE_ID": "1", "MEGASCALE_NUM_SLICES": "4",
     "MEGASCALE_COORDINATOR_ADDRESS": "coord.svc"},
    {"MEGASCALE_NUM_SLICES": "2", "MEGASCALE_COORDINATOR_ADDRESS": "c",
     "TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": "a,b"},
    {},
    {"TPU_WORKER_ID": "9", "TPU_WORKER_HOSTNAMES": "a,b"},
    {"TPU_WORKER_ID": "", "TPU_WORKER_HOSTNAMES": "a,b"},
    {"CLOUD_TPU_TASK_ID": "1", "TPU_PROCESS_ADDRESSES": "p0,p1:99"},
    {"CLOUD_TPU_TASK_ID": "x", "TPU_PROCESS_ADDRESSES": "p0"},
]


@pytest.mark.parametrize("env", POD_ENVS)
def test_pod_detect_matches_the_jax_package(env):
    mine, ref = pod.detect(env), jpod.detect(env)
    assert (None if mine is None else vars(mine)) == \
        (None if ref is None else vars(ref))


def test_init_takes_the_pod_world_and_refuses_megascale(monkeypatch):
    import horovod_tpu_torch as hvd

    for k in ("HOROVOD_SIZE", "HOROVOD_RANK", "HOROVOD_COORDINATOR_ADDR"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MEGASCALE_NUM_SLICES", "2")
    monkeypatch.setenv("MEGASCALE_COORDINATOR_ADDRESS", "c.svc")
    hvd.shutdown()
    with pytest.raises(hvd.HorovodTpuError,
                       match="MEGASCALE_COORDINATOR_ADDRESS"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()
    monkeypatch.delenv("MEGASCALE_NUM_SLICES")
    # a one-worker pod is a world of one: nothing to export
    monkeypatch.setenv("TPU_WORKER_ID", "0")
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "w0")
    try:
        hvd.init(device="cpu")
        assert hvd.size() == 1
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# Process hygiene (tests/test_launcher_cleanup.py)
# ---------------------------------------------------------------------------


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def _wait_dead(pids, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        alive = [p for p in pids if _alive(p)]
        if not alive:
            return []
        time.sleep(0.3)
    return [p for p in pids if _alive(p)]


def _spawn_job(tmp_path, prelude=""):
    script = tmp_path / "sleeper.py"
    script.write_text(textwrap.dedent(f"""\
        import os, signal, time
        {prelude}
        rank = os.environ["HOROVOD_RANK"]
        with open(os.path.join({str(tmp_path)!r}, "pid." + rank), "w") as f:
            f.write(str(os.getpid()))
        time.sleep(120)
    """))
    launcher = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.run.launcher",
         "-np", "2", "--", sys.executable, str(script)],
        env=_env(), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    deadline = time.time() + 60
    pids = []
    while time.time() < deadline:
        files = sorted(tmp_path.glob("pid.*"))
        if len(files) == 2:
            pids = [int(f.read_text()) for f in files]
            break
        if launcher.poll() is not None:
            pytest.fail(f"launcher exited early rc={launcher.returncode}")
        time.sleep(0.2)
    assert len(pids) == 2, "ranks never started"
    return launcher, pids


@pytest.mark.parametrize("prelude", [
    "", "signal.signal(signal.SIGTERM, signal.SIG_IGN)"],
    ids=["plain", "term_immune"])
def test_sigkill_launcher_reaps_ranks(tmp_path, prelude):
    launcher, pids = _spawn_job(tmp_path, prelude)
    launcher.kill()
    launcher.wait()
    leftover = _wait_dead(pids)
    for p in leftover:
        os.kill(p, signal.SIGKILL)
    assert not leftover, f"orphaned ranks after launcher SIGKILL: {leftover}"


def test_rank_grandchildren_die_with_job(tmp_path):
    script = tmp_path / "forker.py"
    script.write_text(textwrap.dedent(f"""\
        import os, subprocess, sys, time
        rank = os.environ["HOROVOD_RANK"]
        child = subprocess.Popen(
            [sys.executable, "-c", "import time; time.sleep(120)"])
        with open(os.path.join({str(tmp_path)!r}, "pid." + rank), "w") as f:
            f.write(str(child.pid))
        if rank == "1":
            time.sleep(1.0)
            sys.exit(3)
        time.sleep(120)
    """))
    launcher = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.run.launcher",
         "-np", "2", "--", sys.executable, str(script)],
        env=_env(), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        rc = launcher.wait(timeout=90)
    except subprocess.TimeoutExpired:
        launcher.kill()
        pytest.fail("launcher hung after rank failure")
    assert rc == 1
    pids = [int(f.read_text()) for f in sorted(tmp_path.glob("pid.*"))]
    assert len(pids) == 2
    leftover = _wait_dead(pids, timeout=10.0)
    for p in leftover:
        os.kill(p, signal.SIGKILL)
    assert not leftover, f"grandchildren survived fail-fast: {leftover}"


# ---------------------------------------------------------------------------
# Restart and resume (test_fault_tolerance.py:547-585)
# ---------------------------------------------------------------------------


def test_launcher_restart_resumes_from_complete(tmp_path):
    from horovod_tpu_torch import checkpoint as ckpt

    ckpt_dir = tmp_path / "ckpt"
    ckpt.save(str(ckpt_dir), {"w": np.ones(1)}, step=3)
    torn = ckpt_dir / "step_9" / "rank_1"
    torn.mkdir(parents=True)
    (torn / "tree.pkl").write_bytes(pickle.dumps({}))
    script = tmp_path / "job.py"
    script.write_text(
        "import os, sys\n"
        "attempt = os.environ.get('HOROVOD_RESTART_ATTEMPT')\n"
        "if attempt is None:\n"
        "    sys.exit(3)\n"
        "assert attempt == '1', attempt\n"
        "assert os.environ.get('HOROVOD_RESUME_STEP') == '3', \\\n"
        "    os.environ.get('HOROVOD_RESUME_STEP')\n"
        "sys.exit(0)\n")
    rc = L.launch(2, [sys.executable, str(script)], env=dict(os.environ),
                  restart_attempts=1, checkpoint_dir=str(ckpt_dir))
    assert rc == 0
    # the same through the flags
    rc = _hvdrun(["-np", "1", "--restart-attempts", "1", "--checkpoint-dir",
                  str(ckpt_dir), "--", sys.executable, str(script)])
    assert rc.returncode == 0, rc.stderr
    assert "resuming from complete checkpoint step 3" in rc.stderr


def test_launcher_restart_attempts_exhausted(tmp_path):
    script = tmp_path / "always_fail.py"
    script.write_text("import sys; sys.exit(2)\n")
    rc = L.launch(1, [sys.executable, str(script)], env=dict(os.environ),
                  restart_attempts=1)
    assert rc == 1


# ---------------------------------------------------------------------------
# Worlds started by the port's launcher
# ---------------------------------------------------------------------------


def test_port_launcher_spawns_a_gloo_world():
    """``python -m horovod_tpu_torch.run -np 2`` runs the collectives
    worker: the topology and sums of test_jax_launcher_spawns_port_ranks,
    with the launcher's env contract and its KV store under the eager
    plane."""
    out = _hvdrun(["-np", "2", "--", sys.executable, WORKER, "cpu"],
                  timeout=120, HOROVOD_METRICS_PUBLISH_INTERVAL="0")
    assert out.returncode == 0, out.stderr[-3000:]
    x0, x1 = inputs(0)["x"], inputs(1)["x"]
    for r in range(2):
        line = next(ln for ln in out.stdout.splitlines()
                    if ln.startswith(f"[{r}]<stdout>:{{"))
        res = json.loads(line.split(":", 1)[1])
        assert res["topology"] == [r, 2, r, 2, 0, 1]
        np.testing.assert_array_equal(_f(res["sum"]), x0 + x1)


def test_rank_env_contract_and_kv_controller(tmp_path):
    """Each rank sees the launcher's contract, and its eager plane
    negotiates over the launcher's KV store (a round completes through
    KVStoreClient), with the metrics publisher feeding it."""
    prog = textwrap.dedent("""\
        import json, os, torch
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.common import basics
        from horovod_tpu_torch.runtime import kvstore, metrics
        hvd.init()
        keys = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
                "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
                "HOROVOD_CROSS_SIZE", "HOROVOD_IS_HOMOGENEOUS",
                "HOROVOD_COORDINATOR_ADDR", "HOROVOD_GLOO_RENDEZVOUS_ADDR",
                "HOROVOD_GLOO_RENDEZVOUS_PORT")
        t = basics.state().background.controller.t
        s = hvd.allreduce(torch.ones(3) * (hvd.rank() + 1), op=hvd.Sum)
        print(json.dumps({
            "env": {k: os.environ.get(k) for k in keys},
            "secret": len(os.environ.get("HOROVOD_SECRET_KEY", "")),
            "transport": type(t).__name__, "sum": s.tolist(),
            "publisher": type(basics.state().metrics_publisher).__name__}))
        hvd.shutdown()
    """)
    out = _hvdrun(["-np", "2", "--", sys.executable, "-c", prog],
                  HOROVOD_METRICS_PUBLISH_INTERVAL="0.2")
    assert out.returncode == 0, out.stderr[-3000:]
    recs = {}
    for ln in out.stdout.splitlines():
        m = re.match(r"\[(\d)\]<stdout>:(\{.*)", ln)
        if m:
            recs[int(m.group(1))] = json.loads(m.group(2))
    assert sorted(recs) == [0, 1]
    for r, rec in recs.items():
        env = rec["env"]
        assert env["HOROVOD_RANK"] == str(r) and env["HOROVOD_SIZE"] == "2"
        assert env["HOROVOD_LOCAL_RANK"] == str(r)
        assert env["HOROVOD_CROSS_SIZE"] == "1"
        assert env["HOROVOD_COORDINATOR_ADDR"].startswith("127.0.0.1:")
        assert env["HOROVOD_GLOO_RENDEZVOUS_ADDR"] == "127.0.0.1"
        assert int(env["HOROVOD_GLOO_RENDEZVOUS_PORT"]) > 0
        assert rec["secret"] == 64
        assert rec["transport"] == "KVStoreClient"
        assert rec["publisher"] == "KVSnapshotPublisher"
        assert rec["sum"] == [3.0, 3.0, 3.0]


def test_run_function_mode():
    import horovod_tpu_torch.run as hr

    def rank_value(x):   # nested: pickled by value
        import torch

        import horovod_tpu_torch as hvd

        out = hvd.allreduce(torch.ones(2) * (hvd.rank() + x), op=hvd.Sum)
        return [float(out[0]), hvd.rank()]

    env = _env(HOROVOD_METRICS_PUBLISH_INTERVAL="0")
    results = hr.run(rank_value, args=(1.0,), np=2, env=env)
    assert results == [[3.0, 0], [3.0, 1]], results


def test_fleet_metrics_aggregate_over_the_kv_store():
    """``HOROVOD_METRICS_PORT``: the launcher serves the fleet aggregate
    on that port, merged from the ranks' KV-published snapshots (both
    ranks' series, the fleet size), and prints the goodput line at
    wrap-up."""
    from horovod_tpu_torch.common.util import free_port

    port = free_port()
    prog = textwrap.dedent(f"""\
        import time, torch, urllib.request
        import horovod_tpu_torch as hvd
        hvd.init()
        hvd.allreduce(torch.ones(2), name="x")
        time.sleep(1.0)
        if hvd.rank() == 0:
            txt = urllib.request.urlopen(
                "http://127.0.0.1:{port}/metrics").read().decode()
            print("AGG", "hvd_fleet_size 2" in txt,
                  'rank="1"' in txt and 'rank="0"' in txt)
        hvd.barrier()
        hvd.shutdown()
    """)
    out = _hvdrun(["-np", "2", "--", sys.executable, "-c", prog],
                  HOROVOD_METRICS_PORT=str(port),
                  HOROVOD_METRICS_PUBLISH_INTERVAL="0.2")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[0]<stdout>:AGG True True" in out.stdout, out.stdout
    assert "fleet metrics: http://" in out.stderr
    assert "fleet goodput" in out.stderr


def test_relay_keeps_long_lines_whole():
    """Four ranks each print one ~330 KB line at once: every relayed
    line parses (the JAX package's relay, whose pumps write without a
    lock, split such lines in 6 of 40 in a stress run; ROADMAP Queue
    C)."""
    prog = ("import json, os; print(json.dumps({'r': "
            "os.environ['HOROVOD_RANK'], 'x': [float(i) for i in "
            "range(30000)]}), flush=True)")
    for _ in range(3):
        out = _hvdrun(["-np", "4", "--", sys.executable, "-c", prog])
        assert out.returncode == 0, out.stderr[-3000:]
        ranks = []
        for ln in out.stdout.splitlines():
            head, _, rest = ln.partition(">:")
            rec = json.loads(rest)
            assert len(rec["x"]) == 30000 and head == f"[{rec['r']}]<stdout"
            ranks.append(rec["r"])
        assert sorted(ranks) == ["0", "1", "2", "3"]
