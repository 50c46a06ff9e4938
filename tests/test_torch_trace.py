"""The port's trace tools (``horovod_tpu_torch/trace``) against the JAX
package's (``tests/test_flight.py``).

Given the same dump directory, both packages' ``compute_offsets``,
``analyze`` (with its text report) and ``chrome_trace`` return equal
results: over the directories the JAX package's own test helpers build
(a synthetic job with a straggler and a SIGKILLed rank, the step split,
two-way clock samples), and over one a port world wrote -- a gloo world
of 3 under ``HOROVOD_FAULT_SPEC=delay@rank1:q/*:1s``, where the analyzer
must rank rank 1 first with ``max_lateness_s > 0.5`` and keep rank 2
under 0.4 s (``tests/test_flight.py:695-731``).  Also the CLI's merge and
analyze, an empty directory raising, and the ``aot-cache`` subcommand
delegating to ``runtime/aot_cache.main``.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys

import pytest

# the packages re-export ``analyze`` (a function) over the submodule
janalyze = importlib.import_module("horovod_tpu.trace.analyze")
jmerge = importlib.import_module("horovod_tpu.trace.merge")
jperfetto = importlib.import_module("horovod_tpu.trace.perfetto")
tanalyze = importlib.import_module("horovod_tpu_torch.trace.analyze")
tmerge = importlib.import_module("horovod_tpu_torch.trace.merge")
tperfetto = importlib.import_module("horovod_tpu_torch.trace.perfetto")

import test_flight as jtests

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(directory: str):
    """(port, jax) results of the whole trace pipeline over one
    directory."""
    out = []
    for merge, analyze, perfetto in ((tmerge, tanalyze, tperfetto),
                                     (jmerge, janalyze, jperfetto)):
        dumps = merge.load_dumps(directory)
        offsets = merge.compute_offsets(dumps)
        report = analyze.analyze(dumps, offsets)
        out.append((offsets, report, analyze.format_report(report),
                    perfetto.chrome_trace(dumps, offsets)))
    return out


def _untooled(trace: dict) -> dict:
    """The trace without the writer's name (each package names itself)."""
    other = dict(trace["otherData"])
    assert other.pop("tool") in ("horovod_tpu.trace",
                                 "horovod_tpu_torch.trace")
    return dict(trace, otherData=other)


def _assert_equal(directory: str):
    port, jax = _both(directory)
    assert port[0] == jax[0]     # offsets
    assert port[1] == jax[1]     # the analyzer's report
    assert port[2] == jax[2]     # its text
    assert _untooled(port[3]) == _untooled(jax[3])   # the Chrome trace
    return port


def test_synthetic_job_matches_jax(tmp_path):
    jtests._synthetic_job(tmp_path)
    _, report, text, trace = _assert_equal(str(tmp_path))
    assert report["deaths"]["dead"] == [1]
    assert report["stragglers"]["ranking"][0]["rank"] == 1
    assert "DEAD rank(s): [1]" in text and trace["traceEvents"]


def test_step_split_and_clock_samples_match_jax(tmp_path):
    jtests._dump(tmp_path, 0, [
        {"kind": "step", "ph": "B", "step": 0, "wall": 1.0, "mono": 1.0},
        {"kind": "step", "ph": "E", "step": 0, "wall": 2.0, "mono": 2.0,
         "wall_s": 1.0, "compute_s": 0.7, "comm_s": 0.2,
         "blocked_s": 0.3},
        {"kind": "clk", "peer": 1, "wall": 100.83, "peer_wall": 100.0},
        {"kind": "wait", "ph": "B", "handle": 1, "mono": 2.5},
        {"kind": "wait", "ph": "E", "handle": 1, "mono": 3.0},
    ])
    jtests._dump(tmp_path, 1, [
        {"kind": "clk", "peer": 0, "wall": 100.21, "peer_wall": 101.0},
        {"kind": "step", "ph": "B", "step": 0, "wall": 1.0, "mono": 1.0},
    ])
    offsets, report, _, _ = _assert_equal(str(tmp_path))
    assert {v["mode"] for v in offsets.values()} == {"self", "two-way"}
    assert report["phases"][0]["steps"] == 1


def test_merge_cli_and_empty_dir(tmp_path, capsys):
    from horovod_tpu_torch.trace.__main__ import main

    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        tmerge.merge(str(empty))
    assert main(["analyze", str(empty)]) == 1
    jtests._synthetic_job(tmp_path)
    assert main(["merge", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "wrote" in out and "flight-recorder report" in out
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    dumps = jmerge.load_dumps(str(tmp_path))
    assert _untooled(trace) == _untooled(jperfetto.chrome_trace(
        dumps, jmerge.compute_offsets(dumps)))
    assert main(["analyze", str(tmp_path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["deaths"]["dead"] == [1]
    # aot-cache delegates to the cache's own CLI (an empty cache lists
    # no entry)
    assert main(["aot-cache", "list", str(empty)]) == 0
    assert "0 entries" in capsys.readouterr().out


STRAGGLER_SCRIPT = r"""
import torch
import horovod_tpu_torch as hvd

hvd.init(device="cpu")
for i in range(2):
    out = hvd.allreduce(torch.ones(2), op=hvd.Sum, name="t%d" % i)
    assert torch.equal(out, torch.full((2,), 3.0)), out
hvd.dump_flight_recorder()
print("DONE-%d" % hvd.rank(), flush=True)
hvd.shutdown()
"""


def test_delay_fault_straggler_named_by_both_packages(tmp_path):
    """A port world of 3 under ``delay@rank1:q/*:1s`` (cache off, so
    every round ships explicit requests): both packages' analyzers read
    its dumps to the same report, ranking rank 1 first."""
    from test_torch_liveness import _spawn, _world_report

    flight = str(tmp_path / "fl")
    outs = _spawn(STRAGGLER_SCRIPT, 3, {
        "HOROVOD_FLIGHT_DIR": flight,
        "HOROVOD_FAULT_SPEC": "delay@rank1:q/*:1s",
        "HOROVOD_HEARTBEAT_INTERVAL": "0.5",
        "HOROVOD_HEARTBEAT_TIMEOUT_SECONDS": "60",
        "HOROVOD_CACHE_CAPACITY": "0"}, timeout=120)
    report = _world_report(outs)
    for r, (rc, so, _) in enumerate(outs):
        assert rc == 0 and f"DONE-{r}" in so, report
    assert sorted(d.rank for d in tmerge.load_dumps(flight)) == [0, 1, 2]
    _, rep, _, _ = _assert_equal(flight)
    ranking = rep["stragglers"]["ranking"]
    by_rank = {rec["rank"]: rec for rec in ranking}
    assert rep["stragglers"]["rounds"] >= 2, rep["stragglers"]
    assert ranking[0]["rank"] == 1, ranking
    assert by_rank[1]["max_lateness_s"] > 0.5, by_rank
    assert by_rank[1]["max_lateness_s"] < 2.0, by_rank
    assert by_rank[2]["max_lateness_s"] < 0.4, by_rank
    # same host, one physical clock: each two-way offset sits within
    # its own bound of zero
    two_way = [v for v in rep["clock"].values() if v["mode"] == "two-way"]
    assert two_way, rep["clock"]
    for v in two_way:
        assert abs(v["offset_ms"]) <= v["bound_ms"] + 1e-6, v
    # the CLI reads the port's dumps too
    p = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.trace", "analyze", flight,
         "--json"], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO + os.pathsep
                 + os.environ.get("PYTHONPATH", "")))
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout)["stragglers"]["ranking"][0]["rank"] == 1
