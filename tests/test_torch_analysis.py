"""The port's invariant lint suite (``horovod_tpu_torch/analysis/``)
against the JAX package's (``horovod_tpu/analysis/``), case by case.

* the fixture trees under ``tests/data/analysis`` and the compliant
  twins of ``tests/test_analysis.py``: both packages' knob and
  concurrency passes report equal ``(rule, severity, location,
  message)`` lists; the port's resolver deliberately differs on one
  fixture (a call on ``self.<attr>`` never resolves to the caller's own
  class), which the reference flags falsely;
* the ``.hlo`` fixtures, parsed by the reference's ``parse_hlo`` and
  turned into the port's ``Program`` by a test-only helper: both
  checkers give the same rule suffixes and counts under the files' own
  directives; the reference's rule cases likewise;
* allowlist, CLI (exit codes, JSON schema, ``skipped``), findings;
* the real tree green for all three passes, every allowlist entry used,
  the signal handlers' graph reaching ``FlightRecorder.record``;
* ``KNOB-CACHEKEY`` over what the data plane memoizes (a fixture that
  latches a knob is flagged), ``KNOB-BENCH-DRIFT`` with and without the
  port's bench script, ``KNOB-DEAD``;
* the recorder on gloo worlds of 2 and 4 (``c10d`` ranks equal to the
  hops'; the presets and their controls), the emulated hops' transfers
  and the kernel-launch records;
* ``programs.run(device="cpu")`` clean within 60 s;
* the round-0 cases of ``tests/test_analysis.py`` against the port's
  ``round0_cfg`` (its AOT-cache case waits for the port's AOT cache).
"""

import ast
import collections
import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

from horovod_tpu.analysis import concurrency_lint as RCL
from horovod_tpu.analysis import hlo_lint as HL
from horovod_tpu.analysis import knob_lint as RKL
from horovod_tpu.analysis.__main__ import main as ref_cli
from horovod_tpu_torch.analysis import PASSES, allowlist as AL
from horovod_tpu_torch.analysis import concurrency_lint as CL
from horovod_tpu_torch.analysis import knob_lint as KL
from horovod_tpu_torch.analysis import programs
from horovod_tpu_torch.analysis import schedule_lint as SL
from horovod_tpu_torch.analysis.__main__ import main as cli_main
from horovod_tpu_torch.analysis.findings import Finding, sort_findings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "analysis")

# the compliant twins of tests/test_analysis.py:212-316
KNOB_TWIN = ("import os\n"
             "from horovod_tpu.common import config\n"
             "def f():\n"
             "    os.environ['HOROVOD_OVERLAP'] = '1'\n"
             "    return config.get('overlap')\n")
LOCK_TWIN = textwrap.dedent("""\
    import signal
    import threading
    import time

    _lock_a = threading.Lock()
    _lock_b = threading.Lock()
    _ring = threading.RLock()

    def a_then_b():
        with _lock_a:
            with _lock_b:
                return 1

    def also_a_then_b():
        with _lock_a:
            with _lock_b:
                return 2

    def _handler(signum, frame):
        with _ring:        # RLock: signal-safe
            return None

    def install():
        signal.signal(signal.SIGTERM, _handler)

    def sleep_outside_lock():
        with _lock_a:
            x = 1
        time.sleep(0.01)
        return x
""")
# the resolver's false positive: the executor's barrier() is another
# object's method, never the runtime's own
RESOLVER_FIXTURE = textwrap.dedent("""\
    import threading

    class Runtime:
        def __init__(self, executor):
            self.executor = executor
            self._exec_lock = threading.Lock()

        def barrier(self):
            with self._exec_lock:
                self.executor.barrier()
""")


def _key(findings) -> list:
    return [(f.rule, f.severity, f.location, f.message) for f in findings]


def _tree(tmp_path, name: str, text: str) -> str:
    d = tmp_path / name
    d.mkdir()
    (d / "m.py").write_text(text)
    return str(d)


# ---------------------------------------------------------------------------
# Fixture trees: the port's passes report what the reference's report
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["bad_knobs", "knob_twin", "bad_locks",
                                  "lock_twin"])
def test_fixture_trees_equal_reference(tmp_path, case):
    if case.startswith("bad"):
        path = os.path.join(DATA, case)
    else:
        path = _tree(tmp_path, "clean",
                     KNOB_TWIN if case == "knob_twin" else LOCK_TWIN)
    mine, ref = (KL, RKL) if "knob" in case else (CL, RCL)
    got, want = mine.run(package_dir=path), ref.run(package_dir=path)
    assert _key(got) == _key(want)
    assert bool(got) == case.startswith("bad")


def test_resolver_false_positive_fixture(tmp_path):
    """The reference resolves ``self.executor.barrier()`` to the
    runtime's own ``barrier`` and reports a self-deadlock on
    ``_exec_lock``; the port's resolver does not (ROADMAP deviation)."""
    path = _tree(tmp_path, "fp", RESOLVER_FIXTURE)
    ref = RCL.run(package_dir=path)
    assert [f.rule for f in ref] == ["CONC-LOCK-ORDER"]
    assert "_exec_lock" in ref[0].message
    assert CL.run(package_dir=path) == []
    # a call on self itself still resolves: the genuine re-entry is seen
    real = RESOLVER_FIXTURE.replace("self.executor.barrier()",
                                    "self.barrier()")
    got = CL.run(package_dir=_tree(tmp_path, "real", real))
    assert [f.rule for f in got] == ["CONC-LOCK-ORDER"]


def test_scan_env_reads_patterns(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text(textwrap.dedent("""\
        import os
        _KEY = "HOROVOD_INDIRECT"
        a = os.environ.get("HOROVOD_A")
        b = os.getenv("HOROVOD_B", "0")
        c = os.environ["HOROVOD_C"]
        d = "HOROVOD_D" in os.environ
        e = os.environ.get(_KEY)
        os.environ["HOROVOD_WRITE"] = "1"          # write: exempt
        os.environ.setdefault("HOROVOD_SETDEF", "2")  # guarded write
        f = os.environ.get("NOT_HOROVOD")          # other namespaces
    """))
    got = KL.scan_env_reads(str(mod))
    assert got == RKL.scan_env_reads(str(mod))
    assert sorted(n for _, n in got) == ["HOROVOD_A", "HOROVOD_B",
                                         "HOROVOD_C", "HOROVOD_D",
                                         "HOROVOD_INDIRECT"]


# ---------------------------------------------------------------------------
# The .hlo fixtures and the reference's rule cases, through the port
# ---------------------------------------------------------------------------


def program_of_hlo(text: str) -> SL.Program:
    """The reference's parsed HLO as the port's program: an entry
    parameter or a shard/unshard boundary call is an input, a
    ``tpu_custom_call`` a fused-update kernel launch, every other
    instruction a record with its result shapes and the first of its
    replica groups (a recorded transfer holds its own group)."""
    prog = SL.Program([], 0, "hlo")
    for ins in HL.parse_hlo(text).instructions:
        opcode, via = ins.opcode, "hlo"
        if HL._is_global_view(ins):
            via = "parameter"
        elif ins.opcode == "custom-call" and "tpu_custom_call" in ins.raw:
            opcode, via = "hvd.fused_update.momentum", "kernel"
        prog.add(opcode, [SL.Shape(s.dtype, s.dims) for s in ins.shapes],
                 ins.replica_groups[0] if ins.replica_groups else (),
                 ins.source_target_pairs, via=via)
    return prog


def _suffixes(findings) -> collections.Counter:
    return collections.Counter(f.rule.split("-", 1)[1] for f in findings)


@pytest.mark.parametrize("name", ["bad_zero2.hlo", "bad_localsgd_inner.hlo",
                                  "bad_mesh_world.hlo", "good_mesh_dp.hlo"])
def test_hlo_fixtures_same_suffixes(name):
    path = os.path.join(DATA, name)
    with open(path) as f:
        text = f.read()
    want = HL.check_file(path)
    rules = SL.rules_from_directives(text.splitlines(), path)
    got = SL.check_program(program_of_hlo(text), rules)
    assert _suffixes(got) == _suffixes(want)
    assert bool(got) == name.startswith("bad")


def _hlo(body: str) -> str:
    return "ENTRY main {\n" + textwrap.dedent(body) + "}\n"


_LOCAL = ("replica_groups={{0,1,2,3},{4,5,6,7}}, "
          "use_global_device_ids=true, to_apply=r")
_CROSS = ("replica_groups={{0,4},{1,5},{2,6},{3,7}}, "
          "use_global_device_ids=true, to_apply=r")
_WORLD = ("replica_groups={{0,1,2,3,4,5,6,7}}, "
          "use_global_device_ids=true, to_apply=r")
_RING = "".join(f"  cp.{i} = f32[8]{{0}} collective-permute(x.0), "
                "source_target_pairs={{0,1},{1,0}}\n" for i in range(3))
RULE_CASES = {
    "fullbuf-1d": ("  x.1 = f32[384]{0} broadcast(y.0), dimensions={0}\n",
                   "no_full_buffer", (384,)),
    "fullbuf-2d": ("  x.1 = f32[4,96]{1,0} concatenate(y.0), "
                   "dimensions={0}\n", "no_full_buffer", (384,)),
    "fullbuf-good": ("  x.1 = f32[96]{0} broadcast(y.0), dimensions={0}\n",
                     "no_full_buffer", (384,)),
    "fullbuf-inputs": ('  Arg_0.1 = f32[8,48]{1,0} parameter(0)\n'
                       '  custom-call.3 = f32[1,48]{1,0} custom-call('
                       'Arg_0.1), custom_call_target="SPMDFullToShardShape"'
                       ', sharding={manual}\n', "no_full_buffer", (384,)),
    "buckets-ring": (_RING, "min_collectives", ("collective-permute", 4)),
    "buckets-ok": (_RING, "min_collectives", ("collective-permute", 3)),
    "monolithic": ("  ar.1 = f32[64]{0} all-reduce(x.0), "
                   "replica_groups={{0,1}}, to_apply=region_0.4\n",
                   "no_collective", ("all-reduce",)),
    "lossy-ok": (f"  a.1 = s8[1,256]{{1,0}} all-reduce(x.0), {_CROSS}\n"
                 f"  b.2 = f32[256]{{0}} reduce-scatter(y.0), {_LOCAL}\n",
                 "lossy_cross_only", (4,)),
    "lossy-local": (f"  a.1 = s8[1,256]{{1,0}} all-reduce(x.0), {_LOCAL}\n",
                    "lossy_cross_only", (4,)),
    "lossy-world": (f"  a.1 = s8[1,256]{{1,0}} all-reduce(x.0), {_WORLD}\n",
                    "lossy_cross_only", (4,)),
    "lossy-index": (f"  a.1 = s32[16]{{0}} all-gather(x.0), {_LOCAL}\n",
                    "lossy_cross_only", (4,)),
    "lossy-cast": (f"  a.1 = f16[256]{{0}} reduce-scatter(x.0), {_LOCAL}\n",
                   "lossy_cross_only", (4,)),
    "inner-local": (f"  a.1 = f32[8]{{0}} all-reduce(x.0), {_LOCAL}\n",
                    "no_cross_collectives", (4,)),
    "inner-cross": (f"  a.1 = f32[8]{{0}} all-reduce(x.0), {_CROSS}\n",
                    "no_cross_collectives", (4,)),
    "outer-none": (f"  a.1 = f32[8]{{0}} all-reduce(x.0), {_LOCAL}\n",
                   "has_cross_collective", (4,)),
    "outer-cross": (f"  a.1 = f32[8]{{0}} all-reduce(x.0), {_CROSS}\n",
                    "has_cross_collective", (4,)),
    "fused-one": ('  k.1 = (f32[128]{0}, f32[128]{0}) custom-call(a.0), '
                  'custom_call_target="tpu_custom_call"\n',
                  "single_fused_kernel", (1,)),
    "fused-chain": ("  m.1 = f32[128]{0} multiply(a.0, b.0)\n"
                    "  s.2 = f32[128]{0} subtract(m.1, c.0)\n",
                    "single_fused_kernel", (1,)),
    "fused-two": ('  k.1 = (f32[128]{0}, f32[128]{0}) custom-call(a.0), '
                  'custom_call_target="tpu_custom_call"\n',
                  "single_fused_kernel", (2,)),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_rule_cases_same_as_reference(case):
    """The reference's rule cases (``tests/test_analysis.py:97-181``):
    each rule factory, same name and parameters, flags what the
    reference's flags."""
    body, factory, args = RULE_CASES[case]
    text = _hlo(body)
    want = HL.check_program(text, [getattr(HL, factory)(*args)])
    got = SL.check_program(program_of_hlo(text),
                           [getattr(SL, factory)(*args)])
    assert _suffixes(got) == _suffixes(want)


def test_overlap_preset_counts_bucket_transfers():
    """The one preset that deliberately differs: the port's overlap
    engine runs each bucket as a reduce-scatter and an all-gather (no
    permute ring), so ``overlap_rules`` counts those."""
    prog = SL.Program([], 4)
    for _ in range(3):
        prog.add("reduce-scatter", [SL.Shape("f32", (8,))], (0, 1), via="hop")
        prog.add("all-gather", [SL.Shape("f32", (16,))], (0, 1), via="hop")
    assert SL.check_program(prog, SL.overlap_rules(3)) == []
    assert _suffixes(SL.check_program(prog, SL.overlap_rules(4))) == \
        collections.Counter({"BUCKETS": 2})
    prog.add("all-reduce", [SL.Shape("f32", (16,))], (0, 1), via="hop")
    assert _suffixes(SL.check_program(prog, SL.overlap_rules(3))) == \
        collections.Counter({"MONOLITHIC": 1})


@pytest.mark.parametrize("groups,local,pairs", [
    ([(0, 1, 2, 3), (4, 5, 6, 7)], 4, [(0, 1), (1, 0)]),
    ([(0, 4), (1, 5), (2, 6), (3, 7)], 4, [(0, 4), (4, 0)]),
    ([(0, 1, 2, 3, 4, 5, 6, 7)], 4, [(0, 1), (0, 4)]),
    ([(0, 1), (2, 5)], 2, []),
    ([(0, 2)], 2, [(1, 3)]),
])
def test_axis_kinds_equal_reference(groups, local, pairs):
    assert SL.group_axis_kind(groups, local) == \
        HL.group_axis_kind(groups, local)
    assert SL.permute_axis_kind(pairs, local) == \
        HL.permute_axis_kind(pairs, local)


def test_check_file_directives(tmp_path):
    prog = program_of_hlo(open(os.path.join(DATA, "bad_zero2.hlo")).read())
    doc = json.loads(prog.to_json())
    doc["directives"] = ["hvd-lint: no_full_buffer(384)",
                        "hvd-lint: min_collectives(reduce-scatter, 4)"]
    path = tmp_path / "zero2.json"
    path.write_text(json.dumps(doc))
    got = SL.check_file(str(path))
    assert {f.rule for f in got} == {"SCHED-FULLBUF", "SCHED-BUCKETS"}
    assert all(f.location.startswith(str(path)) for f in got)
    assert SL.Program.from_json(prog.to_json()).records == prog.records
    doc["directives"] = []
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="no 'hvd-lint"):
        SL.check_file(str(path))
    # the CLI runs it through --schedule-file
    doc["directives"] = ["hvd-lint: no_full_buffer(384)"]
    path.write_text(json.dumps(doc))
    assert cli_main(["--schedule-file", str(path), "--no-allowlist"]) == 1


# ---------------------------------------------------------------------------
# Allowlist, CLI, findings
# ---------------------------------------------------------------------------


def test_allowlist_round_trip(tmp_path):
    path = tmp_path / "al.json"
    entries = [AL.Entry(rule="KNOB-RAW-ENV", location="pkg/a.py:*",
                        justification="because reasons",
                        match="HOROVOD_X")]
    path.write_text(json.dumps(
        {"schema": 1, "entries": [e.to_dict() for e in entries]}))
    loaded = AL.load(str(path))
    assert loaded == entries
    f_hit = Finding(rule="KNOB-RAW-ENV", severity="error",
                    location="pkg/a.py:12", message="raw HOROVOD_X read")
    f_miss = Finding(rule="KNOB-RAW-ENV", severity="error",
                     location="pkg/b.py:3", message="raw HOROVOD_X read")
    active, covered, used = AL.split([f_hit, f_miss], loaded)
    assert covered == [f_hit] and active == [f_miss] and used == {0}
    assert AL.stale_entries(loaded, set()) == loaded


def test_allowlist_requires_justification(tmp_path):
    path = tmp_path / "al.json"
    path.write_text(json.dumps({"schema": 1, "entries": [
        {"rule": "X", "location": "*", "justification": "  "}]}))
    with pytest.raises(AL.AllowlistError, match="no justification"):
        AL.load(str(path))
    path.write_text(json.dumps({"schema": 2, "entries": []}))
    with pytest.raises(AL.AllowlistError, match="schema"):
        AL.load(str(path))


def test_allowlist_lives_in_the_package():
    path = AL.default_path()
    assert path == os.path.join(REPO, "horovod_tpu_torch", "analysis",
                                "allowlist.json")
    entries = AL.load(path)
    assert entries and all(e.justification for e in entries)
    # no entry names a JAX-package path; runtime/aot_cache.py keys on
    # round0_cfg(), so no KNOB-AOT-KEY entry is left, and the knobs pass
    # over the real tree reports none
    assert all(e.location.startswith("horovod_tpu_torch/") for e in entries)
    assert not [e for e in entries if e.rule == "KNOB-AOT-KEY"]
    real = KL.run()
    assert not [f for f in real if f.rule == "KNOB-AOT-KEY"]


def test_cli_exit_codes_and_json_schema(capsys):
    args = ["knobs", "--package-dir", os.path.join(DATA, "bad_knobs"),
            "--json", "--no-allowlist"]
    rc = cli_main(args)
    doc = json.loads(capsys.readouterr().out)
    assert ref_cli(args) == rc == 1
    ref = json.loads(capsys.readouterr().out)
    assert doc["schema"] == ref["schema"] == 1
    assert doc["passes"] == ["knobs"]
    assert doc["summary"] == ref["summary"]
    assert doc["summary"]["active"] == 2
    assert set(doc) - {"skipped"} == set(ref)
    assert doc["skipped"] == []
    assert doc["findings"] == ref["findings"]
    for f in doc["findings"]:
        assert set(f) == {"rule", "severity", "location", "message",
                          "fix_hint", "pass", "allowlisted"}
    # unknown pass name -> usage error; hlo is the schedule pass
    assert cli_main(["nonsense"]) == 2
    capsys.readouterr()


def test_cli_green_on_real_tree_and_skips_the_bench_rule(capsys):
    rc = cli_main(["knobs", "concurrency", "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert doc["summary"]["active"] == 0
    assert doc["summary"]["allowlisted"] == len(AL.load(AL.default_path()))
    assert [s["rule"] for s in doc["skipped"]] == ["KNOB-BENCH-DRIFT"]
    assert KL.BENCHMARK_JSON in doc["skipped"][0]["reason"]


def test_cli_all_on_the_cpu_is_clean(capsys):
    """``all`` with the program set on the CPU: exit 0, nothing stale;
    ``hlo`` is accepted as the schedule pass's name."""
    assert cli_main(["all", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "CLEAN" in out and "ALLOWLIST-STALE" not in out
    assert cli_main(["hlo", "--device", "cpu", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["passes"] == ["schedule"]


def test_pass_registry_complete():
    assert set(PASSES) == {"schedule", "knobs", "concurrency"}


def test_findings_sort_and_render():
    a = Finding(rule="B-RULE", severity="warning", location="x:1",
                message="w")
    b = Finding(rule="A-RULE", severity="error", location="y:2",
                message="e", fix_hint="do it")
    assert sort_findings([a, b]) == [b, a]
    assert "fix: do it" in b.render()
    with pytest.raises(ValueError, match="severity"):
        Finding(rule="X", severity="meh", location="z", message="m")


# ---------------------------------------------------------------------------
# The real tree
# ---------------------------------------------------------------------------


def test_real_tree_knobs_green_after_allowlist():
    findings = KL.run()
    active, covered, _ = AL.split(findings, AL.load(AL.default_path()))
    assert active == [], "\n".join(f.render() for f in active)
    assert covered, "expected justified allowlisted findings"


def test_real_tree_cachekey_is_the_one_justified_latch():
    """Not the naive re-pointing's 28 vacuous findings: the data plane
    memoizes one knob-dependent value, the executor's fusion buffer."""
    got = [f for f in KL.run() if f.rule == "KNOB-CACHEKEY"]
    assert [(f.location.split(":")[0], "fusion_threshold" in f.message)
            for f in got] == [("horovod_tpu_torch/ops/eager_exec.py", True)]


def test_handshake_help_texts_say_so():
    from horovod_tpu_torch.common import config

    for name in ("bucket_compression", "compression", "overlap",
                 "overlap_chunks", "sharded_optimizer",
                 "zero_prefetch_chunks", "zero_stage"):
        assert "round-0 handshake" in config.knobs()[name].help, name
    assert not [f for f in KL.run() if f.rule.startswith("KNOB-HANDSHAKE")]


def test_real_tree_concurrency_green():
    assert CL.run() == []


def _auditor():
    from horovod_tpu_torch.analysis import repo_root

    root = repo_root()
    rels = []
    for sub in CL.SCAN_DIRS:
        base = os.path.join(root, "horovod_tpu_torch", sub)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", "csrc")]
            rels += [os.path.relpath(os.path.join(dirpath, f), root)
                     for f in filenames if f.endswith(".py")]
    return CL.Auditor(root, rels)


def test_signal_handler_reaches_flight_ring():
    auditor = _auditor()
    flight = "horovod_tpu_torch/runtime/flight.py"
    reach = auditor._reachable((flight, "", "_on_fatal_signal"))
    assert (flight, "FlightRecorder", "record") in reach
    assert auditor.locks[(flight, "FlightRecorder", "_lock")].kind == "RLock"
    roots = {(rel.split("/")[-1], name)
             for rel, _line, name, _keys in auditor.signal_roots()}
    assert roots == {("flight.py", "_on_fatal_signal"),
                     ("preemption.py", "_on_notice_signal"),
                     ("launcher.py", "<lambda>")}


def test_hot_locks_exist_under_their_names():
    auditor = _auditor()
    for mod, cls, attr in CL.HOT_LOCKS:
        hits = [lid for lid in auditor.locks if auditor._is_hot(lid)
                and lid[0] == mod and lid[2] == attr]
        assert hits, (mod, cls, attr)


def test_background_barrier_is_no_self_deadlock():
    """The reference's resolver reports ``BackgroundRuntime._exec_lock``
    re-acquired via ``barrier``; the executor's ``barrier()`` (the
    callee) takes no runtime lock, so the port's resolver drops the
    edge and the tree is clean."""
    from horovod_tpu_torch.analysis import repo_root

    auditor = _auditor()
    ref = RCL.Auditor(repo_root(), list(auditor.scans),
                      hot_locks=CL.HOT_LOCKS)
    bg = "horovod_tpu_torch/runtime/background.py"
    assert [f.location.split(":")[0] for f in ref.lock_order_findings()] \
        == [bg]
    assert auditor.lock_order_findings() == []
    callee = auditor._resolve_call(
        bg, "BackgroundRuntime",
        ast.parse("self.executor.barrier()").body[0].value.func)
    assert callee is None


# ---------------------------------------------------------------------------
# KNOB-CACHEKEY, KNOB-BENCH-DRIFT and KNOB-DEAD fixtures
# ---------------------------------------------------------------------------

MEMO_FIXTURE = textwrap.dedent("""\
    import functools

    from horovod_tpu_torch.common import config as _config

    _BOUNDS = {}


    def _split(n, k):
        return [n // k] * k


    def bucket_bounds(n):
        if n not in _BOUNDS:
            _BOUNDS[n] = _split(n, int(_config.get("overlap_chunks")))
        return _BOUNDS[n]


    def keyed_bounds(n):
        k = int(_config.get("overlap_chunks"))
        _BOUNDS[(n, k)] = _split(n, k)
        return _BOUNDS[(n, k)]


    @functools.lru_cache(maxsize=None)
    def block_layout(n):
        return n // int(_config.get("quant_block_size"))


    class Codec:
        def __init__(self):
            self._layout = None

        def layout(self, n):
            if self._layout is None:
                self._layout = block_layout(n)
            return self._layout
""")


def test_cachekey_flags_a_latched_knob(tmp_path):
    from horovod_tpu_torch.common import config

    (tmp_path / "ops").mkdir()
    (tmp_path / "ops" / "codec.py").write_text(MEMO_FIXTURE)
    mods = KL._Modules(str(tmp_path), ["ops/codec.py"])
    got = KL.memo_findings(mods, ["ops/codec.py"],
                           {"overlap_chunks", "quant_block_size"},
                           config.knobs())
    where = sorted((f.location, f.message.split("'")[1]) for f in got)
    assert where == [("ops/codec.py:14", "overlap_chunks"),
                     ("ops/codec.py:25", "quant_block_size"),
                     ("ops/codec.py:35", "quant_block_size")]
    assert all(f.rule == "KNOB-CACHEKEY" for f in got)
    # a knob outside the handshake is no hazard of this rule
    assert KL.memo_findings(mods, ["ops/codec.py"], set(),
                            config.knobs()) == []


def test_bench_drift_reads_the_ports_bench_script(tmp_path):
    from horovod_tpu_torch.common import config

    env_to_name = {k.env: n for n, k in config.knobs().items()}
    # no manifest: nothing read, and the CLI says the rule was skipped
    assert KL.bench_drift(str(tmp_path), env_to_name) == []
    assert [s["rule"] for s in KL.skipped(str(tmp_path))] == \
        ["KNOB-BENCH-DRIFT"]
    # a manifest that names no script in the checkout is a finding
    manifest = tmp_path / KL.BENCHMARK_JSON
    manifest.write_text(json.dumps({"command": "python missing.py"}))
    got = KL.bench_drift(str(tmp_path), env_to_name)
    assert [(f.rule, f.location) for f in got] == \
        [("KNOB-BENCH-DRIFT", KL.BENCHMARK_JSON)]
    assert KL.skipped(str(tmp_path)) == []
    # the scripts the manifest names are read, wherever they are
    (tmp_path / "bench").mkdir()
    (tmp_path / "bench" / "harness.py").write_text(
        "ENV = ['HOROVOD_OVERLAP', 'HOROVOD_RANK', 'HOROVOD_BENCH_X',\n"
        "       'HOROVOD_MADE_UP']\n")
    manifest.write_text(json.dumps(
        {"paths": {"harness": "bench/harness.py"},
         "workloads": [{"command": "python bench/harness.py --cell a"}]}))
    assert KL.bench_scripts(str(tmp_path)) == ["bench/harness.py"]
    got = KL.bench_drift(str(tmp_path), env_to_name)
    assert [(f.rule, f.location) for f in got] == \
        [("KNOB-BENCH-DRIFT", "bench/harness.py:2")]
    assert "HOROVOD_MADE_UP" in got[0].message
    assert KL.skipped(str(tmp_path)) == []


def test_knob_dead_rule_flags_readerless_knob(monkeypatch):
    from horovod_tpu_torch.common import config as _cfg

    fake = dict(_cfg._KNOBS)
    fake["phantom_knob"] = _cfg.Knob(
        "HOROVOD_PHANTOM_KNOB", 0, int,
        help="must agree on every rank (validated at the round-0 "
             "handshake).")
    monkeypatch.setattr(_cfg, "_KNOBS", fake)
    findings = KL.run()
    dead = [f for f in findings if f.rule == "KNOB-DEAD"]
    assert dead and all("phantom_knob" in f.message for f in dead)
    missing = [f for f in findings if f.rule == "KNOB-HANDSHAKE-MISSING"]
    assert [("phantom_knob" in f.message) for f in missing] == [True]


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------


def _spawn(n: int) -> list:
    sys.path.insert(0, os.path.dirname(__file__))
    from _torch_collectives_worker import spawn

    return spawn(n, "cpu", timeout=240, mode="schedule")


def test_recorder_c10d_ranks_on_a_gloo_world_of_two():
    outs = _spawn(2)
    for r, o in enumerate(outs):
        b = o["basic"]
        assert b["hop"] == [["all-reduce", [0, 1]],
                            ["reduce-scatter", [0, 1]],
                            ["all-gather", [0, 1]]]
        # the hop's own c10d ops carry the world's ranks, and the
        # subgroup's op its one member
        want = b["hop"] + ([["all-reduce", [1]]] if r == 1 else [])
        assert b["c10d"] == want
        assert b["sum"] == [3.0] * 16


def test_recorder_presets_on_a_gloo_world_of_four():
    """The CPU twin of ``test_four_cards_schedule_lint``: (cross 2,
    local 2), every preset clean, every control flagged, the ``c10d``
    records' ranks equal to the hops'."""
    outs = _spawn(4)
    want = {"zero2": [], "zero1-control": ["SCHED-FULLBUF"],
            "overlap": [],
            "overlap-off-control": ["SCHED-MESH-PLACEMENT",
                                    "SCHED-MONOLITHIC"],
            "hier-int8": [], "flat-int8-control": ["SCHED-LOSSY-PLACEMENT"],
            "localsgd-inner": [], "localsgd-outer": [],
            "localsgd-inner-control": ["SCHED-LOCALSGD-INNER"],
            "localsgd-outer-control": ["SCHED-LOCALSGD-OUTER"]}
    for r, o in enumerate(outs):
        c, l_ = divmod(r, 2)
        assert {k: o[k]["rules"] for k in want} == want
        for k, v in o.items():
            if k in ("rank", "basic") or "hop" not in v:
                continue
            assert v["c10d"] == v["hop"], k
            assert v["kernels"] == {}, k      # the CPU runs plain versions
        inner = {tuple(x[1]) for x in o["localsgd-inner"]["hop"]}
        assert inner == {(2 * c, 2 * c + 1)}
        cross = {tuple(x[1]) for x in o["localsgd-outer"]["hop"]
                 if x[1] == [l_, 2 + l_]}
        assert cross


@pytest.fixture(scope="module")
def program_set():
    progs = {}
    t0 = time.perf_counter()
    found = programs.run(device="cpu", programs=progs)
    return found, progs, time.perf_counter() - t0


def test_program_set_clean_on_the_cpu_within_a_minute(program_set):
    found, progs, seconds = program_set
    assert found == [], "\n".join(f.render() for f in found)
    assert seconds < 60, seconds
    assert set(progs) == {"zero2-update", "zero1-control", "zero3-forward",
                          "overlap", "overlap-off", "hier-int8",
                          "hier-topk", "flat-lossy", "mesh-dp-z0",
                          "mesh-dp-z2"}
    assert all(len(v) == 8 for v in progs.values())


def test_emulated_hops_are_recorded(program_set):
    """The emulated hops issue no c10d op; their transfers are recorded
    with the hop's ranks: int8 only on the cross hop (r, r + 4), the
    local hop's transfers float32 over (4c .. 4c + 3)."""
    _, progs, _ = program_set
    for r, prog in enumerate(progs["hier-int8"]):
        c, l_ = divmod(r, 4)
        hops = prog.collectives()
        assert hops and all(x.via == "hop" for x in hops)
        assert not [x for x in prog.records if x.via == "c10d"]
        s8 = [x for x in hops if x.shapes[0].dtype == "s8"]
        assert s8 and all(x.ranks == (l_, l_ + 4) for x in s8)
        local = [x for x in hops if x.ranks == tuple(range(4 * c, 4 * c + 4))]
        assert local and all(x.shapes[0].dtype == "f32" for x in local)
    for prog in progs["mesh-dp-z2"]:
        assert {len(x.ranks) for x in prog.collectives()} == {4}
    # the inputs are marked, and exempt from the full-buffer rule
    assert [x.opcode for x in progs["zero2-update"][0].records[:4]] == \
        ["parameter"] * 4


def test_allowlist_every_entry_used(program_set):
    entries = AL.load(AL.default_path())
    findings = KL.run() + CL.run() + program_set[0]
    _active, _covered, used = AL.split(findings, entries)
    stale = AL.stale_entries(entries, used)
    assert stale == [], [e.to_dict() for e in stale]


def test_kernel_launch_records_are_counted():
    """One record per launch, at every point that counts ``LAUNCHES``
    (pybind calls pass no dispatcher); nothing when no recorder is
    open."""
    from horovod_tpu_torch.common import events

    counts = collections.Counter()
    with SL.record(1) as prog:
        events.note_launch(counts, "fused_update", "momentum")
        events.note_launch(counts, "quantization", "quantize", 3)
    assert [r.opcode for r in prog.kernels()] == \
        ["hvd.fused_update.momentum"] + ["hvd.quantization.quantize"] * 3
    assert SL.check_program(prog, [SL.single_fused_kernel(1)]) == []
    assert events._open == 0
    events.note_launch(counts, "fused_update", "momentum")  # closed: counted
    assert len(prog.kernels()) == 4
    assert counts == {"momentum": 2, "quantize": 3}
    # every wrapper counts its launches through the one hook
    for rel in ("optim/fused_update.py", "ops/quantization.py",
                "ops/batch_norm.py", "ops/flash_attention.py"):
        tree = ast.parse(open(os.path.join(REPO, "horovod_tpu_torch",
                                           rel)).read())
        bumps = [n for n in ast.walk(tree) if isinstance(n, ast.AugAssign)
                 and isinstance(n.target, ast.Subscript)
                 and getattr(n.target.value, "id", "") == "LAUNCHES"]
        notes = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
                 and getattr(n.func, "attr", "") == "note_launch"]
        assert bumps == [] and notes, rel
        assert all(getattr(n.args[0], "id", "") == "LAUNCHES"
                   for n in notes), rel


def test_one_transfer_hook_feeds_the_byte_count_and_the_recorder():
    """A hop's transfer is one call: its payload's bytes go to the open
    ``counting_sent`` block and its record to the open recorder; a hop
    of one rank is counted and not recorded."""
    import types

    import torch

    from horovod_tpu_torch.common import events

    pair = types.SimpleNamespace(ranks=(4, 6))
    alone = types.SimpleNamespace(ranks=(4,))
    x, y, q, z = (torch.ones(8), torch.ones(4),
                  torch.ones(2, dtype=torch.int8), torch.ones(2))
    with events.counting_sent() as sent, SL.record(2) as prog:
        events.note_transfer(pair, "reduce-scatter", x, y)
        events.note_transfer(pair, "collective-permute", None, q, [(1, 0)])
        events.note_transfer(alone, "all-reduce", z)
    assert sent == [8 * 4 + 2 * 4]
    assert [(r.opcode, r.shapes, r.ranks, r.pairs) for r in prog.records
            if r.via == "hop"] == [("reduce-scatter", (SL.Shape("f32", (4,)),), (4, 6), ()),
            ("collective-permute", (SL.Shape("s8", (2,)),), (4, 6),
             ((6, 4),))]
    n = len(prog.records)
    with events.counting_sent() as sent:             # no recorder open
        events.note_transfer(pair, "all-reduce", torch.ones(3))
    assert sent == [12] and len(prog.records) == n


def test_the_data_plane_does_not_import_the_lint_package():
    """The hops, the emulated transport and the kernel wrappers report
    to ``common/events.py``; the recorder installs itself there, so the
    data plane loads nothing of ``analysis/``."""
    code = ("import sys\n"
            "import horovod_tpu_torch.parallel.mesh\n"
            "import horovod_tpu_torch.parallel.emulated\n"
            "import horovod_tpu_torch.ops.quantization\n"
            "import horovod_tpu_torch.ops.batch_norm\n"
            "import horovod_tpu_torch.ops.flash_attention\n"
            "import horovod_tpu_torch.optim.fused_update\n"
            "import horovod_tpu_torch.runtime.background\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.startswith('horovod_tpu_torch.analysis')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_recorder_sees_aten_ops_with_shapes():
    import torch

    x = torch.ones(4, 96)
    with SL.record(4, inputs=[x]) as prog:
        y = (x * 2).reshape(-1)
        torch.cat([y, y])
    ops = [(r.opcode, r.shapes) for r in prog.records]
    assert ops[0] == ("parameter", (SL.Shape("f32", (4, 96)),))
    assert ("aten.mul", (SL.Shape("f32", (4, 96)),)) in ops
    assert ("aten.cat", (SL.Shape("f32", (768,)),)) in ops
    assert SL.check_program(prog, [SL.no_full_buffer(384)]) != []
    assert SL.check_program(prog, [SL.no_full_buffer(768 * 2)]) == []


# ---------------------------------------------------------------------------
# Round 0 (tests/test_analysis.py:446-515) against the port's round0_cfg;
# the AOT-cache case waits for the port's AOT cache (ROADMAP Queue A)
# ---------------------------------------------------------------------------


def test_round0_cfg_carries_hierarchical_and_ragged(monkeypatch):
    from horovod_tpu_torch.runtime import controller as ctl

    for env in ("HOROVOD_HIERARCHICAL_ALLREDUCE",
                "HOROVOD_HIERARCHICAL_ALLGATHER",
                "HOROVOD_HIERARCHICAL_LOCAL_SIZE",
                "HOROVOD_RAGGED_ALLGATHER"):
        monkeypatch.delenv(env, raising=False)
    base = ctl.round0_cfg()
    assert len(base) == len(ctl.ROUND0_KNOB_ENVS)
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLREDUCE", "1")
    assert ctl.round0_cfg() != base
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_LOCAL_SIZE", "4")
    with_ls = ctl.round0_cfg()
    assert with_ls != base and with_ls[17] == 4
    monkeypatch.delenv("HOROVOD_HIERARCHICAL_ALLREDUCE")
    assert ctl.round0_cfg() == base
    monkeypatch.setenv("HOROVOD_RAGGED_ALLGATHER", "psum")
    assert ctl.round0_cfg() != base
    monkeypatch.setenv("HOROVOD_RAGGED_ALLGATHER", "pad")
    assert ctl.round0_cfg()[18] == 2
    monkeypatch.setenv("HOROVOD_RAGGED_ALLGATHER", "tyop")
    assert ctl.round0_cfg()[18] >= 256


def test_round0_mismatch_message_derived_from_vector():
    from horovod_tpu_torch.common import config as _cfg
    from horovod_tpu_torch.runtime import controller as ctl

    envs = {k.env for k in _cfg.knobs().values()}
    assert set(ctl.ROUND0_KNOB_ENVS) <= envs
    assert "HOROVOD_HIERARCHICAL_ALLREDUCE" in ctl.ROUND0_KNOB_ENVS
    assert "HOROVOD_RAGGED_ALLGATHER" in ctl.ROUND0_KNOB_ENVS


def test_config_is_set(monkeypatch):
    from horovod_tpu_torch.common import config

    monkeypatch.delenv("HOROVOD_ZERO_STAGE", raising=False)
    assert not config.is_set("zero_stage")
    monkeypatch.setenv("HOROVOD_ZERO_STAGE", "")
    assert not config.is_set("zero_stage")
    monkeypatch.setenv("HOROVOD_ZERO_STAGE", "  ")
    assert not config.is_set("zero_stage")
    monkeypatch.setenv("HOROVOD_ZERO_STAGE", "2")
    assert config.is_set("zero_stage")


def test_raw_reads_moved_behind_the_registry(monkeypatch):
    """The repairs the knob pass drove: the flight ring's capacity and
    dump dir, and the coordinator address, read through ``config``."""
    from horovod_tpu_torch.common import config
    from horovod_tpu_torch.runtime import flight

    monkeypatch.setenv("HOROVOD_FLIGHT_EVENTS", "17")
    monkeypatch.setenv("HOROVOD_FLIGHT_DIR", "/x/y")
    assert flight._capacity() == 17 and flight.flight_dir() == "/x/y"
    monkeypatch.setenv("HOROVOD_FLIGHT_EVENTS", "junk")
    assert flight._capacity() == 4096
    monkeypatch.setenv("HOROVOD_COORDINATOR_ADDR", "h:1")
    assert config.get("coordinator_addr") == "h:1"
    raw = {(f.location.split(":")[0], f.message.split()[3])
           for f in KL.run() if f.rule == "KNOB-RAW-ENV"}
    assert not {e for _, e in raw} & {"HOROVOD_FLIGHT_EVENTS",
                                      "HOROVOD_FLIGHT_DIR",
                                      "HOROVOD_COORDINATOR_ADDR"}


def test_analysis_imports_no_jax():
    code = ("import sys, horovod_tpu_torch.analysis, "
            "horovod_tpu_torch.analysis.__main__, "
            "horovod_tpu_torch.analysis.programs; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'horovod_tpu')]; "
            "print(bad)")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
