"""The port's transformer LM example on the CPU through the port's
launcher: its printed losses against the JAX package's
``examples/transformer_lm.py`` at the reference test's sizes (one
process, one device), a world of 4 at dp 1 x tp 2 x sp 2, and the
refusal of a world other than dp * pp * tp * sp.

Tolerance: the printed "step i loss" values within rel 2e-2, the
bfloat16 loss tolerance of ``tests/test_torch_transformer.py`` (the
model computes in bfloat16, which the two frameworks round at
different places)."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--steps", "6", "--d-model", "32", "--seq", "16", "--batch", "4",
         "--n-layers", "1"]
LOSS_RTOL = 2e-2

pytestmark = pytest.mark.multiprocess


def _env(**extra) -> dict:
    env = dict(os.environ)
    env.update({"HOROVOD_PLATFORM": "cpu", "OMP_NUM_THREADS": "1",
                "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", "")})
    env.update(extra)
    return env


def _port(np_: int, *args: str, ok: bool = True):
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(np_),
         sys.executable, "-m", "horovod_tpu_torch.examples.transformer_lm",
         *args], env=_env(), cwd=REPO, capture_output=True, text=True,
        timeout=300)
    if ok:
        assert proc.returncode == 0, (proc.stdout[-4000:],
                                      proc.stderr[-4000:])
    return proc


def _losses(out: str) -> dict:
    return {int(i): float(v)
            for i, v in re.findall(r"step (\d+) loss ([0-9.]+)", out)}


def test_losses_match_the_reference_example():
    ref = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "transformer_lm.py"),
         "--dp", "1", "--tp", "1", "--sp", "1", "--pp", "1", *SMALL],
        env=_env(HOROVOD_SIZE="1",
                 XLA_FLAGS="--xla_force_host_platform_device_count=1"),
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, (ref.stdout[-4000:], ref.stderr[-4000:])
    out = _port(1, "--dp", "1", "--tp", "1", "--sp", "1", "--pp", "1",
                *SMALL).stdout
    want, got = _losses(ref.stdout), _losses(out)
    assert sorted(want) == sorted(got) == [0, 5], (ref.stdout, out)
    for i in want:
        assert got[i] == pytest.approx(want[i], rel=LOSS_RTOL), (i, got,
                                                                 want)
    assert "mesh: dp=1 pp=1 tp=1 sp=1 (1 devices)" in out
    assert re.search(r"\d+ tokens/sec \([0-9.]+ ms/step\)", out)


def test_tp2_sp2_over_four_ranks():
    out = _port(4, "--dp", "1", "--tp", "2", "--sp", "2", *SMALL).stdout
    assert "mesh: dp=1 pp=1 tp=2 sp=2 (4 devices)" in out
    assert sorted(_losses(out)) == [0, 5], out
    assert "tokens/sec" in out


def test_a_mismatched_world_is_refused():
    proc = _port(2, "--dp", "1", "--tp", "2", "--sp", "2", *SMALL,
                 ok=False)
    assert proc.returncode != 0
    assert "need 4 devices for dp*pp*tp*sp, have 2" in proc.stderr
