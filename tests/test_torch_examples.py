"""The port's example scripts (``horovod_tpu_torch/examples/``) run on
the CPU through the port's launcher at 2 ranks, with the JAX package's
test arguments (``tests/test_examples.py``), and print the reference
scripts' lines; the imagenet script resumes from its checkpoint; its LR
schedule equals the reference's at every step.  The LM example's tests
are in ``tests/test_torch_examples_lm.py`` (a file of its own so that
``--dist loadfile`` gives them another worker)."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.multiprocess


def run_example(script: str, *args: str, np_: int = 2, by_path=False,
                timeout: int = 300) -> str:
    """Launch ``horovod_tpu_torch/examples/<script>.py`` on ``np_`` CPU
    ranks (as a module, or by path); its standard output."""
    env = dict(os.environ)
    env.update({"HOROVOD_PLATFORM": "cpu", "OMP_NUM_THREADS": "1",
                "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", "")})
    target = ([os.path.join(REPO, "horovod_tpu_torch", "examples",
                            f"{script}.py")] if by_path else
              ["-m", f"horovod_tpu_torch.examples.{script}"])
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(np_),
         sys.executable, *target, *args],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (proc.stdout[-4000:], proc.stderr[-4000:])
    return proc.stdout


def test_pytorch_mnist_example():
    out = run_example("pytorch_mnist", "--epochs", "1", "--steps", "3")
    assert "epoch 0 step 0 loss" in out
    assert "epoch 0 mean loss across ranks" in out


def test_jax_mnist_example():
    out = run_example("jax_mnist", "--epochs", "1", "--steps", "3",
                      by_path=True)
    assert "epoch 0 step 0/3 loss" in out
    assert "epoch 0 mean loss across ranks" in out


def test_pytorch_synthetic_benchmark_example():
    out = run_example("pytorch_synthetic_benchmark", "--batch-size", "2",
                      "--num-iters", "1", "--num-batches-per-iter", "1",
                      by_path=True)
    assert "Batch size: 2, ranks: 2" in out
    assert "Iter #0:" in out and "img/sec per rank" in out
    assert "Total img/sec on 2 rank(s)" in out


@pytest.mark.parametrize("fp16", [False, True], ids=["none", "fp16"])
def test_jax_synthetic_benchmark_example(fp16):
    out = run_example("jax_synthetic_benchmark", "--model", "SmallCNN",
                      "--batch-size", "1", "--num-iters", "1",
                      "--num-batches-per-iter", "1",
                      "--num-warmup-batches", "1",
                      *(["--fp16-allreduce"] if fp16 else []))
    assert "Model: SmallCNN" in out
    assert "Batch size: 1 per device, 2 device(s)" in out
    assert "Img/sec per device" in out
    assert "Total img/sec on 2 device(s)" in out


@pytest.mark.parametrize("wire", [[], ["--use-adasum", "--fp16-allreduce"]],
                         ids=["average", "adasum_fp16"])
def test_jax_imagenet_resnet50_example_resumes(tmp_path, wire):
    """The reference test's run: epoch 0, a checkpoint, ``done``; a
    second invocation with ``--epochs 2`` resumes from epoch 1."""
    args = ["--synthetic", "--epochs", "1", "--steps-per-epoch", "2",
            "--batch-size", "2", "--val-batch-size", "2",
            "--image-size", "32", "--num-classes", "10",
            "--model", "ResNet18", "--checkpoint-dir",
            str(tmp_path / "ckpts"), *wire]
    out = run_example("jax_imagenet_resnet50", *args)
    assert "epoch 0: train_loss" in out and "done" in out
    assert "resumed" not in out
    args[2] = "2"  # --epochs 2
    out = run_example("jax_imagenet_resnet50", *args)
    assert "resumed from epoch 1" in out
    assert "epoch 1: train_loss" in out and "epoch 0:" not in out
    assert "done" in out


def _reference_imagenet():
    spec = importlib.util.spec_from_file_location(
        "_reference_jax_imagenet_resnet50",
        os.path.join(REPO, "examples", "jax_imagenet_resnet50.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("size", [1, 4])
@pytest.mark.parametrize("steps_per_epoch", [2, 3, 100])
def test_lr_schedule_matches_the_reference(monkeypatch, size,
                                           steps_per_epoch):
    """``make_lr_schedule`` against the reference's at every step of 2
    epochs (the warmup) and at the decay boundaries, bit for bit, both
    at the optimizer's int32 count."""
    from horovod_tpu_torch.examples import jax_imagenet_resnet50 as port

    ref = _reference_imagenet()
    monkeypatch.setattr(ref.hvd, "size", lambda: size)
    monkeypatch.setattr(port.hvd, "size", lambda: size)
    args = port.parse_args(["--warmup-epochs", "1.5"])
    spe = steps_per_epoch
    a = ref.make_lr_schedule(args, spe)
    b = port.make_lr_schedule(args, spe)
    steps = list(range(2 * spe + 1)) + [
        e * spe + d for e in (30, 60, 80) for d in (-1, 0, 1)] + [90 * spe]
    want = np.array([np.asarray(a(jnp.int32(s))) for s in steps])
    got = np.array([b(s) for s in steps])
    assert want.dtype == got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
