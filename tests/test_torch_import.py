"""``horovod_tpu_torch`` stands alone: importing every module of it pulls
in no JAX-side module (``jax``, ``jaxlib``, ``flax``, ``optax``, or
``horovod_tpu`` itself), and its entry points refuse to run on a machine
without a GPU unless the caller asks for the CPU."""

import json
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import horovod_tpu_torch
mods = ["horovod_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(horovod_tpu_torch.__path__,
                                          "horovod_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
banned = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in banned)
print(json.dumps({"modules": mods, "bad": bad}))
"""


def test_no_jax_side_module_is_imported():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [], res["bad"]
    # every module of the slice was imported
    for m in ("common.types", "common.logging", "common.config",
              "common.util", "common.basics", "ops.compression",
              "ops.collectives", "optim.fused_update", "optim.distributed",
              "models.resnet", "interop", "train_step", "_build",
              "ops.flash_attention", "parallel.ring_attention",
              "models.transformer", "ops.quantization", "models.layers",
              "models.mnist", "models.vgg", "models.inception",
              "ops.batch_norm", "parallel.mesh", "parallel.ulysses",
              "runtime.wire", "runtime.cache", "runtime.stall",
              "runtime.controller", "runtime.background", "ops.eager",
              "ops.eager_exec", "torch", "torch.mpi_ops",
              "torch.compression", "runtime.flight", "runtime.metrics",
              "runtime.faults", "perf", "perf.goodput", "perf.__main__",
              "perf.kineto", "perf.attribution", "perf.capture",
              "perf.report", "perf.compare",
              "trace", "trace.merge", "trace.analyze", "trace.perfetto",
              "trace.__main__", "runtime.health", "checkpoint",
              "runtime.kvstore", "runtime.preemption", "runtime.simfleet",
              "elastic", "run",
              "run.__main__", "run.launcher", "run.pod", "run.exec_fn",
              "analysis", "analysis.findings", "analysis.allowlist",
              "analysis.knob_lint", "analysis.concurrency_lint",
              "analysis.schedule_lint", "analysis.programs",
              "analysis.__main__", "parallel.emulated", "common.events"):
        assert f"horovod_tpu_torch.{m}" in res["modules"]


def test_package_shares_no_code_with_the_jax_package():
    import horovod_tpu_torch

    for m in pkgutil.walk_packages(horovod_tpu_torch.__path__,
                                   "horovod_tpu_torch."):
        path = os.path.join(REPO, *m.name.split(".")) + (
            os.sep + "__init__.py" if m.ispkg else ".py")
        with open(path) as f:
            src = f.read()
        for word in ("import jax", "from jax", "import flax", "import optax",
                     "from horovod_tpu import", "from horovod_tpu.",
                     "import horovod_tpu\n", "import horovod_tpu."):
            assert word not in src, f"{m.name} has {word!r}"


@pytest.mark.parametrize("entry", ["init", "ResNet50", "synthetic_batch",
                                   "Transformer", "synthetic_tokens",
                                   "VGG16", "InceptionV3", "SmallCNN",
                                   "MnistCNN", "schedule_pass"])
def test_entry_points_raise_without_a_gpu(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # the suite's conftest exports HOROVOD_PLATFORM=cpu, which init()
    # honours as an explicit request for the CPU: this holds the default
    monkeypatch.delenv("HOROVOD_PLATFORM", raising=False)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.inception import InceptionV3
    from horovod_tpu_torch.models.mnist import MnistCNN, SmallCNN
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.models.vgg import VGG16
    from horovod_tpu_torch.analysis import programs
    from horovod_tpu_torch.train_step import synthetic_batch, synthetic_tokens

    small = TransformerConfig(vocab=16, d_model=16, n_heads=2, head_dim=8,
                              n_layers=1, d_ff=16, max_seq=8)
    call = {"init": hvd.init,
            "ResNet50": lambda: ResNet50(num_filters=8),
            "synthetic_batch": lambda: synthetic_batch(2, 8),
            "Transformer": lambda: Transformer(small),
            "synthetic_tokens": lambda: synthetic_tokens(2, 8, 16),
            "VGG16": lambda: VGG16(widths=(8, 8, 8, 8, 8), image_size=32),
            "InceptionV3": lambda: InceptionV3(num_classes=10),
            "SmallCNN": lambda: SmallCNN(num_classes=10),
            "MnistCNN": lambda: MnistCNN(),
            "schedule_pass": programs.run}[entry]
    with pytest.raises(hvd.HorovodTpuError, match="device='cpu'"):
        call()
    assert not hvd.is_initialized()


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """A wrapper given a CUDA tensor launches its kernel or raises; it
    never computes the plain version instead.  Without a card this
    shows as the build failing loudly (no nvcc), not as a result."""
    from horovod_tpu_torch import _build
    from horovod_tpu_torch.common.types import HorovodTpuError
    from horovod_tpu_torch.optim import fused_update as TF

    calls = []
    monkeypatch.setattr(TF, "sgd_plain",
                        lambda *a, **k: calls.append(a) or a[0])
    monkeypatch.setattr(TF, "_lib", None)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")

    g = torch.zeros(4)
    monkeypatch.setattr(type(g), "device",
                        property(lambda self: torch.device("cuda", 0)))
    with pytest.raises(HorovodTpuError, match="nvcc not found"):
        TF.sgd_update(g, 1, -0.1)
    assert calls == []


@pytest.mark.parametrize("wrapper", ["flash_block_step", "flash_bwd_dq",
                                     "flash_bwd_dkv"])
def test_cuda_attention_tensor_never_takes_the_plain_version(wrapper,
                                                             monkeypatch):
    """The same for the attention wrappers B8-B10."""
    from horovod_tpu_torch import _build
    from horovod_tpu_torch.common.types import HorovodTpuError
    from horovod_tpu_torch.ops import flash_attention as FA

    calls = []
    monkeypatch.setattr(FA, f"{wrapper}_plain",
                        lambda *a, **k: calls.append(a) or a[0])
    monkeypatch.setattr(FA, "_lib", None)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")

    x = torch.zeros(2, 8, 8)
    row = torch.zeros(2, 8)
    monkeypatch.setattr(type(x), "device",
                        property(lambda self: torch.device("cuda", 0)))
    args = ((x, x, x, row, row, x) if wrapper == "flash_block_step"
            else (x, x, x, x, row, row))
    with pytest.raises(HorovodTpuError, match="nvcc not found"):
        getattr(FA, wrapper)(*args, 0, 0)
    assert calls == []


@pytest.mark.parametrize("wrapper", ["quantize_values", "dequantize_values",
                                     "quantize_pack4_values",
                                     "unpack_dequantize4_values"])
def test_cuda_codec_tensor_never_takes_the_plain_version(wrapper,
                                                         monkeypatch):
    """The same for the codec wrappers B4-B7, and for the compressors'
    round trip that calls them."""
    from horovod_tpu_torch import _build
    from horovod_tpu_torch.common.types import HorovodTpuError
    from horovod_tpu_torch.ops import quantization as Q

    calls = []
    for name in ("quantize_plain", "dequantize_plain",
                 "quantize_pack4_plain", "unpack_dequantize4_plain"):
        monkeypatch.setattr(Q, name, lambda *a, **k: calls.append(a) or a[0])
    monkeypatch.setattr(Q, "_lib", None)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")

    x = torch.zeros(4, 256)
    q = torch.zeros(4, 256, dtype=torch.int8)
    s = torch.ones(4)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    args = {"quantize_values": (x, s), "dequantize_values": (q, s),
            "quantize_pack4_values": (x, s),
            "unpack_dequantize4_values": (q[:, :128].contiguous(), s)}
    with pytest.raises(HorovodTpuError, match="nvcc not found"):
        getattr(Q, wrapper)(*args[wrapper])
    assert calls == []


@pytest.mark.parametrize("platform,device", [("cpu", "cpu"), ("CPU", "cpu"),
                                             ("gpu", None), ("", None)])
def test_platform_knob_is_an_explicit_cpu_request(platform, device,
                                                  monkeypatch):
    """``HOROVOD_PLATFORM=cpu`` makes ``init()`` place the rank on the
    CPU (gloo); unset or naming the GPU it leaves ``cuda``, which raises
    without a card."""
    import horovod_tpu_torch as hvd

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k in ("HOROVOD_SIZE", "HOROVOD_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_PLATFORM", platform)
    hvd.shutdown()
    try:
        if device is None:
            with pytest.raises(hvd.HorovodTpuError, match="device='cpu'"):
                hvd.init()
        else:
            hvd.init()
            assert hvd.device().type == device
            import torch.distributed as dist

            assert dist.get_backend() == "gloo"
    finally:
        hvd.shutdown()

