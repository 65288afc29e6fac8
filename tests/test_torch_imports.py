"""The port stands alone and runs on the GPU unless asked otherwise.

``horovod_tpu_torch`` and every submodule import neither ``jax`` nor the
JAX package (checked in a fresh interpreter: this test session has both
loaded already). The entry points default to ``cuda:<local rank>`` and
raise when no GPU is there, unless the caller passes ``device="cpu"``.
"""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PURITY = r"""
import importlib, pkgutil, sys
import horovod_tpu_torch
names = [m.name for m in pkgutil.walk_packages(horovod_tpu_torch.__path__,
                                                "horovod_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("parallel", "parallel.mesh", "parallel.ring_attention",
             "parallel.ulysses", "parallel.moe", "parallel.pipeline",
             "models.image_layers", "models.resnet", "models.vgg",
             "models.inception", "image_bench", "zero", "checkpoint",
             "ops.adasum", "ops.eager", "common.native", "common.metrics",
             "common.logging"):
    assert "horovod_tpu_torch." + name in names, name
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                           "horovod_tpu"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "HVD_PALLAS_INTERPRET")}
    proc = subprocess.run([sys.executable, "-c", _PURITY], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 18, proc.stdout


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_init_defaults_to_cuda(no_gpu):
    import horovod_tpu_torch as hvd

    with pytest.raises(hvd.NotInitializedError, match="required by size"):
        hvd.size()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hvd.init()
    assert not hvd.is_initialized()
    hvd.init(device="cpu")
    try:
        assert hvd.device() == torch.device("cpu")
        assert (hvd.size(), hvd.rank(), hvd.local_rank()) == (1, 0, 0)
    finally:
        hvd.shutdown()


def test_model_defaults_to_cuda(no_gpu):
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Transformer(TransformerConfig(n_layers=1))
    model = Transformer(TransformerConfig(n_layers=1), device="cpu")
    assert next(model.parameters()).device == torch.device("cpu")


@pytest.mark.parametrize("ctor,small", [
    ("resnet.ResNet50", dict(num_filters=8)),
    ("vgg.VGG16", dict(num_filters=(8,) * 5, dense_width=16, image_size=32)),
    ("inception.InceptionV3", {})])
def test_image_model_defaults_to_cuda(no_gpu, ctor, small):
    import importlib

    module, cls = ctor.split(".")
    model_cls = getattr(importlib.import_module(
        f"horovod_tpu_torch.models.{module}"), cls)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_cls(**small)
    model = model_cls(num_classes=10, device="cpu", **small)
    assert next(model.parameters()).device == torch.device("cpu")


def test_bench_defaults_to_cuda(no_gpu):
    from horovod_tpu_torch import transformer_bench

    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer_bench.main(["--n-layers", "1", "--num-iters", "1"])


def test_image_bench_defaults_to_cuda(no_gpu):
    from horovod_tpu_torch import image_bench

    with pytest.raises(RuntimeError, match="device='cpu'"):
        image_bench.main(["--image-size", "32", "--batch-size", "1",
                          "--num-iters", "1"])


def test_default_device_is_the_local_rank_gpu(monkeypatch):
    from horovod_tpu_torch.common.state import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("HOROVOD_LOCAL_RANK", "2")
    assert resolve_device() == torch.device("cuda", 2)
    monkeypatch.setenv("HOROVOD_LOCAL_RANK", "4")
    with pytest.raises(RuntimeError, match="local rank 4 has no GPU"):
        resolve_device()


def test_bench_runs_on_the_cpu_when_asked(capsys):
    import json

    from horovod_tpu_torch import transformer_bench

    transformer_bench.main(["--device", "cpu", "--d-model", "32",
                            "--n-heads", "2", "--n-layers", "1", "--vocab",
                            "64", "--seq-len", "16", "--num-warmup", "1",
                            "--num-iters", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["platform"] == "cpu" and "mfu" not in line
    assert line["mesh"] == {"dp": 1, "pp": 1, "sp": 1, "tp": 1}
    assert set(line) >= {"metric", "value", "unit", "device_kind", "n_params",
                         "n_matmul_params", "loss", "step_ms"}
