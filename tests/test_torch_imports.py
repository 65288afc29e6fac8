"""The port stands alone and runs on the GPU unless asked otherwise.

``horovod_tpu_torch`` and every submodule import neither ``jax`` nor the
JAX package (checked in a fresh interpreter: this test session has both
loaded already). The modules that need no TensorFlow, imported first,
load neither cloudpickle nor PyYAML, which the launcher imports only when
``run()`` or ``--config-file`` asks for them (TensorFlow itself loads
cloudpickle). TensorFlow tries
``from jax import jit`` when it is imported and goes on without it, so
the interpreter first installs an import hook that refuses ``jax``,
``jaxlib`` and ``horovod_tpu``: TensorFlow takes its own ``ImportError``
branch, and a port module that imported any of them fails. The entry points default to ``cuda:<local rank>`` and
raise when no GPU is there, unless the caller passes ``device="cpu"``.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import torch_worlds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PURITY = torch_worlds.REFUSE_JAX + r"""
import importlib, os, pkgutil, subprocess

# No import builds anything: the native core, the kernels and the
# sanitizer stress harness (csrc/testing) are built by calls only.
_popen = subprocess.Popen.__init__


def _no_compiler(self, args, *a, **k):
    argv = [args] if isinstance(args, (str, bytes)) else list(args)
    tool = os.path.basename(str(argv[0])) if argv else ""
    assert not tool.endswith(("g++", "gcc", "nvcc", "c++", "clang++")), argv
    _popen(self, args, *a, **k)


subprocess.Popen.__init__ = _no_compiler


def walk(path, prefix):
    for m in pkgutil.iter_modules([path]):
        yield prefix + m.name
        if m.ispkg:
            yield from walk(os.path.join(path, m.name), prefix + m.name + ".")


def needs_tensorflow(name):
    return name.split(".")[1] in ("tensorflow", "keras", "_keras") or \
        name.rsplit(".", 1)[-1].startswith(("tensorflow2_", "keras_"))


import horovod_tpu_torch
names = list(walk(horovod_tpu_torch.__path__[0], "horovod_tpu_torch."))
for name in sorted(names, key=needs_tensorflow):
    if needs_tensorflow(name) and "tensorflow" not in sys.modules:
        # TensorFlow loads cloudpickle itself.
        late = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("cloudpickle", "yaml"))
        assert not late, late
    importlib.import_module(name)
for name in ("parallel", "parallel.mesh", "parallel.ring_attention",
             "parallel.ulysses", "parallel.moe", "parallel.pipeline",
             "models.image_layers", "models.resnet", "models.vgg",
             "models.inception", "image_bench", "zero", "checkpoint",
             "ops.adasum", "ops.eager", "common.native", "common.metrics",
             "common.logging", "common.faults", "common.timeline",
             "common.parameter_manager", "common.optim",
             "common.optim.gaussian_process",
             "common.optim.bayesian_optimization", "common.host_world",
             "common.host_staging", "torch", "torch.mpi_ops",
             "torch.compression", "torch.functions", "torch.optimizer",
             "torch.sync_batch_norm", "torch.elastic", "elastic",
             "elastic.state", "run", "run.http.http_client",
             "run.common.util.network", "run.common.util.secret",
             "run.elastic.rendezvous", "run.elastic.worker", "examples",
             "examples.pytorch_synthetic_benchmark", "version",
             "common.liveness", "run.common.util.hosts",
             "run.common.util.safe_shell_exec",
             "run.common.util.config_parser", "run.http.http_server",
             "run.launch", "run.util", "run.util.cache", "run.util.lsf",
             "run.util.threads", "run.js_run", "run.runner", "run.__main__",
             "run.task_fn", "run.elastic.discovery",
             "run.elastic.registration", "run.elastic.driver",
             "run.elastic.runner", "examples.pytorch_mnist",
             "examples.pytorch_imagenet_resnet50",
             "examples.adasum_small_model", "examples.elastic",
             "examples.elastic.pytorch_mnist_elastic",
             "examples.elastic.pytorch_synthetic_elastic", "tensorflow",
             "tensorflow.compression", "tensorflow.mpi_ops",
             "tensorflow.native_ops", "tensorflow.functions",
             "tensorflow.elastic", "tensorflow.keras",
             "tensorflow.keras.elastic", "keras", "keras.callbacks",
             "keras.elastic", "_keras", "_keras.callbacks", "_keras.elastic",
             "examples.tensorflow2_synthetic_benchmark",
             "examples.tensorflow2_mnist", "examples.tensorflow2_keras_mnist",
             "examples.keras_mnist", "examples.keras_mnist_advanced",
             "examples.keras_imagenet_resnet50",
             "examples.elastic.tensorflow2_synthetic_elastic",
             "examples.elastic.tensorflow2_mnist_elastic",
             "examples.elastic.tensorflow2_keras_mnist_elastic",
             "run.driver", "run.driver.driver_service", "common.host_ops",
             "spark", "spark.exec", "spark.task_exec", "spark.common",
             "spark.common.backend", "spark.common.estimator",
             "spark.common.reader", "spark.common.store",
             "spark.common.util", "spark.torch", "spark.torch.remote",
             "spark.torch.estimator", "spark.keras", "spark.keras.remote",
             "spark.keras.util", "spark.keras.estimator", "mxnet",
             "examples.pytorch_spark_mnist", "examples.keras_spark_mnist",
             "examples.keras_spark_rossmann_estimator",
             "examples.mxnet_mnist", "examples.mxnet_imagenet_resnet50",
             "examples.long_context", "examples.synthetic_benchmark",
             "examples.scaling_bench", "tools", "tools.controller_bench",
             "tools.kernel_bench", "tools.profile_resnet",
             "tools.chaos_sched"):
    assert "horovod_tpu_torch." + name in names, name
# Nor the root ``tools`` package: the port's own tools stand alone.
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "horovod_tpu", "tools"))
print(len(names), bad)
assert not bad, bad
assert os.path.isfile(os.path.join(horovod_tpu_torch.__path__[0], "csrc",
                                   "testing", "stress_core.cc"))
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


_WITHOUT_TENSORFLOW = torch_worlds.REFUSE_JAX.replace(
    '("jax", "jaxlib", "horovod_tpu")',
    '("jax", "jaxlib", "horovod_tpu", "tensorflow")') + r"""
import horovod_tpu_torch.mxnet as hvd
import horovod_tpu_torch.spark.torch
import horovod_tpu_torch.spark.exec

assert not hvd._MXNET_AVAILABLE
hvd.init()
assert hvd.broadcast_object({"a": 1}) == {"a": 1}
hvd.shutdown()
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "horovod_tpu", "tensorflow", "keras"))
assert not bad, bad
print("OK")
"""


def test_mxnet_binding_needs_no_tensorflow():
    """The MXNet binding, the Spark transport and the torch estimator
    import, and the binding's world runs, in an interpreter that refuses
    ``tensorflow``."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "HVD_PALLAS_INTERPRET")}
    proc = subprocess.run([sys.executable, "-c", _WITHOUT_TENSORFLOW],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", \
        proc.stdout + proc.stderr


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


def _by_design():
    """The public names of ``horovod_tpu`` that ROADMAP.md lists as not
    ported by design (the backticked names of its "Public names" line)."""
    import re

    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        text = f.read()
    line = re.search(r"^Public names of `horovod_tpu` not in.*?(?=\n\n)",
                     text, re.M | re.S).group(0)
    return {m.group(1) for m in re.finditer(r"`(\w+)` \(", line)}


def _public_names(package):
    """The public names a fresh import of ``package`` gives (a process
    that imported submodules since has them as attributes too)."""
    code = (f"import json, {package}; print(json.dumps(sorted(n for n in "
            f"dir({package}) if not n.startswith('_'))))")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return set(json.loads(proc.stdout.splitlines()[-1]))


def test_every_public_name_of_the_jax_package_is_ported_or_listed():
    listed = _by_design()
    assert listed == {"mesh", "hierarchical_mesh", "xla", "xla_built",
                      "tpu_available"}, listed
    reference = _public_names("horovod_tpu")
    port = _public_names("horovod_tpu_torch")
    assert reference - port == listed, sorted(reference - port - listed)
    assert not listed & port, listed & port


def test_the_added_public_names_answer():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import torch as binding
    from horovod_tpu_torch.common import exceptions

    for name in ("nccl_built", "gloo_built", "mpi_built", "mpi_enabled",
                 "mpi_threads_supported", "ccl_built", "ddl_built",
                 "gloo_enabled"):
        assert getattr(hvd, name)() == getattr(binding, name)(), name
    assert hvd.gloo_built() == torch.distributed.is_gloo_available()
    assert hvd.nccl_built() == torch.distributed.is_nccl_available()
    assert not hvd.mpi_built() and not hvd.gloo_enabled()
    assert hvd.HostsUpdatedInterrupt is exceptions.HostsUpdatedInterrupt
    assert issubclass(exceptions.TensorShapeMismatchError,
                      exceptions.HorovodTpuError)
    assert hvd.version.__version__ == hvd.__version__
    assert hvd.elastic.run is not None
    with pytest.raises(hvd.NotInitializedError):
        hvd.is_homogeneous()


_HOMOGENEOUS = torch_worlds.REFUSE_JAX + r"""
import sys
sys.path.insert(0, sys.argv[1])
import horovod_tpu_torch as hvd
hvd.init(device="cpu")
print("HOMOGENEOUS", hvd.rank(), hvd.is_homogeneous(), flush=True)
hvd.shutdown()
"""


@pytest.mark.parametrize("local_sizes,want", [((1, 1), True),
                                              ((2, 2, 1), False)])
def test_is_homogeneous_reads_the_world(local_sizes, want):
    """Every rank reads the same answer: whether every host holds as many
    ranks (two hosts of one; a host of two beside a host of one)."""
    from horovod_tpu_torch.common.config import free_port_pair

    port = free_port_pair()
    size = len(local_sizes)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _HOMOGENEOUS, REPO], cwd=REPO,
        env=dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(size),
                 HOROVOD_LOCAL_RANK=str(r % 2 if ls == 2 else 0),
                 HOROVOD_LOCAL_SIZE=str(ls),
                 HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                 HOROVOD_CONTROLLER_PORT=str(port), OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r, ls in enumerate(local_sizes)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"HOMOGENEOUS {r} {want}" in out, out


def test_new_entry_points_default_to_cuda(no_gpu, tmp_path):
    """The long-context example, the synthetic and scaling benchmarks and
    the profile tool ask for the card unless told ``--device cpu`` (or
    ``--cpu-devices``)."""
    from horovod_tpu_torch.examples import (long_context, scaling_bench,
                                            synthetic_benchmark)
    from horovod_tpu_torch.tools import profile_resnet

    for main, argv in ((long_context.main, ["--sp", "1"]),
                       (synthetic_benchmark.main, []),
                       (profile_resnet.main, ["--out", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
    with pytest.raises(SystemExit, match="0 attached device"):
        scaling_bench.main([])
