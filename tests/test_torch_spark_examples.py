"""The port's Spark and MXNet examples (``horovod_tpu_torch/examples/``)
against the JAX package's (``examples/``), with the arguments of
``tests/test_examples.py``.

``pytorch_spark_mnist`` (one rank on the ``LocalBackend``, the port's
with ``--no-cuda``) and ``keras_spark_rossmann_estimator`` start from one
seed in both processes and must print the same lines, digit for digit.
The Rossmann case (a Keras model over 20,000 rows) takes a minute or more
of CPU and is marked ``slow``. The MXNet examples exit 1 with their gate
message, since mxnet is not installed.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Seeds torch, numpy and (where asked) Keras, then runs an example as
# ``__main__``: a path, or a module of the port.
SEEDED = r"""
import runpy, sys
import numpy as np
import torch
torch.manual_seed(0)
np.random.seed(0)
if sys.argv[1] == "--keras":
    import keras
    keras.utils.set_random_seed(0)
    sys.argv.pop(1)
target = sys.argv[1]
sys.argv = sys.argv[1:]
if target.endswith(".py"):
    runpy.run_path(target, run_name="__main__")
else:
    runpy.run_module(target, run_name="__main__", alter_sys=True)
"""


def _env():
    from conftest import subprocess_cpu_env

    return subprocess_cpu_env(
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _start(target, args, keras=False):
    return subprocess.Popen(
        [sys.executable, "-c", SEEDED] + (["--keras"] if keras else [])
        + [target] + args, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _both(ref_path, port_module, args, port_args, tmp_path, keras=False,
          timeout=300):
    """Both examples at once, each with a work directory of its own;
    their standard outputs' lines."""
    procs = [_start(os.path.join(REPO, "examples", ref_path),
                    args + ["--work-dir", str(tmp_path / "ref")], keras),
             _start(f"horovod_tpu_torch.examples.{port_module}",
                    args + port_args + ["--work-dir", str(tmp_path / "port")],
                    keras)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, out[-2000:] + err[-3000:]
            outs.append(out.splitlines())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def test_pytorch_spark_mnist(tmp_path):
    pytest.importorskip("pandas")
    ref, port = _both("pytorch_spark_mnist.py", "pytorch_spark_mnist",
                      ["--epochs", "1"], ["--no-cuda"], tmp_path)
    ref = [ln for ln in ref if ln.startswith(("history:", "prediction"))]
    port = [ln for ln in port if ln.startswith(("history:", "prediction"))]
    assert len(ref) == 2 and port == ref


@pytest.mark.slow
def test_keras_rossmann_estimator(tmp_path):
    pytest.importorskip("keras")
    pytest.importorskip("pandas")
    ref, port = _both("keras_spark_rossmann_estimator.py",
                      "keras_spark_rossmann_estimator",
                      ["--epochs", "1", "--num-proc", "2"], [], tmp_path,
                      keras=True, timeout=600)
    ref = [ln for ln in ref if ln.startswith("validation RMSPE")]
    port = [ln for ln in port if ln.startswith("validation RMSPE")]
    assert len(ref) == 1 and port == ref


@pytest.mark.parametrize("module", ["mxnet_mnist",
                                    "mxnet_imagenet_resnet50"])
def test_mxnet_example_gates_cleanly(module):
    proc = subprocess.run(
        [sys.executable, "-m", f"horovod_tpu_torch.examples.{module}"],
        capture_output=True, text=True, timeout=120, env=_env(), cwd=REPO)
    assert proc.returncode == 1
    assert "mxnet is not installed" in proc.stderr
    assert "Traceback" not in proc.stderr
