"""The port's scaling-efficiency harness and synthetic benchmark on the
CPU.

``examples/scaling_bench.py --cpu-devices 2 --devices 1 2`` starts a gloo
world of one rank, then of two, through the launcher's ``run()``: a line
a world, the note that CPU worlds timeshare one host, and last the JSON
line with ``examples/scaling_bench.py``'s keys, ``value`` the per-device
rate at 2 over the rate at 1. ``examples/synthetic_benchmark.py`` prints
``examples/jax_synthetic_benchmark.py``'s lines at two ranks, bucketed
and ZeRO-1. One rank of scaling_bench's world trains image_bench's
ResNet-50 step, loss for loss.
"""

import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module, *argv):
    proc = subprocess.run(
        [sys.executable, "-m", module, *argv], capture_output=True,
        text=True, timeout=420, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


def test_scaling_protocol_runs():
    out = _run("horovod_tpu_torch.examples.scaling_bench", "--cpu-devices",
               "2", "--devices", "1", "2", "--model", "resnet18",
               "--batch-size", "2", "--image-size", "32", "--num-classes",
               "10", "--num-warmup", "1", "--num-iters", "2")
    lines = out.strip().splitlines()
    worlds = [ln for ln in lines if ln.startswith("devices=")]
    assert [int(re.match(r"devices=\s*(\d+)", ln).group(1))
            for ln in worlds] == [1, 2]
    assert all("efficiency vs 1-device:" in ln for ln in worlds)
    assert any(ln.startswith("NOTE: virtual CPU devices timeshare one host")
               for ln in lines)
    res = json.loads(lines[-1])
    assert set(res) == {"metric", "value", "unit", "per_device_img_per_sec",
                        "platform"}
    assert res["metric"] == "scaling_efficiency"
    assert res["unit"] == "fraction at 2 devices vs 1"
    assert res["platform"] == "cpu"
    rates = res["per_device_img_per_sec"]
    assert set(rates) == {"1", "2"} and min(rates.values()) > 0
    assert res["value"] == pytest.approx(rates["2"] / rates["1"], rel=2e-2,
                                         abs=1e-3)


# One process trains image_bench's ResNet-50 and then one rank of
# scaling_bench's world of one, with ``make_train_step`` wrapped to record
# what each harness hands it and what each step returns.
SAME_STEP = r"""
import json
import horovod_tpu_torch as hvd
import horovod_tpu_torch.training as training
from horovod_tpu_torch import image_bench
from horovod_tpu_torch.examples import scaling_bench

seen, real = {}, training.make_train_step


def recording(name):
    def make(model, opt):
        step = real(model, opt)
        rec = seen[name] = {
            "model": type(model).__name__,
            "params": [(n, str(p.dtype), list(p.shape))
                       for n, p in model.named_parameters()],
            "optimizer": type(opt).__mro__[-2].__name__,
            "groups": [{k: v for k, v in g.items() if k != "params"}
                       for g in opt.param_groups],
            "inputs": None, "losses": []}

        def recorded(images, labels, *rest):
            rec["inputs"] = [[list(t.shape), str(t.dtype)]
                             for t in (images, labels)]
            loss = step(images, labels, *rest)
            rec["losses"].append(float(loss))
            return loss
        return recorded
    return make


training.make_train_step = recording("image_bench")
image_bench.run(image_bench.parse_args([
    "--model", "resnet50", "--batch-size", "2", "--image-size", "32",
    "--num-warmup", "1", "--num-iters", "2", "--device", "cpu"]))
hvd.shutdown()
training.make_train_step = recording("scaling_bench")
scaling_bench.world_rank("resnet50", 2, 32, 1000, 1, 2, "cpu")
print(json.dumps(seen, default=str))
"""


def test_scaling_trains_image_bench_step():
    """scaling_bench's world trains what image_bench trains: the same
    model, parameter dtypes, optimizer and hyperparameters, batch and
    step, so on the same data (both draw it from the same seeds) the same
    losses, bit for bit on the CPU. On the card the rates of the two are
    printed side by side, not held to each other (the host moves them)."""
    proc = subprocess.run(
        [sys.executable, "-c", SAME_STEP], capture_output=True, text=True,
        timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    image, scaling = seen["image_bench"], seen["scaling_bench"]
    # models/resnet's ResNet50 builds a ResNet of 161 parameter tensors.
    assert image["model"] == "ResNet" and len(image["params"]) == 161
    assert image["inputs"] == [[[2, 32, 32, 3], "torch.float32"],
                               [[2], "torch.int64"]]
    assert len(image["losses"]) == 3
    for key in ("model", "params", "optimizer", "groups", "inputs",
                "losses"):
        assert scaling[key] == image[key], key


def test_no_world_fits():
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.examples.scaling_bench",
         "--cpu-devices", "1", "--devices", "2"], capture_output=True,
        text=True, timeout=120, cwd=REPO, env=dict(os.environ,
                                                   PYTHONPATH=REPO))
    assert proc.returncode == 1
    assert "no requested world size fits the 1 attached" in proc.stderr


@pytest.mark.parametrize("zero", [False, True])
def test_synthetic_benchmark_lines(zero):
    out = _run("horovod_tpu_torch.run", "-np", "2", "-H", "localhost:2",
               sys.executable, "-m",
               "horovod_tpu_torch.examples.synthetic_benchmark", "--device",
               "cpu", "--batch-size", "2", "--image-size", "32",
               "--num-warmup", "1", "--num-iters", "2",
               *(["--zero"] if zero else []))
    # The launcher prefixes each line with its rank.
    lines = [ln.split("]", 1)[1] for ln in out.splitlines()
             if ln.startswith("[0]")]
    assert [ln for ln in lines if ln.startswith("Iter #")] == [
        ln for ln in lines if re.fullmatch(
            r"Iter #[01]: [0-9.]+ img/sec per device", ln)]
    assert len([ln for ln in lines if ln.startswith("Iter #")]) == 2
    assert any(re.fullmatch(r"Img/sec per device: [0-9.]+ \+-[0-9.]+", ln)
               for ln in lines)
    assert any(re.fullmatch(r"Total img/sec on 2 device\(s\): [0-9.]+", ln)
               for ln in lines)
    assert not [ln for ln in out.splitlines() if ln.startswith("[1]Iter")]
