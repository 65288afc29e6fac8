"""The port's profiled model-zoo step in its CPU mode.

``python -m horovod_tpu_torch.tools.profile_resnet --device cpu
--include-host`` writes the Chrome trace under ``<out>/<model>_trace_<ts>/``
and a summary beside it whose table ranks the host ops by self time (a
CPU run records no device time), and prints the run's JSON line.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("model", ["resnet50"])
def test_cpu_profile_writes_trace_and_summary(tmp_path, model):
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.tools.profile_resnet",
         "--device", "cpu", "--model", model, "--batch-size", "2",
         "--image-size", "32", "--steps", "1", "--top", "7",
         "--include-host", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    meta = json.loads(proc.stdout.strip().splitlines()[-1])
    assert meta["platform"] == "cpu" and meta["model"] == model
    assert meta["batch_size"] == 2 and meta["steps"] == 1
    assert meta["img_per_sec"] > 0 and meta["step_ms"] > 0
    traces = [p for p in os.listdir(tmp_path) if os.path.isdir(tmp_path / p)]
    assert len(traces) == 1 and traces[0].startswith(f"{model}_trace_")
    with open(tmp_path / traces[0] / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    summary = (tmp_path / (traces[0] + "_summary.md")).read_text()
    rows = [ln for ln in summary.splitlines()
            if ln.startswith("| ") and ln.split("|")[1].strip().isdigit()]
    assert len(rows) == 7
    assert f"summary -> {tmp_path / traces[0]}_summary.md" in proc.stderr


def test_default_out_is_in_the_ignored_build_tree():
    from horovod_tpu_torch.tools import profile_resnet

    assert profile_resnet.DEFAULT_OUT == os.path.join(
        REPO, "build", "horovod_tpu_torch", "probes")
