"""The port's attention kernel microbench in its CPU mode.

``horovod_tpu_torch.tools.kernel_bench`` refuses without a card unless
``--device cpu``, where the wrappers run their plain versions: the
platform line, one row per (seq_len, phase) with the reference's keys
(``tools/pallas_bench.py``) and the port's own, the numerics against the
fp32 oracle inside the tolerance, and the summary line; with
``--packed`` the library runs on the documents' boolean mask.
"""

import json

import pytest
import torch

from horovod_tpu_torch.tools import kernel_bench

REF_KEYS = {"seq_len", "phase", "batch", "heads", "head_dim", "causal",
            "window", "pallas_ms", "xla_ms", "speedup", "maxerr_vs_xla"}
SMALL = ["--device", "cpu", "--batch", "1", "--heads", "2", "--dim", "64",
         "--iters", "1"]


def _lines(capsys, argv):
    code = kernel_bench.main(argv)
    return code, [json.loads(x) for x in capsys.readouterr().out.splitlines()]


@pytest.mark.parametrize("extra", [[], ["--packed", "3"],
                                   ["--window", "16"]])
def test_cpu_mode_rows(capsys, extra):
    code, lines = _lines(capsys, SMALL + ["--seq-lens", "64,96"] + extra)
    assert code == 0
    assert lines[0] == {"platform": "cpu", "device_kind": "cpu"}
    rows, summary = lines[1:-1], lines[-1]
    assert [(r["seq_len"], r["phase"]) for r in rows] == [
        (64, "fwd"), (64, "bwd"), (96, "fwd"), (96, "bwd")]
    for row in rows:
        assert REF_KEYS <= set(row)
        assert row["numerics_ok"] and row["rel_err"] <= kernel_bench.TOLERANCE
        assert row["pallas_ms"] > 0 and row["xla_ms"] > 0
        assert row["packed"] == (3 if "--packed" in extra else 0)
    assert {"dq_ms", "dkv_ms"} <= set(rows[1])
    assert summary["numerics_ok"] and summary["rows"] == 4


def test_packed_ids_are_the_examples():
    ids = kernel_bench.packed_ids(96, 2, 3, "cpu")
    assert ids.dtype == torch.int32 and ids.shape == (2, 96)
    assert ids[0].tolist() == [i // 32 for i in range(96)]


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        kernel_bench.main(["--seq-lens", "64"])
    assert e.value.code == 2
    assert "--device cpu" in capsys.readouterr().err


def test_a_failed_check_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(kernel_bench, "TOLERANCE", 1e-9)
    code, lines = _lines(capsys, SMALL + ["--seq-lens", "64"])
    assert code == 1 and lines[-1]["numerics_ok"] is False
