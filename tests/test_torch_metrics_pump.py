"""The port's metrics pump (``common/metrics.py``) against the JAX
package's.

``prometheus_text``, ``report_text`` and ``percentiles`` give the
reference's output on the same snapshot (the report's title names the
package); drained straggler events become the same ``STRAGGLER_WARNING``
instants. Then the pump in a size-1 world on the CPU: with
``HOROVOD_METRICS_EXPORT`` set it writes a textfile that parses as
Prometheus text and holds the eager plane's counters and histograms, and
the open timeline gets its counter events; unset, nothing is written.
"""

import json
import re

import pytest

from horovod_tpu.common import metrics as jmetrics
from horovod_tpu_torch.common import metrics as tmetrics

SNAPSHOT = {
    "python": {"retrier.retries": 2, "faults.injected": 5,
               "shm.attach_fallback": 1},
    "native": {
        "counters": {"bytes_sent": 123, "cache_hits": 4, "cycles": 77,
                     "link.reconnects": 0, "cross-bytes": 9},
        "histograms": {
            # Buckets out of order, and a count one below the buckets' sum
            # (a record landing between the snapshot's reads).
            "cycle_us": {"count": 3, "sum": 30, "max": 20,
                         "buckets": [[4, 2], [2, 1]]},
            "enq_to_neg_allreduce_us": {"count": 5, "sum": 900, "max": 400,
                                        "buckets": [[5, 1], [8, 3], [9, 2]]},
            "empty_us": {"count": 0, "sum": 0, "max": 0, "buckets": []},
        },
        "straggler": {"warnings": 1, "last_rank": 2, "last_lag_ms": 250.0,
                      "events": [{"rank": 1, "lag_ms": 120.5},
                                 {"rank": 2, "lag_ms": 250.0}]},
    },
}


def test_prometheus_text_matches_reference():
    assert tmetrics.prometheus_text(SNAPSHOT) == \
        jmetrics.prometheus_text(SNAPSHOT)
    assert tmetrics.prometheus_text({"python": {}, "native": None}) == \
        jmetrics.prometheus_text({"python": {}, "native": None})
    for name in ("a.b-c", "cycles", "link.reconnects"):
        assert tmetrics._prom_name(name) == jmetrics._prom_name(name)


def test_report_and_percentiles_match_reference():
    got = tmetrics.report_text(SNAPSHOT).splitlines()
    want = jmetrics.report_text(SNAPSHOT).splitlines()
    assert got[0] == "== horovod_tpu_torch metrics ==" and \
        want[0] == "== horovod_tpu metrics =="
    assert got[1:] == want[1:]
    for h in SNAPSHOT["native"]["histograms"].values():
        assert tmetrics.percentiles(h) == jmetrics.percentiles(h)


class _Recorder:
    def __init__(self):
        self.events = []

    def instant(self, name, args=None):
        self.events.append((name, args))


def test_straggler_instants_match_reference(monkeypatch):
    got, want = _Recorder(), _Recorder()
    monkeypatch.setattr(tmetrics, "_active_timeline", lambda: got)
    monkeypatch.setattr(jmetrics, "_active_timeline", lambda: want)
    tmetrics._emit_straggler_instants(SNAPSHOT["native"])
    jmetrics._emit_straggler_instants(SNAPSHOT["native"])
    assert got.events == want.events and len(got.events) == 2


def _parse_prometheus(text):
    series = {}
    for line in text.splitlines():
        if line.startswith("#"):
            assert re.fullmatch(r"# TYPE \w+ (counter|gauge|histogram)",
                                line), line
            continue
        m = re.fullmatch(r'(\w+(?:\{le="[^"]+"\})?) (\S+)', line)
        assert m is not None, line
        series[m.group(1)] = float(m.group(2))
    return series


@pytest.mark.parametrize("armed", [True, False])
def test_pump_writes_its_textfile(tmp_path, monkeypatch, armed):
    import torch

    import horovod_tpu_torch as hvd

    prom, trace = tmp_path / "hvd.prom", tmp_path / "timeline.json"
    if armed:
        monkeypatch.setenv("HOROVOD_METRICS_EXPORT", str(prom))
        monkeypatch.setenv("HOROVOD_METRICS_INTERVAL_MS", "100")
    monkeypatch.setenv("HOROVOD_TIMELINE", str(trace))
    hvd.init(device="cpu")
    try:
        for i in range(4):
            hvd.allreduce(torch.ones(8), name=f"pump.{i}", op=hvd.Sum)
    finally:
        hvd.shutdown()
    names = {e["name"] for e in json.loads(trace.read_text())}
    if not armed:
        assert not prom.exists()
        assert not names & {"hvd_bytes", "hvd_control"}
        return
    series = _parse_prometheus(prom.read_text())
    assert series["hvd_enq_to_neg_allreduce_us_count"] >= 4
    assert series['hvd_cycle_us_bucket{le="+Inf"}'] == \
        series["hvd_cycle_us_count"] > 0
    assert series["hvd_cycles"] > 0
    assert {"hvd_bytes", "hvd_control"} <= names
