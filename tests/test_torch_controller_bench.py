"""The control plane's round-trip gate on the port's native core.

``horovod_tpu_torch.tools.controller_bench`` runs ``tools/
controller_bench.py``'s worlds over the port's core: its exec callback
completes each response without a collective, so the rows time
negotiation alone. The reference's live gate holds here (sizes 2 and 4,
60 iterations; the cached p50 under twice the reference's 5 ms cycle, the
miss p50 under ten cycles, every worker resubmission a cache hit; a
short settle and up to two reruns for a shared machine's jitter), flat
and under ``--hier-control``. The JSON line has the reference's keys; a
``--hier-control`` row has exactly the keys of ``docs/controller_bench.
json``'s rows (captured that way), a flat row those without the
leader-side split.
"""

import json
import os
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET_MS = 5.0
CI_LIMIT_MS = 2 * BUDGET_MS
LIVE_ITERS = 60
HIER_ONLY = {"leader_agg_ms", "fanout_ms"}


def _run_bench(sizes, iters, extra=()):
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.tools.controller_bench",
         "--sizes", sizes, "--iters", str(iters), *extra],
        capture_output=True, text=True, timeout=420, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1]
    return json.loads(line)


def _timings_within_limits(result) -> bool:
    return all(data["hit_ms"]["p50"] < CI_LIMIT_MS
               and data["miss_ms"]["p50"] < 10 * BUDGET_MS
               for data in result["sizes"].values())


@pytest.mark.parametrize("mode", ["flat", "hier-control"])
def test_cached_rtt_beats_cycle_budget(mode):
    extra = ("--hier-control",) if mode == "hier-control" else ()
    result = _run_bench("2,4", LIVE_ITERS, extra)
    for _ in range(2):
        if _timings_within_limits(result):
            break
        time.sleep(2.0)
        result = _run_bench("2,4", LIVE_ITERS, extra)
    assert result["metric"] == "controller_cached_rtt_ms"
    assert result["hier_control"] is (mode == "hier-control")
    with open(os.path.join(REPO, "docs", "controller_bench.json")) as f:
        committed = json.load(f)
    assert set(result) == set(committed)
    want = set(committed["sizes"]["2"])
    if mode == "flat":
        want -= HIER_ONLY
    assert set(result["sizes"]) == {"2", "4"}
    for size, data in result["sizes"].items():
        assert set(data) == want, (size, sorted(data))
        hit, miss = data["hit_ms"], data["miss_ms"]
        assert {"p50", "p90", "p99", "mean", "n"} <= set(hit)
        assert hit["n"] == miss["n"] == LIVE_ITERS
        assert hit["p50"] <= hit["p99"]
        assert hit["p50"] < CI_LIMIT_MS, (size, hit)
        assert miss["p50"] < 10 * BUDGET_MS, (size, miss)
        # The id fast path engaged: every worker-rank resubmission of the
        # repeated name was a cache hit.
        assert data["cache_hits_worker_ranks"] >= \
            (int(size) - 1) * LIVE_ITERS, data
