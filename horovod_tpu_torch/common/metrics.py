"""Metrics — the Python half, the parts the native snapshot needs.

The port's copy of ``horovod_tpu/common/metrics.py``'s counters, snapshot
and histogram math: the native registry's JSON snapshot
(``csrc/hvd/metrics.cc``, read through the single
``hvd_metrics_snapshot`` getter) merged with the Python-plane counters.
Surfaced as ``hvd.metrics()`` and ``hvd.metrics_report()``. The
Prometheus pump and the timeline's ``STRAGGLER_WARNING`` instants come
with the port's timeline.
"""

from __future__ import annotations

import threading
from typing import Optional

# ---- Python-plane counters -------------------------------------------------
#
# One flat namespace of monotonically increasing ints, dotted names after
# the subsystem that owns them.

_lock = threading.Lock()
_counters: dict = {}


def inc(name: str, n: int = 1) -> None:
    """Bump a Python-plane counter (thread-safe)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """A copy of the Python-plane counters."""
    with _lock:
        return dict(_counters)


def reset() -> None:
    """Zero the Python-plane counters (tests)."""
    with _lock:
        _counters.clear()


# ---- native snapshot access ------------------------------------------------


def live_native_core():
    """The process's live NativeCore: the eager engine's when it runs on
    the native core; None in direct mode or before init. The one rule
    every observability surface shares (``hvd.stall_report``,
    ``ring_traffic``, ``metrics``)."""
    from . import state as _state

    st = _state.global_state()
    if st.initialized and st.engine is not None:
        return st.engine.native_core
    return None


def snapshot(drain: bool = True) -> dict:
    """The merged metrics view behind ``hvd.metrics()``:

    ``{"python": {counter: value}, "native": {...} | None}``

    ``native`` is the parsed unified snapshot (counters, log2
    histograms, straggler state) or None when no native core is live.
    With ``drain`` (the default), pending straggler warning events are
    consumed into ``native["straggler"]["events"]``; monitors that must
    not take them pass ``drain=False``."""
    native = None
    core = live_native_core()
    if core is not None:
        flags = core.METRICS_DRAIN_STRAGGLER if drain else 0
        native = core.metrics_snapshot(flags) or None
    return {"python": counters(), "native": native}


# ---- histogram math --------------------------------------------------------


def percentiles(hist: dict, qs=(50, 90, 99)) -> dict:
    """Approximate percentiles of a native log2 histogram (the value at
    each covering bucket's upper bound, 2^(i+1)). ``hist`` is the
    snapshot shape ``{"count":..., "buckets": [[index, count], ...]}``.
    Returns {"p50": v, ...} (zeros when empty)."""
    total = int(hist.get("count", 0))
    out = {f"p{q}": 0 for q in qs}
    if total <= 0:
        return out
    buckets = sorted((int(b), int(c)) for b, c in hist.get("buckets", ()))
    for q in qs:
        target = total * q / 100.0
        seen = 0
        val = 0
        for b, c in buckets:
            seen += c
            if seen >= target:
                val = 2 ** (b + 1)
                break
        out[f"p{q}"] = val
    return out


def report_text(snap: Optional[dict] = None) -> str:
    """Human-readable rendering of a merged snapshot (the string behind
    ``hvd.metrics_report()``): counters, then each non-empty histogram
    with count / approximate p50/p99 / max, then straggler state. Reads
    with ``drain=False``: a glance must not take pending straggler events
    from ``hvd.metrics()``."""
    snap = snap if snap is not None else snapshot(drain=False)
    lines = ["== horovod_tpu_torch metrics =="]
    py = snap.get("python") or {}
    native = snap.get("native")
    if py:
        lines.append("-- python counters --")
        for k in sorted(py):
            lines.append(f"{k}: {py[k]}")
    if not native:
        lines.append("native core: absent (direct mode or not "
                     "initialized)")
        return "\n".join(lines) + "\n"
    lines.append("-- native counters --")
    for k in sorted(native.get("counters", {})):
        lines.append(f"{k}: {native['counters'][k]}")
    lines.append("-- histograms (us) --")
    for name in sorted(native.get("histograms", {})):
        h = native["histograms"][name]
        if not h.get("count"):
            continue
        p = percentiles(h, (50, 99))
        lines.append(f"{name}: n={h['count']} p50~{p['p50']} "
                     f"p99~{p['p99']} max={h['max']}")
    st = native.get("straggler", {})
    lines.append(f"straggler: warnings={st.get('warnings', 0)} "
                 f"last_rank={st.get('last_rank', -1)} "
                 f"last_lag_ms={st.get('last_lag_ms', 0)}")
    return "\n".join(lines) + "\n"
