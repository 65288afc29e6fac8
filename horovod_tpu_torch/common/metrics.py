"""Metrics — the Python half.

The port's copy of ``horovod_tpu/common/metrics.py``: the native
registry's JSON snapshot (``csrc/hvd/metrics.cc``, read through the single
``hvd_metrics_snapshot`` getter) merged with the Python-plane counters
(retries, fault injections, shm/stripe fallback armings). Surfaced as
``hvd.metrics()`` and ``hvd.metrics_report()`` and, behind
``HOROVOD_METRICS_EXPORT`` (unset: nothing starts, nothing is written),
published by a pump thread as a Prometheus textfile and as counter events
in the open timeline.

The straggler warnings that the native detector drains through the
snapshot become ``STRAGGLER_WARNING`` timeline instants here: the Python
side owns the timeline, the native side the per-rank ready times.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from . import config as _config
from . import logging as _log

# ---- Python-plane counters -------------------------------------------------
#
# One flat namespace of monotonically increasing ints, dotted names after
# the subsystem that owns them:
#   retrier.retries          every Retrier backoff taken (faults.py)
#   faults.injected          every fault point that fired (faults.py)
#   chaos.injected           the subset drawn by HOROVOD_CHAOS_SPEC
#   shm.attach_fallback      ring.shm.attach forced a TCP fallback
#                            (host_world.py)
#   stripe.connect_fallback  the stripe sibling (host_world.py)

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
    the native core, else the host world's; None in direct mode or before
    init. The one rule every observability surface shares
    (``hvd.stall_report``, ``ring_traffic``, ``metrics``)."""
    from . import state as _state

    st = _state.global_state()
    if st.initialized and st.engine is not None:
        core = st.engine.native_core
        if core is not None:
            return core
    from . import host_world as _host_world

    world = _host_world.world()
    return world._core if world.initialized else None


def _active_timeline():
    from . import state as _state

    st = _state.global_state()
    return st.timeline if st.initialized else None


def _emit_straggler_instants(native: Optional[dict]) -> None:
    """Drained straggler events -> ``STRAGGLER_WARNING`` instants in the
    open timeline (the events stay in the snapshot either way)."""
    if not native:
        return
    events = native.get("straggler", {}).get("events", ())
    if not events:
        return
    timeline = _active_timeline()
    if timeline is None:
        return
    from . import timeline as _timeline

    for ev in events:
        timeline.instant(_timeline.STRAGGLER_WARNING,
                         {"rank": ev.get("rank"),
                          "lag_ms": ev.get("lag_ms")})


def snapshot(drain: bool = True) -> dict:
    """The merged metrics view behind ``hvd.metrics()``:

    ``{"python": {counter: value}, "native": {...} | None}``

    ``native`` is the parsed unified snapshot (counters, log2
    histograms, straggler state) or None when no native core is live.
    With ``drain`` (the default), pending straggler warning events are
    consumed into ``native["straggler"]["events"]`` and mirrored as
    ``STRAGGLER_WARNING`` timeline instants; monitors that must not take
    them pass ``drain=False``."""
    native = None
    core = live_native_core()
    if core is not None:
        flags = core.METRICS_DRAIN_STRAGGLER if drain else 0
        native = core.metrics_snapshot(flags) or None
        if drain:
            _emit_straggler_instants(native)
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


# ---- Prometheus textfile exporter ------------------------------------------


def _prom_name(name: str) -> str:
    return "hvd_" + name.replace(".", "_").replace("-", "_")


def prometheus_text(snap: Optional[dict] = None) -> str:
    """A merged snapshot in node-exporter textfile format: Python counters
    as counters, native counters as gauges, the log2 histograms as
    Prometheus histograms with ``le`` at the bucket upper bounds (2^(i+1)
    us)."""
    snap = snap if snap is not None else snapshot(drain=False)
    out = []
    py = snap.get("python") or {}
    for k in sorted(py):
        n = _prom_name(k)
        out.append(f"# TYPE {n} counter")
        out.append(f"{n} {py[k]}")
    native = snap.get("native")
    if native:
        for k in sorted(native.get("counters", {})):
            v = native["counters"][k]
            n = _prom_name(k)
            out.append(f"# TYPE {n} gauge")
            out.append(f"{n} {v}")
        for name in sorted(native.get("histograms", {})):
            h = native["histograms"][name]
            n = _prom_name(name)
            out.append(f"# TYPE {n} histogram")
            cum = 0
            for b, c in sorted((int(b), int(c))
                               for b, c in h.get("buckets", ())):
                cum += c
                out.append(f'{n}_bucket{{le="{2 ** (b + 1)}"}} {cum}')
            # The snapshot reads the count before the buckets while
            # recorders bump bucket then count: +Inf and _count must stay
            # >= every explicit bucket, or the series decreases.
            total = max(cum, int(h.get("count", 0)))
            out.append(f'{n}_bucket{{le="+Inf"}} {total}')
            out.append(f"{n}_sum {h.get('sum', 0)}")
            out.append(f"{n}_count {total}")
        st = native.get("straggler", {})
        out.append("# TYPE hvd_straggler_warnings counter")
        out.append(f"hvd_straggler_warnings {st.get('warnings', 0)}")
        out.append("# TYPE hvd_straggler_last_rank gauge")
        out.append(f"hvd_straggler_last_rank {st.get('last_rank', -1)}")
    return "\n".join(out) + "\n"


class MetricsPump(threading.Thread):
    """The exporter thread, armed only by ``HOROVOD_METRICS_EXPORT``:
    every interval it takes one snapshot and publishes it twice: it
    rewrites the textfile atomically and, when a timeline is open, emits
    counter events and any drained ``STRAGGLER_WARNING`` instants. A
    failed publish logs and keeps the thread alive: observability never
    takes the job down."""

    def __init__(self, path: str, interval_ms: int):
        super().__init__(name="hvd-metrics-pump", daemon=True)
        self._path = path
        self._interval_s = max(0.1, interval_ms / 1000.0)
        # Not self._stop: threading.Thread has a private _stop().
        self._stop_evt = threading.Event()
        # The native link.reconnects seen at the last publish; growth
        # becomes a LINK_RECONNECT instant (the pump is its only reader).
        self._last_reconnects = 0

    def stop(self):
        self._stop_evt.set()
        self.join(timeout=5.0)

    def publish_once(self):
        # Drain straggler events only when a timeline can take them as
        # instants; otherwise hvd.metrics() still delivers them.
        snap = snapshot(drain=_active_timeline() is not None)
        text = prometheus_text(snap)
        tmp = f"{self._path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, self._path)
        timeline = _active_timeline()
        native = snap.get("native")
        if timeline is not None and native:
            c = native.get("counters", {})
            timeline.counter("hvd_bytes", {
                "bytes_sent": c.get("bytes_sent", 0),
                "cross_bytes": c.get("cross_bytes", 0),
                "shm_bytes": c.get("shm_bytes", 0),
            })
            timeline.counter("hvd_control", {
                "cache_hits": c.get("cache_hits", 0),
                "cycles": c.get("cycles", 0),
                "pending": c.get("pending", 0),
            })
            reconnects = int(c.get("link.reconnects", 0))
            if reconnects > self._last_reconnects:
                from . import timeline as _timeline

                timeline.instant(_timeline.LINK_RECONNECT,
                                 {"reconnects": reconnects})
            self._last_reconnects = reconnects

    def run(self):
        while not self._stop_evt.wait(self._interval_s):
            # Best effort by contract: a failed write or snapshot must not
            # end the pump (or the job).
            try:
                self.publish_once()
            except Exception as e:
                _log.warning(f"metrics export failed: {e}")
        # A final publish, so a short job still leaves its file.
        try:
            self.publish_once()
        except Exception as e:
            _log.debug(f"final metrics export failed: {e}")


_pump: Optional[MetricsPump] = None


def maybe_start_pump() -> Optional[MetricsPump]:
    """Start the exporter if ``HOROVOD_METRICS_EXPORT`` is set (called when
    the eager engine starts). Unset: nothing starts, nothing is
    written."""
    global _pump
    path = _config.metrics_export_path()
    if not path or _pump is not None:
        return _pump
    _pump = MetricsPump(path, _config.metrics_interval_ms())
    _pump.start()
    return _pump


def stop_pump() -> None:
    """Stop the exporter (called when the eager engine stops, while its
    core and the timeline are still live); it publishes once more."""
    global _pump
    if _pump is not None:
        _pump.stop()
        _pump = None
