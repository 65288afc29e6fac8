"""Chrome-tracing timeline writer.

The port's copy of ``horovod_tpu/common/timeline.py``: per-tensor phase
events (``NEGOTIATE_*``, then the execution activity) and instants,
written as Chrome-tracing JSON by a writer thread fed from a queue, so the
hot path never waits on file IO. Open the file in ``chrome://tracing`` or
Perfetto.

Every name is the reference's except the execution activities, which are
named for the backend that runs them: ``NCCL_*`` on the card, ``GLOO_*``
on the CPU, where the JAX package wrote ``XLA_*``. ``REFERENCE_NAMES``
maps each to the reference's name, so tools written for the reference's
traces read the port's after one rename.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Optional

NEGOTIATE_ALLREDUCE = "NEGOTIATE_ALLREDUCE"
NEGOTIATE_ALLGATHER = "NEGOTIATE_ALLGATHER"
NEGOTIATE_BROADCAST = "NEGOTIATE_BROADCAST"
WAIT_FOR_DATA = "WAIT_FOR_DATA"
WAIT_FOR_OTHER_TENSOR_DATA = "WAIT_FOR_OTHER_TENSOR_DATA"
MEMCPY_IN_FUSION_BUFFER = "MEMCPY_IN_FUSION_BUFFER"
MEMCPY_OUT_FUSION_BUFFER = "MEMCPY_OUT_FUSION_BUFFER"
# Execution activities: one per collective and backend.
NCCL_ALLREDUCE = "NCCL_ALLREDUCE"
NCCL_ALLGATHER = "NCCL_ALLGATHER"
NCCL_BCAST = "NCCL_BCAST"
NCCL_REDUCESCATTER = "NCCL_REDUCESCATTER"
NCCL_ALLTOALL = "NCCL_ALLTOALL"
GLOO_ALLREDUCE = "GLOO_ALLREDUCE"
GLOO_ALLGATHER = "GLOO_ALLGATHER"
GLOO_BCAST = "GLOO_BCAST"
GLOO_REDUCESCATTER = "GLOO_REDUCESCATTER"
GLOO_ALLTOALL = "GLOO_ALLTOALL"
COMPILE = "COMPILE"
# Robustness-plane instants: a Retrier backing off, a stall-inspector
# warning drained by hvd.stall_report(), a host blacklisted by the
# elastic driver.
RETRY = "RETRY"
STALL_WARNING = "STALL_WARNING"
HOST_BLACKLISTED = "HOST_BLACKLISTED"
# Liveness-plane instants.
HEARTBEAT_MISS = "HEARTBEAT_MISS"
RANK_SUSPECT = "RANK_SUSPECT"
RANK_EVICTED = "RANK_EVICTED"
DRAIN_BEGIN = "DRAIN_BEGIN"
DRAIN_COMMIT = "DRAIN_COMMIT"
# Metrics-plane instants: the coordinator's straggler detector naming a
# rank (args: rank, lag_ms), and the cycle marker of mark_cycle.
STRAGGLER_WARNING = "STRAGGLER_WARNING"
CYCLE = "CYCLE"
# A cross-host data link redialed in place (args: reconnects).
LINK_RECONNECT = "LINK_RECONNECT"

# Every instant name: a call site passes one of these constants, so the
# tools that read traces find every event by its name.
INSTANT_CATALOG = (
    RETRY,
    STALL_WARNING,
    HOST_BLACKLISTED,
    HEARTBEAT_MISS,
    RANK_SUSPECT,
    RANK_EVICTED,
    DRAIN_BEGIN,
    DRAIN_COMMIT,
    STRAGGLER_WARNING,
    CYCLE,
    LINK_RECONNECT,
)

# The port's execution activity -> the reference's name for the same
# span (XLA_ALLTOALL has no constant there; its eager engine writes it).
REFERENCE_NAMES = {f"{backend}_{op}": f"XLA_{op}"
                   for backend in ("NCCL", "GLOO")
                   for op in ("ALLREDUCE", "ALLGATHER", "BCAST",
                              "REDUCESCATTER", "ALLTOALL")}

_OP_NAMES = {"allreduce": "ALLREDUCE", "allgather": "ALLGATHER",
             "broadcast": "BCAST", "reducescatter": "REDUCESCATTER",
             "alltoall": "ALLTOALL"}


def execution_activity(kind: str, device_type: str) -> str:
    """The execution activity of a ``kind`` collective ("allreduce",
    "broadcast", ...) run on a ``device_type`` ("cuda": NCCL, "cpu":
    gloo)."""
    backend = "NCCL" if device_type == "cuda" else "GLOO"
    return f"{backend}_{_OP_NAMES[kind]}"


def negotiate_activity(kind: str) -> str:
    """The negotiation span of a ``kind`` collective (the reference's
    ``NEGOTIATE_<KIND>``)."""
    return f"NEGOTIATE_{kind.upper()}"


class Timeline:
    """Chrome-tracing JSON writer with a background writer thread."""

    def __init__(self, filename: str, mark_cycles: bool = False):
        self._filename = filename
        self._mark_cycles = mark_cycles
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._start_ns = time.monotonic_ns()
        self._pid = os.getpid()
        self._tensor_tids = {}
        self._next_tid = 1
        self._tid_lock = threading.Lock()
        self._closed = False
        self._file = open(filename, "w")
        self._file.write("[\n")
        self._writer = threading.Thread(target=self._drain, daemon=True,
                                        name="hvd-timeline-writer")
        self._writer.start()

    # -- event API -----------------------------------------------------------

    def _ts_us(self) -> float:
        return (time.monotonic_ns() - self._start_ns) / 1e3

    def _tid(self, tensor_name: str) -> int:
        # The caller's thread and the executor's both name tensors: one
        # lock keeps each name's tid and its metadata event unique.
        with self._tid_lock:
            tid = self._tensor_tids.get(tensor_name)
            if tid is None:
                tid = self._next_tid
                self._next_tid += 1
                self._tensor_tids[tensor_name] = tid
                self._emit(
                    {
                        "name": "thread_name",
                        "ph": "M",
                        "pid": self._pid,
                        "tid": tid,
                        "args": {"name": tensor_name},
                    }
                )
        return tid

    def _emit(self, ev: dict):
        if not self._closed:
            self._queue.put(ev)

    def start_activity(self, tensor_name: str, activity: str):
        self._emit(
            {
                "name": activity,
                "ph": "B",
                "pid": self._pid,
                "tid": self._tid(tensor_name),
                "ts": self._ts_us(),
            }
        )

    def end_activity(self, tensor_name: str, activity: str):
        self._emit(
            {
                "name": activity,
                "ph": "E",
                "pid": self._pid,
                "tid": self._tid(tensor_name),
                "ts": self._ts_us(),
            }
        )

    def instant(self, name: str, args: Optional[dict] = None):
        self._emit(
            {
                "name": name,
                "ph": "i",
                "s": "g",
                "pid": self._pid,
                "tid": 0,
                "ts": self._ts_us(),
                "args": args or {},
            }
        )

    def rank_ready(self, tensor_name: str, rank: int,
                   mono_ns: Optional[int] = None):
        """A per-rank negotiation tick: when ``rank``'s submission of
        ``tensor_name`` reached the coordinator, inside the NEGOTIATE span.
        ``mono_ns`` is a CLOCK_MONOTONIC time (the native controller's
        clock, the same as ``time.monotonic_ns``)."""
        ts = (self._ts_us() if mono_ns is None
              else (mono_ns - self._start_ns) / 1e3)
        self._emit(
            {
                "name": f"RANK_READY[{rank}]",
                "ph": "i",
                "s": "t",
                "pid": self._pid,
                "tid": self._tid(tensor_name),
                "ts": ts,
                "args": {"rank": rank},
            }
        )

    def counter(self, name: str, values: dict):
        """A counter event ("C" phase): ``values`` maps series name to a
        number (the metrics pump's byte and control counters)."""
        self._emit(
            {
                "name": name,
                "ph": "C",
                "pid": self._pid,
                "ts": self._ts_us(),
                "args": values,
            }
        )

    def mark_cycle(self):
        if self._mark_cycles:
            self.instant(CYCLE)

    # -- writer thread -------------------------------------------------------

    def _drain(self):
        first = True
        while True:
            ev = self._queue.get()
            if ev is None:
                break
            if not first:
                self._file.write(",\n")
            first = False
            self._file.write(json.dumps(ev))
        self._file.write("\n]\n")
        self._file.flush()
        self._file.close()

    def close(self):
        if not self._closed:
            self._closed = True
            self._queue.put(None)
            self._writer.join(timeout=5.0)
