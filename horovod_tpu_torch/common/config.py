"""Environment knobs the port reads — the port's own copy.

The names are those of ``horovod_tpu/common/config.py``, so one launcher
environment drives both packages. Only the knobs the port reads are
here; each has one accessor with one default and one parse. The native
core (``csrc/hvd``) reads its own transport knobs (``HOROVOD_SHM``,
``HOROVOD_STRIPES``, ...) from the environment itself.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import socket

HOROVOD_RANK = "HOROVOD_RANK"
HOROVOD_SIZE = "HOROVOD_SIZE"
HOROVOD_LOCAL_RANK = "HOROVOD_LOCAL_RANK"
HOROVOD_LOCAL_SIZE = "HOROVOD_LOCAL_SIZE"
HOROVOD_CROSS_RANK = "HOROVOD_CROSS_RANK"
HOROVOD_CROSS_SIZE = "HOROVOD_CROSS_SIZE"
HOROVOD_CONTROLLER_ADDR = "HOROVOD_CONTROLLER_ADDR"
HOROVOD_CONTROLLER_PORT = "HOROVOD_CONTROLLER_PORT"
HOROVOD_FUSION_THRESHOLD = "HOROVOD_FUSION_THRESHOLD"
HOROVOD_COMPRESSION = "HOROVOD_COMPRESSION"
# ZeRO partitioning (zero.py): which tensors are partitioned 1/d across
# the ranks, and how far ahead the stage-3 parameter gathers may run.
HOROVOD_ZERO_STAGE = "HOROVOD_ZERO_STAGE"
HOROVOD_ZERO_PREFETCH = "HOROVOD_ZERO_PREFETCH"
# The native core of the eager plane (common/native.py, ops/eager.py).
HOROVOD_NATIVE = "HOROVOD_NATIVE"
HOROVOD_CYCLE_TIME = "HOROVOD_CYCLE_TIME"
HOROVOD_CACHE_CAPACITY = "HOROVOD_CACHE_CAPACITY"
HOROVOD_HIERARCHICAL_ALLREDUCE = "HOROVOD_HIERARCHICAL_ALLREDUCE"
HOROVOD_HIERARCHICAL_ALLGATHER = "HOROVOD_HIERARCHICAL_ALLGATHER"
HOROVOD_STALL_CHECK_DISABLE = "HOROVOD_STALL_CHECK_DISABLE"
HOROVOD_STALL_CHECK_TIME_SECONDS = "HOROVOD_STALL_CHECK_TIME_SECONDS"
HOROVOD_STALL_SHUTDOWN_TIME_SECONDS = "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"
HOROVOD_HEARTBEAT_MS = "HOROVOD_HEARTBEAT_MS"
HOROVOD_LIVENESS_TIMEOUT_MS = "HOROVOD_LIVENESS_TIMEOUT_MS"
HOROVOD_HOSTNAME = "HOROVOD_HOSTNAME"
HOROVOD_LOG_LEVEL = "HOROVOD_LOG_LEVEL"
HOROVOD_LOG_HIDE_TIME = "HOROVOD_LOG_HIDE_TIME"

DEFAULT_FUSION_THRESHOLD_BYTES = 64 * 1024 * 1024
DEFAULT_ZERO_STAGE = 2
DEFAULT_ZERO_PREFETCH = 1
DEFAULT_CYCLE_TIME_MS = 5.0
DEFAULT_CACHE_CAPACITY = 1024
DEFAULT_STALL_WARNING_SECONDS = 60.0
DEFAULT_LIVENESS_TIMEOUT_MS = 10000

# On-wire gradient compression modes (common/compression.py).
COMPRESSION_CHOICES = ("none", "fp16", "bf16", "ef16")

_log = logging.getLogger("horovod_tpu_torch")


def _get_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    try:
        return int(v) if v is not None else default
    except ValueError:
        return default


def _get_bool(name: str, default: bool = False) -> bool:
    """"1"/"true"/"yes"/"on" enable, anything else disables (the native
    core's ``EnvFlag`` grammar)."""
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def _get_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    try:
        return float(v) if v is not None else default
    except ValueError:
        return default


def _get_int_explicit(name: str, default: int):
    """(value, explicit): unset or unparseable gives (default, False)."""
    v = os.environ.get(name)
    try:
        return (int(v), True) if v is not None else (default, False)
    except ValueError:
        return default, False


def _get_choice_explicit(name: str, choices, default: str):
    """(value, explicit) for an enumerated knob; an unknown value warns
    and counts as unset."""
    v = os.environ.get(name)
    if v is None:
        return default, False
    v = v.strip().lower()
    if v in choices:
        return v, True
    _log.warning(f"{name}={v!r} is not one of {sorted(choices)}; "
                 f"ignoring (using {default!r})")
    return default, False


def parse_compression_env() -> str:
    """The env-level compression mode ("none" when unset or invalid)."""
    v, _ = _get_choice_explicit(HOROVOD_COMPRESSION, COMPRESSION_CHOICES,
                                "none")
    return v


def zero_stage() -> int:
    """ZeRO stage for states built with ``zero_stage="auto"``: 1 shards
    the optimizer state and fp32 masters, 2 the gradients too (each
    bucket reduce-scattered), 3 the parameters too (kept only as the
    fp32 master shard, gathered just in time). Clamped to [1, 3]."""
    return max(1, min(3, _get_int(HOROVOD_ZERO_STAGE, DEFAULT_ZERO_STAGE)))


def zero_prefetch_env():
    """(depth, explicit) of the stage-3 gather prefetch: how many bucket
    gathers beyond the one being consumed may be in flight. Clamped to
    [0, 8]."""
    v, explicit = _get_int_explicit(HOROVOD_ZERO_PREFETCH,
                                    DEFAULT_ZERO_PREFETCH)
    return max(0, min(8, v)), explicit


def rank() -> int:
    """This process's launch-time global rank (0 when unlaunched)."""
    return _get_int(HOROVOD_RANK, 0)


def size() -> int:
    """Launch-time world size (1 when unlaunched)."""
    return _get_int(HOROVOD_SIZE, 1)


def rank_string():
    """The raw ``HOROVOD_RANK`` value, ``None`` when not launched (the
    log prefix wants presence, not a parsed 0)."""
    return os.environ.get(HOROVOD_RANK)


def local_rank() -> int:
    """Launch-time rank on this host (0 when unlaunched)."""
    return _get_int(HOROVOD_LOCAL_RANK, 0)


def local_size(default: int) -> int:
    """Processes on this host; the caller supplies the fallback."""
    return _get_int(HOROVOD_LOCAL_SIZE, default)


def cross_rank(default: int) -> int:
    """Host index from the launcher; the caller supplies the fallback."""
    return _get_int(HOROVOD_CROSS_RANK, default)


def cross_size(default: int) -> int:
    """Host count from the launcher; the caller supplies the fallback."""
    return _get_int(HOROVOD_CROSS_SIZE, default)


def controller_addr() -> str:
    """The rendezvous host for the process group's TCP store."""
    return os.environ.get(HOROVOD_CONTROLLER_ADDR, "127.0.0.1")


def controller_base_port() -> int:
    """The rendezvous port for the process group's TCP store."""
    return _get_int(HOROVOD_CONTROLLER_PORT, 29500)


# The native controller listens on the process group's port + this.
NATIVE_PORT_OFFSET = 1


def native_controller_port() -> int:
    """The native controller's TCP port: the base port + 1 (the base port
    is the process group's TCP store)."""
    return controller_base_port() + NATIVE_PORT_OFFSET


def free_port_pair() -> int:
    """A base port that is free on 127.0.0.1 and whose native controller
    port is free too, for a world launched on this host."""
    for _ in range(64):
        with socket.socket() as a, socket.socket() as b:
            a.bind(("127.0.0.1", 0))
            port = a.getsockname()[1]
            try:
                b.bind(("127.0.0.1", port + NATIVE_PORT_OFFSET))
            except OSError:
                continue
            return port
    raise RuntimeError("no pair of free ports for a world")


def hostname(default=None):
    """This slot's advertised hostname (``HOROVOD_HOSTNAME``); the caller
    supplies the fallback."""
    return os.environ.get(HOROVOD_HOSTNAME, default)


def native_enabled() -> bool:
    """Whether the eager plane runs on the native core (default on).
    ``HOROVOD_NATIVE=0`` asks for direct mode: every eager collective runs
    at once on the caller's thread, with no negotiation."""
    return _get_bool(HOROVOD_NATIVE, default=True)


def heartbeat_ms() -> int:
    """Liveness heartbeat interval in ms; 0 (the default) disables the
    native core's liveness plane. Must agree across ranks."""
    return max(0, _get_int(HOROVOD_HEARTBEAT_MS, 0))


def liveness_timeout_ms() -> int:
    """Silence after which the coordinator evicts a rank (SUSPECT at half
    of it); read only with heartbeats armed."""
    return max(1, _get_int(HOROVOD_LIVENESS_TIMEOUT_MS,
                           DEFAULT_LIVENESS_TIMEOUT_MS))


def log_level_name() -> str:
    """Lower-cased ``HOROVOD_LOG_LEVEL`` ("warning" by default)."""
    return os.environ.get(HOROVOD_LOG_LEVEL, "warning").strip().lower()


def log_hide_time() -> bool:
    """Drop timestamps from log lines."""
    return _get_bool(HOROVOD_LOG_HIDE_TIME)


@dataclasses.dataclass
class RuntimeConfig:
    """The knobs ``init()`` freezes; "explicit" means set in the env."""

    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES
    fusion_threshold_explicit: bool = False
    compression: str = "none"
    compression_explicit: bool = False
    # The native core's cycle, response cache and stall inspector, and the
    # eager plane's hierarchical dispatch.
    cycle_time_ms: float = DEFAULT_CYCLE_TIME_MS
    cache_capacity: int = DEFAULT_CACHE_CAPACITY
    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False
    stall_check_disable: bool = False
    stall_warning_seconds: float = DEFAULT_STALL_WARNING_SECONDS
    stall_shutdown_seconds: float = 0.0

    @classmethod
    def from_env(cls) -> "RuntimeConfig":
        fusion, fusion_explicit = _get_int_explicit(
            HOROVOD_FUSION_THRESHOLD, DEFAULT_FUSION_THRESHOLD_BYTES)
        comp, comp_explicit = _get_choice_explicit(
            HOROVOD_COMPRESSION, COMPRESSION_CHOICES, "none")
        return cls(
            fusion_threshold_bytes=fusion,
            fusion_threshold_explicit=fusion_explicit,
            compression=comp, compression_explicit=comp_explicit,
            cycle_time_ms=_get_float(HOROVOD_CYCLE_TIME,
                                     DEFAULT_CYCLE_TIME_MS),
            cache_capacity=_get_int(HOROVOD_CACHE_CAPACITY,
                                    DEFAULT_CACHE_CAPACITY),
            hierarchical_allreduce=_get_bool(HOROVOD_HIERARCHICAL_ALLREDUCE),
            hierarchical_allgather=_get_bool(HOROVOD_HIERARCHICAL_ALLGATHER),
            stall_check_disable=_get_bool(HOROVOD_STALL_CHECK_DISABLE),
            stall_warning_seconds=_get_float(
                HOROVOD_STALL_CHECK_TIME_SECONDS,
                DEFAULT_STALL_WARNING_SECONDS),
            stall_shutdown_seconds=_get_float(
                HOROVOD_STALL_SHUTDOWN_TIME_SECONDS, 0.0))
