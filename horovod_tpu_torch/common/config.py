"""Environment knobs the port reads — the port's own copy.

The names are those of ``horovod_tpu/common/config.py``, so one launcher
environment drives both packages. Only the knobs this slice reads are
here; each has one accessor with one default and one parse.
"""

from __future__ import annotations

import dataclasses
import logging
import os

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

DEFAULT_FUSION_THRESHOLD_BYTES = 64 * 1024 * 1024
DEFAULT_ZERO_STAGE = 2
DEFAULT_ZERO_PREFETCH = 1

# On-wire gradient compression modes (common/compression.py).
COMPRESSION_CHOICES = ("none", "fp16", "bf16", "ef16")

_log = logging.getLogger("horovod_tpu_torch")


def _get_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    try:
        return int(v) if v is not None else default
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


@dataclasses.dataclass
class RuntimeConfig:
    """The knobs ``init()`` freezes; "explicit" means set in the env."""

    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES
    fusion_threshold_explicit: bool = False
    compression: str = "none"
    compression_explicit: bool = False

    @classmethod
    def from_env(cls) -> "RuntimeConfig":
        fusion, fusion_explicit = _get_int_explicit(
            HOROVOD_FUSION_THRESHOLD, DEFAULT_FUSION_THRESHOLD_BYTES)
        comp, comp_explicit = _get_choice_explicit(
            HOROVOD_COMPRESSION, COMPRESSION_CHOICES, "none")
        return cls(fusion_threshold_bytes=fusion,
                   fusion_threshold_explicit=fusion_explicit,
                   compression=comp, compression_explicit=comp_explicit)
