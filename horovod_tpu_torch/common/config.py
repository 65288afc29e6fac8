"""Environment knobs the port reads — the port's own copy.

The names are those of ``horovod_tpu/common/config.py``, so one launcher
environment drives both packages. Only the knobs the port reads are
here; each has one accessor with one default and one parse. The native
core (``csrc/hvd``) reads its own transport knobs (``HOROVOD_SHM``,
``HOROVOD_STRIPES``, ...) from the environment itself; their accessors
here are the Python side's reading of the same variables. Also here: the
fault-spec and chaos-spec grammars (``common/faults.py``) and the shared
retry policy (``faults.Retrier``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
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
HOROVOD_NATIVE_SANITIZE = "HOROVOD_NATIVE_SANITIZE"
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
# The timeline (common/timeline.py) and the autotuner
# (common/parameter_manager.py).
HOROVOD_TIMELINE = "HOROVOD_TIMELINE"
HOROVOD_TIMELINE_MARK_CYCLES = "HOROVOD_TIMELINE_MARK_CYCLES"
HOROVOD_AUTOTUNE = "HOROVOD_AUTOTUNE"
HOROVOD_AUTOTUNE_LOG = "HOROVOD_AUTOTUNE_LOG"
HOROVOD_AUTOTUNE_WARMUP_SAMPLES = "HOROVOD_AUTOTUNE_WARMUP_SAMPLES"
HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE = "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE"
HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES = "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES"
HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE = "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE"
# The host world (common/host_world.py) and its staging through NCCL
# (common/host_staging.py); the names are the JAX package's, where the
# staging went through XLA.
HOROVOD_ELASTIC = "HOROVOD_ELASTIC"
# The elastic worker (common/host_world.py, elastic/, run/): the driver's
# rendezvous KV, its notification key, the preemption signal, the rejoin
# and drain graces and the blacklist strikes.
HOROVOD_RENDEZVOUS_ADDR = "HOROVOD_GLOO_RENDEZVOUS_ADDR"
HOROVOD_RENDEZVOUS_PORT = "HOROVOD_GLOO_RENDEZVOUS_PORT"
HOROVOD_SECRET_KEY = "HOROVOD_SECRET_KEY"
HOROVOD_ELASTIC_PREEMPT_SIGNAL = "HOROVOD_ELASTIC_PREEMPT_SIGNAL"
HOROVOD_ELASTIC_REJOIN_GRACE = "HOROVOD_ELASTIC_REJOIN_GRACE"
HOROVOD_DRAIN_GRACE_MS = "HOROVOD_DRAIN_GRACE_MS"
DEFAULT_DRAIN_GRACE_MS = 5000
HOROVOD_ELASTIC_BLACKLIST_STRIKES = "HOROVOD_ELASTIC_BLACKLIST_STRIKES"
DEFAULT_BLACKLIST_STRIKES = 3
# The elastic driver's parole (run/elastic/discovery.py).
HOROVOD_ELASTIC_PAROLE_WINDOW = "HOROVOD_ELASTIC_PAROLE_WINDOW"
DEFAULT_PAROLE_WINDOW_SECONDS = 300.0
HOROVOD_HOST_VIA_XLA = "HOROVOD_HOST_VIA_XLA"
HOROVOD_HOST_VIA_XLA_THRESHOLD = "HOROVOD_HOST_VIA_XLA_THRESHOLD"
DEFAULT_HOST_VIA_XLA_THRESHOLD = 1 << 20  # 1 MiB fused response
# The host ring's transports and control plane (read by csrc/hvd too).
HOROVOD_HIER_CONTROL = "HOROVOD_HIER_CONTROL"
HOROVOD_SHM = "HOROVOD_SHM"
HOROVOD_SHM_SLOT_BYTES = "HOROVOD_SHM_SLOT_BYTES"
HOROVOD_SHM_FALLBACK = "HOROVOD_SHM_FALLBACK"
HOROVOD_STRIPES = "HOROVOD_STRIPES"
HOROVOD_CHUNK_BYTES = "HOROVOD_CHUNK_BYTES"
HOROVOD_STRIPE_FALLBACK = "HOROVOD_STRIPE_FALLBACK"
HOROVOD_JOB_KEY = "HOROVOD_JOB_KEY"
HOROVOD_RING_TREE_THRESHOLD = "HOROVOD_RING_TREE_THRESHOLD"
DEFAULT_RING_TREE_THRESHOLD = 16384  # csrc/hvd/ring_ops.cc TreeThresholdBytes
HOROVOD_MAX_FRAME_BYTES = "HOROVOD_MAX_FRAME_BYTES"
DEFAULT_MAX_FRAME_BYTES = 1073741824  # 1 GiB; csrc/hvd/socket.cc MaxFrameBytes
HOROVOD_LINK_RETRY_ATTEMPTS = "HOROVOD_LINK_RETRY_ATTEMPTS"
HOROVOD_LINK_RETRY_BACKOFF_MS = "HOROVOD_LINK_RETRY_BACKOFF_MS"
HOROVOD_LINK_RETRY_DEADLINE_MS = "HOROVOD_LINK_RETRY_DEADLINE_MS"
DEFAULT_LINK_RETRY_ATTEMPTS = 3
DEFAULT_LINK_RETRY_BACKOFF_MS = 100
# Well below DEFAULT_LIVENESS_TIMEOUT_MS: healing must never mask a real
# death past the liveness window.
DEFAULT_LINK_RETRY_DEADLINE_MS = 3000
# The metrics pump and the straggler detector (common/metrics.py).
HOROVOD_METRICS_EXPORT = "HOROVOD_METRICS_EXPORT"
HOROVOD_METRICS_INTERVAL_MS = "HOROVOD_METRICS_INTERVAL_MS"
HOROVOD_STRAGGLER_MS = "HOROVOD_STRAGGLER_MS"
HOROVOD_STRAGGLER_PATIENCE = "HOROVOD_STRAGGLER_PATIENCE"
DEFAULT_METRICS_INTERVAL_MS = 5000
DEFAULT_STRAGGLER_MS = 100
DEFAULT_STRAGGLER_PATIENCE = 3
# Fault injection and the shared retry policy (common/faults.py).
HOROVOD_FAULT_SPEC = "HOROVOD_FAULT_SPEC"
HOROVOD_CHAOS_SPEC = "HOROVOD_CHAOS_SPEC"
HOROVOD_RETRY_PREFIX = "HOROVOD_RETRY"

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


# The elastic rendezvous's plan for the current round
# (``host_world.elastic_rendezvous``): while set, it takes the place of the
# launcher's rank block and controller endpoint, so every reader of the
# world's layout sees the round's.
_round_world: "dict | None" = None


def set_round_world(world) -> None:
    """Install (a dict with ``rank``, ``size``, ``local_rank``,
    ``local_size``, ``cross_rank``, ``cross_size``, ``addr``, ``port``)
    or clear (None) the elastic round's layout."""
    global _round_world
    _round_world = dict(world) if world is not None else None


def round_world():
    """The elastic round's layout (a copy), or None."""
    return None if _round_world is None else dict(_round_world)


def _round(key: str):
    return None if _round_world is None else _round_world[key]


def rank() -> int:
    """This process's global rank (0 when unlaunched)."""
    r = _round("rank")
    return r if r is not None else _get_int(HOROVOD_RANK, 0)


def size() -> int:
    """The world's size (1 when unlaunched)."""
    r = _round("size")
    return r if r is not None else _get_int(HOROVOD_SIZE, 1)


def rank_string():
    """The raw ``HOROVOD_RANK`` value, ``None`` when not launched (the
    log prefix wants presence, not a parsed 0)."""
    return os.environ.get(HOROVOD_RANK)


def local_rank() -> int:
    """This process's rank on its host (0 when unlaunched)."""
    r = _round("local_rank")
    return r if r is not None else slot_local_rank()


def slot_local_rank() -> int:
    """The launch-time local rank: with ``hostname()`` the identity of
    this worker's slot in the elastic driver's KV, fixed for the life of
    the process while the rank moves."""
    return _get_int(HOROVOD_LOCAL_RANK, 0)


def local_size(default: int) -> int:
    """Processes on this host; the caller supplies the fallback."""
    r = _round("local_size")
    return r if r is not None else _get_int(HOROVOD_LOCAL_SIZE, default)


def cross_rank(default: int) -> int:
    """Host index; the caller supplies the fallback."""
    r = _round("cross_rank")
    return r if r is not None else _get_int(HOROVOD_CROSS_RANK, default)


def cross_size(default: int) -> int:
    """Host count; the caller supplies the fallback."""
    r = _round("cross_size")
    return r if r is not None else _get_int(HOROVOD_CROSS_SIZE, default)


def controller_addr() -> str:
    """The rendezvous host for the process group's TCP store."""
    r = _round("addr")
    return r if r is not None else os.environ.get(HOROVOD_CONTROLLER_ADDR,
                                                  "127.0.0.1")


def controller_base_port() -> int:
    """The rendezvous port for the process group's TCP store."""
    r = _round("port")
    return r if r is not None else _get_int(HOROVOD_CONTROLLER_PORT, 29500)


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


NATIVE_SANITIZE_CHOICES = ("tsan", "asan")


def native_sanitize() -> str:
    """The sanitizer variant of the native core to build and load, ""
    for the production library. ``HOROVOD_NATIVE_SANITIZE=tsan`` or
    ``asan`` selects ``libhvdcore-<hash>-{tsan,asan}.so``
    (``common/native.py``), built beside the production library, never
    in its place; "", "0", "none" and "off" mean the production library,
    and any other value warns and is ignored. Read when the process first
    loads the library. An instrumented library needs its sanitizer's
    runtime loaded first: ``LD_PRELOAD=$(g++ -print-file-name=libtsan.so)``
    (or ``libasan.so``)."""
    v = os.environ.get(HOROVOD_NATIVE_SANITIZE, "").strip().lower()
    if v in ("", "0", "none", "off"):
        return ""
    if v in NATIVE_SANITIZE_CHOICES:
        return v
    from . import logging as _log

    _log.warning(f"{HOROVOD_NATIVE_SANITIZE}={v!r} is not one of "
                 f"{sorted(NATIVE_SANITIZE_CHOICES)}; ignoring "
                 f"(loading the production library)")
    return ""


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


def elastic_enabled() -> bool:
    """Whether the launcher asked for an elastic world (``HOROVOD_ELASTIC``,
    the ``EnvFlag`` grammar): every (re-)init then takes the world's
    layout from the elastic driver's rendezvous KV."""
    return _get_bool(HOROVOD_ELASTIC)


def rendezvous_addr():
    """The elastic rendezvous KV's host, ``None`` when not under the
    elastic driver (empty counts as unset)."""
    return os.environ.get(HOROVOD_RENDEZVOUS_ADDR) or None


def rendezvous_port():
    """The elastic rendezvous KV's port, ``None`` when unset or not a
    number (which warns: callers then run without the KV, and that must
    not look like a launcher that never exported the port)."""
    v = os.environ.get(HOROVOD_RENDEZVOUS_PORT)
    if not v:
        return None
    try:
        return int(v)
    except ValueError:
        _log.warning(f"{HOROVOD_RENDEZVOUS_PORT}={v!r} is not a valid port; "
                     "elastic rendezvous registration disabled")
        return None


def rendezvous_port_string():
    """The raw rendezvous port, ``None`` when unset or empty (for errors
    that must show a value that did not parse)."""
    return os.environ.get(HOROVOD_RENDEZVOUS_PORT) or None


def secret_key_b64():
    """The elastic driver's base64 notification key; ``None`` when this
    process was not launched by the elastic driver."""
    return os.environ.get(HOROVOD_SECRET_KEY) or None


def preempt_signal_spec() -> str:
    """The opt-in preemption signal (a name or a number; empty: none)."""
    return os.environ.get(HOROVOD_ELASTIC_PREEMPT_SIGNAL, "").strip()


def rejoin_grace_env():
    """The operator's rejoin grace in seconds, ``None`` when unset (the
    grace the driver publishes in the KV applies then)."""
    if not os.environ.get(HOROVOD_ELASTIC_REJOIN_GRACE):
        return None
    return _get_float(HOROVOD_ELASTIC_REJOIN_GRACE, 10.0)


def drain_grace_ms() -> int:
    """How long a preempted worker gets to commit and say DRAIN before
    it force-exits."""
    return max(1, _get_int(HOROVOD_DRAIN_GRACE_MS, DEFAULT_DRAIN_GRACE_MS))


def blacklist_strikes() -> int:
    """Failures a host absorbs before its blacklist turns permanent."""
    return max(1, _get_int(HOROVOD_ELASTIC_BLACKLIST_STRIKES,
                           DEFAULT_BLACKLIST_STRIKES))


def parole_window_seconds() -> float:
    """How long a host returning from blacklist cooldown must run clean
    before its strike count resets (0 disables strike decay)."""
    return _get_float(HOROVOD_ELASTIC_PAROLE_WINDOW,
                      DEFAULT_PAROLE_WINDOW_SECONDS)


# ---- fault injection (common/faults.py) ------------------------------------
#
# HOROVOD_FAULT_SPEC grammar:  spec(;spec)*
#   spec  = point(:key=value)*
#   point = dotted fault-point name, e.g. "ring.exec" (see faults.CATALOG)
#   keys  = rank  (int; only this rank fires — default: every rank)
#           step  (int; fire on the Nth hit of the point in this process,
#                  0-based — default: every hit)
#           kind  (raise | delay_ms | exit | drop_conn — default: raise)
#           ms    (float; delay for kind=delay_ms — default 100)
#           code  (int; exit status for kind=exit — default 13)
#           times (int; max fires — default 1 when step given, else
#                  unlimited)
#
# e.g. HOROVOD_FAULT_SPEC="ring.exec:rank=1:step=3:kind=exit"
# Parsing is strict: a malformed spec raises instead of injecting nothing,
# so a chaos test whose fault never fires cannot pass by accident.

FAULT_KINDS = ("raise", "delay_ms", "exit", "drop_conn")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    point: str
    rank: int = -1          # -1 = any rank
    step: int = -1          # -1 = every hit
    kind: str = "raise"
    ms: float = 100.0
    code: int = 13
    times: int = 0          # 0 = unlimited


def parse_fault_spec(text: str) -> tuple:
    """Parse a ``HOROVOD_FAULT_SPEC`` string into ``FaultSpec`` tuples.
    Raises ``ValueError`` on any malformed field."""
    specs = []
    for chunk in text.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        fields = chunk.split(":")
        point = fields[0].strip()
        if not point:
            raise ValueError(f"fault spec {chunk!r}: empty point name")
        kw = {"point": point}
        for field in fields[1:]:
            if "=" not in field:
                raise ValueError(
                    f"fault spec {chunk!r}: field {field!r} is not "
                    f"key=value")
            key, _, val = field.partition("=")
            key = key.strip()
            val = val.strip()
            try:
                if key in ("rank", "step", "code", "times"):
                    kw[key] = int(val)
                elif key == "ms":
                    kw[key] = float(val)
                elif key == "kind":
                    if val not in FAULT_KINDS:
                        raise ValueError(
                            f"unknown kind {val!r} (choices: "
                            f"{', '.join(FAULT_KINDS)})")
                    kw[key] = val
                else:
                    raise ValueError(f"unknown key {key!r}")
            except ValueError as e:
                raise ValueError(f"fault spec {chunk!r}: {e}") from None
        if "times" not in kw and kw.get("step", -1) >= 0:
            kw["times"] = 1  # a step-pinned fault is one-shot by default
        specs.append(FaultSpec(**kw))
    return tuple(specs)


def parse_fault_spec_env() -> tuple:
    """The active fault specs from ``HOROVOD_FAULT_SPEC`` (empty when
    unset)."""
    text = os.environ.get(HOROVOD_FAULT_SPEC)
    return parse_fault_spec(text) if text else ()


# HOROVOD_CHAOS_SPEC grammar:  key=value(,key=value)*
#   seed   (int, required)  rng seed: the schedule is a pure function of
#                           the spec string, on every run and rank
#   n      (int, required)  number of faults to draw
#   kinds  (a|b|...)        draw pool (default "drop_conn|delay_ms")
#   points (p|q|...)        fault-point pool (default
#                           "ring.exec|ring.hier.cross")
#   ranks  (0|1|...)        rank pool (default: every rank, 0..size-1)
#   steps  (lo-hi)          inclusive hit-index window (default 0-10)
#   ms     (float)          delay of drawn delay_ms faults (default 50)
#   code   (int)            exit status of drawn exit faults (default 13)

CHAOS_DEFAULT_KINDS = "drop_conn|delay_ms"
CHAOS_DEFAULT_POINTS = "ring.exec|ring.hier.cross"


def chaos_spec() -> str:
    """The seeded chaos schedule's spec, "" when unset."""
    return os.environ.get(HOROVOD_CHAOS_SPEC, "").strip()


def parse_chaos_spec(text: str, size: int = 0) -> tuple:
    """Compile a ``HOROVOD_CHAOS_SPEC`` string into one-shot ``FaultSpec``
    tuples, deterministically from its seed (draw order per fault: point,
    rank, step, kind). ``size`` bounds the default rank pool; 0 falls back
    to ``HOROVOD_SIZE``. Raises ``ValueError`` on any malformed or unknown
    field."""
    fields = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"chaos spec field {part!r} is not key=value")
        key, _, val = part.partition("=")
        fields[key.strip()] = val.strip()
    try:
        seed = int(fields.pop("seed"))
        n = int(fields.pop("n"))
    except KeyError as e:
        raise ValueError(f"chaos spec {text!r}: missing required "
                         f"field {e.args[0]}") from None
    if n < 0:
        raise ValueError(f"chaos spec {text!r}: n must be >= 0")
    kinds = tuple(k.strip() for k in
                  fields.pop("kinds", CHAOS_DEFAULT_KINDS).split("|"))
    for k in kinds:
        if k not in FAULT_KINDS:
            raise ValueError(f"chaos spec {text!r}: unknown kind {k!r} "
                             f"(choices: {', '.join(FAULT_KINDS)})")
    points = tuple(p.strip() for p in
                   fields.pop("points", CHAOS_DEFAULT_POINTS).split("|"))
    ranks_txt = fields.pop("ranks", "")
    if ranks_txt:
        ranks = tuple(int(r) for r in ranks_txt.split("|"))
    else:
        world = size if size > 0 else max(1, _get_int(HOROVOD_SIZE, 1))
        ranks = tuple(range(world))
    steps_txt = fields.pop("steps", "0-10")
    lo, sep, hi = steps_txt.partition("-")
    if not sep:
        raise ValueError(f"chaos spec {text!r}: steps must be lo-hi")
    step_lo, step_hi = int(lo), int(hi)
    if step_lo < 0 or step_hi < step_lo:
        raise ValueError(f"chaos spec {text!r}: bad steps window "
                         f"{steps_txt!r}")
    ms = float(fields.pop("ms", 50.0))
    code = int(fields.pop("code", 13))
    if fields:
        raise ValueError(f"chaos spec {text!r}: unknown key(s) "
                         f"{', '.join(sorted(fields))}")
    rng = random.Random(seed)
    specs = []
    for _ in range(n):
        point = rng.choice(points)
        rank = rng.choice(ranks)
        step = rng.randint(step_lo, step_hi)
        kind = rng.choice(kinds)
        specs.append(FaultSpec(point=point, rank=rank, step=step,
                               kind=kind, ms=ms, code=code, times=1))
    return tuple(specs)


def parse_chaos_spec_env(size: int = 0) -> tuple:
    """The compiled chaos schedule from ``HOROVOD_CHAOS_SPEC`` (empty when
    unset)."""
    text = chaos_spec()
    return parse_chaos_spec(text, size=size) if text else ()


# ---- the shared retry policy (faults.Retrier) ------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with full jitter and an overall deadline.
    ``max_attempts=0``: unlimited (bounded by ``deadline``);
    ``deadline=0``: no overall deadline (bounded by attempts)."""

    max_attempts: int = 3
    base_delay: float = 0.5
    max_delay: float = 15.0
    multiplier: float = 2.0
    deadline: float = 0.0
    jitter: bool = True


_RETRY_FIELD_ENV = {
    "max_attempts": ("MAX_ATTEMPTS", int),
    "base_delay": ("BASE_DELAY", float),
    "max_delay": ("MAX_DELAY", float),
    "multiplier": ("MULTIPLIER", float),
    "deadline": ("DEADLINE", float),
}


def retry_policy_from_env(scope: str = "", pinned=(),
                          **defaults) -> RetryPolicy:
    """A ``RetryPolicy`` with env precedence per field:
    ``HOROVOD_RETRY_<SCOPE>_<FIELD>`` > ``HOROVOD_RETRY_<FIELD>`` >
    ``defaults``. ``pinned`` fields keep their coded values (a correctness
    contract, not a tuning knob). An unparseable value falls back a
    level."""
    kw = dict(defaults)
    scope = scope.strip().upper().replace(".", "_")
    for field, (suffix, conv) in _RETRY_FIELD_ENV.items():
        if field in pinned:
            continue
        names = [f"{HOROVOD_RETRY_PREFIX}_{suffix}"]
        if scope:
            names.insert(0, f"{HOROVOD_RETRY_PREFIX}_{scope}_{suffix}")
        for name in names:
            v = os.environ.get(name)
            if v is None:
                continue
            try:
                kw[field] = conv(v)
                break
            except ValueError:
                continue
    return RetryPolicy(**kw)


# ---- the host ring's knobs (csrc/hvd parses the same variables) ------------


def hier_control_enabled() -> bool:
    """The hierarchical control plane (per-host leaders aggregate their
    members' request frames); off by default. Must agree across ranks."""
    return _get_bool(HOROVOD_HIER_CONTROL)


def shm_enabled() -> bool:
    """The shared-memory intra-host transport for the host ring's local
    legs (TCP stays the registered fallback); off by default. Must agree
    across ranks."""
    return _get_bool(HOROVOD_SHM)


def shm_slot_bytes():
    """The shm ring's slot size in bytes, None when unset (the core then
    derives it from the fusion cap)."""
    v = os.environ.get(HOROVOD_SHM_SLOT_BYTES)
    if not v:
        return None
    try:
        n = int(v)
    except ValueError:
        return None
    return n if n > 0 else None


def shm_fallback_enabled() -> bool:
    """Whether a failed shm attach falls through to TCP (default on)."""
    return _get_bool(HOROVOD_SHM_FALLBACK, default=True)


def job_key() -> str:
    """The per-job isolation token of the controller's hello ("" when
    unset)."""
    return os.environ.get(HOROVOD_JOB_KEY, "")


def ring_tree_threshold() -> int:
    """Allreduces at or under this many wire bytes take the binomial tree
    instead of the ring (default 16 KiB). Must agree across ranks."""
    v = _get_int(HOROVOD_RING_TREE_THRESHOLD, DEFAULT_RING_TREE_THRESHOLD)
    return v if v >= 0 else DEFAULT_RING_TREE_THRESHOLD


def max_frame_bytes() -> int:
    """The largest frame a peer can make this process allocate, clamped to
    [64 KiB, 1 GiB]."""
    v = _get_int(HOROVOD_MAX_FRAME_BYTES, DEFAULT_MAX_FRAME_BYTES)
    return max(64 * 1024, min(DEFAULT_MAX_FRAME_BYTES, v))


def stripes() -> int:
    """Parallel TCP connections per cross-host leader pair, in [1, 32]
    (1: one socket). Must agree across ranks."""
    return max(1, min(32, _get_int(HOROVOD_STRIPES, 1)))


def chunk_bytes():
    """The striped transport's pipeline chunk in bytes, None when unset
    (the core then uses 256 KiB). Must agree across ranks."""
    v = os.environ.get(HOROVOD_CHUNK_BYTES)
    if not v:
        return None
    try:
        n = int(v)
    except ValueError:
        return None
    return n if n > 0 else None


def stripe_fallback_enabled() -> bool:
    """Whether a failed stripe connect falls through to one socket
    (default on)."""
    return _get_bool(HOROVOD_STRIPE_FALLBACK, default=True)


def link_retry_attempts() -> int:
    """In-place redials of a failed cross-host link before the failure
    escalates; 0 disables healing."""
    return max(0, _get_int(HOROVOD_LINK_RETRY_ATTEMPTS,
                           DEFAULT_LINK_RETRY_ATTEMPTS))


def link_retry_backoff_ms() -> int:
    """Sleep between in-place redials, in ms (flat)."""
    return max(1, _get_int(HOROVOD_LINK_RETRY_BACKOFF_MS,
                           DEFAULT_LINK_RETRY_BACKOFF_MS))


def link_retry_deadline_ms() -> int:
    """Wall-clock budget for healing one link failure, in ms; keep it well
    below ``HOROVOD_LIVENESS_TIMEOUT_MS``."""
    return max(1, _get_int(HOROVOD_LINK_RETRY_DEADLINE_MS,
                           DEFAULT_LINK_RETRY_DEADLINE_MS))


# ---- the metrics pump and the straggler detector ---------------------------


def metrics_export_path():
    """The Prometheus textfile the pump rewrites, None when unset: then no
    pump thread starts, no file is written and no timeline counter events
    are emitted."""
    return os.environ.get(HOROVOD_METRICS_EXPORT) or None


def metrics_interval_ms() -> int:
    """How often the pump snapshots and publishes (at least 100 ms)."""
    return max(100, _get_int(HOROVOD_METRICS_INTERVAL_MS,
                             DEFAULT_METRICS_INTERVAL_MS))


def straggler_ms() -> int:
    """EWMA lag behind the ready group's fastest rank at which the
    coordinator's straggler detector warns (the core reads it too)."""
    return max(1, _get_int(HOROVOD_STRAGGLER_MS, DEFAULT_STRAGGLER_MS))


def straggler_patience() -> int:
    """Consecutive ready groups a rank must arrive last before a warning
    can fire (the core reads it too)."""
    return max(1, _get_int(HOROVOD_STRAGGLER_PATIENCE,
                           DEFAULT_STRAGGLER_PATIENCE))


@dataclasses.dataclass
class RuntimeConfig:
    """The knobs ``init()`` freezes; "explicit" means set in the env."""

    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES
    fusion_threshold_explicit: bool = False
    compression: str = "none"
    compression_explicit: bool = False
    # Stage-3 gather prefetch depth; explicit means env-set or pinned by
    # the autotuner (fusion.resolve_prefetch_depth("auto") prefers it).
    zero_prefetch: int = DEFAULT_ZERO_PREFETCH
    zero_prefetch_explicit: bool = False
    # The native core's cycle, response cache and stall inspector, and the
    # eager plane's hierarchical dispatch.
    cycle_time_ms: float = DEFAULT_CYCLE_TIME_MS
    cache_capacity: int = DEFAULT_CACHE_CAPACITY
    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False
    stall_check_disable: bool = False
    stall_warning_seconds: float = DEFAULT_STALL_WARNING_SECONDS
    stall_shutdown_seconds: float = 0.0
    # The timeline (written by the rank whose env names a file) and the
    # autotuner (rank 0).
    timeline_filename: str = ""
    timeline_mark_cycles: bool = False
    autotune: bool = False
    autotune_log: str = ""
    autotune_warmup_samples: int = 3
    autotune_steps_per_sample: int = 10
    autotune_bayes_opt_max_samples: int = 20
    autotune_gaussian_process_noise: float = 0.8
    # Host staging through NCCL (common/host_staging.py).
    host_via_xla: bool = False
    host_via_xla_threshold: int = DEFAULT_HOST_VIA_XLA_THRESHOLD

    @classmethod
    def from_env(cls) -> "RuntimeConfig":
        fusion, fusion_explicit = _get_int_explicit(
            HOROVOD_FUSION_THRESHOLD, DEFAULT_FUSION_THRESHOLD_BYTES)
        comp, comp_explicit = _get_choice_explicit(
            HOROVOD_COMPRESSION, COMPRESSION_CHOICES, "none")
        prefetch, prefetch_explicit = zero_prefetch_env()
        return cls(
            fusion_threshold_bytes=fusion,
            fusion_threshold_explicit=fusion_explicit,
            compression=comp, compression_explicit=comp_explicit,
            zero_prefetch=prefetch, zero_prefetch_explicit=prefetch_explicit,
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
                HOROVOD_STALL_SHUTDOWN_TIME_SECONDS, 0.0),
            timeline_filename=os.environ.get(HOROVOD_TIMELINE, ""),
            timeline_mark_cycles=_get_bool(HOROVOD_TIMELINE_MARK_CYCLES),
            autotune=_get_bool(HOROVOD_AUTOTUNE),
            autotune_log=os.environ.get(HOROVOD_AUTOTUNE_LOG, ""),
            autotune_warmup_samples=_get_int(
                HOROVOD_AUTOTUNE_WARMUP_SAMPLES, 3),
            autotune_steps_per_sample=_get_int(
                HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE, 10),
            autotune_bayes_opt_max_samples=_get_int(
                HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES, 20),
            autotune_gaussian_process_noise=_get_float(
                HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE, 0.8),
            host_via_xla=_get_bool(HOROVOD_HOST_VIA_XLA),
            host_via_xla_threshold=_get_int(
                HOROVOD_HOST_VIA_XLA_THRESHOLD,
                DEFAULT_HOST_VIA_XLA_THRESHOLD))
