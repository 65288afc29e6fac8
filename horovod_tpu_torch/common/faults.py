"""Deterministic fault injection and the shared retry/backoff policy.

The port's copy of ``horovod_tpu/common/faults.py``; the catalog, the
spec grammar (``common/config.py``) and the log lines are the reference's,
so one ``HOROVOD_FAULT_SPEC`` drives both packages.

- **Fault points**: named hooks (``faults.point("ring.exec")``) at the
  host plane's seams, inert unless ``HOROVOD_FAULT_SPEC`` (or the seeded
  ``HOROVOD_CHAOS_SPEC``) arms a spec in this process. Firing is
  deterministic by rank and a per-point hit counter, so a chaos test
  that kills rank 1 on its 3rd enqueue does so on every run.
- **Retrier**: the one retry/backoff loop of the host plane: exponential
  backoff with full jitter (seeded by site name and rank), an overall
  deadline, and an on-retry callback that logs, counts
  ``retrier.retries`` and records a ``RETRY`` timeline instant.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from . import config as _config
from . import logging as _log
from .exceptions import HorovodInternalError

# Fault-point catalog. An unknown point in a spec only warns; these are
# the wired seams (the reference's names, so a spec means the same seam in
# both packages).
CATALOG = (
    "host_world.enqueue",    # HostWorld.enqueue, before the native submit
    "rendezvous.poll",       # elastic slot-layout fetch from the KV
    "rendezvous.endpoint",   # controller-endpoint poll from the KV
    "ring.exec",             # blocking wait on a host-ring collective
    "ring.hier.cross",       # same seam, armed only on a local leader of a
                             # hierarchical multi-host world
    "ring.shm.attach",       # shm-transport attach at world init:
                             # kind=raise makes THIS rank's native shm
                             # attaches fail, so TCP carries its local
                             # legs (the one kind of seam whose raise is
                             # absorbed, not propagated)
    "ring.shm.exec",         # blocking wait on a collective in a world
                             # with the shm transport active
    "ring.stripe.connect",   # striped cross-host transport connect at
                             # world init: kind=raise is absorbed like
                             # ring.shm.attach (single-socket TCP carries
                             # the cross legs)
    "ring.stripe.exec",      # blocking wait on a collective in a world
                             # with the striped cross transport armed
    "xla.exec",              # eager engine executing a device-plane
                             # response (the name is the reference's: the
                             # port's executor runs it on NCCL)
    "zero.gather",           # ZeRO stage-3 parameter-gather leg, armed
                             # as a stage-3 step starts
    "elastic.worker.start",  # driver-side worker launch (slot.rank)
    "checkpoint.write",      # CheckpointManager.save
    "control.heartbeat",     # worker heartbeat KV put
    "elastic.drain",         # preemption drain protocol
)

# Injectable for tests (fake clock, no real sleeps).
_sleep = time.sleep


class FaultInjected(HorovodInternalError):
    """Raised by ``kind=raise`` faults: a ``HorovodInternalError``, so an
    injected failure is handled exactly like a real collective failure."""


_lock = threading.Lock()
_specs: Tuple[_config.FaultSpec, ...] = ()
_hits: Dict[str, int] = {}
_fired: Dict[int, int] = {}  # spec index -> fire count
_loaded = False
# Specs at [_chaos_base:] came from HOROVOD_CHAOS_SPEC and also count
# "chaos.injected" when they fire.
_chaos_base = 0


def refresh() -> None:
    """(Re-)read ``HOROVOD_FAULT_SPEC`` and ``HOROVOD_CHAOS_SPEC`` and
    reset every hit and fire counter. Called lazily by the first
    ``point()`` of a process; call it after changing the env in-process
    (tests)."""
    global _specs, _hits, _fired, _loaded, _chaos_base
    with _lock:
        _specs = _config.parse_fault_spec_env()
        _chaos_base = len(_specs)
        _specs = _specs + _config.parse_chaos_spec_env()
        _hits = {}
        _fired = {}
        _loaded = True
        for spec in _specs:
            if spec.point not in CATALOG:
                _log.warning(
                    f"fault spec names unknown point {spec.point!r} "
                    f"(catalog: {', '.join(CATALOG)}); it will only fire "
                    f"if some code calls faults.point({spec.point!r})")


def active() -> bool:
    """True when any fault spec is armed in this process."""
    if not _loaded:
        refresh()
    return bool(_specs)


def _default_rank() -> int:
    return _config.rank()


def point(name: str, rank: Optional[int] = None) -> None:
    """A named fault point. A no-op unless a spec is armed in this
    process; hit counters advance only while armed. ``rank`` is the
    caller's rank when it knows it; the default is ``HOROVOD_RANK``."""
    if _loaded:
        if not _specs:
            return
    else:
        refresh()
        if not _specs:
            return
    with _lock:
        hit = _hits.get(name, 0)
        _hits[name] = hit + 1
        if rank is None:
            rank = _default_rank()
        to_fire = None
        chaos = False
        for i, spec in enumerate(_specs):
            if spec.point != name:
                continue
            if spec.rank >= 0 and spec.rank != rank:
                continue
            if spec.step >= 0 and spec.step != hit:
                continue
            if spec.times > 0 and _fired.get(i, 0) >= spec.times:
                continue
            _fired[i] = _fired.get(i, 0) + 1
            to_fire = spec
            chaos = i >= _chaos_base
            break
    if to_fire is None:
        return
    _fire(to_fire, name, rank, hit, chaos=chaos)


def _fire(spec: _config.FaultSpec, name: str, rank: int, hit: int,
          chaos: bool = False) -> None:
    desc = f"fault injected at {name} (rank={rank} hit={hit} " \
           f"kind={spec.kind})"
    _log.warning(desc)
    from . import metrics as _metrics

    _metrics.inc("faults.injected")
    if chaos:
        _metrics.inc("chaos.injected")
    if spec.kind == "delay_ms":
        _sleep(spec.ms / 1000.0)
        return
    if spec.kind == "exit":
        # Hard death, as if the process was killed: no atexit, no finally.
        os._exit(spec.code)
    if spec.kind == "drop_conn":
        raise ConnectionResetError(desc)
    raise FaultInjected(desc)


def voted_point(name: str, vote, rank: Optional[int] = None) -> None:
    """A fault point on a collective path (``xla.exec``, ``zero.gather``),
    where a rank that fails alone would leave its peers waiting inside the
    collective for ever. While a spec is armed, every rank hands its
    outcome to ``vote(ok) -> bool``, a MIN all-reduce over the group that
    runs the collective, and raises when any rank's point fired, so the
    failure surfaces on every rank at the same seam. The spec must be
    armed alike on every rank (one launcher environment). Inert, with no
    vote, when nothing is armed."""
    if not active():
        return
    err = None
    try:
        point(name, rank=rank)
    except (FaultInjected, ConnectionResetError) as e:
        err = e
    if not vote(err is None):
        raise err if err is not None else FaultInjected(
            f"fault injected at {name} on another rank")


# ---- shared retry/backoff -------------------------------------------------


def _timeline_instant(name: str, args: dict) -> None:
    """A timeline instant for a retry when a timeline is open (imported
    lazily: faults sits below state in the module graph)."""
    try:
        from . import state as _state

        st = _state.global_state()
        timeline = st.timeline if st.initialized else None
    except Exception:
        return
    if timeline is not None:
        timeline.instant(name, args)


def default_on_retry(name: str, attempt: int, delay: float,
                     err: Optional[BaseException]) -> None:
    """Log, count and timeline-record one retry (the Retrier's
    default)."""
    why = f" ({err})" if err is not None else ""
    _log.warning(f"{name}: attempt {attempt + 1} failed{why}; "
                 f"retrying in {delay:.2f}s")
    from . import metrics as _metrics

    _metrics.inc("retrier.retries")
    from . import timeline as _timeline

    _timeline_instant(_timeline.RETRY, {
        "site": name, "attempt": attempt, "delay_s": round(delay, 3),
        "error": str(err) if err is not None else "",
    })


class RetryExhausted(TimeoutError):
    """Raised by ``Retrier.poll`` when the deadline passes without a
    result (``Retrier.call`` re-raises the last real exception)."""


class Retrier:
    """Exponential backoff, full jitter and an overall deadline.

    The jitter's rng is seeded by ``(name, rank)``, so a schedule seen in
    one run is the schedule of every run; ``clock``/``sleep`` are
    injectable for tests.

        Retrier(policy, "kv.read").call(fn, retry_on=(OSError,))
        Retrier(policy, "endpoint").poll(fetch)   # until non-None
    """

    def __init__(self, policy: _config.RetryPolicy, name: str,
                 on_retry: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Optional[Callable[[float], None]] = None,
                 rank: Optional[int] = None):
        self.policy = policy
        self.name = name
        self._on_retry = on_retry if on_retry is not None else (
            lambda attempt, delay, err: default_on_retry(
                name, attempt, delay, err))
        self._clock = clock
        self._sleep = sleep if sleep is not None else (lambda s: _sleep(s))
        self._seed_rank = rank if rank is not None else _default_rank()
        self._rng = None   # seeded on the first jittered backoff

    def backoff(self, attempt: int) -> float:
        """The delay after ``attempt`` (0-based) failures: full jitter,
        ``uniform(0, cap)``, over an exponentially growing cap."""
        p = self.policy
        cap = min(p.max_delay, p.base_delay * (p.multiplier ** attempt))
        if not p.jitter:
            return cap
        if self._rng is None:
            self._rng = random.Random(f"{self.name}:{self._seed_rank}")
        return self._rng.uniform(0.0, cap)

    def _deadline(self) -> float:
        p = self.policy
        return self._clock() + p.deadline if p.deadline > 0 \
            else float("inf")

    def call(self, fn: Callable, retry_on: Tuple = (OSError,), *args,
             **kwargs):
        """Run ``fn`` until it returns, retrying on ``retry_on``; the final
        failure re-raises ``fn``'s own exception."""
        deadline = self._deadline()
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except retry_on as e:
                attempt += 1
                p = self.policy
                if p.max_attempts > 0 and attempt >= p.max_attempts:
                    raise
                delay = self.backoff(attempt - 1)
                if self._clock() + delay > deadline:
                    raise
                self._on_retry(attempt - 1, delay, e)
                self._sleep(delay)

    def poll(self, fn: Callable, *args, **kwargs):
        """Run ``fn`` until it returns non-None, sleeping the backoff
        schedule between polls; raises ``RetryExhausted`` at the deadline
        or the attempt limit. ``fn`` raising propagates at once."""
        deadline = self._deadline()
        attempt = 0
        while True:
            result = fn(*args, **kwargs)
            if result is not None:
                return result
            p = self.policy
            attempt += 1
            if p.max_attempts > 0 and attempt >= p.max_attempts:
                raise RetryExhausted(
                    f"{self.name}: no result after {attempt} attempts")
            delay = self.backoff(attempt - 1)
            now = self._clock()
            if now >= deadline:
                raise RetryExhausted(
                    f"{self.name}: no result within "
                    f"{self.policy.deadline:.1f}s deadline")
            delay = min(delay, max(0.0, deadline - now))
            self._sleep(delay)


def retrier(scope: str, name: Optional[str] = None,
            on_retry: Optional[Callable] = None,
            rank: Optional[int] = None, pinned=(),
            **defaults) -> Retrier:
    """A ``Retrier`` whose policy comes from the ``scope``'s
    ``HOROVOD_RETRY_*`` envs over the coded ``defaults`` (``pinned``
    fields keep their coded values)."""
    return Retrier(
        _config.retry_policy_from_env(scope, pinned=pinned, **defaults),
        name or scope.lower(), on_retry=on_retry, rank=rank)
