"""The elastic driver (the port's copy of
``horovod_tpu/run/elastic/driver.py``).

- polls the host discovery every ``DISCOVER_HOSTS_FREQUENCY_SECS`` (1 s)
  on a thread of its own;
- starts once ``min_np`` slots are there;
- assigns ranks stably: hosts keep their discovery age, so a running
  worker keeps its rank when the world grows, and rank 0 stays on the
  oldest host;
- spawns one worker a slot through the caller's ``create_worker_fn``;
- records each worker's exit: a failure is a strike against its host
  (``registration.py``), and the world is re-formed on what is left;
- writes each round's plan to the rendezvous KV and tells the live
  workers (``HostsUpdatedRequest``) when the plan changes;
- with ``HOROVOD_HEARTBEAT_MS`` set, folds the workers' heartbeats into a
  ``LivenessTracker`` on every tick, evicts a worker silent past
  ``HOROVOD_LIVENESS_TIMEOUT_MS`` (its slot's event terminates it:
  SIGTERM, then SIGKILL 5 s later) and nudges the survivors. A worker
  that marked its exit (``/exit``, put at ``atexit``) is past its last
  beat but not hung: its teardown is bounded by twice the drain grace,
  as a drain is, and its exit code alone says how it ended.

Its frames keep the JAX package's class paths
(``run/common/util/network.py``), so it drives the port's workers and
the JAX package's alike.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ...common import faults as _faults
from ...common import liveness as _liveness
from ...common import logging as _log
from ...common import timeline as _timeline
from ..common.util.hosts import HostInfo, SlotInfo, get_host_assignments
from .discovery import HostManager
from .registration import DRAINED, FAILURE, SUCCESS, WorkerStateRegistry
from .rendezvous import DRAIN_SCOPE, EXIT_SCOPE, HEARTBEAT_SCOPE

DISCOVER_HOSTS_FREQUENCY_SECS = 1.0


class _WorkerHandle:
    """Per-worker shutdown event + classification marks (mutated under
    the driver lock): `removed` = slot left the plan (no accounting),
    `evicted` = liveness plane gave up on it (failure accounting
    regardless of exit code), `draining` = announced a graceful
    preemption drain."""

    __slots__ = ("event", "removed", "evicted", "draining")

    def __init__(self):
        self.event = threading.Event()
        self.removed = False
        self.evicted = False
        self.draining = False


class ElasticDriver:
    def __init__(self, rendezvous, discovery, min_np: int, max_np: int = 0,
                 timeout: Optional[float] = None,
                 cooldown_range: Optional[Tuple[int, int]] = None,
                 verbose: int = 0, timeline=None):
        self._rendezvous = rendezvous
        self._timeline = timeline  # launcher-side Timeline, optional
        self._host_manager = HostManager(discovery, cooldown_range)
        self._host_manager.set_on_blacklist(self._on_host_blacklisted)
        # Publish the rejoin grace surviving workers should honor before
        # concluding a failure was transient. It must cover the driver's
        # own worst-case plan rebuild (blacklist cooldown upper bound +
        # activation), and only the driver knows the cooldown range — so
        # the value travels through the rendezvous KV rather than being a
        # worker-side guess (see host_world._rejoin_grace_seconds).
        grace = 10.0 + (cooldown_range[1] if cooldown_range else 0.0)
        if hasattr(rendezvous, "put"):
            self._rendezvous.put("config", "rejoin_grace",
                                 repr(grace).encode())
        self._min_np = min_np
        self._max_np = max_np or 0
        # `is None` check: timeout=0 is an explicit fail-fast request.
        self._timeout = 600.0 if timeout is None else timeout
        self._verbose = verbose

        self._worker_registry = WorkerStateRegistry(self, self._host_manager)
        self._create_worker_fn: Optional[Callable] = None
        self._assignments: Dict[Tuple[str, int], SlotInfo] = {}
        self._world_size = 0
        self._rendezvous_round = 0

        self._lock = threading.RLock()
        self._shutdown = threading.Event()
        self._host_change = threading.Event()
        self._workers_active: Dict[Tuple[str, int], _WorkerHandle] = {}
        # Liveness plane: armed by HOROVOD_HEARTBEAT_MS
        # > 0 when the rendezvous store is readable driver-side. Workers
        # push heartbeats into the KV; the discovery loop folds them into
        # the tracker and escalates silence miss -> SUSPECT -> EVICT.
        # Tracker state is guarded by self._lock.
        self._liveness: Optional[_liveness.LivenessTracker] = None
        if _liveness.enabled() and hasattr(rendezvous, "get"):
            self._liveness = _liveness.LivenessTracker()
        self._hb_seen: Dict[Tuple[str, int], bytes] = {}
        # ((host, slot), phase) -> consumed marker
        self._drain_seen: Dict[Tuple[Tuple[str, int], str], bytes] = {}
        self._requested_np = min_np
        self._round_failures = 0
        self._notify_client_factory = None  # injectable for tests
        self._result: Optional[int] = None
        self._done = threading.Event()
        self._discovery_thread = threading.Thread(
            target=self._discover_loop, daemon=True, name="elastic-discovery")

    # -- lifecycle -----------------------------------------------------------

    def start(self, np: int, create_worker_fn: Callable) -> None:
        """Begin: wait for min_np slots, assign, spawn workers (parity:
        ``driver.py:84``)."""
        self._create_worker_fn = create_worker_fn
        self._requested_np = max(np, self._min_np)
        self._host_manager.update_available_hosts()
        self._discovery_thread.start()
        while True:
            self.wait_for_available_slots(self._min_np)
            if self._activate_workers(self._requested_np):
                break
            self._shutdown.wait(DISCOVER_HOSTS_FREQUENCY_SECS)

    def stop(self) -> None:
        self._shutdown.set()
        with self._lock:
            handles = list(self._workers_active.values())
        for h in handles:
            h.event.set()
        if self._discovery_thread.is_alive():
            self._discovery_thread.join(timeout=5.0)

    def finished(self) -> bool:
        return self._done.is_set()

    def get_results(self) -> int:
        self._done.wait()
        return self._result if self._result is not None else 1

    # -- membership ----------------------------------------------------------

    def _blacklist_detail(self) -> str:
        info = self._host_manager.blacklist_info()
        if not info:
            return ""
        parts = []
        for host, st in info.items():
            if not st["blacklisted"]:
                continue
            kind = "permanently" if st["permanent"] else "in cooldown"
            parts.append(f"{host} ({kind}, strikes {st['strikes']})")
        return f"; blacklisted hosts: {', '.join(parts)}" if parts else ""

    def wait_for_available_slots(self, min_np: int):
        """Block until at least ``min_np`` slots exist (parity:
        ``driver.py:133``). Refusing to shrink below ``min_np`` comes
        with a clear error: the timeout message names every blacklisted
        host and whether it can ever return — "job died because the
        driver blacklisted its last hosts" must be diagnosable from the
        launcher log alone. The wait itself always runs the full timeout:
        discovery may hand out brand-new replacement hosts (autoscaler)
        that no blacklist state can predict."""
        deadline = time.time() + self._timeout
        while not self._shutdown.is_set():
            available = self._host_manager.available_slots()
            if available >= min_np:
                return
            if time.time() > deadline:
                raise TimeoutError(
                    f"timed out waiting for {min_np} slots; only "
                    f"{available} available{self._blacklist_detail()}")
            self._shutdown.wait(DISCOVER_HOSTS_FREQUENCY_SECS)

    def _discover_loop(self):
        while not self._shutdown.is_set():
            try:
                if self._host_manager.update_available_hosts():
                    self._host_change.set()
                    self._on_hosts_updated()
            # discovery script
            # hiccups are transient; the loop retries next tick and no
            # collective signal flows through the driver's discovery path
            except Exception as e:
                _log.warning(f"host discovery failed: {e}")
            if self._liveness is not None:
                try:
                    self._check_liveness()
                # the liveness
                # sweep must never kill the discovery loop; a failed pass
                # only delays detection by one tick
                except Exception as e:
                    _log.warning(f"liveness check failed: {e}")
            self._shutdown.wait(DISCOVER_HOSTS_FREQUENCY_SECS)

    # -- liveness plane -------------------------------------------------------

    def _instant(self, name: str, args: dict) -> None:
        if self._timeline is not None:
            # generic
            # relay: every call site passes a catalog constant through
            self._timeline.instant(name, args)

    def _check_liveness(self):
        """One liveness pass, piggybacked on the discovery tick: fold KV
        heartbeats and drain markers into the tracker, escalate, act on
        evictions. Detection latency is bounded by the liveness timeout
        plus one tick — comfortably inside the 2x-timeout acceptance
        window the chaos tests assert."""
        to_evict = []
        with self._lock:
            tracker = self._liveness
            active = dict(self._workers_active)
            # A worker enters the tracker at its FIRST beat, not at
            # spawn: liveness defends a previously-live worker against
            # silent death; a worker still importing frameworks or
            # loading a checkpoint has never beaten and is the elastic
            # start-timeout's job — evicting it for slow startup would
            # blacklist healthy hosts on oversubscribed machines.
            for key in list(tracker.members()):
                if key not in active:
                    tracker.forget(key)
                    self._hb_seen.pop(key, None)
            for key, handle in active.items():
                host, slot = key
                kv_key = f"{host}:{slot}"
                beat = self._rendezvous.get(HEARTBEAT_SCOPE, kv_key)
                # Value-change detection, never clock comparison: the
                # driver's clock and the workers' never meet, so a beat
                # is "the counter moved", timed by the driver's own clock.
                if beat is not None and beat != self._hb_seen.get(key):
                    self._hb_seen[key] = beat
                    tracker.beat(key)
                if self._rendezvous.get(EXIT_SCOPE, kv_key) is not None:
                    # Exiting: silent from interpreter finalization on.
                    tracker.mark_draining(key)
                for phase, name in (("begin", _timeline.DRAIN_BEGIN),
                                    ("commit", _timeline.DRAIN_COMMIT)):
                    marker = (key, phase)
                    if marker in self._drain_seen:
                        continue
                    if self._rendezvous.get(DRAIN_SCOPE,
                                            f"{kv_key}.{phase}") is None:
                        continue
                    self._drain_seen[marker] = b"1"
                    handle.draining = True
                    tracker.mark_draining(key)
                    self._instant(name, {"host": host, "slot": slot,
                                         "phase": phase})
                    _log.info(
                        f"elastic: worker {host}:{slot} drain {phase}")
            for ev in tracker.check():
                host, slot = ev.member
                args = {"host": host, "slot": slot,
                        "silence_ms": round(ev.silence_ms)}
                if ev.kind == _liveness.MISS:
                    self._instant(_timeline.HEARTBEAT_MISS, args)
                    _log.debug(f"elastic: heartbeat miss from "
                               f"{host}:{slot}")
                elif ev.kind == _liveness.SUSPECT_EVENT:
                    self._instant(_timeline.RANK_SUSPECT, args)
                    _log.warning(
                        f"elastic: worker {host}:{slot} is SUSPECT "
                        f"({ev.silence_ms:.0f}ms silent)")
                elif ev.kind == _liveness.EVICT:
                    self._instant(_timeline.RANK_EVICTED, args)
                    from ...common import metrics as _metrics

                    _metrics.inc("elastic.evictions")
                    _log.warning(
                        f"elastic: worker {host}:{slot} EVICTED after "
                        f"{ev.silence_ms:.0f}ms of silence")
                    handle = self._workers_active.get(ev.member)
                    if handle is not None:
                        handle.evicted = True
                        to_evict.append(ev.member)
        # Act outside the lock: terminating the worker and nudging the
        # survivors both cross process/network boundaries.
        for key in to_evict:
            with self._lock:
                handle = self._workers_active.get(key)
            if handle is not None:
                handle.event.set()  # terminate; exit routes to failure
        if to_evict:
            self._notify_survivors(exclude=set(to_evict))

    def _notify_survivors(self, exclude=()):
        """Membership-change nudge to every live worker NOT in
        ``exclude`` — survivors raise ``HostsUpdatedInterrupt`` at their
        next commit instead of wedging on a collective with the evicted
        rank."""
        factory = self._notify_client_factory
        if factory is None:
            return
        ts = time.time()
        with self._lock:
            keys = [k for k in self._assignments if k not in set(exclude)]
        for hostname, local_rank in keys:
            try:
                client = factory(hostname, local_rank)
                if client is not None:
                    client.notify_hosts_updated(ts)
            # best-effort nudge:
            # an unreachable survivor learns of the change when its
            # collective fails, exactly as before the liveness plane
            except Exception as e:
                _log.debug(f"could not notify {hostname}:{local_rank}: {e}")

    def _consume_drain_marker(self, host: str, slot: int) -> bool:
        """At worker exit: True when the worker completed its drain
        protocol (commit marker present; begin alone is an uncommitted
        drain = a crash). Consumes the markers so a re-staffed slot's
        next life starts unmarked. A fast drain can finish between two
        discovery ticks — any phase the liveness sweep never saw gets
        its timeline instant emitted here, so DRAIN_BEGIN/DRAIN_COMMIT
        are recorded deterministically, not only when the 1 s poll wins
        the race."""
        if not hasattr(self._rendezvous, "get"):
            return False
        kv_key = f"{host}:{slot}"
        # Also retire the slot's heartbeat key: a re-staffed slot must
        # not inherit its previous life's counter — the first liveness
        # tick would read the stale value as a fresh beat and start the
        # new worker's silence clock while it is still importing
        # frameworks (exactly the slow-startup eviction the first-beat
        # admission rule exists to prevent).
        if hasattr(self._rendezvous, "delete"):
            self._rendezvous.delete(HEARTBEAT_SCOPE, kv_key)
            self._rendezvous.delete(EXIT_SCOPE, kv_key)
        self._hb_seen.pop((host, slot), None)
        committed = False
        for phase, name in (("begin", _timeline.DRAIN_BEGIN),
                            ("commit", _timeline.DRAIN_COMMIT)):
            present = self._rendezvous.get(
                DRAIN_SCOPE, f"{kv_key}.{phase}") is not None
            if phase == "commit":
                committed = present
            if present and ((host, slot), phase) not in self._drain_seen:
                self._instant(name, {"host": host, "slot": slot,
                                     "phase": phase})
                _log.info(f"elastic: worker {host}:{slot} drain {phase}")
            if hasattr(self._rendezvous, "delete"):
                self._rendezvous.delete(DRAIN_SCOPE, f"{kv_key}.{phase}")
            self._drain_seen.pop(((host, slot), phase), None)
        return committed

    def _on_hosts_updated(self):
        # Gate on the *plan* actually changing, not merely the host set: a
        # discovery echo (e.g. a blacklisted host returning from cooldown
        # after the failure path already rebuilt the plan, or spare hosts
        # beyond max_np appearing) must not interrupt workers — they would
        # re-rendezvous expecting a new round that never comes.
        if not self._plan_changed():
            _log.debug("elastic: host set changed but plan is unchanged "
                       "and staffed; nothing to do")
            return
        _log.info("elastic: host set changed; notifying workers")
        self._notify_survivors()
        # Regrow/shrink the plan so the rendezvous the interrupted workers
        # re-fetch reflects the new host set, and spawn workers on any new
        # slots (parity: driver.py:185-213 + _activate_workers on update).
        # Never shrink below min_np on a discovery blip: keep the current
        # plan and let the failure path (which gates on min_np) handle any
        # actual worker deaths.
        if self._create_worker_fn is not None and not self._shutdown.is_set():
            if self._host_manager.available_slots() >= self._min_np:
                self._activate_workers(self._target_np())
            else:
                _log.warning(
                    "elastic: host update leaves fewer than min_np="
                    f"{self._min_np} slots; keeping current plan")

    def set_notify_client_factory(self, factory) -> None:
        self._notify_client_factory = factory

    def _on_host_blacklisted(self, host: str, info: dict) -> None:
        """Observer wired into the HostManager: every blacklist decision
        lands in the launcher timeline (when one is configured) so a
        post-mortem shows membership churn on the same time axis as the
        workers' collectives."""
        if self._timeline is not None:
            args = dict(info)
            if args.get("until") == float("inf"):
                # json.dumps would emit bare `Infinity` — invalid JSON
                # for strict trace parsers; `permanent` carries the fact.
                args["until"] = None
            self._timeline.instant(_timeline.HOST_BLACKLISTED, args)

    def blacklist_status(self):
        """Queryable blacklist state (strikes / cooldown / parole per
        host) — see ``HostManager.blacklist_info``."""
        return self._host_manager.blacklist_info()

    # -- rank assignment -----------------------------------------------------

    def _compute_assignments(self, np: int) -> List[SlotInfo]:
        hosts = [HostInfo(h, s) for h, s in self._host_manager.current_hosts]
        np_actual = min(sum(h.slots for h in hosts),
                        self._max_np or np, max(np, self._min_np))
        return get_host_assignments(hosts, np_actual)

    @staticmethod
    def _plan_key(plan: List[SlotInfo]):
        return sorted((s.hostname, s.local_rank, s.to_response_string())
                      for s in plan)

    def _plan_is_current(self, plan: List[SlotInfo]) -> bool:
        """True when ``plan`` equals the active assignments AND every slot
        has a live worker — i.e. re-activating would change nothing. Must
        be called under the lock."""
        if self._plan_key(plan) != self._plan_key(
                list(self._assignments.values())):
            return False
        return all((s.hostname, s.local_rank) in self._workers_active
                   for s in plan)

    def _plan_changed(self) -> bool:
        with self._lock:
            try:
                plan = self._compute_assignments(self._target_np())
            # erring toward
            # "changed" only triggers a spurious notify, never a loss
            except Exception:
                return True  # can't tell; err on notifying
            return not self._plan_is_current(plan)

    def _activate_workers(self, np: int) -> bool:
        """(Re)assign ranks, spawn workers for newly-assigned slots, and
        terminate workers whose slot left the plan (blacklisted/removed
        hosts) (parity: ``driver.py:157,259-277``). Returns False — leaving
        the current plan untouched — when fewer than min_np slots exist at
        decision time (the available-slot pre-checks run unlocked, so a
        concurrent blacklist can shrink the world between check and act)."""
        with self._lock:
            plan = self._compute_assignments(np)
            if len(plan) < self._min_np:
                _log.warning(
                    f"elastic: only {len(plan)} slots available, below "
                    f"min_np={self._min_np}; keeping current plan")
                return False
            if self._plan_is_current(plan):
                # Nothing would change: same slots, same ranks, all
                # staffed. Bumping the round anyway is not harmless — a
                # worker mid-join on the current round would be orphaned
                # (it waits for the old round's coordinator; new arrivals
                # wait for the new round's), so dedupe here, where both
                # the failure path and the discovery thread land. This IS
                # a completed activation decision, so clear the round's
                # failure count like the full path does: the failure that
                # routed us here was already absorbed by a concurrent
                # activation (which respawned the dead slot), and keeping
                # its count would doom a fully recovered job's exit code.
                self._round_failures = 0
                return True
            self._world_size = plan[0].size if plan else 0
            self._rendezvous_round += 1
            self._round_failures = 0
            self._rendezvous.init(plan, self._rendezvous_round)
            new_slots = []
            assignments = {}
            for slot in plan:
                key = (slot.hostname, slot.local_rank)
                assignments[key] = slot
                if key not in self._workers_active:
                    new_slots.append(slot)
            removed = [k for k in self._workers_active
                       if k not in assignments]
            self._assignments = assignments
            for key in removed:
                handle = self._workers_active[key]
                handle.removed = True
                handle.event.set()
            for slot in new_slots:
                self._spawn(slot)
            return True

    def _spawn(self, slot: SlotInfo) -> None:
        handle = _WorkerHandle()
        key = (slot.hostname, slot.local_rank)
        self._workers_active[key] = handle
        if self._liveness is not None:
            # A new worker enters the tracker at its first beat: neither
            # the silence of the worker it replaces on this slot nor that
            # worker's last beat, still in the KV, is its own, and a
            # respawn can come before a liveness pass sees the slot empty.
            self._liveness.forget(key)
            self._hb_seen[key] = self._rendezvous.get(
                HEARTBEAT_SCOPE, f"{slot.hostname}:{slot.local_rank}")

        def run():
            try:
                # Chaos seam: a kind=raise fault here simulates a launch-
                # side failure (bad ssh, unwritable output dir) for
                # slot.rank and must be accounted exactly like one.
                _faults.point("elastic.worker.start", rank=slot.rank)
                code = self._create_worker_fn(slot, [handle.event,
                                                     self._shutdown])
            # converted, not
            # swallowed: code=1 routes it into the worker-failure
            # accounting (strikes/blacklist); the elastic.worker.start
            # chaos seam's FaultInjected relies on exactly this
            except Exception as e:
                # A launch-side failure (unwritable output dir, ssh exec
                # error) must be accounted like a worker failure — an
                # escaped exception would leave the slot unaccounted and
                # stall the driver forever.
                _log.warning(
                    f"worker {slot.hostname}:{slot.local_rank} failed to "
                    f"launch: {e}")
                code = 1
            host, lslot = slot.hostname, slot.local_rank
            # Classify under the lock: `removed`/`evicted` are only
            # honored while this worker's own handle is still the
            # registered one (a respawned slot carries a fresh handle).
            with self._lock:
                current = self._workers_active.get(key) is handle
                removed = handle.removed and current
                evicted = handle.evicted and current
            drained = self._consume_drain_marker(host, lslot)
            if removed:
                # Deliberately terminated when its slot left the plan —
                # neither a success nor a host-blacklisting failure.
                self.on_worker_removed(host, lslot)
            elif drained:
                # Completed the preemption drain protocol (commit marker
                # in the KV): clean departure, zero strikes, but the
                # world still shrinks and re-activates. Checked before
                # `evicted` — a drain whose farewell lost the race with
                # the liveness eviction is still a clean drain.
                from ...common import metrics as _metrics

                _metrics.inc("elastic.drains")
                self._worker_registry.record_drained(host, lslot)
            elif evicted:
                # The liveness plane gave up on this worker (silence past
                # the timeout) and terminated it; its exit code is
                # whatever the kill produced — the classification is
                # failure regardless.
                self._worker_registry.record_failure(host, lslot)
            elif code == 0:
                self._worker_registry.record_success(host, lslot)
            else:
                self._worker_registry.record_failure(host, lslot)

        threading.Thread(target=run, daemon=True,
                         name=f"worker-{slot.hostname}-{slot.local_rank}"
                         ).start()

    # -- worker exit handling (called by WorkerStateRegistry) ---------------

    def on_worker_removed(self, host: str, slot: int) -> None:
        """A worker terminated because its slot left the plan; drop it from
        the active set with no success/failure accounting. If discovery
        flapped and the slot is back in the current plan, respawn it so no
        rank is left unstaffed."""
        with self._lock:
            self._workers_active.pop((host, slot), None)
            reborn = self._assignments.get((host, slot))
            if reborn is not None and not self._shutdown.is_set():
                self._spawn(reborn)
                return
            still_active = len(self._workers_active)
        if still_active == 0 and not self._shutdown.is_set():
            self._finish()

    def _finish(self) -> None:
        # Job over: success iff workers succeeded and none failed in the
        # current rendezvous round — failures recovered from in earlier
        # rounds don't doom an elastic job (parity: driver.py:279-295).
        successes = self._worker_registry.count(SUCCESS)
        self._result = (0 if self._round_failures == 0 and successes > 0
                        else 1)
        self._done.set()
        self._shutdown.set()

    def on_worker_exit(self, host: str, slot: int, state: str) -> None:
        with self._lock:
            self._workers_active.pop((host, slot), None)
            still_active = len(self._workers_active)
            if state == FAILURE:
                self._round_failures += 1
        if self._shutdown.is_set():
            return
        if still_active == 0:
            self._finish()
            return
        if state in (FAILURE, DRAINED):
            # Try to resume on the remaining hosts with as many slots as
            # are available (up to the requested/max np); workers meanwhile
            # hit HorovodInternalError and wait in their retry loop for the
            # new rendezvous. Retry if activation loses a race with another
            # concurrent blacklist.
            while not self._shutdown.is_set():
                try:
                    self.wait_for_available_slots(self._min_np)
                except TimeoutError:
                    self._result = 1
                    self._done.set()
                    self._shutdown.set()
                    return
                if self._activate_workers(self._target_np()):
                    return
                self._shutdown.wait(DISCOVER_HOSTS_FREQUENCY_SECS)

    def _target_np(self) -> int:
        """World size to aim for on membership change: grow to max_np when
        elastic bounds were given, else stay at the requested np."""
        return self._max_np or self._requested_np

    # -- introspection (used by tests, parity: driver accessors) -------------

    @property
    def host_manager(self) -> HostManager:
        return self._host_manager

    @property
    def world_size(self) -> int:
        return self._world_size

    def get_slot_info(self, host: str, slot: int) -> Optional[SlotInfo]:
        with self._lock:
            return self._assignments.get((host, slot))

    def get_assignments(self) -> List[SlotInfo]:
        with self._lock:
            return sorted(self._assignments.values(),
                          key=lambda s: s.rank)
