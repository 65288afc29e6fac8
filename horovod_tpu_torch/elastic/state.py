"""Elastic worker state: commit, restore and sync, and the retry loop
(the port's copy of ``horovod_tpu/elastic/state.py``).

- ``State.commit()`` saves a known-good snapshot and checks the mailbox
  for host updates;
- ``State.restore()`` rolls back to the last commit;
- ``State.sync()`` makes every worker agree (a broadcast from rank 0)
  after the world changed;
- ``run(fn)`` wraps a training function in the loop that answers
  ``HorovodInternalError`` (restore, re-init) and
  ``HostsUpdatedInterrupt`` (re-init, keep the results).

``TensorState`` is the counterpart of ``JaxState``: a tree (dicts, lists,
tuples) of tensors on the world's device, snapshotted to host memory.
"""

from __future__ import annotations

import copy
import functools
import os
import queue
import threading
from typing import Callable, Dict, List

import torch

from ..common import config as _config
from ..common import faults as _faults
from ..common import logging as _log
from ..common.exceptions import (HorovodInternalError, HostsUpdatedInterrupt,
                                 NotInitializedError, PreemptionInterrupt)
from ..parallel.mesh import SHARD_ATTR


class _HostUpdates:
    """The process's mailbox of membership notices: the worker's
    notification service posts updates, a preemption signal posts a
    drain."""

    def __init__(self):
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()

    def post(self, timestamp: float = 0.0, drain: bool = False):
        self._q.put((timestamp, drain))

    def pending(self):
        """Empty the mailbox: None (nothing), "update" or "drain" (which
        wins over updates: this worker leaves either way)."""
        kind = None
        try:
            while True:
                _, drain = self._q.get_nowait()
                kind = "drain" if drain else (kind or "update")
        except queue.Empty:
            pass
        return kind


notification_mailbox = _HostUpdates()


def _drain_watchdog(grace_ms: int) -> threading.Timer:
    """Force-exit (nonzero, a crash to the driver) when the drain has not
    finished within ``HOROVOD_DRAIN_GRACE_MS``. Armed by
    ``_graceful_drain`` and cancelled when it ends either way."""

    def fire():
        os.write(2, b"[horovod_tpu_torch] drain grace expired; "
                    b"force-exiting\n")
        os._exit(1)

    t = threading.Timer(grace_ms / 1000.0, fire)
    t.daemon = True
    t.start()
    return t


def register_preemption_signal(signum=None):
    """Turn a preemption signal (``HOROVOD_ELASTIC_PREEMPT_SIGNAL``,
    SIGTERM by default) into a ``PreemptionInterrupt`` at the next
    ``state.commit()``: the worker leaves at a committed point, announces
    its drain and exits 0. Returns the previous handler."""
    import signal as _signal

    if signum is None:
        name = _config.preempt_signal_spec() or "SIGTERM"
        signum = (int(name) if name.isdigit()
                  else getattr(_signal, name.upper()))

    def _on_preempt(signo, frame):
        _log.warning(f"preemption signal {signo} received; draining at the "
                     "next commit")
        notification_mailbox.post(drain=True)

    return _signal.signal(signum, _on_preempt)


class State:
    """The base of elastic state."""

    def __init__(self, **kwargs):
        self._reset_callbacks: List[Callable] = []
        for k, v in kwargs.items():
            setattr(self, k, v)

    def register_reset_callbacks(self, callbacks: List[Callable]):
        self._reset_callbacks.extend(callbacks)

    def on_reset(self):
        for cb in self._reset_callbacks:
            cb()

    def commit(self):
        self.save()
        self.check_host_updates()

    def check_host_updates(self):
        kind = notification_mailbox.pending()
        if kind == "drain":
            raise PreemptionInterrupt()
        if kind:
            raise HostsUpdatedInterrupt(skip_sync=False)

    def save(self):
        raise NotImplementedError

    def restore(self):
        raise NotImplementedError

    def sync(self):
        raise NotImplementedError


class ObjectState(State):
    """Picklable attributes: a deep copy on ``save``, a broadcast from
    rank 0 on ``sync``."""

    def __init__(self, bcast_object=None, **kwargs):
        if bcast_object is None:
            from .. import broadcast_object as bcast_object  # noqa: PLC0415
        self._bcast_object = bcast_object
        self._saved_state: Dict = {}
        super().__init__(**kwargs)
        self.save()

    def _public_attrs(self) -> Dict:
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}

    def save(self):
        self._saved_state = copy.deepcopy(self._public_attrs())

    def restore(self):
        for k, v in copy.deepcopy(self._saved_state).items():
            setattr(self, k, v)

    def sync(self):
        synced = self._bcast_object(self._public_attrs(), root_rank=0)
        for k, v in synced.items():
            setattr(self, k, v)
        self.save()


def map_tensors(fn: Callable, tree):
    """``tree`` with every tensor leaf replaced by ``fn(leaf)`` (dicts,
    lists and tuples are walked; other leaves are kept)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, map_tensors(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return tree


def to_host(tree):
    """A host copy of every tensor of ``tree``: detached CPU tensors
    (blocking on the card, so the copy is whole when it returns)."""
    return map_tensors(lambda t: t.detach().to("cpu", copy=True), tree)


def check_snapshot() -> None:
    """Refuse a snapshot taken in a world that lost a rank: the abort may
    have cut a collective short, leaving its partial result in the state
    (the retry loop then restores the last commit instead)."""
    from ..common import state as _state

    _state.check_world()


def _check_whole(tree, what: str) -> None:
    """Raise when a leaf of ``tree`` is only this process's slice of a
    tensor split across processes: a ZeRO-3 parameter (on the ``meta``
    device) or a leaf marked with ``parallel.mesh.SHARD_ATTR``."""

    def check(t):
        axis = getattr(t, SHARD_ATTR, None)
        if t.is_meta or axis is not None:
            where = (f"sharded over {axis!r}" if axis is not None
                     else "a ZeRO-3 parameter on the meta device")
            raise NotImplementedError(
                f"{what} cannot snapshot a leaf {where}: it is sharded "
                "across processes. Use horovod_tpu_torch.checkpoint."
                "CheckpointManager (each rank writes its own shards) for "
                "elastic recovery of a sharded state.")
        return t

    map_tensors(check, tree)


class TensorState(ObjectState):
    """A tree of tensors (``.tree``: dicts, lists and tuples of tensors,
    on the world's device) plus picklable attributes.

    ``save()`` copies the tree to host memory: a restore after a failure
    on the card never reads device memory that failed, and the snapshot
    takes none of the card's. ``restore()`` puts the snapshot back on the
    device through ``place`` (default: ``hvd.device()``), or, while the
    world is down, leaves ``.tree`` None for ``on_reset()`` to place after
    the re-init. ``sync()`` broadcasts the live tree and attributes from
    rank 0 and commits them. ``save()`` refuses a leaf sharded across
    processes.

        state = hvd.elastic.TensorState({"w": w}, batch=0)

        @hvd.elastic.run
        def train(state):
            while state.batch < n:
                state.tree["w"] -= lr * grad(state.tree["w"], state.batch)
                state.batch += 1
                state.commit()
    """

    def __init__(self, tree, place: Callable = None, **kwargs):
        self._place = place or self._to_device
        self.tree = tree
        super().__init__(**kwargs)

    @staticmethod
    def _to_device(host_tree):
        from ..common import state as _state

        st = _state.global_state()
        if st.world_lost:
            raise HorovodInternalError("the world is down")
        dev = _state.device()
        return map_tensors(lambda t: t.to(dev, copy=True), host_tree)

    def _replace_from_snapshot(self):
        self.tree = self._place(self._saved_tree)

    def save(self):
        _check_whole(self.tree, "TensorState")
        # The snapshot of the tree and of the attributes are assigned
        # together: a save that fails halfway leaves both at the last
        # commit.
        saved_tree = to_host(self.tree)
        check_snapshot()
        tree, self.tree = self.tree, None
        try:
            saved_attrs = copy.deepcopy(self._public_attrs())
        finally:
            self.tree = tree
        self._saved_tree = saved_tree
        self._saved_state = saved_attrs

    def restore(self):
        super().restore()
        # In the retry loop restore() runs before the re-init: when the
        # world (or the runtime) is down, placement waits for on_reset().
        # A fault in a custom ``place`` of the user's propagates.
        try:
            self._replace_from_snapshot()
        except (RuntimeError, NotInitializedError, HorovodInternalError) as e:
            _log.warning(f"TensorState: placing the tree after the re-init "
                         f"({e})")
            self.tree = None

    def on_reset(self):
        # After the re-init: place from the snapshot only when restore()
        # deferred it; a live tree (a membership change) is kept, and the
        # sync() that follows broadcasts it.
        if self.tree is None:
            self._replace_from_snapshot()
        super().on_reset()

    def sync(self):
        # The live tree goes with the live attributes (the committed tree
        # when placement is still deferred, whose attributes restore()
        # brought back with it), in one broadcast, and that pair becomes
        # the commit.
        payload = {k: v for k, v in self._public_attrs().items()
                   if k != "tree"}
        payload["tree"] = (to_host(self.tree) if self.tree is not None
                           else self._saved_tree)
        synced = self._bcast_object(payload, root_rank=0)
        self._saved_tree = synced.pop("tree")
        for k, v in synced.items():
            setattr(self, k, v)
        self._replace_from_snapshot()
        tree, self.tree = self.tree, None
        try:
            ObjectState.save(self)
        finally:
            self.tree = tree


def _reinitialize():
    """shutdown, then init with the arguments of the last init."""
    from ..common import state as _state

    _state.reinitialize()


def _graceful_drain(state: "State") -> None:
    """The preemption drain, when a ``PreemptionInterrupt`` reaches the
    retry loop: announce "begin" in the rendezvous KV, commit, announce
    "commit", then the DRAIN farewell on the native controller and the
    world's teardown (best effort once committed: the commit marker
    already stands). A failure before the commit marker propagates, a
    crash to the driver. ``HOROVOD_DRAIN_GRACE_MS`` bounds it all."""
    _log.warning("preemption drain: committing and leaving cleanly")
    watchdog = _drain_watchdog(_config.drain_grace_ms())
    try:
        addr = _config.rendezvous_addr()
        port = _config.rendezvous_port()
        hostname = _config.hostname()
        local_rank = _config.slot_local_rank()
        announce = addr is not None and port is not None and hostname
        if announce:
            from ..run.elastic.rendezvous import announce_drain

            announce_drain(addr, port, hostname, local_rank, "begin")
        _faults.point("elastic.drain")
        state.save()
        if announce:
            announce_drain(addr, port, hostname, local_rank, "commit")
        from ..common import host_world as _host_world
        from ..common import state as _state

        try:
            _host_world.world().drain()
        # The commit stands: a world that falls apart under the farewell
        # must not turn the clean exit into a crash.
        except Exception as e:
            _log.warning(f"drain farewell (host world) failed: {e}")
        try:
            _state.drain()
        except Exception as e:
            _log.warning(f"drain teardown (engine) failed: {e}")
    finally:
        watchdog.cancel()
    _log.warning("preemption drain complete; exiting 0")


# Consecutive failed re-inits tolerated before giving up: a race with the
# driver's next plan heals on a retry; a dead driver does not.
_MAX_REINIT_FAILURES = 3


def retry_loop(func: Callable, reinitialize: Callable[[], None]) -> Callable:
    """The elastic retry loop, parameterized by the world's re-init.

    A re-init that raises ``HorovodInternalError`` (a rendezvous racing
    the driver's next plan, a world that did not form) is retried up to
    ``_MAX_REINIT_FAILURES`` times in a row; a failing ``state.sync()``
    restores and re-inits like any collective failure."""

    @functools.wraps(func)
    def wrapper(state: State, *args, **kwargs):
        reset_required = False
        skip_sync = False
        reinit_failures = 0
        while True:
            if reset_required:
                try:
                    reinitialize()
                except HorovodInternalError as e:
                    reinit_failures += 1
                    if reinit_failures > _MAX_REINIT_FAILURES:
                        raise
                    _log.warning(f"elastic re-init failed ({e}); retrying")
                    continue
                reinit_failures = 0
                state.on_reset()
                reset_required = False
            try:
                if not skip_sync:
                    state.sync()
                skip_sync = False
                ret = func(state, *args, **kwargs)
            except HorovodInternalError:
                _log.warning(
                    "collective failure: restoring last committed state")
                state.restore()
                reset_required = True
            except PreemptionInterrupt:
                _graceful_drain(state)
                raise SystemExit(0)
            except HostsUpdatedInterrupt as e:
                _log.info("host membership changed: re-initializing")
                reset_required = True
                skip_sync = e.skip_sync
            else:
                return ret

    return wrapper


def run(func: Callable) -> Callable:
    """The elastic retry loop as a decorator, re-initializing the world
    that ``hvd.init`` made."""
    return retry_loop(func, _reinitialize)
