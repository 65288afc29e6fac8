"""Process-rank collective world for host (CPU) tensors.

The port's copy of ``horovod_tpu/common/host_world.py``: one process a
rank, as in Horovod's torch binding, with the collectives of CPU tensors
on the native core's host data plane: the C++ ring over TCP
(``csrc/hvd/ring_ops.cc``) and, when armed, its shared-memory and striped
transports. It needs no ``hvd.init``: ``world().init()`` reads the
launcher's ``HOROVOD_*`` environment (or a scheduler's rank variables) and
starts a core of its own on the controller's base port + 1. When
``hvd.init`` has run, it borrows the eager engine's core instead, so one
controller negotiates both planes' tensors in one cycle.

With ``HOROVOD_HOST_VIA_XLA=1`` in a world whose core this process owns,
fused host responses at or above ``HOROVOD_HOST_VIA_XLA_THRESHOLD`` go
through NCCL instead (``common/host_staging.py``); the knob keeps the
reference's name.

The API is raw buffers (``enqueue``/``test``/``wait`` with data pointers,
``result_fetch``) and small blocking helpers on numpy arrays; torch CPU
tensors pass their ``data_ptr()`` with the code of ``dtype_code``.

Under ``HOROVOD_ELASTIC`` every (re-)init takes the world's layout from
the elastic driver's rendezvous KV (``elastic_rendezvous``), as
``hvd.init`` does: the slot plan of the current round, and the endpoint
rank 0 publishes for it.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from . import config as _config
from . import faults as _faults
from . import logging as _log
from . import native as _native
from .exceptions import HorovodInternalError, NotInitializedError

NUMPY_DTYPE_CODES = dict(_native.DTYPE_CODES)


def dtype_code(dtype) -> int:
    """The native core's code of a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return _native.TORCH_DTYPE_CODES[dtype]
    return NUMPY_DTYPE_CODES[str(np.dtype(dtype))]


# Scheduler rank variables, tried in order when HOROVOD_* is absent:
# jsrun/Spectrum MPI (JSM/PMIX/OMPI) and Slurm.
_SCHED_RANK = ("JSM_NAMESPACE_RANK", "PMIX_RANK", "OMPI_COMM_WORLD_RANK",
               "SLURM_PROCID")
_SCHED_SIZE = ("JSM_NAMESPACE_SIZE", "OMPI_COMM_WORLD_SIZE", "SLURM_NTASKS")
_SCHED_LOCAL_RANK = ("JSM_NAMESPACE_LOCAL_RANK",
                     "OMPI_COMM_WORLD_LOCAL_RANK", "SLURM_LOCALID")
_SCHED_LOCAL_SIZE = ("JSM_NAMESPACE_LOCAL_SIZE",
                     "OMPI_COMM_WORLD_LOCAL_SIZE", "SLURM_NTASKS_PER_NODE")


def _sched_env(primary: str, fallbacks, default: str) -> str:
    v = os.environ.get(primary)
    if v is not None:
        return v
    for name in fallbacks:
        v = os.environ.get(name)
        if v is not None:
            # Slurm's compound counts look like "16(x2)": the leading int
            # is the per-node value.
            return v.split("(")[0]
    return default


def _rejoin_grace_seconds(addr=None, port=None) -> float:
    """How long a surviving worker waits for the driver to move to a new
    round before it takes the failure for a transient one and rejoins the
    current round: ``HOROVOD_ELASTIC_REJOIN_GRACE`` when set, else the
    grace the driver publishes under ``config/rejoin_grace`` (it covers
    its blacklist cooldown), else 10 s. Read at every re-init."""
    grace = _config.rejoin_grace_env()
    if grace is not None:
        return grace
    if addr and port:
        from ..run.http.http_client import read_data_from_kvstore

        try:
            blob = read_data_from_kvstore(addr, int(port), "config",
                                          "rejoin_grace", timeout=2.0,
                                          retries=1)
            if blob:
                return float(blob.decode())
        except (OSError, ValueError):
            pass
    return 10.0


def _excluded_from_plan_error() -> HorovodInternalError:
    return HorovodInternalError(
        "this worker is no longer in the rendezvous plan (slot removed or "
        "host blacklisted)")


# The rendezvous round of this process's last elastic init (None before
# the first): a re-init prefers a newer one.
_last_round: Optional[int] = None
# The base port rank 0 published for each round: a re-init that rejoins
# the same round publishes the same one again, so a peer that reads the
# round's key before rank 0 writes it anew still finds rank 0.
_round_ports: dict = {}


def elastic_rendezvous(current_rank: int = 0) -> None:
    """Under ``HOROVOD_ELASTIC``: this worker's layout for the current
    round of the elastic driver's plan, and the endpoint of the round's
    world (rank 0 takes a free pair of ports, ``config.free_port_pair``,
    a round, and publishes ``host:port`` keyed by the round; the others
    wait for it). The layout is installed with ``config.set_round_world``, and
    the notification service is started, so the driver can reach this
    worker. Nothing is installed (the launch-time environment stands)
    when the job is not elastic, and at the first init when the KV is
    unreachable or has no plan for this slot yet (the launch-time
    environment is the plan's first round). Raises ``HorovodInternalError`` when the job is
    elastic but the rendezvous is not in the environment, and at a
    re-init when the KV cannot be read or the plan leaves this slot out:
    it never runs a fixed world in place of an elastic one.

    ``current_rank`` targets the fault points (the launch-time rank goes
    stale once the driver moves ranks)."""
    global _last_round
    _config.set_round_world(None)
    if not _config.elastic_enabled():
        return
    addr = _config.rendezvous_addr()
    port = _config.rendezvous_port()
    hostname = _config.hostname()
    if not (addr and port and hostname):
        raise HorovodInternalError(
            f"{_config.HOROVOD_ELASTIC} is set but the elastic driver's "
            f"rendezvous is not ({_config.HOROVOD_RENDEZVOUS_ADDR}, "
            f"{_config.HOROVOD_RENDEZVOUS_PORT}, {_config.HOROVOD_HOSTNAME}):"
            f" launch elastic jobs with the elastic launcher; a fixed world "
            f"does not run in place of an elastic one")
    from ..run.elastic.rendezvous import fetch_slot_info

    slot = _config.slot_local_rank()
    if _last_round is None:
        try:
            fetched = fetch_slot_info(addr, port, hostname, slot,
                                      rank=current_rank)
        # The first init only: the launch-time environment is still the
        # plan's first round, so an unreachable KV degrades to it.
        except Exception as e:
            _log.warning(f"elastic rendezvous unreachable at first init; "
                         f"using the launch-time layout: {e}")
            return
        if fetched is None:
            return
    else:
        last, latest = _last_round, [None]

        def fetch_newer():
            try:
                got = fetch_slot_info(addr, port, hostname, slot,
                                      rank=current_rank)
            except Exception as e:
                raise HorovodInternalError(
                    f"elastic re-rendezvous failed: {e}") from e
            if got is None:
                raise _excluded_from_plan_error()
            latest[0] = got
            return got if got[1] > last else None

        # A failure that killed a worker makes the driver plan a new round
        # (cooldown + activation, a few seconds); a transient one changes
        # nothing, and everyone rejoins the current round once the grace
        # is over. Unlimited polls within the grace are the contract, so
        # attempts and deadline take no environment override.
        retrier = _faults.retrier(
            "REJOIN", name="elastic.rejoin", rank=current_rank,
            pinned=("max_attempts", "deadline"),
            max_attempts=0, base_delay=0.25, max_delay=1.0,
            deadline=max(_rejoin_grace_seconds(addr, port), 0.001))
        try:
            fetched = retrier.poll(fetch_newer)
        except _faults.RetryExhausted:
            fetched = latest[0]
    (rank, size, local_rank, local_size, cross_rank,
     cross_size), rendezvous_round = fetched
    host, base_port = _exchange_endpoint(addr, port, hostname, slot, rank,
                                         rendezvous_round)
    _last_round = rendezvous_round
    _config.set_round_world(dict(
        rank=rank, size=size, local_rank=local_rank, local_size=local_size,
        cross_rank=cross_rank, cross_size=cross_size, addr=host,
        port=base_port))
    from ..run.elastic.worker import notification_manager

    notification_manager.init()


def _exchange_endpoint(addr: str, port: int, hostname: str, slot: int,
                       rank: int, rendezvous_round: int) -> Tuple[str, int]:
    """Rank 0 takes a free pair of ports (the store's and the native
    controller's) for the round, the same one again when it rejoins a
    round, and publishes it; the others poll for it, watching for the
    round moving on under them. Raises ``HorovodInternalError``: the
    retry loop then re-rendezvouses."""
    from ..run.elastic.rendezvous import (fetch_controller_endpoint,
                                          fetch_slot_info,
                                          publish_controller_endpoint)

    try:
        if rank == 0:
            base = _round_ports.get(rendezvous_round)
            if base is None:
                base = _round_ports[rendezvous_round] = \
                    _config.free_port_pair()
            publish_controller_endpoint(addr, port, hostname, base,
                                        rendezvous_round)
            return hostname, base

        def fetch_once():
            ep = fetch_controller_endpoint(addr, port, rendezvous_round,
                                           timeout=2.0, rank=rank)
            if ep is not None:
                return ep
            current = fetch_slot_info(addr, port, hostname, slot, rank=rank)
            if current is None:
                raise _excluded_from_plan_error()
            if current[1] != rendezvous_round:
                raise HorovodInternalError(
                    f"rendezvous advanced to round {current[1]} while "
                    f"waiting for round {rendezvous_round}'s endpoint")
            return None

        retrier = _faults.retrier(
            "RENDEZVOUS", name="controller.endpoint", rank=rank,
            pinned=("max_attempts",),
            max_attempts=0, base_delay=0.25, max_delay=2.0, deadline=120.0)
        try:
            return retrier.poll(fetch_once)
        except _faults.RetryExhausted:
            raise HorovodInternalError(
                f"the endpoint of rendezvous round {rendezvous_round} never "
                f"appeared in the KV (rank 0 failed before publishing?)"
            ) from None
    except HorovodInternalError:
        raise
    except Exception as e:
        raise HorovodInternalError(
            f"elastic endpoint rendezvous failed: {e}") from e


class HostWorld:
    """Process-rank collective world over the native host data plane."""

    def __init__(self):
        self._lock = threading.Lock()
        self.initialized = False
        self.rank = 0
        self.size = 1
        self.local_rank = 0
        self.local_size = 1
        self.cross_rank = 0
        self.cross_size = 1
        self._core: Optional[_native.NativeCore] = None
        self._owns_core = False
        self._staging = None  # host_staging.HostStagingExecutor when active
        # The seams of the fault points that exist only in some worlds:
        # a local leader of a hierarchical multi-host world carries the
        # cross-host leg (ring.hier.cross); the shm transport is armed
        # (ring.shm.exec); the striped cross transport is armed
        # (ring.stripe.exec).
        self._hier_cross_seam = False
        self._shm_seam = False
        self._stripe_seam = False

    # -- lifecycle -----------------------------------------------------------

    def init(self, comm=None, device=None):
        """Join the world. ``comm``: a subset of the launched ranks (as
        ``hvd.init(comm=[...])``). ``device``: where host staging runs its
        collective (default ``cuda:<local rank>``; ``"cpu"`` runs it with
        gloo); read only with ``HOROVOD_HOST_VIA_XLA=1``."""
        with self._lock:
            if self.initialized:
                return
            core = self._borrow_engine_core()
            if core is None and _config.elastic_enabled():
                # Without hvd.init this world rendezvouses itself; with it,
                # hvd.init already installed the round's layout.
                elastic_rendezvous(_config.rank())
            rw = _config.round_world()
            if rw is not None:
                self.rank, self.size = rw["rank"], rw["size"]
                self.local_rank = rw["local_rank"]
                self.local_size = rw["local_size"]
            else:
                self.rank = int(_sched_env(_config.HOROVOD_RANK,
                                           _SCHED_RANK, "0"))
                self.size = int(_sched_env(_config.HOROVOD_SIZE,
                                           _SCHED_SIZE, "1"))
                self.local_rank = int(
                    _sched_env(_config.HOROVOD_LOCAL_RANK,
                               _SCHED_LOCAL_RANK, "0"))
                self.local_size = int(
                    _sched_env(_config.HOROVOD_LOCAL_SIZE,
                               _SCHED_LOCAL_SIZE, "1"))
            # The launcher's cross topology wins; under a scheduler it
            # follows from the per-node packing (a homogeneous layout).
            ls = max(1, self.local_size)
            self.cross_rank = _config.cross_rank(self.rank // ls)
            self.cross_size = _config.cross_size(
                max(1, (self.size + ls - 1) // ls))
            if comm is not None:
                if self.rank not in comm:
                    raise ValueError(
                        f"process rank {self.rank} not in comm {comm}")
                self.size = len(comm)
                self.rank = sorted(comm).index(self.rank)

            # The forced-failure hooks belong to one world: clear any
            # earlier world's arming.
            os.environ.pop("HVD_SHM_FORCE_ATTACH_FAIL", None)
            os.environ.pop("HVD_STRIPE_FORCE_CONNECT_FAIL", None)
            if _config.shm_enabled() and self.size > 1 and \
                    self.local_size > 1:
                try:
                    _faults.point("ring.shm.attach", rank=self.rank)
                except _faults.FaultInjected as e:
                    # An absorbed raise: it simulates a failed shm attach,
                    # so this rank's native attaches fail and TCP carries
                    # its local legs, byte for byte the same.
                    os.environ["HVD_SHM_FORCE_ATTACH_FAIL"] = "1"
                    from . import metrics as _metrics

                    _metrics.inc("shm.attach_fallback")
                    _log.warning(
                        f"ring.shm.attach fault armed: forcing shm "
                        f"attach failure; TCP carries the local legs "
                        f"({e})")
            if _config.stripes() > 1 and self.size > 1 and \
                    self.cross_size > 1:
                try:
                    _faults.point("ring.stripe.connect", rank=self.rank)
                except _faults.FaultInjected as e:
                    # The stripe sibling: this rank's stripe dials fail,
                    # and the cross legs fall back to one socket in
                    # lock-step (a hard error under
                    # HOROVOD_STRIPE_FALLBACK=0).
                    os.environ["HVD_STRIPE_FORCE_CONNECT_FAIL"] = "1"
                    from . import metrics as _metrics

                    _metrics.inc("stripe.connect_fallback")
                    _log.warning(
                        f"ring.stripe.connect fault armed: forcing "
                        f"stripe connect failure; single-socket TCP "
                        f"carries the cross legs ({e})")
            if core is not None:
                self._core, self._owns_core = core, False
            elif self.size > 1:
                self._core = self._init_own_core()
                self._owns_core = True
            else:
                # A world of one: every collective is the identity; no
                # controller or ring.
                self._core = None
            self._staging = None
            cfg = _config.RuntimeConfig.from_env()
            self._hier_cross_seam = (
                self.size > 1 and self.cross_size > 1
                and self.local_rank == 0
                and (cfg.hierarchical_allreduce or
                     cfg.hierarchical_allgather))
            self._shm_seam = (_config.shm_enabled() and self.size > 1
                              and self.local_size > 1)
            self._stripe_seam = (_config.stripes() > 1 and self.size > 1
                                 and self.cross_size > 1)
            if self._core is not None:
                from . import host_staging

                # Every rank of a multi-process world takes part in the
                # staging vote, with the knob or without it.
                try:
                    self._staging = host_staging.maybe_activate(
                        self, self._core, owns_exec_slot=self._owns_core,
                        device=device)
                except BaseException:
                    if self._owns_core:
                        self._core.shutdown()
                    self._core = None
                    raise
            self.initialized = True

    @staticmethod
    def _borrow_engine_core():
        from . import state as _state

        st = _state.global_state()
        if st.initialized and st.engine is not None:
            return st.engine.native_core
        return None

    def _init_own_core(self) -> _native.NativeCore:
        core = _native.NativeCore()
        if not core.available:
            raise HorovodInternalError(
                "a multi-process host world needs the native core; "
                "HOROVOD_NATIVE=0 turned it off")
        cfg = _config.RuntimeConfig.from_env()

        def reject_xla(responses, rid):
            core.response_done(rid, False,
                               "no device executor in a host-only world")

        ok = core.init(
            rank=self.rank, size=self.size, local_rank=self.local_rank,
            local_size=self.local_size, cross_rank=self.cross_rank,
            cross_size=self.cross_size,
            coordinator_addr=_config.controller_addr(),
            coordinator_port=_config.native_controller_port(),
            my_host=_config.hostname("127.0.0.1"),
            cycle_time_ms=cfg.cycle_time_ms,
            fusion_threshold=cfg.fusion_threshold_bytes,
            cache_capacity=cfg.cache_capacity,
            stall_warning_sec=cfg.stall_warning_seconds,
            stall_shutdown_sec=cfg.stall_shutdown_seconds,
            stall_check_enabled=not cfg.stall_check_disable,
            exec_callback=reject_xla,
            heartbeat_ms=_config.heartbeat_ms(),
            liveness_timeout_ms=_config.liveness_timeout_ms())
        if not ok:
            raise HorovodInternalError(
                f"native controller world join failed (rank {self.rank} of "
                f"{self.size}, controller {_config.controller_addr()}:"
                f"{_config.native_controller_port()}): coordinator "
                f"unreachable or worker-connect timeout")
        return core

    def drain(self):
        """Graceful departure: mark this rank's leaving as a clean DRAIN on
        the native controller, then shut the world down."""
        with self._lock:
            if self.initialized and self._core is not None and \
                    self._owns_core:
                self._core.drain()
        self.shutdown()

    def shutdown(self):
        with self._lock:
            if not self.initialized:
                return
            if self._core is not None and self._owns_core:
                if self._staging is not None:
                    self._core.set_host_via_xla(-1)
                    self._staging.close()
                self._core.shutdown()
            self._core = None
            self._staging = None
            self._hier_cross_seam = False
            self._shm_seam = False
            self._stripe_seam = False
            self.initialized = False
            self.rank, self.size = 0, 1
            self.local_rank, self.local_size = 0, 1
            self.cross_rank, self.cross_size = 0, 1

    def require_init(self):
        if not self.initialized:
            raise NotInitializedError("host collective API")

    @property
    def native(self) -> bool:
        return self._core is not None

    @property
    def staging(self):
        """The active ``host_staging.HostStagingExecutor``, or None."""
        return self._staging

    @contextlib.contextmanager
    def ring_only(self, name: str = "host.ring_only"):
        """Every host response inside the block rides the ring, staged or
        not (an A/B of staging against the ring on the same tensors).
        Every rank enters and leaves the block together: a barrier on
        each side, so every rank routes each response alike."""
        self.require_init()
        if self._staging is None:
            yield
            return
        self.barrier(f"{name}.enter")
        self._core.set_host_via_xla(-1)
        try:
            yield
        finally:
            self.barrier(f"{name}.leave")
            self._staging.enable_routing()

    # -- raw buffer collectives ---------------------------------------------

    def enqueue(self, name: str, op: int, reduce_op: int, dtype_code: int,
                shape: Tuple[int, ...], data_ptr: int, output_ptr: int,
                root_rank: int = -1, prescale: float = 1.0,
                postscale: float = 1.0) -> int:
        self.require_init()
        _faults.point("host_world.enqueue", rank=self.rank)
        if self._core is None:
            raise HorovodInternalError(
                "native host plane unavailable in this process")
        return self._core.enqueue(
            name, op, reduce_op, dtype_code, shape, data_ptr=data_ptr,
            output_ptr=output_ptr, root_rank=root_rank, prescale=prescale,
            postscale=postscale, plane=_native.PLANE_HOST)

    def test(self, handle: int) -> Tuple[int, str]:
        core = self._core
        if core is None:
            raise HorovodInternalError(
                "native host plane unavailable (shut down?)")
        return core.test(handle)

    def wait(self, handle: int) -> Tuple[int, str]:
        core = self._core
        if core is None:
            raise HorovodInternalError(
                "native host plane unavailable (shut down?)")
        # The blocking seam of a ring collective: a kind=exit fault here
        # kills the worker after its tensor was submitted.
        _faults.point("ring.exec", rank=self.rank)
        if self._hier_cross_seam:
            _faults.point("ring.hier.cross", rank=self.rank)
        if self._shm_seam:
            _faults.point("ring.shm.exec", rank=self.rank)
        if self._stripe_seam:
            _faults.point("ring.stripe.exec", rank=self.rank)
        return core.wait(handle)

    # -- small helper collectives (numpy, blocking) --------------------------

    def _run(self, name, op, arr, out, root_rank=-1):
        h = self.enqueue(name, op, 1, dtype_code(arr.dtype), arr.shape,
                         arr.ctypes.data, out.ctypes.data if out is not None
                         else 0, root_rank=root_rank)
        r, err = self.wait(h)
        if r < 0:
            raise HorovodInternalError(err)
        return h

    def allgather_np(self, arr: np.ndarray, name: str) -> np.ndarray:
        """Blocking equal-shape allgather of a small numpy array."""
        self.require_init()
        if self.size == 1:
            return arr.copy()
        arr = np.asarray(arr, order="C")
        out = np.zeros((self.size,) + arr.shape, dtype=arr.dtype)
        self._run(name, _native.OP_ALLGATHER, arr, out)
        return out

    def result_fetch(self, handle: int):
        """An executor-allocated result (see ``NativeCore.result_fetch``)."""
        core = self._core
        if core is None:
            raise HorovodInternalError(
                "native host plane unavailable (shut down?)")
        return core.result_fetch(handle)

    def allgatherv_np(self, arr: np.ndarray, name: str):
        """Ragged allgather (MPI_Allgatherv): the ranks' dim-0 sizes may
        differ. Returns (concatenated array, per-rank sizes); the executor
        allocates the output once the response's dims arrive."""
        self.require_init()
        arr = np.ascontiguousarray(arr)
        if arr.ndim == 0:
            arr = arr.reshape(1)
        if self.size == 1 or self._core is None:
            return arr.copy(), np.asarray([arr.shape[0]], np.int64)
        h = self._run(name, _native.OP_ALLGATHER, arr, None)
        fetched = self._core.result_fetch(h)
        if fetched is None:
            raise HorovodInternalError(
                f"allgather result missing for '{name}'")
        raw, dims = fetched
        out = np.frombuffer(bytearray(raw), dtype=arr.dtype).reshape(
            (int(sum(dims)),) + arr.shape[1:])
        return out, np.asarray(dims, np.int64)

    def broadcast_np(self, arr: np.ndarray, root_rank: int,
                     name: str) -> np.ndarray:
        self.require_init()
        if self.size == 1:
            return arr.copy()
        arr = np.asarray(arr, order="C")
        out = arr.copy()
        self._run(name, _native.OP_BROADCAST, arr, out, root_rank=root_rank)
        return out

    def join(self) -> int:
        """Graceful departure: this process stops submitting and
        contributes zeros to the others' reductions until every process
        joins. Returns the rank that joined last."""
        self.require_init()
        if self.size == 1 or self._core is None:
            return self.size - 1
        h = self._core.join()
        if h < 0:
            raise HorovodInternalError("join enqueue failed")
        r, err = self._core.wait(h)
        if r < 0:
            raise HorovodInternalError(err)
        return self._core.last_joined()

    def barrier(self, name: str = "host.barrier"):
        self.require_init()
        if self.size == 1 or self._core is None:
            return
        z = np.zeros(1, np.uint8)
        h = self.enqueue(name, _native.OP_BARRIER, 1, 0, z.shape,
                         z.ctypes.data, z.ctypes.data)
        r, err = self.wait(h)
        if r < 0:
            raise HorovodInternalError(err)


_world = HostWorld()


def world() -> HostWorld:
    return _world
