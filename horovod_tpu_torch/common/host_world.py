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

Not ported yet: the elastic re-rendezvous through the elastic driver's KV
(ROADMAP A17). Under ``HOROVOD_ELASTIC`` ``init`` refuses the world rather
than run a fixed one in its place.
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
            if _config.elastic_enabled():
                raise NotImplementedError(
                    "HOROVOD_ELASTIC: the host world's elastic "
                    "re-rendezvous is not ported yet (ROADMAP A17); "
                    "refusing to run a fixed world in place of an elastic "
                    "one")
            self.rank = int(_sched_env(_config.HOROVOD_RANK, _SCHED_RANK,
                                       "0"))
            self.size = int(_sched_env(_config.HOROVOD_SIZE, _SCHED_SIZE,
                                       "1"))
            self.local_rank = int(
                _sched_env(_config.HOROVOD_LOCAL_RANK, _SCHED_LOCAL_RANK,
                           "0"))
            self.local_size = int(
                _sched_env(_config.HOROVOD_LOCAL_SIZE, _SCHED_LOCAL_SIZE,
                           "1"))
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
            core = self._borrow_engine_core()
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
