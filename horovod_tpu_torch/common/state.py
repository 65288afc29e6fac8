"""Process-global runtime state and the basics API.

Counterpart of ``horovod_tpu/common/state.py``. The JAX package runs one
process that drives every local chip through one mesh; the port runs one
process per GPU, as Horovod does on GPUs. The world comes from the
launcher's environment (``HOROVOD_RANK/SIZE/LOCAL_RANK/LOCAL_SIZE/
CROSS_*`` and ``HOROVOD_CONTROLLER_ADDR/PORT`` for the rendezvous), and
the collectives run on one ``torch.distributed`` process group: NCCL when
the device is a GPU, gloo when the caller asks for the CPU. Without a
launcher the world has size 1, and the group is still made, so the
collective path is the same at every size. ``init`` also starts the
eager engine (``ops/eager.py``: the native core's negotiation and an
executor on a process group of its own) after the groups are made, the
timeline on a rank whose ``HOROVOD_TIMELINE`` names a file, and the
autotuner (``HOROVOD_AUTOTUNE``) on rank 0; ``shutdown`` stops them before
any group is destroyed.

Under ``HOROVOD_ELASTIC`` the layout and the store's endpoint come from
the elastic driver's plan for the current round
(``host_world.elastic_rendezvous``). A world of more than one process
whose native core runs keeps a watch on the core's verdict
(``_CoreWatch``): when a peer dies, NCCL raises nothing and a survivor's
kernel would wait for it forever, but the core's controller sees the
closed connection on its own thread, so the watch aborts the world's
communicators, and the collectives in flight and the next ones raise
``HorovodInternalError``, which the elastic retry loop answers with a
restore and ``reinitialize()``. A direct collective of the world's
groups turns its failure into that error through ``direct_collective``.
"""

from __future__ import annotations

import contextlib
import faulthandler
import gc
import importlib
import os
import socket
import sys
import threading
import time
from typing import Optional

import torch
import torch.distributed as dist

from . import config as _config
from . import logging as _log
from .exceptions import HorovodInternalError, NotInitializedError


class _GlobalState:
    def __init__(self):
        self.lock = threading.Lock()
        self.initialized = False
        self.config: Optional[_config.RuntimeConfig] = None
        self.device: Optional[torch.device] = None
        self.owns_group = False
        self.size = 0
        self.rank = 0
        self.local_size = 0
        self.local_rank = 0
        self.cross_size = 0
        self.cross_rank = 0
        self.is_homogeneous = True  # every host holds as many ranks
        self.axis_sizes = None   # {"dp", "pp", "sp", "tp"} sizes
        self.groups = None       # name -> this rank's AxisGroup
        self.engine = None       # the eager engine (ops/eager.py)
        self.timeline = None     # common/timeline.Timeline when written
        self.autotuner = None    # common/parameter_manager (rank 0)
        self.watch = None        # _CoreWatch of a world init made
        self.world_lost = False  # a rank was lost; the groups are aborted
        self.aborted = threading.Event()  # set once that abort returned
        self.store = None        # rank 0's TCPStore of a world init made

    def reset(self):
        self.__init__()


_state = _GlobalState()
# The arguments of the last init, for reinitialize().
_init_args: dict = {}

# Seconds a rank waits for rank 0 to open a new world on its store.
JOIN_TIMEOUT_S = 120.0
# How often the watch reads the core's verdict on the world.
WATCH_PERIOD_S = 0.01
# Seconds a failed direct collective waits for the core's verdict: the
# communicator may see a dead peer a cycle before the core does.
VERDICT_WAIT_S = 2.0
# Seconds each group's abort may take. Past it the watch names every
# group whose abort is still out in the log, dumps the Python stacks
# once (faulthandler), and lets ``check_world`` raise.
ABORT_GROUP_BOUND_S = 5.0
# Seconds a rank that found its world lost waits for the watch's abort:
# the group bound and slack for the watch's own thread. ``check_world``
# raises within this of the core's verdict.
ABORT_WAIT_S = ABORT_GROUP_BOUND_S + 5.0


class _CoreWatch:
    """A thread that reads the native core's verdict on the world
    (``NativeCore.world_lost``: a closed or silent controller connection,
    an eviction, a stall shutdown; a rank that asked to leave is not a
    loss) and calls ``on_lost`` once when the world was lost."""

    def __init__(self, core, on_lost):
        self._core, self._on_lost = core, on_lost
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="hvd-world-watch")
        self._thread.start()

    def _run(self):
        while not self._stop.wait(WATCH_PERIOD_S):
            if self._core.world_lost():
                self._on_lost()
                return

    def close(self):
        """Stop the thread, then read the verdict once more: a collective
        can raise on the core's own error before the thread's next read,
        and a lost world must be aborted before its groups are torn
        down."""
        self._stop.set()
        self._thread.join()
        if self._core.world_lost():
            self._on_lost()


# Rank 0's hold on its world's two ports (``_hold_ports``): port -> socket.
_held_ports: dict = {}


def _hold_ports(ports) -> None:
    """Hold ``ports`` (and let go of any other held before): a socket
    bound to each with ``SO_REUSEADDR`` that never listens. The store and
    the native controller bind beside it (both set ``SO_REUSEADDR``), but
    no ``connect()`` of the host takes a held port as its ephemeral local
    port. The controller's port is free once the core's bootstrap is over,
    and a base port from ``bind(0)`` makes it one that ``connect()``
    hands out: a peer's store client or an NCCL socket of the world could
    take it, and a re-init on the same ports then failed to listen there.
    A port that is taken already is left to the bind that needs it."""
    for port in [p for p in _held_ports if p not in ports]:
        _held_ports.pop(port).close()
    for port in ports:
        if port in _held_ports:
            continue
        sock = socket.socket()
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            sock.bind(("", port))
        except OSError:
            sock.close()
            continue
        _held_ports[port] = sock


# The token of the last world this process joined (``_open_store``).
_last_token: Optional[str] = None
_TOKEN_KEY = "hvd.world.token"
_CLOSED = "closed"


def _open_store(size: int, rank: int):
    """The world's store and its token. Rank 0 listens on the base port
    and puts a fresh token in its store; the others connect and wait for
    a token that is not the one of the last world they joined, nor the
    mark of an ended world (``_close_store``). At a re-init on the same
    port a peer (a member of the old world, or a process started in a
    lost rank's place) may reach rank 0's old store before it goes; the
    peer then waits there until it goes, and connects again, until
    ``JOIN_TIMEOUT_S``."""
    addr, port = _config.controller_addr(), _config.controller_base_port()
    if rank == 0:
        _hold_ports((port, _config.native_controller_port()))
        store = dist.TCPStore(addr, port, world_size=size, is_master=True)
        token = os.urandom(8).hex()
        store.set(_TOKEN_KEY, token)
        return store, token
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while True:
        try:
            store = dist.TCPStore(addr, port, world_size=size,
                                  is_master=False)
            while True:
                token = store.get(_TOKEN_KEY).decode()
                if token not in (_last_token, _CLOSED):
                    return store, token
                if time.monotonic() > deadline:
                    raise HorovodInternalError(
                        "rank 0 did not open a new world on its store")
                time.sleep(0.05)
        except RuntimeError:
            # The old store went away under us: rank 0 is re-initializing.
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)


def _close_store():
    """Mark rank 0's store as an ended world's, for whoever reaches it
    while the old groups keep it alive."""
    if _state.store is not None:
        try:
            _state.store.set(_TOKEN_KEY, _CLOSED)
        except RuntimeError:
            pass


# Each group's abort in the last lost world (``abort_report``); kept
# across ``shutdown``, which resets the rest of the state.
_abort_log: list = []


def abort_report() -> list:
    """Each group's abort in the last world this process lost: its
    ``name``, ``backend``, ``desc`` (torch's group description) and
    ``ranks`` (global), and ``seconds`` from the abort's start to its
    return, or None while it is still out."""
    return [{"name": a["name"], "backend": a["backend"], "desc": a["desc"],
             "ranks": a["ranks"],
             "seconds": None if a["end"] is None else a["end"] - a["start"]}
            for a in _abort_log]


def _label(a) -> str:
    desc = "" if a["desc"] in ("", "undefined") else f", {a['desc']}"
    return f"{a['name']!r} (ranks {a['ranks']}, {a['backend']}{desc})"


def _forget_groups(c10d) -> None:
    """Take every group out of torch's tables without aborting it again:
    what ``c10d._abort_process_group()`` does after its own aborts. A
    step that takes over a second is logged: dropping the last reference
    to an aborted NCCL group runs its destructor, which waits for torch's
    own threads (59.4 s once on an H100)."""
    world = c10d._world
    steps = [("the default group", lambda: c10d._update_default_pg(None))]
    steps += [(f"torch's {name}", getattr(world, name).clear)
              for name in ("pg_map", "pg_names", "pg_group_ranks",
                           "pg_backend_config", "pg_to_tag", "tags_to_pg",
                           "pg_coalesce_state")]
    steps.append(("the registry", c10d._unregister_all_process_groups))
    for name, step in steps:
        t0 = time.monotonic()
        step()
        if time.monotonic() - t0 > 1.0:
            _log.warning(f"dropping the lost world's groups: {name} took "
                         f"{time.monotonic() - t0:.1f} s")
    world.group_count = 0


def _on_world_lost():
    if _state.world_lost:
        return
    _state.world_lost = True
    _close_store()
    _log.warning("the native core lost a rank of the world: aborting the "
                 "world's communicators")
    # Every group of the process, so that a kernel waiting for the dead
    # peer returns (a gloo group raises by itself when a peer's connection
    # drops; aborting it does nothing). Each group's abort runs on a
    # thread of its own, so that no group's abort waits for another's,
    # and is timed and bounded (``ABORT_GROUP_BOUND_S``). Then the groups
    # leave torch's tables without torch's one call for every group
    # (``c10d._abort_process_group()``): it aborts every group again, and
    # on an H100 it once never returned when the world group's kernel
    # waited for the peer.
    from torch.distributed import distributed_c10d as c10d

    def abort(pg, rec):
        try:
            pg.abort()
        except RuntimeError as e:
            _log.warning(f"aborting group {rec['name']!r} failed: {e}")
        finally:
            rec["end"] = time.monotonic()

    try:
        _abort_log.clear()
        threads = []
        for pg in list(c10d._world.pg_map):
            rec = {"name": c10d._world.pg_names.get(pg, "?"),
                   "backend": str(c10d._world.pg_map[pg][0]),
                   "desc": getattr(pg, "group_desc", "") or "",
                   "ranks": sorted(c10d._world.pg_group_ranks.get(pg, {})),
                   "start": time.monotonic(), "end": None}
            _abort_log.append(rec)
            threads.append(threading.Thread(
                target=abort, args=(pg, rec), daemon=True,
                name=f"hvd-abort-{rec['name']}"))
            threads[-1].start()
        deadline = time.monotonic() + ABORT_GROUP_BOUND_S
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        _log.warning("the world's aborts: " + ", ".join(
            f"{_label(a)} " + ("still out" if a["seconds"] is None
                               else f"{a['seconds']:.3f} s")
            for a in abort_report()))
        out = [(rec, t) for rec, t in zip(_abort_log, threads)
               if t.is_alive()]
        if out:
            for rec, t in out:
                _log.warning(
                    f"the abort of group {_label(rec)} did not return "
                    f"within {ABORT_GROUP_BOUND_S} s (thread {t.ident:#x})")
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        # The raise need not wait for the groups to leave torch's tables;
        # a re-init does, through ``shutdown``, which joins this thread
        # (the old world's store, and so its port, goes with them).
        _state.aborted.set()
        _forget_groups(c10d)
    except (RuntimeError, ValueError) as e:
        _log.warning(f"aborting the world's groups failed: {e}")
    finally:
        _state.aborted.set()


def check_world() -> None:
    """Raise ``HorovodInternalError`` once the world was lost, after the
    watch's abort has returned: a kernel of the world's groups that
    waited for the dead peer has then ended, so what the caller does
    next on the card (the retry loop's restore) does not queue behind
    one. A group whose abort does not return holds it
    ``ABORT_GROUP_BOUND_S`` at most: the raise comes within
    ``ABORT_WAIT_S`` of the core's verdict."""
    if _state.world_lost:
        if not _state.aborted.wait(ABORT_WAIT_S):
            _log.warning(f"the world's abort did not return within "
                         f"{ABORT_WAIT_S} s")
        raise HorovodInternalError(
            "a rank of the world was lost; its communicators were aborted")


def poll_until(done) -> None:
    """Wait for ``done()`` by polling it; raise ``HorovodInternalError``
    (``check_world``) once the world is lost."""
    pause = 0.0
    while not done():
        check_world()
        time.sleep(pause)
        pause = min(1e-3, pause + 2e-5)


@contextlib.contextmanager
def direct_collective():
    """Around a direct collective of the world's groups (one the native
    core does not negotiate): in a world that lost a rank, c10d's error
    (or a result the abort cut short) becomes ``HorovodInternalError``,
    which the elastic retry loop answers. Any other error propagates.

    ``ops/collectives.guarded_allreduce`` runs one inside it."""
    check_world()
    try:
        yield
    except (RuntimeError, ValueError) as e:
        deadline = time.monotonic() + VERDICT_WAIT_S
        while _state.watch is not None and not _state.world_lost and \
                time.monotonic() < deadline:
            time.sleep(WATCH_PERIOD_S)
        if not _state.world_lost:
            raise
        try:
            check_world()
        except HorovodInternalError as lost:
            raise lost from e
    check_world()


# Torch's NCCL error handling for the groups an elastic ``init`` makes:
# the watch, not torch's watchdog, answers a lost rank (the watchdog would
# end the survivor), and a lost rank, an expected event there, does not
# set off the flight recorder's dump of every rank's collectives.
ELASTIC_NCCL_ENV = {"TORCH_NCCL_ASYNC_ERROR_HANDLING": "0",
                    "TORCH_NCCL_DUMP_ON_TIMEOUT": "0"}


@contextlib.contextmanager
def _nccl_error_handling(backend: str):
    """``ELASTIC_NCCL_ENV`` while ``init`` makes its NCCL groups under
    ``HOROVOD_ELASTIC``. A value the caller set is kept, and nothing else
    in the process (later groups, child processes) sees the change."""
    if backend != "nccl" or not _config.elastic_enabled():
        yield
        return
    added = [k for k in ELASTIC_NCCL_ENV if k not in os.environ]
    os.environ.update({k: ELASTIC_NCCL_ENV[k] for k in added})
    try:
        yield
    finally:
        for k in added:
            os.environ.pop(k, None)


def global_state() -> _GlobalState:
    return _state


def resolve_device(device=None, local_rank: Optional[int] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda:<local_rank>``. Raises when that GPU is not there — the port
    never moves to the CPU unless the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if local_rank is None:
        local_rank = (_state.local_rank if _state.initialized
                      else _config.local_rank())
    if not torch.cuda.is_available():
        raise RuntimeError(
            "horovod_tpu_torch runs on CUDA devices by default and none is "
            "available; pass device='cpu' to run on the CPU")
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(
            f"local rank {local_rank} has no GPU "
            f"({torch.cuda.device_count()} visible)")
    return torch.device("cuda", local_rank)


def _comm_world(comm, size: int, rank: int):
    """(size, rank) of the world of the launched ranks in ``comm``
    (``hvd.init(comm=[...])``): its members renumbered in sorted order.
    A rank outside it raises ``ValueError``."""
    if comm is None:
        return size, rank
    members = sorted(int(r) for r in comm)
    if rank not in members:
        raise ValueError(f"process rank {rank} not in comm {list(comm)}")
    return len(members), members.index(rank)


def init(device=None, sp: int = 1, tp: int = 1, pp: int = 1, comm=None):
    """Join the world and make its process groups.

    ``device``: where this process computes; defaults to
    ``cuda:<local_rank>``. Pass ``device="cpu"`` to run on the CPU (gloo).
    ``comm``: a subset of the launched ranks; its members form a world of
    ``len(comm)``, renumbered in sorted order (a rank outside it raises
    ``ValueError``, having joined nothing).
    ``sp``, ``tp``, ``pp``: the sequence-, tensor- and pipeline-parallel
    axis sizes; the world is the rank grid ``reshape(dp, pp, sp, tp)``
    with dp = size / (sp * tp * pp) (``parallel/mesh.py``), and a group is
    made for each axis, for the data shards (dp x sp), the stages
    (dp x pp x sp) and the local and cross hosts. Idempotent (a second
    call must ask for the same sizes). Adopts a ``torch.distributed``
    group the caller already made.
    """
    from ..ops.eager import EagerEngine
    from ..parallel.mesh import build_groups, factor_devices
    from .host_world import elastic_rendezvous

    global _last_token
    asked = {"sp": sp, "tp": tp, "pp": pp}
    with _state.lock:
        if _state.initialized:
            have = {a: _state.axis_sizes[a] for a in asked}
            if have != asked:
                raise ValueError(
                    f"already initialized with {have}; shutdown() before "
                    f"asking for {asked}")
            return
        _init_args.clear()
        _init_args.update(device=device, sp=sp, tp=tp, pp=pp, comm=comm)
        if not dist.is_initialized():
            elastic_rendezvous(_config.rank())
        elif comm is not None:
            raise ValueError("comm asks for a world of a subset of the "
                             "launched ranks; it cannot adopt the "
                             "torch.distributed group made already")
        size, rank = _comm_world(comm, _config.size(), _config.rank())
        # Bad axis sizes raise before the world is joined.
        factor_devices(dist.get_world_size() if dist.is_initialized()
                       else size, tp=tp, pp=pp, sp=sp)
        local_rank = _config.local_rank()
        local_size = _config.local_size(size)
        dev = resolve_device(device, local_rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        owns = False
        backend = "nccl" if dev.type == "cuda" else "gloo"
        with _nccl_error_handling(backend):
            if not dist.is_initialized():
                # Importing torch._dynamo (every torch.optim optimizer
                # does) while a default group exists keeps that group, and
                # with it its store's port, for the life of the process,
                # so a re-init could not listen there again: import it
                # before the group.
                importlib.import_module("torch._dynamo")
                try:
                    if size == 1:
                        store = dist.HashStore()
                    else:
                        store, token = _open_store(size, rank)
                    dist.init_process_group(backend, store=store, rank=rank,
                                            world_size=size)
                    if size > 1:
                        _last_token = token
                        _state.store = store if rank == 0 else None
                except (RuntimeError, OSError) as e:
                    if dist.is_initialized():
                        dist.destroy_process_group()
                    raise HorovodInternalError(
                        f"the world of {size} did not form at "
                        f"{_config.controller_addr()}:"
                        f"{_config.controller_base_port()}: {e}") from e
                owns = True
            _state.config = _config.RuntimeConfig.from_env()
            _state.device = dev
            _state.owns_group = owns
            _state.size = dist.get_world_size()
            _state.rank = dist.get_rank()
            _state.local_rank = local_rank
            _state.local_size = local_size
            _state.cross_size = _config.cross_size(
                max(1, _state.size // max(1, local_size)))
            _state.cross_rank = _config.cross_rank(
                _state.rank // max(1, local_size))
            # Hosts of different sizes get no local and cross groups, on
            # every rank alike.
            _state.is_homogeneous = _homogeneous(local_size, dev)
            _state.axis_sizes, _state.groups = build_groups(
                _state.size, _state.rank, sp=sp, tp=tp, pp=pp,
                local_size=local_size if _state.is_homogeneous else 0)
            try:
                _state.engine = EagerEngine(_state)
            except BaseException:
                if owns and dist.is_initialized():
                    dist.destroy_process_group()
                _state.reset()
                raise
        core = _state.engine.native_core
        if owns and _state.size > 1 and core is not None:
            _state.watch = _CoreWatch(core, _on_world_lost)
        if _state.config.timeline_filename:
            from .timeline import Timeline

            _state.timeline = Timeline(
                _state.config.timeline_filename,
                mark_cycles=_state.config.timeline_mark_cycles)
        if _state.config.autotune:
            _state.autotuner = _make_autotuner(_state.engine.native_core)
        _state.initialized = True


def _homogeneous(local_size: int, dev: torch.device) -> bool:
    """Whether every host of the world holds the same number of ranks:
    each rank's local size, gathered over the world group."""
    if dist.get_world_size() == 1:
        return True
    mine = torch.tensor([local_size], dtype=torch.int64, device=dev)
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    return len({int(t) for t in every}) == 1


def _make_autotuner(core):
    """The parameter manager, on rank 0 only: its (cycle ms, fusion
    bytes) point rides the response frames to every rank. In a world of
    more than one process the Python-side publishes stay off (the bucket
    cap of ``fusion.resolve_bucket_cap("auto")``, the compression mode and
    the ZeRO prefetch depth): they would change rank 0's config alone, and
    ranks whose bucket plans differ issue mismatched NCCL calls. Set
    ``HOROVOD_FUSION_THRESHOLD`` / ``HOROVOD_COMPRESSION`` /
    ``HOROVOD_ZERO_PREFETCH`` alike on every rank to govern those."""
    if core is None:
        _log.warning("HOROVOD_AUTOTUNE requested but the native core is "
                     "off (direct mode has no cycle or fusion to tune); "
                     "autotuning disabled")
        return None
    if _state.rank != 0:
        _log.debug("autotune: the tuner runs on rank 0; this rank applies "
                   "the parameters the response frames carry")
        return None
    from .parameter_manager import ParameterManager

    cfg = _state.config
    one_process = _state.size == 1

    def publish_cap(nbytes: int) -> None:
        cfg.fusion_threshold_bytes = int(nbytes)
        cfg.fusion_threshold_explicit = True

    def publish_compression(mode: str) -> None:
        cfg.compression = mode
        cfg.compression_explicit = True

    def publish_prefetch(depth: int) -> None:
        cfg.zero_prefetch = int(depth)
        cfg.zero_prefetch_explicit = True

    # Compression is explored only when the user asked for a mode: the
    # grid then answers whether that mode pays on this model.
    comp_candidates = ()
    if one_process and cfg.compression_explicit and \
            cfg.compression != "none":
        comp_candidates = ("none", cfg.compression)
    stripe_candidates = ()
    if _config.stripes() > 1:
        stripe_candidates = (1, _config.stripes())
    prefetch_candidates = ()
    if one_process and _config.zero_stage() == 3:
        prefetch_candidates = (0, 1, 2)
    if not one_process:
        _log.debug("autotune: bucket-cap/compression/prefetch publish off "
                   "in a world of more than one process")
    groups = _state.groups or {}
    return ParameterManager(
        core, warmup_samples=cfg.autotune_warmup_samples,
        steps_per_sample=cfg.autotune_steps_per_sample,
        max_samples=cfg.autotune_bayes_opt_max_samples,
        gp_noise=cfg.autotune_gaussian_process_noise,
        log_file=cfg.autotune_log,
        initial_cycle_ms=cfg.cycle_time_ms,
        initial_fusion_bytes=cfg.fusion_threshold_bytes,
        # The hierarchical grid only when the hierarchy spans hosts.
        tune_hierarchical=("local" in groups and "cross" in groups
                           and _state.cross_size > 1),
        bucket_cap_setter=publish_cap if one_process else None,
        compression_setter=(publish_compression if comp_candidates
                            else None),
        compression_candidates=comp_candidates,
        stripe_candidates=stripe_candidates,
        zero_prefetch_setter=(publish_prefetch if prefetch_candidates
                              else None),
        zero_prefetch_candidates=prefetch_candidates)


def shutdown():
    """Tear down the runtime: stops the watch, then the eager engine (its
    metrics pump, its native core, then its executor), closes the
    timeline, then destroys the process group if ``init`` made it (a
    world that lost a rank was aborted instead)."""
    with _state.lock:
        if not _state.initialized:
            return
        try:
            if _state.watch is not None:
                _state.watch.close()
            _close_store()
            _state.engine.shutdown()
        finally:
            if _state.timeline is not None:
                _state.timeline.close()
            if _state.owns_group and dist.is_initialized():
                if _state.world_lost:
                    # The watch aborted each group already.
                    from torch.distributed import distributed_c10d as c10d

                    _forget_groups(c10d)
                else:
                    dist.destroy_process_group()
            _state.reset()
            # A failed collective's error keeps the frames it was raised
            # through, whose locals hold the groups (and so the store and
            # its port), in a reference cycle through the pending entry
            # that keeps the error: collect it for a re-init on that port.
            gc.collect()


def drain():
    """A graceful departure: the DRAIN farewell on the native controller
    (the coordinator logs a drain, not a crash), then ``shutdown``."""
    with _state.lock:
        core = (_state.engine.native_core
                if _state.initialized and _state.engine is not None
                else None)
        if core is not None:
            core.drain()
    shutdown()


def reinitialize():
    """``shutdown``, then ``init`` with the arguments of the last
    ``init``: the elastic retry loop's re-init. Under ``HOROVOD_ELASTIC``
    the new world follows the driver's current plan. A world that does
    not form raises ``HorovodInternalError``."""
    args = dict(_init_args)
    shutdown()
    init(**args)


def is_initialized() -> bool:
    return _state.initialized


def _require_init(name: str) -> _GlobalState:
    if not _state.initialized:
        raise NotInitializedError(name)
    return _state


def size() -> int:
    """Number of processes (one per GPU) in the world."""
    return _require_init("size").size


def rank() -> int:
    return _require_init("rank").rank


def local_size() -> int:
    return _require_init("local_size").local_size


def local_rank() -> int:
    return _require_init("local_rank").local_rank


def cross_size() -> int:
    return _require_init("cross_size").cross_size


def cross_rank() -> int:
    return _require_init("cross_rank").cross_rank


def is_homogeneous() -> bool:
    """Whether every host holds the same number of ranks (the local
    sizes of the world ``init`` formed)."""
    return _require_init("is_homogeneous").is_homogeneous


def device() -> torch.device:
    """The device ``init`` chose for this process."""
    return _require_init("device").device


def _axis(name: str):
    return _require_init(f"{name} of the mesh").groups[name]


def sp_size() -> int:
    """Ranks along the sequence-parallel axis."""
    return _axis("sp").size


def sp_rank() -> int:
    """This rank's index along the sequence-parallel axis."""
    return _axis("sp").rank


def dp_size() -> int:
    """Ranks along the data-parallel axis (size / (sp * tp * pp))."""
    return _axis("dp").size


def dp_rank() -> int:
    """This rank's index along the data-parallel axis."""
    return _axis("dp").rank


def tp_size() -> int:
    """Ranks along the tensor-parallel axis."""
    return _axis("tp").size


def tp_rank() -> int:
    """This rank's index along the tensor-parallel axis."""
    return _axis("tp").rank


def pp_size() -> int:
    """Ranks along the pipeline axis (the number of stages)."""
    return _axis("pp").size


def pp_rank() -> int:
    """This rank's pipeline stage."""
    return _axis("pp").rank


def axis_group(axis: str):
    """This rank's ``AxisGroup`` of ``axis``: a mesh axis ("dp", "pp",
    "sp", "tp"), "data" (dp x sp), "stages" (dp x pp x sp), or "local" /
    "cross" (the hosts' axes; raises when the local size does not divide
    the world)."""
    groups = _require_init(f"axis_group({axis!r})").groups
    if axis not in groups:
        if axis in ("local", "cross"):
            raise ValueError(
                f"no {axis} group: the local size {_state.local_size} does "
                f"not divide the world of {_state.size}")
        raise ValueError(f"unknown axis group {axis!r}")
    return groups[axis]


def axis_sizes() -> dict:
    """The mesh's axis sizes, {"dp", "pp", "sp", "tp"}."""
    return dict(_require_init("axis_sizes").axis_sizes)
