"""horovod_tpu_torch — the PyTorch/CUDA port of horovod_tpu.

The JAX package ``horovod_tpu`` stays the reference; this package does its
work on torch tensors in CUDA memory, with NCCL in the role of XLA's
compiled collectives and hand-written Hopper kernels in place of the
Pallas TPU kernels. It imports neither ``jax`` nor ``horovod_tpu``.

Typical use, one process per GPU::

    import horovod_tpu_torch as hvd

    hvd.init()                                  # cuda:<local rank>, NCCL
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters()),
                                   named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

``hvd.init(sp=, tp=, pp=)`` lays the world out as dp x pp x sp x tp
(``parallel/mesh.py``); ``hvd.axis_group(name)`` returns this rank's group
of an axis. The flagship transformer runs on them: sequence-parallel
attention (ring or Ulysses) on sp, Megatron tensor parallelism on tp, the
GPipe pipeline on pp and MoE experts on dp
(``horovod_tpu_torch.parallel``, ``models/transformer.py``,
``transformer_bench``); the image trainer (``image_bench``) is data
parallel. ROADMAP.md lists what is still to port.

The eager API is Horovod's: ``allreduce_async(tensor, name=...)`` and its
kin return an int handle for ``poll``/``synchronize``; the native core
negotiates each named tensor across the ranks and fuses what arrives
together (``ops/eager.py``). ``join``, ``barrier``, ``stall_report``,
``liveness_report``, ``metrics`` and ``ring_traffic`` read or drive that
core. ``HOROVOD_TIMELINE``, ``HOROVOD_AUTOTUNE``,
``HOROVOD_METRICS_EXPORT`` and ``HOROVOD_FAULT_SPEC`` arm the runtime
planes around it (``common/{timeline,parameter_manager,metrics,faults}``).
CPU tensors of a process-rank world without ``hvd.init`` go through
``common/host_world.world()`` on the core's TCP ring, large ones through
NCCL with ``HOROVOD_HOST_VIA_XLA=1`` (``common/host_staging.py``). The direct collectives on a group (``allgather(x, axis=...)``,
``grouped_allreduce(..., bucket_cap_bytes=...)``, the differentiable
ones) live in ``horovod_tpu_torch.ops.collectives``, the counterpart of
``hvd.xla``.
"""

from typing import List, Optional


from .common import exceptions  # noqa: F401
from .common.compression import Compression  # noqa: F401
from .common.exceptions import (  # noqa: F401
    DuplicateTensorNameError,
    HorovodInternalError,
    NotInitializedError,
)
from .common.state import (  # noqa: F401
    axis_group,
    axis_sizes,
    cross_rank,
    cross_size,
    device,
    dp_rank,
    dp_size,
    init,
    is_initialized,
    local_rank,
    local_size,
    pp_rank,
    pp_size,
    rank,
    shutdown,
    size,
    sp_rank,
    sp_size,
    tp_rank,
    tp_size,
)
from .common.state import global_state as _global_state
from .ops.collectives import (  # noqa: F401
    Adasum,
    Average,
    Max,
    Min,
    ReduceOp,
    Sum,
    broadcast_parameters,
    grouped_hierarchical_allreduce,
    hierarchical_allgather,
    hierarchical_allreduce,
)
from .opt import DistributedOptimizer  # noqa: F401


def _engine():
    st = _global_state()
    if not st.initialized or st.engine is None:
        raise NotInitializedError("collective API")
    return st.engine


# ---- the eager API: named, negotiated, asynchronous ------------------------


def allreduce_async(tensor, name: Optional[str] = None, op: int = Average,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0) -> int:
    """Submit an allreduce of this rank's ``tensor`` under ``name``;
    returns a handle for ``poll``/``synchronize``. Average by default,
    as in Horovod."""
    return _engine().allreduce_async(
        tensor, name=name, op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor)


def allreduce(tensor, name: Optional[str] = None, op: int = Average,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0):
    """Eager allreduce (Average by default): ``synchronize`` of
    ``allreduce_async``."""
    return synchronize(allreduce_async(
        tensor, name=name, op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor))


def grouped_allreduce_async(tensors: List, name: Optional[str] = None,
                            op: int = Average, prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0) -> int:
    """Allreduce a list of tensors as one explicitly fused unit; the
    handle's result is the list."""
    return _engine().grouped_allreduce_async(
        tensors, name=name, op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor)


def grouped_allreduce(tensors: List, name: Optional[str] = None,
                      op: int = Average, prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0):
    return synchronize(grouped_allreduce_async(
        tensors, name=name, op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor))


def allgather_async(tensor, name: Optional[str] = None) -> int:
    """Submit an allgather along dim 0; the ranks' first dims may
    differ."""
    return _engine().allgather_async(tensor, name=name)


def allgather(tensor, name: Optional[str] = None):
    return synchronize(allgather_async(tensor, name=name))


def broadcast_async(tensor, root_rank: int, name: Optional[str] = None) -> int:
    return _engine().broadcast_async(tensor, root_rank, name=name)


def broadcast(tensor, root_rank: int, name: Optional[str] = None):
    """A copy of ``root_rank``'s tensor on every rank."""
    return synchronize(broadcast_async(tensor, root_rank, name=name))


def reducescatter_async(tensor, name: Optional[str] = None,
                        op: int = Sum) -> int:
    return _engine().reducescatter_async(tensor, name=name, op=op)


def reducescatter(tensor, name: Optional[str] = None, op: int = Sum):
    """Reduce over the ranks and keep this rank's block of dim 0."""
    return synchronize(reducescatter_async(tensor, name=name, op=op))


def alltoall_async(tensor, name: Optional[str] = None) -> int:
    return _engine().alltoall_async(tensor, name=name)


def alltoall(tensor, name: Optional[str] = None):
    """Block i of dim 0 goes to rank i; the received blocks are joined in
    rank order."""
    return synchronize(alltoall_async(tensor, name=name))


def poll(handle: int) -> bool:
    """True if the collective behind ``handle`` has completed."""
    return _engine().poll(handle)


def synchronize(handle: int):
    """Block until the collective completes and return its result."""
    return _engine().synchronize(handle)


def barrier():
    """Wait for every rank (negotiated by the native core)."""
    _engine().barrier()


def join() -> int:
    """Graceful departure: this rank stops submitting and contributes
    zeros to the others' allreduces until every rank has joined. Returns
    the rank that joined last (one device a process: a rank, not a
    chip)."""
    return _engine().join()


def _native_core():
    from .common import metrics as _metrics

    return _metrics.live_native_core()


def stall_report() -> str:
    """Drain the native stall inspector's warnings: the tensors some
    ranks submitted and others did not, past the warning time. Always a
    ``str``: empty when nothing stalled, before ``init`` or in direct
    mode. A non-empty report is also recorded as a ``STALL_WARNING``
    instant in the open timeline."""
    core = _native_core()
    if core is None:
        return ""
    report = core.stall_report()
    st = _global_state()
    if report and st.initialized and st.timeline is not None:
        from .common import timeline as _timeline

        st.timeline.instant(_timeline.STALL_WARNING, {"report": report})
    return report


def liveness_report() -> str:
    """Drain the native liveness plane's events (SUSPECT/EVICT/DRAIN/
    RECOVER lines; armed by ``HOROVOD_HEARTBEAT_MS``). Always a
    ``str``."""
    core = _native_core()
    return core.liveness_report() if core is not None else ""


def metrics() -> dict:
    """The unified metrics snapshot: ``{"python": {...}, "native": {...}
    | None}`` (counters, the log2 latency histograms, straggler state);
    ``native`` is None before init and in direct mode. Reading drains the
    pending straggler events into ``native["straggler"]["events"]`` and
    mirrors them as ``STRAGGLER_WARNING`` instants in the open
    timeline."""
    from .common import metrics as _metrics

    return _metrics.snapshot()


def metrics_report() -> str:
    """Human-readable rendering of :func:`metrics` (always a string)."""
    from .common import metrics as _metrics

    return _metrics.report_text()


def ring_traffic() -> dict:
    """The native core's host data-plane traffic: ``bytes_sent``,
    ``local_bytes``, ``cross_bytes``, ``shm_bytes``, ``shm``,
    ``stripe_bytes``, ``stripes``, the effective
    ``hierarchical_allreduce``/``hierarchical_allgather`` host dispatch
    and ``tuned``. Zeros before init or in direct mode."""
    core = _native_core()
    empty = {"bytes_sent": 0, "local_bytes": 0, "cross_bytes": 0,
             "shm_bytes": 0, "shm": False, "stripe_bytes": 0, "stripes": 0,
             "hierarchical_allreduce": False,
             "hierarchical_allgather": False, "tuned": False}
    snap = core.metrics_snapshot() if core is not None else None
    if not snap:
        return empty
    c = snap.get("counters", {})
    flags = int(c.get("host_hier_flags", 0))
    return {
        "bytes_sent": int(c.get("bytes_sent", 0)),
        "local_bytes": int(c.get("local_bytes", 0)),
        "cross_bytes": int(c.get("cross_bytes", 0)),
        "shm_bytes": int(c.get("shm_bytes", 0)),
        "shm": bool(c.get("shm_active", 0)),
        "stripe_bytes": int(c.get("stripe_bytes", 0)),
        "stripes": int(c.get("stripes", 0)),
        "hierarchical_allreduce": bool(flags & 1),
        "hierarchical_allgather": bool(flags & 2),
        "tuned": int(c.get("tuned_hier_flags", -1)) >= 0,
    }


def broadcast_object(obj, root_rank: int = 0, name: Optional[str] = None):
    """Broadcast a picklable object from ``root_rank`` (its pickle's
    length by a Sum allreduce, then its bytes by a broadcast). Unpickle
    only what your own ranks sent."""
    import pickle

    import numpy as np

    if size() == 1:
        return obj
    payload = pickle.dumps(obj) if rank() == root_rank else b""
    n = int(allreduce(np.asarray(len(payload), dtype=np.int64), op=Sum,
                      name=(name or "bcast.obj") + ".len"))
    buf = np.zeros(n, dtype=np.uint8)
    if rank() == root_rank:
        buf[:] = np.frombuffer(payload, dtype=np.uint8)
    buf = broadcast(buf, root_rank, name=(name or "bcast.obj") + ".data")
    return pickle.loads(buf.tobytes())
