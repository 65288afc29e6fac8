"""The torch binding's collectives: Horovod's ``allreduce``,
``allgather`` and ``broadcast`` with their ``_async`` and in-place
forms, ``poll``, ``synchronize``, ``join`` and ``barrier`` (the port's
counterpart of ``horovod_tpu/torch/mpi_ops.py``).

``init()`` joins the world as ``hvd.init`` does: this rank on
``cuda:<local rank>`` with NCCL, or on the CPU with gloo when the caller
passes ``device="cpu"``. A tensor then takes one of two planes, chosen by
where it lies:

- on the world's device: the eager engine (``ops/eager.py``), named and
  negotiated by the native core and run on NCCL (gloo on the CPU);
- on the CPU in a world on a GPU: the host world's ring
  (``common/host_world.py``) on the same native core, as the reference
  binding carries its CPU tensors.

Any other device, or a dtype the core does not carry (complex ones
included), raises ``ValueError``: a tensor is never copied to another
device. Handles are one int table over both planes. ``synchronize``
waits for a result on the card by polling its completion event, so a
world that lost a rank (the watch of ``common/state.py`` aborts its
communicators) raises ``HorovodInternalError`` instead of waiting.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..common import native as _native
from ..common import state as _state
from ..common.exceptions import HorovodInternalError, NotInitializedError
from ..common.host_world import world as _host_world
from ..ops.collectives import Adasum, Average, Max, Min, ReduceOp, Sum
from .compression import Compression

__all__ = [
    "init", "shutdown", "rank", "size", "local_rank", "local_size",
    "cross_rank", "cross_size", "is_initialized",
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
    "allgather", "allgather_async", "broadcast", "broadcast_",
    "broadcast_async", "broadcast_async_", "poll", "synchronize", "join",
    "barrier", "Average", "Sum", "Adasum", "Min", "Max", "ReduceOp",
]


def init(comm=None, device=None):
    """Join the world (``hvd.init()``): ``device`` defaults to
    ``cuda:<local rank>`` (NCCL); ``"cpu"`` runs on gloo. In a world on a
    GPU the host world starts too, on the engine's core, for CPU tensors.
    ``comm`` (a subset of the launched ranks) is not supported."""
    if comm is not None:
        raise ValueError("horovod_tpu_torch.torch.init takes no comm: the "
                         "world is every launched rank")
    _state.init(device=device)
    _init_host_world()


def _init_host_world():
    if _state.device().type == "cuda":
        _host_world().init()


def shutdown():
    _host_world().shutdown()
    _state.shutdown()


def reinitialize():
    """``shutdown``, then ``init`` as the last ``init`` did: the elastic
    retry loop's re-init (under ``HOROVOD_ELASTIC``, against the driver's
    current plan)."""
    _host_world().shutdown()
    _state.reinitialize()
    _init_host_world()


def is_initialized() -> bool:
    return _state.is_initialized()


rank = _state.rank
size = _state.size
local_rank = _state.local_rank
local_size = _state.local_size
cross_rank = _state.cross_rank
cross_size = _state.cross_size

# ---- the handle table --------------------------------------------------------

_ENGINE, _HOST, _DONE = "engine", "host", "done"


class _Handle:
    """``plane``: where the work runs; ``inner``: that plane's handle;
    ``output``: the result tensor (host plane and done); ``post``: maps
    the plane's result to the caller's; ``keepalive``: tensors whose
    memory the host ring reads until the handle resolves."""

    __slots__ = ("plane", "inner", "output", "post", "keepalive")

    def __init__(self, plane, inner=None, output=None, post=None,
                 keepalive=None):
        self.plane = plane
        self.inner = inner
        self.output = output
        self.post = post
        self.keepalive = keepalive


_handles: Dict[int, _Handle] = {}
_handles_lock = threading.Lock()
_next_handle = 0
_name_counter = 0


def _new_handle(entry: _Handle) -> int:
    global _next_handle
    with _handles_lock:
        h = _next_handle
        _next_handle += 1
        _handles[h] = entry
        return h


def _auto_name(prefix: str) -> str:
    global _name_counter
    with _handles_lock:
        _name_counter += 1
        return f"torch.{prefix}.noname.{_name_counter}"


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (a.index if a.index is not None else current) == \
        (b.index if b.index is not None else current)


def _plane(tensor) -> str:
    """The plane ``tensor`` takes (see the module's docstring); raises
    ``ValueError`` for any other device or dtype."""
    if not isinstance(tensor, torch.Tensor):
        raise ValueError(f"expected a torch.Tensor, got {type(tensor)}")
    if tensor.dtype not in _native.TORCH_DTYPE_CODES:
        raise ValueError(f"unsupported torch dtype {tensor.dtype}")
    dev = _state.device()
    if _same_device(tensor.device, dev):
        return _ENGINE
    if tensor.device.type == "cpu" and dev.type == "cuda":
        return _HOST
    raise ValueError(
        f"a tensor on {tensor.device} in a world on {dev}: the binding "
        f"carries tensors on the world's device and, beside a GPU, on the "
        f"CPU")


def _engine():
    st = _state.global_state()
    if not st.initialized:
        raise NotInitializedError("horovod_tpu_torch.torch")
    return st.engine


def _resolve_op(op: Optional[int], average: Optional[bool]) -> int:
    """The deprecated ``average`` argument: either it or ``op``; Average
    when neither is given."""
    if average is not None:
        if op is not None:
            raise ValueError("specify either op or average, not both")
        return Average if average else Sum
    return Average if op is None else op


def _check_adasum(op: int) -> None:
    n = size()
    if op == Adasum and (n & (n - 1)) != 0:
        raise ValueError("Adasum requires a power-of-two world size")


# ---- submissions -------------------------------------------------------------


def _host_allreduce(tensor, output, name, op, prescale, postscale) -> int:
    """The reference binding's host-plane submission: the ring reads and
    writes the tensors in place; a world of one copies (and scales)."""
    w = _host_world()
    if w.size == 1:
        scale = prescale * (postscale if op not in (Min, Max) else 1.0)
        if scale == 1.0:
            # Never round-trip an int64 above 2^53 through a float.
            if output.data_ptr() != tensor.data_ptr():
                output.copy_(tensor)
        else:
            output.copy_((tensor.to(torch.float64) * scale).to(tensor.dtype))
        return _new_handle(_Handle(_DONE, output=output))
    h = w.enqueue(name, _native.OP_ALLREDUCE, op,
                  _native.TORCH_DTYPE_CODES[tensor.dtype],
                  tuple(tensor.shape), tensor.data_ptr(), output.data_ptr(),
                  prescale=prescale, postscale=postscale)
    return _new_handle(_Handle(_HOST, h, output, keepalive=tensor))


def _allreduce_async(tensor, output_into, name, op, prescale_factor,
                     postscale_factor) -> int:
    """``output_into``: the tensor the result is written into (the input,
    for the in-place forms), or None for a new one."""
    _check_adasum(op)
    if _plane(tensor) == _ENGINE:
        h = _engine().allreduce_async(
            tensor, name=name, op=op, prescale_factor=prescale_factor,
            postscale_factor=postscale_factor)
        post = None
        if output_into is not None:
            def post(out):
                output_into.copy_(out)
                return output_into
        return _new_handle(_Handle(_ENGINE, h, post=post))
    t = tensor.contiguous()
    if output_into is not None and t.data_ptr() != tensor.data_ptr():
        raise ValueError("in-place allreduce requires a contiguous tensor")
    out = t if output_into is not None else t.clone()
    return _host_allreduce(t, out, name, op, prescale_factor,
                           postscale_factor)


def allreduce_async(tensor: torch.Tensor, average: Optional[bool] = None,
                    name: Optional[str] = None, op: Optional[int] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0) -> int:
    return _allreduce_async(tensor, None, name or _auto_name("allreduce"),
                            _resolve_op(op, average), prescale_factor,
                            postscale_factor)


def allreduce_async_(tensor: torch.Tensor, average: Optional[bool] = None,
                     name: Optional[str] = None, op: Optional[int] = None,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0) -> int:
    return _allreduce_async(tensor, tensor, name or _auto_name("allreduce_"),
                            _resolve_op(op, average), prescale_factor,
                            postscale_factor)


class _AllreduceFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, name, op, prescale_factor, postscale_factor):
        ctx.op = op
        ctx.prescale_factor = prescale_factor
        ctx.postscale_factor = postscale_factor
        return synchronize(allreduce_async(
            tensor, name=name, op=op, prescale_factor=prescale_factor,
            postscale_factor=postscale_factor))

    @staticmethod
    def backward(ctx, grad_output):
        reduced = synchronize(allreduce_async(
            grad_output, op=ctx.op, prescale_factor=ctx.prescale_factor,
            postscale_factor=ctx.postscale_factor))
        return reduced, None, None, None, None


def allreduce(tensor: torch.Tensor, average: Optional[bool] = None,
              name: Optional[str] = None, compression=Compression.none,
              op: Optional[int] = None, prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """A synchronous, differentiable allreduce (Average unless ``op`` or
    ``average`` says otherwise); its backward all-reduces the gradient
    with the same op and factors."""
    compressed, ctx = compression.compress(tensor)
    summed = _AllreduceFn.apply(compressed, name, _resolve_op(op, average),
                                prescale_factor, postscale_factor)
    return compression.decompress(summed, ctx)


def allreduce_(tensor: torch.Tensor, average: Optional[bool] = None,
               name: Optional[str] = None, op: Optional[int] = None,
               prescale_factor: float = 1.0,
               postscale_factor: float = 1.0) -> torch.Tensor:
    return synchronize(allreduce_async_(
        tensor, average, name, op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor))


# ---- allgather ---------------------------------------------------------------


def _allgather_async(tensor, name, sizes_out=None) -> int:
    """Every rank's ``tensor`` joined along dim 0 (the first dims may
    differ). ``sizes_out``, when given, gets the ranks' first dims when
    the handle resolves."""
    if tensor.dim() == 0:
        tensor = tensor.reshape(1)
    if _plane(tensor) == _ENGINE:
        h = _engine().allgather_async(tensor, name=name)
        post = None
        if sizes_out is not None:
            dim0 = tensor.shape[0]

            def post(out):
                # Each rank's first dim rides a second, tiny gather only
                # when the caller asked for the split.
                sizes_out.append(_engine_first_dims(dim0, name))
                return out
        return _new_handle(_Handle(_ENGINE, h, post=post))
    w = _host_world()
    t = tensor.contiguous()
    if w.size == 1:
        if sizes_out is not None:
            sizes_out.append(np.asarray([t.shape[0]], np.int64))
        return _new_handle(_Handle(_DONE, output=t.clone()))
    rest = tuple(t.shape[1:])
    h = w.enqueue(name, _native.OP_ALLGATHER, 1,
                  _native.TORCH_DTYPE_CODES[t.dtype], tuple(t.shape),
                  t.data_ptr(), 0)

    def post(_unused):
        fetched = w.result_fetch(h)
        if fetched is None:
            raise HorovodInternalError(
                f"allgather result missing for '{name}'")
        raw, dims = fetched
        out = torch.empty((int(sum(dims)),) + rest, dtype=t.dtype)
        if len(raw):
            ctypes.memmove(out.data_ptr(), raw, len(raw))
        if sizes_out is not None:
            sizes_out.append(np.asarray(dims, np.int64))
        return out

    return _new_handle(_Handle(_HOST, h, post=post, keepalive=t))


def _engine_first_dims(dim0: int, name: str) -> np.ndarray:
    eng = _engine()
    mine = torch.tensor([dim0], dtype=torch.int64, device=_state.device())
    return eng.synchronize(eng.allgather_async(
        mine, name=f"{name}.first_dims")).cpu().numpy()


def allgather_async(tensor: torch.Tensor, name: Optional[str] = None) -> int:
    return _allgather_async(tensor, name or _auto_name("allgather"))


class _AllgatherFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, name):
        ctx.dim0 = tensor.shape[0] if tensor.dim() > 0 else 1
        sizes: list = []
        out = synchronize(_allgather_async(
            tensor, name or _auto_name("allgather"), sizes_out=sizes))
        ctx.sizes = sizes[0]
        return out

    @staticmethod
    def backward(ctx, grad_output):
        # The gathered gradient summed over the ranks, then this rank's
        # rows.
        reduced = synchronize(allreduce_async(grad_output, op=Sum))
        offset = int(ctx.sizes[:rank()].sum())
        return reduced.narrow(0, offset, ctx.dim0), None


def allgather(tensor: torch.Tensor, name: Optional[str] = None) -> torch.Tensor:
    """Every rank's ``tensor`` joined along dim 0, differentiable."""
    _plane(tensor)
    return _AllgatherFn.apply(tensor, name)


# ---- broadcast ---------------------------------------------------------------


def _broadcast_async(tensor, output_into, root_rank, name) -> int:
    if not 0 <= root_rank < size():
        raise ValueError(f"root_rank {root_rank} outside the world of "
                         f"{size()}")
    if _plane(tensor) == _ENGINE:
        h = _engine().broadcast_async(tensor, root_rank, name=name)
        post = None
        if output_into is not None:
            def post(out):
                output_into.copy_(out)
                return output_into
        return _new_handle(_Handle(_ENGINE, h, post=post))
    t = tensor.contiguous()
    if output_into is not None and t.data_ptr() != tensor.data_ptr():
        raise ValueError("in-place broadcast requires a contiguous tensor")
    out = t if output_into is not None else t.clone()
    w = _host_world()
    if w.size == 1:
        return _new_handle(_Handle(_DONE, output=out))
    h = w.enqueue(name, _native.OP_BROADCAST, 1,
                  _native.TORCH_DTYPE_CODES[t.dtype], tuple(t.shape),
                  t.data_ptr(), out.data_ptr(), root_rank=root_rank)
    return _new_handle(_Handle(_HOST, h, out, keepalive=t))


def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    name: Optional[str] = None) -> int:
    return _broadcast_async(tensor, None, root_rank,
                            name or _auto_name("broadcast"))


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     name: Optional[str] = None) -> int:
    return _broadcast_async(tensor, tensor, root_rank,
                            name or _auto_name("broadcast_"))


class _BroadcastFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, root_rank, name):
        ctx.root_rank = root_rank
        return synchronize(broadcast_async(tensor, root_rank, name=name))

    @staticmethod
    def backward(ctx, grad_output):
        # Only the root's input reached the output: it gets the sum of
        # every rank's gradient, the others zeros.
        reduced = synchronize(allreduce_async(grad_output, op=Sum))
        if rank() != ctx.root_rank:
            reduced = reduced * 0
        return reduced, None, None


def broadcast(tensor: torch.Tensor, root_rank: int,
              name: Optional[str] = None) -> torch.Tensor:
    """A copy of ``root_rank``'s tensor on every rank, differentiable."""
    _plane(tensor)
    return _BroadcastFn.apply(tensor, root_rank, name)


def broadcast_(tensor: torch.Tensor, root_rank: int,
               name: Optional[str] = None) -> torch.Tensor:
    return synchronize(broadcast_async_(tensor, root_rank, name))


# ---- completion ---------------------------------------------------------------


def _lookup(handle: int, pop: bool) -> _Handle:
    with _handles_lock:
        entry = _handles.pop(handle, None) if pop else _handles.get(handle)
    if entry is None:
        raise ValueError(f"unknown or already-synchronized handle {handle}")
    return entry


def poll(handle: int) -> bool:
    """True once the collective behind ``handle`` has completed."""
    entry = _lookup(handle, pop=False)
    if entry.plane == _ENGINE:
        return _engine().poll(entry.inner)
    if entry.plane == _HOST:
        r, _ = _host_world().test(entry.inner)
        return r != 0
    return True


def synchronize(handle: int) -> torch.Tensor:
    """Wait for the collective behind ``handle`` and return its result.
    Raises ``HorovodInternalError`` when it failed or the world lost a
    peer (the elastic retry loop's trigger)."""
    entry = _lookup(handle, pop=True)
    if entry.plane == _ENGINE:
        eng = _engine()
        # A wait on the card that a dead peer would make endless: poll the
        # completion, and give up once the watch has found the world
        # down.
        _state.poll_until(lambda: eng.poll(entry.inner))
        _state.check_world()
        out = eng.synchronize(entry.inner)
    elif entry.plane == _HOST:
        r, err = _host_world().wait(entry.inner)
        if r < 0:
            raise HorovodInternalError(err)
        out = entry.output
    else:
        out = entry.output
    return entry.post(out) if entry.post is not None else out


def barrier():
    """Wait for every rank (negotiated, so a joined rank does not block
    it)."""
    _engine().barrier()


def join(device: int = -1) -> int:
    """Graceful departure: this rank stops submitting and contributes
    zeros to the others' allreduces until every rank has joined; returns
    the rank that joined last. ``device`` is accepted for Horovod's
    signature and ignored (one device a process)."""
    return _engine().join()

