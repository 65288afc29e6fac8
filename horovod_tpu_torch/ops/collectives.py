"""Collectives on the port's process group (NCCL on GPUs, gloo on CPUs).

Counterpart of ``horovod_tpu/ops/xla.py``, whose collectives XLA compiled
into the program over ICI. Here each collective is a ``torch.distributed``
call on the group ``hvd.init()`` made, with the same numerics:

- bf16/fp16 inputs are accumulated — and travel — at fp32 unless a
  compressor names a 16-bit wire dtype;
- pre/postscale factors apply in fp32 inside that accumulation window,
  never in a 16-bit dtype;
- with compression, averaging and postscale run in fp32 on the reduced
  value before the cast back to the input dtype.

``allreduce_async`` returns a handle whose ``wait()`` finishes that
arithmetic; the optimizer launches one per fusion bucket from backward
hooks and waits in ``step()``. The default op is Average, Horovod's
user-level default.

Sequence parallelism adds collectives on one axis group of
``parallel/mesh.py`` (an ``AxisGroup``), in the roles ``lax.ppermute``,
``lax.all_to_all`` and ``lax.all_gather`` play in the JAX package:
``ring_exchange``, ``all_to_all`` and ``allgather_along``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from ..common.compression import resolve_compression
from ..common.fusion import plan_buckets_for, resolve_bucket_cap


class ReduceOp:
    """Reduction op ids (the JAX package's ``ReduceOp`` values)."""

    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX

_LOW_PRECISION = (torch.bfloat16, torch.float16)
_DIST_OP = {ReduceOp.SUM: dist.ReduceOp.SUM,
            ReduceOp.AVERAGE: dist.ReduceOp.SUM,
            ReduceOp.MIN: dist.ReduceOp.MIN,
            ReduceOp.MAX: dist.ReduceOp.MAX}


def _scale(acc, factor):
    """Multiply in ``acc``'s own dtype (the accumulation dtype); no-op
    for factor 1."""
    if factor == 1.0:
        return acc
    return acc * (factor if acc.dtype.is_floating_point else int(factor))


def _scale_f32(tensor, factor):
    """Scale at fp32 whatever the input dtype (no-op for factor 1)."""
    if factor == 1.0:
        return tensor
    return tensor.float() * factor


class PendingReduce:
    """An all-reduce in flight; ``wait()`` returns the result."""

    def __init__(self, work, acc, dtype, op, postscale, compressed, n):
        self._work = work
        self._acc = acc
        self._dtype = dtype
        self._op = op
        self._postscale = postscale
        self._compressed = compressed
        self._n = n

    def wait(self) -> torch.Tensor:
        self._work.wait()
        out = self._acc
        if self._compressed:
            out = out.float()
        if self._op == ReduceOp.AVERAGE:
            out = out / self._n
        return _scale(out, self._postscale).to(self._dtype)


def allreduce_async(tensor, op: int = ReduceOp.AVERAGE,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    compression=None) -> PendingReduce:
    """Launch an all-reduce of ``tensor`` across the world; the input is
    left unchanged."""
    if op == ReduceOp.ADASUM:
        raise NotImplementedError("Adasum comes with a later slice of the "
                                  "port")
    if op not in _DIST_OP:
        raise ValueError(f"unknown reduce op {op}")
    comp = resolve_compression(compression) if compression is not None \
        else None
    dtype = tensor.dtype
    wire = comp.wire_dtype(dtype) if comp is not None else None
    if wire is not None:
        acc = _scale_f32(tensor, prescale_factor).to(wire)
    else:
        acc = tensor.float() if dtype in _LOW_PRECISION else tensor
        acc = _scale(acc, prescale_factor)
    if acc is tensor:
        acc = tensor.clone()
    work = dist.all_reduce(acc, op=_DIST_OP[op], async_op=True)
    return PendingReduce(work, acc, dtype, op, postscale_factor,
                         wire is not None, dist.get_world_size())


def allreduce(tensor, op: int = ReduceOp.AVERAGE, prescale_factor: float = 1.0,
              postscale_factor: float = 1.0, compression=None):
    """All-reduce ``tensor`` across the world (see ``allreduce_async``)."""
    return allreduce_async(tensor, op, prescale_factor, postscale_factor,
                           compression).wait()


def fuse(flats: Sequence[torch.Tensor], indices: Sequence[int]):
    """One bucket's flat tensors concatenated into a fresh buffer."""
    if len(indices) == 1:
        return flats[indices[0]]
    return torch.cat([flats[i] for i in indices])


def unfuse(reduced: torch.Tensor, shapes, indices: Sequence[int]):
    """Split a reduced bucket back into (index, tensor) pairs."""
    off = 0
    for i in indices:
        n = 1
        for d in shapes[i]:
            n *= int(d)
        yield i, reduced[off:off + n].view(shapes[i])
        off += n


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      op: int = ReduceOp.AVERAGE, prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0, bucket_cap_bytes=None,
                      compression=None) -> List[torch.Tensor]:
    """All-reduce a list of tensors as fused buckets.

    ``bucket_cap_bytes`` unset: one bucket per dtype. An int (or
    ``"auto"`` following ``HOROVOD_FUSION_THRESHOLD``): size-capped
    dtype-pure buckets in reverse parameter order
    (``common/fusion.plan_buckets``). Every bucket is launched before the
    first is waited on. ``compression`` makes each bucket reduce in the
    compressed wire dtype and the plan budget that width.
    """
    if not tensors:
        return []
    cap = resolve_bucket_cap(bucket_cap_bytes)
    comp = resolve_compression(compression) if compression is not None \
        else None
    flats = [t.reshape(-1) for t in tensors]
    shapes = [t.shape for t in tensors]
    pending = [
        (b.indices, allreduce_async(fuse(flats, b.indices), op,
                                    prescale_factor, postscale_factor, comp))
        for b in plan_buckets_for(flats, cap, comp)
    ]
    out: List[torch.Tensor] = [None] * len(tensors)
    for indices, handle in pending:
        for i, t in unfuse(handle.wait(), shapes, indices):
            out[i] = t
    return out


def broadcast(tensor, root_rank: int):
    """A copy of root's ``tensor`` on every rank."""
    out = tensor.clone()
    dist.broadcast(out, src=root_rank)
    return out


class PendingExchange:
    """A ring exchange in flight; ``wait()`` returns the received
    tensors. It holds the tensors being sent until then."""

    def __init__(self, works, sent, received):
        self._works = works
        self._sent = sent
        self._received = received

    def wait(self) -> List[torch.Tensor]:
        for w in self._works:
            w.wait()
        self._sent = None
        return self._received


def ring_exchange(tensors: Sequence[torch.Tensor], axis, tag: int = 0
                  ) -> PendingExchange:
    """Send each tensor to the next rank of the ring ``axis`` (an
    ``AxisGroup``: index i sends to i + 1 and receives from i - 1, modulo
    the axis size) and receive the previous rank's tensors of the same
    shapes and dtypes: the port's ``lax.ppermute(x, axis, fwd_perm)``.
    One ``batch_isend_irecv``; the caller computes while it is in flight.
    Tensor i travels under tag ``tag + i``."""
    nxt = axis.global_rank(axis.rank + 1)
    prv = axis.global_rank(axis.rank - 1)
    sent = [t.contiguous() for t in tensors]
    received = [torch.empty_like(t) for t in sent]
    ops = []
    for i, (s, r) in enumerate(zip(sent, received)):
        ops.append(dist.P2POp(dist.isend, s, nxt, axis.group, tag + i))
        ops.append(dist.P2POp(dist.irecv, r, prv, axis.group, tag + i))
    return PendingExchange(dist.batch_isend_irecv(ops), sent, received)


def _all_to_all(x, split_dim, concat_dim, axis):
    chunks = torch.stack(x.chunk(axis.size, split_dim)).contiguous()
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=axis.group)
    return torch.cat(out.unbind(0), concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, axis):
        ctx.args = (split_dim, concat_dim, axis)
        return _all_to_all(x, split_dim, concat_dim, axis)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim, axis = ctx.args
        return _all_to_all(g, concat_dim, split_dim, axis), None, None, None


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, axis
               ) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)`` on
    the group ``axis``: ``x`` is cut into ``axis.size`` equal chunks
    along ``split_dim``, chunk i goes to axis rank i, and the chunks
    received are joined along ``concat_dim`` in axis-rank order (one
    ``all_to_all_single``). Differentiable: the backward is the reverse
    exchange."""
    if x.shape[split_dim] % axis.size:
        raise ValueError(f"all_to_all: dim {split_dim} of {list(x.shape)} "
                         f"does not split {axis.size} ways")
    return _AllToAll.apply(x, split_dim, concat_dim, axis)


def allgather_along(x: torch.Tensor, dim: int, axis) -> torch.Tensor:
    """Every axis rank's ``x`` joined along ``dim`` in axis-rank order
    (``lax.all_gather(..., tiled=True)``); not differentiable."""
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return torch.cat(parts, dim)


@torch.no_grad()
def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Overwrite, in place, every tensor of ``params`` (a ``state_dict``
    or an iterable of ``(name, tensor)``) with root's values."""
    items = params.items() if isinstance(params, dict) else params
    for _, p in sorted(items, key=lambda kv: kv[0]):
        dist.broadcast(p.data if isinstance(p, torch.nn.Parameter) else p,
                       src=root_rank)
