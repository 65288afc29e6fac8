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

Every collective takes ``axis``, an ``AxisGroup`` of ``parallel/mesh.py``
(default: the world), in the role of the JAX package's ``axis_name``:
``allreduce``, ``allgather``, ``reducescatter`` (dim 0), ``alltoall``
(dim 0) and ``barrier``; ``hierarchical_allreduce`` and
``hierarchical_allgather`` run on the local and cross groups.

The model-parallel planes add differentiable collectives, in the roles
``lax.ppermute``, ``lax.all_to_all``, ``lax.all_gather`` and ``lax.psum``
play in the JAX package: ``ring_exchange`` and ``ring_shift`` (the
pipeline's hop, whose backward is the reverse hop), ``all_to_all`` (any
split and concat dims), ``allgather_along``, ``mean_over`` and the
Megatron pair ``copy_to_tp`` / ``reduce_from_tp``.

The ZeRO step (``zero.py``) has its two legs here: ``zero_reducescatter``
(a padded fp32 bucket's gradient, each rank keeping its 1/d of the sum)
and ``zero_allgather`` (a 1/d master segment back into the full bucket,
launched asynchronously so that gathers run ahead of the compute).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from ..common import state as _state
from ..common.compression import resolve_compression
from ..common.fusion import plan_buckets_for, resolve_bucket_cap
from ..parallel.mesh import AxisGroup


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


def _world() -> AxisGroup:
    return AxisGroup(None, tuple(range(dist.get_world_size())),
                     dist.get_rank())


def _to_acc(tensor, prescale_factor, wire):
    """The tensor a reduction sends: in the wire dtype when compressed
    (prescaled in fp32 first), else in the accumulation dtype (fp32 for
    16-bit inputs), prescaled there."""
    if wire is not None:
        return _scale_f32(tensor, prescale_factor).to(wire)
    acc = tensor.float() if tensor.dtype in _LOW_PRECISION else tensor
    return _scale(acc, prescale_factor)


def _from_acc(out, dtype, op, n, postscale_factor, compressed):
    """A reduction's result back in ``dtype``: averaging and postscale in
    fp32 (compressed) or the accumulation dtype."""
    if compressed:
        out = out.float()
    if op == ReduceOp.AVERAGE:
        out = out / n
    return _scale(out, postscale_factor).to(dtype)


def _check_op(op):
    """Ops an elementwise reduction takes (Adasum is not elementwise: only
    the all-reduces route it, to ``ops/adasum.py``)."""
    if op == ReduceOp.ADASUM:
        raise ValueError("Adasum is not elementwise: use allreduce, "
                         "grouped_allreduce or "
                         "grouped_hierarchical_allreduce")
    if op not in _DIST_OP:
        raise ValueError(f"unknown reduce op {op}")


def _apply_scale(tensor, factor):
    """Dtype-preserving scale for the per-tensor (Adasum) paths: fp32
    math for 16-bit tensors, rounded back once."""
    if factor == 1.0:
        return tensor
    if tensor.dtype in _LOW_PRECISION:
        return _scale_f32(tensor, factor).to(tensor.dtype)
    return _scale(tensor, factor)


def _grouped_per_tensor(tensors, group_fn, bucket_cap_bytes):
    """Per-tensor (non-elementwise) group reductions (Adasum) over the
    plan's buckets: ``group_fn`` on each bucket's tensors as a list; with
    no cap, one call over the whole list."""
    cap = resolve_bucket_cap(bucket_cap_bytes)
    if not tensors:
        return []
    if not cap:
        return group_fn(list(tensors))
    out = [None] * len(tensors)
    for bucket in plan_buckets_for(tensors, cap):
        idxs = list(bucket.indices)
        for i, r in zip(idxs, group_fn([tensors[i] for i in idxs])):
            out[i] = r
    return out


def _adasum_grouped(tensors, group_fn, prescale_factor, postscale_factor,
                    bucket_cap_bytes):
    pre = [_apply_scale(t, prescale_factor) for t in tensors]
    red = _grouped_per_tensor(pre, group_fn, bucket_cap_bytes)
    return [_apply_scale(t, postscale_factor) for t in red]


def _wire(tensor, compression):
    comp = resolve_compression(compression) if compression is not None \
        else None
    return comp.wire_dtype(tensor.dtype) if comp is not None else None


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
        return _from_acc(self._acc, self._dtype, self._op, self._n,
                         self._postscale, self._compressed)


def allreduce_async(tensor, op: int = ReduceOp.AVERAGE,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    compression=None, axis=None) -> PendingReduce:
    """Launch an all-reduce of ``tensor`` over ``axis`` (an ``AxisGroup``;
    default the world); the input is left unchanged. Adasum runs
    ``ops/adasum.adasum_allreduce`` to completion (the handle is done);
    as in the JAX package it takes no scale factors and no compression:
    its coefficients are per tensor, in fp32."""
    axis = axis or _world()
    if op == ReduceOp.ADASUM:
        from .adasum import adasum_allreduce

        return _Done(adasum_allreduce(tensor, axis))
    _check_op(op)
    wire = _wire(tensor, compression)
    acc = _to_acc(tensor, prescale_factor, wire)
    if acc is tensor:
        acc = tensor.clone()
    work = dist.all_reduce(acc, op=_DIST_OP[op], group=axis.group,
                           async_op=True)
    return PendingReduce(work, acc, tensor.dtype, op, postscale_factor,
                         wire is not None, axis.size)


def allreduce(tensor, op: int = ReduceOp.AVERAGE, prescale_factor: float = 1.0,
              postscale_factor: float = 1.0, compression=None, axis=None):
    """All-reduce ``tensor`` over ``axis`` (see ``allreduce_async``)."""
    return allreduce_async(tensor, op, prescale_factor, postscale_factor,
                           compression, axis).wait()


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


def _grouped(tensors, reduce_async, bucket_cap_bytes, compression):
    """Fuse ``tensors`` into the plan's buckets, launch ``reduce_async``
    on each bucket's flat buffer, then wait on each and split it back."""
    if not tensors:
        return []
    cap = resolve_bucket_cap(bucket_cap_bytes)
    comp = resolve_compression(compression) if compression is not None \
        else None
    flats = [t.reshape(-1) for t in tensors]
    shapes = [t.shape for t in tensors]
    pending = [(b.indices, reduce_async(fuse(flats, b.indices), comp))
               for b in plan_buckets_for(flats, cap, comp)]
    out: List[torch.Tensor] = [None] * len(tensors)
    for indices, handle in pending:
        for i, t in unfuse(handle.wait(), shapes, indices):
            out[i] = t
    return out


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      op: int = ReduceOp.AVERAGE, prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0, bucket_cap_bytes=None,
                      compression=None, axis=None) -> List[torch.Tensor]:
    """All-reduce a list of tensors over ``axis`` as fused buckets.

    ``bucket_cap_bytes`` unset: one bucket per dtype. An int (or
    ``"auto"`` following ``HOROVOD_FUSION_THRESHOLD``): size-capped
    dtype-pure buckets in reverse parameter order
    (``common/fusion.plan_buckets``). Every bucket is launched before the
    first is waited on. ``compression`` makes each bucket reduce in the
    compressed wire dtype and the plan budget that width.

    Adasum (``ops/adasum.grouped_adasum_allreduce``) runs on each
    bucket's tensors as a list, every tensor with its own coefficients;
    the scale factors apply per tensor before and after, compression not
    at all.
    """
    if op == ReduceOp.ADASUM:
        from .adasum import grouped_adasum_allreduce

        return _adasum_grouped(
            tensors, lambda chunk: grouped_adasum_allreduce(chunk, axis),
            prescale_factor, postscale_factor, bucket_cap_bytes)
    return _grouped(
        tensors, lambda flat, comp: allreduce_async(
            flat, op, prescale_factor, postscale_factor, comp, axis),
        bucket_cap_bytes, compression)


class _Done:
    """A finished reduction in the shape of ``PendingReduce``."""

    def __init__(self, value):
        self._value = value

    def wait(self):
        return self._value


def hierarchical_allreduce(tensor, op: int = ReduceOp.AVERAGE,
                           prescale_factor: float = 1.0,
                           postscale_factor: float = 1.0, compression=None,
                           hosts=None):
    """All-reduce over the world in three legs: reduce-scatter on the
    local group, all-reduce of the shards on the cross group, all-gather
    on the local group (``ops/xla.hierarchical_allreduce``, the reference's
    ``NCCLHierarchicalAllreduce``). The flat tensor is padded with zeros
    to a multiple of the local size. Every leg travels at the
    accumulation dtype (fp32 for 16-bit inputs) or, with
    ``compression``, in the wire dtype; averaging and postscale run on
    the result as in ``allreduce``. Sum and Average only. ``hosts``: the
    (local, cross) pair of ``AxisGroup``s to run on (default the
    world's)."""
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        _check_op(op)
        raise ValueError(f"hierarchical allreduce supports Sum and Average, "
                         f"got op {op}")
    local, cross = hosts or host_groups()
    wire = _wire(tensor, compression)
    acc = _to_acc(tensor, prescale_factor, wire)
    flat = acc.reshape(-1)
    n = flat.numel()
    pad = (-n) % local.size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shard = _reduce_scatter(flat, dist.ReduceOp.SUM, local)
    dist.all_reduce(shard, group=cross.group)
    full = allgather_along(shard, 0, local)[:n].view(acc.shape)
    return _from_acc(full, tensor.dtype, op, local.size * cross.size,
                     postscale_factor, wire is not None)


def grouped_hierarchical_allreduce(tensors: Sequence[torch.Tensor],
                                   op: int = ReduceOp.AVERAGE,
                                   prescale_factor: float = 1.0,
                                   postscale_factor: float = 1.0,
                                   bucket_cap_bytes=None, compression=None,
                                   hosts=None) -> List[torch.Tensor]:
    """``hierarchical_allreduce`` of a list of tensors, fused into the
    buckets ``grouped_allreduce`` plans; each bucket runs all three legs
    before the next starts. Adasum: a plain sum within the local group,
    Adasum across the cross group, per tensor
    (``ops/adasum.grouped_hierarchical_adasum_allreduce``). ``hosts`` as
    in ``hierarchical_allreduce``."""
    if op == ReduceOp.ADASUM:
        from .adasum import grouped_hierarchical_adasum_allreduce

        return _adasum_grouped(
            tensors,
            lambda chunk: grouped_hierarchical_adasum_allreduce(chunk, hosts),
            prescale_factor, postscale_factor, bucket_cap_bytes)
    return _grouped(
        tensors, lambda flat, comp: _Done(hierarchical_allreduce(
            flat, op, prescale_factor, postscale_factor, comp, hosts)),
        bucket_cap_bytes, compression)


def allgather(tensor, axis=None) -> torch.Tensor:
    """Every rank's ``tensor`` (same shapes) joined along dim 0 in rank
    order over ``axis`` (default the world)."""
    return allgather_along(tensor, 0, axis or _world())


def hierarchical_allgather(tensor, hosts=None) -> torch.Tensor:
    """``allgather`` over the world in two legs: on the local group, then
    the local blocks on the cross group. The cross-major layout (``rank =
    cross * local_size + local``) makes that the world's rank order.
    ``hosts`` as in ``hierarchical_allreduce``."""
    local, cross = hosts or host_groups()
    return allgather_along(allgather_along(tensor, 0, local), 0, cross)


def host_groups():
    """The world's (local, cross) ``AxisGroup``s."""
    return _state.axis_group("local"), _state.axis_group("cross")


def _reduce_scatter(acc, dist_op, axis):
    """``acc`` reduced over ``axis`` with this rank's block of dim 0 kept
    (dim 0 split into ``axis.size`` equal blocks)."""
    chunks = list(acc.contiguous().chunk(axis.size))
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, op=dist_op, group=axis.group)
    return out


def reducescatter(tensor, op: int = ReduceOp.SUM, axis=None,
                  prescale_factor: float = 1.0,
                  postscale_factor: float = 1.0) -> torch.Tensor:
    """Reduce ``tensor`` over ``axis`` (default the world) and keep this
    rank's block of dim 0 (dim 0 splits into ``axis.size`` equal blocks).
    16-bit inputs accumulate at fp32, as in ``allreduce``."""
    _check_op(op)
    axis = axis or _world()
    if tensor.shape[0] % axis.size:
        raise ValueError(f"reducescatter: dim 0 of {list(tensor.shape)} "
                         f"does not split {axis.size} ways")
    out = _reduce_scatter(_to_acc(tensor, prescale_factor, None),
                          _DIST_OP[op], axis)
    return _from_acc(out, tensor.dtype, op, axis.size, postscale_factor,
                     False)


# The one-tensor collectives under their current names (torch 2.13 renamed
# the ``*_into_tensor`` / ``*_tensor`` forms).
_all_gather_single = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)
_reduce_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)


def zero_reducescatter(flat, axis, wire_dtype=None) -> torch.Tensor:
    """The gradient-partitioning leg: reduce-scatter one padded fp32
    bucket flat over ``axis`` (its length a multiple of the axis size),
    each rank keeping its 1/d block of the sum. With ``wire_dtype``
    (fp16/bf16 compression) the payload travels, and is summed, at the
    16-bit dtype, and the reduced block comes back as fp32 before any
    averaging. Callers average (``/ d``) outside, at fp32."""
    payload = flat.to(wire_dtype) if wire_dtype is not None else flat
    out = payload.new_empty(payload.numel() // axis.size)
    _reduce_scatter_single(out, payload.contiguous(), group=axis.group)
    return out.float() if wire_dtype is not None else out


class PendingGather:
    """An all-gather in flight; ``wait()`` returns the gathered tensor.
    It holds the tensor being sent until then."""

    def __init__(self, work, sent, out):
        self._work, self._sent, self.out = work, sent, out

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = self._sent = None
        return self.out


def zero_allgather(seg, axis, gather_dtype=None) -> PendingGather:
    """The parameter-assembly leg: launch the all-gather of one 1/d
    master segment into the full padded bucket flat over ``axis``, at
    ``gather_dtype`` (uniform-dtype models gather at the model's dtype).
    ``wait()`` on the handle orders the caller's stream after the gather
    (NCCL runs it on its own stream) and returns the flat."""
    sent = (seg.detach().to(gather_dtype) if gather_dtype is not None
            else seg.detach()).contiguous()
    out = sent.new_empty(sent.numel() * axis.size)
    work = _all_gather_single(out, sent, group=axis.group, async_op=True)
    return PendingGather(work, sent, out)


def alltoall(tensor, axis=None) -> torch.Tensor:
    """Exchange equal blocks of dim 0 over ``axis`` (default the world):
    block i goes to rank i, and the blocks received are joined in rank
    order."""
    return all_to_all(tensor, 0, 0, axis or _world())


def barrier(axis=None) -> torch.Tensor:
    """Wait for every rank of ``axis`` (default the world); returns the
    number of ranks that arrived, as the JAX package's psum of ones."""
    axis = axis or _world()
    ones = torch.ones((), dtype=torch.int32, device=_state.device())
    dist.all_reduce(ones, group=axis.group)
    return ones


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


def ring_exchange(tensors: Sequence[torch.Tensor], axis, tag: int = 0,
                  shift: int = 1) -> PendingExchange:
    """Send each tensor to the next rank of the ring ``axis`` (an
    ``AxisGroup``: index i sends to i + shift and receives from i - shift,
    modulo the axis size) and receive the previous rank's tensors of the
    same shapes and dtypes: the port's ``lax.ppermute(x, axis, fwd_perm)``.
    One ``batch_isend_irecv``; the caller computes while it is in flight.
    Tensor i travels under tag ``tag + i``."""
    nxt = axis.global_rank(axis.rank + shift)
    prv = axis.global_rank(axis.rank - shift)
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


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, *side):
        ctx.axis, ctx.n_side = axis, len(side)
        received = ring_exchange([x, *side], axis).wait()
        ctx.mark_non_differentiable(*received[1:])
        return tuple(received)

    @staticmethod
    def backward(ctx, g, *_):
        (gx,) = ring_exchange([g], ctx.axis, shift=-1).wait()
        return (gx, None) + (None,) * ctx.n_side


def ring_shift(x: torch.Tensor, axis, *side: torch.Tensor):
    """One hop of the ring ``axis``: send ``x`` (and the ``side`` tensors,
    say segment ids, which carry no gradient) to the next rank and return
    the previous rank's, as ``(x, *side)``. Differentiable in ``x``: the
    backward sends the gradient one hop back (``lax.ppermute``'s
    transpose)."""
    return _RingShift.apply(x, axis, *side)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return allreduce(g, op=ReduceOp.SUM, axis=ctx.axis), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return allreduce(x, op=ReduceOp.SUM, axis=axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, axis) -> torch.Tensor:
    """Megatron's entry into a tensor-parallel region: the identity
    forward, and a sum over the tp group ``axis`` backward (each tp rank
    holds the gradient of its shard's product only)."""
    if axis is None or axis.size == 1:
        return x
    return _CopyToGroup.apply(x, axis)


def reduce_from_tp(x: torch.Tensor, axis) -> torch.Tensor:
    """Megatron's exit from a tensor-parallel region: the sum of the tp
    ranks' partial outputs forward (``lax.psum(x, "tp")``), the identity
    backward (every tp rank holds the same gradient of the sum)."""
    if axis is None or axis.size == 1:
        return x
    return _ReduceFromGroup.apply(x, axis)


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return allreduce(x, op=ReduceOp.AVERAGE, axis=axis)

    @staticmethod
    def backward(ctx, g):
        return allreduce(g, op=ReduceOp.AVERAGE, axis=ctx.axis), None


def mean_over(x: torch.Tensor, axis) -> torch.Tensor:
    """``lax.pmean(x, axis)``: the mean over the group, differentiable
    (its backward is the mean of the ranks' gradients)."""
    if axis is None or axis.size == 1:
        return x
    return _MeanOver.apply(x, axis)


@torch.no_grad()
def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Overwrite, in place, every tensor of ``params`` (a ``state_dict``
    or an iterable of ``(name, tensor)``) with root's values."""
    items = params.items() if isinstance(params, dict) else params
    for _, p in sorted(items, key=lambda kv: kv[0]):
        dist.broadcast(p.data if isinstance(p, torch.nn.Parameter) else p,
                       src=root_rank)
