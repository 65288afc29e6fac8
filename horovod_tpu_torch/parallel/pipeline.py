"""Pipeline parallelism: the GPipe schedule over the pp group.

Counterpart of ``horovod_tpu/parallel/pipeline.py`` (``spmd_pipeline``).
Each rank of the pp group holds one stage's layers. The schedule runs
``M + S - 1`` ticks: at tick t stage 0 takes in microbatch t, every stage
that holds a microbatch (t - stage in [0, M)) applies itself to it, the
last stage collects microbatch t - (S - 1), and every activation moves one
hop around the ring (``ops/collectives.ring_shift``). At the end the last
stage's outputs are broadcast to every member of the group.

The reference lets autodiff derive the backward pipeline from
``lax.ppermute``; here autograd does, from ``ring_shift``, whose backward
sends the gradient one hop back. Eager autograd adds two duties:

- a stage that holds no microbatch skips its layers but still takes part
  in every hop, forward and backward: the activation passes through
  unchanged, so every rank issues the same hops in the same order;
- every hop must be on every rank's autograd graph, since its backward is
  a collective. The carried activation therefore requires grad from the
  first tick, stage 0 takes in microbatches by ``torch.where`` (which
  keeps the received tensor on the graph, with a zero gradient), and the
  closing broadcast takes the last carried activation as an input whose
  gradient is zero. The broadcast's backward gives the last stage the
  gradient of its own copy of the outputs: every member computes the same
  loss from them, and one copy's gradient is the gradient of that loss.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..ops.collectives import ring_shift


class _BroadcastFromLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, carried, axis):
        ctx.last = axis.rank == axis.size - 1
        ctx.carried = (carried.shape, carried.dtype, carried.device)
        buf = out.clone() if ctx.last else torch.empty_like(out)
        dist.broadcast(buf, src=axis.global_rank(axis.size - 1),
                       group=axis.group)
        return buf

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.carried
        return (g if ctx.last else None,
                torch.zeros(shape, dtype=dtype, device=device), None)


def spmd_pipeline(stage_fn: Callable, microbatches, axis=None,
                  collect_fn: Optional[Callable] = None):
    """Run ``microbatches`` through the pipeline on the pp group ``axis``.

    ``stage_fn(x) -> y``: this rank's stage (same structure in and out).
    ``microbatches``: an ``[M, ...]`` tensor, or a tuple whose first entry
    is the activation and the rest side data (say segment ids) that rides
    the ring with it and carries no gradient. Only stage 0 reads their
    values; every stage needs their shapes. ``collect_fn(y)`` selects the
    output from a stage's result (default: all of it; with side data,
    the tensor ``collect_fn`` returns).

    Returns the last stage's ``[M, ...]`` outputs on every member.
    """
    packed = isinstance(microbatches, tuple)
    leaves = microbatches if packed else (microbatches,)
    collect_fn = collect_fn or (lambda y: y)
    M = leaves[0].shape[0]
    S = 1 if axis is None else axis.size
    stage = 0 if axis is None else axis.rank
    if S == 1:
        return torch.stack([collect_fn(stage_fn(
            tuple(m[i] for m in leaves) if packed else leaves[0][i]))
            for i in range(M)])

    state = [torch.zeros_like(m[0]) for m in leaves]
    if torch.is_grad_enabled():
        state[0].requires_grad_()
    outs = []
    for t in range(M + S - 1):
        if stage == 0 and t < M:
            state[0] = torch.where(torch.ones((), dtype=torch.bool,
                                              device=state[0].device),
                                   leaves[0][t], state[0])
            state[1:] = [m[t] for m in leaves[1:]]
        if 0 <= t - stage < M:
            y = stage_fn(tuple(state) if packed else state[0])
            state = list(y) if packed else [y]
            if stage == S - 1:
                outs.append(collect_fn(y))
        if t < M + S - 2:
            state = list(ring_shift(state[0], axis, *state[1:]))
    out = (torch.stack(outs) if outs else
           torch.empty((M, *state[0].shape), dtype=state[0].dtype,
                       device=state[0].device))
    return _BroadcastFromLast.apply(out, state[0], axis)
