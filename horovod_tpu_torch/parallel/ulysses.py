"""All-to-all sequence parallelism (Ulysses), and the strategy dispatch.

Counterpart of ``horovod_tpu/parallel/ulysses.py``. Where ring attention
keeps the sequence sharded and moves K/V around the ring, this strategy
re-shards once: an all-to-all swaps the sequence sharding for a head
sharding, every rank runs flash attention over the FULL sequence for its
H/sp heads, and a second all-to-all swaps back. It moves each Q/K/V
element once but needs ``heads % sp == 0``; the ring has no head
constraint and keeps a T_local working set.

Autograd: ``ops/collectives.all_to_all`` is differentiable (its backward
is the reverse exchange), so the backward is the mirrored pair of
all-to-alls around the flash backward kernels.
"""

from __future__ import annotations

import torch

from ..ops.collectives import all_to_all, allgather_along
from ..ops.flash_attention import flash_attention
from .ring_attention import (_axis_size, expand_kv, local_attention,
                             ring_attention)

STRATEGIES = ("ring", "ulysses", "auto")


def gather_segment_ids(segment_ids, axis):
    """All-gather sequence-sharded segment ids to int32 ``[B, T_global]``.
    Loop-invariant across decoder layers: the model gathers once per
    forward and passes ``gathered_segment_ids`` to every layer."""
    return allgather_along(segment_ids.to(torch.int32), 1, axis)


def ulysses_attention(q, k, v, axis=None, causal: bool = True,
                      segment_ids=None, gathered_segment_ids=None,
                      window=None):
    """Context-parallel attention via head<->sequence all-to-all.

    q/k/v: ``[B, T_local, H(kv), D]`` on each rank of the sp group
    ``axis``, sequence-sharded. Returns ``[B, T_local, H, D]`` with the
    same sharding. Requires both head counts divisible by the axis size.
    ``segment_ids`` (int ``[B, T_local]``): packed sequences, all-gathered
    along T (or pass ``gathered_segment_ids`` ``[B, T_global]``).
    """
    sp = _axis_size(axis)
    heads = q.shape[2]
    g = heads // k.shape[2]
    if sp == 1:
        return local_attention(q, k, v, causal, segment_ids, window)
    if heads % sp != 0 or k.shape[2] % sp != 0:
        raise ValueError(
            f"ulysses_attention needs heads divisible by the sp axis: "
            f"{heads} query / {k.shape[2]} KV heads across {sp} ranks. "
            f"Use ring_attention when heads don't divide.")

    def seq_to_heads(x):  # [B, T_local, H, D] -> [B, T_global, H/sp, D]
        return all_to_all(x, 2, 1, axis)

    full_seg = gathered_segment_ids
    if full_seg is None and segment_ids is not None:
        full_seg = gather_segment_ids(segment_ids, axis)
    # GQA K/V cross at their reduced width; the contiguous head split
    # means rank i's query heads use exactly rank i's KV heads.
    kf, vf = expand_kv(seq_to_heads(k), seq_to_heads(v), g)
    o = flash_attention(seq_to_heads(q), kf, vf, causal=causal,
                        q_segment_ids=full_seg, k_segment_ids=full_seg,
                        window=window)
    return all_to_all(o, 1, 2, axis)  # back to [B, T_local, H, D]


def resolve_strategy(strategy: str, heads: int, kv_heads: int,
                     sp: int) -> str:
    """"ring" or "ulysses": ``"auto"`` takes ulysses when both head
    counts divide the axis, else ring."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown sequence-parallel strategy {strategy!r}; "
                         "expected 'ring', 'ulysses', or 'auto'")
    if strategy == "auto":
        return ("ulysses" if heads % sp == 0 and kv_heads % sp == 0
                else "ring")
    return strategy


def context_parallel_attention(q, k, v, axis=None, causal: bool = True,
                               strategy: str = "ring", segment_ids=None,
                               gathered_segment_ids=None, window=None):
    """Dispatch between the two sequence-parallel strategies:
    ``"ring"`` (default; no head constraint, T_local working set),
    ``"ulysses"`` (all-to-all re-shard, heads % sp == 0) or ``"auto"``.
    ``gathered_segment_ids`` serves ulysses only; the ring's masking is
    block-local."""
    strategy = resolve_strategy(strategy, q.shape[2], k.shape[2],
                                _axis_size(axis))
    if strategy == "ulysses":
        return ulysses_attention(q, k, v, axis, causal=causal,
                                 segment_ids=segment_ids,
                                 gathered_segment_ids=gathered_segment_ids,
                                 window=window)
    return ring_attention(q, k, v, axis, causal=causal,
                          segment_ids=segment_ids, window=window)
