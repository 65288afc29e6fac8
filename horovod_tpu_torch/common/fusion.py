"""Bucketed fusion planner — the port's copy of ``horovod_tpu/common/
fusion.py``.

A pure function over (byte size, dtype) specs that returns size-capped,
dtype-pure buckets in reverse parameter order, the approximation of the
order backward produces gradients. The port's ``DistributedOptimizer``
launches each bucket's all-reduce as soon as the bucket's last gradient
lands, so communication overlaps the rest of backward. The plans are
identical to the JAX package's for the same shapes, dtypes and
environment; only ``leaf_nbytes`` reads torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "Bucket",
    "plan_buckets",
    "plan_buckets_for",
    "forward_bucket_order",
    "leaf_nbytes",
    "leaf_wire_nbytes",
    "resolve_bucket_cap",
    "resolve_prefetch_depth",
    "describe_plan",
]


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One fusion bucket: the leaf indices it covers (in emission order),
    their common dtype, and its payload size in bytes."""

    indices: Tuple[int, ...]
    dtype: Any
    nbytes: int


def leaf_nbytes(leaf: torch.Tensor) -> int:
    """Byte size of a tensor."""
    return leaf.numel() * leaf.element_size()


# Low-precision floats are accumulated — and so travel the wire — at fp32
# (ops/collectives.py allreduce).
_FP32_WIRE_DTYPES = (torch.bfloat16, torch.float16)


def leaf_wire_nbytes(leaf: torch.Tensor, compression=None) -> int:
    """Bytes the leaf occupies in the fused collective: the compressed
    wire dtype's width when ``compression`` applies to it, else fp32
    width for bf16/fp16 (the accumulation dtype), else its own width."""
    if compression is not None:
        w = compression.wire_dtype(leaf.dtype)
        if w is not None:
            return leaf.numel() * w.itemsize
    item = 4 if leaf.dtype in _FP32_WIRE_DTYPES else leaf.element_size()
    return leaf.numel() * item


def _dtype_key(dtype: Any) -> str:
    """A dtype's name without its framework prefix ("float32" for both
    ``torch.float32`` and numpy's float32)."""
    return str(dtype).replace("torch.", "")


def plan_buckets(
    sizes_bytes: Sequence[int],
    dtypes: Sequence[Any],
    bucket_cap_bytes: Optional[int] = None,
) -> List[Bucket]:
    """Partition leaves ``0..n-1`` into fusion buckets.

    With ``bucket_cap_bytes`` unset (None or <= 0): one bucket per dtype,
    dtypes in first-seen order, indices ascending.

    With a cap, leaves are walked in REVERSE index order. A bucket closes
    when the next leaf would push it past the cap or has a different
    dtype (buckets stay dtype-pure and contiguous in production order). A
    single leaf larger than the cap gets a bucket of its own.
    """
    n = len(sizes_bytes)
    if n != len(dtypes):
        raise ValueError(f"sizes/dtypes length mismatch: {n} vs {len(dtypes)}")
    if n == 0:
        return []

    if not bucket_cap_bytes or bucket_cap_bytes <= 0:
        by_dtype: dict = {}
        for i in range(n):
            key = _dtype_key(dtypes[i])
            by_dtype.setdefault(key, ([], dtypes[i]))[0].append(i)
        return [
            Bucket(tuple(idxs), dt, sum(sizes_bytes[i] for i in idxs))
            for idxs, dt in by_dtype.values()
        ]

    cap = int(bucket_cap_bytes)
    buckets: List[Bucket] = []
    cur: List[int] = []
    cur_bytes = 0
    cur_dtype: Any = None

    def close():
        nonlocal cur, cur_bytes, cur_dtype
        if cur:
            buckets.append(Bucket(tuple(cur), cur_dtype, cur_bytes))
        cur, cur_bytes, cur_dtype = [], 0, None

    for i in range(n - 1, -1, -1):
        nb = int(sizes_bytes[i])
        if cur and (_dtype_key(dtypes[i]) != _dtype_key(cur_dtype)
                    or cur_bytes + nb > cap):
            close()
        cur.append(i)
        cur_bytes += nb
        cur_dtype = dtypes[i]
        if cur_bytes >= cap:
            close()
    close()
    return buckets


def plan_buckets_for(leaves: Sequence[torch.Tensor],
                     bucket_cap_bytes: Optional[int] = None,
                     compression=None) -> List[Bucket]:
    """Plan directly from tensors, budgeting each at its wire width."""
    return plan_buckets([leaf_wire_nbytes(t, compression) for t in leaves],
                        [t.dtype for t in leaves], bucket_cap_bytes)


def forward_bucket_order(buckets: Sequence[Bucket]) -> Tuple[int, ...]:
    """Bucket indices ordered by their smallest leaf index: the order the
    forward pass consumes parameters."""
    return tuple(sorted(range(len(buckets)),
                        key=lambda j: min(buckets[j].indices)
                        if buckets[j].indices else 0))


def resolve_bucket_cap(bucket_cap_bytes) -> Optional[int]:
    """Resolve a user-facing cap knob to an int or None (monolithic).

    - ``"auto"``: ``HOROVOD_FUSION_THRESHOLD`` when it was set — the
      config ``init()`` froze, else the raw env — otherwise None.
    - ``None`` / ``0``: monolithic (no bucketing).
    - int > 0: that many bytes.
    """
    if bucket_cap_bytes is None:
        return None
    if isinstance(bucket_cap_bytes, str):
        if bucket_cap_bytes != "auto":
            raise ValueError(
                f"bucket_cap_bytes must be an int, None, or 'auto'; "
                f"got {bucket_cap_bytes!r}")
        from . import config as _config
        from .state import global_state

        st = global_state()
        if (st.initialized and st.config is not None
                and st.config.fusion_threshold_explicit):
            v = int(st.config.fusion_threshold_bytes)
            return v if v > 0 else None
        v, explicit = _config._get_int_explicit(
            _config.HOROVOD_FUSION_THRESHOLD, 0)
        return v if explicit and v > 0 else None
    cap = int(bucket_cap_bytes)
    return cap if cap > 0 else None


def resolve_prefetch_depth(depth="auto") -> int:
    """The stage-3 gather prefetch depth as an int in [0, 8]: ``"auto"``
    follows ``HOROVOD_ZERO_PREFETCH`` (default 1: one bucket gathered
    ahead), an int is taken as given. Depth changes when gathers are
    issued, never the numbers."""
    if not isinstance(depth, str):
        return max(0, min(8, int(depth)))
    if depth != "auto":
        raise ValueError(
            f"prefetch depth must be an int or 'auto'; got {depth!r}")
    from . import config as _config

    v, _ = _config.zero_prefetch_env()
    return v


def describe_plan(buckets: Sequence[Bucket]) -> dict:
    """JSON-friendly summary of a plan."""
    return {
        "num_buckets": len(buckets),
        "bucket_bytes": [b.nbytes for b in buckets],
        "bucket_dtypes": [_dtype_key(b.dtype) for b in buckets],
        "bucket_sizes": [len(b.indices) for b in buckets],
    }
