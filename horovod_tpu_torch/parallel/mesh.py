"""Parallelism axes over the world: dp / pp / sp / tp sizes and groups.

Counterpart of ``horovod_tpu/parallel/mesh.py``. The JAX package lays its
devices out as a ``jax.sharding.Mesh`` of shape ``(dp, pp, sp, tp)``; the
port has one process per GPU, so the same layout is a grid of global
ranks, ``arange(world).reshape(dp, pp, sp, tp)`` (the JAX mesh's device
order), and each axis becomes ``torch.distributed`` groups along it. sp
groups are therefore runs of consecutive ranks (tp = pp = 1), and dp groups
stride across them.

This slice builds the dp and sp groups; tp and pp raise in the model.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch.distributed as dist

AXES = ("dp", "pp", "sp", "tp")


def factor_devices(n: int, tp: Optional[int] = None, pp: Optional[int] = None,
                   sp: Optional[int] = None,
                   dp: Optional[int] = None) -> Dict[str, int]:
    """Choose axis sizes multiplying to ``n``.

    Unspecified axes are filled greedily with powers of two, preferring
    tp, then pp, then sp, and giving the remainder to dp — tiny-mesh
    defaults for dry runs; real jobs pass sizes explicitly.
    """
    fixed = {"tp": tp, "pp": pp, "sp": sp, "dp": dp}
    remaining = n
    for name, v in fixed.items():
        if v is not None:
            if remaining % v != 0:
                raise ValueError(f"{name}={v} does not divide {remaining}")
            remaining //= v
    for name in ("tp", "pp", "sp"):
        if fixed[name] is None:
            fixed[name] = 2 if remaining % 2 == 0 and remaining > 1 else 1
            remaining //= fixed[name]
    if fixed["dp"] is None:
        fixed["dp"] = remaining
        remaining = 1
    if remaining != 1:
        raise ValueError(
            f"axis sizes {fixed} do not use all {n} devices")
    return fixed


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The group of one axis that this rank belongs to.

    ``group`` is the ``torch.distributed`` group (None for the default
    group when the axis spans the whole world), ``ranks`` its members'
    global ranks in axis order, ``rank`` this process's index among them.
    """

    group: Optional[dist.ProcessGroup]
    ranks: Tuple[int, ...]
    rank: int

    @property
    def size(self) -> int:
        return len(self.ranks)

    def global_rank(self, i: int) -> int:
        """The global rank of axis index ``i`` (taken modulo the size)."""
        return self.ranks[i % self.size]


def axis_ranks(sizes: Dict[str, int], axis: str):
    """Every group of ``axis`` as a tuple of global ranks, in a fixed
    order: the rank grid ``reshape(dp, pp, sp, tp)`` read along ``axis``."""
    grid = np.arange(int(np.prod([sizes[a] for a in AXES]))).reshape(
        [sizes[a] for a in AXES])
    lines = np.moveaxis(grid, AXES.index(axis), -1).reshape(-1, sizes[axis])
    return [tuple(int(r) for r in line) for line in lines]


def build_groups(world_size: int, rank: int, sp: int = 1
                 ) -> Tuple[Dict[str, int], Dict[str, AxisGroup]]:
    """Axis sizes (tp = pp = 1, dp = world / sp) and this rank's dp and
    sp groups. Collective: every rank of the world calls it, and creates
    every group in the same order, members or not."""
    sizes = factor_devices(world_size, tp=1, pp=1, sp=sp)
    sizes = {a: sizes[a] for a in AXES}   # the JAX mesh's axis order
    groups = {}
    for axis in ("dp", "sp"):
        for ranks in axis_ranks(sizes, axis):
            group = (None if len(ranks) == world_size
                     else dist.new_group(list(ranks)))
            if rank in ranks:
                groups[axis] = AxisGroup(group, ranks, ranks.index(rank))
    return sizes, groups
