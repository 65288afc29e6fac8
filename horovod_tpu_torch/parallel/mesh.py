"""Parallelism axes over the world: dp / pp / sp / tp sizes and groups.

Counterpart of ``horovod_tpu/parallel/mesh.py``. The JAX package lays its
devices out as a ``jax.sharding.Mesh`` of shape ``(dp, pp, sp, tp)``; the
port has one process per GPU, so the same layout is a grid of global
ranks, ``arange(world).reshape(dp, pp, sp, tp)`` (the JAX mesh's device
order), and each axis becomes ``torch.distributed`` groups along it. sp
groups are therefore runs of consecutive ranks (tp = pp = 1), and dp groups
stride across them.

``build_groups`` makes a group for each entry of ``GROUPS`` (the four
axes, ``data`` = dp x sp and ``stages`` = dp x pp x sp) and the ``local``
and ``cross`` groups of the hosts. A parameter names the group its
gradient is reduced over in its ``REDUCE_ATTR`` attribute (read by
``reduce_group``; the model sets it, the optimizer reads it).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
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


# The groups ``build_groups`` makes, each named by the mesh axes it spans.
GROUPS = {"dp": ("dp",), "pp": ("pp",), "sp": ("sp",), "tp": ("tp",),
          "data": ("dp", "sp"), "stages": ("dp", "pp", "sp")}
# The parameter attribute that names the group its gradient is reduced
# over (a name of ``GROUPS``); unset means "data".
REDUCE_ATTR = "hvd_reduce"
# A parameter that holds one slice of a leaf split over an axis (a tp
# shard of a layer, an ep rank's experts) names that axis here; what
# snapshots a model whole (``elastic.TensorState``) refuses such a leaf.
SHARD_ATTR = "hvd_sharded"


def reduce_group(p: torch.Tensor) -> str:
    """The group name ``p``'s gradient is reduced over."""
    return getattr(p, REDUCE_ATTR, "data")


def axis_ranks(sizes: Dict[str, int], axis):
    """Every group of ``axis`` (one axis name, or a tuple of them) as a
    tuple of global ranks, in a fixed order: the rank grid ``reshape(dp,
    pp, sp, tp)`` read along those axes, the first axis slowest."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    grid = np.arange(int(np.prod([sizes[a] for a in AXES]))).reshape(
        [sizes[a] for a in AXES])
    idx = [AXES.index(a) for a in axes]
    n = int(np.prod([sizes[a] for a in axes]))
    lines = np.moveaxis(grid, idx, list(range(-len(idx), 0))).reshape(-1, n)
    return [tuple(int(r) for r in line) for line in lines]


def host_ranks(world_size: int, local_size: int):
    """The (local, cross) groups of the cross-major layout ``rank = cross
    * local_size + local``, as lists of rank tuples; None when
    ``local_size`` does not divide the world (an inhomogeneous layout,
    which the reference's hierarchical mesh refuses too)."""
    if local_size < 1 or world_size % local_size:
        return None
    grid = np.arange(world_size).reshape(-1, local_size)
    return ([tuple(int(r) for r in row) for row in grid],
            [tuple(int(r) for r in col) for col in grid.T])


def build_groups(world_size: int, rank: int, sp: int = 1, tp: int = 1,
                 pp: int = 1, local_size: Optional[int] = None
                 ) -> Tuple[Dict[str, int], Dict[str, AxisGroup]]:
    """Axis sizes (dp = world / (sp * tp * pp)) and this rank's group of
    each entry of ``GROUPS``, plus ``local`` and ``cross`` when
    ``local_size`` divides the world (None: one host; 0: no host groups,
    for a world whose hosts hold different numbers of ranks). Collective: every rank of the world
    calls it, and creates every group in the same order, members or not."""
    sizes = factor_devices(world_size, tp=tp, pp=pp, sp=sp)
    sizes = {a: sizes[a] for a in AXES}   # the JAX mesh's axis order
    lines = {name: axis_ranks(sizes, axes) for name, axes in GROUPS.items()}
    hosts = host_ranks(world_size,
                       world_size if local_size is None else local_size)
    if hosts is not None:
        lines["local"], lines["cross"] = hosts
    groups = {}
    for name, name_lines in lines.items():
        for ranks in name_lines:
            group = (None if len(ranks) == world_size
                     else dist.new_group(list(ranks)))
            if rank in ranks:
                groups[name] = AxisGroup(group, ranks, ranks.index(rank))
    return sizes, groups
