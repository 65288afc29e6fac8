"""Adasum: scaling-insensitive gradient combination over torch.distributed.

Counterpart of ``horovod_tpu/ops/adasum.py``. At each level of the
recursion partners a, b (rank r and r ^ level) combine as::

    a' = (1 - a.b / (2*||a||^2)) * a + (1 - a.b / (2*||b||^2)) * b

with the dot product and the norms in fp32; after log2(n) levels every
rank holds the same result. As in the JAX package, each level exchanges
full vectors (one ``batch_isend_irecv`` with the partner) rather than
halving them: the halving of the reference's VHDD saves point-to-point
bandwidth, which NCCL's links make a second-order cost here. The
combination is symmetric in (a, b) and every scalar is reduced in the same
order on both partners, so the ranks agree bitwise.

- ``adasum_allreduce``: one tensor over an axis (power-of-two size).
- ``grouped_adasum_allreduce``: a list fused into one flat, with the
  coefficients per tensor (segment sums), one exchange per level.
- ``hierarchical_adasum_allreduce`` and its grouped form: a plain sum
  within the local group (reduce-scatter), Adasum across the cross group
  with the scalars summed over the local group (each local rank holds a
  block of the vectors), then a local all-gather — the reference's
  NCCL-mode semantics, not equal to the flat form.

``adasum_reference`` and ``hierarchical_adasum_reference`` are the NumPy
oracles (the port's own copies), the plain versions the tests and
``chip_smoke.py`` hold these against.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..common import state as _state

_EPS = 1e-30


def _is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _check(n: int, what: str = "Adasum") -> None:
    if not _is_power_of_two(n):
        raise ValueError(f"{what} requires a power-of-two participant "
                         f"count, got {n}")


def _coefficients(dot, na, nb):
    """(ca, cb); a (near-)zero vector takes the plain sum's 1."""
    ca = torch.where(na <= _EPS, torch.ones_like(na),
                     1.0 - dot / (2.0 * torch.clamp(na, min=_EPS)))
    cb = torch.where(nb <= _EPS, torch.ones_like(nb),
                     1.0 - dot / (2.0 * torch.clamp(nb, min=_EPS)))
    return ca, cb


def _partner(a: torch.Tensor, axis, level: int) -> torch.Tensor:
    """The vector of axis rank ``axis.rank ^ level``, for ours."""
    peer = axis.global_rank(axis.rank ^ level)
    b = torch.empty_like(a)
    ops = [dist.P2POp(dist.isend, a, peer, axis.group),
           dist.P2POp(dist.irecv, b, peer, axis.group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return b


def _axis(axis):
    if axis is not None:
        return axis
    from .collectives import _world

    return _world()


def _segment_sums(x, lengths):
    """Per-segment sums of ``x`` (segments of ``lengths``, in order)."""
    return torch.segment_reduce(x, "sum", lengths=lengths)


def _fused_level(a, b, lengths, local=None):
    """One level on a fused flat with per-tensor coefficients; ``local``:
    the group the scalars are summed over (hierarchical)."""
    scalars = torch.stack([_segment_sums(a * b, lengths),
                           _segment_sums(a * a, lengths),
                           _segment_sums(b * b, lengths)])
    if local is not None and local.size > 1:
        dist.all_reduce(scalars, group=local.group)
    ca, cb = _coefficients(*scalars)
    return (torch.repeat_interleave(ca, lengths) * a
            + torch.repeat_interleave(cb, lengths) * b)


def adasum_allreduce(tensor: torch.Tensor, axis=None) -> torch.Tensor:
    """Adasum of every rank's ``tensor`` over ``axis`` (an ``AxisGroup``;
    default the world; a power-of-two size), in fp32, cast back."""
    axis = _axis(axis)
    _check(axis.size)
    a = tensor.reshape(-1).float()
    level = 1
    while level < axis.size:
        b = _partner(a.contiguous(), axis, level)
        ca, cb = _coefficients((a * b).sum(), (a * a).sum(), (b * b).sum())
        a = ca * a + cb * b
        level <<= 1
    return a.view(tensor.shape).to(tensor.dtype)


def _fuse(tensors):
    flats = [t.reshape(-1).float() for t in tensors]
    lengths = torch.tensor([f.numel() for f in flats],
                           device=flats[0].device)
    return torch.cat(flats), lengths


def _split_back(fused, tensors) -> List[torch.Tensor]:
    out, off = [], 0
    for t in tensors:
        out.append(fused[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return out


def grouped_adasum_allreduce(tensors: Sequence[torch.Tensor],
                             axis=None) -> List[torch.Tensor]:
    """Adasum of a list of tensors with one exchange per level on their
    fused flat; each tensor keeps its own coefficients."""
    axis = _axis(axis)
    _check(axis.size)
    if not tensors:
        return []
    a, lengths = _fuse(tensors)
    level = 1
    while level < axis.size:
        b = _partner(a, axis, level)
        a = _fused_level(a, b, lengths)
        level <<= 1
    return _split_back(a, tensors)


def _local_scatter(flat, local):
    """(this local rank's block of the local sum, pad)."""
    from .collectives import zero_reducescatter

    pad = (-flat.numel()) % local.size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    if local.size == 1:
        return flat, pad
    return zero_reducescatter(flat, local), pad


def _local_gather(block, local, pad):
    from .collectives import zero_allgather

    full = block if local.size == 1 else zero_allgather(block, local).wait()
    return full[:full.numel() - pad] if pad else full


def _world_hosts():
    return _state.axis_group("local"), _state.axis_group("cross")


def hierarchical_adasum_allreduce(tensor: torch.Tensor, hosts=None
                                  ) -> torch.Tensor:
    """Plain sum over the local group, Adasum across the cross group (a
    power-of-two size) with each scalar summed over the local group,
    then a local all-gather. ``hosts``: the (local, cross) pair of
    ``AxisGroup``s to run on (default the world's)."""
    local, cross = hosts or _world_hosts()
    _check(cross.size, "hierarchical Adasum (cross size)")
    a, pad = _local_scatter(tensor.reshape(-1).float(), local)
    level = 1
    while level < cross.size:
        b = _partner(a, cross, level)
        scalars = torch.stack([(a * b).sum(), (a * a).sum(), (b * b).sum()])
        if local.size > 1:
            dist.all_reduce(scalars, group=local.group)
        ca, cb = _coefficients(*scalars)
        a = ca * a + cb * b
        level <<= 1
    return _local_gather(a, local, pad).view(tensor.shape).to(tensor.dtype)


def grouped_hierarchical_adasum_allreduce(tensors: Sequence[torch.Tensor],
                                          hosts=None) -> List[torch.Tensor]:
    """``hierarchical_adasum_allreduce`` of a list on its fused flat, with
    per-tensor coefficients: each local rank's block keeps the segment
    lengths of the tensors it covers (the padding is a segment of its
    own), and the scalars are summed over the local group. ``hosts`` as
    in ``hierarchical_adasum_allreduce``."""
    local, cross = hosts or _world_hosts()
    _check(cross.size, "hierarchical Adasum (cross size)")
    if not tensors:
        return []
    fused, lengths = _fuse(tensors)
    a, pad = _local_scatter(fused, local)
    # The segments of this rank's block [lo, hi): every tensor's overlap
    # with it (possibly empty), then the padding's.
    bounds = np.concatenate([[0], np.cumsum(lengths.tolist()), [fused.numel()
                                                                 + pad]])
    lo = local.rank * a.numel()
    hi = lo + a.numel()
    mine = np.clip(bounds, lo, hi)
    seg = torch.tensor(np.diff(mine), device=a.device)
    level = 1
    while level < cross.size:
        b = _partner(a, cross, level)
        a = _fused_level(a, b, seg, local)
        level <<= 1
    return _split_back(_local_gather(a, local, pad), tensors)


# ---- NumPy oracles (the plain versions) --------------------------------------


def adasum_reference(tensors):
    """Adasum of a list of vectors (a power-of-two count) in float64, by
    the pairwise recursion: the ground truth of the tests."""
    vecs = [np.asarray(t, dtype=np.float64) for t in tensors]
    assert _is_power_of_two(len(vecs)), \
        "adasum reference needs power-of-two inputs"

    def combine(a, b, eps=_EPS):
        dot = float(np.sum(a * b))
        na = float(np.sum(a * a))
        nb = float(np.sum(b * b))
        ca = 1.0 if na <= eps else 1.0 - dot / (2.0 * na)
        cb = 1.0 if nb <= eps else 1.0 - dot / (2.0 * nb)
        return ca * a + cb * b

    while len(vecs) > 1:
        vecs = [combine(vecs[i], vecs[i + 1])
                for i in range(0, len(vecs), 2)]
    return vecs[0]


def hierarchical_adasum_reference(tensors, local_size):
    """The oracle of ``hierarchical_adasum_allreduce``: a plain sum within
    each run of ``local_size`` ranks (cross-major rank order), Adasum
    across the sums."""
    assert len(tensors) % local_size == 0
    sums = [np.sum([np.asarray(t, dtype=np.float64)
                    for t in tensors[g:g + local_size]], axis=0)
            for g in range(0, len(tensors), local_size)]
    if len(sums) == 1:
        return sums[0]
    return adasum_reference(sums)
