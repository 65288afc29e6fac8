"""The training step: forward, loss, backward and the distributed update.

Counterpart of ``horovod_tpu/training.py`` (``cross_entropy_loss``,
``make_train_step``, ``init_train_state``, ``shard_batch``) and of the
transformer's ``make_train_step``. PyTorch runs eagerly, so the step is a
plain function; the gradient reduction happens inside
``DistributedOptimizer`` (bucket all-reduces launched from backward hooks,
waited on in ``step()``), each parameter over the ranks that hold the same
slice of it. Under sequence parallelism every rank's backward already
carries the gradients that other ranks' losses send back through the ring
or all-to-all, so the average over the data shards (dp x sp) is the
transpose of the JAX loss's ``lax.pmean(loss, ("dp", "sp"))`` with no
extra step. The tp and pp ranks of a data shard hold the same loss.

An image model's batch norms normalize with this rank's batch and update
their running statistics; after the update the step averages those
statistics over the world in one fused all-reduce, as the JAX step's
``lax.pmean(new_stats)`` does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .common import state as _state
from .ops.collectives import allreduce, grouped_allreduce


def cross_entropy_loss(logits, labels):
    """Mean cross-entropy over every position, computed in fp32."""
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def make_train_step(model: torch.nn.Module, dist_opt: torch.optim.Optimizer):
    """``step(inputs, labels, segment_ids=None) -> loss``: one forward in
    training mode, backward and distributed optimizer update on this
    rank's shard of the batch (tokens, or NHWC images). The returned loss
    is detached and averaged over the data shards (the dp x sp group), the
    JAX step's ``pmean``: the same on every rank. The model's floating
    buffers (batch-norm running statistics) are averaged over the world
    after the update."""
    stats = [b for b in model.buffers() if b.is_floating_point()]

    def step(inputs, labels, segment_ids=None):
        model.train()
        dist_opt.zero_grad(set_to_none=True)
        # No name for the logits: a live reference would keep them (the
        # transformer's are [B, T, vocab] fp32) through the backward.
        args = (inputs,) if segment_ids is None else (inputs, segment_ids)
        loss = cross_entropy_loss(model(*args), labels)
        loss.backward()
        dist_opt.step()
        if stats:
            with torch.no_grad():
                torch._foreach_copy_(stats, grouped_allreduce(stats))
        return allreduce(loss.detach(), axis=data)

    data = _state.axis_group("data")
    return step


def init_train_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     compression="auto", bucket_cap_bytes="auto"):
    """The optimizer state the step runs on: ``optimizer`` wrapped in a
    ``DistributedOptimizer`` with the step's compression mode, so that an
    ``ef16`` state holds its residuals from the start (the JAX
    ``init_train_state``'s agreement between state and step)."""
    from .opt import DistributedOptimizer

    return DistributedOptimizer(optimizer,
                                named_parameters=model.named_parameters(),
                                compression=compression,
                                bucket_cap_bytes=bucket_cap_bytes)


def shard_batch(arrays: Sequence[np.ndarray], rank: int, size: int,
                device) -> list:
    """This rank's rows ``[rank * b, (rank + 1) * b)`` of each global-batch
    array (b = rows / size), as tensors on ``device``."""
    out = []
    for a in arrays:
        if a.shape[0] % size:
            raise ValueError(f"global batch {a.shape[0]} does not split over "
                             f"{size} ranks")
        b = a.shape[0] // size
        out.append(torch.as_tensor(a[rank * b:(rank + 1) * b], device=device))
    return out
