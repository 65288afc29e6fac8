"""The training step: forward, loss, backward and the distributed update.

Counterpart of ``horovod_tpu/training.py``'s ``cross_entropy_loss`` and of
the transformer's ``make_train_step``. PyTorch runs eagerly, so the step
is a plain function; the gradient average over the world happens inside
``DistributedOptimizer`` (bucket all-reduces launched from backward hooks,
waited on in ``step()``). Under sequence parallelism every rank's
backward already carries the gradients that other ranks' losses send back
through the ring or all-to-all, so that world average is the transpose of
the JAX loss's ``lax.pmean(loss, ("dp", "sp"))`` with no extra step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops.collectives import allreduce


def cross_entropy_loss(logits, labels):
    """Mean token cross-entropy, computed in fp32."""
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def make_train_step(model: torch.nn.Module, dist_opt: torch.optim.Optimizer):
    """``step(tokens, labels, segment_ids=None) -> loss``: one forward,
    backward and distributed optimizer update on this rank's shard of
    the batch. The returned loss is detached and averaged over the world
    (every dp and sp rank), the JAX step's ``pmean``."""

    def step(tokens, labels, segment_ids=None):
        dist_opt.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(model(tokens, segment_ids), labels)
        loss.backward()
        dist_opt.step()
        return allreduce(loss.detach())

    return step
