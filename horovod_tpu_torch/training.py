"""The training step: forward, loss, backward and the distributed update.

Counterpart of ``horovod_tpu/training.py``'s ``cross_entropy_loss`` and of
the transformer's ``make_train_step``. PyTorch runs eagerly, so the step
is a plain function; the data-parallel gradient average happens inside
``DistributedOptimizer`` (bucket all-reduces launched from backward hooks,
waited on in ``step()``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy_loss(logits, labels):
    """Mean token cross-entropy, computed in fp32."""
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def make_train_step(model: torch.nn.Module, dist_opt: torch.optim.Optimizer):
    """``step(tokens, labels) -> loss``: one forward, backward and
    distributed optimizer update on this rank's batch. The returned loss
    is this rank's, detached (it is not averaged across ranks)."""

    def step(tokens, labels):
        dist_opt.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(model(tokens), labels)
        loss.backward()
        dist_opt.step()
        return loss.detach()

    return step
