"""Batch norm over the world's batch (the port's counterpart of
``horovod_tpu/torch/sync_batch_norm.py``).

The forward all-reduces each rank's count, sum and sum of squares in
fp32 and takes the one-pass variance E[x^2] - E[x]^2 of the world's
batch; the backward all-reduces the two gradient sums. The running
variance is the unbiased one, as torch's batch norm keeps it, and the
output is in the input's dtype. On the world's device the two sums a
layer are negotiated, as the reference's are, so that they run in the
coordinator's order with the gradients that the binding's
``DistributedOptimizer`` submits from backward hooks
(``ops/collectives.ordered_allreduce``); inside a bucketed train step
(``ops/collectives.direct_world_sums``) they take the direct world
all-reduce. A lost world raises ``HorovodInternalError`` on either path.
A CPU tensor in a world on a GPU goes through the named host plane
(``hvd.allreduce``).
"""

from __future__ import annotations

import torch
from torch.nn.modules.batchnorm import _BatchNorm

from ..ops import collectives as _coll
from . import mpi_ops as _ops


class SyncBatchNorm(_BatchNorm):
    """A drop-in for ``torch.nn.BatchNorm{1,2,3}d`` in data-parallel
    training: the statistics of training mode are those of every rank's
    batch. In eval mode with running statistics, and in a world of one,
    it is the local batch norm."""

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {input.dim()}D input)")

    def forward(self, input):
        if (not self.training and self.track_running_stats) or \
                _ops.size() == 1:
            return super().forward(input)
        self._check_input_dim(input)
        factor = 0.0 if self.momentum is None else self.momentum
        if self.num_batches_tracked is not None:
            self.num_batches_tracked.add_(1)
            if self.momentum is None:
                factor = 1.0 / float(self.num_batches_tracked)
        return _SyncBatchNormFn.apply(
            input, self.weight, self.bias, self.running_mean,
            self.running_var, self.eps, factor)


def _world_sum(t: torch.Tensor, name: str) -> torch.Tensor:
    """The sum of ``t`` over the world: ordered with the eager engine's
    collectives for a tensor on the world's device, the named host plane
    otherwise."""
    if _ops._plane(t) == _ops._ENGINE:
        return _coll.ordered_allreduce(t, name, op=_coll.Sum)
    return _ops.synchronize(_ops.allreduce_async(t, op=_ops.Sum, name=name))


class _SyncBatchNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, input, weight, bias, running_mean, running_var, eps,
                momentum):
        C = input.size(1)
        reduce_dims = [0] + list(range(2, input.dim()))
        local = torch.empty(2 * C + 1, dtype=torch.float32,
                            device=input.device)
        local[0] = float(input.numel() // C)
        local[1:1 + C] = input.sum(dim=reduce_dims).to(torch.float32)
        local[1 + C:] = (input * input).sum(dim=reduce_dims).to(torch.float32)
        total = _world_sum(local, "sync_batch_norm.fwd")
        count_all = total[0]
        mean = total[1:1 + C] / count_all
        var = total[1 + C:] / count_all - mean * mean
        invstd = torch.rsqrt(var + eps)
        if running_mean is not None:
            running_mean.mul_(1 - momentum).add_(
                mean.to(running_mean.dtype), alpha=momentum)
            unbiased = var * (count_all / (count_all - 1).clamp_min(1))
            running_var.mul_(1 - momentum).add_(
                unbiased.to(running_var.dtype), alpha=momentum)
        shape = [1, C] + [1] * (input.dim() - 2)
        out = (input.to(torch.float32) - mean.view(shape)) * \
            invstd.view(shape)
        if weight is not None:
            out = out * weight.to(torch.float32).view(shape)
        if bias is not None:
            out = out + bias.to(torch.float32).view(shape)
        ctx.save_for_backward(input, weight, mean, invstd, count_all)
        return out.to(input.dtype)

    @staticmethod
    def backward(ctx, grad_output):
        input, weight, mean, invstd, count_all = ctx.saved_tensors
        C = input.size(1)
        reduce_dims = [0] + list(range(2, input.dim()))
        shape = [1, C] + [1] * (input.dim() - 2)
        gof = grad_output.to(torch.float32)
        xmu = input.to(torch.float32) - mean.view(shape)
        sum_dy = gof.sum(dim=reduce_dims)
        sum_dy_xmu = (gof * xmu).sum(dim=reduce_dims)
        total = _world_sum(torch.cat([sum_dy, sum_dy_xmu]),
                           "sync_batch_norm.bwd")
        n = count_all
        w = (weight.to(torch.float32).view(shape) if weight is not None
             else torch.ones(shape, dtype=torch.float32,
                             device=input.device))
        grad_input = w * invstd.view(shape) * (
            gof - total[:C].view(shape) / n
            - xmu * invstd.view(shape) ** 2 * total[C:].view(shape) / n)
        grad_weight = grad_bias = None
        if weight is not None and ctx.needs_input_grad[1]:
            grad_weight = (sum_dy_xmu * invstd).to(weight.dtype)
        if ctx.needs_input_grad[2]:
            grad_bias = sum_dy.to(grad_output.dtype)
        return (grad_input.to(input.dtype), grad_weight, grad_bias, None,
                None, None, None)
