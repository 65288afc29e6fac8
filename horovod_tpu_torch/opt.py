"""DistributedOptimizer: gradients averaged across the world bucket by
bucket while backward runs.

Counterpart of ``horovod_tpu/opt.py`` (the optax wrapper whose bucketed
all-reduces XLA overlapped with backprop) and of the hook design of
``horovod_tpu/torch/optimizer.py``. It wraps any ``torch.optim``
optimizer:

- the parameters are planned into fusion buckets by
  ``common/fusion.plan_buckets`` in backward order (monolithic per dtype
  unless ``bucket_cap_bytes`` or ``HOROVOD_FUSION_THRESHOLD`` sets a cap);
- a post-accumulate-grad hook on every parameter counts the bucket's
  gradients down, and when the last one lands the bucket's fused
  all-reduce is launched asynchronously (``ops/collectives``), so
  communication overlaps the rest of backward;
- ``step()`` waits on every bucket, writes the averaged gradients back
  into ``.grad`` and runs the wrapped optimizer.

The hook path runs at every world size, including 1. With ``ef16``
(fp16 with error feedback) each bucket's flat gradient is corrected by
its fp32 residual before the fp16 cast and the cast's error is kept for
the next step (``apply_error_feedback``). The residuals sit in the
optimizer's ``state`` under ``RESIDUAL_KEY``, one fp32 tensor per
parameter, so ``state_dict()`` carries them; ``load_state_dict`` refuses
a state whose residuals disagree with the optimizer's compression mode
(the JAX package's state-owns-the-mode check).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .common.compression import (apply_error_feedback, init_residual,
                                 resolve_compression)
from .common.fusion import plan_buckets_for, resolve_bucket_cap
from .ops import collectives as _coll

# The optimizer-state key of the error-feedback residuals (a list of fp32
# tensors in the wrapped parameters' order).
RESIDUAL_KEY = "error_feedback_residual"


class _DistributedOptimizer(torch.optim.Optimizer):
    def __init__(self, params, named_parameters=None, compression="auto",
                 op=_coll.Average, bucket_cap_bytes="auto",
                 backward_passes_per_step=1):
        super(self.__class__, self).__init__(params)
        if backward_passes_per_step != 1:
            raise NotImplementedError(
                "backward_passes_per_step > 1 comes with a later slice of "
                "the port")
        if op not in (_coll.Average, _coll.Sum):
            raise NotImplementedError(
                f"op {op}: the port's DistributedOptimizer reduces with "
                f"Average or Sum; Adasum comes with a later slice")
        self.op = op
        self._compression = resolve_compression(compression)
        self._ef = (self._compression is not None
                    and self._compression.error_feedback)
        self._params: List[torch.Tensor] = [
            p for group in self.param_groups for p in group["params"]
            if p.requires_grad]
        if named_parameters is not None:
            named = list(named_parameters)
            if {id(p) for p in self._params} - {id(p) for _, p in named}:
                raise ValueError("named_parameters was given but one or more "
                                 "model parameters are not named")
            if len({n for n, _ in named}) < len(named):
                raise ValueError("parameter names must be unique")
        self._buckets = plan_buckets_for(
            self._params, resolve_bucket_cap(bucket_cap_bytes),
            self._compression)
        self._bucket_of: Dict[int, int] = {}
        for b, bucket in enumerate(self._buckets):
            for i in bucket.indices:
                self._bucket_of[id(self._params[i])] = b
        self._remaining = [len(b.indices) for b in self._buckets]
        self._pending: Dict[int, _coll.PendingReduce] = {}
        # Bucket all-reduces launched since construction.
        self.allreduce_count = 0
        if self._ef:
            self.state[RESIDUAL_KEY] = init_residual(self._params)
        self._hooks = [p.register_post_accumulate_grad_hook(self._grad_ready)
                       for p in self._params]

    def _grad_ready(self, p: torch.Tensor) -> None:
        b = self._bucket_of[id(p)]
        if b in self._pending:
            raise RuntimeError(
                "a gradient was accumulated twice before step(); "
                "backward_passes_per_step > 1 comes with a later slice")
        self._remaining[b] -= 1
        if self._remaining[b] == 0:
            self._launch(b)

    def _launch(self, b: int) -> None:
        idxs = self._buckets[b].indices
        flats = {i: self._params[i].grad.reshape(-1) for i in idxs}
        flat = _coll.fuse(flats, idxs)
        if self._ef:
            res = self.state[RESIDUAL_KEY]
            flat, new_res = apply_error_feedback(
                self._compression, flat,
                _coll.fuse({i: res[i].reshape(-1) for i in idxs}, idxs))
            shapes = {i: res[i].shape for i in idxs}
            torch._foreach_copy_(
                [res[i] for i in idxs],
                [r for _, r in _coll.unfuse(new_res, shapes, idxs)])
        self._pending[b] = _coll.allreduce_async(
            flat, op=self.op, compression=self._compression)
        self.allreduce_count += 1

    def synchronize(self) -> None:
        """Finish every bucket's all-reduce and write the result into
        ``.grad``. Buckets whose gradients never all arrived (a parameter
        unused this step) are launched here, with zeros for the missing
        gradients."""
        for b, bucket in enumerate(self._buckets):
            if b not in self._pending:
                for i in bucket.indices:
                    p = self._params[i]
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                self._launch(b)
        shapes = [p.shape for p in self._params]
        with torch.no_grad():
            for b, handle in self._pending.items():
                for i, g in _coll.unfuse(handle.wait(), shapes,
                                         self._buckets[b].indices):
                    self._params[i].grad.copy_(g)
        self._pending.clear()
        self._remaining = [len(b.indices) for b in self._buckets]

    def step(self, closure=None):
        self.synchronize()
        return super(self.__class__, self).step(closure)

    def load_state_dict(self, state_dict):
        """Load a state; its error-feedback residuals must agree with this
        optimizer's compression mode: present (one per parameter, of its
        shape) under ef16, absent otherwise."""
        residual = state_dict["state"].get(RESIDUAL_KEY)
        if self._ef and residual is None:
            raise ValueError(
                "compression mismatch: this DistributedOptimizer was built "
                "with error feedback (ef16) but the state carries no "
                "residuals; save and load with the same compression mode")
        if not self._ef and residual is not None:
            raise ValueError(
                "compression mismatch: the state carries error-feedback "
                "residuals but this DistributedOptimizer was built without "
                "error feedback; save and load with the same compression "
                "mode")
        if residual is not None and [tuple(r.shape) for r in residual] != [
                tuple(p.shape) for p in self._params]:
            raise ValueError("the state's error-feedback residuals do not "
                             "match the parameters' shapes")
        super(self.__class__, self).load_state_dict(state_dict)
        if residual is not None:
            self.state[RESIDUAL_KEY] = [
                r.detach().to(device=p.device, dtype=torch.float32,
                              copy=True)
                for r, p in zip(residual, self._params)]

    def zero_grad(self, set_to_none: bool = True):
        if self._pending:
            raise RuntimeError(
                "optimizer.zero_grad() was called after loss.backward() but "
                "before optimizer.step() or optimizer.synchronize()")
        return super(self.__class__, self).zero_grad(set_to_none=set_to_none)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None, compression="auto",
                         op: int = _coll.Average, bucket_cap_bytes="auto",
                         backward_passes_per_step: int = 1):
    """Wrap ``optimizer`` so that ``step()`` applies world-averaged
    gradients (``op=Sum`` for summed ones).

    ``compression``: ``Compression.none/fp16/bf16/ef16``, the name, or
    ``"auto"`` (``HOROVOD_COMPRESSION``). ``bucket_cap_bytes``: an int,
    ``None`` (one bucket per dtype) or ``"auto"``
    (``HOROVOD_FUSION_THRESHOLD``, else one bucket per dtype).

    The result is an instance of a subclass of ``optimizer``'s class
    built over the same parameter groups (hyperparameters included).
    """
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression, op,
               bucket_cap_bytes, backward_passes_per_step)
