"""DistributedOptimizer: gradients reduced over the ranks that hold the
same slice of each parameter, bucket by bucket while backward runs.

Counterpart of ``horovod_tpu/opt.py`` (the optax wrapper whose bucketed
all-reduces XLA overlapped with backprop) and of the hook design of
``horovod_tpu/torch/optimizer.py``. It wraps any ``torch.optim``
optimizer:

- each parameter is reduced over a group of ``parallel/mesh.py``: the
  data shards (``"data"``, dp x sp: every rank at tp = pp = 1) unless the
  parameter names another in its ``mesh.REDUCE_ATTR`` attribute (the
  transformer's embedding: ``"stages"``, since one pipeline stage alone
  uses it; its experts: ``"sp"``, since the expert all-to-all already
  summed their gradient over dp). The gradient is summed over that group
  and, for Average, divided by the number of data shards, so every
  placement yields the gradient of the mean loss;
- the parameters are planned into fusion buckets by
  ``common/fusion.plan_buckets`` in backward order, pure in group as well
  as in dtype (monolithic per dtype unless ``bucket_cap_bytes`` or
  ``HOROVOD_FUSION_THRESHOLD`` sets a cap);
- a post-accumulate-grad hook on every parameter counts its gradient's
  arrivals; when every parameter of a bucket has arrived
  ``backward_passes_per_step`` times, the bucket's fused all-reduce is
  launched asynchronously (``ops/collectives``), so communication
  overlaps the rest of backward. A bucket whose group spans pipeline
  stages waits for ``synchronize()``: its members run different stages'
  graphs, whose hooks fire in different orders, so the plan's order is
  the only one they share;
- ``step()`` waits on every bucket, writes the reduced gradients back
  into ``.grad`` and runs the wrapped optimizer.

With ``backward_passes_per_step = k`` the k backward passes accumulate
into ``.grad`` (torch's sum) and that sum is what is reduced, as the
torch binding does (``torch/optimizer.py``); the JAX package reduces the
mean of the k gradients, so a loss scaled by 1/k gives the same update.
Error feedback is applied when the bucket is sent, to the accumulated
gradient, as the JAX package applies it at communication time.

The hook path runs at every world size, including 1. With ``ef16``
(fp16 with error feedback) each bucket's flat gradient is corrected by
its fp32 residual before the fp16 cast and the cast's error is kept for
the next step (``apply_error_feedback``). The residuals sit in the
optimizer's ``state`` under ``RESIDUAL_KEY``, one fp32 tensor per
parameter, so ``state_dict()`` carries them; ``load_state_dict`` refuses
a state whose residuals disagree with the optimizer's compression mode
(the JAX package's state-owns-the-mode check).

``zero_axis="dp"`` partitions the wrapped optimizer's state over that
axis after the reduction (ZeRO-1, ``zero.ZeroOverAxis``), and
``op=Adasum`` builds the delta flavour instead
(``_DistributedAdasumOptimizer``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Dict, List

import torch

from .common import state as _state
from .common.compression import (apply_error_feedback, init_residual,
                                 resolve_compression)
from .common.fusion import plan_buckets_for, resolve_bucket_cap
from .ops import collectives as _coll
from .parallel.mesh import GROUPS as _MESH_GROUPS
from .parallel.mesh import reduce_group

# The optimizer-state key of the error-feedback residuals (a list of fp32
# tensors in the wrapped parameters' order).
RESIDUAL_KEY = "error_feedback_residual"


class _DistributedOptimizer(torch.optim.Optimizer):
    # A wrapper's step reduces first (torch/functions._local_step skips
    # it).
    _hvd_wrapper = True

    def __init__(self, params, named_parameters=None, compression="auto",
                 op=_coll.Average, bucket_cap_bytes="auto",
                 backward_passes_per_step=1, gradient_predivide_factor=1.0,
                 prescale_factor=1.0, postscale_factor=1.0, zero_axis=None):
        self._zero = None
        model_params = None
        if zero_axis is not None:
            from .zero import ZeroOverAxis

            model_params = [p for group in params for p in group["params"]
                            if p.requires_grad]
            over = set(_MESH_GROUPS[zero_axis])
            self._zero = ZeroOverAxis(
                params, _state.axis_group(zero_axis),
                lambda p: over <= set(_MESH_GROUPS[reduce_group(p)]))
            params = self._zero.param_groups
        super(self.__class__, self).__init__(params)
        if op not in (_coll.Average, _coll.Sum):
            raise ValueError(
                f"op {op}: the DistributedOptimizer reduces gradients with "
                f"Average or Sum (Adasum combines deltas: op=Adasum)")
        if backward_passes_per_step < 1:
            raise ValueError(f"backward_passes_per_step must be >= 1, got "
                             f"{backward_passes_per_step}")
        self.op = op
        self.backward_passes_per_step = backward_passes_per_step
        self._compression = resolve_compression(compression)
        self._ef = (self._compression is not None
                    and self._compression.error_feedback)
        self._params: List[torch.Tensor] = model_params or [
            p for group in self.param_groups for p in group["params"]
            if p.requires_grad]
        if named_parameters is not None:
            named = list(named_parameters)
            if {id(p) for p in self._params} - {id(p) for _, p in named}:
                raise ValueError("named_parameters was given but one or more "
                                 "model parameters are not named")
            if len({n for n, _ in named}) < len(named):
                raise ValueError("parameter names must be unique")
        self._buckets, names = self._plan(bucket_cap_bytes)
        self._groups = [_state.axis_group(name) for name in names]
        n_data = _state.axis_group("data").size
        self._scales = []
        for group in self._groups:
            if gradient_predivide_factor != 1.0:
                self._scales.append((
                    _coll.Sum, prescale_factor / gradient_predivide_factor,
                    postscale_factor * gradient_predivide_factor / n_data))
            elif op == _coll.Average:
                # Average divides by the group; the mean is over the data
                # shards, however many ranks hold a slice.
                self._scales.append((op, prescale_factor, postscale_factor
                                     * group.size / n_data))
            else:
                self._scales.append((op, prescale_factor, postscale_factor))
        self._deferred = {b for b, name in enumerate(names)
                          if "pp" in _MESH_GROUPS.get(name, ())}
        self._bucket_of: Dict[int, int] = {}
        for b, bucket in enumerate(self._buckets):
            for i in bucket.indices:
                self._bucket_of[id(self._params[i])] = b
        self._pending: Dict[int, _coll.PendingReduce] = {}
        self._reset_counts()
        self._synchronized = False
        self._should_synchronize = True
        # Bucket all-reduces launched since construction.
        self.allreduce_count = 0
        if self._ef:
            self.state[RESIDUAL_KEY] = init_residual(self._params)
        self._hooks = [p.register_post_accumulate_grad_hook(self._grad_ready)
                       for p in self._params]

    def _plan(self, bucket_cap_bytes):
        """Buckets pure in group and dtype, and each bucket's group name:
        each group's parameters are planned apart, groups in the order of
        their first parameter."""
        cap = resolve_bucket_cap(bucket_cap_bytes)
        by_group: Dict[str, List[int]] = {}
        for i, p in enumerate(self._params):
            by_group.setdefault(reduce_group(p), []).append(i)
        buckets, names = [], []
        for name, idxs in by_group.items():
            for b in plan_buckets_for([self._params[i] for i in idxs], cap,
                                      self._compression):
                buckets.append(dataclasses.replace(
                    b, indices=tuple(idxs[j] for j in b.indices)))
                names.append(name)
        return buckets, names

    def _reset_counts(self):
        k = self.backward_passes_per_step
        self._arrivals = {id(p): k for p in self._params}
        self._remaining = [len(b.indices) for b in self._buckets]

    def _grad_ready(self, p: torch.Tensor) -> None:
        b = self._bucket_of[id(p)]
        if self._arrivals[id(p)] == 0:
            raise RuntimeError(
                "a gradient was computed more than backward_passes_per_step "
                f"({self.backward_passes_per_step}) times before step() or "
                "synchronize(); raise backward_passes_per_step to "
                "accumulate more passes")
        self._arrivals[id(p)] -= 1
        if self._arrivals[id(p)] == 0:
            self._remaining[b] -= 1
            if self._remaining[b] == 0 and b not in self._deferred:
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
        op, pre, post = self._scales[b]
        self._pending[b] = _coll.allreduce_async(
            flat, op=op, prescale_factor=pre, postscale_factor=post,
            compression=self._compression, axis=self._groups[b])
        self.allreduce_count += 1

    def synchronize(self) -> None:
        """Finish every bucket's all-reduce and write the result into
        ``.grad``. Buckets not launched yet are launched here, in plan
        order: those whose group spans pipeline stages, and those whose
        gradients never all arrived (a parameter unused this step, which
        is given a zero gradient)."""
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
        self._reset_counts()
        self._synchronized = True

    @contextlib.contextmanager
    def skip_synchronize(self):
        """Let ``step()`` skip its ``synchronize()``: for a caller that
        synchronized by hand (say, to clip the reduced gradients) before
        stepping."""
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def step(self, closure=None):
        if self._should_synchronize:
            if self._synchronized:
                warnings.warn(
                    "optimizer.step() called without wrapping it in "
                    "optimizer.skip_synchronize() after a manual "
                    "synchronize(); the gradients are reduced again")
            self.synchronize()
        self._synchronized = False
        if self._zero is None:
            return super(self.__class__, self).step(closure)
        self._zero.load()
        loss = super(self.__class__, self).step(closure)
        self._zero.gather()
        return loss

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
        if self._zero is not None:
            for p in self._params:
                if set_to_none:
                    p.grad = None
                elif p.grad is not None:
                    p.grad.zero_()
        return super(self.__class__, self).zero_grad(set_to_none=set_to_none)


class _DistributedAdasumOptimizer(torch.optim.Optimizer):
    """The Adasum delta flavour (``horovod_tpu/torch/optimizer.py``'s, the
    reference's ``torch/optimizer.py:197-365``): the wrapped optimizer
    steps on this rank's own gradients, the parameter deltas are
    combined over the world with Adasum (``allreduce_async``, op=Adasum:
    each tensor with its own coefficients) and the combined delta is
    added to the start-of-step parameters. With a 16-bit compression the
    deltas travel in the wire dtype (the combination runs in fp32)."""

    _hvd_wrapper = True

    def __init__(self, params, compression="auto"):
        super(self.__class__, self).__init__(params)
        comp = resolve_compression(compression)
        if comp is not None and comp.error_feedback:
            raise ValueError("Adasum combines deltas, which keep no "
                             "error-feedback residual; use fp16 or bf16")
        self._compression = comp

    def step(self, closure=None):
        starts = {p: p.detach().clone() for group in self.param_groups
                  for p in group["params"] if p.requires_grad}
        loss = super(self.__class__, self).step(closure)
        if _state.size() > 1:
            with torch.no_grad():
                pending = []
                for p, start in starts.items():
                    delta = p - start
                    if self._compression is not None:
                        delta, ctx = self._compression.compress(delta)
                    else:
                        ctx = None
                    pending.append((p, start, ctx, _coll.allreduce_async(
                        delta, op=_coll.Adasum)))
                for p, start, ctx, handle in pending:
                    delta = handle.wait()
                    if ctx is not None:
                        delta = self._compression.decompress(delta, ctx)
                    p.copy_(start + delta)
        return loss


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None, compression="auto",
                         op: int = _coll.Average, bucket_cap_bytes="auto",
                         backward_passes_per_step: int = 1,
                         gradient_predivide_factor: float = 1.0,
                         prescale_factor: float = 1.0,
                         postscale_factor: float = 1.0, zero_axis=None):
    """Wrap ``optimizer`` so that ``step()`` applies gradients averaged
    over the data shards (``op=Sum`` for summed ones).

    ``compression``: ``Compression.none/fp16/bf16/ef16``, the name, or
    ``"auto"`` (``HOROVOD_COMPRESSION``). ``bucket_cap_bytes``: an int,
    ``None`` (one bucket per dtype) or ``"auto"``
    (``HOROVOD_FUSION_THRESHOLD``, else one bucket per dtype).
    ``backward_passes_per_step``: backward passes accumulated into
    ``.grad`` before their sum is reduced. ``gradient_predivide_factor``
    f (Average only): the sum is taken of gradients divided by f and
    multiplied by f / shards after, which moves where fp16 rounds.
    ``prescale_factor`` / ``postscale_factor``: multiply each bucket, in
    fp32, before and after the reduction. ``zero_axis`` (a mesh axis,
    say ``"dp"``): ZeRO-1 over it (``zero.ZeroOverAxis``), each rank
    keeping the optimizer state of its 1/n slice of every parameter that
    axis replicates, the JAX ``init_opt_state(zero_axis=...)``.

    ``op=Adasum`` selects the delta flavour (``_DistributedAdasumOptimizer``):
    no gradient reduction, the deltas combined by Adasum after the local
    step; it takes ``compression`` (fp16/bf16) and none of the bucketing,
    accumulation or scaling options.

    The result is an instance of a subclass of ``optimizer``'s class
    built over the same parameter groups (hyperparameters included).
    """
    if gradient_predivide_factor != 1.0 and op != _coll.Average:
        raise ValueError("gradient_predivide_factor not supported with "
                         "op != Average")
    if op == _coll.Adasum:
        cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
                   dict(_DistributedAdasumOptimizer.__dict__))
        return cls(optimizer.param_groups, compression)
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression, op,
               bucket_cap_bytes, backward_passes_per_step,
               gradient_predivide_factor, prescale_factor, postscale_factor,
               zero_axis)
