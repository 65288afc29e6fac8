"""Horovod torch's ``DistributedOptimizer``: one named allreduce a
parameter (the port's counterpart of ``horovod_tpu/torch/optimizer.py``;
the bucketed optimizer of ``horovod_tpu_torch/opt.py`` is another
design).

Each parameter gets a post-accumulate-grad hook that submits its
gradient by name (``allreduce_async_``) once it has arrived
``backward_passes_per_step`` times; the native core fuses what arrives
together, and ``step()`` synchronizes every handle first, so the
reductions overlap the rest of backward. Average is a Sum with a
prescale of 1 / ``gradient_predivide_factor`` and a postscale of
``gradient_predivide_factor`` / size. ``op=hvd.Adasum`` builds the delta
flavour (``_DistributedAdasumOptimizer``) on ``ops/adasum.py``.
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager

import torch

from . import mpi_ops as _ops
from .compression import Compression
from .mpi_ops import Adasum, Average, Sum


class _DistributedOptimizer(torch.optim.Optimizer):
    _hvd_wrapper = True

    def __init__(self, params, named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step=1, op=Average,
                 gradient_predivide_factor=1.0):
        super(self.__class__, self).__init__(params)
        self._compression = compression
        self.op = op
        self.backward_passes_per_step = backward_passes_per_step
        self.gradient_predivide_factor = gradient_predivide_factor
        all_params = [p for group in self.param_groups
                      for p in group["params"]]
        if named_parameters is not None:
            named_parameters = list(named_parameters)
            named = {p for _, p in named_parameters}
            if any(p not in named for p in all_params):
                raise ValueError(
                    "named_parameters was specified but one or more model "
                    "parameters were not named")
            if len({name for name, _ in named_parameters}) < len(
                    named_parameters):
                raise ValueError("parameter names must be unique")
            self._parameter_names = {p: name for name, p in named_parameters}
        else:
            self._parameter_names = {
                p: f"allreduce.noname.{gi}.{pi}"
                for gi, group in enumerate(self.param_groups)
                for pi, p in enumerate(group["params"])}
        self._handles = {}
        self._allreduce_delay = {}
        self._hook_handles = []
        self._requires_update = []
        self._synchronized = False
        self._should_synchronize = True
        if _ops.size() > 1:
            self._register_hooks()

    def _register_hooks(self):
        for group in self.param_groups:
            for p in group["params"]:
                if not p.requires_grad:
                    continue
                self._requires_update.append(p)
                self._allreduce_delay[p] = self.backward_passes_per_step
                self._hook_handles.append(
                    p.register_post_accumulate_grad_hook(self._on_grad_ready))

    def _on_grad_ready(self, p):
        if p.grad is None:
            return
        if p in self._handles and self._allreduce_delay[p] <= 0:
            raise AssertionError(
                "Gradients were computed more than "
                "backward_passes_per_step times before call to step(). "
                "Increase backward_passes_per_step to accumulate "
                "gradients locally.")
        self._allreduce_delay[p] -= 1
        if self._allreduce_delay[p] == 0:
            self._handles[p] = self._allreduce_grad_async(p)

    def _allreduce_grad_async(self, p):
        prescale = postscale = 1.0
        op = self.op
        if op == Average:
            # The net scale is 1/size either way; the split sets where a
            # 16-bit wire rounds.
            op = Sum
            prescale = 1.0 / self.gradient_predivide_factor
            postscale = self.gradient_predivide_factor / _ops.size()
        compressed, ctx = self._compression.compress(p.grad)
        handle = _ops.allreduce_async_(
            compressed, name=self._parameter_names.get(p), op=op,
            prescale_factor=prescale, postscale_factor=postscale)
        return handle, ctx, compressed

    def synchronize(self):
        """Complete every outstanding allreduce, first submitting those of
        parameters whose hooks never fired this step (an unused branch:
        its gradient, zeros if it has none)."""
        for p in self._requires_update:
            if p not in self._handles:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                self._allreduce_delay[p] = 0
                self._handles[p] = self._allreduce_grad_async(p)
        try:
            for p, (handle, ctx, compressed) in list(self._handles.items()):
                output = _ops.synchronize(handle)
                self._allreduce_delay[p] = self.backward_passes_per_step
                if compressed is not p.grad or ctx is not None:
                    p.grad.copy_(self._compression.decompress(output, ctx))
        except BaseException:
            # A failed world (the elastic retry loop restores and
            # re-initializes): its handles are gone with it.
            for p in self._requires_update:
                self._allreduce_delay[p] = self.backward_passes_per_step
            raise
        finally:
            self._handles.clear()
        self._synchronized = True

    @contextmanager
    def skip_synchronize(self):
        """For a ``step()`` after a manual ``synchronize()``."""
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
                    "synchronize(); this can cause training slowdown")
            self.synchronize()
        self._synchronized = False
        return super(self.__class__, self).step(closure)

    def zero_grad(self, *args, **kwargs):
        if self._handles:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() but "
                "before optimizer.step() or optimizer.synchronize(). This "
                "is prohibited as it can cause a race condition.")
        return super(self.__class__, self).zero_grad(*args, **kwargs)


class _DistributedAdasumOptimizer(torch.optim.Optimizer):
    """The Adasum delta flavour: the wrapped optimizer steps on this
    rank's own gradients, the parameter deltas are combined over the
    world with Adasum (each tensor with its own coefficients, by name),
    and the combined delta is applied to the parameters of the step's
    start."""

    _hvd_wrapper = True

    def __init__(self, params, compression=Compression.none):
        super(self.__class__, self).__init__(params)
        self._compression = compression

    def step(self, closure=None):
        starts = {p: p.data.clone() for group in self.param_groups
                  for p in group["params"] if p.requires_grad}
        loss = super(self.__class__, self).step(closure)
        if _ops.size() > 1:
            handles = []
            for gi, group in enumerate(self.param_groups):
                for pi, p in enumerate(group["params"]):
                    if p not in starts:
                        continue
                    compressed, ctx = self._compression.compress(
                        p.data - starts[p])
                    h = _ops.allreduce_async(
                        compressed, name=f"adasum.delta.{gi}.{pi}",
                        op=Adasum)
                    handles.append((p, h, ctx))
            for p, h, ctx in handles:
                delta = self._compression.decompress(_ops.synchronize(h), ctx)
                p.data.copy_(starts[p] + delta)
        return loss


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         op: int = Average,
                         gradient_predivide_factor: float = 1.0):
    """Wrap ``optimizer`` so that ``step()`` applies gradients averaged
    over the world (``op=Sum``: summed), reduced a parameter at a time as
    backward makes them; ``op=hvd.Adasum`` selects the delta flavour. The
    result is an instance of a subclass of ``optimizer``'s class over the
    same parameter groups."""
    if gradient_predivide_factor != 1.0 and op != Average:
        raise ValueError(
            "gradient_predivide_factor not supported with op != Average")
    if op != Adasum:
        cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
                   dict(_DistributedOptimizer.__dict__))
        return cls(optimizer.param_groups, named_parameters, compression,
                   backward_passes_per_step, op, gradient_predivide_factor)
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedAdasumOptimizer.__dict__))
    return cls(optimizer.param_groups, compression)
