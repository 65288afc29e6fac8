"""Layers the image models share, with the numerics of the flax layers the
JAX models use (``nn.Conv``, ``nn.BatchNorm``, ``nn.Dense``,
``nn.max_pool``/``nn.avg_pool``).

On a GPU, activations are NCHW tensors in ``channels_last`` memory (an
NHWC input permuted, with no copy), so cuDNN runs its NHWC kernels, and
conv weights are fp32 parameters in the same memory format, cast to the
model dtype on every forward as flax casts them. On the CPU both stay
in PyTorch's default NCHW layout: there torch 2.13's backward of a
strided 1x1 conv in ``channels_last`` writes out of bounds (a crash or
wrong gradients), and the layout changes no value.

- ``padding="SAME"`` follows XLA: the odd pad element goes to the high
  end, so a stride-2 layer pads (lo, hi) = (2, 3) for a 7x7 kernel on 224
  px and (0, 1) for a 3x3 kernel on an even size. PyTorch's ``padding=``
  is symmetric, so an asymmetric pad is an explicit ``F.pad`` (zeros for
  a conv, -inf for a max pool) and a symmetric one rides the op's own
  ``padding``.
- Batch norm: statistics and normalization in fp32, the output in the
  input's dtype, fp32 scale and bias, flax's momentum (0.9 on the old
  value) and its running variance from the *biased* batch variance.
  ``F.batch_norm`` (cuDNN on a GPU) updates the running variance with the
  unbiased one, so ``flax_running_var`` corrects it in closed form.
  With ``axis_name`` (the models' ``sync_bn_axis``), flax's
  ``BatchNorm(axis_name=...)``: the batch's E[x] and E[x^2] in fp32 are
  averaged over the named axis's group (``hvd.axis_group``), the
  variance is flax's one-pass max(0, E[x^2] - E[x]^2), and the gradient
  flows back through the average (``ops/collectives.mean_over``).
- Initialization: ``lecun_normal`` (a normal truncated at two standard
  deviations, std sqrt(1/fan_in) over the truncation's 0.8796) for every
  conv and dense kernel, zero biases, batch-norm scale one (zero where
  the model asks) and bias zero, drawn from one ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

Padding = Union[str, Sequence[Tuple[int, int]]]

# Standard deviation of a unit normal truncated to [-2, 2]
# (jax.nn.initializers.variance_scaling's truncated_normal constant).
_TRUNC_STD = 0.87962566103423978


def memory_format(device) -> torch.memory_format:
    """``channels_last`` on a GPU, PyTorch's default layout elsewhere."""
    return (torch.channels_last if torch.device(device).type == "cuda"
            else torch.contiguous_format)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis: (lo, hi), the odd
    element at the high end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def resolve_pads(spatial, kernel, stride, padding: Padding):
    """((lo_h, hi_h), (lo_w, hi_w)) of ``padding`` ("SAME", "VALID" or
    explicit pairs) for an input of ``spatial`` = (H, W)."""
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding == "SAME":
        return tuple(same_pads(n, k, s)
                     for n, k, s in zip(spatial, kernel, stride))
    return tuple(tuple(p) for p in padding)


def pad2d(x, pads, value=0.0):
    """``(x', (ph, pw))``: the pads an op can take symmetrically, or ``x``
    padded explicitly with ``value`` and (0, 0) when they are not."""
    (lh, hh), (lw, hw) = pads
    if lh == hh and lw == hw:
        return x, (lh, lw)
    return F.pad(x, (lw, hw, lh, hh), value=value), (0, 0)


def lecun_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """A new contiguous fp32 tensor of ``shape`` drawn from ``lecun_normal``
    with fan_in = the product of every dimension but the first (OIHW and
    ``[out, in]`` kernels)."""
    fan_in = math.prod(shape[1:])
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w = torch.empty(shape, device=generator.device)
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class Conv(nn.Module):
    """``nn.Conv(features, kernel, strides, padding, use_bias, dtype,
    param_dtype=float32)``: the input is in ``dtype``; the fp32 kernel
    (OIHW, ``memory_format(device)``) and bias are cast to it."""

    def __init__(self, in_channels: int, features: int, kernel, strides=1,
                 padding: Padding = "SAME", use_bias: bool = False,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.kernel, self.strides = _pair(kernel), _pair(strides)
        self.padding, self.dtype = padding, dtype
        self.weight = nn.Parameter(torch.empty(
            (features, in_channels, *self.kernel), device=device).to(
                memory_format=memory_format(device)))
        self.bias = nn.Parameter(torch.zeros(features, device=device)) \
            if use_bias else None

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.copy_(lecun_normal(self.weight.shape, generator))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        pads = resolve_pads(x.shape[2:], self.kernel, self.strides,
                            self.padding)
        x, sym = pad2d(x, pads)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), bias, self.strides,
                        sym)


@torch.no_grad()
def flax_running_var(running_var, updated, n: int, momentum: float) -> None:
    """Set ``running_var`` (the old value) to flax's update from the one
    ``F.batch_norm`` wrote into ``updated``: ``momentum * old + (1 -
    momentum) * var * n / (n - 1)``, the unbiased batch variance over the
    ``n`` values of a channel. Flax takes the biased one, which gives
    ``updated * (1 - 1/n) + momentum * old / n``."""
    running_var.mul_(momentum / n).add_(updated, alpha=1.0 - 1.0 / n)


class BatchNorm(nn.Module):
    """``nn.BatchNorm(momentum, epsilon, dtype, param_dtype=float32)`` over
    the channels of an NCHW tensor. In training the batch's statistics
    normalize and update the running ones; in eval the running ones
    normalize."""

    def __init__(self, features: int, epsilon: float = 1e-5,
                 momentum: float = 0.9, scale_init: float = 1.0,
                 axis_name: Optional[str] = None, device=None):
        super().__init__()
        self.epsilon, self.momentum, self.scale_init = (epsilon, momentum,
                                                        scale_init)
        self.axis_name = axis_name
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))
        self.reset_parameters(None)

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.fill_(self.scale_init)
            self.bias.zero_()

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.epsilon)
        if self.axis_name is not None:
            return self._synced(x)
        # F.batch_norm updates a copy: autograd keeps the running buffers it
        # was given, so the correction must not touch those in place.
        updated = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, updated, self.weight,
                         self.bias, True, 1.0 - self.momentum, self.epsilon)
        flax_running_var(self.running_var, updated, x.numel() // x.shape[1],
                         self.momentum)
        return y


    def _synced(self, x):
        from ..common.state import axis_group
        from ..ops.collectives import mean_over

        xf = x.float()
        dims = [0] + list(range(2, x.dim()))
        stats = mean_over(torch.stack([xf.mean(dims), (xf * xf).mean(dims)]),
                          axis_group(self.axis_name))
        mean, mean2 = stats[0], stats[1]
        var = (mean2 - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_(
                mean.detach(), alpha=1.0 - self.momentum)
            self.running_var.mul_(self.momentum).add_(
                var.detach(), alpha=1.0 - self.momentum)
        shape = [1, -1] + [1] * (x.dim() - 2)
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


def set_sync_bn_axis(model: nn.Module, axis: Optional[str]) -> None:
    """Give every ``BatchNorm`` of ``model`` the axis its training
    statistics are averaged over (None: each shard's own)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.axis_name = axis


class Dense(nn.Module):
    """``nn.Dense(features, dtype, param_dtype=float32)``: input, fp32
    kernel and bias cast to ``dtype``."""

    def __init__(self, in_features: int, features: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty((features, in_features),
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.copy_(lecun_normal(self.weight.shape, generator))
            self.bias.zero_()

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


def max_pool(x, kernel, strides, padding: Padding = "VALID"):
    """``nn.max_pool``: an asymmetric "SAME" pad is filled with -inf."""
    kernel, strides = _pair(kernel), _pair(strides)
    x, sym = pad2d(x, resolve_pads(x.shape[2:], kernel, strides, padding),
                   value=float("-inf"))
    return F.max_pool2d(x, kernel, strides, sym)


def avg_pool_same_3x3(x):
    """``nn.avg_pool(x, (3, 3), (1, 1), "SAME")``: the border windows are
    divided by all nine taps (flax's ``count_include_pad=True``)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def to_nchw(x, dtype):
    """An NHWC image batch cast to ``dtype`` and viewed as NCHW: on a GPU
    a ``channels_last`` tensor, with no copy beyond the cast."""
    return x.to(dtype).contiguous().permute(0, 3, 1, 2).contiguous(
        memory_format=memory_format(x.device))


def reset_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every layer's parameters, in registration order."""
    for m in model.modules():
        if isinstance(m, (Conv, BatchNorm, Dense)):
            m.reset_parameters(generator)


def make_generator(device, seed: int,
                   generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(seed)


_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def params_from_jax(variables: Mapping) -> dict:
    """An image model's ``state_dict`` from the numpy leaves of flax's
    ``{"params": ..., "batch_stats": ...}``: module paths keep flax's
    names (``BottleneckBlock_3.Conv_1``); a conv kernel HWIO becomes
    OIHW, a dense kernel ``[in, out]`` becomes ``[out, in]``, a batch
    norm's scale/bias/mean/var become weight/bias/running_mean/
    running_var. Every value is fp32, as the port keeps them."""
    out = {}

    def walk(tree, prefix, leaves):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.", leaves)
                continue
            arr = np.array(value, dtype=np.float32)
            if key == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif key == "kernel":
                arr = arr.T
            out[prefix + leaves[key]] = torch.from_numpy(
                np.ascontiguousarray(arr))

    walk(variables["params"], "", _PARAM_LEAVES)
    walk(variables.get("batch_stats", {}), "", _STAT_LEAVES)
    return out
