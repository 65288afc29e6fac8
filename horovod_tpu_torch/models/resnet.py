"""ResNet family — the port of ``horovod_tpu/models/resnet.py``, the
headline benchmark's model.

The modules keep flax's names (``conv_init``, ``bn_init``,
``BottleneckBlock_<i>`` with ``Conv_<j>``, ``BatchNorm_<j>``,
``conv_proj``, ``norm_proj``, then ``Dense_0``), so ``params_from_jax``
maps a flax ``{"params", "batch_stats"}`` tree onto the ``state_dict``
path by path. The forward takes NHWC images, as the JAX model does, and
keeps the network in ``channels_last`` memory. Numerics follow the JAX
model (``models/image_layers.py``): bf16 convs on fp32 parameters, XLA's
asymmetric "SAME" pads, flax batch norm (fp32 statistics, bf16 output,
the block's last scale initialized to zero), the mean pool in bf16, an
fp32 head. The stride of a bottleneck block sits on its 3x3 conv
(ResNet v1.5).

``space_to_depth_stem`` swaps the 7x7/stride-2 stem for the equivalent
4x4/stride-1 conv over space-to-depth(2) input; its kernel is the 7x7
kernel drawn from the same generator and re-tiled by
``stem_weights_to_s2d``, so both stems give one model at one seed.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common.state import resolve_device
from .image_layers import (BatchNorm, Conv, Dense, lecun_normal,
                           make_generator, max_pool, set_sync_bn_axis,
                           to_nchw)
from .image_layers import params_from_jax  # noqa: F401


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_channels: int, filters: int, strides: int,
                 dtype, device):
        super().__init__()
        conv = functools.partial(Conv, dtype=dtype, device=device)
        out = filters * 4
        self.Conv_0 = conv(in_channels, filters, 1)
        self.BatchNorm_0 = BatchNorm(filters, device=device)
        self.Conv_1 = conv(filters, filters, 3, strides)
        self.BatchNorm_1 = BatchNorm(filters, device=device)
        self.Conv_2 = conv(filters, out, 1)
        self.BatchNorm_2 = BatchNorm(out, scale_init=0.0, device=device)
        if in_channels != out or strides != 1:
            self.conv_proj = conv(in_channels, out, 1, strides)
            self.norm_proj = BatchNorm(out, device=device)
        self.out_channels = out

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if hasattr(self, "conv_proj"):
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, filters: int, strides: int,
                 dtype, device):
        super().__init__()
        conv = functools.partial(Conv, dtype=dtype, device=device)
        self.Conv_0 = conv(in_channels, filters, 3, strides)
        self.BatchNorm_0 = BatchNorm(filters, device=device)
        self.Conv_1 = conv(filters, filters, 3)
        self.BatchNorm_1 = BatchNorm(filters, scale_init=0.0, device=device)
        if in_channels != filters or strides != 1:
            self.conv_proj = conv(in_channels, filters, 1, strides)
            self.norm_proj = BatchNorm(filters, device=device)
        self.out_channels = filters

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        if hasattr(self, "conv_proj"):
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """[N, H, W, C] -> [N, H/b, W/b, b*b*C]; channel order (dh, dw, c), the
    layout ``stem_weights_to_s2d`` maps onto."""
    n, h, w, c = x.shape
    b = block
    x = x.reshape(n, h // b, b, w // b, b, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // b, w // b, b * b * c)


def stem_weights_to_s2d(w: torch.Tensor) -> torch.Tensor:
    """Exact re-tiling of a 7x7/stride-2 stem kernel ``[F, C, 7, 7]``
    (OIHW) into the equivalent 4x4/stride-1 kernel ``[F, 4C, 4, 4]`` over
    space-to-depth(2) input: tap (m, n) with sub-position (dh, dw) carries
    the original tap (2m + dh, 2n + dw); the out-of-range slot (7) of each
    axis stays zero. XLA's "SAME" pad_lo of 2 for the 7x7/stride-2 conv is
    twice the s2d conv's pad_lo of 1, so the windows line up."""
    f, c, kh, kw = w.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"stem re-tiling is for the 7x7 kernel, got "
                         f"{kh}x{kw}")
    w8 = F.pad(w, (0, 1, 0, 1)).reshape(f, c, 4, 2, 4, 2)
    return w8.permute(0, 3, 5, 1, 2, 4).reshape(f, 4 * c, 4, 4)


class ResNet(nn.Module):
    """Logits ``[N, num_classes]`` (fp32) of NHWC images."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype=torch.bfloat16, space_to_depth_stem: bool = False,
                 sync_bn_axis=None, device=None, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.space_to_depth_stem = space_to_depth_stem
        nf = num_filters
        if space_to_depth_stem:
            self.conv_init_s2d = Conv(12, nf, 4, 1, ((1, 2), (1, 2)),
                                      dtype=dtype, device=device)
        else:
            self.conv_init = Conv(3, nf, 7, 2, dtype=dtype, device=device)
        self.bn_init = BatchNorm(nf, device=device)
        blocks, channels = [], nf
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                strides = 2 if i > 0 and j == 0 else 1
                block = block_cls(channels, nf * 2 ** i, strides, dtype,
                                  device)
                self.add_module(f"{block_cls.__name__}_{len(blocks)}", block)
                blocks.append(block)
                channels = block.out_channels
        self._blocks = blocks
        self.Dense_0 = Dense(channels, num_classes, device=device)
        self.reset_parameters(make_generator(device, seed, generator))
        set_sync_bn_axis(self, sync_bn_axis)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every layer in registration order; the s2d stem draws the
        7x7 kernel (first, as the 7x7 stem does) and re-tiles it."""
        for m in self.modules():
            if m is getattr(self, "conv_init_s2d", None):
                w7 = lecun_normal((m.weight.shape[0], 3, 7, 7), generator)
                with torch.no_grad():
                    m.weight.copy_(stem_weights_to_s2d(w7))
            elif isinstance(m, (Conv, BatchNorm, Dense)):
                m.reset_parameters(generator)

    def forward(self, x):
        if self.space_to_depth_stem:
            x = to_nchw(space_to_depth(x.to(self.dtype), 2), self.dtype)
            x = self.conv_init_s2d(x)
        else:
            x = self.conv_init(to_nchw(x, self.dtype))
        x = F.relu(self.bn_init(x))
        x = max_pool(x, 3, 2, "SAME")
        for block in self._blocks:
            x = block(x)
        return self.Dense_0(x.mean((2, 3)))


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block_cls=BasicBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BottleneckBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                              block_cls=BottleneckBlock)
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3],
                              block_cls=BottleneckBlock)
