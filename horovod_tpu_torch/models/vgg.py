"""VGG — the port of ``horovod_tpu/models/vgg.py``: the communication-heavy
model of the benchmark trio (its 25088->4096 dense layer carries most of
~138 M parameters at 224 px).

Modules keep flax's names (``conv<i>_<j>``, ``bn<i>_<j>``, ``fc0``,
``fc1``, ``head``) for ``params_from_jax``. Convs (3x3, "SAME", with
bias) and the two hidden dense layers run in bf16 on fp32 parameters, the
head in fp32; ``max_pool(2, 2)`` has no padding. The features are
flattened in flax's NHWC order (H, W, C), so ``fc0``'s rows line up with
the JAX kernel's; the module is built for one ``image_size``, which sets
``fc0``'s width as flax's shape inference does at init.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common.state import resolve_device
from .image_layers import (BatchNorm, Conv, Dense, make_generator, max_pool,
                           reset_parameters, set_sync_bn_axis, to_nchw)
from .image_layers import params_from_jax  # noqa: F401


def flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW features flattened in (H, W, C) order, as flax flattens NHWC
    (a view of a channels_last tensor)."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class VGG(nn.Module):
    """Logits ``[N, num_classes]`` (fp32) of NHWC images of
    ``image_size`` px."""

    def __init__(self, stage_convs: Sequence[int], num_classes: int = 1000,
                 num_filters: Sequence[int] = (64, 128, 256, 512, 512),
                 dense_width: int = 4096, dtype=torch.bfloat16,
                 batch_norm: bool = False, sync_bn_axis=None,
                 image_size: int = 224, device=None, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self._layers = []
        channels, size = 3, image_size
        for i, n_convs in enumerate(stage_convs):
            for j in range(n_convs):
                conv = Conv(channels, num_filters[i], 3, use_bias=True,
                            dtype=dtype, device=device)
                self.add_module(f"conv{i}_{j}", conv)
                bn = None
                if batch_norm:
                    bn = BatchNorm(num_filters[i], device=device)
                    self.add_module(f"bn{i}_{j}", bn)
                self._layers.append((conv, bn))
                channels = num_filters[i]
            self._layers.append(None)   # the stage's max pool
            size //= 2
        dense = functools.partial(Dense, device=device)
        self.fc0 = dense(size * size * channels, dense_width, dtype)
        self.fc1 = dense(dense_width, dense_width, dtype)
        self.head = dense(dense_width, num_classes, torch.float32)
        reset_parameters(self, make_generator(device, seed, generator))
        set_sync_bn_axis(self, sync_bn_axis)

    def features(self, x):
        """The conv stack's output, NCHW (channels_last), from NHWC
        images."""
        x = to_nchw(x, self.dtype)
        for layer in self._layers:
            if layer is None:
                x = max_pool(x, 2, 2)
                continue
            conv, bn = layer
            x = conv(x)
            if bn is not None:
                x = bn(x)
            x = F.relu(x)
        return x

    def classifier(self, x):
        """Logits from the flattened features."""
        x = F.relu(self.fc0(x))
        x = F.relu(self.fc1(x))
        return self.head(x)

    def forward(self, x):
        return self.classifier(flatten_hwc(self.features(x)))


VGG11 = functools.partial(VGG, stage_convs=[1, 1, 2, 2, 2])
VGG13 = functools.partial(VGG, stage_convs=[2, 2, 2, 2, 2])
VGG16 = functools.partial(VGG, stage_convs=[2, 2, 3, 3, 3])
VGG19 = functools.partial(VGG, stage_convs=[2, 2, 4, 4, 4])
