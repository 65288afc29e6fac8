"""Inception V3 — the port of ``horovod_tpu/models/inception.py`` (stem,
3 x InceptionA, InceptionB, 4 x InceptionC, InceptionD, 2 x InceptionE,
mean pool, head; no aux classifier). The canonical input is 299 px; the
stem's three stride-2 reductions need at least 75.

Modules keep flax's auto-names (``ConvBN_<i>`` with ``Conv_0`` and
``BatchNorm_0``, ``InceptionA_<i>``, ..., ``Dense_0``) for
``params_from_jax``. Each ``ConvBN`` is a bf16 conv without bias, flax
batch norm at epsilon 1e-3, and ReLU; "VALID" and stride-1 "SAME" pads,
(1, 7)/(7, 1)/(1, 3)/(3, 1) kernels; the branches' outputs are joined on
channels. The 3x3 "SAME" average pool divides the border windows by all
nine taps (flax's ``count_include_pad=True``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common.state import resolve_device
from .image_layers import (BatchNorm, Conv, Dense, avg_pool_same_3x3,
                           make_generator, max_pool, reset_parameters,
                           set_sync_bn_axis, to_nchw)
from .image_layers import params_from_jax  # noqa: F401


class ConvBN(nn.Module):
    """Conv -> BN -> ReLU, the Inception building unit."""

    def __init__(self, in_channels, filters, kernel=(1, 1), strides=(1, 1),
                 padding="SAME", dtype=torch.bfloat16, device=None):
        super().__init__()
        self.Conv_0 = Conv(in_channels, filters, kernel, strides, padding,
                           dtype=dtype, device=device)
        self.BatchNorm_0 = BatchNorm(filters, epsilon=1e-3, device=device)
        self.out_channels = filters

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class _Mixed(nn.Module):
    """A mixed block whose ``ConvBN_<i>`` are registered in flax's creation
    order; ``unit(i)`` returns the i-th."""

    def __init__(self, dtype, device):
        super().__init__()
        self._units = []
        self._dtype, self._device = dtype, device

    def _add(self, in_channels, filters, kernel=(1, 1), strides=(1, 1),
             padding="SAME"):
        unit = ConvBN(in_channels, filters, kernel, strides, padding,
                      self._dtype, self._device)
        self.add_module(f"ConvBN_{len(self._units)}", unit)
        self._units.append(unit)
        return filters

    def unit(self, i):
        return self._units[i]


class InceptionA(_Mixed):
    def __init__(self, in_channels, pool_features, dtype, device):
        super().__init__(dtype, device)
        c = in_channels
        self._add(c, 64)
        self._add(c, 48)
        self._add(48, 64, (5, 5))
        self._add(c, 64)
        self._add(64, 96, (3, 3))
        self._add(96, 96, (3, 3))
        self._add(c, pool_features)
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x):
        u = self.unit
        b1 = u(0)(x)
        b2 = u(2)(u(1)(x))
        b3 = u(5)(u(4)(u(3)(x)))
        b4 = u(6)(avg_pool_same_3x3(x))
        return torch.cat([b1, b2, b3, b4], 1)


class InceptionB(_Mixed):
    """Grid reduction 35 -> 17."""

    def __init__(self, in_channels, dtype, device):
        super().__init__(dtype, device)
        c = in_channels
        self._add(c, 384, (3, 3), (2, 2), "VALID")
        self._add(c, 64)
        self._add(64, 96, (3, 3))
        self._add(96, 96, (3, 3), (2, 2), "VALID")
        self.out_channels = 384 + 96 + c

    def forward(self, x):
        u = self.unit
        b1 = u(0)(x)
        b2 = u(3)(u(2)(u(1)(x)))
        b3 = max_pool(x, 3, 2)
        return torch.cat([b1, b2, b3], 1)


class InceptionC(_Mixed):
    """Factorized 7x7 branches."""

    def __init__(self, in_channels, c7, dtype, device):
        super().__init__(dtype, device)
        c = in_channels
        self._add(c, 192)
        self._add(c, c7)
        self._add(c7, c7, (1, 7))
        self._add(c7, 192, (7, 1))
        self._add(c, c7)
        self._add(c7, c7, (7, 1))
        self._add(c7, c7, (1, 7))
        self._add(c7, c7, (7, 1))
        self._add(c7, 192, (1, 7))
        self._add(c, 192)
        self.out_channels = 4 * 192

    def forward(self, x):
        u = self.unit
        b1 = u(0)(x)
        b2 = u(3)(u(2)(u(1)(x)))
        b3 = u(8)(u(7)(u(6)(u(5)(u(4)(x)))))
        b4 = u(9)(avg_pool_same_3x3(x))
        return torch.cat([b1, b2, b3, b4], 1)


class InceptionD(_Mixed):
    """Grid reduction 17 -> 8."""

    def __init__(self, in_channels, dtype, device):
        super().__init__(dtype, device)
        c = in_channels
        self._add(c, 192)
        self._add(192, 320, (3, 3), (2, 2), "VALID")
        self._add(c, 192)
        self._add(192, 192, (1, 7))
        self._add(192, 192, (7, 1))
        self._add(192, 192, (3, 3), (2, 2), "VALID")
        self.out_channels = 320 + 192 + c

    def forward(self, x):
        u = self.unit
        b1 = u(1)(u(0)(x))
        b2 = u(5)(u(4)(u(3)(u(2)(x))))
        b3 = max_pool(x, 3, 2)
        return torch.cat([b1, b2, b3], 1)


class InceptionE(_Mixed):
    """Expanded filter banks for the 8x8 grid."""

    def __init__(self, in_channels, dtype, device):
        super().__init__(dtype, device)
        c = in_channels
        self._add(c, 320)
        self._add(c, 384)
        self._add(384, 384, (1, 3))
        self._add(384, 384, (3, 1))
        self._add(c, 448)
        self._add(448, 384, (3, 3))
        self._add(384, 384, (1, 3))
        self._add(384, 384, (3, 1))
        self._add(c, 192)
        self.out_channels = 320 + 768 + 768 + 192

    def forward(self, x):
        u = self.unit
        b1 = u(0)(x)
        b2 = u(1)(x)
        b2 = torch.cat([u(2)(b2), u(3)(b2)], 1)
        b3 = u(5)(u(4)(x))
        b3 = torch.cat([u(6)(b3), u(7)(b3)], 1)
        b4 = u(8)(avg_pool_same_3x3(x))
        return torch.cat([b1, b2, b3, b4], 1)


class InceptionV3(_Mixed):
    """Logits ``[N, num_classes]`` (fp32) of NHWC images."""

    def __init__(self, num_classes: int = 1000, dtype=torch.bfloat16,
                 sync_bn_axis=None, device=None, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        device = resolve_device(device)
        super().__init__(dtype, device)
        self.dtype = dtype
        self._add(3, 32, (3, 3), (2, 2), "VALID")
        self._add(32, 32, (3, 3), padding="VALID")
        self._add(32, 64, (3, 3))
        self._add(64, 80)
        c = self._add(80, 192, (3, 3), padding="VALID")
        blocks = []
        for i, pf in enumerate((32, 64, 64)):
            blocks.append((f"InceptionA_{i}",
                           InceptionA(c, pf, dtype, device)))
            c = blocks[-1][1].out_channels
        blocks.append(("InceptionB_0", InceptionB(c, dtype, device)))
        c = blocks[-1][1].out_channels
        for i, c7 in enumerate((128, 160, 160, 192)):
            blocks.append((f"InceptionC_{i}", InceptionC(c, c7, dtype,
                                                         device)))
            c = blocks[-1][1].out_channels
        blocks.append(("InceptionD_0", InceptionD(c, dtype, device)))
        c = blocks[-1][1].out_channels
        for i in range(2):
            blocks.append((f"InceptionE_{i}", InceptionE(c, dtype, device)))
            c = blocks[-1][1].out_channels
        for name, block in blocks:
            self.add_module(name, block)
        self._blocks = [b for _, b in blocks]
        self.Dense_0 = Dense(c, num_classes, device=device)
        reset_parameters(self, make_generator(device, seed, generator))
        set_sync_bn_axis(self, sync_bn_axis)

    def forward(self, x):
        u = self.unit
        x = to_nchw(x, self.dtype)
        x = u(2)(u(1)(u(0)(x)))
        x = max_pool(x, 3, 2)
        x = u(4)(u(3)(x))
        x = max_pool(x, 3, 2)
        for block in self._blocks:
            x = block(x)
        return self.Dense_0(x.mean((2, 3)))
