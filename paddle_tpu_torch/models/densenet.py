"""DenseNet (reference ``python/paddle/vision/models/densenet.py``):
dense blocks in which every layer concatenates all earlier feature maps
(BN-ReLU-1×1 bottleneck, then BN-ReLU-3×3 with growth rate k), and
half-channel transitions. Depths 121, 161, 169 and 201.

Port of ``paddle_tpu.models.densenet`` with its module names
(``stem.0``, ``blocks.i.bn1``, ``blocks.i.conv2``, ``bn_final``,
``fc``), BatchNorm buffers included."""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..core.enforce import InvalidArgumentError
from ..nn.layers import AdaptiveAvgPool2D, AvgPool2D, BatchNorm2D, Conv2D, Linear, MaxPool2D, ReLU

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169", "densenet201"]

Generator = Optional[torch.Generator]

_CONFIGS = {
    121: (64, 32, (6, 12, 24, 16)),
    161: (96, 48, (6, 12, 36, 24)),
    169: (64, 32, (6, 12, 32, 32)),
    201: (64, 32, (6, 12, 48, 32)),
}


class _DenseLayer(nn.Module):
    def __init__(self, in_ch: int, growth: int, bn_size: int = 4,
                 generator: Generator = None) -> None:
        super().__init__()
        g = generator
        self.bn1 = BatchNorm2D(in_ch)
        self.conv1 = Conv2D(in_ch, bn_size * growth, 1, bias_attr=False, generator=g)
        self.bn2 = BatchNorm2D(bn_size * growth)
        self.conv2 = Conv2D(bn_size * growth, growth, 3, padding=1, bias_attr=False,
                            generator=g)
        self.relu = ReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(self.relu(self.bn1(x)))
        y = self.conv2(self.relu(self.bn2(y)))
        return torch.cat([x, y], dim=1)


class _Transition(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, generator: Generator = None) -> None:
        super().__init__()
        self.bn = BatchNorm2D(in_ch)
        self.conv = Conv2D(in_ch, out_ch, 1, bias_attr=False, generator=generator)
        self.pool = AvgPool2D(2, stride=2)
        self.relu = ReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pool(self.conv(self.relu(self.bn(x))))


class DenseNet(nn.Module):
    def __init__(self, layers: int = 121, num_classes: int = 1000,
                 generator: Generator = None) -> None:
        super().__init__()
        g = generator
        if layers not in _CONFIGS:
            raise InvalidArgumentError(f"unsupported densenet depth {layers}; "
                                       f"have {sorted(_CONFIGS)}")
        init_ch, growth, blocks = _CONFIGS[layers]
        self.num_classes = num_classes
        self.stem = nn.Sequential(
            Conv2D(3, init_ch, 7, stride=2, padding=3, bias_attr=False, generator=g),
            BatchNorm2D(init_ch), ReLU(), MaxPool2D(3, stride=2, padding=1))
        mods: List[nn.Module] = []
        ch = init_ch
        for bi, n_layers in enumerate(blocks):
            for _ in range(n_layers):
                mods.append(_DenseLayer(ch, growth, generator=g))
                ch += growth
            if bi != len(blocks) - 1:
                mods.append(_Transition(ch, ch // 2, g))
                ch //= 2
        self.blocks = nn.Sequential(*mods)
        self.bn_final = BatchNorm2D(ch)
        self.relu = ReLU()
        self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(ch, num_classes, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.blocks(self.stem(x))
        x = self.pool(self.relu(self.bn_final(x)))
        if self.num_classes > 0:
            x = self.fc(x.reshape(x.shape[0], -1))
        return x


def densenet121(**kw) -> DenseNet:
    return DenseNet(layers=121, **kw)


def densenet161(**kw) -> DenseNet:
    return DenseNet(layers=161, **kw)


def densenet169(**kw) -> DenseNet:
    return DenseNet(layers=169, **kw)


def densenet201(**kw) -> DenseNet:
    return DenseNet(layers=201, **kw)
