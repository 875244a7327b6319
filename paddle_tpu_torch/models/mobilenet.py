"""The MobileNet family (reference ``python/paddle/vision/models/
mobilenetv1.py`` / ``mobilenetv2.py``): depthwise-separable convolutions
(v1) and inverted residuals with linear bottlenecks (v2). A depthwise
conv is ``Conv2D`` with ``groups`` equal to its channels.

Port of ``paddle_tpu.models.mobilenet`` with its module names
(``features.i.dw.conv``, ``features.i.block.j``, ``classifier.1``, ...);
``_ConvBNReLU`` serves ``shufflenetv2`` too."""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..nn.layers import AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, Linear, ReLU

__all__ = ["MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]

Generator = Optional[torch.Generator]


def _make_divisible(v: float, divisor: int = 8, min_value: Optional[int] = None) -> int:
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _ConvBNReLU(nn.Module):
    """conv (no bias) → BatchNorm → ReLU (unless ``act`` is false)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: bool = True, generator: Generator = None) -> None:
        super().__init__()
        self.conv = Conv2D(in_ch, out_ch, kernel, stride=stride, padding=(kernel - 1) // 2,
                           groups=groups, bias_attr=False, generator=generator)
        self.bn = BatchNorm2D(out_ch)
        self.relu = ReLU() if act else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return self.relu(x) if self.relu is not None else x


class _DepthwiseSeparable(nn.Module):
    """v1 block: depthwise 3×3 then pointwise 1×1."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, generator: Generator = None) -> None:
        super().__init__()
        self.dw = _ConvBNReLU(in_ch, in_ch, 3, stride=stride, groups=in_ch, generator=generator)
        self.pw = _ConvBNReLU(in_ch, out_ch, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw(self.dw(x))


class MobileNetV1(nn.Module):
    """13 depthwise-separable blocks under a width multiplier ``scale``."""

    def __init__(self, scale: float = 1.0, num_classes: int = 1000, with_pool: bool = True,
                 generator: Generator = None) -> None:
        super().__init__()
        g = generator
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return int(ch * scale)

        cfg = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
               (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1)]
        blocks: List[nn.Module] = [_ConvBNReLU(3, c(32), 3, stride=2, generator=g)]
        in_ch = c(32)
        for out_ch, stride in cfg:
            blocks.append(_DepthwiseSeparable(in_ch, c(out_ch), stride, g))
            in_ch = c(out_ch)
        self.features = nn.Sequential(*blocks)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(c(1024), num_classes, generator=g)
        self._out_ch = c(1024)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.reshape(x.shape[0], -1))
        return x


class _InvertedResidual(nn.Module):
    """v2 block: 1×1 expand → depthwise 3×3 → 1×1 linear projection, with
    the residual when the stride is 1 and the shapes match."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, expand: int,
                 generator: Generator = None) -> None:
        super().__init__()
        g = generator
        hidden = int(round(in_ch * expand))
        self.use_res = stride == 1 and in_ch == out_ch
        layers: List[nn.Module] = []
        if expand != 1:
            layers.append(_ConvBNReLU(in_ch, hidden, 1, generator=g))
        layers.append(_ConvBNReLU(hidden, hidden, 3, stride=stride, groups=hidden, generator=g))
        layers.append(Conv2D(hidden, out_ch, 1, bias_attr=False, generator=g))
        layers.append(BatchNorm2D(out_ch))
        self.block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.block(x)
        return x + y if self.use_res else y


class MobileNetV2(nn.Module):
    """The inverted-residual settings table (t, c, n, s) under ``scale``."""

    def __init__(self, scale: float = 1.0, num_classes: int = 1000, with_pool: bool = True,
                 generator: Generator = None) -> None:
        super().__init__()
        g = generator
        self.num_classes = num_classes
        self.with_pool = with_pool
        settings = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_ch = _make_divisible(32 * scale)
        last_ch = _make_divisible(1280 * max(1.0, scale))
        blocks: List[nn.Module] = [_ConvBNReLU(3, in_ch, 3, stride=2, generator=g)]
        for t, ch, n, s in settings:
            out_ch = _make_divisible(ch * scale)
            for i in range(n):
                blocks.append(_InvertedResidual(in_ch, out_ch, s if i == 0 else 1, t, g))
                in_ch = out_ch
        blocks.append(_ConvBNReLU(in_ch, last_ch, 1, generator=g))
        self.features = nn.Sequential(*blocks)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(Dropout(0.2), Linear(last_ch, num_classes,
                                                                 generator=g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.reshape(x.shape[0], -1))
        return x


def mobilenet_v1(scale: float = 1.0, **kw) -> MobileNetV1:
    return MobileNetV1(scale=scale, **kw)


def mobilenet_v2(scale: float = 1.0, **kw) -> MobileNetV2:
    return MobileNetV2(scale=scale, **kw)
