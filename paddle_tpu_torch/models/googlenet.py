"""GoogLeNet / Inception v1 (reference ``python/paddle/vision/models/
googlenet.py``): parallel 1×1 / 3×3 / 5×5 / pool branches concatenated
on channels, and two auxiliary classifiers.

Port of ``paddle_tpu.models.googlenet`` with its module names
(``stem.0.conv``, ``i3a.b2.1.conv``, ``aux1.fc1``, ...). With
``with_aux`` the forward returns ``(out, aux1, aux2)``; the aux heads
pool to 4×4 at their taps, so they need an input whose taps divide by 4
(128: 8×8; the 224 input's 14×14 taps do not)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.layers import AdaptiveAvgPool2D, Conv2D, Dropout, Linear, MaxPool2D, ReLU

__all__ = ["GoogLeNet", "googlenet"]

Generator = Optional[torch.Generator]


class _ConvReLU(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding: int = 0,
                 generator: Generator = None) -> None:
        super().__init__()
        self.conv = Conv2D(in_ch, out_ch, kernel, stride=stride, padding=padding,
                           generator=generator)
        self.relu = ReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.relu(self.conv(x))


class _Inception(nn.Module):
    def __init__(self, in_ch: int, c1: int, c3r: int, c3: int, c5r: int, c5: int, proj: int,
                 generator: Generator = None) -> None:
        super().__init__()
        g = generator
        self.b1 = _ConvReLU(in_ch, c1, 1, generator=g)
        self.b2 = nn.Sequential(_ConvReLU(in_ch, c3r, 1, generator=g),
                                _ConvReLU(c3r, c3, 3, padding=1, generator=g))
        self.b3 = nn.Sequential(_ConvReLU(in_ch, c5r, 1, generator=g),
                                _ConvReLU(c5r, c5, 5, padding=2, generator=g))
        self.pool = MaxPool2D(3, stride=1, padding=1)
        self.b4 = _ConvReLU(in_ch, proj, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.b1(x), self.b2(x), self.b3(x), self.b4(self.pool(x))], dim=1)


class _AuxHead(nn.Module):
    """A training-time auxiliary classifier (googlenet.py's out1/out2)."""

    def __init__(self, in_ch: int, num_classes: int, generator: Generator = None) -> None:
        super().__init__()
        g = generator
        self.pool = AdaptiveAvgPool2D(4)
        self.conv = _ConvReLU(in_ch, 128, 1, generator=g)
        self.fc1 = Linear(128 * 4 * 4, 1024, generator=g)
        self.relu = ReLU()
        self.drop = Dropout(0.7)
        self.fc2 = Linear(1024, num_classes, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(self.pool(x))
        return self.fc2(self.drop(self.relu(self.fc1(x.reshape(x.shape[0], -1)))))


class GoogLeNet(nn.Module):
    def __init__(self, num_classes: int = 1000, with_aux: bool = False,
                 generator: Generator = None) -> None:
        super().__init__()
        g = generator
        self.num_classes = num_classes
        self.with_aux = with_aux
        self.stem = nn.Sequential(
            _ConvReLU(3, 64, 7, stride=2, padding=3, generator=g),
            MaxPool2D(3, stride=2, padding=1),
            _ConvReLU(64, 64, 1, generator=g), _ConvReLU(64, 192, 3, padding=1, generator=g),
            MaxPool2D(3, stride=2, padding=1))
        self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32, g)
        self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64, g)
        self.pool3 = MaxPool2D(3, stride=2, padding=1)
        self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64, g)
        self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64, g)
        self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64, g)
        self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64, g)
        self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128, g)
        self.pool4 = MaxPool2D(3, stride=2, padding=1)
        self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128, g)
        self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128, g)
        self.avgpool = AdaptiveAvgPool2D(1)
        self.dropout = Dropout(0.4)
        if num_classes > 0:
            self.fc = Linear(1024, num_classes, generator=g)
            if with_aux:
                self.aux1 = _AuxHead(512, num_classes, g)
                self.aux2 = _AuxHead(528, num_classes, g)

    def forward(self, x: torch.Tensor):
        aux = self.with_aux and self.num_classes > 0
        x = self.pool3(self.i3b(self.i3a(self.stem(x))))
        x = self.i4a(x)
        a1 = self.aux1(x) if aux else None
        x = self.i4d(self.i4c(self.i4b(x)))
        a2 = self.aux2(x) if aux else None
        x = self.i5b(self.i5a(self.pool4(self.i4e(x))))
        x = self.dropout(self.avgpool(x))
        if self.num_classes > 0:
            x = self.fc(x.reshape(x.shape[0], -1))
        return (x, a1, a2) if aux else x


def googlenet(**kw) -> GoogLeNet:
    return GoogLeNet(**kw)
