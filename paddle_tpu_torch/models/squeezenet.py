"""SqueezeNet 1.0 and 1.1 (reference
``python/paddle/vision/models/squeezenet.py``): fire modules, a 1×1
squeeze and parallel 1×1/3×3 expands concatenated on channels.

Port of ``paddle_tpu.models.squeezenet`` with its module names
(``features.3.squeeze``, ``classifier.1``, ...)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.enforce import InvalidArgumentError
from ..nn.layers import AdaptiveAvgPool2D, Conv2D, Dropout, MaxPool2D, ReLU

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(nn.Module):
    def __init__(self, in_ch: int, squeeze: int, e1: int, e3: int,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        g = generator
        self.squeeze = Conv2D(in_ch, squeeze, 1, generator=g)
        self.relu = ReLU()
        self.e1 = Conv2D(squeeze, e1, 1, generator=g)
        self.e3 = Conv2D(squeeze, e3, 3, padding=1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.relu(self.squeeze(x))
        return torch.cat([self.relu(self.e1(x)), self.relu(self.e3(x))], dim=1)


class SqueezeNet(nn.Module):
    def __init__(self, version: str = "1.0", num_classes: int = 1000,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        g = generator
        self.num_classes = num_classes
        if version == "1.0":
            self.features = nn.Sequential(
                Conv2D(3, 96, 7, stride=2, generator=g), ReLU(), MaxPool2D(3, stride=2),
                _Fire(96, 16, 64, 64, g), _Fire(128, 16, 64, 64, g),
                _Fire(128, 32, 128, 128, g), MaxPool2D(3, stride=2),
                _Fire(256, 32, 128, 128, g), _Fire(256, 48, 192, 192, g),
                _Fire(384, 48, 192, 192, g), _Fire(384, 64, 256, 256, g),
                MaxPool2D(3, stride=2), _Fire(512, 64, 256, 256, g))
        elif version == "1.1":
            self.features = nn.Sequential(
                Conv2D(3, 64, 3, stride=2, generator=g), ReLU(), MaxPool2D(3, stride=2),
                _Fire(64, 16, 64, 64, g), _Fire(128, 16, 64, 64, g), MaxPool2D(3, stride=2),
                _Fire(128, 32, 128, 128, g), _Fire(256, 32, 128, 128, g),
                MaxPool2D(3, stride=2),
                _Fire(256, 48, 192, 192, g), _Fire(384, 48, 192, 192, g),
                _Fire(384, 64, 256, 256, g), _Fire(512, 64, 256, 256, g))
        else:
            raise InvalidArgumentError(f"unknown squeezenet version {version!r}")
        if num_classes > 0:
            self.classifier = nn.Sequential(
                Dropout(0.5), Conv2D(512, num_classes, 1, generator=g), ReLU())
        self.pool = AdaptiveAvgPool2D(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        x = self.pool(x)
        return x.reshape(x.shape[0], -1)


def squeezenet1_0(**kw) -> SqueezeNet:
    return SqueezeNet(version="1.0", **kw)


def squeezenet1_1(**kw) -> SqueezeNet:
    return SqueezeNet(version="1.1", **kw)
