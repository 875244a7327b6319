"""AlexNet (reference ``python/paddle/vision/models/alexnet.py``): five
convs and a three-``Linear`` classifier with dropout.

Port of ``paddle_tpu.models.alexnet`` with its module names
(``features.0``, ``classifier.1``, ...), so
``convert.vision_params_from_jax`` carries its weights over name for
name. The 6×6 adaptive pool needs the canonical 224 input."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.layers import AdaptiveAvgPool2D, Conv2D, Dropout, Linear, MaxPool2D, ReLU

__all__ = ["AlexNet", "alexnet"]


class AlexNet(nn.Module):
    def __init__(self, num_classes: int = 1000, dropout: float = 0.5,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        g = generator
        self.num_classes = num_classes
        self.features = nn.Sequential(
            Conv2D(3, 64, 11, stride=4, padding=2, generator=g), ReLU(), MaxPool2D(3, stride=2),
            Conv2D(64, 192, 5, padding=2, generator=g), ReLU(), MaxPool2D(3, stride=2),
            Conv2D(192, 384, 3, padding=1, generator=g), ReLU(),
            Conv2D(384, 256, 3, padding=1, generator=g), ReLU(),
            Conv2D(256, 256, 3, padding=1, generator=g), ReLU(),
            MaxPool2D(3, stride=2))
        self.pool = AdaptiveAvgPool2D(6)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                Dropout(dropout), Linear(256 * 6 * 6, 4096, generator=g), ReLU(),
                Dropout(dropout), Linear(4096, 4096, generator=g), ReLU(),
                Linear(4096, num_classes, generator=g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(x.reshape(x.shape[0], -1))
        return x


def alexnet(**kw) -> AlexNet:
    return AlexNet(**kw)
