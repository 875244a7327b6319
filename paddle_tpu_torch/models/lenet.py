"""LeNet-5, the first rung of the model ladder (MNIST on one device).

Port of ``paddle_tpu.models.lenet`` with its parameter names
(``features.0``, ``features.3``, ``fc.0``–``fc.2``), so ``convert``
carries the JAX model's weights over name for name."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.layers import Conv2D, Linear, MaxPool2D, ReLU

__all__ = ["LeNet"]


class LeNet(nn.Module):
    def __init__(self, num_classes: int = 10,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        g = generator
        self.features = nn.Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, generator=g), ReLU(), MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, generator=g), ReLU(), MaxPool2D(2, 2))
        self.fc = nn.Sequential(Linear(400, 120, generator=g), Linear(120, 84, generator=g),
                                Linear(84, num_classes, generator=g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x)
        return self.fc(x.reshape(x.shape[0], -1))
