"""The VGG family (reference ``python/paddle/vision/models/vgg.py``):
configurations A/B/D/E (``vgg11``/``13``/``16``/``19``), optional
BatchNorm after each conv, a 4096-wide classifier.

Port of ``paddle_tpu.models.vgg`` with its module names (``features.i``,
``classifier.i``), so ``convert.vision_params_from_jax`` carries its
weights and BatchNorm buffers over name for name. The classifier takes
512·7·7 features: 224 inputs (7×7 after five pools)."""

from __future__ import annotations

from typing import List, Optional, Union

import torch
from torch import nn

from ..nn.layers import AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, Linear, MaxPool2D, ReLU

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

Generator = Optional[torch.Generator]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
          512, "M", 512, 512, 512, 512, "M"],
}


def _make_features(cfg: List[Union[int, str]], batch_norm: bool,
                   generator: Generator = None) -> nn.Sequential:
    layers: List[nn.Module] = []
    in_ch = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, stride=2))
            continue
        layers.append(Conv2D(in_ch, v, 3, padding=1, generator=generator))
        if batch_norm:
            layers.append(BatchNorm2D(v))
        layers.append(ReLU())
        in_ch = v
    return nn.Sequential(*layers)


class VGG(nn.Module):
    def __init__(self, features: nn.Sequential, num_classes: int = 1000,
                 with_pool: bool = True, generator: Generator = None) -> None:
        super().__init__()
        g = generator
        self.features = features
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(7)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                Linear(512 * 7 * 7, 4096, generator=g), ReLU(), Dropout(0.5),
                Linear(4096, 4096, generator=g), ReLU(), Dropout(0.5),
                Linear(4096, num_classes, generator=g))
        self.num_classes = num_classes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.reshape(x.shape[0], -1))
        return x


def _vgg(cfg: str, batch_norm: bool, generator: Generator = None, **kw) -> VGG:
    return VGG(_make_features(_CFGS[cfg], batch_norm, generator), generator=generator, **kw)


def vgg11(batch_norm: bool = False, **kw) -> VGG:
    return _vgg("A", batch_norm, **kw)


def vgg13(batch_norm: bool = False, **kw) -> VGG:
    return _vgg("B", batch_norm, **kw)


def vgg16(batch_norm: bool = False, **kw) -> VGG:
    return _vgg("D", batch_norm, **kw)


def vgg19(batch_norm: bool = False, **kw) -> VGG:
    return _vgg("E", batch_norm, **kw)
