"""The ResNet family, the second rung of the model ladder (ResNet-50 on
ImageNet).

Port of ``paddle_tpu.models.resnet``: NCHW, OIHW convs without bias,
BatchNorm after each, the JAX package's module names (``conv1``,
``bn1``, ``layer1.0.conv2``, ``layer2.0.downsample.0``, ``fc``, ...), so
``convert.vision_params_from_jax`` carries its weights and running stats
over name for name."""

from __future__ import annotations

from typing import List, Optional, Type

import torch
from torch import nn

from ..nn.layers import AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear, MaxPool2D, ReLU

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152"]

Generator = Optional[torch.Generator]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, ch: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None, generator: Generator = None) -> None:
        super().__init__()
        g = generator
        self.conv1 = Conv2D(in_ch, ch, 3, stride=stride, padding=1, bias_attr=False, generator=g)
        self.bn1 = BatchNorm2D(ch)
        self.conv2 = Conv2D(ch, ch, 3, stride=1, padding=1, bias_attr=False, generator=g)
        self.bn2 = BatchNorm2D(ch)
        self.relu = ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = self.downsample(x) if self.downsample is not None else x
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, ch: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None, generator: Generator = None) -> None:
        super().__init__()
        g = generator
        self.conv1 = Conv2D(in_ch, ch, 1, bias_attr=False, generator=g)
        self.bn1 = BatchNorm2D(ch)
        self.conv2 = Conv2D(ch, ch, 3, stride=stride, padding=1, bias_attr=False, generator=g)
        self.bn2 = BatchNorm2D(ch)
        self.conv3 = Conv2D(ch, ch * 4, 1, bias_attr=False, generator=g)
        self.bn3 = BatchNorm2D(ch * 4)
        self.relu = ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = self.downsample(x) if self.downsample is not None else x
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + identity)


class ResNet(nn.Module):
    def __init__(self, block: Type[nn.Module], depth_cfg: List[int], num_classes: int = 1000,
                 in_channels: int = 3, generator: Generator = None) -> None:
        super().__init__()
        self.conv1 = Conv2D(in_channels, 64, 7, stride=2, padding=3, bias_attr=False,
                            generator=generator)
        self.bn1 = BatchNorm2D(64)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(3, 2, padding=1)
        self._in_ch = 64
        self.layer1 = self._make_layer(block, 64, depth_cfg[0], 1, generator)
        self.layer2 = self._make_layer(block, 128, depth_cfg[1], 2, generator)
        self.layer3 = self._make_layer(block, 256, depth_cfg[2], 2, generator)
        self.layer4 = self._make_layer(block, 512, depth_cfg[3], 2, generator)
        self.avgpool = AdaptiveAvgPool2D(1)
        self.fc = Linear(512 * block.expansion, num_classes, generator=generator)

    def _make_layer(self, block, ch: int, depth: int, stride: int,
                    g: Generator) -> nn.Sequential:
        downsample = None
        if stride != 1 or self._in_ch != ch * block.expansion:
            downsample = nn.Sequential(
                Conv2D(self._in_ch, ch * block.expansion, 1, stride=stride, bias_attr=False,
                       generator=g),
                BatchNorm2D(ch * block.expansion))
        layers = [block(self._in_ch, ch, stride, downsample, generator=g)]
        self._in_ch = ch * block.expansion
        for _ in range(1, depth):
            layers.append(block(self._in_ch, ch, generator=g))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.avgpool(x)
        return self.fc(x.reshape(x.shape[0], -1))


def resnet18(num_classes: int = 1000, generator: Generator = None) -> ResNet:
    return ResNet(BasicBlock, [2, 2, 2, 2], num_classes, generator=generator)


def resnet34(num_classes: int = 1000, generator: Generator = None) -> ResNet:
    return ResNet(BasicBlock, [3, 4, 6, 3], num_classes, generator=generator)


def resnet50(num_classes: int = 1000, generator: Generator = None) -> ResNet:
    return ResNet(BottleneckBlock, [3, 4, 6, 3], num_classes, generator=generator)


def resnet101(num_classes: int = 1000, generator: Generator = None) -> ResNet:
    return ResNet(BottleneckBlock, [3, 4, 23, 3], num_classes, generator=generator)


def resnet152(num_classes: int = 1000, generator: Generator = None) -> ResNet:
    return ResNet(BottleneckBlock, [3, 8, 36, 3], num_classes, generator=generator)
