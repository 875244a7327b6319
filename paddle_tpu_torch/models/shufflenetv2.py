"""ShuffleNetV2 (reference ``python/paddle/vision/models/
shufflenetv2.py``): units that split the channels, transform one half
and shuffle them back together.

Port of ``paddle_tpu.models.shufflenetv2`` with its module names
(``stem.0.conv``, ``stages.i.branch.j``, ``stages.i.short.j``, ``head``,
``fc``). The channel shuffle is a reshape and a transpose."""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..core.enforce import InvalidArgumentError
from ..nn.layers import AdaptiveAvgPool2D, Linear, MaxPool2D
from .mobilenet import _ConvBNReLU

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
           "shufflenet_v2_x1_5", "shufflenet_v2_x2_0"]

_STAGE_OUT = {
    0.25: (24, 24, 48, 96, 512),
    0.5: (24, 48, 96, 192, 1024),
    1.0: (24, 116, 232, 464, 1024),
    1.5: (24, 176, 352, 704, 1024),
    2.0: (24, 244, 488, 976, 2048),
}
_REPEATS = (4, 8, 4)


def _channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    n, c, h, w = x.shape
    x = x.reshape(n, groups, c // groups, h, w).transpose(1, 2)
    return x.reshape(n, c, h, w)


class _ShuffleUnit(nn.Module):
    """Stride 1: split the channels, transform one half, concatenate,
    shuffle. Stride 2: both halves transformed (no split), downsampled."""

    def __init__(self, in_ch: int, out_ch: int, stride: int,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        g = generator
        self.stride = stride
        branch_ch = out_ch // 2
        if stride == 1:
            self.branch = nn.Sequential(
                _ConvBNReLU(in_ch // 2, branch_ch, 1, generator=g),
                _ConvBNReLU(branch_ch, branch_ch, 3, groups=branch_ch, act=False, generator=g),
                _ConvBNReLU(branch_ch, branch_ch, 1, generator=g))
        else:
            self.short = nn.Sequential(
                _ConvBNReLU(in_ch, in_ch, 3, stride=2, groups=in_ch, act=False, generator=g),
                _ConvBNReLU(in_ch, branch_ch, 1, generator=g))
            self.branch = nn.Sequential(
                _ConvBNReLU(in_ch, branch_ch, 1, generator=g),
                _ConvBNReLU(branch_ch, branch_ch, 3, stride=2, groups=branch_ch, act=False,
                            generator=g),
                _ConvBNReLU(branch_ch, branch_ch, 1, generator=g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            half = x.shape[1] // 2
            out = torch.cat([x[:, :half], self.branch(x[:, half:])], dim=1)
        else:
            out = torch.cat([self.short(x), self.branch(x)], dim=1)
        return _channel_shuffle(out)


class ShuffleNetV2(nn.Module):
    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        g = generator
        if scale not in _STAGE_OUT:
            raise InvalidArgumentError(f"unsupported scale {scale}; have {sorted(_STAGE_OUT)}")
        c0, c1, c2, c3, c_last = _STAGE_OUT[scale]
        self.num_classes = num_classes
        self.stem = nn.Sequential(_ConvBNReLU(3, c0, 3, stride=2, generator=g),
                                  MaxPool2D(3, stride=2, padding=1))
        mods: List[nn.Module] = []
        in_ch = c0
        for out_ch, reps in zip((c1, c2, c3), _REPEATS):
            mods.append(_ShuffleUnit(in_ch, out_ch, stride=2, generator=g))
            for _ in range(reps - 1):
                mods.append(_ShuffleUnit(out_ch, out_ch, stride=1, generator=g))
            in_ch = out_ch
        self.stages = nn.Sequential(*mods)
        self.head = _ConvBNReLU(in_ch, c_last, 1, generator=g)
        self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(c_last, num_classes, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pool(self.head(self.stages(self.stem(x))))
        if self.num_classes > 0:
            x = self.fc(x.reshape(x.shape[0], -1))
        return x


def shufflenet_v2_x0_25(**kw) -> ShuffleNetV2:
    return ShuffleNetV2(scale=0.25, **kw)


def shufflenet_v2_x0_5(**kw) -> ShuffleNetV2:
    return ShuffleNetV2(scale=0.5, **kw)


def shufflenet_v2_x1_0(**kw) -> ShuffleNetV2:
    return ShuffleNetV2(scale=1.0, **kw)


def shufflenet_v2_x1_5(**kw) -> ShuffleNetV2:
    return ShuffleNetV2(scale=1.5, **kw)


def shufflenet_v2_x2_0(**kw) -> ShuffleNetV2:
    return ShuffleNetV2(scale=2.0, **kw)
