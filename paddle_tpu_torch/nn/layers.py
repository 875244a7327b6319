"""Layers of the port, with the JAX package's parameter names,
initializers and formulas.

Every layer is a ``torch.nn.Module``. Weight layouts: ``Linear`` keeps
torch's ``[out, in]`` (the JAX package keeps ``[in, out]``; ``convert``
transposes), ``Conv2D`` keeps OIHW as both packages do. ``BatchNorm1D``/
``2D`` hold the parameters ``weight``/``bias`` and the buffers
``_mean``/``_variance``; in training mode their forward writes the new
running stats into those buffers in place, so a step that owns copies of
the buffers reads them back after the forward (``executor``).

Initializers draw from an explicit ``torch.Generator`` (``None``: torch's
global one), with the JAX package's distributions: weights of ``Linear``
and ``Conv2D`` uniform in ±1/sqrt(fan_in), biases 0, ``Embedding``
normal / sqrt(dim), BatchNorm's weight 1 and bias 0, its running mean 0
and variance 1.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from . import functional as F

__all__ = ["AdaptiveAvgPool2D", "AvgPool2D", "BCEWithLogitsLoss", "BatchNorm1D",
           "BatchNorm2D", "Conv2D", "CrossEntropyLoss", "Dropout", "Embedding",
           "Flatten", "GELU", "LayerNorm", "Linear", "MSELoss", "MaxPool2D", "ReLU",
           "Sigmoid", "Softmax", "Tanh"]

Generator = Optional[torch.Generator]


def _uniform(shape, fan_in: int, generator: Generator) -> nn.Parameter:
    bound = 1.0 / np.sqrt(max(fan_in, 1))
    w = torch.empty(shape)
    w.uniform_(-bound, bound, generator=generator)
    return nn.Parameter(w)


class Linear(nn.Module):
    """``y = x @ weight.T + bias`` through ``F.linear`` (so it consults
    ``amp``); ``weight`` is ``[out, in]``."""

    def __init__(self, in_features: int, out_features: int, bias_attr: bool = True,
                 generator: Generator = None) -> None:
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = _uniform((out_features, in_features), in_features, generator)
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias_attr else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class Conv2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Sequence[int]], stride=1, padding=0,
                 dilation=1, groups: int = 1, bias_attr: bool = True,
                 generator: Generator = None) -> None:
        super().__init__()
        kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups
        fan_in = in_channels // groups * kh * kw
        self.weight = _uniform((out_channels, in_channels // groups, kh, kw), fan_in, generator)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias_attr else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups)


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0) -> None:
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding)


class AvgPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0) -> None:
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size) -> None:
        super().__init__()
        self.output_size = output_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.adaptive_avg_pool2d(x, self.output_size)


class _BatchNormBase(nn.Module):
    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5) -> None:
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, new_mean, new_var = F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self.momentum, eps=self.epsilon)
        if self.training:
            with torch.no_grad():
                self._mean.copy_(new_mean)
                self._variance.copy_(new_var)
        return y


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 epsilon: float = 1e-5) -> None:
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(tuple(normalized_shape)))
        self.bias = nn.Parameter(torch.zeros(tuple(normalized_shape)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.weight, self.bias, self.epsilon)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, sparse: bool = False,
                 generator: Generator = None) -> None:
        super().__init__()
        self.padding_idx = padding_idx
        self.sparse = sparse  # API parity; the PS tables carry true sparse
        w = torch.empty(num_embeddings, embedding_dim)
        w.normal_(generator=generator)
        self.weight = nn.Parameter(w / np.sqrt(embedding_dim))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight, self.padding_idx)


class Dropout(nn.Module):
    """``generator`` is set by whoever owns the run (``executor.Trainer``
    hands every ``Dropout`` of its model its own seeded generator)."""

    def __init__(self, p: float = 0.5) -> None:
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, self.p, training=self.training, generator=self.generator)


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)


class GELU(nn.Module):
    def forward(self, x):
        return F.gelu(x)


class Sigmoid(nn.Module):
    def forward(self, x):
        return F.sigmoid(x)


class Tanh(nn.Module):
    def forward(self, x):
        return F.tanh(x)


class Softmax(nn.Module):
    def __init__(self, axis: int = -1) -> None:
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)


class Flatten(nn.Module):
    def __init__(self, start_axis: int = 1) -> None:
        super().__init__()
        self.start_axis = start_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis)


class CrossEntropyLoss(nn.Module):
    def __init__(self, reduction: str = "mean", soft_label: bool = False,
                 ignore_index: int = -100) -> None:
        super().__init__()
        self.reduction, self.soft_label, self.ignore_index = reduction, soft_label, ignore_index

    def forward(self, logits, labels):
        return F.cross_entropy(logits, labels, self.soft_label, self.reduction,
                               self.ignore_index)


class MSELoss(nn.Module):
    def __init__(self, reduction: str = "mean") -> None:
        super().__init__()
        self.reduction = reduction

    def forward(self, pred, target):
        return F.mse_loss(pred, target, self.reduction)


class BCEWithLogitsLoss(nn.Module):
    def __init__(self, reduction: str = "mean") -> None:
        super().__init__()
        self.reduction = reduction

    def forward(self, logits, labels):
        return F.binary_cross_entropy_with_logits(logits, labels, self.reduction)
