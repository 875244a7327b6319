"""Layers of the port that ``torch.nn`` has in another form: the JAX
package's ``LayerNorm`` (``weight``/``bias``, eps 1e-5, its formula) and
``Dropout`` (explicit generator)."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from . import functional as F

__all__ = ["Dropout", "LayerNorm"]


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


class Dropout(nn.Module):
    """``generator`` is set by whoever owns the run (``executor.Trainer``
    hands every ``Dropout`` of its model its own seeded generator)."""

    def __init__(self, p: float = 0.5) -> None:
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, self.p, training=self.training, generator=self.generator)
