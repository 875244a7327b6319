"""Functional ops DeepFM needs, with the JAX package's formulas."""

from __future__ import annotations

import torch

__all__ = ["binary_cross_entropy_with_logits", "relu"]


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def binary_cross_entropy_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                                     reduction: str = "mean") -> torch.Tensor:
    """``max(x, 0) - x*y + log1p(exp(-|x|))``, the formula of
    ``paddle_tpu.nn.functional.binary_cross_entropy_with_logits``."""
    labels = labels.to(logits.dtype)
    loss = (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss
