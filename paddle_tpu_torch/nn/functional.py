"""Functional ops of the port's models, with the JAX package's formulas."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.enforce import InvalidArgumentError, enforce

__all__ = ["binary_cross_entropy_with_logits", "cross_entropy", "dropout", "gelu",
           "layer_norm", "relu"]


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def gelu(x: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    """``jax.nn.gelu``: the tanh approximation by default."""
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate else "none")


def dropout(x: torch.Tensor, p: float = 0.5, training: bool = True,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout: keep with probability ``1 - p`` and scale by
    ``1 / (1 - p)``. The identity at ``p <= 0`` or when not training;
    otherwise the keep mask draws from ``generator``, which the caller
    owns (the Trainer seeds one), so a run is reproducible."""
    if not training or p <= 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    enforce(generator is not None,
            "dropout with p > 0 in training needs an explicit torch.Generator",
            InvalidArgumentError)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (1.0 - p)
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """Over the last axis: biased variance, ``(x - mean) * rsqrt(var + eps)``."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, soft_label: bool = False,
                  reduction: str = "mean", ignore_index: int = -100) -> torch.Tensor:
    """Softmax cross entropy over the last axis. Hard labels equal to
    ``ignore_index`` count zero, and ``"mean"`` divides by the number of
    the others (at least 1)."""
    lp = torch.log_softmax(logits, dim=-1)
    if soft_label:
        loss = -(labels * lp).sum(dim=-1)
    else:
        labels = labels.reshape(logits.shape[:-1])
        mask = labels != ignore_index
        idx = torch.where(mask, labels, torch.zeros_like(labels)).to(torch.int64)
        picked = torch.gather(lp, -1, idx[..., None])[..., 0]
        loss = torch.where(mask, -picked, torch.zeros((), dtype=lp.dtype, device=lp.device))
        if reduction == "mean":
            return loss.sum() / torch.clamp(mask.sum(), min=1)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


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
