"""Plain softmax attention on local blocks.

Port of ``local_attention`` from ``paddle_tpu.parallel.ring_attention``:
the JAX package's einsum path for ERNIE off the TPU, and the oracle of
the flash-attention kernels (``ops.flash_attention``). ``ring_attention``
and ``ring_flash_attention`` (context parallelism over a ``cp`` axis)
come with the distributed slice.
"""

from __future__ import annotations

import torch

__all__ = ["local_attention"]


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, q_offset: int = 0,
                    k_offset: int = 0) -> torch.Tensor:
    """Softmax attention in the [B, L, H, D] layout, in the inputs' type.
    ``causal`` masks key positions ``k_offset + j`` above query positions
    ``q_offset + i``; a row with no key left is NaN, as in the JAX
    package."""
    D = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=q.dtype))  # rounded as jnp does
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale.to(q.device)
    if causal:
        qi = torch.arange(q.shape[1], device=q.device)[:, None] + q_offset
        ki = torch.arange(k.shape[1], device=q.device)[None, :] + k_offset
        scores = torch.where(ki <= qi, scores,
                             torch.tensor(float("-inf"), dtype=scores.dtype, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
