"""Mixture-of-Experts with expert parallelism.

Port of ``paddle_tpu.parallel.moe`` (the reference's
``incubate/distributed/models/moe``: ``MoELayer``, the gshard top-2 and
switch top-1 gates, ``global_scatter``/``global_gather``). Dispatch is
the GShard fixed-capacity form: tokens go into dense
``[experts, capacity, d]`` buffers (overflow dropped), which one tiled
``all_to_all`` over the ``ep`` axis exchanges so each rank runs its
``num_experts / ep`` local experts on every rank's tokens, and a second
one brings the results back.

The gates keep the JAX package's arithmetic exactly: f32 one-hot masks,
buffer positions from a cumulative sum (exact in f32 below 2^24
tokens), the second expert's tokens placed after every first-expert
token, capacity drop, and the load-balancing aux loss
``E · Σ_e frac_tokens_e · frac_prob_e``. ``torch.argmax`` returns the
first maximum, as ``jnp.argmax`` does, so both route ties alike.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.enforce import enforce_eq
from ..nn import functional as F
from ..ops import collectives as coll

__all__ = ["ExpertFFN", "MoELayer", "top1_gate", "top2_gate"]


def _one_hot(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(x.long(), n).to(torch.float32)


def top1_gate(logits: torch.Tensor, capacity: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Switch-style top-1 gating: (dispatch [T, E, C] one-hot, combine
    [T, E, C] weights, aux loss)."""
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate_p = probs.amax(dim=-1)
    mask = _one_hot(expert, E)
    # each token's position within its expert's capacity buffer
    pos = torch.cumsum(mask, dim=0) * mask - 1.0           # -1 where unrouted
    pos_in_expert = (pos * mask).sum(dim=-1)
    keep = (pos_in_expert >= 0) & (pos_in_expert < capacity)
    pos_clamped = pos_in_expert.clamp(0, capacity - 1).to(torch.int64)
    dispatch = (mask * keep[:, None])[:, :, None] * _one_hot(pos_clamped, capacity)[:, None, :]
    combine = dispatch * gate_p[:, None, None]
    aux = E * (mask.mean(dim=0) * probs.mean(dim=0)).sum()
    return dispatch, combine, aux


def top2_gate(logits: torch.Tensor, capacity: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GShard top-2 gating: the second expert weighted by the
    renormalized probability; both subject to capacity, the second
    expert's tokens after all of the first expert's."""
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    e1 = torch.argmax(probs, dim=-1)
    p1 = probs.amax(dim=-1)
    probs2 = probs * (1.0 - _one_hot(e1, E))
    e2 = torch.argmax(probs2, dim=-1)
    p2 = probs2.amax(dim=-1)
    denom = torch.clamp_min(p1 + p2, 1e-9)
    w1, w2 = p1 / denom, p2 / denom

    mask1, mask2 = _one_hot(e1, E), _one_hot(e2, E)
    pos1 = torch.cumsum(mask1, dim=0) * mask1 - 1.0
    used1 = mask1.sum(dim=0, keepdim=True)                  # tokens per expert via e1
    pos2 = (torch.cumsum(mask2, dim=0) - 1.0 + used1) * mask2

    def build(mask, pos, w):
        p = (pos * mask).sum(dim=-1)
        keep = (mask.sum(dim=-1) > 0) & (p >= 0) & (p < capacity)
        pc = p.clamp(0, capacity - 1).to(torch.int64)
        d = (mask * keep[:, None])[:, :, None] * _one_hot(pc, capacity)[:, None, :]
        return d, d * w[:, None, None]

    d1, c1 = build(mask1, pos1, w1)
    d2, c2 = build(mask2, pos2, w2)
    dispatch = torch.clamp_max(d1 + d2, 1.0)
    combine = c1 + c2
    aux = E * (mask1.mean(dim=0) * probs.mean(dim=0)).sum()
    return dispatch, combine, aux


class ExpertFFN(nn.Module):
    """A rank's bank of local experts, ``w_in`` [E_local, d, h] and
    ``w_out`` [E_local, h, d], applied to all of them in one batched
    product."""

    def __init__(self, num_local_experts: int, d_model: int, d_hidden: int,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.w_in = nn.Parameter(torch.randn((num_local_experts, d_model, d_hidden),
                                             generator=generator) / np.sqrt(d_model))
        self.w_out = nn.Parameter(torch.randn((num_local_experts, d_hidden, d_model),
                                              generator=generator) / np.sqrt(d_hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: [E_local, tokens, d]
        h = F.gelu(torch.einsum("etd,edh->eth", x, self.w_in))
        return torch.einsum("eth,ehd->etd", h, self.w_out)


class MoELayer(nn.Module):
    """Expert-parallel MoE over ``[tokens_local, d]``: each rank holds
    ``num_experts // ep_size`` experts and its own tokens. With ep
    inactive (one rank, or outside ``run_ranks``) it dispatches locally.
    The load-balancing loss of the last forward is the ``aux_loss``
    buffer (the JAX package hands it out the same way)."""

    def __init__(self, d_model: int, d_hidden: int, num_experts: int, ep_size: int = 1,
                 gate: str = "gshard", capacity_factor: float = 1.25,
                 mesh_axis: Optional[str] = "ep",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        enforce_eq(num_experts % max(ep_size, 1), 0, "experts must divide ep size")
        self.num_experts = num_experts
        self.ep_size = max(ep_size, 1)
        self.num_local = num_experts // self.ep_size
        self.capacity_factor = capacity_factor
        self.mesh_axis = mesh_axis if ep_size > 1 else None
        self.gate_fn = {"gshard": top2_gate, "switch": top1_gate, "naive": top1_gate}[gate]
        self.gate_w = nn.Parameter(torch.randn((d_model, num_experts), generator=generator)
                                   * 0.01)
        self.experts = ExpertFFN(self.num_local, d_model, d_hidden, generator)
        self.register_buffer("aux_loss", torch.zeros(()))

    def _capacity(self, tokens: int) -> int:
        top_k = 2 if self.gate_fn is top2_gate else 1
        return max(4, int(math.ceil(tokens * top_k * self.capacity_factor / self.num_experts)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T, _ = x.shape
        dispatch, combine, aux = self.gate_fn(x @ self.gate_w, self._capacity(T))
        self.aux_loss = aux
        expert_in = torch.einsum("tec,td->ecd", dispatch, x)      # [E, C, d]
        active = coll.axis_active(self.mesh_axis)
        if active:
            # → [E_local, ep·C, d]: this rank's experts' buffers from every rank
            expert_in = coll.all_to_all(expert_in, self.mesh_axis, split_axis_=0, concat_axis=1)
        expert_out = self.experts(expert_in)
        if active:
            expert_out = coll.all_to_all(expert_out, self.mesh_axis, split_axis_=1,
                                         concat_axis=0)
        return torch.einsum("tec,ecd->td", combine, expert_out)
