"""DIN — the Deep Interest Network over a variable-length behaviour sequence.

Port of ``paddle_tpu.models.din`` (PaddleRec's ``models/rank/din``): the
user's behaviour sequence is pooled by a local activation unit, an MLP
that scores each behaviour against the target, instead of a sum. The
per-position embeddings come from the padded-column layout of the pooled
step (padding positions hold the cache's capacity sentinel C and pull
zeros), and :func:`make_ctr_attention_train_step` hands the model the
real-position mask with them, so the attention excludes padding exactly
(a softmax with padding filled at −1e30, and zero weight on every
position of a row that is all padding), not by trusting padded
embeddings to stay zero.

Column layout: the first ``num_target_cols`` columns are single-valued
target/context slots; the rest are the behaviour sequence. Parameter
names are the JAX package's (``att1``, ``att2``, ``dnn.layers.i``,
``dense_lin``); ``convert.ctr_params_from_jax`` carries them across.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from ..core.device import resolve_device
from ..nn import functional as F
from ..nn.layers import Linear
from ..ps.embedding_cache import CacheConfig
from .ctr import Device, _check_device, _ctr_step_body, _DNN, _weighted_mean

__all__ = ["DIN", "make_ctr_attention_train_step"]


class DIN(nn.Module):
    def __init__(self, num_target_cols: int, num_behavior_cols: int, num_dense: int,
                 embedx_dim: int, dnn_hidden: Tuple[int, ...] = (64, 32),
                 att_hidden: int = 16, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.num_target_cols = num_target_cols
        self.num_behavior_cols = num_behavior_cols
        self.embedx_dim = d = embedx_dim
        # the local activation unit: score(b_j | target) from
        # [target, b_j, target*b_j, target-b_j]
        self.att1 = Linear(4 * d, att_hidden, generator=generator)
        self.att2 = Linear(att_hidden, 1, generator=generator)
        self.dnn = _DNN(num_target_cols * d + d + num_dense, dnn_hidden, generator=generator)
        self.dense_lin = Linear(num_dense, 1, generator=generator)

    def forward(self, emb: torch.Tensor, real: torch.Tensor,
                dense_x: torch.Tensor) -> torch.Tensor:
        """emb [B, T, 1+dim] per-position pulls; real [B, T] 0/1 mask;
        dense_x [B, D] → logits [B]."""
        G = self.num_target_cols
        v = emb[..., 1:]                                    # [B, T, dim]
        target, behav = v[:, :G, :], v[:, G:, :]            # [B, G, dim], [B, Tb, dim]
        bmask = real[:, G:]                                 # [B, Tb]
        t = target.mean(dim=1, keepdim=True).expand_as(behav)   # the target's summary
        feats = torch.cat([t, behav, t * behav, t - behav], dim=-1)   # [B, Tb, 4d]
        scores = self.att2(F.relu(self.att1(feats)))[..., 0]
        scores = torch.where(bmask > 0, scores, torch.full_like(scores, -1e30))
        w = torch.softmax(scores, dim=-1) * (bmask.sum(-1, keepdim=True) > 0)  # all-pad → 0
        interest = torch.einsum("bt,btd->bd", w, behav)
        x = torch.cat([target.reshape(target.shape[0], -1), interest, dense_x], dim=-1)
        first = (emb[..., 0] * real).sum(dim=-1)
        return self.dnn(x) + self.dense_lin(dense_x)[..., 0] + first


def make_ctr_attention_train_step(model: nn.Module, optimizer, cache_cfg: CacheConfig,
                                  device: Device = None) -> Callable:
    """The GPUPS step for attention models over padded columns: the CTR
    family's body (``models.ctr._ctr_step_body``) with ``with_real``, so
    the model takes ``(emb, real, dense_x)`` and the padding positions
    push nothing (show 0; their sentinel row is dropped). Each real
    position receives its own gradient.

    step(params, opt_state, cache_state, rows [B, T], dense_x, labels,
         weights=None) → (params, opt_state, cache_state, loss)

    ``device`` defaults to ``"cuda"`` (raises without a GPU)."""
    dev = resolve_device(device)

    def loss_builder(model_, dense_x, labels, weights, real):
        def loss_fn(params, emb):
            out = functional_call(model_, params, (emb, real, dense_x))
            per = F.binary_cross_entropy_with_logits(out, labels.to(torch.float32),
                                                     reduction="none")
            return _weighted_mean(per, weights)

        return loss_fn

    def step(params, opt_state, cache_state, rows, dense_x, labels, weights=None):
        _check_device(rows, dev, "rows")
        B, T = rows.shape
        return _ctr_step_body(model, optimizer, cache_cfg, params, opt_state, cache_state,
                              rows.reshape(-1), B, T, dense_x, labels, weights,
                              loss_builder=loss_builder, with_real=True)

    return step
