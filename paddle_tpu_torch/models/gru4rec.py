"""GRU4Rec, session-based next-item recall over the sparse PS path: the
port of ``paddle_tpu.models.gru4rec`` (PaddleRec models/recall/gru4rec).

A GRU (``nn.rnn.GRU``) runs over the session's item embeddings; items
live in the device embedding cache (keys = item ids, one table); training
uses in-batch negatives (DSSM's objective). One step: ONE pull of the
sequence and target rows, the GRU and the projections forward and
backward, the dense update, and ONE push carrying both row sets (the
merge and the ``ctr_sparse_rows_at`` kernel on the card).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..core.device import resolve_device
from ..core.enforce import UnavailableError
from ..nn.layers import Linear
from ..nn.rnn import GRU
from ..ps.embedding_cache import CacheConfig, cache_pull, cache_push
from .ctr import _check_device
from .dssm import DSSM, _l2_normalize

__all__ = ["GRU4Rec", "make_gru4rec_train_step", "item_keys", "export_gru4rec_towers",
           "make_gru4rec_ranker"]

Device = Optional[Union[str, torch.device]]


def item_keys(item_ids: np.ndarray) -> np.ndarray:
    """Item ids → uint64 feasigns (one item table, hi=0)."""
    return np.asarray(item_ids, np.uint64)


class GRU4Rec(nn.Module):
    """forward(seq_emb [B, T, 1+dim], target_emb [..., 1+dim], lengths [B])
    → (session_vec [B, out], item_vec [..., out]), L2-normalized: the
    two-tower contract, so ``DSSM.loss_vec`` scores it unchanged.
    ``item_proj`` is pointwise over the last axis, so a [B, K, 1+dim]
    candidate block goes through as it is."""

    def __init__(self, embedx_dim: int, hidden: int = 32, out_dim: int = 16,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        d = 1 + embedx_dim
        self.gru = GRU(d, hidden, generator=generator)
        self.sess_proj = Linear(hidden, out_dim, generator=generator)
        self.item_proj = Linear(d, out_dim, generator=generator)

    def forward(self, seq_emb: torch.Tensor, target_emb: torch.Tensor,
                lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        _, h_n = self.gru(seq_emb, lengths)
        return _l2_normalize(self.sess_proj(h_n[-1])), _l2_normalize(self.item_proj(target_emb))


def make_gru4rec_train_step(model: GRU4Rec, optimizer, cache_cfg: CacheConfig,
                            temperature: float = 0.1, device: Device = None) -> Callable:
    """step(params, opt_state, cache_state, rows_seq [B, T], rows_target [B],
    lengths [B]) → (params, opt_state, cache_state, loss).

    Padding positions of a sequence carry the capacity sentinel C (zero
    pull, dropped push) and sit past ``lengths`` (the GRU freezes through
    them). Push stats: show 1 per real sequence position and per target,
    click 1 per target. ``device`` defaults to ``"cuda"`` (raises without
    a GPU)."""
    dev = resolve_device(device)

    def step(params, opt_state, cache_state, rows_seq, rows_target, lengths):
        _check_device(rows_seq, dev, "rows_seq")
        B, T = rows_seq.shape
        all_rows = torch.cat([rows_seq.reshape(-1), rows_target])
        pulled = cache_pull(cache_state, all_rows)
        emb_seq = pulled[:B * T].reshape(B, T, -1).detach().requires_grad_(True)
        emb_tgt = pulled[B * T:].detach().requires_grad_(True)
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        u, v = functional_call(model, leaves, (emb_seq, emb_tgt, lengths))
        loss = DSSM.loss_vec((u, v), None, temperature=temperature).mean()
        *g, g_seq, g_tgt = torch.autograd.grad(loss, [*leaves.values(), emb_seq, emb_tgt])
        new_params, new_opt = optimizer.update(dict(zip(leaves, g)), opt_state, params)
        C = cache_state["embed_w"].shape[0]
        ones = torch.ones(B, dtype=torch.float32, device=dev)
        shows = torch.cat([(rows_seq.reshape(-1) < C).to(torch.float32), ones])
        clicks = torch.cat([torch.zeros(B * T, dtype=torch.float32, device=dev), ones])
        with torch.no_grad():
            cache_push(cache_state, all_rows, torch.cat([g_seq.reshape(B * T, -1), g_tgt]),
                       shows, clicks, cache_cfg)
        return new_params, new_opt, cache_state, loss.detach()

    return step


def make_gru4rec_ranker(model: GRU4Rec, params: Optional[Dict[str, torch.Tensor]] = None,
                        device: Device = None) -> Callable:
    """The serving pipeline's ranker: ``rank(hist_emb [B, H, 1+dim], lengths
    [B], cand_emb [B, K, 1+dim]) → scores [B, K]``, the session·candidate
    cosine (numpy in and out, the model on ``device``, default
    ``"cuda"``). ``params``: the model's params dict (default: its own
    parameters, read at each call: a serving process that refreshes the
    towers passes each new dict). Batches are not padded (the JAX
    package pads to a power of two to reuse compiled programs): a row's
    scores do not depend on the others'."""
    dev = resolve_device(device)

    def rank(hist_emb, lengths, cand_emb) -> np.ndarray:
        state = params if params is not None else dict(model.named_parameters())
        state = {k: v.detach().to(dev) for k, v in state.items()}
        hist = torch.from_numpy(np.ascontiguousarray(hist_emb, np.float32)).to(dev)
        cand = torch.from_numpy(np.ascontiguousarray(cand_emb, np.float32)).to(dev)
        lens = torch.from_numpy(np.ascontiguousarray(lengths, np.int64)).to(dev)
        with torch.no_grad():
            u, v = functional_call(model, state, (hist, cand, lens))
            return torch.einsum("bo,bko->bk", u, v).cpu().numpy()

    return rank


def export_gru4rec_towers(*args, **kwargs) -> None:
    """The towers' inference export waits for ``io/inference.py``."""
    raise UnavailableError("export_gru4rec_towers needs io/inference.py, which is not "
                           "ported yet (ROADMAP Queue A item 5)")
