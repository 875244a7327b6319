"""GRU4Rec, session-based next-item recall over the sparse PS path: the
port of ``paddle_tpu.models.gru4rec`` (PaddleRec models/recall/gru4rec).

A GRU (``nn.rnn.GRU``) runs over the session's item embeddings; items
live in the device embedding cache (keys = item ids, one table); training
uses in-batch negatives (DSSM's objective). One step: ONE pull of the
sequence and target rows, the GRU and the projections forward and
backward, the dense update, and ONE push carrying both row sets (the
merge and the ``ctr_sparse_rows_at`` kernel on the card).
``export_gru4rec_towers`` exports the session and item towers for
serving (``io.inference``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..core.device import resolve_device
from ..core.enforce import enforce
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


def export_gru4rec_towers(dirname: str, model: GRU4Rec, cache, max_len: int,
                          refresh_only: bool = False) -> None:
    """The session-recall deployment split: ``<dirname>/session`` serves
    the ONLINE tower — (item lo32 [b, max_len] int64, lengths [b] int64)
    → the normalized session vector — and ``<dirname>/item`` the OFFLINE
    one (item lo32 [b, 1] → normalized item vectors for the ANN index).
    Each is an ``io.inference`` export (``torch.export``, ``b`` dynamic)
    with the PRUNED serving tables (``embed_w``/``embedx_w`` and the
    pass's key map; no optimizer state) and its own tower's params only.
    Out-of-pass and padding ids probe to the sentinel and pull zeros;
    positions past ``lengths`` are frozen by the GRU's length mask, as in
    training. ``max_len`` is the deploy-time session length.

    ``refresh_only=True`` overwrites only the serving values of both
    existing exports (no trace)."""
    import os

    from ..io.inference import refresh_inference_params, save_inference_model
    from .ctr import serving_pull
    from .dssm import _sub_params

    enforce(cache.state is not None, "begin_pass first")
    enforce(cache.device_map is not None,
            "export_gru4rec_towers needs device_map=True on the cache")
    state = {k: v.detach() for k, v in model.named_parameters()}
    dev = cache.state["embed_w"].device
    tables = {"embed_w": cache.state["embed_w"], "embedx_w": cache.state["embedx_w"]}
    map_state = dict(cache.device_map.state)
    # one item table: every key lives in hi = 0 (item_keys)
    sess_hi = torch.zeros(int(max_len), dtype=torch.int64, device=dev)
    item_hi = torch.zeros(1, dtype=torch.int64, device=dev)

    def sess_fn(p, lo32, lengths):
        emb = serving_pull(p["tables"], p["map"], sess_hi, lo32)
        _, h_n = functional_call(model.gru, p["model"]["gru"], (emb, lengths))
        return _l2_normalize(functional_call(model.sess_proj, p["model"]["sess_proj"],
                                             (h_n[-1],)))

    def item_fn(p, lo32):
        emb = serving_pull(p["tables"], p["map"], item_hi, lo32)[:, 0, :]
        return _l2_normalize(functional_call(model.item_proj, p["model"]["item_proj"],
                                             (emb,)))

    towers = (
        ("session", sess_fn, {"gru": _sub_params(state, "gru"),
                              "sess_proj": _sub_params(state, "sess_proj")},
         (torch.zeros((2, int(max_len)), dtype=torch.int64, device=dev),
          torch.full((2,), int(max_len), dtype=torch.int64, device=dev))),
        ("item", item_fn, {"item_proj": _sub_params(state, "item_proj")},
         (torch.zeros((2, 1), dtype=torch.int64, device=dev),)))
    for which, fn, sub_states, example in towers:
        serving = {"model": sub_states, "tables": tables, "map": map_state}
        if refresh_only:
            refresh_inference_params(os.path.join(dirname, which), serving)
            continue
        save_inference_model(os.path.join(dirname, which), fn, serving, example,
                             notes={"lo32": "uint32 item ids carried as int64 in [0, 2^32)"})
