"""TDM, tree-based deep match over the sparse PS path: the port of
``paddle_tpu.models.tdm`` (PaddleRec models/treebased/tdm).

Items live at the leaves of a K-ary tree (``data.index_dataset.TreeIndex``);
training samples per-layer positives (the target's ancestors) and uniform
negatives (``LayerWiseSampler``); every tree NODE owns an embedding in the
sparse PS, and serving walks the tree with beam search, scoring candidates
with the trained user×node tower.

The tree and sampler stay on the host; their fixed-shape outputs feed ONE
step: one pull of the user's behavior leaves and the candidate nodes, the
tower forward and backward (the user is the masked mean of the behavior
leaves), and one push (the merge and ``ctr_sparse_rows_at`` on the card).
Beam search is a host loop over levels around a scorer on the cache's
device. Node keys are the raw tree codes (one node table, hi=0), so user
and candidate share one node embedding space.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..core.device import resolve_device
from ..core.enforce import enforce
from ..data.index_dataset import LayerWiseSampler, TreeIndex
from ..nn import functional as F
from ..ps.embedding_cache import CacheConfig, cache_pull, cache_push
from .ctr import _DNN, _check_device

__all__ = ["TDM", "make_tdm_train_step", "tdm_sample_batch", "beam_search_retrieve",
           "node_keys", "ServingBeamSource"]

Device = Optional[Union[str, torch.device]]


def node_keys(codes: np.ndarray) -> np.ndarray:
    """Tree codes → uint64 feasigns (one node table, hi=0)."""
    return np.asarray(codes, np.uint64)


class TDM(nn.Module):
    """forward(user_emb [B, U, 1+dim], node_emb [B, T, 1+dim], user_real
    [B, U]) → logits [B, T]: the masked-mean user vector of the behavior
    leaves beside each candidate node's embedding, one shared DNN scoring
    every (user, node) pair (PaddleRec tdm's input layer and fc tower)."""

    def __init__(self, embedx_dim: int, hidden: Tuple[int, ...] = (64, 32),
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.dnn = _DNN(2 * (1 + embedx_dim), hidden, out_dim=1, generator=generator)

    def forward(self, user_emb: torch.Tensor, node_emb: torch.Tensor,
                user_real: torch.Tensor) -> torch.Tensor:
        B, T = node_emb.shape[0], node_emb.shape[1]
        w = user_real.to(torch.float32)[:, :, None]
        denom = torch.clamp(w.sum(dim=1), min=1.0)
        user = (user_emb * w).sum(dim=1) / denom                # [B, 1+dim]
        pair = torch.cat([user[:, None, :].expand(B, T, user.shape[-1]), node_emb], dim=-1)
        return self.dnn(pair.reshape(B * T, -1)).reshape(B, T)


def tdm_sample_batch(sampler: LayerWiseSampler, targets: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The sampler's output regrouped to fixed [B, T] (codes, labels f32):
    T is one positive plus min(count_l, layer_size_l - 1) negatives per
    sampled layer."""
    pair, codes, labels = sampler.sample(targets)
    B = len(targets)
    T = len(codes) // B
    enforce(T * B == len(codes),
            "sampler output is not batch-uniform (tree layers smaller "
            "than layer_counts at varying depths?)")
    return codes.reshape(B, T), labels.reshape(B, T).astype(np.float32)


def make_tdm_train_step(model: TDM, optimizer, cache_cfg: CacheConfig,
                        device: Device = None) -> Callable:
    """step(params, opt_state, cache_state, rows_user [B, U], rows_node [B, T],
    labels [B, T]) → (params, opt_state, cache_state, loss).

    Rows come from ``cache.lookup`` over ``node_keys``; sentinel rows
    (padding behavior slots) pull zeros and drop out of the user mean.
    Push stats: show 1 per real behavior leaf and per candidate, click =
    label for candidates. ``device`` defaults to ``"cuda"`` (raises
    without a GPU)."""
    dev = resolve_device(device)

    def step(params, opt_state, cache_state, rows_user, rows_node, labels):
        _check_device(rows_node, dev, "rows_node")
        B, U = rows_user.shape
        T = rows_node.shape[1]
        C = cache_state["embed_w"].shape[0]
        user_real = (rows_user < C).to(torch.float32)
        all_rows = torch.cat([rows_user.reshape(-1), rows_node.reshape(-1)])
        pulled = cache_pull(cache_state, all_rows)
        emb_u = pulled[:B * U].reshape(B, U, -1).detach().requires_grad_(True)
        emb_n = pulled[B * U:].reshape(B, T, -1).detach().requires_grad_(True)
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        out = functional_call(model, leaves, (emb_u, emb_n, user_real))
        loss = F.binary_cross_entropy_with_logits(out, labels, reduction="none").mean()
        *g, g_u, g_n = torch.autograd.grad(loss, [*leaves.values(), emb_u, emb_n])
        new_params, new_opt = optimizer.update(dict(zip(leaves, g)), opt_state, params)
        shows = torch.cat([user_real.reshape(-1),
                           torch.ones(B * T, dtype=torch.float32, device=dev)])
        clicks = torch.cat([torch.zeros(B * U, dtype=torch.float32, device=dev),
                            labels.reshape(-1).to(torch.float32)])
        with torch.no_grad():
            cache_push(cache_state, all_rows,
                       torch.cat([g_u.reshape(B * U, -1), g_n.reshape(B * T, -1)]),
                       shows, clicks, cache_cfg)
        return new_params, new_opt, cache_state, loss.detach()

    return step


def _beam_score(model: TDM, params, state, user_rows, user_real, cand_rows, cand_mask):
    """One level's scores on the state's device (padding candidates -inf)."""
    dim1 = state["embed_w"].shape[1] + state["embedx_w"].shape[1]
    emb_u = cache_pull(state, user_rows.reshape(-1)).reshape(1, -1, dim1)
    emb_n = cache_pull(state, cand_rows.reshape(-1)).reshape(1, cand_rows.shape[1], dim1)
    out = functional_call(model, params, (emb_u, emb_n, user_real))
    return torch.where(cand_mask, out[0], torch.full_like(out[0], -float("inf")))


def beam_search_retrieve(tree: TreeIndex, model: TDM, params: Dict[str, torch.Tensor],
                         cache, user_items: Sequence[int], k: int = 8) -> list:
    """Serving: walk the tree root→leaves keeping the top-``k`` nodes per
    level by the trained score (index_sampler.h BeamSearchSampler's role).
    ``cache``: an ``HbmEmbeddingCache`` or a :class:`ServingBeamSource`
    (``.state`` columns and ``lookup(keys) → host rows``); the scorer runs
    on the device of its state, ``params`` must live there. Returns up to
    ``k`` item ids (the beam's leaves that are items, best first)."""
    state = cache.state
    dev = state["embed_w"].device
    C = state["embed_w"].shape[0]
    user_rows = torch.as_tensor(np.asarray(cache.lookup(node_keys(
        [int(tree.get_travel_codes(i)[0]) for i in user_items])), np.int64),
        device=dev)[None, :]
    # the train step's convention: sentinel rows drop out of the user mean
    user_real = (user_rows < C).to(torch.float32)
    pad_to = k * tree.branch
    beam = [0]  # root
    with torch.no_grad():
        for level in range(1, tree.height + 1):
            cand = [child for b in beam for c in range(tree.branch)
                    if (child := b * tree.branch + 1 + c) < tree.total_node_num()]
            if not cand:
                break
            padded = np.zeros(pad_to, np.int64)
            mask = np.zeros(pad_to, bool)
            padded[:len(cand)] = cache.lookup(node_keys(cand))
            mask[:len(cand)] = True
            s = _beam_score(model, params, state, user_rows, user_real,
                            torch.from_numpy(padded).to(dev)[None, :],
                            torch.from_numpy(mask).to(dev)).cpu().numpy()
            order = np.argsort(-s[:len(cand)])
            beam = [cand[i] for i in order[:k]]
    items = tree.get_items_of_codes(beam)
    return [i for i in items if i is not None][:k]


class ServingBeamSource:
    """The ``cache`` of :func:`beam_search_retrieve` at serve time: node
    embeddings live behind a read-only ``serving.lookup.CachedLookup``;
    this adapter fetches VALUES through it into a fixed-size block of
    device tensors (``state``: ``embed_w [capacity+1, 1]``, ``embedx_w
    [capacity+1, width-1]`` on ``device``, default ``"cuda"``) and
    ``lookup(keys)`` returns host row ids into it.

    Size ``capacity`` past a walk's working set (history leaves plus
    ``k·branch`` candidates per level × height): an overflow FLUSHES the
    block (zeroes it, forgets every slot, ``flushes`` += 1) and fetches
    the whole request again; a single request larger than the block
    raises. Row ``capacity`` stays zero (the sentinel)."""

    def __init__(self, lookup, capacity: int = 1 << 14, device: Device = None) -> None:
        self._lookup = lookup
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        # the row width, from the lookup (a miss reads zeros: shape only)
        width = int(np.asarray(lookup.lookup(np.zeros(1, np.uint64))).shape[1])
        enforce(width >= 2, f"serving rows must be [show ++ embedx], got width {width}")
        self.state = {
            "embed_w": torch.zeros((self.capacity + 1, 1), device=self.device),
            "embedx_w": torch.zeros((self.capacity + 1, width - 1), device=self.device)}
        self._slots: dict = {}
        self._next = 0
        self.flushes = 0

    def lookup(self, keys) -> np.ndarray:
        keys = np.asarray(keys, np.uint64).reshape(-1)
        missing = [int(k) for k in keys if int(k) not in self._slots]
        if missing:
            if self._next + len(missing) > self.capacity:
                enforce(len(missing) <= self.capacity,
                        f"beam working set {len(missing)} exceeds "
                        f"ServingBeamSource capacity {self.capacity}")
                self._slots.clear()
                self._next = 0
                self.state["embed_w"].zero_()
                self.state["embedx_w"].zero_()
                self.flushes += 1
                missing = [int(k) for k in keys]
            vals = torch.from_numpy(np.asarray(self._lookup.lookup(
                np.asarray(missing, np.uint64)), np.float32)).to(self.device)
            slots = np.arange(self._next, self._next + len(missing))
            self._next += len(missing)
            self._slots.update(zip(missing, slots.tolist()))   # a repeated key: the last slot
            idx = torch.from_numpy(slots).to(self.device)
            self.state["embed_w"][idx] = vals[:, :1]
            self.state["embedx_w"][idx] = vals[:, 1:]
        return np.asarray([self._slots[int(k)] for k in keys], np.int64)
