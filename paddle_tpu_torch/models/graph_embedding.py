"""DeepWalk / skip-gram graph embeddings over the sparse PS path.

Port of ``paddle_tpu.models.graph_embedding`` (the reference's
graph-learning loop, graph4rec: ``GraphDataGenerator`` pulls deepwalk
walks from the GPU graph table, windows them into skip-gram pairs on the
device and trains a sparse embedding through the PS). One step, in the
JAX package's order:

  walk (``DeviceGraph.random_walk``) → window pairing (static shifts) →
  negative draws → cuckoo key→row probe → ``cache_pull`` → SGNS loss
  forward and backward → ``cache_push``

On the card the push is the merge kernel and B1 in place
(``ps.embedding_cache.cache_push_sparse``: ``ctr_sparse_rows_at``); the
rest are torch ops around it. Like every port cache step it updates the
cache's columns in place and returns the same dict.

Two logical embedding tables (skip-gram's center and context matrices)
live in ONE ``HbmEmbeddingCache`` by slot-tagging the node key's high
half (center = slot 0, context = slot 1), the tagged-key layout of the
CTR steps. Negatives are uniform over the pass's node pool.

The walk's and the negatives' draws come from the ``torch.Generator``
the caller passes (JAX splits a ``jax.random`` key), so the walks and
negatives are not the JAX package's: given the same walks and negative
indices the step's loss and cache agree with it
(``tests/test_torch_graph_embedding.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as tf

from ..core.enforce import enforce
from ..ops.device_graph import DeviceGraph
from ..ps.device_hash import device_hash_lookup
from ..ps.embedding_cache import CacheConfig, cache_pull, cache_push

__all__ = ["DeepWalkConfig", "tag_center", "tag_context", "make_deepwalk_train_step",
           "init_node_embeddings", "node_embeddings", "link_prediction_auc"]

CENTER_SLOT = np.uint32(0)
CONTEXT_SLOT = np.uint32(1)


@dataclasses.dataclass
class DeepWalkConfig:
    walk_len: int = 8          # steps per walk (walk has walk_len+1 nodes)
    window: int = 2            # skip-gram window radius
    negatives: int = 4         # negative draws per positive pair
    embed_dim: int = 16        # must equal cache embedx_dim


def tag_center(nodes: np.ndarray) -> np.ndarray:
    """uint64 feasigns for the center/input embedding table."""
    return (np.uint64(CENTER_SLOT) << np.uint64(32)) | np.asarray(nodes, np.uint64)


def tag_context(nodes: np.ndarray) -> np.ndarray:
    """uint64 feasigns for the context/output embedding table."""
    return (np.uint64(CONTEXT_SLOT) << np.uint64(32)) | np.asarray(nodes, np.uint64)


def _pairs_from_walks(wh, wl, live, window: int):
    """Static-shift window pairing: walks [B, T] → (center hi, center lo,
    context hi, context lo, valid) each [B, T-1, 2*window]. Pair (t, t+d)
    is valid when the walk was still live at t+d (dead ends freeze and
    must not produce self-pairs); both directions are emitted; short
    shifts are zero-padded (and invalid)."""
    B, T = wh.shape
    ch, cl, xh, xl, ok = [], [], [], [], []
    for d in range(1, window + 1):
        if d >= T:
            break
        v = live[:, d:]
        # forward: center t, context t+d
        ch.append(wh[:, :-d]); cl.append(wl[:, :-d])
        xh.append(wh[:, d:]); xl.append(wl[:, d:])
        ok.append(v)
        # backward: center t+d, context t
        ch.append(wh[:, d:]); cl.append(wl[:, d:])
        xh.append(wh[:, :-d]); xl.append(wl[:, :-d])
        ok.append(v)

    def cat(xs):
        return torch.stack([tf.pad(x, (0, (T - 1) - x.shape[1])) for x in xs], dim=2)

    return cat(ch), cat(cl), cat(xh), cat(xl), cat([o.to(torch.float32) for o in ok])


def _negative_indices(generator: torch.Generator, n_pairs: int, k: int, pool: int,
                      device: torch.device) -> torch.Tensor:
    """[n_pairs, k] uniform indices into the node pool."""
    return torch.randint(0, pool, (n_pairs, k), generator=generator, device=device)


def make_deepwalk_train_step(graph: DeviceGraph, cache_cfg: CacheConfig, cfg: DeepWalkConfig,
                             pool_lo: np.ndarray) -> Callable:
    """Build the walk → pair → SGNS → push step::

        step(cache_state, map_state, start_lo, generator) → (cache_state, loss)

    ``start_lo``: [B] int64 low-32 node ids to start walks from (node ids
    are < 2^32, the graph table's convention; the slot tag supplies the
    high half). ``map_state``: the embedding cache's device key map (both
    tagged key sets must be in the pass). ``pool_lo``: [N] low halves of
    the pass's node ids, the negatives' pool. Runs on the graph's device;
    ``generator`` (of that device) draws the walks, then the negatives.
    ``cache_state`` is updated in place and returned."""
    enforce(cfg.embed_dim == cache_cfg.embedx_dim,
            "DeepWalkConfig.embed_dim must equal cache embedx_dim")
    W, K, L = int(cfg.window), int(cfg.negatives), int(cfg.walk_len)
    gstate = graph.state
    dev = gstate["cdf"].device
    pool_lo_d = torch.from_numpy(np.asarray(pool_lo, np.uint32).astype(np.int64)).to(dev)

    def step(cache_state, map_state, start_lo, generator):
        B = start_lo.shape[0]
        hi0 = torch.zeros(B, dtype=torch.int64, device=dev)   # raw node keys walk the graph
        wh, wl, live = DeviceGraph.random_walk(gstate, generator, hi0, start_lo.to(torch.int64),
                                               L)
        _, cl, _, xl, valid = _pairs_from_walks(wh, wl, live, W)
        P = cl.numel()
        cl_f, xl_f, valid_f = cl.reshape(-1), xl.reshape(-1), valid.reshape(-1)
        nl_f = pool_lo_d[_negative_indices(generator, P, K, pool_lo_d.shape[0], dev)]  # [P, K]
        C = cache_state["embed_w"].shape[0]

        def rows_of(tag, lo):
            hi = torch.full((lo.numel(),), int(tag), dtype=torch.int64, device=dev)
            r = device_hash_lookup(map_state, hi, lo.reshape(-1))
            return torch.where(r >= 0, r, C).reshape(lo.shape)

        # invalid pairs (dead-end masked AND the zero padding of short
        # window shifts) take the sentinel row: a padded lo of 0 would
        # otherwise resolve to REAL node 0's row, whose optimizer state a
        # decaying rule (Adam) would advance every step
        live_pair = valid_f > 0
        rows_c = torch.where(live_pair, rows_of(CENTER_SLOT, cl_f), C)
        rows_x = torch.where(live_pair, rows_of(CONTEXT_SLOT, xl_f), C)
        rows_n = torch.where(live_pair[:, None], rows_of(CONTEXT_SLOT, nl_f), C)
        all_rows = torch.cat([rows_c, rows_x, rows_n.reshape(-1)])

        d = cfg.embed_dim
        pulled = cache_pull(cache_state, all_rows).requires_grad_(True)
        with torch.enable_grad():
            vc = pulled[:P, 1:1 + d]                                  # centers
            vx = pulled[P:2 * P, 1:1 + d]                             # contexts
            vn = pulled[2 * P:, 1:1 + d].reshape(P, K, d)             # negatives
            pos = (vc * vx).sum(dim=-1)
            neg = torch.einsum("pd,pkd->pk", vc, vn)
            # SGNS: -log σ(pos) - Σ log σ(-neg), masked by pair validity,
            # SUMMED over pairs: word2vec applies the full gradient per
            # (center, context) sample, and the sparse rule's show scale
            # already averages over a key's appearances
            per = tf.softplus(-pos) + tf.softplus(neg).sum(dim=-1)
            total = (per * valid_f).sum()
            (g_pulled,) = torch.autograd.grad(total, pulled)
        loss = total.detach() / torch.clamp_min(valid_f.sum(), 1.0)

        # push: show=1 per valid appearance (negatives count as
        # appearances of the context table), click=0
        shows = torch.cat([valid_f, valid_f, torch.repeat_interleave(valid_f, K)])
        clicks = torch.zeros_like(shows)
        cache_push(cache_state, all_rows, g_pulled, shows, clicks, cache_cfg)
        return cache_state, loss

    return step


def init_node_embeddings(table, nodes: np.ndarray, rng: np.random.Generator,
                         scale: float = 0.1) -> None:
    """Force-create both tagged tables' rows with uniform ±scale embedx
    (word2vec-style init). SGNS is bilinear: zero embeddings are an exact
    saddle (every gradient is zero), so the lazy zero-create never starts
    learning. Call once before the first ``begin_pass``."""
    acc = table.accessor
    es = acc.embed_rule.state_dim
    xd = acc.config.embedx_dim
    for tag in (tag_center, tag_context):
        keys = tag(nodes)
        vals, _ = table.export_full(keys, create=True)
        vals[:, 6 + es] = 1.0  # has_embedx
        vals[:, 7 + es: 7 + es + xd] = rng.uniform(
            -scale, scale, (len(keys), xd)).astype(np.float32)
        table.import_full(keys, vals)


def node_embeddings(cache, nodes: np.ndarray) -> np.ndarray:
    """The center-table embeddings of ``nodes`` (a host-side eval helper,
    through the cache's host index)."""
    rows = torch.from_numpy(np.asarray(cache.lookup(tag_center(nodes)), np.int64))
    emb = cache_pull(cache.state, rows.to(cache.state["embed_w"].device))
    return emb.cpu().numpy()[:, 1:]


def link_prediction_auc(cache, edges: np.ndarray, non_edges: np.ndarray) -> float:
    """AUC of cosine-similarity scores: true edges against non-edges (the
    standard deepwalk evaluation; both inputs are [n, 2] node-id arrays)."""
    def score(pairs):
        a = node_embeddings(cache, pairs[:, 0])
        b = node_embeddings(cache, pairs[:, 1])
        na = np.linalg.norm(a, axis=1) + 1e-9
        nb = np.linalg.norm(b, axis=1) + 1e-9
        return np.sum(a * b, axis=1) / (na * nb)

    pos, neg = score(edges), score(non_edges)
    # exact pairwise AUC (small eval sets)
    return float(np.mean((pos[:, None] > neg[None, :]).astype(np.float64)
                         + 0.5 * (pos[:, None] == neg[None, :])))
