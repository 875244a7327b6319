"""Graph table for graph learning: a sharded host property graph with
seeded neighbour sampling.

The port's own copy of ``paddle_tpu.ps.graph_table`` (the reference's
``distributed/ps/table/common_graph_table.{h,cc}``): nodes with float
features and weighted adjacency, bucketed into shards by
``node_id % shard_num``, sampled with one ``numpy`` generator seeded at
construction, so the same calls on the same seed return the JAX
package's arrays bit for bit. Sampling returns fixed-size padded arrays
with an explicit mask (``sample_neighbors``), the shape a device step
consumes; ``ps.graph_client.DistGraphClient`` keeps the same API over the
PS servers' graph stores.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.enforce import NotFoundError, enforce

__all__ = ["GraphTable", "parse_edge_file"]


def parse_edge_file(path: str, reverse: bool = False
                    ) -> Tuple[List[int], List[int], List[float]]:
    """``src \\t dst [\\t weight]`` per line (common_graph_table.cc
    load_edges format) — the ONE parser both the local table and the
    distributed client load through."""
    srcs: List[int] = []
    dsts: List[int] = []
    ws: List[float] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            s, d = int(parts[0]), int(parts[1])
            if reverse:
                s, d = d, s
            srcs.append(s)
            dsts.append(d)
            ws.append(float(parts[2]) if len(parts) > 2 else 1.0)
    return srcs, dsts, ws


class _GraphShard:
    """common_graph_table.h GraphShard: bucket of nodes with adjacency."""

    def __init__(self) -> None:
        self.neighbors: Dict[int, List[int]] = {}
        self.weights: Dict[int, List[float]] = {}
        self.feat: Dict[int, np.ndarray] = {}


class GraphTable:
    """Sharded property graph with weighted neighbor sampling.

    API parity (common_graph_table.cc): add_graph_node, add_edges
    (build_graph from files), random_sample_neighbors, sample_nodes
    (random_sample_nodes), get/set_node_feat, get_node_degree.
    """

    def __init__(self, shard_num: int = 8, seed: int = 0) -> None:
        enforce(shard_num >= 1, "shard_num >= 1")
        self.shard_num = shard_num
        self._shards = [_GraphShard() for _ in range(shard_num)]
        self._locks = [threading.Lock() for _ in range(shard_num)]
        # numpy Generators are not thread-safe; sampling serializes
        # on this lock (shard data access keeps the per-shard locks)
        self._rng_lock = threading.Lock()
        self._rng = np.random.default_rng(seed)

    def _shard(self, node_id: int) -> Tuple[_GraphShard, threading.Lock]:
        s = int(node_id) % self.shard_num
        return self._shards[s], self._locks[s]

    # -- construction ------------------------------------------------------

    def add_graph_node(self, node_ids: Sequence[int],
                       features: Optional[np.ndarray] = None) -> None:
        for i, nid in enumerate(node_ids):
            shard, lock = self._shard(nid)
            with lock:
                shard.neighbors.setdefault(int(nid), [])
                shard.weights.setdefault(int(nid), [])
                if features is not None:
                    shard.feat[int(nid)] = np.asarray(features[i], np.float32)

    def add_edges(self, src: Sequence[int], dst: Sequence[int],
                  weights: Optional[Sequence[float]] = None) -> None:
        enforce(len(src) == len(dst), "src/dst length mismatch")
        for i in range(len(src)):
            s, d = int(src[i]), int(dst[i])
            w = float(weights[i]) if weights is not None else 1.0
            shard, lock = self._shard(s)
            with lock:
                shard.neighbors.setdefault(s, []).append(d)
                shard.weights.setdefault(s, []).append(w)
            # register the dst node in ITS OWN shard (after releasing the
            # src lock — they may be the same non-reentrant lock)
            dshard, dlock = self._shard(d)
            with dlock:
                dshard.neighbors.setdefault(d, [])
                dshard.weights.setdefault(d, [])

    def load_edges(self, path: str, reverse: bool = False) -> int:
        srcs, dsts, ws = parse_edge_file(path, reverse)
        if srcs:
            self.add_edges(srcs, dsts, ws)
        return len(srcs)

    def load_nodes(self, path: str, feat_dim: Optional[int] = None) -> int:
        """Node file: ``node_id [\\t f0 f1 ...]`` per line."""
        n = 0
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                nid = int(parts[0])
                feat = (np.asarray([float(x) for x in parts[1:]], np.float32)
                        if len(parts) > 1 else None)
                self.add_graph_node(
                    [nid], feat[None, :] if feat is not None else None)
                n += 1
        return n

    # -- queries -----------------------------------------------------------

    def get_node_degree(self, node_ids: Sequence[int]) -> np.ndarray:
        out = np.zeros(len(node_ids), np.int32)
        for i, nid in enumerate(node_ids):
            shard, lock = self._shard(nid)
            with lock:
                out[i] = len(shard.neighbors.get(int(nid), ()))
        return out

    def sample_neighbors(self, node_ids: Sequence[int], sample_size: int,
                         weighted: bool = True
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """random_sample_neighbors: per node, up to ``sample_size``
        neighbors (weighted without replacement when weighted=True).

        Returns ``(neighbors[n, sample_size] int64, mask[n, sample_size]
        bool)`` — padded static shapes for jit consumption."""
        n = len(node_ids)
        nbrs = np.zeros((n, sample_size), np.int64)
        mask = np.zeros((n, sample_size), bool)
        for i, nid in enumerate(node_ids):
            shard, lock = self._shard(nid)
            with lock:
                cand = shard.neighbors.get(int(nid))
                if not cand:
                    continue
                cand = np.asarray(cand, np.int64)
                w = np.asarray(shard.weights.get(int(nid)), np.float64)
            if weighted and w.sum() > 0:
                # zero-weight edges are legal input but unsamplable
                # without replacement — drop them before choice
                nz = w > 0
                cand, w = cand[nz], w[nz]
                k = min(sample_size, len(cand))
                with self._rng_lock:
                    idx = self._rng.choice(len(cand), size=k, replace=False,
                                           p=w / w.sum())
            else:
                k = min(sample_size, len(cand))
                with self._rng_lock:
                    idx = self._rng.choice(len(cand), size=k, replace=False)
            nbrs[i, :k] = cand[idx]
            mask[i, :k] = True
        return nbrs, mask

    def sample_nodes(self, size: int) -> np.ndarray:
        """random_sample_nodes: uniform sample over all node ids."""
        all_ids = self.all_nodes()
        enforce(len(all_ids) > 0, "graph is empty")
        with self._rng_lock:
            return self._rng.choice(all_ids, size=size,
                                    replace=len(all_ids) < size)

    def all_nodes(self) -> np.ndarray:
        ids: List[int] = []
        for shard, lock in zip(self._shards, self._locks):
            with lock:
                ids.extend(shard.neighbors.keys())
        return np.asarray(sorted(ids), np.int64)

    def get_node_feat(self, node_ids: Sequence[int],
                      feat_dim: int) -> np.ndarray:
        out = np.zeros((len(node_ids), feat_dim), np.float32)
        for i, nid in enumerate(node_ids):
            shard, lock = self._shard(nid)
            with lock:
                f = shard.feat.get(int(nid))
            if f is not None:
                out[i, :len(f)] = f[:feat_dim]
        return out

    def set_node_feat(self, node_ids: Sequence[int],
                      features: np.ndarray) -> None:
        for i, nid in enumerate(node_ids):
            shard, lock = self._shard(nid)
            with lock:
                if int(nid) not in shard.neighbors:
                    raise NotFoundError(f"node {nid} not in graph")
                shard.feat[int(nid)] = np.asarray(features[i], np.float32)

    @property
    def node_count(self) -> int:
        return sum(len(s.neighbors) for s in self._shards)

    @property
    def edge_count(self) -> int:
        return sum(len(v) for s in self._shards for v in s.neighbors.values())
