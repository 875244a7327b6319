"""Distributed graph sampling over the PS transport.

The port's own copy of ``paddle_tpu.ps.graph_client``: the reference
serves ``common_graph_table.cc`` through a graph brpc service; here the
native graph store (``csrc/graph_store.h``) lives inside the port's TCP
PS service (``csrc/ps_service.cc``, commands ``kCreateGraph`` …
``kGraphStats``), and :class:`DistGraphClient` keeps
``ps.graph_table.GraphTable``'s API (padded fixed-shape results), so a
sampling loop swaps a local table for the distributed one unchanged.

Partitioning, as in the JAX package: node id → server ``id % num_servers``
(``_route``); an edge lives with its SRC node, and ``add_edges`` also
registers each dst node on its own owner. The client rides a connected
:class:`~paddle_tpu_torch.ps.rpc.RpcPsClient` (its deadlines, retries and
reconnects).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.enforce import NotFoundError, enforce
from .rpc import RpcPsClient, _long_ms

__all__ = ["DistGraphClient"]

# command ids (ps_service.cc Cmd enum, graph block)
_CREATE_GRAPH = 25
_ADD_NODES = 26
_ADD_EDGES = 27
_SAMPLE_NEIGHBORS = 28
_DEGREE = 29
_NODE_FEAT = 30
_SET_NODE_FEAT = 31
_SAMPLE_NODES = 32
_GRAPH_STATS = 33


class DistGraphClient:
    """GraphTable-shaped view over graph stores on N PS servers.

    Construct over a connected :class:`RpcPsClient` (shares its
    hardened transport — deadlines, retry, reconnect)."""

    def __init__(self, client: RpcPsClient, table_id: int = 0,
                 shard_num: int = 16) -> None:
        self._cli = client
        self._tid = int(table_id)
        for c in client._conns:
            c.check(_CREATE_GRAPH, self._tid, aux=shard_num)

    @property
    def num_servers(self) -> int:
        return self._cli.num_servers

    def _route(self, ids: np.ndarray) -> np.ndarray:
        return (ids % np.uint64(self.num_servers)).astype(np.int64)

    # -- construction ----------------------------------------------------

    def add_graph_node(self, node_ids: Sequence[int],
                       features: Optional[np.ndarray] = None) -> None:
        ids = np.ascontiguousarray(node_ids, np.uint64)
        fdim = 0 if features is None else int(np.asarray(features).shape[1])
        feats = (None if features is None
                 else np.ascontiguousarray(features, np.float32))
        sv = self._route(ids)
        for s, c in enumerate(self._cli._conns):
            sel = np.flatnonzero(sv == s)
            if not len(sel):
                continue
            payload = ids[sel].tobytes()
            if feats is not None:
                payload += np.ascontiguousarray(feats[sel]).tobytes()
            c.check(_ADD_NODES, self._tid, n=len(sel), aux=fdim,
                    payload=payload, timeout_ms=_long_ms())

    def add_edges(self, src: Sequence[int], dst: Sequence[int],
                  weights: Optional[Sequence[float]] = None) -> None:
        src = np.ascontiguousarray(src, np.uint64)
        dst = np.ascontiguousarray(dst, np.uint64)
        enforce(len(src) == len(dst), "src/dst length mismatch")
        w = (np.ones(len(src), np.float32) if weights is None
             else np.ascontiguousarray(weights, np.float32))
        sv = self._route(src)
        for s, c in enumerate(self._cli._conns):
            sel = np.flatnonzero(sv == s)
            if not len(sel):
                continue
            payload = (src[sel].tobytes() + dst[sel].tobytes()
                       + w[sel].tobytes())
            # retries=0: edge insertion is append-only — a timeout-then-
            # retry would duplicate the batch and permanently skew the
            # sampling distribution (unlike idempotent node/feat sets)
            c.check(_ADD_EDGES, self._tid, n=len(sel), payload=payload,
                    timeout_ms=_long_ms(), retries=0)
        # dst nodes register on their own owners (degree-0 endpoints must
        # exist for sampling/feat queries, load_edges parity)
        self.add_graph_node(np.unique(dst))

    def load_edges(self, path: str, reverse: bool = False) -> int:
        from .graph_table import parse_edge_file

        srcs, dsts, ws = parse_edge_file(path, reverse)
        if srcs:
            self.add_edges(srcs, dsts, ws)
        return len(srcs)

    # -- queries ---------------------------------------------------------

    def _scatter_query(self, cmd, ids, aux, out, dtype, width) -> None:
        """Route ids to owners, run cmd, scatter per-server responses
        back into ``out`` rows (split_input_to_shard + join)."""
        sv = self._route(ids)
        for s, c in enumerate(self._cli._conns):
            sel = np.flatnonzero(sv == s)
            if not len(sel):
                continue
            _, resp = c.check(cmd, self._tid, n=len(sel), aux=aux,
                              payload=ids[sel].tobytes())
            out[sel] = np.frombuffer(resp, dtype).reshape(len(sel), width)

    def get_node_degree(self, node_ids: Sequence[int]) -> np.ndarray:
        ids = np.ascontiguousarray(node_ids, np.uint64)
        out = np.zeros((len(ids), 1), np.int32)
        self._scatter_query(_DEGREE, ids, 0, out, np.int32, 1)
        return out[:, 0]

    def sample_neighbors(self, node_ids: Sequence[int], sample_size: int,
                         weighted: bool = True
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """(neighbors [n, k] int64, mask [n, k] bool) — padded static
        shapes, sampled server-side on each node's owner."""
        ids = np.ascontiguousarray(node_ids, np.uint64)
        k = int(sample_size)
        enforce(0 < k < 1 << 16, "sample_size in (0, 65536)")
        nbrs = np.zeros((len(ids), k), np.int64)
        mask = np.zeros((len(ids), k), bool)
        aux = k | (1 << 30 if weighted else 0)
        sv = self._route(ids)
        for s, c in enumerate(self._cli._conns):
            sel = np.flatnonzero(sv == s)
            if not len(sel):
                continue
            _, resp = c.check(_SAMPLE_NEIGHBORS, self._tid, n=len(sel),
                              aux=aux, payload=ids[sel].tobytes())
            nb = len(sel) * k * 8
            nbrs[sel] = np.frombuffer(resp[:nb], np.uint64).reshape(
                len(sel), k).astype(np.int64)
            mask[sel] = np.frombuffer(resp[nb:], np.uint8).reshape(
                len(sel), k).astype(bool)
        return nbrs, mask

    def get_node_feat(self, node_ids: Sequence[int],
                      feat_dim: int) -> np.ndarray:
        ids = np.ascontiguousarray(node_ids, np.uint64)
        out = np.zeros((len(ids), feat_dim), np.float32)
        self._scatter_query(_NODE_FEAT, ids, feat_dim, out, np.float32,
                            feat_dim)
        return out

    def set_node_feat(self, node_ids: Sequence[int],
                      features: np.ndarray) -> None:
        ids = np.ascontiguousarray(node_ids, np.uint64)
        feats = np.ascontiguousarray(features, np.float32)
        fdim = feats.shape[1]
        sv = self._route(ids)
        for s, c in enumerate(self._cli._conns):
            sel = np.flatnonzero(sv == s)
            if not len(sel):
                continue
            try:
                c.check(_SET_NODE_FEAT, self._tid, n=len(sel), aux=fdim,
                        payload=ids[sel].tobytes()
                        + np.ascontiguousarray(feats[sel]).tobytes())
            except NotFoundError:
                raise NotFoundError("node not in graph")

    def sample_nodes(self, size: int) -> np.ndarray:
        """Uniform over the global node set: draw per server
        proportionally to its node count, then join (the reference's
        pull_graph_list-style fan-out)."""
        stats = [self._server_stats(c) for c in self._cli._conns]
        counts = np.asarray([s[0] for s in stats], np.float64)
        total = counts.sum()
        enforce(total > 0, "graph is empty")
        out = []
        # largest-remainder allocation of `size` draws over servers
        quota = counts / total * size
        take = np.floor(quota).astype(int)
        rem = size - take.sum()
        order = np.argsort(-(quota - take))
        take[order[:rem]] += 1
        for (c, k) in zip(self._cli._conns, take):
            if k <= 0:
                continue
            got, resp = c.check(_SAMPLE_NODES, self._tid, n=int(k))
            out.append(np.frombuffer(resp[: got * 8], np.uint64))
        return np.concatenate(out) if out else np.zeros(0, np.uint64)

    def _server_stats(self, conn) -> Tuple[int, int]:
        _, resp = conn.check(_GRAPH_STATS, self._tid)
        s = np.frombuffer(resp, np.int64)
        return int(s[0]), int(s[1])

    @property
    def node_count(self) -> int:
        return sum(self._server_stats(c)[0] for c in self._cli._conns)

    @property
    def edge_count(self) -> int:
        return sum(self._server_stats(c)[1] for c in self._cli._conns)
