"""Warm-path embedding lookup sources for the serving frontend.

The port's own copy of ``paddle_tpu.serving.lookup``. Two implementations
of the one-method contract ``lookup(keys [n] u64) -> values [n, d] f32``
(numpy):

- :class:`ReplicaLookup`, the host path: every lookup is a
  ``pull_sparse(create=False)`` against the serving replica's local table
  (a serve-QoS client, no training-PS call). Missing keys read as zeros,
  the serving contract for out-of-population features.
- :class:`CachedLookup`, the device path: the
  :class:`~paddle_tpu_torch.ps.hot_tier.HotEmbeddingTier` read path
  (``ensure(mark_dirty=False)``, then ``cache_pull``, a gather on the
  tier's device state) over a replica's cold view, so warm keys never
  leave resident state: no call of any kind. Staleness is bounded: a
  resident row older than ``freshness_budget_s`` is dropped and fetched
  again only when the feed has advanced past its fetch point
  (``replica.applied_seq``), so an idle feed re-fetches nothing and a busy
  one refreshes each warm row at most once a budget.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..core.enforce import enforce
from ..ps.embedding_cache import cache_pull
from ..ps.hot_tier import HotEmbeddingTier

__all__ = ["ReplicaLookup", "CachedLookup"]


class ReplicaLookup:
    """Direct host-table reads from the serving replica."""

    def __init__(self, client, table_id: int) -> None:
        self._client = client
        self.table_id = int(table_id)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        return self._client.pull_sparse(self.table_id, keys, create=False)

    @property
    def dim(self) -> int:
        return self._client._dims(self.table_id)[0]


class CachedLookup:
    """Resident-state reads through a read-only hot tier.

    ``tier`` must be built with ``create_on_miss=False`` over a replica's
    :meth:`~paddle_tpu_torch.serving.replica.ServingReplica.serve_view`
    (the replica is read-only: a create-on-miss tier would be refused).
    ``replica`` gives the feed cursor for the staleness bound; None turns
    the refresh off (a static table served from device memory)."""

    def __init__(self, tier: HotEmbeddingTier, replica=None,
                 freshness_budget_s: float = 0.05) -> None:
        enforce(not tier.config.create_on_miss,
                "CachedLookup needs a read-only tier (HotTierConfig(create_on_miss=False)): "
                "a serving lookup must never create rows")
        self.tier = tier
        self.replica = replica
        self.freshness_budget_s = freshness_budget_s
        C = tier.config.capacity
        # per-row fetch stamps: the feed seq a row was fetched under, and
        # when (the two sides of the staleness predicate)
        self._row_seq = np.zeros(C, np.int64)
        self._row_t = np.zeros(C, np.float64)
        self.refreshes = 0

    def _refresh_stale(self, keys: np.ndarray, rows: np.ndarray, seq: int,
                       now: float) -> int:
        """Invalidate resident but stale rows; returns how many dropped
        (``rows`` is the caller's host-map probe, reused)."""
        res = rows >= 0
        if not res.any():
            return 0
        rres = rows[res]
        stale = (self._row_seq[rres] < seq) & (now - self._row_t[rres] > self.freshness_budget_s)
        if not stale.any():
            return 0
        stale_keys = np.unique(keys[res][stale])
        dropped = self.tier.invalidate(stale_keys)
        self.refreshes += len(stale_keys)
        return dropped

    def admit(self, keys: np.ndarray) -> int:
        """Bulk-admit ``keys`` into the resident set, stamped fresh as of
        now (a joining replica's warm handoff: one fetch a chunk instead
        of a cold miss a request; rows admitted through the raw tier would
        carry seq 0 and be dropped as stale on their first lookup). Returns
        the rows made resident."""
        keys = np.ascontiguousarray(keys, np.uint64)
        if len(keys) == 0:
            return 0
        now = time.perf_counter()
        seq = self.replica.applied_seq if self.replica is not None else 0
        pre = self.tier.device_map.lookup_host(keys)
        rows = self.tier.ensure(keys, mark_dirty=False)
        fresh = np.unique(rows[pre < 0])
        self._row_seq[fresh] = seq
        self._row_t[fresh] = now
        return len(fresh)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, np.uint64)
        now = time.perf_counter()
        seq: Optional[int] = self.replica.applied_seq if self.replica is not None else None
        pre = self.tier.device_map.lookup_host(keys)
        if seq is not None and self._refresh_stale(keys, pre, seq, now):
            pre = self.tier.device_map.lookup_host(keys)  # rare: rows left
        rows = self.tier.ensure(keys, mark_dirty=False)
        fetched = np.unique(rows[pre < 0])
        if len(fetched):
            self._row_seq[fetched] = seq if seq is not None else 0
            self._row_t[fetched] = now
        # the JAX package pads the gather to a power of two so its jit does
        # not compile a new length per micro-batch; the eager gather has no
        # compile, so it takes the rows as they are (same result)
        idx = torch.from_numpy(rows.astype(np.int64)).to(self.tier.device)
        return cache_pull(self.tier.state, idx).cpu().numpy()

    @property
    def dim(self) -> int:
        return 1 + self.tier.cache_config.embedx_dim

    def stats(self) -> dict:
        out = self.tier.stats()
        out["staleness_refreshes"] = self.refreshes
        return out
