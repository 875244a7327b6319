"""The host sparse table that backs a training pass.

The port's own copy of ``MemorySparseTable`` with the Python-shard
backend of ``paddle_tpu.ps.table`` (the native sparse engine and the SSD
tier wait for later slices): N local shards, feasign-routed
(``shard = key % shard_num``), insert-on-miss pull, push through the CTR
accessor, and the full-row export/import the pass cache builds from and
flushes back to. Columnar numpy blocks per shard; the key→row map of
each shard is the native ``FeasignIndex``.
"""

from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

from .accessor import AccessorConfig, CtrCommonAccessor, FeatureBlock
from .native import FeasignIndex

__all__ = ["MemorySparseTable", "TableConfig", "merge_duplicate_keys",
           "row_digest"]


def row_digest(keys: np.ndarray, values: np.ndarray) -> int:
    """Order-independent content digest: per-row FNV-1a over [key bytes ++
    full-row float bytes], summed with wrapping 64-bit add (the same
    digest as ``paddle_tpu.ps.table.row_digest``). Test-scale tool."""
    mask = 0xFFFFFFFFFFFFFFFF
    total = 0
    keys = np.ascontiguousarray(keys, np.uint64)
    values = np.ascontiguousarray(values, np.float32)
    for i in range(len(keys)):
        h = 0xCBF29CE484222325
        for b in keys[i].tobytes() + values[i].tobytes():
            h = ((h ^ b) * 0x100000001B3) & mask
        total = (total + h) & mask
    return total


def merge_duplicate_keys(keys: np.ndarray, values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Client-side dedup-merge before push: gradients/show/click sum; the
    slot (col 0) is categorical — keep the first occurrence."""
    uniq, first_idx, inverse = np.unique(keys, return_index=True, return_inverse=True)
    if len(uniq) == len(keys):
        return keys, values
    merged = np.zeros((len(uniq), values.shape[1]), np.float32)
    np.add.at(merged, inverse, values)
    merged[:, 0] = values[first_idx, 0]
    return uniq, merged


@dataclasses.dataclass
class TableConfig:
    """Mirrors TableParameter (ps.proto:121) for the Python-shard table
    with the CTR accessor (the other accessors wait for later slices)."""

    shard_num: int = 16
    accessor_config: Optional[AccessorConfig] = None
    seed: int = 0


class _SparseShard:
    """One local shard: FeasignIndex + growable columnar FeatureBlock."""

    def __init__(self, accessor: CtrCommonAccessor, seed: int) -> None:
        self.accessor = accessor
        self.index = FeasignIndex(1024)
        self.block = FeatureBlock(0, accessor)
        self.initialized = np.zeros(0, bool)
        self.rng = np.random.default_rng(seed)
        self.lock = threading.Lock()

    def _ensure_capacity(self, rows_needed: int) -> None:
        cur = len(self.block.slot)
        if rows_needed <= cur:
            return
        new_cap = max(1024, cur * 2, rows_needed)
        old = self.block
        self.block = FeatureBlock(new_cap, self.accessor)
        for name, arr in vars(old).items():
            if len(arr):
                getattr(self.block, name)[: len(arr)] = arr
        init = np.zeros(new_cap, bool)
        init[: len(self.initialized)] = self.initialized
        self.initialized = init

    def _new_rows_mask(self, rows: np.ndarray) -> np.ndarray:
        """First occurrence of each never-initialized row. Initialization
        is tracked explicitly — embed_state == 0 is ambiguous."""
        _, first_idx = np.unique(rows, return_index=True)
        first = np.zeros(len(rows), bool)
        first[first_idx] = True
        return first & ~self.initialized[rows]

    def _create_new(self, rows: np.ndarray, slots: np.ndarray) -> None:
        new_mask = self._new_rows_mask(rows)
        if new_mask.any():
            new_rows = rows[new_mask]
            self.accessor.create(self.block, new_rows, slots[new_mask], self.rng)
            self.initialized[new_rows] = True

    def pull(self, keys: np.ndarray, slots: Optional[np.ndarray], create: bool) -> np.ndarray:
        with self.lock:
            if create:
                rows, n_new = self.index.lookup_or_insert(keys)
                self._ensure_capacity(self.index.row_capacity)
                if n_new:
                    s = slots if slots is not None else np.zeros(len(keys), np.int32)
                    self._create_new(rows, s)
            else:
                rows = self.index.lookup(keys)
            found = rows >= 0
            out = np.zeros((len(keys), self.accessor.pull_dim), np.float32)
            if found.any():
                out[found] = self.accessor.select(self.block, rows[found])
            return out

    def push(self, keys: np.ndarray, push_values: np.ndarray) -> None:
        with self.lock:
            rows, _ = self.index.lookup_or_insert(keys)
            self._ensure_capacity(self.index.row_capacity)
            self._create_new(rows, push_values[:, 0].astype(np.int32))
            self.accessor.update(self.block, rows, push_values, self.rng)

    def export(self, keys: np.ndarray, full_dim: int) -> Tuple[np.ndarray, np.ndarray]:
        """Full-layout rows of ``keys`` (zeros where absent) and found."""
        es = self.accessor.embed_rule.state_dim
        xd = self.accessor.config.embedx_dim
        with self.lock:
            rows = self.index.lookup(keys)
            ok = rows >= 0
            out = np.zeros((len(keys), full_dim), np.float32)
            r = rows[ok]
            b = self.block
            out[ok, 0] = b.slot[r]
            out[ok, 1] = b.unseen_days[r]
            out[ok, 2] = b.delta_score[r]
            out[ok, 3] = b.show[r]
            out[ok, 4] = b.click[r]
            out[ok, 5] = b.embed_w[r, 0]
            out[np.ix_(ok, range(6, 6 + es))] = b.embed_state[r]
            out[ok, 6 + es] = b.has_embedx[r].astype(np.float32)
            out[np.ix_(ok, range(7 + es, 7 + es + xd))] = b.embedx_w[r]
            out[np.ix_(ok, range(7 + es + xd, full_dim))] = b.embedx_state[r]
            return out, ok

    def import_rows(self, keys: np.ndarray, values: np.ndarray) -> None:
        es = self.accessor.embed_rule.state_dim
        xd = self.accessor.config.embedx_dim
        with self.lock:
            rows, _ = self.index.lookup_or_insert(keys)
            self._ensure_capacity(self.index.row_capacity)
            b = self.block
            b.slot[rows] = values[:, 0].astype(np.int32)
            b.unseen_days[rows] = values[:, 1]
            b.delta_score[rows] = values[:, 2]
            b.show[rows] = values[:, 3]
            b.click[rows] = values[:, 4]
            b.embed_w[rows, 0] = values[:, 5]
            b.embed_state[rows] = values[:, 6 : 6 + es]
            b.has_embedx[rows] = values[:, 6 + es] != 0.0
            b.embedx_w[rows] = values[:, 7 + es : 7 + es + xd]
            b.embedx_state[rows] = values[:, 7 + es + xd :]
            self.initialized[rows] = True


class MemorySparseTable:
    """Sparse embedding table over N local Python shards."""

    def __init__(self, config: Optional[TableConfig] = None) -> None:
        self.config = config or TableConfig()
        self.accessor = CtrCommonAccessor(self.config.accessor_config)
        self._shards = [_SparseShard(self.accessor, self.config.seed + i)
                        for i in range(self.config.shard_num)]
        self._pool = ThreadPoolExecutor(max_workers=min(self.config.shard_num, 8))

    def close(self) -> None:
        """Stop the shard worker threads."""
        self._pool.shutdown(wait=True)

    def _scatter_gather(self, keys: np.ndarray, fn, *per_key_args):
        """Group keys by shard, apply fn per shard, regather results."""
        keys = np.ascontiguousarray(keys, np.uint64)
        shard_ids = (keys % np.uint64(self.config.shard_num)).astype(np.int64)
        order = np.argsort(shard_ids, kind="stable")
        bounds = np.searchsorted(shard_ids[order], np.arange(self.config.shard_num + 1))
        futures = []
        for s in range(self.config.shard_num):
            sel = order[bounds[s] : bounds[s + 1]]
            if len(sel) == 0:
                continue
            args = [a[sel] if a is not None else None for a in per_key_args]
            futures.append((sel, self._pool.submit(fn, self._shards[s], keys[sel], *args)))
        return [(sel, f.result()) for sel, f in futures]

    def pull_sparse(self, keys: np.ndarray, slots: Optional[np.ndarray] = None,
                    create: bool = True) -> np.ndarray:
        """Batched pull with insert-on-miss (memory_sparse_table.cc:443)."""
        out = np.zeros((len(keys), self.accessor.pull_dim), np.float32)
        for sel, vals in self._scatter_gather(
                keys, lambda sh, k, s: sh.pull(k, s, create), slots):
            out[sel] = vals
        return out

    def push_sparse(self, keys: np.ndarray, push_values: np.ndarray) -> None:
        """Batched push: push_values [n, 4 + dim] (slot, show, click,
        embed_g, embedx_g...); duplicate keys are pre-merged."""
        keys, push_values = merge_duplicate_keys(
            np.ascontiguousarray(keys, np.uint64), push_values)
        self._scatter_gather(keys, lambda sh, k, pv: sh.push(k, pv), push_values)

    @property
    def full_dim(self) -> int:
        """Row width of the full layout: slot, unseen_days, delta_score,
        show, click, embed_w, embed_state[es], has_embedx, embedx_w[xd],
        embedx_state[xs]."""
        return (7 + self.accessor.embed_rule.state_dim
                + self.accessor.config.embedx_dim
                + self.accessor.embedx_rule.state_dim)

    def export_full(self, keys: np.ndarray, create: bool = False,
                    slots: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        """(values [n, full_dim], found [n] bool). With ``create``, missing
        rows are inserted in the same shard visit (the pass build)."""
        keys = np.ascontiguousarray(keys, np.uint64)
        slots_arr = np.ascontiguousarray(slots, np.int32) if slots is not None else None
        full_dim = self.full_dim

        def visit(sh, k, s):
            if create:
                sh.pull(k, s, True)
            return sh.export(k, full_dim)

        out = np.zeros((len(keys), full_dim), np.float32)
        found = np.zeros(len(keys), bool)
        for sel, res in self._scatter_gather(keys, visit, slots_arr):
            out[sel], found[sel] = res
        return out, found

    def import_full(self, keys: np.ndarray, values: np.ndarray) -> None:
        """Direct overwrite of full rows (insert-on-miss)."""
        self._scatter_gather(keys, lambda sh, k, v: sh.import_rows(k, v), values)

    def size(self) -> int:
        return sum(len(sh.index) for sh in self._shards)

    def snapshot_items(self) -> Tuple[np.ndarray, np.ndarray]:
        """(keys [n] u64, full rows [n, full_dim]) of every live feature."""
        keys = [sh.index.items()[0] for sh in self._shards]
        keys = np.concatenate(keys) if keys else np.zeros(0, np.uint64)
        values, _ = self.export_full(keys)
        return keys, values

    def digest(self) -> int:
        """Order-independent content digest of every live row."""
        return row_digest(*self.snapshot_items())
