"""Persistent HBM-resident hot-embedding tier.

Port of ``paddle_tpu.ps.hot_tier`` (single card). Where the pass cache
(``ps.embedding_cache.HbmEmbeddingCache``) builds a working set per PASS
and flushes it at the pass boundary, this tier lives on the card for the
WHOLE training run:

- **residency** — a :class:`~paddle_tpu_torch.ps.device_hash.
  DynamicDeviceKeyMap` (insert/evict-capable, probed on the card) plus
  the seven row-state columns of the pass cache;
- **warm path** — batch keys resolve to rows on the card, the pull is a
  gather and the CTR rule update a scatter: a warm step touches the cold
  store not at all. With ``kernels="auto"`` the probe+pull is ONE kernel
  (``ops.hot_kernels.hot_probe_gather``) and the merge+rule+scatter ONE
  more (``hot_scatter_apply``); ``kernels="unfused"`` runs the reference
  formulation (``dynamic_map_lookup`` + ``cache_pull`` + ``cache_push``,
  which on the card runs the merge kernel and ``ctr_sparse_rows_at``). The
  two are bit-identical and the launch counters show which one ran;
- **miss path** — cold ids fill from the cold table through the full-row
  exporter (``export_full(create=True)`` — values AND optimizer state);
- **eviction** — LFU/LRU victims write their dirty rows back with the
  ``end_pass`` flush-back semantics (export-modify-import: delta_score
  fold, unseen reset, lazy-embedx splice);
- **flush** — :meth:`HotEmbeddingTier.flush` writes every dirty row back;
- **sharding** — with ``HotTierConfig.mesh`` (a ``core.mesh`` of K
  shards) the state is row-sharded: shard k owns the row block
  ``[k·C/K, (k+1)·C/K)``, and with one bank per shard (the default) a
  key's bank block IS its owner shard's block, so the host control plane
  (``ensure()``, eviction, write-back) stays global and unchanged. The
  step (:func:`make_sharded_hot_train_step`) probes each shard's batch
  slice against the one key map (``ops.hot_kernels.hot_probe``) and
  routes the rows to their owners through ``ps.sharded_cache``; the owner
  applies the push to its block in place (``hot_scatter_apply``).

Bit-parity contract (as in the JAX package): the device rule math is
bit-identical to the host table's, so training with the tier reproduces
the tier-less trainer's dense params and table rows EXACTLY, through
eviction churn, except ``delta_score`` (save column 2), which folds per
flush instead of per push.

The cold store may be a local table or a ``ps.rpc.RemoteSparseTable``
(sparse rows on PS servers): the tier reads only ``export_full``,
``import_full`` and ``accessor``. :meth:`HotEmbeddingTier.prefetch` with a
communicator runs the cold fetch on the communicator's pull workers, so it
overlaps the steps in front of the batch.

PyTorch idiom: the tier state and the map's device arrays are updated IN
PLACE (``index_copy_`` / ``index_put_`` and the kernels) where the JAX
package returned fresh arrays; admission needs no power-of-two padding
(there is no compiled shape to reuse). Counters are a plain dict. The
tier's state and control plane are single-threaded: the trainer's step
loop owns them (a prefetch only reads the host mirror on that thread and
fetches elsewhere).
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..core.device import resolve_device
from ..core.enforce import enforce
from ..core.mesh import Mesh, mesh_axis_size
from ..nn import functional as F
from ..obs.registry import CounterGroup
from ..ops.hot_kernels import hot_probe, hot_probe_gather, hot_scatter_apply
from .device_hash import DynamicDeviceKeyMap, dynamic_map_lookup
from .embedding_cache import CacheConfig, cache_pull, cache_push
from .sharded_cache import _make_sharded_step, _keyed_rows

__all__ = ["HotEmbeddingTier", "HotTierConfig", "make_hot_ctr_train_step",
           "make_sharded_hot_train_step"]

_KERNELS = ("auto", "unfused")
_COUNTERS = ("hits", "misses", "evictions", "writebacks", "cold_fetches",
             "flushes", "reshards", "tenant_cap_evictions")
_TIER_SEQ = iter(range(1, 1 << 30))  # per-process tier tag allocator


@dataclasses.dataclass
class HotTierConfig:
    """Knobs of the persistent hot tier (the row-update math itself —
    rules, hyperparameters — always comes from the cold table's accessor;
    anything else would corrupt the flush-back)."""

    #: resident rows (HBM budget = capacity × row width × 4 bytes)
    capacity: int = 1 << 18
    #: eviction policy: "lfu" (fewest ensure() appearances) or "lru"
    #: (oldest last appearance); ties break by row id — deterministic
    policy: str = "lfu"
    #: extra victims evicted per shortfall, PER BANK (0 = exactly the
    #: shortfall)
    evict_batch: int = 0
    #: a ``core.mesh`` row-shards the tier over its ``axis`` (None = one
    #: shard); the capacity must divide over the shards
    mesh: Optional[Mesh] = None
    axis: str = "ps"
    #: the sharded step's routing (``ps.sharded_cache.select_routing``)
    #: and its bucket slack
    routing: Any = "auto"
    cap_factor: float = 2.0
    #: miss semantics: True (training) creates missing rows in the cold
    #: store; False fetches without creating (absent keys admit as zero
    #: rows — the read-only serving contract)
    create_on_miss: bool = True
    #: push formulation of the "unfused" step (embedding_cache
    #: resolve_push_mode: "auto" = "sparse")
    push_mode: str = "auto"
    #: "auto": the fused kernels (hot_probe_gather + hot_scatter_apply;
    #: their plain versions on the CPU) — the JAX package's "pallas";
    #: "unfused": dynamic_map_lookup + cache_pull + cache_push — its "jnp"
    kernels: str = "auto"
    #: bucket/row banks (power of two, a multiple of the shard count): a
    #: key's row lives in its bank's contiguous row block, which never
    #: crosses a shard boundary. None = one bank per shard
    banks: Optional[int] = None
    #: multi-tenant slot caps: tenant id → max resident rows; a tenant
    #: past its cap evicts its OWN rows. None = single-tenant tier
    tenant_slots: Optional[Dict[int, int]] = None
    #: vectorized keys → tenant ids; None = the key's top byte
    tenant_of_key: Optional[Callable[[np.ndarray], np.ndarray]] = None


def _tenant_of_key_default(keys: np.ndarray) -> np.ndarray:
    """Tenant id from the key's top byte (the tenancy key namespacing)."""
    return (np.asarray(keys, np.uint64) >> np.uint64(56)).astype(np.int64)


class HotEmbeddingTier:
    """See the module docstring. ``table`` is the COLD store — anything
    with the full-row surface (``export_full``/``import_full`` + an
    ``accessor``), such as ``ps.table.MemorySparseTable``. ``device``
    defaults to ``"cuda"`` and raises without a GPU unless the caller
    passes ``device="cpu"``."""

    def __init__(self, table, config: Optional[HotTierConfig] = None,
                 cache_config: Optional[CacheConfig] = None,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        for attr in ("export_full", "import_full", "accessor"):
            enforce(hasattr(table, attr), f"cold store lacks .{attr} — not a full-row Table")
        self.config = config or HotTierConfig()
        enforce(self.config.policy in ("lfu", "lru"),
                f"unknown eviction policy {self.config.policy!r}")
        enforce(self.config.kernels in _KERNELS,
                f"kernels must be one of {_KERNELS}, got {self.config.kernels!r}")
        self.device = resolve_device(device)
        self.table = table
        acc = table.accessor.config
        # the device math is the accessor's math (same derivation as
        # HbmEmbeddingCache)
        self.cache_config = cache_config or CacheConfig(
            capacity=self.config.capacity, embedx_dim=acc.embedx_dim,
            embed_rule=acc.embed_sgd_rule, embedx_rule=acc.embedx_sgd_rule,
            sgd=acc.sgd, nonclk_coeff=acc.nonclk_coeff, click_coeff=acc.click_coeff,
            embedx_threshold=acc.embedx_threshold, push_mode=self.config.push_mode)
        enforce(self.cache_config.capacity == self.config.capacity,
                "cache_config.capacity must equal HotTierConfig.capacity")

        C = self.config.capacity
        self._n_shards = 1
        if self.config.mesh is not None:
            self._n_shards = mesh_axis_size(self.config.mesh, self.config.axis)
            enforce(self.config.mesh.device.type == self.device.type,
                    f"the mesh lives on {self.config.mesh.device}, the tier on {self.device}")
            enforce(C % self._n_shards == 0,
                    "hot-tier capacity must divide evenly over the mesh axis")
        self._banks = self.config.banks if self.config.banks is not None else self._n_shards
        enforce(self._banks >= 1 and (self._banks & (self._banks - 1)) == 0,
                f"banks must be a power of two, got {self._banks}")
        enforce(C % self._banks == 0, "hot-tier capacity must divide evenly over the banks")
        enforce(self._banks % self._n_shards == 0,
                f"banks ({self._banks}) must be a multiple of the mesh shard count "
                f"({self._n_shards})")

        ec = table.accessor
        self._es = ec.embed_rule.state_dim
        self._xs = ec.embedx_rule.state_dim
        self._xd = ec.config.embedx_dim

        self._tenant_slots = (dict(self.config.tenant_slots)
                              if self.config.tenant_slots else None)
        self._tenant_of = self.config.tenant_of_key or _tenant_of_key_default

        # host control plane (membership/policy/dirtiness — row values
        # live on the card, never here)
        self._keys = np.zeros(C, np.uint64)
        self._row_tenant = np.zeros(C, np.int64)
        self._valid = np.zeros(C, bool)
        self._dirty = np.zeros(C, bool)
        self._freq = np.zeros(C, np.int64)
        self._tick = np.zeros(C, np.int64)
        self._clock = 0
        self._prefetched: Dict[int, Future] = {}  # token → future of (missing keys, rows)
        # registry-backed counters: the dict-shaped increments are those of
        # a plain dict, and every count also lands in the process registry's
        # ``hot_tier_events`` family, labelled by a per-process tier tag;
        # ``stats()`` reads the exact local values
        self.counters = CounterGroup("hot_tier_events", _COUNTERS, max_series=1024,
                                     tier=str(next(_TIER_SEQ)))
        self._reset_resident_set()

    def _reset_resident_set(self) -> None:
        """Fresh map/state/control plane — cold construction AND drop()
        share this so the two can never desynchronize."""
        C = self.config.capacity
        self.device_map = DynamicDeviceKeyMap(C, device=self.device, banks=self._banks)
        self.state = self._fresh_state()
        self._valid[:] = False
        self._dirty[:] = False
        self._freq[:] = 0
        self._tick[:] = 0
        self._keys[:] = 0
        self._row_tenant[:] = 0
        # per-bank free row lists: bank b owns [b·C/banks, (b+1)·C/banks)
        Cb = C // self._banks
        self._free = [list(range(b * Cb, (b + 1) * Cb))[::-1] for b in range(self._banks)]
        self._row_bank = np.arange(C) // Cb  # row id → owning bank
        self._prefetched.clear()

    # -- state ------------------------------------------------------------

    def _fresh_state(self) -> Dict[str, torch.Tensor]:
        C, d = self.config.capacity, self.device
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=d)
        return {"show": z(C), "click": z(C), "embed_w": z(C, 1),
                "embed_state": z(C, self._es), "embedx_w": z(C, self._xd),
                "embedx_state": z(C, self._xs), "has_embedx": z(C)}

    def _full_to_cols(self, values: np.ndarray) -> Dict[str, np.ndarray]:
        """Full save-layout rows → the seven state columns."""
        es, xs, xd = self._es, self._xs, self._xd
        return {
            "show": values[:, 3].copy(),
            "click": values[:, 4].copy(),
            "embed_w": values[:, 5:6].copy(),
            "embed_state": values[:, 6:6 + es].copy(),
            "has_embedx": values[:, 6 + es].copy(),
            "embedx_w": values[:, 7 + es:7 + es + xd].copy(),
            "embedx_state": values[:, 7 + es + xd:7 + es + xd + xs].copy(),
        }

    # -- miss prefetch ----------------------------------------------------

    def prefetch(self, keys: np.ndarray, communicator=None) -> None:
        """Issue the cold fetch of ``keys``'s non-resident ids now — on the
        communicator's pull workers (``communicator.fetch_async``), or in
        line without one — so a later :meth:`ensure` of the same batch
        takes the rows without a fetch of its own. Fetch only, no tier
        mutation, so it runs ahead of the steps. Creation order stays
        deterministic only without overlapping prefetches (the sync trainer
        issues none)."""
        keys = np.ascontiguousarray(keys, np.uint64)
        missing, slots = self._missing_of(keys)
        if len(missing) == 0:
            return

        def fetch():
            values, _ = self.table.export_full(missing, create=self.config.create_on_miss,
                                               slots=slots)
            return missing, values

        if communicator is not None:
            fut = communicator.fetch_async(fetch)
        else:
            fut = Future()
            fut.set_result(fetch())
        self.counters["cold_fetches"] += 1
        self._prefetched[self._batch_token(keys)] = fut

    @staticmethod
    def _batch_token(keys: np.ndarray) -> int:
        # content token so ensure() matches the prefetch issued for the
        # same batch (first/last/middle/len fingerprint)
        if len(keys) == 0:
            return 0
        return hash((len(keys), int(keys[0]), int(keys[-1]), int(keys[len(keys) // 2])))

    def _missing_of(self, keys: np.ndarray, rows: Optional[np.ndarray] = None):
        """First-occurrence-order unique non-resident keys + their slot
        ids (key>>32). Order matters: the cold table creates missing rows
        in request order, and the tier-less trainer's pull creates the
        same new keys in the same order."""
        if rows is None:
            rows = self.device_map.lookup_host(keys)
        miss = keys[rows < 0]
        if len(miss) == 0:
            return miss, miss
        _, first = np.unique(miss, return_index=True)
        missing = miss[np.sort(first)]
        return missing, (missing >> np.uint64(32)).astype(np.int32)

    # -- the resident-set contract ----------------------------------------

    def ensure(self, keys: np.ndarray, mark_dirty: bool = True) -> np.ndarray:
        """Make every key resident; return its row ids ([n] int32).

        Misses fetch full rows from the cold store (taking a matching
        :meth:`prefetch`), evicting victims first when a bank's free list
        runs short. ``mark_dirty`` records that the following step PUSHES
        these rows (pull-only callers pass False, so eviction can skip
        the writeback)."""
        keys = np.ascontiguousarray(keys, np.uint64)
        self._clock += 1
        rows = self.device_map.lookup_host(keys)
        n_hit = int((rows >= 0).sum())
        self.counters["hits"] += n_hit
        self.counters["misses"] += len(keys) - n_hit
        pre = self._prefetched.pop(self._batch_token(keys), None)
        if (rows < 0).any():
            if pre is not None:
                # the resident set may have moved since the prefetch; only
                # still-missing keys take the fetched rows
                missing, values = pre.result()
                still = self.device_map.lookup_host(missing) < 0
                self._admit(missing[still], values[still], keys)
                rows = self.device_map.lookup_host(keys)
            if (rows < 0).any():
                missing, slots = self._missing_of(keys)
                values, _ = self.table.export_full(
                    missing, create=self.config.create_on_miss, slots=slots)
                self.counters["cold_fetches"] += 1
                self._admit(missing, values, keys)
                rows = self.device_map.lookup_host(keys)
        enforce(bool((rows >= 0).all()), "hot tier ensure() left misses")
        if mark_dirty:
            self._dirty[rows] = True
        self._freq[rows] += 1
        self._tick[rows] = self._clock
        return rows

    def _admit(self, missing: np.ndarray, values: np.ndarray,
               batch_keys: np.ndarray) -> None:
        if len(missing) == 0:
            return
        # tenant caps come FIRST: an over-cap tenant frees its own rows
        # before the bank-shortfall pass sees the free lists
        if self._tenant_slots:
            self._enforce_tenant_caps(missing, batch_keys)
        bk = self.device_map.bank_of(missing)
        counts = np.bincount(bk, minlength=self._banks)
        needs = counts - np.asarray([len(f) for f in self._free])
        if (needs > 0).any():
            self._evict(np.maximum(needs, 0), batch_keys)
        new_rows = np.asarray([self._free[b].pop() for b in bk], np.int64)
        if self._tenant_slots:
            self._row_tenant[new_rows] = self._tenant_of(missing)
        idx = torch.from_numpy(new_rows).to(self.device)
        for name, v in self._full_to_cols(values).items():
            if self.state[name].numel():  # zero-width state has nothing to fill
                self.state[name].index_copy_(0, idx, torch.from_numpy(v).to(self.device))
        self.device_map.insert(missing, new_rows.astype(np.int32))
        self._keys[new_rows] = missing
        self._valid[new_rows] = True
        self._dirty[new_rows] = False
        self._freq[new_rows] = 0
        self._tick[new_rows] = self._clock

    def _policy_order(self, cand: np.ndarray) -> np.ndarray:
        if self.config.policy == "lfu":
            return np.lexsort((cand, self._tick[cand], self._freq[cand]))
        return np.lexsort((cand, self._freq[cand], self._tick[cand]))  # lru

    def _protected(self, batch_keys: np.ndarray) -> np.ndarray:
        protect = np.zeros(self.config.capacity, bool)
        r = self.device_map.lookup_host(batch_keys)
        protect[r[r >= 0]] = True
        return protect

    def _evict(self, needs: np.ndarray, batch_keys: np.ndarray) -> None:
        """Deterministic victim selection + dirty writeback. ``needs`` is
        the PER-BANK shortfall — victims come from the short bank's own
        row block (a key can only admit into its bank)."""
        evictable = self._valid & ~self._protected(batch_keys)
        victims_all = []
        for b in np.flatnonzero(needs > 0):
            need = int(needs[b])
            cand = np.flatnonzero(evictable & (self._row_bank == b))
            count = min(need + int(self.config.evict_batch), len(cand))
            enforce(count >= need,
                    f"hot tier bank {b} smaller than one batch's working set — "
                    "raise HotTierConfig.capacity (per-bank budget is capacity/banks)")
            victims_all.append(cand[self._policy_order(cand)[:count]])
        victims = np.concatenate(victims_all) if victims_all else np.zeros(0, np.int64)
        self._evict_rows(victims)
        self.counters["evictions"] += len(victims)

    def _evict_rows(self, victims: np.ndarray) -> None:
        """Dirty writeback, map removal, control-plane invalidation, rows
        back to their banks' free lists."""
        if len(victims) == 0:
            return
        self.writeback(victims[self._dirty[victims]])
        self.device_map.remove(self._keys[victims])
        self._valid[victims] = False
        self._dirty[victims] = False
        for v in victims:
            self._free[self._row_bank[v]].append(int(v))

    def _enforce_tenant_caps(self, missing: np.ndarray, batch_keys: np.ndarray) -> None:
        """Per-tenant slot quota: a capped tenant whose resident +
        incoming rows exceed its cap evicts the overage from its OWN rows
        (policy order, batch keys protected)."""
        t_in = self._tenant_of(missing)
        protect = self._protected(batch_keys)
        for t, cap in self._tenant_slots.items():
            incoming = int((t_in == t).sum())
            if incoming == 0:
                continue
            enforce(incoming <= cap,
                    f"hot tier tenant {t}: one batch admits {incoming} rows but "
                    f"tenant_slots caps it at {cap} — raise the cap (it must "
                    "cover a batch's working set)")
            resident = self._valid & (self._row_tenant == t)
            over = int(resident.sum()) + incoming - cap
            if over <= 0:
                continue
            cand = np.flatnonzero(resident & ~protect)
            enforce(len(cand) >= over,
                    f"hot tier tenant {t}: cap {cap} cannot fit the current batch "
                    f"even after evicting every unprotected resident row "
                    f"({len(cand)} evictable, need {over})")
            victims = cand[self._policy_order(cand)[:over]]
            self._evict_rows(victims)
            self.counters["tenant_cap_evictions"] += len(victims)

    def tenant_residency(self) -> Dict[int, int]:
        """Resident row count per tenant (control-plane read)."""
        rows = self._row_tenant[self._valid]
        return {int(t): int((rows == t).sum()) for t in np.unique(rows)}

    # -- flush-back (end_pass semantics, incremental) ----------------------

    def writeback(self, rows: np.ndarray) -> int:
        """Write these resident rows back into the cold store — the
        end_pass export-modify-import: stat totals overwrite, delta_score
        folds the growth, unseen_days zeroes, lazily created embedx
        splices over the old block. Resident rows receive no cold-store
        pushes (the tier is their write path), so the exported 'old' row
        is the at-admit baseline."""
        rows = np.asarray(rows, np.int64)
        if len(rows) == 0:
            return 0
        keys = self._keys[rows]
        idx = torch.from_numpy(rows).to(self.device)
        host = {k: v[idx].cpu().numpy() for k, v in self.state.items()}
        old, found = self.table.export_full(keys)
        enforce(bool(found.all()),
                "hot-tier writeback: resident key missing from the cold store "
                "(table shrunk mid-run? the tier is its only writer)")
        es, xs, xd = self._es, self._xs, self._xd
        acc = self.table.accessor.config
        new = old.copy()
        d_show = host["show"] - old[:, 3]
        d_click = host["click"] - old[:, 4]
        new[:, 2] = old[:, 2] + (d_show - d_click) * acc.nonclk_coeff + d_click * acc.click_coeff
        new[:, 1] = 0.0
        new[:, 3] = host["show"]
        new[:, 4] = host["click"]
        new[:, 5] = host["embed_w"][:, 0]
        new[:, 6:6 + es] = host["embed_state"]
        has = host["has_embedx"] > 0
        keep_old = old[:, 6 + es] != 0.0
        new[:, 6 + es] = (has | keep_old).astype(np.float32)
        new[has, 7 + es:7 + es + xd] = host["embedx_w"][has]
        new[has, 7 + es + xd:7 + es + xd + xs] = host["embedx_state"][has]
        self.table.import_full(keys, new)
        self.counters["writebacks"] += len(rows)
        return len(rows)

    def flush(self) -> int:
        """Write every dirty row back (rows stay resident, now clean).
        Returns the number of rows written."""
        rows = np.flatnonzero(self._valid & self._dirty)
        n = self.writeback(rows)
        self._dirty[rows] = False
        self.counters["flushes"] += 1
        return n

    def drop(self) -> None:
        """Forget the whole resident set WITHOUT writeback (restore path:
        the cold store was rebuilt — the tier refills on miss)."""
        self._reset_resident_set()

    def on_reshard(self, plan=None) -> int:
        """Reshard hook: flush dirty resident rows and KEEP the resident
        set (residency is keyed by feasign, not by PS shard). Returns
        rows flushed."""
        n = self.flush()
        self.counters["reshards"] += 1
        return n

    def invalidate(self, keys: np.ndarray) -> int:
        """Forget just these keys' resident rows so the next ensure()
        re-fetches them; dirty rows write back first. Returns the number
        of rows dropped."""
        keys = np.ascontiguousarray(keys, np.uint64)
        rows = self.device_map.lookup_host(keys)
        rows = np.unique(rows[rows >= 0])
        if len(rows) == 0:
            return 0
        self.writeback(rows[self._dirty[rows]])
        self.device_map.remove(self._keys[rows])
        self._valid[rows] = False
        self._dirty[rows] = False
        for r in rows:
            self._free[self._row_bank[r]].append(int(r))
        return len(rows)

    def resident_keys(self) -> np.ndarray:
        """[occupancy] u64 — every key currently resident, in row order
        (a control-plane read; no device I/O)."""
        valid = self._valid.copy()
        return self._keys[valid].copy()

    # -- observability ----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Counters (lifetime-cumulative), hit rate, churn and occupancy."""
        total = self.counters["hits"] + self.counters["misses"]
        tenants = {"tenants": self.tenant_residency()} if self._tenant_slots else {}
        return {
            **self.counters,
            **tenants,
            "hit_rate": self.counters["hits"] / total if total else 0.0,
            "occupancy": int(self._valid.sum()),
            "capacity": self.config.capacity,
            "dirty": int((self._valid & self._dirty).sum()),
            "map_rebuilds": self.device_map.rebuilds,
            "shards": self._n_shards,
            "banks": self._banks,
            "kernels": self.config.kernels,
        }


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def stream_loss_fn(model: nn.Module, dense_x: torch.Tensor, labels: torch.Tensor):
    """EXACTLY the stream trainer's objective (plain mean BCE over the
    model's logits) as a function of (params, pulled embeddings) — the
    tier-less trainer and the hot-tier step share it, so both run the
    same dense graph and the parity contract extends to dense params."""

    def loss_fn(params, emb):
        out = functional_call(model, params, (emb, dense_x))
        return F.binary_cross_entropy_with_logits(out, labels.to(torch.float32))

    return loss_fn


def make_hot_ctr_train_step(model: nn.Module, optimizer, cache_cfg: CacheConfig,
                            slot_ids: Sequence[int], probe_buckets: int = 2,
                            banks: int = 1, kernels: str = "auto",
                            device: Optional[Union[str, torch.device]] = None):
    """Single-card hot-tier step: map probe → pull → fwd/bwd → dense Adam
    → CTR push, all on the card. ``probe_buckets`` and ``banks`` MUST be
    the map's own layout (the trainer passes
    ``tier.device_map.probe_buckets``/``.banks``). ``kernels`` is
    ``"auto"`` (fused ``hot_probe_gather`` + ``hot_scatter_apply``) or
    ``"unfused"`` (``dynamic_map_lookup`` + ``cache_pull`` +
    ``cache_push``) — bit-identical by contract.

    step(params, opt_state, tier_state, map_state, keys_lo [B,S] int32
         (uint32 bit patterns), dense_x [B,D], labels [B])
      → (params, opt_state, tier_state, loss)

    ``tier_state`` is updated in place and returned. ``device`` defaults
    to ``"cuda"`` (raises without a GPU)."""
    enforce(kernels in _KERNELS, f"kernels must be one of {_KERNELS}, got {kernels!r}")
    dev = resolve_device(device)
    slot_hi = torch.as_tensor(np.asarray(slot_ids, np.int32), device=dev)
    fused = kernels == "auto"

    def step(params, opt_state, tier_state, map_state, keys_lo, dense_x, labels):
        enforce(keys_lo.device.type == dev.type,
                f"keys are on {keys_lo.device}, the step was built for {dev}")
        B, S = keys_lo.shape
        hi = slot_hi[None, :].expand(B, S).reshape(-1)
        lo = keys_lo.reshape(-1)
        C = tier_state["embed_w"].shape[0]
        if fused:
            # ONE kernel: probe buckets + matched value row
            rows, emb = hot_probe_gather(map_state, hi, lo, tier_state,
                                         probe_buckets=probe_buckets, banks=banks)
            rows = torch.where(rows >= 0, rows, C)
        else:
            rows = dynamic_map_lookup(map_state, hi, lo, probe_buckets, banks)
            # ensure() guarantees residency; sentinel-map anyway (a miss
            # pulls zeros and drops its push instead of corrupting C-1)
            rows = torch.where(rows >= 0, rows, C).to(torch.int64)
            emb = cache_pull(tier_state, rows)
        emb = emb.reshape(B, S, -1).requires_grad_(True)
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        loss = stream_loss_fn(model, dense_x, labels)(leaves, emb)
        *g, emb_grad = torch.autograd.grad(loss, [*leaves.values(), emb])
        new_params, new_opt = optimizer.update(dict(zip(leaves, g)), opt_state, params)
        shows = torch.ones(B * S, dtype=torch.float32, device=dev)
        clicks = torch.repeat_interleave(labels.to(torch.float32), S)
        push = hot_scatter_apply if fused else cache_push
        with torch.no_grad():
            push(tier_state, rows, emb_grad.reshape(B * S, -1).contiguous(), shows,
                 clicks, cache_cfg)
        return new_params, new_opt, tier_state, loss.detach()

    return step


def make_sharded_hot_train_step(model: nn.Module, optimizer, cache_cfg: CacheConfig,
                                mesh: Mesh, slot_ids: Sequence[int], axis: str = "ps",
                                routing="auto", cap_factor: float = 2.0,
                                pre_dedup: bool = True, probe_buckets: int = 2,
                                banks: int = 1, kernels: str = "auto"):
    """The sharded hot-tier step over ``mesh``'s K shards: each shard
    probes its slice of the batch against the one key map
    (``hot_probe`` for ``kernels="auto"``, ``dynamic_map_lookup`` for
    ``"unfused"``), the rows ride the routed or gathered exchange of
    ``ps.sharded_cache``, and the OWNER shard applies the push to its
    row block (``hot_scatter_apply`` / ``cache_push``). ``banks`` must be
    a multiple of K (the tier's own layout: a key's row lies in its owner
    shard's block). ``probe_buckets`` and ``banks`` are the map's.

    step(params, opt_state, tier_state, map_state, keys_lo [B,S] int32,
         dense_x [B,D], labels [B])
      → (params, opt_state, tier_state, loss, overflow)

    B must split into K equal slices. ``tier_state`` is updated in place
    and returned; ``overflow`` is an int32 device scalar
    (``ps.sharded_cache.check_route_overflow``)."""
    enforce(kernels in _KERNELS, f"kernels must be one of {_KERNELS}, got {kernels!r}")
    slot_hi = torch.as_tensor(np.asarray(slot_ids, np.int32), device=mesh.device)
    probe = hot_probe if kernels == "auto" else (
        lambda ms, hi, lo, **kw: dynamic_map_lookup(ms, hi, lo, **kw))
    lookup = lambda ms, hi, lo: probe(ms, hi, lo, probe_buckets=probe_buckets, banks=banks)
    return _make_sharded_step(model, optimizer, cache_cfg, mesh, axis, routing, cap_factor,
                              pre_dedup, _keyed_rows(lookup, slot_hi),
                              hot_scatter_apply if kernels == "auto" else None)
