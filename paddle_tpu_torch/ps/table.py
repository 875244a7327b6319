"""The host sparse tables that back a training pass.

The port's own copy of ``MemorySparseTable`` and ``SsdSparseTable`` from
``paddle_tpu.ps.table``:

- ``MemorySparseTable``, with the Python-shard backend: N local shards, feasign-routed
  (``shard = key % shard_num``), insert-on-miss pull, push through the
  CTR accessor, and the full-row export/import the pass cache builds from
  and flushes back to. Columnar numpy blocks per shard; the key→row map
  of each shard is the native ``FeasignIndex``.
- ``NativeMemorySparseTable`` (``TableConfig(backend="native")``), the same
  table API on the native RAM engine the PS servers run
  (``ps.native.NativeSparseTableEngine``): row creation and every rule
  update bit for bit a server's. The measured-placement collective plane
  (``distributed.placement``) keeps its rows in one. The Python shards
  draw new rows from a per-shard generator, so with a nonzero
  ``initial_range`` their rows differ from a server's.
- ``SsdSparseTable``, the two-tier table over the native SSD engine
  (``ps.native.SsdTableEngine``): a RAM hot tier plus per-shard disk
  logs, the same table API, and ``spill``/``compact``/``load_cold``.
- ``MemoryDenseTable`` (server-side SGD/Adam/sum over a dense block),
  ``MemorySparseGeoTable`` (GEO delta accumulation), ``BarrierTable`` and
  ``GlobalStepTable``: the in-process tables behind ``ps.client``'s
  ``LocalPsClient``.

The three sparse tables' ``pull_sparse``, ``push_sparse``, ``export_full``
and ``import_full`` run in the profiler scopes of the JAX package's
``MemorySparseTable`` (``core.profiler.RecordEvent``: the reference's
CostProfiler probes ``pserver_sparse_select_all``, ``_update_all``,
``_export_full`` and ``_import_full``), whichever engine holds the rows.

Both save and load per-shard text files in the accessor's format, byte
for byte the JAX package's (``part-NNNNN.shard[.gz]`` and a
``meta.json``), through an optional named converter (``"gzip"``), with
the save modes 0 (all), 1 (delta), 2 (base) and 3 (batch model). A load
re-routes rows by the loading table's own ``shard_num``.
"""

from __future__ import annotations

import dataclasses
import functools
import gzip
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.enforce import InvalidArgumentError, enforce, enforce_eq
from ..core.profiler import RecordEvent
from .accessor import AccessorConfig, CtrCommonAccessor, FeatureBlock, accessor_class, make_accessor
from .native import FeasignIndex, NativeSparseTableEngine, SsdTableEngine

__all__ = ["BarrierTable", "GlobalStepTable", "MemoryDenseTable", "MemorySparseGeoTable",
           "MemorySparseTable", "NativeMemorySparseTable", "SsdSparseTable", "TableConfig",
           "converter_entry",
           "make_sparse_table", "merge_duplicate_keys", "register_converter", "row_digest"]

_SAVE_MODE_ALL = 0

# -- save/load converters -------------------------------------------------------
# A converter is (file suffix, open for writing, open for reading) over
# text streams, the reference's accessor DataConverter role; "gzip" is
# built in, and its files are the JAX package's.

_CONVERTERS: Dict[str, Tuple[str, object, object]] = {}


def register_converter(name: str, suffix: str, open_write, open_read) -> None:
    """Register a named shard-file converter. ``open_write(path)`` /
    ``open_read(path)`` return text-mode file objects."""
    _CONVERTERS[name] = (suffix, open_write, open_read)


register_converter("gzip", ".gz", lambda p: gzip.open(p, "wt"), lambda p: gzip.open(p, "rt"))


def converter_entry(name: Optional[str]):
    """(suffix, open_write, open_read) for ``name``; plain text when None."""
    if name is None:
        return "", (lambda p: open(p, "w")), (lambda p: open(p))
    enforce(name in _CONVERTERS,
            f"unknown save converter {name!r} (registered: {sorted(_CONVERTERS)})")
    return _CONVERTERS[name]


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
    """Mirrors TableParameter (ps.proto:121) for the port's tables: the CTR
    accessor, Python shards in RAM or the two-tier SSD engine, and the
    value encodings of the RPC wire (``ps.rpc`` checks them when it
    creates the table; local tables ignore them)."""

    #: the table's id on a PS client (``ps.client``, ``ps.rpc``)
    table_id: int = 0
    shard_num: int = 16
    accessor_config: Optional[AccessorConfig] = None
    seed: int = 0
    accessor: str = "ctr"
    # a "memory" table's engine: "python" = MemorySparseTable's shards (what
    # the JAX package's backend="python" computes); "native" =
    # NativeMemorySparseTable, the PS servers' C++ engine
    backend: str = "python"
    # "memory" = MemorySparseTable; "ssd" = SsdSparseTable (needs ssd_path)
    storage: str = "memory"
    ssd_path: Optional[str] = None
    # the SSD tier's value columns (embed_w, embedx_w) on disk: "fp32",
    # or "fp16" with f32 optimizer state; every read widens to f32
    ssd_value_dtype: str = "fp32"
    # named shard-file converter of save/load ("gzip" built in)
    converter: Optional[str] = None
    # pull-value encoding on the RPC wire: "fp32" exact, or "fp16" (the
    # server rounds to nearest even, the client widens back)
    pull_wire_dtype: str = "fp32"
    # push-gradient encoding on the RPC wire: "fp32" exact; "fp16" halves
    # the gradient block; "int8" = block-quantized int8 with one fp32 absmax
    # scale a block, plus a client-side fp32 error-feedback residual per
    # (table, key) folded into the key's next push and drained over the fp32
    # wire at Communicator.quiesce(). The slot/show/click head stays fp32;
    # the server dequantizes before it applies.
    push_wire_dtype: str = "fp32"
    # int8 scale block (gradient elements per scale; blocks tile a row)
    push_wire_block: int = 128
    # int8 only: keep the quantization error client-side and re-inject it
    push_error_feedback: bool = True


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

    def shrink(self) -> int:
        """The accessor's daily shrink over every live row; erases the
        rows it drops. Returns their count."""
        with self.lock:
            keys, rows = self.index.items()
            if len(rows) == 0:
                return 0
            keep = self.accessor.shrink(self.block, rows)
            self.index.erase(keys[~keep])
            self.initialized[rows[~keep]] = False
            return int((~keep).sum())

    def save_items(self, mode: int) -> Tuple[np.ndarray, np.ndarray]:
        """(keys, rows) that pass the save filter of ``mode``, after the
        accessor's update_stat_after_save on them."""
        with self.lock:
            keys, rows = self.index.items()
            if len(rows) == 0:
                return keys, rows
            keep = self.accessor.save_filter(self.block, rows, mode)
            self.accessor.update_stat_after_save(self.block, rows[keep], mode)
            return keys[keep], rows[keep]

    def full_rows(self, rows: np.ndarray) -> np.ndarray:
        """Full-layout rows of the block's ``rows`` (the caller holds the
        lock or owns the rows, as the save path does after
        :meth:`save_items`)."""
        b = self.block
        es = self.accessor.embed_rule.state_dim
        xd = self.accessor.config.embedx_dim
        out = np.zeros((len(rows), 7 + es + xd + self.accessor.embedx_rule.state_dim),
                       np.float32)
        out[:, 0] = b.slot[rows]
        out[:, 1] = b.unseen_days[rows]
        out[:, 2] = b.delta_score[rows]
        out[:, 3] = b.show[rows]
        out[:, 4] = b.click[rows]
        out[:, 5] = b.embed_w[rows, 0]
        out[:, 6:6 + es] = b.embed_state[rows]
        out[:, 6 + es] = b.has_embedx[rows].astype(np.float32)
        out[:, 7 + es:7 + es + xd] = b.embedx_w[rows]
        out[:, 7 + es + xd:] = b.embedx_state[rows]
        return out

    def export(self, keys: np.ndarray, full_dim: int) -> Tuple[np.ndarray, np.ndarray]:
        """Full-layout rows of ``keys`` (zeros where absent) and found."""
        with self.lock:
            rows = self.index.lookup(keys)
            ok = rows >= 0
            out = np.zeros((len(keys), full_dim), np.float32)
            out[ok] = self.full_rows(rows[ok])
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


def _scoped(name: str):
    """Run the method in the profiler scope ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            with RecordEvent(name):
                return fn(*args, **kw)
        return run
    return wrap


_SELECT_ALL = _scoped("pserver_sparse_select_all")
_UPDATE_ALL = _scoped("pserver_sparse_update_all")
_EXPORT_FULL = _scoped("pserver_sparse_export_full")
_IMPORT_FULL = _scoped("pserver_sparse_import_full")


class MemorySparseTable:
    """Sparse embedding table over N local Python shards."""

    def __init__(self, config: Optional[TableConfig] = None) -> None:
        self.config = config or TableConfig()
        self.accessor = make_accessor(self.config.accessor, self.config.accessor_config)
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

    @_SELECT_ALL
    def pull_sparse(self, keys: np.ndarray, slots: Optional[np.ndarray] = None,
                    create: bool = True) -> np.ndarray:
        """Batched pull with insert-on-miss (memory_sparse_table.cc:443)."""
        out = np.zeros((len(keys), self.accessor.pull_dim), np.float32)
        for sel, vals in self._scatter_gather(
                keys, lambda sh, k, s: sh.pull(k, s, create), slots):
            out[sel] = vals
        return out

    @_UPDATE_ALL
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

    @_EXPORT_FULL
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

    @_IMPORT_FULL
    def import_full(self, keys: np.ndarray, values: np.ndarray) -> None:
        """Direct overwrite of full rows (insert-on-miss)."""
        self._scatter_gather(keys, lambda sh, k, v: sh.import_rows(k, v), values)

    def size(self) -> int:
        return sum(len(sh.index) for sh in self._shards)

    def shard_sizes(self) -> np.ndarray:
        return np.asarray([len(sh.index) for sh in self._shards], np.int64)

    def shrink(self) -> int:
        """The daily shrink (decay, age, delete); returns the rows erased."""
        return sum(sh.shrink() for sh in self._shards)

    def flush(self) -> None:
        """Writes are synchronous: nothing to flush."""

    def snapshot_items(self, mode: int = _SAVE_MODE_ALL) -> Tuple[np.ndarray, np.ndarray]:
        """(keys [n] u64, full rows [n, full_dim]) of the live features
        that pass the save filter of ``mode`` (0: all), after the
        accessor's update_stat_after_save: what :meth:`save` writes, in
        binary."""
        per = [(sh.save_items(mode), sh) for sh in self._shards]
        keys = np.concatenate([k for (k, _), _ in per]) if per else np.zeros(0, np.uint64)
        values = (np.concatenate([sh.full_rows(r) for (_, r), sh in per]) if per
                  else np.zeros((0, self.full_dim), np.float32))
        return keys, values

    def digest(self) -> int:
        """Order-independent content digest of every live row."""
        return row_digest(*self.snapshot_items(_SAVE_MODE_ALL))

    # -- save/load: per-shard text files in the accessor's format -----------

    def save(self, dirname: str, mode: int = _SAVE_MODE_ALL,
             converter: Optional[str] = None) -> int:
        """Write ``part-NNNNN.shard[suffix]`` per shard (rows routed by
        ``key % shard_num``, one line each in the accessor's text format)
        and ``meta.json``; ``converter`` defaults to ``config.converter``.
        Returns the rows written."""
        os.makedirs(dirname, exist_ok=True)
        conv = converter if converter is not None else self.config.converter
        suffix, open_w, _ = converter_entry(conv)
        keys, values = self.snapshot_items(mode)
        shard_of = (keys % np.uint64(self.config.shard_num)).astype(np.int64)
        order = np.argsort(shard_of, kind="stable")
        bounds = np.searchsorted(shard_of[order], np.arange(self.config.shard_num + 1))
        fmt = self.accessor.format_row
        for i in range(self.config.shard_num):
            with open_w(os.path.join(dirname, f"part-{i:05d}.shard{suffix}")) as f:
                for j in order[bounds[i]:bounds[i + 1]]:
                    f.write(fmt(keys[j], values[j]) + "\n")
        self._write_meta(dirname, mode, conv)
        return len(keys)

    def _write_meta(self, dirname: str, mode: int, converter: Optional[str] = None) -> None:
        with open(os.path.join(dirname, "meta.json"), "w") as f:
            json.dump({"shard_num": self.config.shard_num,
                       "embedx_dim": self.accessor.config.embedx_dim,
                       "accessor": self.config.accessor, "mode": mode,
                       "converter": converter}, f)

    def load(self, dirname: str) -> int:
        """Load the rows of a :meth:`save` directory (either package's);
        returns their count."""
        with open(os.path.join(dirname, "meta.json")) as f:
            meta = json.load(f)
        enforce_eq(meta["embedx_dim"], self.accessor.config.embedx_dim, "embedx_dim mismatch")
        enforce(accessor_class(meta.get("accessor", "ctr")).parse_row
                is type(self.accessor).parse_row,
                f"checkpoint written by accessor {meta.get('accessor')!r} cannot load into "
                f"{self.config.accessor!r}")
        suffix, _, open_r = converter_entry(meta.get("converter"))
        parse = self.accessor.parse_row
        total = 0
        for i in range(meta["shard_num"]):
            path = os.path.join(dirname, f"part-{i:05d}.shard{suffix}")
            if not os.path.exists(path):
                continue
            keys, rows = [], []
            with open_r(path) as f:
                for line in f:
                    parts = line.split()
                    if parts:
                        k, row = parse(parts, self.full_dim)
                        keys.append(k)
                        rows.append(row)
            if keys:
                self._load_rows(np.asarray(keys, np.uint64), np.stack(rows))
                total += len(keys)
        return total

    def _load_rows(self, keys: np.ndarray, values: np.ndarray) -> None:
        """Where a load puts its rows (the SSD table: its disk tier)."""
        self.import_full(keys, values)


class NativeMemorySparseTable(MemorySparseTable):
    """The RAM table on the native engine the PS servers run
    (``ps.native.NativeSparseTableEngine``): the same API as
    :class:`MemorySparseTable`, with every row created and updated as a
    server's RAM table does it, so a local copy of a server's rows trains
    bit for bit as the server would."""

    def __init__(self, config: Optional[TableConfig] = None) -> None:
        self.config = config or TableConfig(backend="native")
        self.accessor = make_accessor(self.config.accessor, self.config.accessor_config)
        self._engine = NativeSparseTableEngine(self.config.shard_num, self.config.accessor,
                                               self.accessor.config, self.config.seed)

    def close(self) -> None:
        """Release the engine."""
        self._engine.close()

    @_SELECT_ALL
    def pull_sparse(self, keys: np.ndarray, slots: Optional[np.ndarray] = None,
                    create: bool = True) -> np.ndarray:
        return self._engine.pull(keys, slots, create)

    @_UPDATE_ALL
    def push_sparse(self, keys: np.ndarray, push_values: np.ndarray) -> None:
        keys, push_values = merge_duplicate_keys(
            np.ascontiguousarray(keys, np.uint64), push_values)
        self._engine.push(keys, push_values)

    @_EXPORT_FULL
    def export_full(self, keys: np.ndarray, create: bool = False,
                    slots: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        return self._engine.export_full(keys, create=create, slots=slots)

    @_IMPORT_FULL
    def import_full(self, keys: np.ndarray, values: np.ndarray) -> None:
        self._engine.insert_full(keys, values)

    def size(self) -> int:
        return self._engine.size()

    def shard_sizes(self) -> np.ndarray:
        return self._engine.shard_sizes(self.config.shard_num)

    def shrink(self) -> int:
        return self._engine.shrink()

    def snapshot_items(self, mode: int = _SAVE_MODE_ALL) -> Tuple[np.ndarray, np.ndarray]:
        return self._engine.save_items(mode)

    def digest(self) -> int:
        return self._engine.digest()


class SsdSparseTable(MemorySparseTable):
    """Two-tier sparse table: a RAM hot tier plus per-shard disk logs, on
    the native SSD engine (``ps.native.SsdTableEngine``). Reads promote
    a cold row into RAM, :meth:`spill` moves the coldest rows back to
    disk, shrink and save cover both tiers, and reopening a path replays
    its logs. The same table API as :class:`MemorySparseTable`, so the
    pass cache and the trainers work over it unchanged; a load goes to
    the disk tier."""

    def __init__(self, path: str, config: Optional[TableConfig] = None) -> None:
        self.config = config or TableConfig()
        self.path = str(path)
        self.accessor = make_accessor(self.config.accessor, self.config.accessor_config)
        enforce(self.config.ssd_value_dtype in ("fp32", "fp16"),
                f"TableConfig.ssd_value_dtype must be 'fp32' or 'fp16', "
                f"got {self.config.ssd_value_dtype!r}", InvalidArgumentError)
        self._engine = SsdTableEngine(self.config.shard_num, self.config.accessor,
                                      self.accessor.config, self.config.seed, self.path,
                                      value_f16=self.config.ssd_value_dtype == "fp16")

    def close(self) -> None:
        """Flush the logs and release the engine."""
        self._engine.close()

    @_SELECT_ALL
    def pull_sparse(self, keys: np.ndarray, slots: Optional[np.ndarray] = None,
                    create: bool = True) -> np.ndarray:
        return self._engine.pull(keys, slots, create)

    @_UPDATE_ALL
    def push_sparse(self, keys: np.ndarray, push_values: np.ndarray) -> None:
        self._engine.push(*merge_duplicate_keys(np.ascontiguousarray(keys, np.uint64),
                                                push_values))

    @property
    def full_dim(self) -> int:
        return self._engine.full_dim

    @_EXPORT_FULL
    def export_full(self, keys: np.ndarray, create: bool = False,
                    slots: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        return self._engine.export_full(keys, create=create, slots=slots)

    @_IMPORT_FULL
    def import_full(self, keys: np.ndarray, values: np.ndarray) -> None:
        self._engine.insert_full(keys, values)

    def size(self) -> int:
        return self._engine.size()

    def shard_sizes(self) -> np.ndarray:
        return self._engine.shard_sizes(self.config.shard_num)

    def shrink(self) -> int:
        return self._engine.shrink()

    def flush(self) -> None:
        self._engine.flush()

    def snapshot_items(self, mode: int = _SAVE_MODE_ALL) -> Tuple[np.ndarray, np.ndarray]:
        return self._engine.save_items(mode)

    def digest(self) -> int:
        """Content digest over both tiers (the RAM table's for the same
        logical rows)."""
        return self._engine.digest()

    def spill(self, hot_budget: int) -> int:
        """Move the coldest rows (most unseen days, then lowest score) to
        disk until at most ``hot_budget`` stay in RAM; returns the rows
        moved."""
        return self._engine.spill(int(hot_budget))

    def compact(self) -> int:
        """Rewrite the logs to their live records; returns disk bytes."""
        return self._engine.compact()

    def stats(self) -> Dict[str, float]:
        """Tier counts and disk use (``ps.native.SST_STAT_FIELDS``) and
        the cold index's bytes per row."""
        out: Dict[str, float] = dict(self._engine.stats())
        out["index_bytes_per_row"] = (out["index_bytes"] / out["cold_rows"]
                                      if out["cold_rows"] else 0.0)
        return out

    def load_cold(self, keys: np.ndarray, values: np.ndarray) -> None:
        """Bulk-load full rows into the disk tier (a population at scale:
        training promotes the rows it touches)."""
        self._engine.load_cold(keys, values)

    def _load_rows(self, keys: np.ndarray, values: np.ndarray) -> None:
        self._engine.load_cold(keys, values)


def make_sparse_table(config: TableConfig) -> MemorySparseTable:
    """``config.storage`` picks a RAM table ("memory": ``config.backend``
    picks MemorySparseTable or NativeMemorySparseTable) or SsdSparseTable
    ("ssd", at ``config.ssd_path``)."""
    if config.storage == "memory":
        enforce(config.backend in ("python", "native"),
                f"unknown table backend {config.backend!r}; have python|native",
                InvalidArgumentError)
        return (NativeMemorySparseTable(config) if config.backend == "native"
                else MemorySparseTable(config))
    if config.storage == "ssd":
        enforce(config.ssd_path is not None, "TableConfig.storage='ssd' requires ssd_path",
                InvalidArgumentError)
        return SsdSparseTable(config.ssd_path, config)
    raise InvalidArgumentError(f"unknown table storage {config.storage!r}; have memory|ssd")


class MemoryDenseTable:
    """A dense block with a server-side optimizer (memory_dense_table.cc:
    "sgd", "adam", or "sum" for a raw accumulator)."""

    def __init__(self, dim: int, optimizer: str = "adam", lr: float = 0.001) -> None:
        enforce(optimizer in ("sgd", "adam", "sum"),
                f"unknown dense optimizer {optimizer!r}", InvalidArgumentError)
        self.dim = dim
        self.values = np.zeros(dim, np.float32)
        self.optimizer = optimizer
        self.lr = lr
        if optimizer == "adam":
            self.m = np.zeros(dim, np.float32)
            self.v = np.zeros(dim, np.float32)
            self.beta1, self.beta2, self.eps = 0.9, 0.999, 1e-8
            self.t = 0
        self.lock = threading.Lock()

    def pull_dense(self) -> np.ndarray:
        return self.values.copy()

    def push_dense(self, grad: np.ndarray) -> None:
        with self.lock:
            if self.optimizer == "sgd":
                self.values -= self.lr * grad
            elif self.optimizer == "sum":
                self.values += grad
            else:
                self.t += 1
                self.m = self.beta1 * self.m + (1 - self.beta1) * grad
                self.v = self.beta2 * self.v + (1 - self.beta2) * grad * grad
                m_hat = self.m / (1 - self.beta1 ** self.t)
                v_hat = self.v / (1 - self.beta2 ** self.t)
                self.values -= self.lr * m_hat / (np.sqrt(v_hat) + self.eps)

    def set_values(self, values: np.ndarray) -> None:
        with self.lock:
            self.values[:] = values


class MemorySparseGeoTable:
    """GEO-SGD delta table (memory_sparse_geo_table + geo_recorder): sums
    per-key deltas and their count; :meth:`pull_geo` drains the means."""

    def __init__(self, embedding_dim: int) -> None:
        self.dim = embedding_dim
        self._index = FeasignIndex(256)
        self._delta = np.zeros((0, embedding_dim), np.float32)
        self._count = np.zeros(0, np.int32)
        self.lock = threading.Lock()

    def push_delta(self, keys: np.ndarray, delta: np.ndarray) -> None:
        with self.lock:
            rows, _ = self._index.lookup_or_insert(np.ascontiguousarray(keys, np.uint64))
            cap = self._index.row_capacity
            if cap > len(self._delta):
                grow = max(256, cap)
                nd = np.zeros((grow, self.dim), np.float32)
                nc = np.zeros(grow, np.int32)
                nd[:len(self._delta)] = self._delta
                nc[:len(self._count)] = self._count
                self._delta, self._count = nd, nc
            np.add.at(self._delta, rows, delta)
            np.add.at(self._count, rows, 1)

    def pull_geo(self) -> Tuple[np.ndarray, np.ndarray]:
        """(keys, mean deltas) of every key pushed since the last drain."""
        with self.lock:
            keys, rows = self._index.items()
            if len(keys) == 0:
                return keys, np.zeros((0, self.dim), np.float32)
            deltas = self._delta[rows] / np.maximum(self._count[rows], 1)[:, None]
            self._index.erase(keys)
            self._delta[rows] = 0
            self._count[rows] = 0
            return keys, deltas


class BarrierTable:
    """All-trainer barrier (barrier_table.cc:76), in process."""

    def __init__(self, trainer_num: int) -> None:
        self.trainer_num = trainer_num
        self._barrier = threading.Barrier(trainer_num)

    def barrier(self, timeout: Optional[float] = None) -> None:
        self._barrier.wait(timeout=timeout)


class GlobalStepTable:
    """The global-step accumulator (tensor_table.h:257), with an optional
    callback on the accumulated step (the server-side LR decay hook)."""

    def __init__(self, decay_fn=None) -> None:
        self._step = 0
        self._decay_fn = decay_fn
        self.lock = threading.Lock()

    def push_step(self, n: int = 1) -> int:
        with self.lock:
            self._step += int(n)
            if self._decay_fn is not None:
                self._decay_fn(self._step)
            return self._step

    @property
    def step(self) -> int:
        return self._step
