"""ctypes bindings for the port's host library (``csrc/``).

``sparse_index.cc`` (the feasign index and the parallel pass dedup),
``cuckoo.cc`` (the per-pass device key map build), ``slot_parser.cc``
(the MultiSlot text parser of the dataset) and ``data_feed.cc`` (the
threaded file reader over that parser, :class:`NativeDataFeed`) are the
port's own copies of the JAX package's sources. They build at first use
with ``g++ -O3 -ffp-contract=off -std=c++17 -fPIC -shared`` into the
gitignored build directory (``ops/_build.py``). There is no Python
fallback: ``dedup_u64``'s order fixes the cache row ids of a pass, and a
different dedup would give different rows.

The SSD tier (``ssd_table.cc`` over ``sparse_table.h``, the port's copies
too) builds the same way into a second library, linked with zlib
(``-lz``), so the host library's build does not need zlib and a machine
without it fails only the paths that open an SSD table. Only what the
pass trainer's daily loop calls is bound (:class:`SsdTableEngine`); the
engine's admission sketch, IO budget, background compaction and
streaming file save/load are not (ROADMAP Queue A).

The PS service (``ps_service.cc`` with ``graph_store.h``, the port's
copies of the TCP server and client of ``ps.rpc``) calls the SSD
engine's ``sst_*`` and zlib, so it builds into the same second library,
and :func:`load_ssd` loads both. Bound: the server lifecycle, the
mutation gate, the high-availability controls (the oplog tap and its
consumer, the create catalog, epoch, applied seq, read-only mode, dense
version, the server's faults), the connection and the scatter-gather call
(``psc_callv``). The tenancy and obs symbols are in the library but not
bound (ROADMAP Queue A item 3, entries 4 and 6).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from ..ops._build import build_shared_library

__all__ = ["FeasignIndex", "NativeDataFeed", "SST_STAT_FIELDS", "SlotParser", "SsdTableEngine",
           "cuckoo_build", "dedup_u64", "load_native", "load_ssd", "table_native_params"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
_SOURCES = tuple(os.path.join(_CSRC, f)
                 for f in ("sparse_index.cc", "cuckoo.cc", "slot_parser.cc", "data_feed.cc"))
_SSD_SOURCES = tuple(os.path.join(_CSRC, f) for f in ("ssd_table.cc", "ps_service.cc",
                                                      "sparse_table.h", "graph_store.h"))
_LOCK = threading.Lock()
_SSD_LOCK = threading.Lock()  # its own, so the two builds run side by side
_LIB: Optional[ctypes.CDLL] = None
_SSD_LIB: Optional[ctypes.CDLL] = None


def _gxx_command(out: str):
    # -ffp-contract=off mirrors paddle_tpu/csrc/Makefile; no -march=native
    # so the library runs on whatever host the checkout lands on
    return ["g++", "-O3", "-ffp-contract=off", "-std=c++17", "-fPIC",
            "-shared", "-o", out, *_SOURCES, "-lpthread"]


def _gxx_ssd_command(out: str):
    # the headers join the build's digest (_SSD_SOURCES), not the argv
    return ["g++", "-O3", "-ffp-contract=off", "-std=c++17", "-fPIC",
            "-shared", "-o", out, *_SSD_SOURCES[:2], "-lpthread", "-lz"]


def load_native() -> ctypes.CDLL:
    """Build (first use) and load the host library; raises on failure."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_shared_library("paddle_tpu_torch_host",
                                                   _SOURCES, _gxx_command))
            _configure(lib)
            _LIB = lib
        return _LIB


def load_ssd() -> ctypes.CDLL:
    """Build (first use) and load the SSD tier's library, which holds the
    PS service too; raises on failure (a missing zlib included)."""
    global _SSD_LIB
    with _SSD_LOCK:
        if _SSD_LIB is None:
            lib = ctypes.CDLL(build_shared_library("paddle_tpu_torch_ssd", _SSD_SOURCES,
                                                   _gxx_ssd_command))
            _configure_sst(lib)
            _configure_rpc(lib)
            _SSD_LIB = lib
        return _SSD_LIB


def _configure(lib: ctypes.CDLL) -> None:
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.psidx_create.restype = ctypes.c_void_p
    lib.psidx_create.argtypes = [ctypes.c_uint64]
    lib.psidx_destroy.restype = None
    lib.psidx_destroy.argtypes = [ctypes.c_void_p]
    lib.psidx_size.restype = ctypes.c_int64
    lib.psidx_size.argtypes = [ctypes.c_void_p]
    lib.psidx_row_capacity.restype = ctypes.c_int64
    lib.psidx_row_capacity.argtypes = [ctypes.c_void_p]
    lib.psidx_lookup_mt.restype = None
    lib.psidx_lookup_mt.argtypes = [ctypes.c_void_p, u64p, ctypes.c_int64,
                                    i32p, ctypes.c_int32]
    lib.psidx_lookup_or_insert.restype = ctypes.c_int64
    lib.psidx_lookup_or_insert.argtypes = [ctypes.c_void_p, u64p,
                                           ctypes.c_int64, i32p]
    lib.psidx_items.restype = None
    lib.psidx_items.argtypes = [ctypes.c_void_p, u64p, i32p]
    lib.psidx_erase.restype = None
    lib.psidx_erase.argtypes = [ctypes.c_void_p, u64p, ctypes.c_int64]
    lib.ps_dedup_u64.restype = ctypes.c_int64
    lib.ps_dedup_u64.argtypes = [u64p, ctypes.c_int64, u64p, ctypes.c_int32]
    lib.cuckoo_build.restype = ctypes.c_int64
    lib.cuckoo_build.argtypes = [u64p, i32p, ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_uint32, u32p, u32p, i32p]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.slotp_create.restype = ctypes.c_void_p
    lib.slotp_create.argtypes = [ctypes.c_int, u8p, u8p]
    lib.slotp_destroy.restype = None
    lib.slotp_destroy.argtypes = [ctypes.c_void_p]
    lib.slotp_parse.restype = ctypes.c_int64
    lib.slotp_parse.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.slotp_lines.restype = ctypes.c_int64
    lib.slotp_lines.argtypes = [ctypes.c_void_p]
    lib.slotp_errors.restype = ctypes.c_int64
    lib.slotp_errors.argtypes = [ctypes.c_void_p]
    lib.slotp_slot_value_count.restype = ctypes.c_int64
    lib.slotp_slot_value_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.slotp_slot_fetch.restype = None
    lib.slotp_slot_fetch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, i32p]
    lib.slotp_reset.restype = None
    lib.slotp_reset.argtypes = [ctypes.c_void_p]
    lib.dfd_create.restype = ctypes.c_void_p
    lib.dfd_create.argtypes = [ctypes.c_int, u8p, u8p, ctypes.c_char_p, ctypes.c_int,
                               ctypes.c_int]
    lib.dfd_destroy.restype = None
    lib.dfd_destroy.argtypes = [ctypes.c_void_p]
    lib.dfd_next.restype = ctypes.c_int64
    lib.dfd_next.argtypes = [ctypes.c_void_p]
    lib.dfd_value_count.restype = ctypes.c_int64
    lib.dfd_value_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dfd_fetch.restype = None
    lib.dfd_fetch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, i32p]
    lib.dfd_release.restype = None
    lib.dfd_release.argtypes = [ctypes.c_void_p]
    lib.dfd_errors.restype = ctypes.c_int64
    lib.dfd_errors.argtypes = [ctypes.c_void_p]


def _u64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def cuckoo_build(keys: np.ndarray, rows: np.ndarray, nbuckets: int,
                 seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static bucketized-cuckoo table (csrc/cuckoo.cc) mapping uint64
    feasign → int32 row: (hi, lo, row) arrays of ``nbuckets*4`` entries.
    Raises RuntimeError when a key cannot be placed (retry a new seed)."""
    lib = load_native()
    keys = np.ascontiguousarray(keys, np.uint64)
    rows = np.ascontiguousarray(rows, np.int32)
    hi = np.empty(nbuckets * 4, np.uint32)
    lo = np.empty(nbuckets * 4, np.uint32)
    row = np.empty(nbuckets * 4, np.int32)
    fails = int(lib.cuckoo_build(_u64(keys), _i32(rows), len(keys), nbuckets,
                                 ctypes.c_uint32(seed), _u32(hi), _u32(lo),
                                 _i32(row)))
    if fails:
        raise RuntimeError(f"cuckoo build failed to place {fails} keys")
    return hi, lo, row


def dedup_u64(keys: np.ndarray, n_threads: Optional[int] = None) -> np.ndarray:
    """Distinct keys in the native library's deterministic (unsorted)
    order — the PreBuildTask shard dedup. ``n_threads`` defaults to the
    JAX package's choice, so both packages assign the same rows."""
    keys = np.ascontiguousarray(keys, np.uint64).reshape(-1)
    lib = load_native()
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 1)
    out = np.empty(len(keys), np.uint64)
    n = int(lib.ps_dedup_u64(_u64(keys), len(keys), _u64(out),
                             ctypes.c_int32(n_threads)))
    return out[:n].copy()


class FeasignIndex:
    """Batched feasign→row map over the native open-addressing index."""

    def __init__(self, capacity_hint: int = 1024) -> None:
        self._lib = load_native()
        self._h = self._lib.psidx_create(ctypes.c_uint64(capacity_hint))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.psidx_destroy(self._h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.psidx_size(self._h))

    @property
    def row_capacity(self) -> int:
        """Highest row id ever allocated + 1 (size for value arrays)."""
        return int(self._lib.psidx_row_capacity(self._h))

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """[n] int32 rows, −1 for a key not in the index."""
        keys = np.ascontiguousarray(keys, np.uint64)
        rows = np.empty(len(keys), np.int32)
        self._lib.psidx_lookup_mt(self._h, _u64(keys), len(keys), _i32(rows),
                                  min(8, os.cpu_count() or 1))
        return rows

    def lookup_or_insert(self, keys: np.ndarray) -> Tuple[np.ndarray, int]:
        """(rows, num_new): insert-on-miss pull semantics."""
        keys = np.ascontiguousarray(keys, np.uint64)
        rows = np.empty(len(keys), np.int32)
        n_new = int(self._lib.psidx_lookup_or_insert(self._h, _u64(keys),
                                                     len(keys), _i32(rows)))
        return rows, n_new

    def erase(self, keys: np.ndarray) -> None:
        """Drop ``keys``; their rows go to the index's free list."""
        keys = np.ascontiguousarray(keys, np.uint64)
        self._lib.psidx_erase(self._h, _u64(keys), len(keys))

    def items(self) -> Tuple[np.ndarray, np.ndarray]:
        """(keys, rows) of all live entries."""
        n = len(self)
        keys = np.empty(n, np.uint64)
        rows = np.empty(n, np.int32)
        self._lib.psidx_items(self._h, _u64(keys), _i32(rows))
        return keys, rows


class SlotParser:
    """Batched MultiSlot text parser (``csrc/slot_parser.cc``).

    ``slots``: list of (name, is_float, used). :meth:`parse` consumes a
    text block; :meth:`fetch` returns {slot_name: (values, lengths)} CSR
    pairs for the used slots and resets for the next block."""

    def __init__(self, slots) -> None:
        self.slots = [(str(n), bool(f), bool(u)) for n, f, u in slots]
        self._lib = load_native()
        is_float = np.asarray([f for _, f, _ in self.slots], np.uint8)
        used = np.asarray([u for _, _, u in self.slots], np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        self._h = self._lib.slotp_create(len(self.slots), is_float.ctypes.data_as(u8p),
                                         used.ctypes.data_as(u8p))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.slotp_destroy(self._h)
            self._h = None

    def parse(self, text) -> int:
        """Parse a text block; returns the number of lines parsed OK."""
        data = text.encode() if isinstance(text, str) else bytes(text)
        return int(self._lib.slotp_parse(self._h, data, len(data)))

    @property
    def errors(self) -> int:
        return int(self._lib.slotp_errors(self._h))

    @property
    def lines(self) -> int:
        return int(self._lib.slotp_lines(self._h))

    def fetch(self):
        out = {}
        n_lines = self.lines
        for s, (name, is_float, used) in enumerate(self.slots):
            if not used:
                continue
            count = int(self._lib.slotp_slot_value_count(self._h, s))
            values = np.empty(count, np.float32 if is_float else np.uint64)
            lengths = np.empty(n_lines, np.int32)
            self._lib.slotp_slot_fetch(self._h, s, values.ctypes.data_as(ctypes.c_void_p),
                                       _i32(lengths))
            out[name] = (values, lengths)
        self._lib.slotp_reset(self._h)
        return out


class NativeDataFeed:
    """The threaded MultiSlot file reader (``csrc/data_feed.cc``): reader
    threads take whole files from a queue, parse each with the slot parser
    and hand the chunks through a channel of ``capacity`` chunks; iterating
    yields one {slot_name: (values, lengths)} dict per non-empty file, for
    the used slots. One thread yields the files in order; more yield them
    in the order they finish. A file that cannot be read counts one error
    (:attr:`errors`, with the parser's bad lines). Raises when the host
    library does not build: there is no Python reader behind it."""

    def __init__(self, slots, files, num_threads: int = 4, capacity: int = 8) -> None:
        self.slots = [(str(n), bool(f), bool(u)) for n, f, u in slots]
        self._lib = load_native()
        is_float = np.asarray([f for _, f, _ in self.slots], np.uint8)
        used = np.asarray([u for _, _, u in self.slots], np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        self._h = self._lib.dfd_create(len(self.slots), is_float.ctypes.data_as(u8p),
                                       used.ctypes.data_as(u8p), "\n".join(files).encode(),
                                       int(num_threads), int(capacity))

    def __del__(self):
        self.close()

    def close(self) -> None:
        """Stop and join the readers and free the feed (idempotent)."""
        if getattr(self, "_h", None):
            self._lib.dfd_destroy(self._h)
            self._h = None

    @property
    def errors(self) -> int:
        return int(self._lib.dfd_errors(self._h))

    def __iter__(self):
        while True:
            n = int(self._lib.dfd_next(self._h))
            if n < 0:
                return
            out = {}
            for s, (name, is_float, used) in enumerate(self.slots):
                if not used:
                    continue
                count = int(self._lib.dfd_value_count(self._h, s))
                values = np.empty(count, np.float32 if is_float else np.uint64)
                lengths = np.empty(n, np.int32)
                self._lib.dfd_fetch(self._h, s, values.ctypes.data_as(ctypes.c_void_p),
                                    _i32(lengths))
                out[name] = (values, lengths)
            self._lib.dfd_release(self._h)
            yield out


# -- the SSD tier (csrc/ssd_table.cc) ------------------------------------------

_RULE_IDS = {"naive": 0, "adagrad": 1, "std_adagrad": 2, "adam": 3}
_ACCESSOR_IDS = {"ctr": 0}

# sst_create2 flag bit 0: value columns stored fp16 on disk
SST_FLAG_VALUE_F16 = 1

# sst_stats2's field layout, the csrc SstStatField enum in order
SST_STAT_FIELDS = ("hot_rows", "cold_rows", "disk_bytes", "index_bytes", "sketch_bytes",
                   "admit_checks", "admit_rejects", "admit_admitted", "bg_compactions",
                   "bg_backlog", "io_serve_bytes", "io_bg_bytes", "io_bg_wait_ms",
                   "open_block_bytes")


def table_native_params(shard_num: int, accessor: str, acc_cfg,
                        seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(iparams i32[6], fparams f32[17]) for the native table ABI, the
    layout ``pstpu::parse_table_config`` (``csrc/sparse_table.h``) reads.
    ``acc_cfg`` is an ``AccessorConfig``."""
    sgd = acc_cfg.sgd
    ip = np.asarray(
        [shard_num, _ACCESSOR_IDS[accessor], acc_cfg.embedx_dim,
         _RULE_IDS[acc_cfg.embed_sgd_rule], _RULE_IDS[acc_cfg.embedx_sgd_rule],
         seed], np.int32)
    fp = np.asarray(
        [acc_cfg.nonclk_coeff, acc_cfg.click_coeff, acc_cfg.base_threshold,
         acc_cfg.delta_threshold, acc_cfg.delta_keep_days,
         acc_cfg.show_click_decay_rate, acc_cfg.delete_threshold,
         acc_cfg.delete_after_unseen_days, acc_cfg.embedx_threshold,
         sgd.learning_rate, sgd.initial_g2sum, sgd.initial_range,
         sgd.weight_bounds[0], sgd.weight_bounds[1],
         sgd.beta1, sgd.beta2, sgd.ada_epsilon], np.float32)
    return ip, fp


def _configure_rpc(lib: ctypes.CDLL) -> None:
    """The PS service's server lifecycle, mutation gate and high-availability
    controls, connection and scatter-gather call (``psc_callv`` sends the
    44-byte request header with a zero trace context)."""
    h = ctypes.c_void_p
    lib.pss_create.restype = ctypes.c_void_p
    lib.pss_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.pss_port.restype = ctypes.c_int
    lib.pss_port.argtypes = [h]
    lib.pss_stopped.restype = ctypes.c_int
    lib.pss_stopped.argtypes = [h]
    lib.pss_stop.restype = None
    lib.pss_stop.argtypes = [h]
    lib.pss_destroy.restype = None
    lib.pss_destroy.argtypes = [h]
    lib.pss_pause_mutations.restype = None
    lib.pss_pause_mutations.argtypes = [h, ctypes.c_int]
    lib.psc_connect2.restype = ctypes.c_void_p
    lib.psc_connect2.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.psc_close.restype = None
    lib.psc_close.argtypes = [h]
    lib.psc_callv.restype = ctypes.c_int64
    lib.psc_callv.argtypes = [h, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64,
                              ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_void_p),
                              ctypes.POINTER(ctypes.c_uint64), ctypes.c_int32]
    lib.psc_resp_len.restype = ctypes.c_uint64
    lib.psc_resp_len.argtypes = [h]
    lib.psc_resp_ptr.restype = ctypes.c_void_p
    lib.psc_resp_ptr.argtypes = [h]
    lib.psc_resp_copy.restype = None
    lib.psc_resp_copy.argtypes = [h, ctypes.c_void_p]
    # high availability (ps/ha.py): the oplog tap and its single consumer,
    # the create catalog, epoch and applied seq, read-only mode, the dense
    # version and the server's own faults
    lib.pss_set_replication.restype = None
    lib.pss_set_replication.argtypes = [h, ctypes.c_int, ctypes.c_int64]
    lib.pss_oplog_next.restype = ctypes.c_int64
    lib.pss_oplog_next.argtypes = [h, ctypes.c_int32]
    lib.pss_staged_len.restype = ctypes.c_uint64
    lib.pss_staged_len.argtypes = [h]
    lib.pss_staged_ptr.restype = ctypes.c_void_p
    lib.pss_staged_ptr.argtypes = [h]
    for fn in ("pss_oplog_seq", "pss_oplog_pending", "pss_oplog_dropped", "pss_catalog_count",
               "pss_epoch", "pss_applied_seq", "pss_dense_version"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [h]
    lib.pss_catalog_copy.restype = ctypes.c_int64
    lib.pss_catalog_copy.argtypes = [h, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    lib.pss_set_epoch.restype = None
    lib.pss_set_epoch.argtypes = [h, ctypes.c_int64]
    lib.pss_set_read_only.restype = None
    lib.pss_set_read_only.argtypes = [h, ctypes.c_int]
    lib.pss_read_only.restype = ctypes.c_int
    lib.pss_read_only.argtypes = [h]
    lib.pss_arm_fault.restype = None
    lib.pss_arm_fault.argtypes = [h, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int64,
                                  ctypes.c_int64]


def _configure_sst(lib: ctypes.CDLL) -> None:
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    h = ctypes.c_void_p
    lib.sst_create2.restype = ctypes.c_void_p
    lib.sst_create2.argtypes = [i32p, f32p, ctypes.c_char_p, ctypes.c_int32]
    lib.sst_destroy.restype = None
    lib.sst_destroy.argtypes = [h]
    for fn in ("sst_pull_dim", "sst_push_dim", "sst_full_dim"):
        getattr(lib, fn).restype = ctypes.c_int32
        getattr(lib, fn).argtypes = [h]
    lib.sst_size.restype = ctypes.c_int64
    lib.sst_size.argtypes = [h]
    lib.sst_stats2.restype = ctypes.c_int32
    lib.sst_stats2.argtypes = [h, i64p, ctypes.c_int32]
    lib.sst_shard_sizes.restype = None
    lib.sst_shard_sizes.argtypes = [h, i64p]
    lib.sst_pull.restype = None
    lib.sst_pull.argtypes = [h, u64p, i32p, ctypes.c_int64, ctypes.c_int32, f32p]
    lib.sst_push.restype = None
    lib.sst_push.argtypes = [h, u64p, f32p, ctypes.c_int64]
    lib.sst_export.restype = None
    lib.sst_export.argtypes = [h, u64p, i32p, ctypes.c_int64, ctypes.c_int32, f32p, u8p]
    lib.sst_insert_full.restype = None
    lib.sst_insert_full.argtypes = [h, u64p, f32p, ctypes.c_int64]
    lib.sst_load_cold.restype = ctypes.c_int64
    lib.sst_load_cold.argtypes = [h, u64p, f32p, ctypes.c_int64]
    lib.sst_spill.restype = ctypes.c_int64
    lib.sst_spill.argtypes = [h, ctypes.c_int64]
    lib.sst_shrink.restype = ctypes.c_int64
    lib.sst_shrink.argtypes = [h]
    lib.sst_compact.restype = ctypes.c_int64
    lib.sst_compact.argtypes = [h]
    lib.sst_save_begin.restype = ctypes.c_int64
    lib.sst_save_begin.argtypes = [h, ctypes.c_int32]
    lib.sst_save_fetch.restype = None
    lib.sst_save_fetch.argtypes = [h, u64p, f32p]
    lib.sst_flush.restype = None
    lib.sst_flush.argtypes = [h]
    lib.sst_digest.restype = ctypes.c_uint64
    lib.sst_digest.argtypes = [h]


class SsdTableEngine:
    """ctypes handle over the two-tier C++ table (``csrc/ssd_table.cc``):
    a RAM hot tier plus per-shard append-only log files, promote on
    access, explicit spill of the coldest rows, shrink and save over both
    tiers, crash recovery by log replay. Native only: there is no Python
    version of the disk tier."""

    def __init__(self, shard_num: int, accessor: str, acc_cfg, seed: int, path: str,
                 value_f16: bool = False) -> None:
        self._lib = load_ssd()
        iparams, fparams = table_native_params(shard_num, accessor, acc_cfg, seed)
        self._h = self._lib.sst_create2(_i32(iparams), _f32(fparams), str(path).encode(),
                                        SST_FLAG_VALUE_F16 if value_f16 else 0)
        if not self._h:
            raise OSError(f"ssd table open failed at {path!r}")
        self._save_lock = threading.Lock()
        self.pull_dim = int(self._lib.sst_pull_dim(self._h))
        self.push_dim = int(self._lib.sst_push_dim(self._h))
        self.full_dim = int(self._lib.sst_full_dim(self._h))

    def __del__(self):
        self.close()

    def close(self) -> None:
        """Flush and release the engine (idempotent)."""
        if getattr(self, "_h", None):
            self._lib.sst_destroy(self._h)
            self._h = None

    def size(self) -> int:
        return int(self._lib.sst_size(self._h))

    def stats(self) -> dict:
        """The engine's stat vector by ``SST_STAT_FIELDS`` name (hot and
        cold rows, disk bytes including log garbage, ...)."""
        out = np.zeros(len(SST_STAT_FIELDS), np.int64)
        n = int(self._lib.sst_stats2(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                     len(SST_STAT_FIELDS)))
        return {name: int(out[i]) for i, name in enumerate(SST_STAT_FIELDS) if i < n}

    def shard_sizes(self, shard_num: int) -> np.ndarray:
        out = np.empty(shard_num, np.int64)
        self._lib.sst_shard_sizes(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return out

    def pull(self, keys: np.ndarray, slots, create: bool) -> np.ndarray:
        keys = np.ascontiguousarray(keys, np.uint64)
        out = np.empty((len(keys), self.pull_dim), np.float32)
        slots_arr = np.ascontiguousarray(slots, np.int32) if slots is not None else None
        self._lib.sst_pull(self._h, _u64(keys),
                           _i32(slots_arr) if slots_arr is not None else None,
                           len(keys), 1 if create else 0, _f32(out))
        return out

    def push(self, keys: np.ndarray, push_values: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, np.uint64)
        push_values = np.ascontiguousarray(push_values, np.float32)
        self._lib.sst_push(self._h, _u64(keys), _f32(push_values), len(keys))

    def export_full(self, keys: np.ndarray, create: bool = False,
                    slots=None) -> Tuple[np.ndarray, np.ndarray]:
        keys = np.ascontiguousarray(keys, np.uint64)
        values = np.empty((len(keys), self.full_dim), np.float32)
        found = np.empty(len(keys), np.uint8)
        slots_arr = np.ascontiguousarray(slots, np.int32) if slots is not None else None
        self._lib.sst_export(self._h, _u64(keys),
                             _i32(slots_arr) if slots_arr is not None else None,
                             len(keys), 1 if create else 0, _f32(values),
                             found.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return values, found.astype(bool)

    def insert_full(self, keys: np.ndarray, values: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, np.uint64)
        values = np.ascontiguousarray(values, np.float32)
        self._lib.sst_insert_full(self._h, _u64(keys), _f32(values), len(keys))

    def load_cold(self, keys: np.ndarray, values: np.ndarray) -> None:
        """Bulk-load full rows straight into the disk tier. Raises on a
        short load (the engine truncates the partial slice, so the log
        stays replay-consistent)."""
        keys = np.ascontiguousarray(keys, np.uint64)
        values = np.ascontiguousarray(values, np.float32)
        loaded = int(self._lib.sst_load_cold(self._h, _u64(keys), _f32(values), len(keys)))
        if loaded != len(keys):
            raise OSError(f"load_cold wrote only {loaded}/{len(keys)} rows "
                          "(disk full or IO error; partial slice truncated)")

    def spill(self, budget: int) -> int:
        """Move the coldest hot rows to disk until at most ``budget`` stay
        hot; returns the rows moved."""
        return int(self._lib.sst_spill(self._h, ctypes.c_int64(budget)))

    def shrink(self) -> int:
        return int(self._lib.sst_shrink(self._h))

    def compact(self) -> int:
        """Rewrite the logs to their live records; returns disk bytes after."""
        return int(self._lib.sst_compact(self._h))

    def flush(self) -> None:
        self._lib.sst_flush(self._h)

    def digest(self) -> int:
        """Order-independent content digest over both tiers, equal to a
        RAM table's for the same logical rows."""
        return int(self._lib.sst_digest(self._h))

    def save_items(self, mode: int) -> Tuple[np.ndarray, np.ndarray]:
        """(keys, full rows) of both tiers after the accessor's save
        filter for ``mode``; the engine applies update_stat_after_save."""
        with self._save_lock:
            n = int(self._lib.sst_save_begin(self._h, mode))
            keys = np.empty(n, np.uint64)
            values = np.empty((n, self.full_dim), np.float32)
            self._lib.sst_save_fetch(self._h, _u64(keys), _f32(values))
        return keys, values
