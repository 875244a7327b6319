"""ctypes bindings for the port's host library (``csrc/``).

``sparse_index.cc`` (the feasign index and the parallel pass dedup) and
``cuckoo.cc`` (the per-pass device key map build) are the port's own
copies of the JAX package's sources. They build at first use with
``g++ -O3 -ffp-contract=off -std=c++17 -fPIC -shared`` into the
gitignored build directory (``ops/_build.py``). There is no Python
fallback: ``dedup_u64``'s order fixes the cache row ids of a pass, and a
different dedup would give different rows.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from ..ops._build import build_shared_library

__all__ = ["FeasignIndex", "cuckoo_build", "dedup_u64", "load_native"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
_SOURCES = tuple(os.path.join(_CSRC, f) for f in ("sparse_index.cc", "cuckoo.cc"))
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _gxx_command(out: str):
    # -ffp-contract=off mirrors paddle_tpu/csrc/Makefile; no -march=native
    # so the library runs on whatever host the checkout lands on
    return ["g++", "-O3", "-ffp-contract=off", "-std=c++17", "-fPIC",
            "-shared", "-o", out, *_SOURCES, "-lpthread"]


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
    lib.ps_dedup_u64.restype = ctypes.c_int64
    lib.ps_dedup_u64.argtypes = [u64p, ctypes.c_int64, u64p, ctypes.c_int32]
    lib.cuckoo_build.restype = ctypes.c_int64
    lib.cuckoo_build.argtypes = [u64p, i32p, ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_uint32, u32p, u32p, i32p]


def _u64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


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

    def items(self) -> Tuple[np.ndarray, np.ndarray]:
        """(keys, rows) of all live entries."""
        n = len(self)
        keys = np.empty(n, np.uint64)
        rows = np.empty(n, np.int32)
        self._lib.psidx_items(self._h, _u64(keys), _i32(rows))
        return keys, rows
