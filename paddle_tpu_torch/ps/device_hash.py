"""Device-resident feasign→row hash table (per-batch lookup on the card).

Port of ``paddle_tpu.ps.device_hash``: the pass cache's static
bucketized cuckoo table (2 hash functions × 4-slot buckets, load ≤ 0.5)
built on the host once per pass (``csrc/cuckoo.cc``) and probed on the
device with two bucket-row gathers and compares — branch-free and
bounded; and the hot tier's :class:`DynamicDeviceKeyMap`, an
insert/evict-capable bucketized linear-probe map whose host mirror is
the JAX package's, array for array.

Keys are uint64 split into (hi, lo) 32-bit halves. PyTorch has no
dependable uint32 arithmetic (on the CPU ``>>`` on ``torch.uint32``
raises "rshift_cpu not implemented"), so the mixer runs in int64 with
every intermediate masked to 32 bits, and 32×32-bit products are split
into 16-bit halves so that no step ever leaves the int64 range. The
result is bit-equal to ``mix32`` in cuckoo.cc and to the JAX package's
``_mix32``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.enforce import enforce
from .native import cuckoo_build

__all__ = ["DeviceKeyMap", "DynamicDeviceKeyMap", "device_hash_lookup",
           "dynamic_map_lookup", "dynamic_map_state_to_device",
           "dynamic_probe_buckets", "split_keys"]

_SLOTS = 4
_SEED2_XOR = 0x7FEB352D
_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 ``h`` in [0, 2^32) and a 32-bit
    constant ``c``, without overflowing int64: the product is split over
    c's 16-bit halves (each partial product stays below 2^48)."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(hi: torch.Tensor, lo: torch.Tensor,
           seed: Union[int, torch.Tensor]) -> torch.Tensor:
    """int64 mirror of csrc/cuckoo.cc mix32 (uint32 wrap-around math);
    ``hi``/``lo`` hold uint32 values in int64 tensors."""
    h = (hi ^ seed) & _M32
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h ^ lo
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def split_keys(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side uint64 → (hi, lo) uint32 halves."""
    keys = np.ascontiguousarray(keys, np.uint64)
    return ((keys >> np.uint64(32)).astype(np.uint32),
            (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def device_hash_lookup(table: Dict[str, torch.Tensor], keys_hi: torch.Tensor,
                       keys_lo: torch.Tensor) -> torch.Tensor:
    """Probe: [n] int64 rows (−1 = missing) for (hi, lo) keys given as
    int64 tensors holding uint32 values. Two bucket-row gathers (the
    HashTable::get analogue); ``table`` holds ``hi``/``lo`` int64 and
    ``row`` int32 arrays of shape [nbuckets, 4] and the 0-dim ``seed``."""
    mask = table["row"].shape[0] - 1  # nbuckets (power of 2)
    seed = table["seed"]
    hi = keys_hi.to(torch.int64)
    lo = keys_lo.to(torch.int64)
    found = torch.full(hi.shape, -1, dtype=torch.int64, device=hi.device)
    for which in (0, 1):
        s = seed if which == 0 else seed ^ _SEED2_XOR
        b = _mix32(hi, lo, s) & mask
        bh = table["hi"][b]                      # [n, 4]
        bl = table["lo"][b]
        br = table["row"][b].to(torch.int64)
        match = (bh == hi[:, None]) & (bl == lo[:, None]) & (br >= 0)
        hit = torch.where(match, br, -1).amax(dim=1)
        found = torch.where(hit >= 0, hit, found)
    return found


class DeviceKeyMap:
    """Per-pass static key→row map living on the device.

    ``build_host`` runs the cuckoo build on the host after the pass dedup
    assigned rows; ``state`` is a dict of device tensors the step reads.
    """

    @staticmethod
    def build_host(keys: np.ndarray, rows: np.ndarray) -> dict:
        """Host-only cuckoo build: returns the host arrays to upload."""
        n = len(keys)
        enforce(n == len(rows), "keys/rows length mismatch")
        nb = 64
        while nb * _SLOTS < 2 * max(n, 1):
            nb <<= 1
        last_err = None
        for seed in (0x1234ABCD, 0x9E3779B9, 0xDEADBEEF, 0x2545F491):
            try:
                hi, lo, row = cuckoo_build(keys, rows, nb, seed)
                break
            except RuntimeError as e:  # placement failure: retry a new seed
                last_err = e
        else:
            raise RuntimeError(f"cuckoo build failed for {n} keys: {last_err}")
        return {"hi": hi.reshape(nb, 4), "lo": lo.reshape(nb, 4),
                "row": row.reshape(nb, 4), "seed": np.uint32(seed), "nb": nb}

    def __init__(self, host_built: dict, device: torch.device) -> None:
        self.nbuckets = host_built["nb"]
        self.state = map_state_to_device(host_built, device)

    def lookup(self, keys_hi: torch.Tensor, keys_lo: torch.Tensor) -> torch.Tensor:
        return device_hash_lookup(self.state, keys_hi, keys_lo)


def map_state_to_device(host: dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """Host map arrays (uint32 hi/lo, int32 row, uint32 seed — the JAX
    package's layout) → the port's device tensors (int64 hi/lo/seed)."""
    return {
        "hi": torch.from_numpy(np.asarray(host["hi"]).astype(np.int64)).to(device),
        "lo": torch.from_numpy(np.asarray(host["lo"]).astype(np.int64)).to(device),
        "row": torch.from_numpy(np.array(host["row"], np.int32)).to(device),
        "seed": torch.tensor(int(host["seed"]), dtype=torch.int64, device=device),
    }


# ---------------------------------------------------------------------------
# The dynamic map of the persistent hot tier.
#
# BANKS: with ``banks > 1`` the bucket array partitions into ``banks``
# contiguous regions and every key hashes FIRST to its bank (a FIXED seed
# — bank membership survives reseed/grow rebuilds) and then to a bucket
# inside that bank's region; the probe window wraps within the bank. The
# hot tier allocates a key's ROW from the same bank's row block.
#
# Device layout: ``hi``/``lo`` are int32 tensors holding the uint32 bit
# patterns (12 B per slot, as in the JAX package), ``row`` int32 and
# ``seed`` a 0-dim int32 bit pattern. The plain probe widens them with
# ``& 0xFFFFFFFF`` into int64 before hashing; the CUDA kernel
# (``ops.hot_kernels.hot_probe_gather``) hashes in native uint32.
# ---------------------------------------------------------------------------

_EMPTY = np.int32(-1)
_TOMB = np.int32(-2)
#: fixed bank-hash seed — NEVER rotated (rows must not migrate between
#: banks when the probe seed rotates on a rebuild)
_BANK_SEED = 0x243F6A88


def _mix32_np(hi: np.ndarray, lo: np.ndarray, seed: int) -> np.ndarray:
    """numpy mirror of ``_mix32`` (uint32 wraparound math) — the host
    mirror and the device probe MUST hash identically."""
    with np.errstate(over="ignore"):
        h = np.uint32(seed) ^ hi.astype(np.uint32)
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h ^ lo.astype(np.uint32)
        h = h * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
    return h


def _u32(t: torch.Tensor) -> torch.Tensor:
    """Integer tensor of uint32 values or bit patterns → int64 in [0, 2^32)."""
    return t.to(torch.int64) & _M32


def dynamic_probe_buckets(nbuckets: int, keys_hi: torch.Tensor, keys_lo: torch.Tensor,
                          seed: Union[int, torch.Tensor], probe_buckets: int,
                          banks: int = 1):
    """The probe-window bucket ids ([n] int64 per window step) of a
    :class:`DynamicDeviceKeyMap`; with banks the window wraps WITHIN the
    key's bank region. The same hash as the host mirror and the kernel."""
    hi, lo = _u32(keys_hi), _u32(keys_lo)
    seed = _u32(seed) if isinstance(seed, torch.Tensor) else int(seed) & _M32
    nbpb = nbuckets // banks          # buckets per bank (both pow2)
    local_mask = nbpb - 1
    base = 0
    if banks > 1:
        base = (_mix32(hi, lo, _BANK_SEED) & (banks - 1)) * nbpb
    b0 = _mix32(hi, lo, seed) & local_mask
    return [base + ((b0 + t) & local_mask) for t in range(probe_buckets)]


def dynamic_map_lookup(table: Dict[str, torch.Tensor], keys_hi: torch.Tensor,
                       keys_lo: torch.Tensor, probe_buckets: int = 2,
                       banks: int = 1) -> torch.Tensor:
    """The plain probe of a :class:`DynamicDeviceKeyMap`: [n] int32 rows
    (−1 = missing). ``probe_buckets`` bucket-row gathers; in a bucket the
    largest matching row wins, and the first bucket with a hit wins."""
    hi, lo = _u32(keys_hi), _u32(keys_lo)
    found = torch.full(hi.shape, -1, dtype=torch.int32, device=hi.device)
    for b in dynamic_probe_buckets(table["row"].shape[0], hi, lo, table["seed"],
                                   probe_buckets, banks):
        bh = _u32(table["hi"][b])                  # [n, slots]
        bl = _u32(table["lo"][b])
        br = table["row"][b]
        match = (bh == hi[:, None]) & (bl == lo[:, None]) & (br >= 0)
        hit = torch.where(match, br, -1).amax(dim=1).to(torch.int32)
        found = torch.where(found >= 0, found, hit)
    return found


def dynamic_map_state_to_device(hi: np.ndarray, lo: np.ndarray, row: np.ndarray,
                                seed, device: torch.device) -> Dict[str, torch.Tensor]:
    """Host arrays (uint32 hi/lo, int32 row, uint32 seed — the JAX
    package's layout) → device tensors (int32 bit patterns)."""
    as_i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32).copy())
    return {"hi": as_i32(hi).to(device), "lo": as_i32(lo).to(device),
            "row": torch.from_numpy(np.array(row, np.int32)).to(device),
            "seed": as_i32(np.asarray(seed, np.uint32).reshape(())).to(device)}


class DynamicDeviceKeyMap:
    """Insert/evict-capable feasign→row map living on the device.

    The host keeps the authoritative mirror (numpy arrays — membership
    decisions, miss detection and eviction bookkeeping are host
    control-plane work, and the arrays are the JAX package's after the
    same inserts and removes); every mutation queues slot patches that
    :meth:`device_state` applies IN PLACE (``index_put_``) before the next
    step reads the map, and a rebuild re-uploads everything.

    Scheme: ``nbuckets × bucket_slots`` slots, bucketized linear probing
    over a ``probe_buckets``-bucket window (load factor ≤ 0.5 by
    construction). An insert that cannot place inside its window — or
    tombstone pressure past 25% — triggers a deterministic REBUILD
    (reseed from a fixed sequence, then grow): layout changes only, never
    values. ``banks`` (power of two) partitions the buckets into per-bank
    regions (see above); ``banks=1`` is the unbanked layout. ``device``
    defaults to ``"cuda"`` and raises without a GPU unless the caller
    passes ``device="cpu"``.
    """

    _SEEDS = (0x1234ABCD, 0x9E3779B9, 0xDEADBEEF, 0x2545F491)

    def __init__(self, capacity: int, device: Optional[Union[str, torch.device]] = None,
                 bucket_slots: int = 8, probe_buckets: int = 2, banks: int = 1) -> None:
        enforce(capacity > 0, "capacity must be positive")
        self.capacity = int(capacity)
        self.device = resolve_device(device)
        self.bucket_slots = int(bucket_slots)
        self.probe_buckets = int(probe_buckets)
        self.banks = int(banks)
        enforce(self.banks >= 1 and (self.banks & (self.banks - 1)) == 0,
                f"banks must be a power of two, got {banks}")
        nb = max(64, self.banks)
        while nb * bucket_slots < 2 * self.capacity:
            nb <<= 1
        self._seed_idx = 0
        self._init_arrays(nb)
        self.rebuilds = 0
        #: mutation counter — bumps on every insert/remove/rebuild, so
        #: callers can cache lookup_host results and invalidate precisely
        self.version = 0
        self._dev: Optional[Dict[str, torch.Tensor]] = None
        self._patches: list = []   # (bucket, lane) pending device writes
        self._full_upload = True   # first device_state uploads everything

    def _init_arrays(self, nb: int) -> None:
        self.nbuckets = nb
        B = self.bucket_slots
        self.hi = np.zeros((nb, B), np.uint32)
        self.lo = np.zeros((nb, B), np.uint32)
        self.row = np.full((nb, B), _EMPTY, np.int32)
        self.seed = np.uint32(self._SEEDS[self._seed_idx])
        self.used = 0
        self.tombstones = 0

    # -- host mirror ------------------------------------------------------

    def _bank_local_np(self, hi: np.ndarray, lo: np.ndarray):
        """(bank-region base bucket, in-bank probe start) per key — the
        numpy twin of :func:`dynamic_probe_buckets`'s hash math."""
        nbpb = self.nbuckets // self.banks
        local = _mix32_np(hi, lo, self.seed) & np.uint32(nbpb - 1)
        if self.banks == 1:
            return np.zeros_like(local), local
        bank = _mix32_np(hi, lo, np.uint32(_BANK_SEED)) & np.uint32(self.banks - 1)
        return bank * np.uint32(nbpb), local

    def bank_of(self, keys: np.ndarray) -> np.ndarray:
        """[n] int32 bank of each key (fixed hash — stable across
        rebuilds/reseeds; all zeros when banks == 1)."""
        keys = np.ascontiguousarray(keys, np.uint64)
        if self.banks == 1:
            return np.zeros(len(keys), np.int32)
        hi, lo = split_keys(keys)
        return (_mix32_np(hi, lo, np.uint32(_BANK_SEED))
                & np.uint32(self.banks - 1)).astype(np.int32)

    def lookup_host(self, keys: np.ndarray) -> np.ndarray:
        """[n] int32 rows, −1 = missing (vectorized; the control-plane
        twin of the device probe — identical hash math)."""
        if len(keys) == 0:
            return np.zeros(0, np.int32)
        hi, lo = split_keys(keys)
        base, local = self._bank_local_np(hi, lo)
        local_mask = np.uint32(self.nbuckets // self.banks - 1)
        found = np.full(len(keys), -1, np.int32)
        for t in range(self.probe_buckets):
            b = base + ((local + np.uint32(t)) & local_mask)
            match = ((self.hi[b] == hi[:, None]) & (self.lo[b] == lo[:, None])
                     & (self.row[b] >= 0))
            hit = np.max(np.where(match, self.row[b], -1), axis=1)
            found = np.where(found >= 0, found, hit).astype(np.int32)
        return found

    def _place_one(self, hi: np.uint32, lo: np.uint32, row: int) -> bool:
        """Insert one key (must not be present). False = window full."""
        local_mask = np.uint32(self.nbuckets // self.banks - 1)
        base, local = self._bank_local_np(np.asarray([hi], np.uint32),
                                          np.asarray([lo], np.uint32))
        base, b0 = int(base[0]), local[0]
        for t in range(self.probe_buckets):
            b = base + int((b0 + np.uint32(t)) & local_mask)
            for l in range(self.bucket_slots):
                if self.row[b, l] < 0:
                    if self.row[b, l] == _TOMB:
                        self.tombstones -= 1
                    self.hi[b, l] = hi
                    self.lo[b, l] = lo
                    self.row[b, l] = row
                    self.used += 1
                    self._patches.append((b, l))
                    return True
        return False

    def insert(self, keys: np.ndarray, rows: np.ndarray) -> None:
        """Insert absent keys (a present key is an error: the tier never
        re-inserts a resident id). Rebuilds deterministically when a
        probe window fills or tombstones exceed 25% load."""
        enforce(len(keys) == len(rows), "keys/rows length mismatch")
        enforce(self.used + len(keys) <= self.capacity,
                "DynamicDeviceKeyMap over capacity")
        if self.tombstones * 4 > self.nbuckets * self.bucket_slots:
            self._rebuild(grow=False)
        self.version += 1
        hi, lo = split_keys(keys)
        for i in range(len(keys)):
            while not self._place_one(hi[i], lo[i], int(rows[i])):
                self._rebuild(grow=self._seed_idx + 1 >= len(self._SEEDS))

    def remove(self, keys: np.ndarray) -> None:
        """Evict keys (tombstone their slots); a missing key is an error."""
        if len(keys) == 0:
            return
        self.version += 1
        hi, lo = split_keys(keys)
        local_mask = np.uint32(self.nbuckets // self.banks - 1)
        bases, b0s = self._bank_local_np(hi, lo)
        for i in range(len(keys)):
            placed = False
            for t in range(self.probe_buckets):
                b = int(bases[i]) + int((b0s[i] + np.uint32(t)) & local_mask)
                for l in range(self.bucket_slots):
                    if (self.row[b, l] >= 0 and self.hi[b, l] == hi[i]
                            and self.lo[b, l] == lo[i]):
                        self.row[b, l] = _TOMB
                        self.used -= 1
                        self.tombstones += 1
                        self._patches.append((b, l))
                        placed = True
                        break
                if placed:
                    break
            enforce(placed, f"remove: key {keys[i]} not in map")

    def items(self):
        """(keys u64, rows i32) of every resident entry (rebuild fuel)."""
        live = self.row >= 0
        keys = (self.hi[live].astype(np.uint64) << np.uint64(32)) \
            | self.lo[live].astype(np.uint64)
        return keys, self.row[live].copy()

    def _rebuild(self, grow: bool) -> None:
        # snapshot EVERY resident entry up front — a failed attempt below
        # must retry with this full list, never re-harvest items() from a
        # half-rebuilt table (that drops the tail)
        keys, rows = self.items()
        self.version += 1
        # deterministic layout: re-insert in ascending row order
        order = np.argsort(rows, kind="stable")
        keys, rows = keys[order], rows[order]
        hi, lo = split_keys(keys)
        nb = self.nbuckets * 2 if grow else self.nbuckets
        while True:
            self._seed_idx = (self._seed_idx + 1) % len(self._SEEDS)
            self._init_arrays(nb)
            self.rebuilds += 1
            self._full_upload = True
            self._patches.clear()
            if all(self._place_one(hi[i], lo[i], int(rows[i]))
                   for i in range(len(keys))):
                return
            # pathological seed: rotate again, growing once the seed
            # sequence is exhausted (terminates: load ≤ 0.5 halves every
            # growth)
            if self._seed_idx + 1 >= len(self._SEEDS):
                nb <<= 1

    # -- device arrays ----------------------------------------------------

    def device_state(self) -> Dict[str, torch.Tensor]:
        """Device tensors for the step, refreshed from the host mirror:
        pending slot patches apply in place (one ``index_put_`` per
        array); a rebuild re-uploads everything. With no mutation since
        the last call it returns the same dict untouched."""
        if self._dev is None or self._full_upload:
            self._dev = dynamic_map_state_to_device(self.hi, self.lo, self.row,
                                                    self.seed, self.device)
            self._full_upload = False
            self._patches.clear()
            return self._dev
        if self._patches:
            bl = np.asarray(self._patches, np.int64)
            b, l = bl[:, 0], bl[:, 1]
            idx = (torch.from_numpy(b).to(self.device), torch.from_numpy(l).to(self.device))
            for name, arr in (("hi", self.hi), ("lo", self.lo), ("row", self.row)):
                vals = torch.from_numpy(np.ascontiguousarray(arr[b, l]).view(np.int32))
                self._dev[name].index_put_(idx, vals.to(self.device))
            self._patches.clear()
        return self._dev

    def lookup(self, keys_hi: torch.Tensor, keys_lo: torch.Tensor) -> torch.Tensor:
        return dynamic_map_lookup(self.device_state(), keys_hi, keys_lo,
                                  self.probe_buckets, self.banks)
