"""Device-resident feasign→row hash table (per-batch lookup on the card).

Port of the static half of ``paddle_tpu.ps.device_hash``: a bucketized
cuckoo table (2 hash functions × 4-slot buckets, load ≤ 0.5) built on
the host once per pass (``csrc/cuckoo.cc``) and probed on the device
with two bucket-row gathers and compares — branch-free and bounded.

Keys are uint64 split into (hi, lo) 32-bit halves. PyTorch has no
dependable uint32 arithmetic (on the CPU ``>>`` on ``torch.uint32``
raises "rshift_cpu not implemented"), so the mixer runs in int64 with
every intermediate masked to 32 bits, and 32×32-bit products are split
into 16-bit halves so that no step ever leaves the int64 range. The
result is bit-equal to ``mix32`` in cuckoo.cc and to the JAX package's
``_mix32``. (The dynamic map of the hot tier waits for a later slice.)
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

from ..core.enforce import enforce
from .native import cuckoo_build

__all__ = ["DeviceKeyMap", "device_hash_lookup", "split_keys"]

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
