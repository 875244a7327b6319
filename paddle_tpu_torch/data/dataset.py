"""Slot-record dataset: MultiSlot text → fixed-shape numpy batches.

The port's own copy of the in-memory half of ``paddle_tpu.data.dataset``
(the reference's ``InMemoryDataset``, data_set.h:170, fed by the
MultiSlot text format of data_feed.cc:893): records are SoA per slot
(values + per-record lengths), parsed by the native ``SlotParser``
(``csrc/slot_parser.cc``), shuffled locally with a seeded numpy
generator, and cut into fixed-shape batches padded/truncated to each
slot's ``max_len``. The same lines and seed give the same batches as the
JAX package. Batches are host numpy arrays; the trainer moves them to
the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.enforce import enforce
from ..ps.native import SlotParser

__all__ = ["InMemoryDataset", "SlotDesc"]


@dataclasses.dataclass
class SlotDesc:
    """One slot of the MultiSlot schema (DataFeedDesc.multi_slot_desc)."""

    name: str
    is_float: bool = False
    is_used: bool = True
    max_len: int = 1          # batch padding length (CTR slots are len-1)


class _SlotColumns:
    """SoA storage for parsed records of one file chunk."""

    def __init__(self, slots: Sequence[SlotDesc], parsed: Dict[str, tuple]) -> None:
        self.values = {s.name: parsed[s.name][0] for s in slots if s.is_used}
        self.lengths = {s.name: parsed[s.name][1] for s in slots if s.is_used}
        names = [s.name for s in slots if s.is_used]
        self.num = len(self.lengths[names[0]]) if names else 0


class _RecordStore:
    """All loaded records as per-slot value arrays + offsets; supports
    permutation (shuffle) and slicing into batches."""

    def __init__(self, slots: Sequence[SlotDesc]) -> None:
        self.slots = [s for s in slots if s.is_used]
        self._vals: Dict[str, List[np.ndarray]] = {s.name: [] for s in self.slots}
        self._lens: Dict[str, List[np.ndarray]] = {s.name: [] for s in self.slots}
        self.num_records = 0

    def append(self, cols: _SlotColumns) -> None:
        for s in self.slots:
            self._vals[s.name].append(cols.values[s.name])
            self._lens[s.name].append(cols.lengths[s.name])
        self.num_records += cols.num

    def finalize(self) -> None:
        for s in self.slots:
            self._vals[s.name] = [np.concatenate(self._vals[s.name])] if self._vals[s.name] else [
                np.zeros(0, np.float32 if s.is_float else np.uint64)]
            self._lens[s.name] = [np.concatenate(self._lens[s.name])] if self._lens[s.name] else [
                np.zeros(0, np.int32)]

    def _offsets(self, name: str) -> np.ndarray:
        lens = self._lens[name][0]
        off = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        return off

    def _gather_rows(self, name: str, indices: np.ndarray):
        """Vectorized variable-length row gather: (lens, values) of the
        given records for one slot. Safe for empty index sets."""
        off = self._offsets(name)
        lens = self._lens[name][0][indices]
        vals = self._vals[name][0]
        total = int(lens.sum())
        if total == 0:
            return lens, np.zeros(0, vals.dtype)
        starts = off[:-1][indices]
        idx = np.repeat(starts, lens) + (
            np.arange(total)
            - np.repeat(np.concatenate([[0], np.cumsum(lens)[:-1]]), lens))
        return lens, vals[idx.astype(np.int64)]

    def permute(self, perm: np.ndarray) -> None:
        for s in self.slots:
            new_lens, new_vals = self._gather_rows(s.name, perm)
            self._vals[s.name][0] = new_vals
            self._lens[s.name][0] = new_lens

    def batch(self, lo: int, hi: int) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """Fixed-shape batch: values padded/truncated to slot.max_len."""
        out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        n = hi - lo
        for s in self.slots:
            off = self._offsets(s.name)
            lens = self._lens[s.name][0][lo:hi]
            vals = self._vals[s.name][0]
            dtype = np.float32 if s.is_float else np.uint64
            padded = np.zeros((n, s.max_len), dtype)
            take = np.minimum(lens, s.max_len)
            for_i = np.arange(n)
            mask_rows = np.repeat(for_i, take)
            col_idx = np.concatenate([np.arange(t) for t in take]) if n else np.zeros(0, np.int64)
            src_idx = np.repeat(off[lo:hi], take) + col_idx
            padded[mask_rows, col_idx] = vals[src_idx.astype(np.int64)]
            out[s.name] = (padded, take.astype(np.int32))
        return out

    def feasigns(self) -> np.ndarray:
        keys = [self._vals[s.name][0] for s in self.slots if not s.is_float]
        return np.concatenate(keys) if keys else np.zeros(0, np.uint64)


class InMemoryDataset:
    """data_set.h InMemoryDataset analogue: load lines, shuffle, batch.

    Usage (mirrors the fleet dataset API)::

        ds = InMemoryDataset(slots, seed=0)
        ds.load_from_lines(lines)     # MultiSlot text lines
        ds.local_shuffle()
        for batch in ds.batch_iter(4096): ...
    """

    def __init__(self, slots: Sequence[SlotDesc], seed: int = 0) -> None:
        self.slots = list(slots)
        self._store: Optional[_RecordStore] = None
        self._rng = np.random.default_rng(seed)
        self.parse_errors = 0

    def _parse_text(self, text: str) -> _SlotColumns:
        p = SlotParser([(s.name, s.is_float, s.is_used) for s in self.slots])
        p.parse(text)
        self.parse_errors += p.errors
        return _SlotColumns(self.slots, p.fetch())

    def load_from_lines(self, lines: Sequence[str]) -> int:
        """Feed pre-generated MultiSlot lines (DataGenerator output)."""
        store = _RecordStore(self.slots)
        store.append(self._parse_text("\n".join(lines) + ("\n" if lines else "")))
        store.finalize()
        self._store = store
        return store.num_records

    # -- shuffle ----------------------------------------------------------

    def local_shuffle(self) -> None:
        enforce(self._store is not None, "load_from_lines first")
        perm = self._rng.permutation(self._store.num_records)
        self._store.permute(perm)

    # -- consume ----------------------------------------------------------

    @property
    def num_records(self) -> int:
        return self._store.num_records if self._store else 0

    def pass_feasigns(self) -> np.ndarray:
        """All uint64 feasigns of the loaded pass (for cache.begin_pass —
        the PreBuildTask dedup input)."""
        enforce(self._store is not None, "load_from_lines first")
        return self._store.feasigns()

    def batch_iter(self, batch_size: int, drop_last: bool = True,
                   start_batch: int = 0
                   ) -> Iterator[Dict[str, Tuple[np.ndarray, np.ndarray]]]:
        """``start_batch`` is the resume cursor: skip that many leading
        batches — for the in-memory store a pure index offset, so a
        restarted job re-enters the stream at the cut for free. The
        record order must match the saved run's (same seed/shuffle)."""
        enforce(self._store is not None, "load_from_lines first")
        n = self._store.num_records
        end = n - (n % batch_size) if drop_last else n
        for lo in range(start_batch * batch_size, end, batch_size):
            yield self._store.batch(lo, min(lo + batch_size, n))

    def release_memory(self) -> None:
        self._store = None
