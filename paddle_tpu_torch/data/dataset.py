"""Slot-record dataset: MultiSlot files → fixed-shape numpy batches.

The port's own copy of ``paddle_tpu.data.dataset`` (the reference's
``InMemoryDataset``/``QueueDataset``, data_set.h:170,328, fed by the
MultiSlot text format of data_feed.cc:893, and the Python
``fleet.data_generator`` emit side): records are SoA per slot (values +
per-record lengths), parsed by the native ``SlotParser``
(``csrc/slot_parser.cc``); ``load_into_memory`` reads files through the
native threaded feed (``csrc/data_feed.cc``, :class:`NativeDataFeed`) or
a ``pipe_command`` per file; records shuffle locally with a seeded numpy
generator or globally across workers (each record to a random worker
through an all-to-all of serialized records, then a local shuffle); the
loaded pass saves to and loads from one SlotRecord binary file
(``PTSR0001``, the JAX package's format). Batches are fixed-shape,
padded/truncated to each slot's ``max_len``. The same files and seed give
the same records, shuffles and batches as the JAX package. Batches are
host numpy arrays; the trainer moves them to the card.

Unlike the JAX package, ``load_into_memory`` has no Python reader behind
the native feed: when the host library does not build it raises.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.enforce import enforce, enforce_eq
from ..ps.native import NativeDataFeed, SlotParser

__all__ = ["DataGenerator", "InMemoryDataset", "QueueDataset", "SlotDesc"]


@dataclasses.dataclass
class SlotDesc:
    """One slot of the MultiSlot schema (DataFeedDesc.multi_slot_desc)."""

    name: str
    is_float: bool = False
    is_used: bool = True
    max_len: int = 1          # batch padding length (CTR slots are len-1)


class DataGenerator:
    """``fleet.data_generator`` compatible emitter: subclass and implement
    ``generate_sample(line)`` → an iterator (or a callable returning one)
    of ``[(slot, [values])]`` samples; each sample serializes to one
    MultiSlot text line."""

    def __init__(self) -> None:
        self._batch = 1

    def set_batch(self, batch: int) -> None:
        self._batch = batch

    def generate_sample(self, line: Optional[str]):
        raise NotImplementedError

    def _serialize(self, sample: Sequence[Tuple[str, Sequence[Any]]]) -> str:
        parts: List[str] = []
        for _, values in sample:
            parts.append(str(len(values)))
            parts.extend(str(v) for v in values)
        return " ".join(parts)

    def run_from_stdin(self, fin=None, fout=None) -> None:
        fin = fin or sys.stdin
        fout = fout or sys.stdout
        for line in fin:
            it = self.generate_sample(line)
            for sample in it() if callable(it) else it:
                fout.write(self._serialize(sample) + "\n")

    def run_from_memory(self, lines: Optional[Sequence[str]] = None) -> List[str]:
        out: List[str] = []
        for line in (lines if lines is not None else [None]):
            it = self.generate_sample(line)
            for sample in it() if callable(it) else it:
                out.append(self._serialize(sample))
        return out


def _expand_filelist(patterns: Sequence[str]) -> List[str]:
    """Each pattern's sorted glob matches, or the pattern itself when it
    matches nothing (so a missing file fails at load, by name)."""
    files: List[str] = []
    for p in patterns:
        hit = sorted(_glob.glob(p))
        files.extend(hit if hit else [p])
    return files


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

    # -- record subset wire format (global-shuffle exchange) -------------

    def extract_bytes(self, indices: np.ndarray) -> bytes:
        """Serialize the given records: [u32 n] then per slot (in slot
        order) [u32 n_values][lens i32][values raw]."""
        indices = np.ascontiguousarray(indices, np.int64)
        parts = [np.asarray([len(indices)], np.uint32).tobytes()]
        for s in self.slots:
            lens, gather = self._gather_rows(s.name, indices)
            parts.append(np.asarray([len(gather)], np.uint32).tobytes())
            parts.append(np.ascontiguousarray(lens, np.int32).tobytes())
            parts.append(np.ascontiguousarray(gather).tobytes())
        return b"".join(parts)

    def _parse_record_blob(self, blob: bytes):
        """Validate + decode one :meth:`extract_bytes` blob → (n, values,
        lengths): a truncated, inconsistent or padded blob fails here, not
        as an IndexError in a later batch gather."""
        view = memoryview(blob)
        enforce(len(blob) >= 4, "record blob too short for its header")
        (n,) = np.frombuffer(view[:4], np.uint32)
        o = 4
        cols_v, cols_l = {}, {}
        for s in self.slots:
            enforce(o + 4 <= len(blob), f"record blob truncated at slot {s.name!r}")
            (nv,) = np.frombuffer(view[o:o + 4], np.uint32)
            o += 4
            lens = np.frombuffer(view[o:o + 4 * int(n)], np.int32)
            o += 4 * int(n)
            dtype = np.float32 if s.is_float else np.uint64
            nbytes = int(nv) * dtype().itemsize
            enforce(o + nbytes <= len(blob), f"record blob truncated in slot {s.name!r} values")
            enforce(len(lens) == int(n) and int(lens.sum()) == int(nv),
                    f"record blob inconsistent for slot {s.name!r} "
                    f"(lens sum {int(lens.sum()) if len(lens) == int(n) else '?'} "
                    f"vs {int(nv)} values)")
            cols_v[s.name] = np.frombuffer(view[o:o + nbytes], dtype).copy()
            cols_l[s.name] = lens.copy()
            o += nbytes
        enforce(o == len(blob), "record blob has trailing bytes")
        return int(n), cols_v, cols_l

    def ingest_bytes(self, blob: bytes) -> int:
        """Append records serialized by :meth:`extract_bytes` (the slot
        schemas must match); returns the records ingested."""
        return self.ingest_many([blob])

    def ingest_many(self, blobs) -> int:
        """Append the records of several blobs with ONE concatenation per
        slot column; returns the records ingested."""
        parsed = [self._parse_record_blob(b) for b in blobs if b]
        total = sum(n for n, _, _ in parsed)
        if not total:
            return 0
        for s in self.slots:
            self._vals[s.name][0] = np.concatenate(
                [self._vals[s.name][0]] + [cv[s.name] for n, cv, _ in parsed if n])
            self._lens[s.name][0] = np.concatenate(
                [self._lens[s.name][0]] + [cl[s.name] for n, _, cl in parsed if n])
        self.num_records += total
        return total

    def keep_only(self, indices: np.ndarray) -> None:
        """Drop every record not in ``indices`` (order preserved)."""
        self.permute(np.ascontiguousarray(indices, np.int64))
        self.num_records = len(indices)


class InMemoryDataset:
    """data_set.h InMemoryDataset analogue: load files, shuffle, batch.

    Usage (mirrors the fleet dataset API)::

        ds = InMemoryDataset(slots, seed=0)
        ds.set_filelist(fleet.util.get_file_shard(files))
        ds.load_into_memory()
        ds.global_shuffle(util=fleet.util)   # or ds.local_shuffle()
        for batch in ds.batch_iter(4096): ...
    """

    def __init__(self, slots: Sequence[SlotDesc], seed: int = 0) -> None:
        self.slots = list(slots)
        self._files: List[str] = []
        self._store: Optional[_RecordStore] = None
        self._rng = np.random.default_rng(seed)
        self.parse_errors = 0
        self._pipe_command: Optional[str] = None

    # -- config -----------------------------------------------------------

    def set_filelist(self, patterns: Sequence[str]) -> None:
        self._files = _expand_filelist(patterns)

    def set_pipe_command(self, cmd: Optional[str]) -> None:
        """Preprocess each input file through a shell command before slot
        parsing (the reference DataFeed's ``pipe_command``: the file
        streams through the command's stdin and MultiSlot lines come
        out). ``None`` restores direct reads through the native feed."""
        self._pipe_command = cmd

    # -- load -------------------------------------------------------------

    def _parse_text(self, text: str) -> _SlotColumns:
        p = SlotParser([(s.name, s.is_float, s.is_used) for s in self.slots])
        p.parse(text)
        self.parse_errors += p.errors
        return _SlotColumns(self.slots, p.fetch())

    def _run_pipe(self, path: str) -> str:
        with open(path, "rb") as fh:
            out = subprocess.run(self._pipe_command, shell=True, stdin=fh,
                                 capture_output=True)
        if out.returncode != 0:
            raise RuntimeError(f"pipe_command failed on {path} (rc {out.returncode}): "
                               f"{out.stderr.decode(errors='replace')[:500]}")
        # a stray non-UTF-8 byte becomes a parse error, as in the native feed
        return out.stdout.decode(errors="replace")

    def load_into_memory(self, num_threads: int = 4) -> int:
        """Load the file list: through the native threaded feed
        (``num_threads`` readers, a file a chunk), or with a pipe command
        one preprocessor subprocess per file, ``num_threads`` at a time,
        parsed in file order. Returns the records loaded. A missing file
        raises before anything is read."""
        store = _RecordStore(self.slots)
        for f in self._files:
            if not os.path.exists(f):
                raise FileNotFoundError(f"dataset file not found: {f}")
        if self._pipe_command:
            with ThreadPoolExecutor(max_workers=num_threads) as pool:
                # in waves, so finished outputs do not pile up ahead of the
                # serial parser (the native feed's channel bounds it)
                for lo in range(0, len(self._files), num_threads):
                    for text in pool.map(self._run_pipe, self._files[lo:lo + num_threads]):
                        store.append(self._parse_text(text))
        else:
            feed = NativeDataFeed([(s.name, s.is_float, s.is_used) for s in self.slots],
                                  self._files, num_threads=num_threads)
            try:
                for parsed in feed:
                    store.append(_SlotColumns(self.slots, parsed))
                self.parse_errors += feed.errors
            finally:
                feed.close()
        store.finalize()
        self._store = store
        return store.num_records

    def load_from_lines(self, lines: Sequence[str]) -> int:
        """Feed pre-generated MultiSlot lines (DataGenerator output)."""
        store = _RecordStore(self.slots)
        store.append(self._parse_text("\n".join(lines) + ("\n" if lines else "")))
        store.finalize()
        self._store = store
        return store.num_records

    # -- shuffle ----------------------------------------------------------

    def local_shuffle(self) -> None:
        enforce(self._store is not None, "load_into_memory or load_from_lines first")
        perm = self._rng.permutation(self._store.num_records)
        self._store.permute(perm)

    def global_shuffle(self, exchange: Optional[Callable[[List[bytes]], List[bytes]]] = None,
                       worker_id: int = 0, worker_num: int = 1, util=None) -> None:
        """Redistribute RECORDS across workers, then shuffle locally (the
        reference's GlooWrapper-backed global shuffle, data_set.cc): every
        local record draws a destination worker from the seeded generator,
        the other workers' records ship as one serialized blob each, and
        what arrives is appended after the records this worker keeps.

        Transport: ``util`` (``fleet.util``: its rank and world are
        authoritative, its ``all_to_all_bytes`` the exchange) or a raw
        ``exchange(blobs) -> blobs`` taking one blob per destination and
        returning one per source. One worker, or no transport: a seeded
        local shuffle."""
        enforce(self._store is not None, "load_into_memory or load_from_lines first")
        if util is not None:
            # mismatched caller-supplied ids would lose or duplicate records
            u_rank, u_world = util.rank, util.world_size
            enforce(worker_id in (0, u_rank) and worker_num in (1, u_world),
                    f"worker_id/num ({worker_id}/{worker_num}) contradict the bound util "
                    f"rank/world ({u_rank}/{u_world})")
            worker_id, worker_num = u_rank, u_world
            if exchange is None:
                exchange = util.all_to_all_bytes
        if worker_num <= 1 or exchange is None:
            self.local_shuffle()
            return
        st = self._store
        dest = self._rng.integers(0, worker_num, size=st.num_records)
        # the own partition stays in place: an empty blob goes to self
        blobs = [st.extract_bytes(np.flatnonzero(dest == w)) if w != worker_id else b""
                 for w in range(worker_num)]
        received = exchange(blobs)
        enforce(len(received) == worker_num, "exchange must return one blob per source worker")
        st.keep_only(np.flatnonzero(dest == worker_id))
        st.ingest_many(blob for src, blob in enumerate(received) if src != worker_id)
        self.local_shuffle()

    # -- consume ----------------------------------------------------------

    @property
    def num_records(self) -> int:
        return self._store.num_records if self._store else 0

    def pass_feasigns(self) -> np.ndarray:
        """All uint64 feasigns of the loaded pass (for cache.begin_pass —
        the PreBuildTask dedup input)."""
        enforce(self._store is not None, "load_into_memory or load_from_lines first")
        return self._store.feasigns()

    def batch_iter(self, batch_size: int, drop_last: bool = True,
                   start_batch: int = 0
                   ) -> Iterator[Dict[str, Tuple[np.ndarray, np.ndarray]]]:
        """``start_batch`` is the resume cursor: skip that many leading
        batches — for the in-memory store a pure index offset, so a
        restarted job re-enters the stream at the cut for free. The
        record order must match the saved run's (same seed/shuffle)."""
        enforce(self._store is not None, "load_into_memory or load_from_lines first")
        n = self._store.num_records
        end = n - (n % batch_size) if drop_last else n
        for lo in range(start_batch * batch_size, end, batch_size):
            yield self._store.batch(lo, min(lo + batch_size, n))

    def release_memory(self) -> None:
        self._store = None

    # -- SlotRecord binary file (data_feed.h:1390 SlotRecord role) --------

    def save_slot_record(self, path: str) -> int:
        """Write the loaded pass as ONE binary file: ``PTSR0001``, the JSON
        header's byte length (u64), the header (per slot: name, type,
        ``max_len``, value dtype, and the offset and count of its value
        and length columns), then the columns back to back. Parse text
        once, reload later passes at memory speed. Returns the records."""
        enforce(self._store is not None, "load_into_memory or load_from_lines first")
        st = self._store
        header: Dict = {"num_records": st.num_records, "slots": []}
        blobs: List[np.ndarray] = []
        off = 0
        for s in st.slots:
            vals = st._vals[s.name][0]
            lens = st._lens[s.name][0]
            # the loader reads 4-byte lengths: catch a drifted dtype here
            enforce_eq(lens.dtype, np.dtype(np.int32), f"slot {s.name!r} length dtype")
            ent = {"name": s.name, "is_float": bool(s.is_float), "max_len": int(s.max_len),
                   "val_dtype": str(vals.dtype), "val_off": off, "val_n": int(len(vals))}
            off += vals.nbytes
            ent.update({"len_off": off, "len_n": int(len(lens))})
            off += lens.nbytes
            header["slots"].append(ent)
            blobs += [vals, lens]
        hdr = json.dumps(header).encode()
        with open(path, "wb") as f:
            f.write(b"PTSR0001")
            f.write(np.asarray([len(hdr)], np.uint64).tobytes())
            f.write(hdr)
            for b in blobs:
                f.write(memoryview(np.ascontiguousarray(b)).cast("B"))
            f.flush()
            os.fsync(f.fileno())
        return st.num_records

    def load_slot_record(self, path: str, mmap: bool = True) -> int:
        """Load a file of :meth:`save_slot_record` (either package's); with
        ``mmap`` the columns are memory-mapped. A file that is not a
        SlotRecord file, is truncated, or lacks a slot of this schema (or
        types it differently) raises. Returns the records."""
        with open(path, "rb") as f:
            enforce(f.read(8) == b"PTSR0001", f"not a SlotRecord file: {path}")
            (hlen,) = np.frombuffer(f.read(8), np.uint64)
            header = json.loads(f.read(int(hlen)).decode())
            base = f.tell()
        by_name = {e["name"]: e for e in header["slots"]}
        store = _RecordStore(self.slots)
        data = (np.memmap(path, np.uint8, mode="r", offset=base) if mmap
                else np.fromfile(path, np.uint8, offset=base))
        for e in header["slots"]:
            end = e["len_off"] + e["len_n"] * 4
            enforce(end <= len(data), f"SlotRecord file truncated: {path} (need {end} data "
                    f"bytes for slot {e['name']!r}, have {len(data)})")
            enforce_eq(e["len_n"], header["num_records"],
                       f"slot {e['name']!r} length column count")
        for s in store.slots:
            enforce(s.name in by_name, f"slot {s.name!r} missing in {path}")
            e = by_name[s.name]
            enforce_eq(bool(s.is_float), e["is_float"], f"slot {s.name!r} float/id type mismatch")
            vd = np.dtype(e["val_dtype"])
            store._vals[s.name] = [data[e["val_off"]: e["val_off"] + e["val_n"] * vd.itemsize]
                                   .view(vd)]
            store._lens[s.name] = [data[e["len_off"]: e["len_off"] + e["len_n"] * 4]
                                   .view(np.int32)]
        store.num_records = int(header["num_records"])
        self._store = store
        return store.num_records


class QueueDataset:
    """Streaming variant (data_set.h QueueDataset): parse files chunk by
    chunk and yield batches without holding the pass; no shuffle. Lines
    carry over from one file to the next; a last partial batch is not
    yielded."""

    def __init__(self, slots: Sequence[SlotDesc], chunk_lines: int = 65536) -> None:
        self.slots = list(slots)
        self.chunk_lines = chunk_lines
        self._files: List[str] = []
        self.parse_errors = 0

    def set_filelist(self, patterns: Sequence[str]) -> None:
        self._files = _expand_filelist(patterns)

    def batch_iter(self, batch_size: int, start_batch: int = 0
                   ) -> Iterator[Dict[str, Tuple[np.ndarray, np.ndarray]]]:
        """``start_batch`` resumes the stream at a saved cursor: the skipped
        batches' lines are read but never parsed."""
        skip = int(start_batch)
        carry: List[str] = []
        for f in self._files:
            with open(f, "r") as fh:
                while True:
                    lines = fh.readlines(self.chunk_lines * 64)
                    if not lines:
                        break
                    carry.extend(lines)
                    while len(carry) >= batch_size:
                        chunk, carry = carry[:batch_size], carry[batch_size:]
                        if skip > 0:
                            skip -= 1
                            continue
                        ds = InMemoryDataset(self.slots)
                        ds.load_from_lines([l.rstrip("\n") for l in chunk])
                        self.parse_errors += ds.parse_errors
                        yield ds._store.batch(0, ds.num_records)
