"""Crash-consistent unified job checkpointing.

The port's own copy of ``paddle_tpu.io.job_checkpoint``: one coordinated
snapshot protocol for BOTH state tiers of a PS training job (the sparse
tables and the dense params/optimizer) plus its stream position, in the
JAX package's format (``paddle_tpu.jobckpt.v1``, the same file names), so
a checkpoint written by either package verifies and loads in the other.

- **consistent cut** — ``save()`` briefly holds a mutation gate
  (:class:`~paddle_tpu_torch.ps.ha.CheckpointGate` over the servers'
  ``pause_mutations``, or ``HACluster.checkpoint_gate()``: the routed
  primaries, drained to their backups; the caller quiesces its
  communicator first) and
  captures, in RAM: every registered sparse table's full rows through
  the save-path exporter (``snapshot_items`` — binary-exact) and its
  content digest, taken under the gate. The gate is held for the table
  capture only — bulk IO happens after release.
- **the dense tier is copied before save() returns** — the JAX manager
  serializes the caller's dense tree later, on its writer thread,
  because JAX arrays are immutable. The port's state changes in place
  (the hot tier's rows under B4, the pass cache's under B1, any tensor a
  caller updates with ``copy_``), so :meth:`JobCheckpointManager.save`
  takes a host copy of every tensor and array of ``dense`` while the
  caller is still blocked in it; the writer thread reads only that copy.
- **async durable write** — captured cuts stream to disk on one
  background writer thread through a BOUNDED queue (backpressure, not
  unbounded RAM). A write failure is latched and re-raised at the next
  ``save()``/``wait()``/``stop()``: nothing fails silently.
- **torn-write-proof publish** — every artifact is CRC32C'd into
  ``manifest.json``, and the manifest self-checksums its own values
  (a parseable bit flip in the cursor/step must not resume the job at
  the wrong position); publish is write-tmp → fsync files → fsync dir →
  ``os.replace`` → fsync parent. A crash at ANY instant leaves either a
  fully-verified checkpoint or an unpublished/failing-verification one.
- **verified load + fallback** — ``load_latest()`` verifies manifest
  presence, per-artifact size + CRC32C, and (on restore) the content
  digests; a torn/corrupt newest checkpoint is skipped with a warning
  and the newest VERIFIED one loads instead.
  :class:`~paddle_tpu_torch.core.enforce.NotFoundError` only when no
  verified checkpoint exists.
- **resume-exact** — a restarted job re-imports the tables, restores
  the dense tier, and re-enters the stream at the saved cursor
  (``CtrStreamTrainer.train_from_dataset(start_batch=cursor)``); with a
  ``SyncCommunicator`` (or a local table) the resumed run's final state
  is BIT-identical to an uninterrupted run that checkpoints at the same
  batches (``tests/test_torch_job_checkpoint.py``).

Chaos: the write path carries
:func:`~paddle_tpu_torch.ps.faultpoints.faultpoint` sites —
``ckpt.artifact`` (after each artifact's checksum is recorded, before its
fsync: arm ``truncate-artifact``/``flip-bytes`` for deterministic torn
writes, or ``kill-job`` for a mid-save SIGKILL), ``ckpt.manifest``
(before the manifest is written) and ``ckpt.publish`` (before the
``os.replace``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import signal
import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core import sync as _sync
from ..core.enforce import (NotFoundError, PreconditionNotMetError, enforce)
from ..core.flags import define_flag, flag
from ..obs import registry as _obs_registry
from ..obs import trace as _obs_trace
from ..ps.faultpoints import faultpoint
from . import checkpoint as ckpt
from .fs import (crc32c, crc32c_file, fsync_dir, fsync_file, gc_snapshots,
                 scan_snapshot_ids)

__all__ = ["JobCheckpointManager", "RestoredJob", "CorruptCheckpointError",
           "verify_checkpoint", "combined_digest"]

define_flag("job_ckpt_max_keep", 3,
            "published job checkpoints retained (older ones GC after a "
            "successful publish). Keep >= 2: the corruption fallback "
            "needs a previous verified snapshot when the newest is torn")
define_flag("job_ckpt_queue_depth", 2,
            "captured-but-unwritten snapshots the background writer may "
            "hold; save() blocks (backpressure) when the queue is full")

_FORMAT = "paddle_tpu.jobckpt.v1"
_MANIFEST = "manifest.json"


class CorruptCheckpointError(PreconditionNotMetError):
    """A checkpoint failed verification: missing/short artifact, CRC32C
    mismatch, unreadable manifest, or a post-restore digest mismatch."""


def combined_digest(table) -> int:
    """A table's order-independent content digest as ONE u64: per-server
    digests (RemoteSparseTable returns a list) are wrapping-ADD combined
    — valid because the digest itself is a wrapping sum of per-row
    hashes (pstpu::row_hash), so the shard layout cancels out."""
    d = table.digest()
    if isinstance(d, (list, tuple)):
        return sum(int(x) for x in d) & 0xFFFFFFFFFFFFFFFF
    return int(d)


def _verify_dir(path: str) -> Optional[str]:
    """None when ``path`` holds a verified checkpoint, else the reason
    it is torn/corrupt (artifact bytes are CRC32C-checked in full)."""
    mpath = os.path.join(path, _MANIFEST)
    if not os.path.exists(mpath):
        return "manifest.json missing (crash before publish finished)"
    try:
        with open(mpath) as f:
            man = json.load(f)
    except (ValueError, OSError) as e:
        return f"manifest.json unreadable: {e}"
    if man.get("format") != _FORMAT:
        return f"unknown manifest format {man.get('format')!r}"
    # a corrupted manifest can still PARSE as JSON (flipped byte inside
    # a key/value): re-derive the self-checksum over the canonical
    # serialization minus the checksum field itself
    want_self = man.pop("manifest_crc32c", None)
    if want_self is None:
        return "manifest self-checksum missing"
    if crc32c(json.dumps(man, sort_keys=True).encode()) != want_self:
        return ("manifest fails its self-CRC32C "
                "(parseable but corrupt values)")
    arts = man.get("artifacts")
    if not isinstance(arts, dict):
        return "manifest has no artifact map"
    for rel, meta in arts.items():
        # defense in depth past the self-checksum: malformed entries
        # must become a fallback reason, not a KeyError that escapes
        # the fallback loop
        try:
            want_bytes = int(meta["bytes"])
            want_crc = int(meta["crc32c"])
        except (TypeError, KeyError, ValueError) as e:
            return f"manifest entry for {rel} malformed: {e!r}"
        p = os.path.join(path, rel)
        if not os.path.exists(p):
            return f"artifact {rel} missing"
        size = os.path.getsize(p)
        if size != want_bytes:
            return (f"artifact {rel} truncated "
                    f"({size} bytes, manifest says {want_bytes})")
        if crc32c_file(p) != want_crc:
            return f"artifact {rel} fails its CRC32C"
    return None


def verify_checkpoint(path: str) -> Dict[str, Any]:
    """Verify one published checkpoint directory end to end; returns
    its manifest, raises :class:`CorruptCheckpointError` otherwise."""
    reason = _verify_dir(path)
    if reason is not None:
        raise CorruptCheckpointError(f"checkpoint {path}: {reason}")
    with open(os.path.join(path, _MANIFEST)) as f:
        return json.load(f)


@dataclasses.dataclass
class RestoredJob:
    """One verified checkpoint loaded into RAM, ready to graft into a
    restarted job."""

    ckpt_id: int
    step: int
    cursor: Optional[Dict[str, Any]]
    manifest: Dict[str, Any]
    tables: Dict[str, Tuple[np.ndarray, np.ndarray]]
    dense: Optional[Dict[str, Any]]  # load_train_state schema, or None

    def restore_sparse(self, name: str, table) -> int:
        """Import the named table's rows into ``table`` (a fresh/empty
        one — import is insert-or-overwrite, it cannot delete phantom
        rows) and verify the restored content digest against the one
        captured under the gate. Returns rows imported."""
        enforce(name in self.tables,
                f"checkpoint {self.ckpt_id} has no sparse table "
                f"{name!r} (has {sorted(self.tables)})", NotFoundError)
        keys, values = self.tables[name]
        if len(keys):
            table.import_full(keys, values)
        want = int(self.manifest["tables"][name]["digest"])
        got = combined_digest(table)
        if got != want:
            raise CorruptCheckpointError(
                f"restored table {name!r} digest {got:#x} != captured "
                f"{want:#x} — restore target not fresh, or content drift")
        return len(keys)


class _Snapshot:
    """One captured cut, waiting for the writer thread."""

    __slots__ = ("ckpt_id", "step", "cursor", "tables", "dense", "wall")

    def __init__(self, ckpt_id, step, cursor, tables, dense, wall):
        self.ckpt_id = ckpt_id
        self.step = step
        self.cursor = cursor
        self.tables = tables    # name -> (keys, values, digest)
        self.dense = dense      # {"state", "opt", "rng"?} or None
        self.wall = wall


class JobCheckpointManager:
    """See the module docstring. Typical wiring::

        mgr = JobCheckpointManager(root, gate=CheckpointGate(servers=servers))
        # or gate=cluster.checkpoint_gate() over an ha.HACluster
        mgr.register_sparse("ctr", RemoteSparseTable(cli, 0, cfg))
        trainer.train_from_dataset(ds, checkpoint=mgr, checkpoint_every=50)
        ...
        mgr.stop()   # drain the writer; surface any latched write error

    Restart::

        restored = mgr.load_latest()          # falls back past torn ones
        restored.restore_sparse("ctr", fresh_table)
        trainer.restore_train_state(restored.dense)
        trainer.train_from_dataset(ds, start_batch=restored.cursor)
        # pass the cursor DICT: the trainer validates batch_size against
        # the one the cursor was recorded under (a batch offset at a
        # different size is a wrong record offset)
    """

    def __init__(self, root: str, max_keep: Optional[int] = None,
                 gate=None, queue_depth: Optional[int] = None) -> None:
        self.root = root
        self.max_keep = (max_keep if max_keep is not None
                         else int(flag("job_ckpt_max_keep")))
        self.gate = gate  # context manager (ps.ha.CheckpointGate) or None
        os.makedirs(root, exist_ok=True)
        self._tables: Dict[str, Any] = {}
        self._wq: "queue.Queue[_Snapshot]" = _sync.Queue(
            maxsize=(queue_depth if queue_depth is not None
                     else int(flag("job_ckpt_queue_depth"))))
        # two locks with disjoint concerns: _mu orders lifecycle
        # (stopped flag, in-flight-put accounting, id allocation) among
        # producers; _err_mu guards only the error latch (the writer's
        # sole lock). The backpressured queue put itself happens with
        # NEITHER lock held — a producer parked on a full queue must
        # not block other savers' id allocation or stop(); _inflight
        # (condition on _mu) is what keeps the put-vs-shutdown-sentinel
        # ordering instead.
        self._mu = _sync.Lock()
        self._inflight = 0                      # accepted, put not landed
        self._quiesced = _sync.Condition(self._mu)
        self._err_mu = _sync.Lock()
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        ids = self._ids()   # one directory scan, not one per use
        self._next_id = (ids[-1] + 1) if ids else 0
        self.saves = 0
        # bounded: a months-long job checkpoints forever — rolling
        # windows, not ever-growing per-manager lists
        self.pause_ms: "deque" = deque(maxlen=512)  # gate hold/capture
        self.fallbacks: "deque" = deque(maxlen=64)  # (id, reason) @load
        self._clean_stale_tmp()
        # obs: set at every publish — (now - gauge) is the checkpoint
        # AGE the SLO watchdog's staleness rule alarms on
        self._g_last_pub = _obs_registry.REGISTRY.gauge(
            "job_checkpoint_last_wall_s")
        self._c_published = _obs_registry.REGISTRY.counter(
            "job_checkpoints_published")

    # -- registration ------------------------------------------------------

    def register_sparse(self, name: str, table) -> None:
        """Register a sparse table for every later save: anything with
        the Table snapshot surface (``snapshot_items``/``import_full``/
        ``digest``) — MemorySparseTable, SsdSparseTable, or a
        RemoteSparseTable view over an RpcPsClient."""
        for attr in ("snapshot_items", "import_full", "digest"):
            enforce(hasattr(table, attr),
                    f"table {name!r} lacks .{attr}() — not a snapshot-"
                    "capable Table")
        self._tables[name] = table

    # -- save --------------------------------------------------------------

    def save(self, step: int, cursor: Optional[Dict[str, Any]] = None,
             dense: Optional[Dict[str, Any]] = None,
             blocking: bool = False) -> int:
        """Capture a consistent cut NOW (under the gate) and hand it to
        the background writer (``blocking=True`` writes + publishes
        inline instead). Raises a previous save's latched write failure
        before capturing — write errors surface here, never silently.
        ``dense`` follows the ``train_state`` schema ({"state", "opt",
        optional "rng"}). Returns the checkpoint id."""
        self._raise_pending()
        enforce(not self._stopped, "JobCheckpointManager is stopped")
        snap = self._capture(step, cursor, dense)
        if blocking:
            self._write(snap)
        else:
            # admission (stopped-check + in-flight count) is atomic
            # under _mu; the bounded put happens OUTSIDE it. stop()
            # flips _stopped under _mu and then waits for _inflight to
            # reach zero before enqueuing its shutdown sentinel, so
            # every admitted snapshot still lands AHEAD of the sentinel
            # — but a producer parked on a full queue (writer lagging)
            # no longer holds _mu, so concurrent savers' id allocation
            # and stop() itself stay responsive while it waits.
            with self._mu:
                enforce(not self._stopped,
                        "JobCheckpointManager stopped during capture — "
                        "snapshot discarded")
                self._ensure_writer()
                self._inflight += 1
            try:
                self._wq.put(snap)  # backpressure: blocks, lock-free
            finally:
                with self._mu:
                    self._inflight -= 1
                    if self._inflight == 0:
                        self._quiesced.notify_all()
        return snap.ckpt_id

    def _capture(self, step, cursor, dense) -> _Snapshot:
        t0 = time.perf_counter()
        gate = self.gate if self.gate is not None else _NULL_GATE
        with gate:
            tables = {}
            for name, t in self._tables.items():
                # a capture only reads, so it never trips a live reshard's
                # ownership fence: it re-resolves the topology here, under
                # the gate (whose control_mu pins the routing), or a capture
                # after a grow would read the old servers and miss every
                # moved row
                refresh = getattr(t, "refresh_routing", None)
                if refresh is not None:
                    refresh()
                keys, values = t.snapshot_items(0)
                # digest under the gate: the same cut the arrays came
                # from (native-fast; the python mirror is row_digest)
                tables[name] = (keys, values, combined_digest(t))
        self.pause_ms.append((time.perf_counter() - t0) * 1000.0)
        # the port's state changes in place: the writer thread must read a
        # copy taken now, while the caller that owns the tree is blocked
        # here (the JAX manager keeps the caller's immutable arrays)
        dense = None if dense is None else _host_copy(dense)
        with self._mu:
            no = self._next_id
            self._next_id += 1
        return _Snapshot(no, int(step), cursor, tables, dense, time.time())

    # -- background writer -------------------------------------------------

    def _ensure_writer(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = _sync.Thread(
                target=self._writer_loop, daemon=True, name="job-ckpt-writer")
            self._thread.start()

    def _writer_loop(self) -> None:
        while True:
            snap = self._wq.get()
            try:
                if snap is None:
                    return
                self._write(snap)
            except BaseException as e:  # noqa: BLE001 — latched, surfaced
                with self._err_mu:      # at the next save()/wait()/stop()
                    self._error = e
            finally:
                self._wq.task_done()

    def _raise_pending(self) -> None:
        with self._err_mu:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def wait(self) -> None:
        """Block until every enqueued snapshot is written + published;
        re-raise any write failure (tests/tools synchronization)."""
        self._wq.join()
        self._raise_pending()

    def stop(self) -> None:
        """Drain the writer and shut it down; surfaces latched errors.
        The queue is FIFO, _stopped flips under _mu, and the sentinel
        waits for in-flight puts to land, so every snapshot a save()
        was admitted for sits AHEAD of the shutdown sentinel and still
        gets written."""
        with self._mu:
            if self._stopped:
                return
            self._stopped = True
            while self._inflight:
                # an admitted save() is parked on the full queue; the
                # writer keeps draining (it never takes _mu), the put
                # lands, and the producer notifies. Waiting here keeps
                # the sentinel BEHIND every admitted snapshot.
                self._quiesced.wait()
            thread = self._thread
        if thread is not None and thread.is_alive():
            self._wq.put(None)
            thread.join(timeout=600)
            enforce(not thread.is_alive(),
                    "job-checkpoint writer still running after stop() "
                    "timeout — a snapshot write is in flight and NOT "
                    "durably published; do not treat this shutdown as "
                    "checkpointed", PreconditionNotMetError)
        self._raise_pending()

    def __enter__(self) -> "JobCheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the durable write (writer thread / blocking save) -----------------

    @staticmethod
    def _hard_kill() -> None:
        # the kill-job faultpoint's callable: die like a preemption —
        # no atexit, no flushes, nothing graceful anywhere
        os.kill(os.getpid(), signal.SIGKILL)

    def _write(self, snap: _Snapshot) -> None:
        final = os.path.join(self.root, f"ckpt_{snap.ckpt_id}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        files = []  # (relname, abspath) in write order
        table_meta = {}
        for name, (keys, values, digest) in snap.tables.items():
            base = os.path.join(tmp, f"sparse_{name}")
            npz, meta = ckpt.save({"keys": keys, "values": values}, base)
            files += [(os.path.basename(npz), npz),
                      (os.path.basename(meta), meta)]
            table_meta[name] = {"digest": int(digest), "rows": len(keys)}
        if snap.dense is not None:
            base = os.path.join(tmp, "dense")
            npz, meta = ckpt.save_train_state(
                base, snap.dense["state"], opt_state=snap.dense.get("opt"),
                rng=snap.dense.get("rng"), step=snap.step)
            files += [(os.path.basename(npz), npz),
                      (os.path.basename(meta), meta)]
        artifacts = {}
        for rel, path in files:
            artifacts[rel] = {"crc32c": crc32c_file(path),
                              "bytes": os.path.getsize(path)}
            # chaos site AFTER the checksum snapshot, BEFORE the fsync:
            # truncate-artifact/flip-bytes simulate exactly the torn
            # write the verifier must catch; kill-job dies mid-save
            faultpoint("ckpt.artifact", path=path, kill=self._hard_kill)
            fsync_file(path)
        faultpoint("ckpt.manifest", kill=self._hard_kill)
        manifest = {
            "format": _FORMAT,
            "ckpt_id": snap.ckpt_id,
            "step": snap.step,
            "time": snap.wall,
            "cursor": snap.cursor,
            "tables": table_meta,
            "dense": snap.dense is not None,
            "artifacts": artifacts,
        }
        # artifact CRCs guard the artifacts but nothing guarded the
        # manifest VALUES themselves: a bit flip that keeps the JSON
        # parseable (a cursor/step digit) would resume the job at the
        # wrong stream position with every artifact still verifying —
        # self-checksum the canonical serialization too
        manifest["manifest_crc32c"] = crc32c(
            json.dumps(manifest, sort_keys=True).encode())
        mpath = os.path.join(tmp, _MANIFEST)
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        fsync_dir(tmp)
        faultpoint("ckpt.publish", kill=self._hard_kill)
        os.replace(tmp, final)   # atomic publish of the whole snapshot
        fsync_dir(self.root)
        self.saves += 1
        self._g_last_pub.set(_obs_trace.wall_s())
        self._c_published.inc()
        self._gc()

    def _gc(self) -> None:
        gc_snapshots(self.root, self.max_keep)

    def _clean_stale_tmp(self) -> None:
        # leftover .tmp staging from a crashed predecessor: unpublished
        # by definition — never loadable, safe to clear
        for name in os.listdir(self.root):
            if name.startswith("ckpt_") and name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)

    def _ids(self):
        return scan_snapshot_ids(self.root)

    # -- load --------------------------------------------------------------

    def load_latest(self) -> RestoredJob:
        """Load the newest VERIFIED checkpoint: every artifact's size +
        CRC32C checks out. Torn/corrupt newer ones are skipped (recorded
        in ``self.fallbacks`` and printed — the operator should know a
        fallback happened); NotFoundError when nothing verifies."""
        for no in reversed(self._ids()):
            path = os.path.join(self.root, f"ckpt_{no}")
            try:
                reason = _verify_dir(path)
            except Exception as e:  # unreadable artifact (EACCES, IO
                reason = (f"verification raised "  # error) = unverified
                          f"{type(e).__name__}: {e}")
            if reason is not None:
                self.fallbacks.append((no, reason))
                print(f"job_checkpoint: skipping ckpt_{no}: {reason} — "
                      "falling back to the previous verified snapshot")
                continue
            return self._load(path, no)
        raise NotFoundError(
            f"no verified job checkpoint under {self.root} "
            f"(skipped: {[n for n, _ in self.fallbacks]})")

    def _load(self, path: str, no: int) -> RestoredJob:
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        tables = {}
        for name in manifest.get("tables", {}):
            snap = ckpt.load(os.path.join(path, f"sparse_{name}"))
            tables[name] = (np.ascontiguousarray(snap["keys"], np.uint64),
                            np.ascontiguousarray(snap["values"], np.float32))
        dense = (ckpt.load_train_state(os.path.join(path, "dense"))
                 if manifest.get("dense") else None)
        return RestoredJob(ckpt_id=no, step=int(manifest.get("step", 0)),
                           cursor=manifest.get("cursor"), manifest=manifest,
                           tables=tables, dense=dense)

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return {
            "saves": self.saves,
            "queued": self._wq.qsize(),
            "pause_ms_last": self.pause_ms[-1] if self.pause_ms else 0.0,
            "pause_ms": list(self.pause_ms),
            "fallbacks": list(self.fallbacks),
        }


def _host_copy(tree):
    """A copy of ``tree`` whose tensor and array leaves are fresh host
    buffers (tensors stay tensors, on the CPU)."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


class _NullGate:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL_GATE = _NullGate()
