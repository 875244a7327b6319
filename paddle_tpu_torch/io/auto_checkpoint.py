"""Auto-checkpoint: resumable epoch/step ranges.

The port's own copy of ``paddle_tpu.io.auto_checkpoint`` (reference:
``fluid/incubate/checkpoint/auto_checkpoint.py``): ``TrainEpochRange``
wraps the epoch loop, snapshotting the state a getter returns plus the
loop position at a cadence, and ``train_epoch_range`` resumes from the
last complete snapshot so a restarted job (elastic restart, preemption)
skips finished epochs. ``CheckpointSaver`` keeps numbered snapshot
directories over the port's ``io/checkpoint.py`` files, published
atomically (``io/fs.py``); the directories are the JAX package's, so
either package resumes from the other's snapshots.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Iterator, Optional

from ..core.enforce import enforce
from . import checkpoint as ckpt
from .fs import gc_snapshots, publish_atomic, scan_snapshot_ids

__all__ = ["TrainEpochRange", "train_epoch_range", "CheckpointSaver"]


class CheckpointSaver:
    """Numbered snapshot directories with atomic publish and GC
    (checkpoint_saver.py semantics: save_checkpoint/get_last/clean_redundant)."""

    def __init__(self, root: str, max_keep: int = 3) -> None:
        self.root = root
        self.max_keep = max_keep
        os.makedirs(root, exist_ok=True)

    def _ids(self):
        return scan_snapshot_ids(self.root)

    def save(self, payload: Any, meta: Dict[str, Any]) -> int:
        ids = self._ids()   # one directory scan, not one per use
        no = (ids[-1] + 1) if ids else 0
        tmp = os.path.join(self.root, f"ckpt_{no}.tmp")
        final = os.path.join(self.root, f"ckpt_{no}")
        os.makedirs(tmp, exist_ok=True)
        ckpt.save(payload, os.path.join(tmp, "state"))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        # fsync files + dirs BEFORE the rename publishes: os.replace
        # alone can land while the data blocks are still dirty page
        # cache — a crash then publishes a directory of torn files
        publish_atomic(tmp, final)
        self.clean_redundant()
        return no

    def get_last(self):
        ids = self._ids()
        if not ids:
            return None, None, None
        no = ids[-1]
        d = os.path.join(self.root, f"ckpt_{no}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        return no, ckpt.load(os.path.join(d, "state")), meta

    def clean_redundant(self) -> None:
        gc_snapshots(self.root, self.max_keep)


class TrainEpochRange:
    """Resumable ``for epoch in TrainEpochRange(n, name, dir)`` loop.

    State to snapshot is registered via ``set_state_getter/setter`` (the
    reference hooks exe/program state the same way); ``save()`` may be
    called mid-epoch for step-level granularity."""

    _needs_step_skip = False
    _cursor_consumed = False

    @property
    def step_in_epoch(self) -> int:
        """Completed steps of the (re-entered) epoch. READING it counts
        as consuming the cursor — the caller is handling the skip
        themselves, whether they read BEFORE the epoch loop or inside
        the epoch body; callers that neither read it nor use
        :meth:`steps` on a mid-epoch resume fail loudly at the epoch's
        end instead of silently re-training the completed steps."""
        self._needs_step_skip = False
        self._cursor_consumed = True
        return self._step_in_epoch

    @step_in_epoch.setter
    def step_in_epoch(self, v: int) -> None:
        self._step_in_epoch = int(v)
        self._cursor_consumed = False  # a fresh cursor is unconsumed

    def __init__(self, max_epoch_num: int, name: str,
                 checkpoint_dir: Optional[str] = None,
                 save_checkpoint_inter: float = 0.0,
                 max_keep: int = 3) -> None:
        self.max_epoch_num = max_epoch_num
        self.name = name
        root = os.path.join(checkpoint_dir or os.environ.get(
            "PADDLE_TPU_CHECKPOINT_DIR", "/tmp/paddle_tpu_acp"), name)
        self._saver = CheckpointSaver(root, max_keep=max_keep)
        self._inter = save_checkpoint_inter
        self._last_save = 0.0
        self._get_state: Optional[Callable[[], Any]] = None
        self._set_state: Optional[Callable[[Any], None]] = None
        self.restored_epoch = -1
        self.step_in_epoch = 0
        no, payload, meta = self._saver.get_last()
        self._pending_restore = (payload, meta) if no is not None else None

    def set_state_getter(self, fn: Callable[[], Any]) -> None:
        self._get_state = fn

    def set_state_setter(self, fn: Callable[[Any], None]) -> None:
        self._set_state = fn
        if self._pending_restore is not None:
            payload, meta = self._pending_restore
            fn(payload)
            self.restored_epoch = int(meta["epoch"])
            self.step_in_epoch = int(meta.get("step", 0))
            self._pending_restore = None

    def save(self, epoch: int, step: int = 0) -> None:
        """``step > 0`` marks a MID-epoch snapshot: a restart re-enters
        ``epoch`` itself (not ``epoch + 1``) with ``step_in_epoch`` set,
        and :meth:`steps` skips the completed steps."""
        enforce(self._get_state is not None, "set_state_getter first")
        self._saver.save(self._get_state(), {"epoch": epoch, "step": step,
                                             "time": time.time()})
        self._last_save = time.monotonic()

    def steps(self, iterable) -> Iterator:
        """Wrap the inner step loop: ``for step, item in r.steps(data)``.
        On the epoch a mid-epoch snapshot re-entered, the first
        ``step_in_epoch`` items are skipped (they trained before the
        crash); every other epoch passes through untouched."""
        skip, self._step_in_epoch = self._step_in_epoch, 0
        self._needs_step_skip = False
        self._cursor_consumed = True
        for i, item in enumerate(iterable):
            if i < skip:
                continue
            yield i, item

    def __iter__(self) -> Iterator[int]:
        # a mid-epoch snapshot (step > 0) re-enters ITS epoch partway —
        # restarting it from scratch would re-train the completed steps
        resume_mid = self._step_in_epoch > 0
        start = (self.restored_epoch if resume_mid
                 else self.restored_epoch + 1)
        # a caller may consume the cursor BEFORE this loop starts (read
        # step_in_epoch, skip the steps themselves) — re-arming the
        # guard here would kill that correct resume at the epoch's end
        self._needs_step_skip = resume_mid and not self._cursor_consumed
        for epoch in range(start, self.max_epoch_num):
            yield epoch
            # a mid-epoch resume whose caller ran a plain inner loop
            # (no steps()/step_in_epoch consumption) has just RE-TRAINED
            # the completed steps on top of the restored state — fail
            # loudly now rather than silently corrupt the weights
            enforce(not self._needs_step_skip,
                    f"resumed epoch {epoch} mid-way (step_in_epoch was "
                    "set) but the completed steps were never skipped — "
                    "wrap the inner loop in r.steps(iterable) or consume "
                    "r.step_in_epoch before training")
            self._step_in_epoch = 0   # later epochs start clean
            if self._get_state is not None and (
                    self._inter <= 0 or
                    time.monotonic() - self._last_save >= self._inter):
                self.save(epoch)


def train_epoch_range(max_epoch_num: int, name: str = "default",
                      **kw) -> TrainEpochRange:
    return TrainEpochRange(max_epoch_num, name, **kw)
