"""Checkpoints of the port: tree files (``checkpoint``), the crash-consistent
job checkpoint (``job_checkpoint``), resumable epoch ranges
(``auto_checkpoint``) and the filesystem layer under them (``fs``)."""

from .auto_checkpoint import CheckpointSaver, TrainEpochRange, train_epoch_range
from .checkpoint import (load, load_checkpoint, load_train_state, save, save_checkpoint,
                         save_train_state)
from .job_checkpoint import (CorruptCheckpointError, JobCheckpointManager, RestoredJob,
                             verify_checkpoint)

__all__ = ["save", "load", "save_checkpoint", "load_checkpoint", "save_train_state",
           "load_train_state", "JobCheckpointManager", "RestoredJob",
           "CorruptCheckpointError", "verify_checkpoint", "CheckpointSaver",
           "TrainEpochRange", "train_epoch_range"]
