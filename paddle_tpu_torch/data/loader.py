"""In-memory ``TensorDataset`` and ``DataLoader`` (the dense path).

Port of ``paddle_tpu.data.loader``: numpy batches, ``drop_last`` by
default, and for the same ``seed`` the same shuffled batch order as the
JAX package's. The slot-record pipeline of the PS path is
``data.dataset``.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from ..core.enforce import InvalidArgumentError, enforce

__all__ = ["DataLoader", "TensorDataset"]


class TensorDataset:
    """Aligned arrays dataset (features..., labels...)."""

    def __init__(self, *arrays: np.ndarray) -> None:
        self.arrays = [np.asarray(a) for a in arrays]
        n = len(self.arrays[0])
        for a in self.arrays:
            enforce(len(a) == n, "all arrays must share their leading dimension",
                    InvalidArgumentError)
        self._len = n

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.arrays)


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = True,
        seed: Optional[int] = None,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        end = n - n % self.batch_size if self.drop_last else n
        for start in range(0, end, self.batch_size):
            idx = order[start : start + self.batch_size]
            yield self.dataset[idx]
