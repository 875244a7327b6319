"""Vision datasets: MNIST, FashionMNIST, Cifar10 and Cifar100.

Port of ``paddle_tpu.data.vision`` (numpy only). Each dataset loads its
local files when given a path (IDX for MNIST, the python pickle batches
for CIFAR) and otherwise falls back to a seeded synthetic sample set with
class-dependent structure, bit-equal to the JAX package's for the same
seed: class k lights a k-dependent patch, so a small model separates the
classes. Nothing is downloaded.

Unpickling runs code: give ``Cifar10``/``Cifar100`` only files you trust.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import Optional, Tuple

import numpy as np

from ..core.enforce import InvalidArgumentError, enforce

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100"]


class _ArrayDataset:
    def __init__(self, images: np.ndarray, labels: np.ndarray) -> None:
        self.images = images
        self.labels = labels

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx):
        return self.images[idx], self.labels[idx]


def _synthetic_images(n: int, shape: Tuple[int, ...], num_classes: int,
                      seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Class-dependent blobs: class k lights a k-dependent patch, so a
    small model separates classes (used by tests and zero-egress runs)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n).astype(np.int64)
    images = rng.normal(0.1, 0.1, (n,) + shape).astype(np.float32)
    c, h, w = shape
    ph = max(h // 4, 1)
    for k in range(num_classes):
        sel = labels == k
        r = (k * ph) % max(h - ph, 1)
        col = (k * ph) % max(w - ph, 1)
        images[sel, :, r : r + ph, col : col + ph] += 0.9
    return images, labels


class MNIST(_ArrayDataset):
    """IDX-format loader (train-images-idx3-ubyte[.gz] etc. under
    ``image_path`` dir) with synthetic fallback. mode: train|test."""

    NUM_CLASSES = 10
    SHAPE = (1, 28, 28)
    FILES = {
        "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }

    def __init__(self, mode: str = "train", image_path: Optional[str] = None,
                 backend: str = "auto", synthetic_size: int = 2048,
                 seed: int = 0) -> None:
        enforce(mode in ("train", "test"), f"mode train|test, got {mode!r}",
                InvalidArgumentError)
        imgs = labels = None
        if backend in ("auto", "idx") and image_path:
            imgs, labels = self._try_load_idx(image_path, mode)
            enforce(imgs is not None or backend == "auto",
                    f"no IDX files for mode={mode} under {image_path}",
                    InvalidArgumentError)
        if imgs is None:
            imgs, labels = _synthetic_images(
                synthetic_size, self.SHAPE, self.NUM_CLASSES,
                seed + (0 if mode == "train" else 1))
        super().__init__(imgs, labels)

    @classmethod
    def _try_load_idx(cls, root: str, mode: str):
        img_name, lbl_name = cls.FILES[mode]

        def find(name):
            for cand in (name, name + ".gz"):
                p = os.path.join(root, cand)
                if os.path.exists(p):
                    return p
            return None

        img_p, lbl_p = find(img_name), find(lbl_name)
        if not img_p or not lbl_p:
            return None, None

        def read(path):
            op = gzip.open if path.endswith(".gz") else open
            with op(path, "rb") as f:
                return f.read()

        raw = read(img_p)
        magic, n, h, w = struct.unpack(">IIII", raw[:16])
        imgs = (np.frombuffer(raw, np.uint8, offset=16)
                .reshape(n, 1, h, w).astype(np.float32) / 255.0)
        raw = read(lbl_p)
        _, n2 = struct.unpack(">II", raw[:8])
        labels = np.frombuffer(raw, np.uint8, offset=8).astype(np.int64)
        return imgs, labels


class FashionMNIST(MNIST):
    """Same IDX format, different archive contents."""


class Cifar10(_ArrayDataset):
    """CIFAR python-pickle batches under ``data_path`` (cifar-10-batches-py)
    with synthetic fallback."""

    NUM_CLASSES = 10
    SHAPE = (3, 32, 32)

    def __init__(self, mode: str = "train", data_path: Optional[str] = None,
                 backend: str = "auto", synthetic_size: int = 2048,
                 seed: int = 0) -> None:
        enforce(mode in ("train", "test"), f"mode train|test, got {mode!r}",
                InvalidArgumentError)
        imgs = labels = None
        if backend in ("auto", "pickle") and data_path:
            imgs, labels = self._try_load(data_path, mode)
        if imgs is None:
            imgs, labels = _synthetic_images(
                synthetic_size, self.SHAPE, self.NUM_CLASSES,
                seed + (0 if mode == "train" else 1))
        super().__init__(imgs, labels)

    def _batch_files(self, root: str, mode: str):
        if mode == "train":
            return [os.path.join(root, f"data_batch_{i}") for i in range(1, 6)]
        return [os.path.join(root, "test_batch")]

    def _label_key(self):
        return b"labels"

    def _try_load(self, root: str, mode: str):
        files = [p for p in self._batch_files(root, mode) if os.path.exists(p)]
        if not files:
            return None, None
        xs, ys = [], []
        for p in files:
            with open(p, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(np.asarray(d[b"data"], np.uint8))
            ys.append(np.asarray(d[self._label_key()], np.int64))
        imgs = (np.concatenate(xs).reshape(-1, 3, 32, 32).astype(np.float32)
                / 255.0)
        return imgs, np.concatenate(ys)


class Cifar100(Cifar10):
    NUM_CLASSES = 100

    def _batch_files(self, root: str, mode: str):
        return [os.path.join(root, "train" if mode == "train" else "test")]

    def _label_key(self):
        return b"fine_labels"
