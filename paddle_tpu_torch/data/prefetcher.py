"""Async host batch feeder.

Port of ``paddle_tpu.data.prefetcher.DevicePrefetcher``: a daemon thread
runs the host batch iterator (slicing, key tagging, packing) and keeps
``depth`` finished batches in a bounded queue, so the training loop's
next batch is ready when the step in front of it has been enqueued.

Division of work on the card: the producer thread yields HOST tensors
(:func:`host_tensors`, optionally pinned); the host→device copy runs on
the training thread (:func:`to_device`, ``non_blocking`` from pinned
memory), on the stream the step runs on. The caller keeps every host
tensor of a batch referenced until the step that reads its device copy
has been enqueued: a pinned buffer freed under an in-flight
``non_blocking`` copy would be silent corruption.

:func:`device_prefetch` is the JAX package's default transform: every
array leaf of a batch goes to the device INSIDE the producer thread (from
pageable memory, so the copy has read its source when it returns), and
the training thread receives device tensors.
"""

from __future__ import annotations

import queue
import threading
import weakref
from typing import Any, Iterable, Iterator, Union

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["DevicePrefetcher", "device_prefetch", "host_tensors", "to_device"]

_STOP = object()


class DevicePrefetcher:
    """Iterate ``source`` on a daemon thread with ``depth`` batches in flight."""

    def __init__(self, source: Iterable, depth: int = 2) -> None:
        q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        stop = threading.Event()
        err_box: list = []
        self._q = q
        self._err_box = err_box
        self._stop = stop

        def run() -> None:  # closes over locals ONLY — never `self`, so
            try:            # an abandoned prefetcher can be GC'd
                for item in source:
                    if stop.is_set():
                        return
                    while True:
                        try:
                            q.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            if stop.is_set():
                                return
            except BaseException as e:  # noqa: BLE001 — re-raised in consumer
                err_box.append(e)
            finally:
                while True:  # always deliver the terminator
                    try:
                        q.put(_STOP, timeout=0.5)
                        return
                    except queue.Full:
                        if stop.is_set():
                            return

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="device-prefetcher")
        self._thread.start()
        # abandoned mid-stream → stop the producer
        weakref.finalize(self, stop.set)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if item is _STOP:
            if self._err_box:
                raise self._err_box[0]
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop early; drains so the producer can exit, then joins it."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


def host_tensors(arrays, pin: bool = False) -> tuple:
    """numpy arrays → CPU tensors (pinned with ``pin``, for a
    ``non_blocking`` copy). Runs on the producer thread."""
    out = (torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    return tuple(t.pin_memory() if pin else t for t in out)


def to_device(tensors, device: Union[str, torch.device]) -> tuple:
    """Tensors → ``device``, non-blocking (asynchronous from pinned
    memory). Runs on the training thread."""
    return tuple(t.to(device, non_blocking=True) for t in tensors)


def _leaves_to_device(item: Any, device: torch.device) -> Any:
    if isinstance(item, (tuple, list)):
        return type(item)(_leaves_to_device(x, device) for x in item)
    if isinstance(item, dict):
        return {k: _leaves_to_device(v, device) for k, v in item.items()}
    if isinstance(item, np.ndarray):
        return to_device(host_tensors((item,)), device)[0]
    return item


def device_prefetch(source: Iterable, depth: int = 2,
                    device: Union[str, torch.device, None] = None) -> DevicePrefetcher:
    """Prefetch ``source`` with every numpy array leaf of a tuple/list/dict
    batch moved to ``device`` as a tensor on the producer thread.
    ``device=None`` means ``"cuda"`` and raises without a GPU unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    return DevicePrefetcher((_leaves_to_device(b, dev) for b in source), depth=depth)
