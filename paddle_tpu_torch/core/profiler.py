"""Host-side profiling scopes, the device trace window and device sync.

Port of ``paddle_tpu.core.profiler`` (the reference's ``RecordEvent``
scopes, ``platform/profiler.cc``, its chrome-tracing logger, and the
``CostTimer`` aggregator of ``distributed/common/cost_timer.h``).

:func:`RecordEvent` does the three things the JAX package's does:

- it marks the range for the device profiler
  (``torch.profiler.record_function``, where JAX uses
  ``jax.profiler.TraceAnnotation``);
- while obs tracing is on (``obs.trace.start_tracing``) it opens an obs
  span of the same name, so the trainers' and the PS client's scopes are
  the client side of the cross-process timeline (tracing off: one flag
  check);
- it adds the scope's host seconds to the per-name statistics
  (:func:`host_event_stats`) and, between :func:`start_timeline` and
  :func:`stop_timeline`, one complete event to the chrome timeline
  (:func:`export_chrome_tracing`, whose ``clockSyncUs`` is the process's
  wall anchor ``obs.trace.EPOCH_ANCHOR_US``, so ``tools/timeline.py``
  aligns several processes' lanes).

:func:`start_profiler`/:func:`stop_profiler` open and close a
``torch.profiler`` window over the CPU and, when there is one, the CUDA
device, and write its chrome trace into ``log_dir`` (the JAX package
writes an XPlane dump there). :func:`fetch_sync` waits for a tensor by a
one-element device-to-host copy, and :func:`timed` measures a call's time
per dispatch with the JAX package's latency subtraction, noise gate and
retries.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..obs import trace as _obs_trace

__all__ = [
    "CostTimer",
    "RecordEvent",
    "export_chrome_tracing",
    "fetch_sync",
    "host_event_stats",
    "profiler_enabled",
    "record_event",
    "reset_host_events",
    "start_profiler",
    "start_timeline",
    "stop_profiler",
    "stop_timeline",
    "timed",
]


class _HostEvents:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._count: Dict[str, int] = {}
        self._total: Dict[str, float] = {}
        self._max: Dict[str, float] = {}

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._count[name] = self._count.get(name, 0) + 1
            self._total[name] = self._total.get(name, 0.0) + seconds
            self._max[name] = max(self._max.get(name, 0.0), seconds)

    def stats(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {name: {"count": self._count[name], "total_s": self._total[name],
                           "avg_s": self._total[name] / self._count[name],
                           "max_s": self._max[name]}
                    for name in self._count}

    def reset(self) -> None:
        with self._lock:
            self._count.clear()
            self._total.clear()
            self._max.clear()


_EVENTS = _HostEvents()


class _Timeline:
    """One chrome "X" (complete) event a scope while enabled: thread id,
    start and duration in microseconds of ``perf_counter``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.enabled = False
        self.events: List[Dict] = []

    def add(self, name: str, t0: float, dur: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.events.append({"name": name, "ph": "X", "ts": t0 * 1e6, "dur": dur * 1e6,
                                "pid": 0, "tid": threading.get_ident() % 1_000_000})


_TIMELINE = _Timeline()


def start_timeline() -> None:
    """Begin recording the scopes for :func:`export_chrome_tracing`."""
    with _TIMELINE._lock:
        _TIMELINE.events.clear()
    _TIMELINE.enabled = True


def stop_timeline() -> None:
    _TIMELINE.enabled = False


def export_chrome_tracing(path: str) -> str:
    """Write the recorded scopes as chrome://tracing JSON; returns ``path``."""
    with _TIMELINE._lock:
        events = list(_TIMELINE.events)
    blob = {"traceEvents": events, "displayTimeUnit": "ms",
            "clockSyncUs": _obs_trace.EPOCH_ANCHOR_US}
    with open(path, "w") as f:
        json.dump(blob, f)
    return path


@contextlib.contextmanager
def RecordEvent(name: str):
    """A named host scope: a ``torch.profiler`` range, an obs span while
    tracing is on, and an entry of :func:`host_event_stats` (and of the
    timeline while it records)."""
    t0 = time.perf_counter()
    span = (_obs_trace.span(name) if _obs_trace.tracing_enabled()
            else contextlib.nullcontext())
    with torch.profiler.record_function(name), span:
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            _EVENTS.add(name, dt)
            _TIMELINE.add(name, t0, dt)


record_event = RecordEvent


class CostTimer:
    """An explicit start/stop timer feeding the same statistics
    (``cost_timer.h:29``), for spans that are not a ``with`` block."""

    def __init__(self, name: str) -> None:
        self._name = name
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        _EVENTS.add(self._name, dt)
        return dt


_PROFILE_LOCK = threading.Lock()
_PROFILE: List[Optional[object]] = [None, None]   # the open window, its log_dir


def start_profiler(log_dir: Optional[str] = None) -> None:
    """Open a ``torch.profiler`` window (CPU, and CUDA when a card is
    there); a second call while one is open does nothing. ``log_dir``
    defaults to ``paddle_tpu_torch_trace`` under the temporary directory."""
    from torch.profiler import ProfilerActivity, profile

    with _PROFILE_LOCK:
        if _PROFILE[0] is not None:
            return
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        _PROFILE[0] = prof
        _PROFILE[1] = log_dir or os.path.join(tempfile.gettempdir(), "paddle_tpu_torch_trace")


def stop_profiler() -> Optional[str]:
    """Close the window and write its chrome trace (``trace.json``) into
    its ``log_dir``; returns the directory, or None when no window was
    open."""
    with _PROFILE_LOCK:
        prof, log_dir = _PROFILE
        if prof is None:
            return None
        _PROFILE[0] = _PROFILE[1] = None
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    return log_dir


def profiler_enabled() -> bool:
    return _PROFILE[0] is not None


def host_event_stats() -> Dict[str, Dict[str, float]]:
    """name → {count, total_s, avg_s, max_s} of every scope since the last
    :func:`reset_host_events`."""
    return _EVENTS.stats()


def reset_host_events() -> None:
    _EVENTS.reset()


def _first_tensor(x):
    """The first leaf in the JAX package's flattening order (dict keys
    sorted)."""
    while isinstance(x, (dict, list, tuple)):
        x = x[min(x)] if isinstance(x, dict) else x[0]
    return x


def fetch_sync(x) -> np.ndarray:
    """Wait for ``x`` (a tensor or a nested dict/list/tuple of them) by a
    one-element device-to-host copy of its first leaf, and return that
    element: the copy cannot complete before the work that writes the
    tensor, whatever the stream's readiness reports."""
    t = _first_tensor(x)
    return t.reshape(-1)[0:1].cpu().numpy()


def timed(fn, *args, iters: int = 20, _retries: int = 2):
    """``(seconds a call, the last output)``: ``iters`` dispatches of
    ``fn(*args)``, one :func:`fetch_sync` at the end, less the fetch's own
    latency (the least of 3 on a ready value). A loop whose total is within
    twice that latency is below the noise: it retries with 5× the
    iterations, twice, then raises ``RuntimeError`` rather than return a
    number that means nothing."""
    out = fn(*args)
    fetch_sync(out)
    lat = min(_t(lambda: fetch_sync(out)) for _ in range(3))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    fetch_sync(out)
    dt = time.perf_counter() - t0 - lat
    if dt <= lat:  # loop total <= 2x latency: below the noise floor
        if _retries > 0:
            return timed(fn, *args, iters=iters * 5, _retries=_retries - 1)
        raise RuntimeError(
            f"timed(): loop total {dt + lat:.4f}s is within 2x the fetch-latency noise floor "
            f"({lat:.4f}s) at iters={iters}; op too fast to resolve")
    return dt / iters, out


def _t(f):
    t0 = time.perf_counter()
    f()
    return time.perf_counter() - t0
