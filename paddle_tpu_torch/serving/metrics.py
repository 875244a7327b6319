"""Serving-plane observability: bounded latency and freshness recorders.

The port's own copy of ``paddle_tpu.serving.metrics``. Everything here is
bounded by construction (fixed-size rings): a serving process that runs
for months must not grow per-request state.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

import numpy as np

from ..obs import registry as _obs_registry

__all__ = ["LatencyRecorder", "FreshnessProbe"]

_REC_SEQ = iter(range(1, 1 << 30))  # per-process recorder tag allocator


class LatencyRecorder:
    """Sliding-window latency percentiles: record seconds, read
    p50/p95/p99 over the last ``window`` samples. Thread-safe (the
    frontend worker records while operators read stats).

    Every ``record`` also lands in the job-wide ``serving_latency_s``
    histogram family (labelled by ``name``: the frontend names its
    recorders request/serve), so the registry's snapshot carries serving
    latency next to the PS wire counters. ``percentiles()`` is the exact
    ring-based accessor.

    ``family`` sends the registry samples to another histogram family;
    extra keyword ``labels`` ride along."""

    def __init__(self, window: int = 4096,
                 name: Optional[str] = None,
                 replica: str = "-",
                 family: str = "serving_latency_s",
                 **labels: str) -> None:
        self._ring: deque = deque(maxlen=window)
        self._mu = threading.Lock()
        self.count = 0
        # `replica` names the serving member that emitted the sample ("-"
        # outside a fleet); cardinality is bounded by max_series
        self._hist = _obs_registry.REGISTRY.histogram(
            family, max_series=1024,
            recorder=name if name is not None
            else f"latency{next(_REC_SEQ)}",
            replica=str(replica),
            **{k: str(v) for k, v in labels.items()})

    def record(self, seconds: float) -> None:
        self._hist.observe(seconds)
        with self._mu:
            self._ring.append(seconds)
            self.count += 1

    def reset(self) -> None:
        """Drop recorded samples (measure steady state after a priming
        burst, not the warm-up's tail)."""
        with self._mu:
            self._ring.clear()
            self.count = 0

    def percentiles(self) -> Dict[str, float]:
        with self._mu:
            buf = np.asarray(self._ring, np.float64)
        if len(buf) == 0:
            return {"count": 0, "p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0,
                    "max_ms": 0.0}
        q = np.quantile(buf, [0.5, 0.95, 0.99])
        return {"count": self.count,
                "p50_ms": round(float(q[0]) * 1e3, 3),
                "p95_ms": round(float(q[1]) * 1e3, 3),
                "p99_ms": round(float(q[2]) * 1e3, 3),
                "max_ms": round(float(buf.max()) * 1e3, 3)}


class FreshnessProbe:
    """Measures the push→servable freshness SLO end to end: the writer
    side stamps a monotonically increasing marker value into a probe
    key on the TRAINING client; the reader side polls the SERVING path
    until the marker is visible and records the elapsed time. One probe
    per call — the bench/tests drive the cadence.

    ``timeout_s`` bounds a probe; a probe that never becomes visible
    counts as a ``failure`` and records the timeout as its latency, so a
    broken feed degrades the percentile instead of vanishing from it.
    """

    def __init__(self, window: int = 1024, timeout_s: float = 5.0,
                 poll_s: float = 0.0005, replica: str = "-") -> None:
        self.latency = LatencyRecorder(window, name="freshness",
                                       replica=replica)
        self.timeout_s = timeout_s
        self.poll_s = poll_s
        self.failures = 0
        self.probes = 0
        # job-wide counters next to the latency histogram: a broken
        # feed shows up in the aggregate, not only in local stats() —
        # labeled per replica so a fleet's one stale member is visible
        self._c_probes = _obs_registry.REGISTRY.counter(
            "serving_freshness_probes", max_series=1024, outcome="ok",
            replica=str(replica))
        self._c_failures = _obs_registry.REGISTRY.counter(
            "serving_freshness_probes", max_series=1024, outcome="timeout",
            replica=str(replica))

    def measure(self, write, read, target) -> Optional[float]:
        """``write()`` publishes the marker (returns None); ``read()``
        returns the currently-servable value; ``target(value)`` → True
        once the marker is visible. Returns the observed push→servable
        seconds (None on timeout)."""
        self.probes += 1
        t0 = time.perf_counter()
        write()
        deadline = t0 + self.timeout_s
        while True:
            if target(read()):
                dt = time.perf_counter() - t0
                self.latency.record(dt)
                self._c_probes.inc()
                return dt
            if time.perf_counter() >= deadline:
                self.failures += 1
                self._c_failures.inc()
                self.latency.record(self.timeout_s)
                return None
            time.sleep(self.poll_s)

    def stats(self) -> Dict[str, float]:
        out = dict(self.latency.percentiles())
        out["probes"] = self.probes
        out["failures"] = self.failures
        return out
