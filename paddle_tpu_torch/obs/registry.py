"""Low-overhead process metrics registry (the obs plane's counter leg).

The port's own copy of ``paddle_tpu.obs.registry``:

- **Pre-bound handles.** ``registry.counter("fam", table="0")`` is the
  EXPENSIVE call (registry lock, label-key canonicalization, cardinality
  check) and belongs at module/constructor scope; the returned handle's
  ``inc``/``set``/``observe`` are the hot-path calls — one small
  per-handle lock, no dict lookups, no string formatting.
- **Bounded label cardinality.** Each family admits at most
  ``FLAGS_obs_max_series`` distinct label-sets (override per family via
  ``max_series=``); the overflow label-set collapses into one shared
  ``{"overflow": "true"}`` series and ``dropped_series`` counts what was
  collapsed — a runaway label degrades into one bucket instead of eating
  the process.
- **Null mode.** With ``FLAGS_obs_metrics=0`` every creation call
  returns the shared ``_NULL`` handle whose methods are no-ops (the
  "metrics compiled out" baseline). The flag is read at HANDLE CREATION
  time (a process-start decision), not per increment.
- **Snapshot, not push.** ``snapshot()`` renders the whole registry to
  one JSON-able dict stamped with process identity, in the JAX
  package's schema (the job-wide merge, ``obs/aggregate.py``, is not
  ported: ROADMAP Queue A).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..core.flags import define_flag, flag

__all__ = [
    "Counter", "Gauge", "Histogram", "CounterGroup", "Registry",
    "REGISTRY", "counter", "gauge", "histogram", "snapshot",
    "metrics_enabled", "set_process_role",
]

define_flag("obs_metrics", True,
            "metrics registry master switch: False makes every handle "
            "creation return a shared no-op handle (the zero-overhead "
            "baseline the obs CI gate measures against). Read at handle "
            "CREATION time — set FLAGS_obs_metrics=0 in the environment "
            "before the process builds its clients/trainers")
define_flag("obs_max_series", 64,
            "per-family label-set cap: label-sets beyond it collapse "
            "into one {'overflow': 'true'} series (dropped_series "
            "counts them) so an unbounded label cannot grow the "
            "registry without limit")

# default histogram bounds: latency-shaped, seconds (100 us … 10 s)
_DEFAULT_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2,
                    2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class _NullHandle:
    """Shared no-op handle (FLAGS_obs_metrics=0): every method is a
    constant-time no-op, ``value`` reads 0."""

    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    add = inc

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    @property
    def value(self) -> int:
        return 0

    def hist(self) -> Dict[str, Any]:
        return {"count": 0, "sum": 0.0, "bounds": [], "buckets": []}


_NULL = _NullHandle()


class Counter:
    """Monotonic counter. ``inc`` is the hot-path call: one per-handle
    lock (uncontended in the common one-writer case), no allocation."""

    __slots__ = ("_mu", "_v")

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._v = 0

    def inc(self, n: int = 1) -> None:
        with self._mu:
            self._v += n

    add = inc

    @property
    def value(self) -> int:
        return self._v  # single attribute read — consistent under the GIL


class Gauge:
    """Last-value gauge with an optional EWMA view (``set`` feeds both).
    The EWMA (alpha 0.2) is what slowly-varying measurements like
    observed push density export — one noisy batch doesn't whipsaw the
    auto-placement feed."""

    __slots__ = ("_mu", "_v", "_ewma")

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._v = 0.0
        self._ewma: Optional[float] = None

    def set(self, v: float) -> None:
        with self._mu:
            self._v = float(v)
            self._ewma = (float(v) if self._ewma is None
                          else 0.8 * self._ewma + 0.2 * float(v))

    @property
    def value(self) -> float:
        return self._v

    @property
    def ewma(self) -> float:
        return self._v if self._ewma is None else self._ewma


class Histogram:
    """Fixed-bound bucketed histogram (count/sum/per-bucket counts; the
    last bucket is +inf). ``observe`` walks the bounds linearly — the
    default 16-bucket latency ladder costs a few comparisons, far below
    the syscall it usually measures."""

    __slots__ = ("_mu", "bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds: Tuple[float, ...] = _DEFAULT_BUCKETS) -> None:
        self._mu = threading.Lock()
        self.bounds = tuple(float(b) for b in bounds)
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        i = 0
        for b in self.bounds:
            if v <= b:
                break
            i += 1
        with self._mu:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def value(self) -> int:
        return self._count

    def hist(self) -> Dict[str, Any]:
        with self._mu:
            return {"count": self._count, "sum": self._sum,
                    "bounds": list(self.bounds),
                    "buckets": list(self._counts)}


class CounterGroup:
    """Dict-shaped bundle of pre-bound counters sharing a family +
    base labels — the migration shim for code written against plain
    ``dict`` counters (``g["hits"] += 1`` keeps working; the value
    ALSO lands in the registry under ``labels + {key: name}``).

    Reads come from a local int mirror (exact, lock-free — the
    hot-tier control plane is single-threaded); writes go through to
    the registry handle as a delta, so the job-wide snapshot sees the
    same numbers ``stats()`` returns."""

    def __init__(self, family: str, names: Tuple[str, ...],
                 registry: Optional["Registry"] = None,
                 **labels: str) -> None:
        reg = registry if registry is not None else REGISTRY
        self._local: Dict[str, int] = {n: 0 for n in names}
        self._handles = {n: reg.counter(family, key=n, **labels)
                         for n in names}

    def __getitem__(self, k: str) -> int:
        return self._local[k]

    def __setitem__(self, k: str, v: int) -> None:
        # positive deltas flow through to the (monotonic) registry
        # counter; writing a LOWER value resets only the local window
        # (frontend.reset() measures steady state locally — the job
        # total keeps running, exactly like reset_op_counts)
        delta = int(v) - self._local[k]
        self._local[k] = int(v)
        if delta > 0:
            self._handles[k].add(delta)

    def __contains__(self, k: str) -> bool:
        return k in self._local

    def __iter__(self) -> Iterator[str]:
        return iter(self._local)

    def keys(self):
        return self._local.keys()

    def items(self):
        return self._local.items()

    def values(self):
        return self._local.values()

    def as_dict(self) -> Dict[str, int]:
        return dict(self._local)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    __slots__ = ("kind", "series", "overflow", "dropped", "max_series",
                 "buckets")

    def __init__(self, kind: str, max_series: int,
                 buckets: Optional[Tuple[float, ...]]) -> None:
        self.kind = kind
        self.series: Dict[Tuple[Tuple[str, str], ...], Any] = {}
        self.overflow: Optional[Any] = None
        self.dropped = 0
        self.max_series = max_series
        self.buckets = buckets

    def make(self):
        if self.kind == "histogram":
            return Histogram(self.buckets or _DEFAULT_BUCKETS)
        return _KINDS[self.kind]()


class Registry:
    """One process's metric store. Almost every caller wants the
    module-level ``REGISTRY`` (what ``snapshot()`` exports and the
    aggregator merges); private instances exist for tests and for the
    overhead bench's in-process disabled arm."""

    def __init__(self) -> None:
        self._mu = threading.RLock()
        self._families: Dict[str, _Family] = {}
        self._role = "proc"
        self._start = time.perf_counter()
        # per-family drop counters (family name → Counter in the
        # ``obs_dropped_series`` family, labeled {"family": name}):
        # makes a cardinality blowout ATTRIBUTABLE — "which family (and
        # so whose label, e.g. which tenant's request-derived value)
        # overflowed" instead of one opaque per-family integer buried in
        # the snapshot. Lazily bound on the first drop (the overflow
        # path is cold by definition).
        self._drop_handles: Dict[str, Counter] = {}

    # -- handle creation (the cold, registry-locked path) -----------------

    def _handle(self, kind: str, name: str,
                buckets: Optional[Tuple[float, ...]],
                max_series: Optional[int], labels: Dict[str, Any]):
        if not flag("obs_metrics"):
            return _NULL
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._mu:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(kind,
                              int(max_series if max_series is not None
                                  else flag("obs_max_series")),
                              buckets)
                self._families[name] = fam
            if fam.kind != kind:
                raise ValueError(
                    f"metric family {name!r} already registered as "
                    f"{fam.kind}, not {kind}")
            h = fam.series.get(key)
            if h is None:
                if len(fam.series) >= fam.max_series:
                    # cardinality bound: collapse into the one shared
                    # overflow series instead of growing without limit
                    fam.dropped += 1
                    self._count_drop(name)
                    if fam.overflow is None:
                        fam.overflow = fam.make()
                    return fam.overflow
                h = fam.make()
                fam.series[key] = h
            return h

    def _count_drop(self, family: str) -> None:
        """Attribute one dropped label-set to its family in the
        ``obs_dropped_series`` family. Called under ``_mu`` (RLock — the
        nested ``_handle`` re-entry is safe); the meta-family is exempt
        from its own accounting so a pathological process with more
        overflowing families than ``obs_dropped_series``'s own series
        cap cannot recurse."""
        if family == "obs_dropped_series":
            return
        h = self._drop_handles.get(family)
        if h is None:
            h = self._handle("counter", "obs_dropped_series", None,
                             256, {"family": family})
            self._drop_handles[family] = h
        h.inc()

    def counter(self, name: str, max_series: Optional[int] = None,
                **labels: Any) -> Counter:
        return self._handle("counter", name, None, max_series, labels)

    def gauge(self, name: str, max_series: Optional[int] = None,
              **labels: Any) -> Gauge:
        return self._handle("gauge", name, None, max_series, labels)

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None,
                  max_series: Optional[int] = None,
                  **labels: Any) -> Histogram:
        return self._handle("histogram", name, buckets, max_series, labels)

    # -- identity / export -------------------------------------------------

    def set_role(self, role: str) -> None:
        """Name this process's lane in the job-wide aggregate
        ("trainer", "ps_shard_0", "serving_frontend", ...)."""
        self._role = str(role)

    def snapshot(self) -> Dict[str, Any]:
        """The whole registry as one JSON-able dict. Counter/gauge
        series render as scalars (gauges add ``ewma``); histograms as
        {count, sum, bounds, buckets}."""
        out_m: Dict[str, Any] = {}
        with self._mu:
            fams = list(self._families.items())
        for name, fam in fams:
            series: List[Dict[str, Any]] = []
            with self._mu:
                entries = list(fam.series.items())
                overflow = fam.overflow
                dropped = fam.dropped
            for key, h in entries:
                rec: Dict[str, Any] = {"labels": dict(key)}
                if fam.kind == "histogram":
                    rec.update(h.hist())
                else:
                    rec["value"] = h.value
                    if fam.kind == "gauge":
                        rec["ewma"] = h.ewma
                series.append(rec)
            if overflow is not None:
                rec = {"labels": {"overflow": "true"}}
                if fam.kind == "histogram":
                    rec.update(overflow.hist())
                else:
                    rec["value"] = overflow.value
                series.append(rec)
            out_m[name] = {"type": fam.kind, "series": series,
                           "dropped_series": dropped}
        return {
            "process": {
                "role": self._role,
                "pid": os.getpid(),
                "host": socket.gethostname(),
                "uptime_s": round(time.perf_counter() - self._start, 3),
            },
            "metrics": out_m,
        }

    def export_json(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)
        return path

    def reset(self) -> None:
        """Drop every family (tests / bench rounds). Handles created
        before a reset keep working but are no longer exported —
        re-create them after a reset."""
        with self._mu:
            self._families.clear()
            self._drop_handles.clear()


#: the process default registry — what ``snapshot()`` exports and the
#: job aggregator merges
REGISTRY = Registry()


def counter(name: str, **labels: Any) -> Counter:
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels: Any) -> Gauge:
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, buckets: Optional[Tuple[float, ...]] = None,
              **labels: Any) -> Histogram:
    return REGISTRY.histogram(name, buckets=buckets, **labels)


def snapshot() -> Dict[str, Any]:
    return REGISTRY.snapshot()


def set_process_role(role: str) -> None:
    REGISTRY.set_role(role)


def metrics_enabled() -> bool:
    return bool(flag("obs_metrics"))
