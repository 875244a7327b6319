"""Continuous telemetry: periodic registry snapshots → a bounded
delta-compressed time-series ring.

The port's own copy of ``paddle_tpu.obs.timeseries``. The registry
answers "what are the totals *now*"; this module
makes the totals *curves*. A :class:`Sampler` thread takes a snapshot
every ``period_s`` and appends the DELTA into a :class:`MetricRing`:

- **counters** are stored as rates (delta / dt) — a process restart
  (value went DOWN) re-bases instead of emitting a negative spike;
- **gauges** as last value (+ ewma/max when the snapshot carries them);
- **histograms** as per-bucket count deltas (+ count/sum deltas), with
  the bucket ladder stored ONCE per family — per-tick quantiles and
  windowed quantiles both come from summed deltas.

One ring record is therefore ~the size of the active series set, not
the history; capacity bounds the whole thing (a months-long job keeps
the newest ``capacity`` ticks, oldest dropped).

:class:`JobCollector` is the job-level sampler: its snapshot fans out
over the local registry + every PS shard's ``kObsSnap`` RPC (per-shard
failures tolerated — mid-failover the dead primary simply misses a
tick) + any extra snapshot callables (serving replicas), merged through
:func:`obs.aggregate.merge_snapshots`, so ONE ring holds the whole
job's history: replication lag, checkpoint age, hot-tier hit rate,
serving latency/freshness, per-table wire bytes/density all become
queryable curves. The SLO watchdog (obs/slo.py) evaluates its rules
over this ring; the exporter (obs/exporter.py) serves it over HTTP.

Timestamps are :func:`obs.trace.wall_s` — the per-process wall anchor +
perf_counter, the same axis spans and chrome exports use, so metric
curves and trace lanes line up in a postmortem bundle.
"""

from __future__ import annotations

# lock discipline (read by testing.sched.load_lock_order):
# `_mu` guards the delta-encoder ring, `_latest_mu` the exporter's
# latest-snapshot cell; they are disjoint LEAVES (the sampler thread
# holds at most one at a time, never both).
# LOCK LEAF: _mu _latest_mu
import threading
import time
from collections import deque
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple)

from ..core import sync as _sync
from . import registry as _registry
from .trace import wall_s

__all__ = ["MetricRing", "Sampler", "JobCollector",
           "quantile_from_hist", "sum_hist"]


_LabelKey = Tuple[Tuple[str, str], ...]


def _key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def quantile_from_hist(bounds: Sequence[float], buckets: Sequence[int],
                       q: float) -> float:
    """Prometheus-style quantile estimate from bucket counts (the last
    bucket is +inf): linear interpolation inside the target bucket,
    upper bound for the +inf bucket (= the largest finite bound)."""
    total = sum(buckets)
    if total <= 0:
        return 0.0
    rank = q * total
    cum = 0.0
    for i, n in enumerate(buckets):
        if n <= 0:
            continue
        if cum + n >= rank:
            if i >= len(bounds):        # +inf bucket: no upper edge
                return float(bounds[-1]) if bounds else 0.0
            lo = float(bounds[i - 1]) if i > 0 else 0.0
            hi = float(bounds[i])
            return lo + (hi - lo) * (rank - cum) / n
        cum += n
    return float(bounds[-1]) if bounds else 0.0


def sum_hist(parts: List[Tuple[Sequence[float], Sequence[int]]]
             ) -> Tuple[Tuple[float, ...], List[int]]:
    """Sum bucket-count lists sharing one ladder (first ladder wins;
    mismatched ladders are skipped — the obs/aggregate bounds_conflict
    discipline)."""
    bounds: Tuple[float, ...] = ()
    acc: List[int] = []
    for b, counts in parts:
        if not acc:
            bounds = tuple(b)
            acc = list(counts)
        elif tuple(b) == bounds and len(counts) == len(acc):
            acc = [x + y for x, y in zip(acc, counts)]
    return bounds, acc


class MetricRing:
    """Bounded ring of delta-compressed snapshot records.

    Each :meth:`append` diffs the new absolute snapshot against the
    previous one and stores only the tick's deltas; the absolute state
    kept between ticks is one value per live series (the delta-
    compression working set), the ring is ``capacity`` tick records.
    Thread-safe: the sampler appends while the watchdog/exporter read.
    """

    def __init__(self, capacity: int = 512) -> None:
        self._mu = _sync.Lock()
        self._ring: deque = deque(maxlen=int(capacity))
        # previous ABSOLUTE values per (family, labels): scalar for
        # counters, (count, sum, buckets) for histograms
        self._prev: Dict[Tuple[str, _LabelKey], Any] = {}
        self._bounds: Dict[str, Tuple[float, ...]] = {}  # family ladder
        self._last_t: Optional[float] = None

    # -- write -------------------------------------------------------------

    def append(self, snapshot: Dict[str, Any],
               t: Optional[float] = None) -> Dict[str, Any]:
        """Diff ``snapshot`` (a registry or merged job snapshot) against
        the previous tick and push one delta record. ``t`` is injectable
        for deterministic tests; defaults to :func:`wall_s`."""
        now = wall_s() if t is None else float(t)
        with self._mu:
            dt = (now - self._last_t) if self._last_t is not None else 0.0
            self._last_t = now
            rec: Dict[str, Any] = {"t": now, "dt": dt, "metrics": {}}
            for name, fam in snapshot.get("metrics", {}).items():
                kind = fam.get("type")
                out_series: List[Dict[str, Any]] = []
                for s in fam.get("series", []):
                    labels = dict(s.get("labels", {}))
                    pk = (name, _key(labels))
                    if kind == "counter":
                        v = s.get("value", 0)
                        prev = self._prev.get(pk)
                        self._prev[pk] = v
                        # first sight or restart (value went DOWN):
                        # the new absolute IS the delta since then
                        delta = (v - prev if prev is not None and v >= prev
                                 else v)
                        rate = (delta / dt) if dt > 0 else 0.0
                        out_series.append({"labels": labels,
                                           "delta": delta, "rate": rate})
                    elif kind == "histogram":
                        bounds = tuple(s.get("bounds", ()))
                        fam_bounds = self._bounds.setdefault(name, bounds)
                        if bounds != fam_bounds:
                            out_series.append({"labels": labels,
                                               "bounds_conflict": True})
                            continue
                        cur = (s.get("count", 0), s.get("sum", 0.0),
                               list(s.get("buckets", [])))
                        prev = self._prev.get(pk)
                        self._prev[pk] = cur
                        if prev is None or cur[0] < prev[0] or \
                                len(prev[2]) != len(cur[2]):
                            dcount, dsum, dbuckets = cur
                        else:
                            dcount = cur[0] - prev[0]
                            dsum = cur[1] - prev[1]
                            dbuckets = [a - b for a, b in
                                        zip(cur[2], prev[2])]
                        out_series.append({"labels": labels,
                                           "count": dcount, "sum": dsum,
                                           "buckets": dbuckets})
                    else:  # gauge: last value wins, no delta to take
                        entry = {"labels": labels,
                                 "value": s.get("value", 0.0)}
                        if "ewma" in s:
                            entry["ewma"] = s["ewma"]
                        if "max" in s:
                            entry["max"] = s["max"]
                        out_series.append(entry)
                if out_series:
                    m = {"kind": kind, "series": out_series}
                    if kind == "histogram":
                        m["bounds"] = list(self._bounds.get(name, ()))
                    rec["metrics"][name] = m
            self._ring.append(rec)
            return rec

    # -- read --------------------------------------------------------------

    def records(self, since: Optional[float] = None) -> List[Dict[str, Any]]:
        with self._mu:
            out = list(self._ring)
        if since is not None:
            out = [r for r in out if r["t"] >= since]
        return out

    def __len__(self) -> int:
        with self._mu:
            return len(self._ring)

    @property
    def last_t(self) -> Optional[float]:
        with self._mu:
            return self._last_t

    def bounds(self, family: str) -> Tuple[float, ...]:
        with self._mu:
            return self._bounds.get(family, ())

    @staticmethod
    def _match(labels: Dict[str, str],
               want: Optional[Dict[str, str]]) -> bool:
        if not want:
            return True
        return all(labels.get(k) == str(v) for k, v in want.items())

    def series(self, family: str, field: str = "rate",
               labels: Optional[Dict[str, str]] = None,
               reduce: str = "sum") -> List[Tuple[float, float]]:
        """One curve: [(t, value)] per tick that carried the family.
        ``field``: counters → "rate"/"delta"; gauges → "value"/"ewma"/
        "max"; histograms → "count"/"sum" (per-tick deltas) or
        "p50"/"p90"/"p95"/"p99" (per-tick quantile from the tick's
        bucket deltas). Matching label-sets (subset match on ``labels``)
        reduce by ``reduce``: sum | max | mean | last."""
        out: List[Tuple[float, float]] = []
        for rec in self.records():
            fam = rec["metrics"].get(family)
            if fam is None:
                continue
            if field.startswith("p") and fam["kind"] == "histogram":
                q = float(field[1:]) / 100.0
                parts = [(fam.get("bounds", ()), s["buckets"])
                         for s in fam["series"]
                         if "buckets" in s and self._match(s["labels"],
                                                           labels)]
                bounds, acc = sum_hist(parts)
                if sum(acc) > 0:
                    out.append((rec["t"],
                                quantile_from_hist(bounds, acc, q)))
                continue
            vals = [s[field] for s in fam["series"]
                    if field in s and self._match(s["labels"], labels)]
            if not vals:
                continue
            if reduce == "sum":
                v = float(sum(vals))
            elif reduce == "max":
                v = float(max(vals))
            elif reduce == "mean":
                v = float(sum(vals)) / len(vals)
            else:  # last
                v = float(vals[-1])
            out.append((rec["t"], v))
        return out

    def window_hist(self, family: str, window_s: float,
                    labels: Optional[Dict[str, str]] = None,
                    now: Optional[float] = None
                    ) -> Tuple[Tuple[float, ...], List[int], float]:
        """Summed bucket deltas of ``family`` over the trailing window:
        (bounds, buckets, sum) — the windowed-quantile/bad-fraction
        input the SLO burn-rate rules evaluate."""
        now = wall_s() if now is None else now
        parts, total_sum = [], 0.0
        for rec in self.records(since=now - window_s):
            fam = rec["metrics"].get(family)
            if fam is None or fam["kind"] != "histogram":
                continue
            for s in fam["series"]:
                if "buckets" in s and self._match(s["labels"], labels):
                    parts.append((fam.get("bounds", ()), s["buckets"]))
                    total_sum += s.get("sum", 0.0)
        bounds, acc = sum_hist(parts)
        return bounds, acc, total_sum

    def bad_fraction(self, family: str, threshold: float, window_s: float,
                     labels: Optional[Dict[str, str]] = None,
                     now: Optional[float] = None) -> Tuple[float, int]:
        """(fraction of observations ABOVE ``threshold``, total count)
        over the trailing window — the error-budget burn input. The
        sub-threshold share of the threshold's bucket is estimated by
        linear interpolation (the prometheus convention)."""
        bounds, acc, _ = self.window_hist(family, window_s, labels, now)
        total = sum(acc)
        if total <= 0:
            return 0.0, 0
        good = 0.0
        for i, n in enumerate(acc):
            if i >= len(bounds):
                break
            hi = bounds[i]
            lo = bounds[i - 1] if i > 0 else 0.0
            if hi <= threshold:
                good += n
            elif lo < threshold:
                good += n * (threshold - lo) / max(hi - lo, 1e-12)
        return max(0.0, 1.0 - good / total), total

    def last_value(self, family: str, field: str = "value",
                   labels: Optional[Dict[str, str]] = None,
                   reduce: str = "max") -> Optional[float]:
        """The newest tick's reduced value of one curve (None when the
        family has no samples yet) — the cheap point probe controllers
        use between full window evaluations (ps/autoscale.py reads
        step-time p95 / wire-byte rates this way)."""
        s = self.series(family, field, labels, reduce)
        return s[-1][1] if s else None

    def window_values(self, family: str, field: str, window_s: float,
                      labels: Optional[Dict[str, str]] = None,
                      reduce: str = "sum",
                      now: Optional[float] = None) -> List[float]:
        """Per-tick values of the trailing window (the gauge/counter
        rule input)."""
        now = wall_s() if now is None else now
        return [v for t, v in self.series(family, field, labels, reduce)
                if t >= now - window_s]


class Sampler:
    """The always-on sampler thread: every ``period_s`` run the probes
    (pre-bound gauge setters — replication lag, queue depths), take
    ``snapshot_fn()``, append it to the ring, then fan the tick out to
    ``on_sample`` listeners (the SLO watchdog hooks here so rules are
    evaluated on exactly the data they just gained).

    ``tick()`` is public and deterministic for tests; the thread just
    loops it. A tick that raises is COUNTED and skipped — mid-failover
    a dead shard must cost one tick, not the sampler."""

    def __init__(self, period_s: float = 1.0,
                 ring: Optional[MetricRing] = None,
                 snapshot_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 name: str = "obs-sampler") -> None:
        self.period_s = float(period_s)
        self.ring = ring if ring is not None else MetricRing()
        self._snapshot_fn = snapshot_fn or _registry.snapshot
        self._probes: List[Callable[[], None]] = []
        self._listeners: List[Callable[[float], None]] = []
        self._name = name
        self._stop = _sync.Event()
        self._thread: Optional[threading.Thread] = None
        # self-metrics: pre-bound (cold path), so the sampler's own
        # health is a curve too
        self._c_ticks = _registry.REGISTRY.counter("obs_sampler_ticks",
                                                   sampler=name)
        self._c_errors = _registry.REGISTRY.counter("obs_sampler_errors",
                                                    sampler=name)
        self._g_dur = _registry.REGISTRY.gauge("obs_sample_duration_s",
                                               sampler=name)
        self.errors = 0
        self.ticks = 0
        self.last_error: Optional[str] = None

    # -- composition -------------------------------------------------------

    def add_probe(self, fn: Callable[[], None]) -> "Sampler":
        """Register a pre-tick probe (sets gauges from live state —
        e.g. ``ReplicationManager.export_metrics``)."""
        self._probes.append(fn)
        return self

    def on_sample(self, fn: Callable[[float], None]) -> "Sampler":
        """Register a post-tick listener called with the tick's
        timestamp (the watchdog's evaluation hook)."""
        self._listeners.append(fn)
        return self

    # -- the tick ----------------------------------------------------------

    def tick(self, t: Optional[float] = None) -> Optional[Dict[str, Any]]:
        t0 = time.perf_counter()
        try:
            for probe in self._probes:
                probe()
            rec = self.ring.append(self._snapshot_fn(), t=t)
        except Exception as e:  # noqa: BLE001 — one tick, not the sampler
            self.errors += 1
            self.last_error = f"{type(e).__name__}: {e}"
            self._c_errors.inc()
            return None
        self.ticks += 1
        self._c_ticks.inc()
        self._g_dur.set(time.perf_counter() - t0)
        for fn in self._listeners:
            try:
                fn(rec["t"])
            except Exception as e:  # noqa: BLE001 — listener owns its errors
                self.errors += 1
                self.last_error = f"{type(e).__name__}: {e}"
                self._c_errors.inc()
        return rec

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            self.tick()

    def start(self) -> "Sampler":
        if self._thread is None:
            self._stop.clear()
            self._thread = _sync.Thread(target=self._loop, daemon=True,
                                            name=self._name)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10)

    def __enter__(self) -> "Sampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class JobCollector(Sampler):
    """The job-level sampler: local registry snapshot + one ``kObsSnap``
    per PS shard (via ``client``) + ``extra`` snapshot callables
    (serving replicas' registries, other trainers' exported JSON),
    merged into ONE snapshot per tick. Per-shard fetch failures are
    tolerated and counted (``shard_errors``) — during a failover the
    dead shard misses ticks, the job history does not stop."""

    def __init__(self, client=None, period_s: float = 1.0,
                 ring: Optional[MetricRing] = None,
                 extra: Sequence[Callable[[], Dict[str, Any]]] = (),
                 name: str = "obs-collector") -> None:
        super().__init__(period_s=period_s, ring=ring,
                         snapshot_fn=self._collect, name=name)
        self.client = client
        self.extra = list(extra)
        self.shard_errors = 0
        self._latest: Optional[Dict[str, Any]] = None
        self._latest_mu = _sync.Lock()

    def _collect(self) -> Dict[str, Any]:
        from . import aggregate

        snaps = [_registry.snapshot()]
        if self.client is not None:
            for s in range(self.client.num_servers):
                try:
                    # retries=0: a dead shard (often mid-failover — the
                    # most interesting window to keep sampling through)
                    # costs one fast-failed tick entry, not the
                    # transport's whole retry budget
                    snap, _ = aggregate.fetch_server_obs(
                        self.client, s, drain=False, retries=0)
                    snaps.append(snap)
                except Exception:  # noqa: BLE001 — dead shard ≠ dead tick
                    self.shard_errors += 1
        for fn in self.extra:
            try:
                snaps.append(fn())
            except Exception:  # noqa: BLE001
                self.shard_errors += 1
        merged = aggregate.merge_snapshots(snaps)
        with self._latest_mu:
            self._latest = merged
        return merged

    def latest(self, collect: bool = False) -> Dict[str, Any]:
        """The most recent merged job snapshot (what the HTTP exporter
        renders); ``collect=True`` forces a fresh fan-out."""
        if collect:
            return self._collect()
        with self._latest_mu:
            latest = self._latest
        return latest if latest is not None else self._collect()
