"""Crash flight recorder: an always-on tail of recent telemetry that
dumps an atomic postmortem bundle when the job degrades.

The port's own copy of ``paddle_tpu.obs.flightrec``. While nothing is
wrong the recorder costs one bounded deque append per noted event (the
span tail is the trace module's ring, peeked, not drained). Only a
TRIGGER pays real cost: one atomic directory publish
(``io.fs.publish_atomic``) containing

- ``manifest.json``  — reason, trigger info, process identity, wall
  time, bundle content listing;
- ``trace.json``     — one chrome trace: this process's span tail and
  the noted events as instant events, on the shared wall-clock axis;
- ``timeline.json``  — the metric ring's delta records;
- ``alerts.json``    — the SLO alert log;
- ``events.json``    — the recorder's own noted-event tail with wall
  timestamps.

The JAX recorder's three outside sources — the metric ring (``ring=``,
``obs/timeseries.py``), the SLO watchdog (``watchdog=``, ``obs/slo.py``)
and the PS shards' server spans (``client=``, ``obs/aggregate.py`` over
the server's obs wire) — are not ported (ROADMAP Queue A item 10).
Passing any of them raises :class:`UnavailableError`; the bundle then
always has empty ``timeline.json`` records and ``alerts.json`` alerts,
in the JAX package's schema.

Trigger sites call the module-level :func:`notify` — one global read,
a no-op until a recorder is :func:`install`-ed. In the port the wired
sites are fired faultpoints (``ps/faultpoints.py``) and an exception
that escapes ``CtrStreamTrainer.train_from_dataset``; SIGTERM through
:func:`install_signal_handler`.

Dumps are rate-limited (``min_interval_s``) and garbage-collected
(``keep`` newest bundles).
"""

from __future__ import annotations

import json
import os
import shutil
from collections import deque
from typing import Any, Dict, List, Optional, Set

from ..core import sync as _sync
from ..core.enforce import UnavailableError
from . import registry as _registry
from . import trace as _trace
from .trace import wall_s

__all__ = ["FlightRecorder", "install", "uninstall", "installed", "notify",
           "install_signal_handler", "DEFAULT_DUMP_ON", "BUNDLE_PREFIX"]

BUNDLE_PREFIX = "postmortem_"

#: event kinds that dump a bundle by default; everything else is noted
#: into the tail only. ``slo_alert`` is note-only by default (a burning
#: SLO is a condition, not an instant) — the slo_demo/CI gate opts it in.
DEFAULT_DUMP_ON = frozenset({
    "failover_promotion", "breaker_open", "faultpoint",
    "trainer_exception", "serving_exception", "sigterm",
    "reconcile_stall", "spec_abort",
})


class FlightRecorder:
    """``out_dir`` is the bundle root (created if missing). ``ring``,
    ``watchdog`` and ``client`` are the JAX recorder's outside sources;
    the port has none of them yet, and passing one raises
    :class:`UnavailableError` (see the module docstring)."""

    def __init__(self, out_dir: str,
                 ring=None, watchdog=None, client=None,
                 dump_on: Optional[Set[str]] = None,
                 keep: int = 8, min_interval_s: float = 5.0,
                 tail_events: int = 1024) -> None:
        for what, src, module in (("ring", ring, "obs/timeseries.py"),
                                  ("watchdog", watchdog, "obs/slo.py"),
                                  ("client", client, "obs/aggregate.py and the server's obs wire")):
            if src is not None:
                raise UnavailableError(
                    f"FlightRecorder({what}=...) needs {module}, which is not ported yet "
                    "(ROADMAP Queue A item 10)")
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.dump_on = (set(DEFAULT_DUMP_ON) if dump_on is None
                        else set(dump_on))
        self.keep = int(keep)
        self.min_interval_s = float(min_interval_s)
        self._mu = _sync.Lock()
        self._events: deque = deque(maxlen=int(tail_events))
        self._last_dump_t = float("-inf")
        self._dumping = False
        self.dumps: List[str] = []
        self.suppressed = 0
        self.dump_errors = 0
        self.last_error: Optional[str] = None
        # pre-bound self-metrics: the recorder's activity is a curve too
        self._c_events = _registry.REGISTRY.counter("flightrec_events")
        self._c_dumps = _registry.REGISTRY.counter("flightrec_dumps")

    # -- the always-on tail ------------------------------------------------

    def note(self, kind: str, **info: Any) -> None:
        with self._mu:
            self._events.append({"t": wall_s(), "kind": kind, **info})
        self._c_events.inc()

    def events(self) -> List[Dict[str, Any]]:
        with self._mu:
            return list(self._events)

    def notify(self, kind: str, **info: Any) -> Optional[str]:
        """Record the event; dump a bundle when ``kind`` is armed.
        Never raises — a failed dump is itself recorded."""
        self.note(kind, **info)
        if kind not in self.dump_on:
            return None
        return self.trigger(reason=kind, **info)

    # -- the dump ----------------------------------------------------------

    def trigger(self, reason: str, **info: Any) -> Optional[str]:
        """Publish one atomic postmortem bundle; returns its path, or
        None when rate-limited or failed (recorded, never raised)."""
        from ..io import fs as _fs

        with self._mu:
            now = wall_s()
            if self._dumping or \
                    now - self._last_dump_t < self.min_interval_s:
                self.suppressed += 1
                return None
            self._dumping = True
            # next free slot on DISK, not an in-memory counter: a
            # restarted process must not collide with (or clobber) the
            # bundles the crash it is diagnosing left behind
            ids = _fs.scan_snapshot_ids(self.out_dir, prefix=BUNDLE_PREFIX)
            bundle_id = (ids[-1] + 1) if ids else 1
        try:
            path = self._dump(bundle_id, reason, now, info)
        except Exception as e:  # noqa: BLE001 — triage aid, not a fault
            self.dump_errors += 1
            self.last_error = f"{type(e).__name__}: {e}"
            return None
        finally:
            with self._mu:
                self._dumping = False
        with self._mu:
            # the rate-limit window starts at a SUCCESSFUL dump only: a
            # failed attempt (disk full) must not suppress the next real
            # trigger's bundle — possibly the crash this recorder exists
            # to keep
            self._last_dump_t = now
            self.dumps.append(path)
        self._c_dumps.inc()
        return path

    def _merged_trace(self, alerts: List[Dict[str, Any]]
                      ) -> Dict[str, Any]:
        """One chrome trace on the shared wall axis: local span tail
        (epoch-anchored), SLO alerts + noted events as instant events."""
        role = _registry.snapshot()["process"]["role"]
        events = _trace.spans_to_chrome(
            _trace.peek_spans(), pid=0, process_name=role,
            epoch_offset_us=_trace.EPOCH_ANCHOR_US)
        for a in alerts:
            events.append({"name": f"ALERT {a.get('rule', '?')}",
                           "cat": "slo_alert", "ph": "i", "s": "g",
                           "ts": a.get("t", 0.0) * 1e6, "pid": 0, "tid": 0,
                           "args": a})
        for ev in self.events():
            events.append({"name": f"EVENT {ev['kind']}",
                           "cat": "flightrec", "ph": "i", "s": "p",
                           "ts": ev["t"] * 1e6, "pid": 0, "tid": 0,
                           "args": {k: v for k, v in ev.items()
                                    if k != "t"}})
        ts = [e["ts"] for e in events if "ts" in e]
        t0 = min(ts) if ts else 0.0
        for e in events:
            if "ts" in e:
                e["ts"] -= t0
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "clockSyncUs": t0}

    def _dump(self, bundle_id: int, reason: str, now: float,
              info: Dict[str, Any]) -> str:
        # lazy: obs must stay importable without dragging the io package
        # (io/job_checkpoint itself imports obs for its metrics)
        from ..io import fs as _fs

        # no watchdog and no metric ring in the port (the constructor
        # refuses them): the bundle keeps the JAX schema with both empty
        alerts: List[Dict[str, Any]] = []
        records: List[Dict[str, Any]] = []
        tmp = os.path.join(self.out_dir, f"{BUNDLE_PREFIX}{bundle_id}.tmp")
        final = os.path.join(self.out_dir, f"{BUNDLE_PREFIX}{bundle_id}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        trace_blob = self._merged_trace(alerts)
        files = {
            "trace.json": trace_blob,
            "timeline.json": {"records": records},
            "alerts.json": {"alerts": alerts},
            "events.json": {"events": self.events()},
        }
        for name, blob in files.items():
            with open(os.path.join(tmp, name), "w", encoding="utf-8") as f:
                json.dump(blob, f)
        manifest = {
            "reason": reason,
            "info": {k: v for k, v in info.items()
                     if isinstance(v, (str, int, float, bool, list, dict))},
            "wall_s": now,
            "process": _registry.snapshot()["process"],
            "spans": sum(1 for e in trace_blob["traceEvents"]
                         if e.get("ph") == "X"),
            "alerts": len(alerts),
            "metric_records": len(records),
            "files": sorted(files),
        }
        with open(os.path.join(tmp, "manifest.json"), "w",
                  encoding="utf-8") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        _fs.publish_atomic(tmp, final)
        _fs.gc_snapshots(self.out_dir, self.keep, prefix=BUNDLE_PREFIX)
        return final

    def bundles(self) -> List[str]:
        """Published bundle paths, oldest first (post-GC)."""
        from ..io import fs as _fs

        ids = _fs.scan_snapshot_ids(self.out_dir, prefix=BUNDLE_PREFIX)
        return [os.path.join(self.out_dir, f"{BUNDLE_PREFIX}{i}")
                for i in ids]


# ---------------------------------------------------------------------------
# module-level hook surface (what the instrumented sites call)
# ---------------------------------------------------------------------------

_RECORDER: Optional[FlightRecorder] = None


def install(recorder: FlightRecorder) -> FlightRecorder:
    """Make ``recorder`` the process's trigger sink. One per process —
    installing replaces the previous one."""
    global _RECORDER
    _RECORDER = recorder
    return recorder


def uninstall() -> None:
    global _RECORDER
    _RECORDER = None


def installed() -> Optional[FlightRecorder]:
    return _RECORDER


def notify(kind: str, **info: Any) -> Optional[str]:
    """The site-side hook: one global read when no recorder is
    installed (the always-on cost at every wired site)."""
    rec = _RECORDER
    if rec is None:
        return None
    return rec.notify(kind, **info)


def install_signal_handler(recorder: Optional[FlightRecorder] = None
                           ) -> bool:
    """Dump a bundle on SIGTERM (the preemption signal), then continue
    with the previous disposition (chained handler, or the default
    terminate). Returns False when not callable from this thread
    (signal handlers are main-thread-only) or on non-POSIX."""
    import signal

    rec = recorder if recorder is not None else _RECORDER
    if rec is None:
        return False
    prev = None

    def _on_term(signum, frame):
        rec.notify("sigterm", signal=int(signum))
        if callable(prev):
            prev(signum, frame)
        elif prev is signal.SIG_IGN:
            return  # the process CHOSE to ignore TERM — honor it
        else:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    try:
        prev = signal.signal(signal.SIGTERM, _on_term)
    except ValueError:  # not the main thread
        return False
    return True
