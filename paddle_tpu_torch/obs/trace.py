"""Trace spans (the obs plane's tracing leg).

The port's own copy of ``paddle_tpu.obs.trace``: a trace is a tree of
spans rooted at one sampled operation (one ``CtrStreamTrainer`` step);
the compact context ``(trace_id, span_id)`` of the INNERMOST open span
rides the PS RPC frame header (``ps.rpc`` → the fixed 16-byte field of
``csrc/ps_service.cc``'s ReqHeader). The server records a server-side
span against it (service time, gate wait, request and response bytes),
and ``obs.aggregate`` stitches both sides into one chrome trace, where a
client pull span links by a flow event to the shard that served it.
Spans land in a bounded ring and export as chrome-trace JSON.

Cost model:

- tracing OFF (default): ``span()`` is one module-bool check;
  ``wire_context()`` is one check returning (0, 0): the request header
  still carries the 16-byte context field, zeroed, and the server
  records no span.
- tracing ON: only SAMPLED roots allocate spans; unsampled traffic pays
  the same single check.

Span ids are unique across processes without coordination: 64-bit
``pid<<44 | local counter``. Timestamps are ``perf_counter``-based with
a once-per-process wall anchor, so multi-process exports merge on one
clock."""

from __future__ import annotations

import contextlib
import os
import struct
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "Span", "span", "start_tracing", "stop_tracing", "tracing_enabled",
    "wire_context", "current_span", "mark_retried", "with_span",
    "drain_spans", "peek_spans", "spans_to_chrome", "export_chrome_trace",
    "WIRE_CONTEXT_BYTES", "EPOCH_ANCHOR_US", "wall_s",
    "SERVER_SPAN_STRUCT", "SERVER_WIRE_STRUCT",
]

#: bytes the trace context occupies in the RPC frame header — fixed
#: whether tracing is on or off (the request header's trace_id + span_id)
WIRE_CONTEXT_BYTES = 16

# wall-clock anchor for perf_counter timestamps, taken ONCE at import:
# exported spans carry epoch-anchored microseconds so traces from
# different processes/hosts merge on one clock axis.
# genuine wall-clock anchor, not a duration measurement:
_EPOCH_OFF = time.time() - time.perf_counter()
EPOCH_ANCHOR_US = _EPOCH_OFF * 1e6


def wall_s() -> float:
    """Wall-clock seconds on the SAME anchored axis every span/export
    uses (the once-per-process anchor + perf_counter): monotonic within
    the process, comparable across processes — what the obs time-series
    ring and SLO alerts stamp their records with."""
    return _EPOCH_OFF + time.perf_counter()

_enabled = False
_sample_rate = 1.0
_MU = threading.Lock()          # ring + id allocation + attr mutation
_RING: deque = deque(maxlen=65536)   # bounded: a sampled month-long job
#                                      keeps the newest spans only
_dropped = 0
_next_id = 0
# sampling PRNG: os.urandom-seeded xorshift — cheap, no global random
# state touched (tests pin sample=1.0/0.0 so determinism isn't needed)
_rng_state = int.from_bytes(os.urandom(8), "little") | 1

_TLS = threading.local()


def _new_id() -> int:
    global _next_id
    with _MU:
        _next_id += 1
        n = _next_id
    return ((os.getpid() & 0xFFFFF) << 44) | (n & ((1 << 44) - 1))


def _sampled() -> bool:
    global _rng_state
    if _sample_rate >= 1.0:
        return True
    if _sample_rate <= 0.0:
        return False
    with _MU:
        x = _rng_state
        x ^= (x << 13) & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 7
        x ^= (x << 17) & 0xFFFFFFFFFFFFFFFF
        _rng_state = x
    return (x >> 11) / float(1 << 53) < _sample_rate


class Span:
    """One recorded scope. ``attrs`` carries small facts (retried,
    tx/rx bytes, shard) — mutate through :meth:`add_attr`/
    :meth:`add_bytes` (module-lock protected: RPC fan-out workers
    update the op span concurrently)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "kind",
                 "t0", "dur", "tid", "attrs")

    def __init__(self, trace_id: int, span_id: int, parent_id: int,
                 name: str, kind: str) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.kind = kind
        self.t0 = time.perf_counter()
        self.dur = 0.0
        self.tid = threading.get_ident() % 1_000_000
        self.attrs: Dict[str, Any] = {}

    def add_attr(self, key: str, val: Any) -> None:
        with _MU:
            self.attrs[key] = val

    def add_bytes(self, tx: int = 0, rx: int = 0) -> None:
        with _MU:
            self.attrs["tx_bytes"] = self.attrs.get("tx_bytes", 0) + int(tx)
            self.attrs["rx_bytes"] = self.attrs.get("rx_bytes", 0) + int(rx)
            self.attrs["rpc"] = True


#: sentinel occupying the TLS slot for the SCOPE of an unsampled root:
#: children see it and stay unsampled too (the "children inherit the
#: root's decision" contract — without it every child would re-roll and
#: become an orphan root). Ids are 0, so wire_context() through it is
#: (0, 0) and propagating it across fan-out workers stays a no-op.
_UNSAMPLED = Span(0, 0, 0, "<unsampled>", "internal")


def start_tracing(sample: float = 1.0, ring: int = 65536) -> None:
    """Enable span recording. ``sample`` is the per-ROOT probability
    (children inherit the root's decision); ``ring`` bounds the span
    buffer (oldest dropped, counted)."""
    global _enabled, _sample_rate, _RING, _dropped
    with _MU:
        _sample_rate = float(sample)
        _RING = deque(maxlen=int(ring))
        _dropped = 0
    _enabled = True


def stop_tracing() -> None:
    global _enabled
    _enabled = False


def tracing_enabled() -> bool:
    return _enabled


def current_span() -> Optional[Span]:
    """The innermost open span on this thread — or the ``_UNSAMPLED``
    sentinel inside an unsampled root (callers propagating it via
    :func:`with_span` carry the not-sampled decision with them)."""
    return getattr(_TLS, "span", None)


def wire_context() -> Tuple[int, int]:
    """(trace_id, span_id) to stamp into the next RPC frame — (0, 0)
    unless tracing is on AND a sampled span is open on this thread."""
    s = getattr(_TLS, "span", None)
    if s is None:
        return 0, 0
    return s.trace_id, s.span_id  # the _UNSAMPLED sentinel reads (0, 0)


def mark_retried() -> None:
    """Stamp the innermost open span ``retried`` — the HA failover
    replay path calls this so a replayed RPC is visibly a REPLAY in
    the merged timeline (same span id, no duplicate span)."""
    s = getattr(_TLS, "span", None)
    if s is not None and s is not _UNSAMPLED:
        with _MU:
            s.attrs["retried"] = True
            s.attrs["retries"] = s.attrs.get("retries", 0) + 1


@contextlib.contextmanager
def span(name: str, kind: str = "internal") -> Iterator[Optional[Span]]:
    """Open a child of the current span (or a sampled new root).
    Yields the Span, or None when tracing is off / the root was not
    sampled — callers never branch on it."""
    if not _enabled:
        yield None
        return
    parent = getattr(_TLS, "span", None)
    if parent is _UNSAMPLED:
        yield None  # inside an unsampled root: no re-roll, no orphans
        return
    if parent is None:
        if not _sampled():
            # park the sentinel for this scope so CHILDREN inherit the
            # negative decision instead of re-rolling into orphan roots
            _TLS.span = _UNSAMPLED
            try:
                yield None
            finally:
                _TLS.span = None
            return
        s = Span(_new_id(), _new_id(), 0, name, kind)
    else:
        s = Span(parent.trace_id, _new_id(), parent.span_id, name, kind)
    _TLS.span = s
    try:
        yield s
    finally:
        _TLS.span = parent
        s.dur = time.perf_counter() - s.t0
        _record(s)


@contextlib.contextmanager
def with_span(s: Optional[Span]) -> Iterator[None]:
    """Adopt ``s`` as this THREAD's current span — the context
    propagation shim for worker pools (RpcPsClient fan-out,
    communicator pull workers): capture ``current_span()`` where the
    op starts, re-enter it on the worker so ``wire_context()`` and
    ``mark_retried()`` see the right span. No new span is recorded."""
    prev = getattr(_TLS, "span", None)
    _TLS.span = s
    try:
        yield
    finally:
        _TLS.span = prev


def _record(s: Span) -> None:
    global _dropped
    with _MU:
        if len(_RING) == _RING.maxlen:
            _dropped += 1
        _RING.append(s)


def drain_spans() -> List[Span]:
    """Snapshot-and-clear the recorded spans (exporters own them)."""
    with _MU:
        out = list(_RING)
        _RING.clear()
    return out


def peek_spans() -> List[Span]:
    """Snapshot WITHOUT clearing — the flight recorder's tail read: a
    postmortem dump must not consume the spans a later explicit export
    (or a second trigger) still wants."""
    with _MU:
        return list(_RING)


def dropped_spans() -> int:
    return _dropped


# ---------------------------------------------------------------------------
# chrome-trace export
# ---------------------------------------------------------------------------

def spans_to_chrome(spans: List[Span], pid: int = 0,
                    process_name: Optional[str] = None,
                    epoch_offset_us: float = 0.0
                    ) -> List[Dict[str, Any]]:
    """Spans → chrome-trace events: one "X" complete event per span
    plus FLOW events — an "s" start on every span that carried its
    context over the RPC wire (``attrs["rpc"]``), keyed by span id,
    which a server-side span's "f" finish binds to, drawing the
    cross-process arrow.

    Timestamps are RAW ``perf_counter`` microseconds (+
    ``epoch_offset_us``); the containing blob's ``clockSyncUs`` anchor
    (see :func:`export_chrome_trace`) is what a timeline merge adds
    to put every process lane on one wall clock — events must NOT be
    pre-anchored or the merge would double-shift them."""
    off = epoch_offset_us
    events: List[Dict[str, Any]] = []
    if process_name is not None:
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": process_name}})
    for s in spans:
        ts = off + s.t0 * 1e6
        args = {"trace_id": f"{s.trace_id:x}", "span_id": f"{s.span_id:x}",
                **s.attrs}
        events.append({"name": s.name, "cat": s.kind, "ph": "X",
                       "ts": ts, "dur": s.dur * 1e6, "pid": pid,
                       "tid": s.tid, "args": args})
        if s.attrs.get("rpc"):
            events.append({"name": "ps_rpc", "cat": "rpc_flow", "ph": "s",
                           "id": s.span_id, "ts": ts + s.dur * 1e6 / 2,
                           "pid": pid, "tid": s.tid})
    return events


def export_chrome_trace(path: str, pid: int = 0,
                        process_name: Optional[str] = None) -> str:
    """Dump (and drain) this process's spans as chrome-trace JSON with
    a ``clockSyncUs`` anchor a timeline merge aligns lanes by."""
    import json

    events = spans_to_chrome(drain_spans(), pid=pid,
                             process_name=process_name)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "clockSyncUs": EPOCH_ANCHOR_US}, f)
    return path


# ---------------------------------------------------------------------------
# server-span wire format (the kObsSnap response; see csrc/ps_service.cc)
# ---------------------------------------------------------------------------

#: one server-side span record: trace_id, span_id, cmd, table_id,
#: ts_us (wall), dur_us, gate_us, req_bytes, resp_bytes
SERVER_SPAN_STRUCT = struct.Struct("<QQII q q q QQ")
#: one per-table wire record: table_id, pad, in_bytes, out_bytes,
#: in_rows, out_rows, reqs
SERVER_WIRE_STRUCT = struct.Struct("<II qqqqq")
