"""Read-only HTTP metrics endpoint + OpenMetrics text rendering
(the port's own copy of ``paddle_tpu.obs.exporter``).

One tiny stdlib server per TRAINER exposes the whole job: the trainer
already proxies every PS shard through the :class:`~.timeseries.
JobCollector` (shards stay RPC-only — ``kObsSnap`` — and never open
ports), so a standard Prometheus/OpenMetrics scraper pointed at the
trainer sees trainer + communicator + every shard + any registered
serving replica in one scrape.

Endpoints (GET only; anything else is 405 — the exporter is strictly
read-only):

- ``/metrics``        OpenMetrics text of the current job snapshot
  (``# TYPE`` per family, ``_total`` counter naming, escaped label
  values, ``# EOF`` terminator)
- ``/snapshot.json``  the same snapshot as JSON
- ``/history.json``   the delta-compressed time-series ring (whole-job
  curves)
- ``/alerts.json``    the SLO watchdog's alert log
- ``/healthz``        liveness

:func:`parse_openmetrics` is a strict validator (escape handling,
cumulative-bucket monotonicity, ``+Inf``≡count, EOF) used by the
round-trip tests — rendering bugs fail a test, not the operator's
scraper at 3am.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["to_openmetrics", "parse_openmetrics", "ObsExporter",
           "escape_label_value", "CONTENT_TYPE"]

CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _metric_name(name: str) -> str:
    name = _NAME_BAD.sub("_", str(name))
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def escape_label_value(v: str) -> str:
    """OpenMetrics label-value escaping: backslash, double-quote and
    newline — in THAT order (escaping the escapes first, or a value
    ending in a backslash swallows its closing quote)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _unescape_label_value(v: str) -> str:
    out, i = [], 0
    while i < len(v):
        c = v[i]
        if c == "\\":
            if i + 1 >= len(v):
                raise ValueError("dangling escape in label value")
            nxt = v[i + 1]
            if nxt == "\\":
                out.append("\\")
            elif nxt == '"':
                out.append('"')
            elif nxt == "n":
                out.append("\n")
            else:
                raise ValueError(f"invalid escape \\{nxt} in label value")
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _labels_text(labels: Dict[str, Any],
                 extra: Optional[Tuple[str, str]] = None) -> str:
    items = [(str(k), str(v)) for k, v in sorted(labels.items())]
    if extra is not None:
        items.append(extra)
    if not items:
        return ""
    inner = ",".join(f'{_metric_name(k)}="{escape_label_value(v)}"'
                     for k, v in items)
    return "{" + inner + "}"


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def to_openmetrics(snapshot: Dict[str, Any]) -> str:
    """Render a registry/job snapshot dict as OpenMetrics text.
    Counters emit ``<fam>_total``; histograms emit cumulative
    ``_bucket{le=...}`` + ``_count`` + ``_sum``; gauges emit the last
    value (the merged-job ``max``/``ewma`` views stay JSON-only).
    Series flagged ``bounds_conflict`` by the merge are skipped — a
    known-corrupt percentile must not reach a scraper as data."""
    lines: List[str] = []
    for name in sorted(snapshot.get("metrics", {})):
        fam = snapshot["metrics"][name]
        kind = fam.get("type", "gauge")
        mname = _metric_name(name)
        if kind == "counter":
            # a family already named *_total keeps one suffix, not two
            base = mname[:-6] if mname.endswith("_total") else mname
            lines.append(f"# TYPE {base} counter")
            for s in fam.get("series", []):
                lines.append(f"{base}_total{_labels_text(s['labels'])} "
                             f"{_fmt(s.get('value', 0))}")
        elif kind == "histogram":
            lines.append(f"# TYPE {mname} histogram")
            for s in fam.get("series", []):
                if s.get("bounds_conflict") or "buckets" not in s:
                    continue
                cum = 0
                for b, n in zip(list(s.get("bounds", [])) + ["+Inf"],
                                s["buckets"]):
                    cum += int(n)
                    le = "+Inf" if b == "+Inf" else _fmt(b)
                    lines.append(
                        f"{mname}_bucket"
                        f"{_labels_text(s['labels'], ('le', le))} {cum}")
                lines.append(f"{mname}_count{_labels_text(s['labels'])} "
                             f"{int(s.get('count', cum))}")
                lines.append(f"{mname}_sum{_labels_text(s['labels'])} "
                             f"{_fmt(s.get('sum', 0.0))}")
        else:
            lines.append(f"# TYPE {mname} gauge")
            for s in fam.get("series", []):
                lines.append(f"{mname}{_labels_text(s['labels'])} "
                             f"{_fmt(s.get('value', 0.0))}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r" (?P<value>[^ ]+)(?: (?P<ts>[^ ]+))?$")


def _parse_labels(text: str) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    i = 0
    while i < len(text):
        eq = text.index("=", i)
        lname = text[i:eq]
        if not _LABEL_NAME_RE.match(lname):
            raise ValueError(f"bad label name {lname!r}")
        if eq + 1 >= len(text) or text[eq + 1] != '"':
            raise ValueError(f"label {lname!r} value not quoted")
        j = eq + 2
        raw = []
        while True:
            if j >= len(text):
                raise ValueError(f"label {lname!r} value not terminated")
            c = text[j]
            if c == "\\":
                raw.append(text[j:j + 2])
                j += 2
                continue
            if c == '"':
                break
            raw.append(c)
            j += 1
        labels[lname] = _unescape_label_value("".join(raw))
        i = j + 1
        if i < len(text):
            if text[i] != ",":
                raise ValueError(f"expected ',' after label {lname!r}")
            i += 1
    return labels


def parse_openmetrics(text: str) -> Dict[str, Dict[str, Any]]:
    """Strict parse of OpenMetrics text → {family: {"type", "samples":
    [(name, labels, value)]}}. Raises ValueError on: missing ``# EOF``
    terminator, samples before any TYPE / under the wrong family,
    malformed names/labels/escapes/values, non-monotonic histogram
    buckets, or a ``+Inf`` bucket disagreeing with ``_count``."""
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    if not lines or lines[-1].strip() != "# EOF":
        raise ValueError("missing # EOF terminator")
    fams: Dict[str, Dict[str, Any]] = {}
    current: Optional[str] = None
    for ln in lines[:-1]:
        if not ln.strip():
            raise ValueError("blank line inside exposition")
        if ln.startswith("#"):
            parts = ln.split(" ")
            if len(parts) >= 4 and parts[1] == "TYPE":
                fam, kind = parts[2], parts[3]
                if not _NAME_RE.match(fam):
                    raise ValueError(f"bad family name {fam!r}")
                if kind not in ("counter", "gauge", "histogram",
                                "summary", "unknown", "info"):
                    raise ValueError(f"bad family type {kind!r}")
                if fam in fams:
                    raise ValueError(f"duplicate TYPE for {fam!r}")
                fams[fam] = {"type": kind, "samples": []}
                current = fam
            continue  # HELP/UNIT/comments: tolerated
        m = _SAMPLE_RE.match(ln)
        if m is None:
            raise ValueError(f"malformed sample line {ln!r}")
        name = m.group("name")
        labels = _parse_labels(m.group("labels") or "")
        try:
            value = float(m.group("value"))
        except ValueError:
            raise ValueError(f"bad sample value in {ln!r}")
        if current is None:
            raise ValueError(f"sample {name!r} before any # TYPE")
        kind = fams[current]["type"]
        ok_suffixes = {"counter": ("_total", "_created"),
                       "histogram": ("_bucket", "_count", "_sum",
                                     "_created"),
                       "summary": ("_count", "_sum", ""),
                       }.get(kind, ("",))
        if not any(name == current + sfx for sfx in ok_suffixes):
            raise ValueError(
                f"sample {name!r} does not belong to family "
                f"{current!r} ({kind})")
        if name == current + "_bucket" and "le" not in labels:
            raise ValueError(f"histogram bucket without le label: {ln!r}")
        fams[current]["samples"].append((name, labels, value))
    # histogram consistency: cumulative buckets non-decreasing and the
    # +Inf bucket equal to _count, per label-set
    for fam, rec in fams.items():
        if rec["type"] != "histogram":
            continue
        by_key: Dict[Tuple, Dict[str, Any]] = {}
        for name, labels, value in rec["samples"]:
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            st = by_key.setdefault(key, {"buckets": [], "count": None})
            if name == fam + "_bucket":
                st["buckets"].append((labels["le"], value))
            elif name == fam + "_count":
                st["count"] = value
        for key, st in by_key.items():
            prev = -1.0
            inf = None
            for le, v in st["buckets"]:
                if v < prev:
                    raise ValueError(
                        f"{fam}{dict(key)}: bucket counts not cumulative")
                prev = v
                if le == "+Inf":
                    inf = v
            if st["buckets"] and inf is None:
                raise ValueError(f"{fam}{dict(key)}: no +Inf bucket")
            if inf is not None and st["count"] is not None \
                    and inf != st["count"]:
                raise ValueError(
                    f"{fam}{dict(key)}: +Inf bucket {inf} != "
                    f"count {st['count']}")
    return fams


class ObsExporter:
    """The per-trainer HTTP endpoint. ``snapshot_fn`` returns the
    current (job-merged) snapshot — pass ``collector.latest`` so a
    scrape costs a dict render, not an RPC fan-out; ``ring`` and
    ``alerts_fn`` back the history/alerts endpoints. ``port=0`` binds
    an ephemeral port (read ``.port``/``.url`` after start)."""

    def __init__(self, snapshot_fn: Callable[[], Dict[str, Any]],
                 ring=None,
                 alerts_fn: Optional[Callable[[], List[Dict[str, Any]]]]
                 = None,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self._snapshot_fn = snapshot_fn
        self._ring = ring
        self._alerts_fn = alerts_fn
        self._host = host
        self._want_port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.scrapes = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ObsExporter":
        if self._httpd is not None:
            return self
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet: scrapes are not events
                pass

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                exporter.scrapes += 1
                try:
                    path = self.path.split("?", 1)[0]
                    if path in ("/metrics", "/"):
                        body = to_openmetrics(
                            exporter._snapshot_fn()).encode()
                        self._send(200, body, CONTENT_TYPE)
                    elif path == "/snapshot.json":
                        self._send(200, json.dumps(
                            exporter._snapshot_fn()).encode())
                    elif path == "/history.json":
                        recs = (exporter._ring.records()
                                if exporter._ring is not None else [])
                        self._send(200, json.dumps(
                            {"records": recs}).encode())
                    elif path == "/alerts.json":
                        alerts = (exporter._alerts_fn()
                                  if exporter._alerts_fn is not None else [])
                        self._send(200, json.dumps(
                            {"alerts": alerts}).encode())
                    elif path == "/healthz":
                        self._send(200, b'{"ok": true}')
                    else:
                        self._send(404, b'{"error": "not found"}')
                except Exception as e:  # noqa: BLE001 — scrape, not process
                    self._send(500, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode())

            def _read_only(self):
                self._send(405, b'{"error": "exporter is read-only"}')

            do_POST = do_PUT = do_DELETE = do_PATCH = _read_only

        self._httpd = ThreadingHTTPServer((self._host, self._want_port),
                                          Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="obs-exporter")
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else 0

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    def __enter__(self) -> "ObsExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
