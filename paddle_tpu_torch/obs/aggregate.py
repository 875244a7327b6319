"""Job-wide aggregation: merge per-process registry snapshots and
stitch client + server spans into one chrome trace.

The port's own copy of ``paddle_tpu.obs.aggregate``. Two sources feed the
job view:

- **Python processes** (trainer, serving frontend, …) export
  ``registry.snapshot()`` dicts (or JSON files of them).
- **PS shards** answer the ``kObsSnap`` RPC (csrc/ps_service.cc) with
  their per-table wire counters and server-side spans;
  :func:`fetch_server_obs` turns one shard's answer into the same
  snapshot shape (role ``ps_shard_<i>``) plus a span list, so a C++
  shard aggregates exactly like a Python process.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .trace import SERVER_SPAN_STRUCT, SERVER_WIRE_STRUCT

__all__ = ["merge_snapshots", "fetch_server_obs", "server_spans_to_chrome",
           "job_snapshot"]


def _merge_series(kind: str, dst: Dict[str, Any], src: Dict[str, Any]
                  ) -> None:
    if kind == "histogram":
        if not dst.get("bounds"):
            dst.update({k: src[k] for k in ("bounds",)})
            dst.setdefault("buckets", [0] * len(src["buckets"]))
        if dst.get("bounds") != src.get("bounds"):
            # two processes registered this family with DIFFERENT
            # bucket ladders: merging count/sum while skipping the
            # buckets would leave sum(buckets) != count and silently
            # corrupt any percentile read off the merged series — keep
            # the first ladder's data intact and mark the conflict
            dst["bounds_conflict"] = True
            return
        dst["count"] = dst.get("count", 0) + src["count"]
        dst["sum"] = dst.get("sum", 0.0) + src["sum"]
        dst["buckets"] = [a + b for a, b in
                          zip(dst["buckets"], src["buckets"])]
    elif kind == "counter":
        dst["value"] = dst.get("value", 0) + src["value"]
    else:  # gauge: keep the latest writer's value, max as a second view
        dst["value"] = src["value"]
        if "ewma" in src:
            dst["ewma"] = src["ewma"]
        dst["max"] = max(dst.get("max", float("-inf")), src["value"])


def merge_snapshots(snaps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """N per-process snapshots → ONE job view: counters/histograms sum
    across processes per (family, labels); gauges keep last + max. The
    result lists every contributing process under ``processes`` (a
    trainer and two PS shards list three)."""
    merged: Dict[str, Any] = {}
    procs: List[Dict[str, Any]] = []
    for snap in snaps:
        procs.append(dict(snap.get("process", {})))
        for name, fam in snap.get("metrics", {}).items():
            m = merged.setdefault(name, {"type": fam["type"], "series": {},
                                         "dropped_series": 0})
            m["dropped_series"] += fam.get("dropped_series", 0)
            for s in fam["series"]:
                key = tuple(sorted(s["labels"].items()))
                dst = m["series"].setdefault(key, {"labels": s["labels"]})
                _merge_series(fam["type"], dst, s)
    return {
        "processes": procs,
        "metrics": {name: {"type": m["type"],
                           "dropped_series": m["dropped_series"],
                           "series": list(m["series"].values())}
                    for name, m in merged.items()},
    }


# ---------------------------------------------------------------------------
# PS shard side (kObsSnap)
# ---------------------------------------------------------------------------

def fetch_server_obs(client, server: int, drain: bool = True,
                     retries: Optional[int] = None
                     ) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """One shard's observability state via kObsSnap, addressed to
    ``server`` (no failover replay — a promoted replacement's counters
    are NOT the dead shard's). Returns ``(snapshot, spans)``:
    ``snapshot`` in registry-snapshot shape (families
    ``ps_server_wire_bytes`` / ``ps_server_wire_rows`` /
    ``ps_server_requests`` labeled by table and direction), ``spans``
    as dicts {trace_id, span_id, cmd, table_id, ts_us, dur_us,
    gate_us, req_bytes, resp_bytes}. ``drain`` pops the span buffer
    (wire counters always persist). ``retries=0`` fails fast — the
    continuous sampler passes it so a dead shard costs one tick, not
    the transport's full retry budget per tick. A span's ``ts_us`` is
    the server's wall clock in microseconds, as C++ stamped it."""
    from ..ps.rpc import _OBS_SNAP  # lazy: rpc imports obs at module load

    kw = {} if retries is None else {"retries": retries}
    _, resp = client._direct(
        server, lambda c: c.check(_OBS_SNAP, aux=1 if drain else 0, **kw))
    buf = bytes(resp)
    n_tables, n_spans, spans_dropped = np.frombuffer(
        buf[:16], dtype=np.dtype([("t", "<u4"), ("s", "<u4"),
                                  ("d", "<i8")]))[0]
    off = 16
    wires = []
    for _ in range(int(n_tables)):
        tid, _pad, in_b, out_b, in_r, out_r, reqs = \
            SERVER_WIRE_STRUCT.unpack_from(buf, off)
        off += SERVER_WIRE_STRUCT.size
        wires.append((tid, in_b, out_b, in_r, out_r, reqs))
    spans = []
    for _ in range(int(n_spans)):
        (trace_id, span_id, cmd, tid, ts_us, dur_us, gate_us,
         req_b, resp_b) = SERVER_SPAN_STRUCT.unpack_from(buf, off)
        off += SERVER_SPAN_STRUCT.size
        spans.append({"trace_id": trace_id, "span_id": span_id,
                      "cmd": cmd, "table_id": tid, "ts_us": ts_us,
                      "dur_us": dur_us, "gate_us": gate_us,
                      "req_bytes": req_b, "resp_bytes": resp_b})
    bytes_series, rows_series, req_series = [], [], []
    # the shard label keeps distinct shards' cumulative counters from
    # ALIASING onto one merged series: without it, one shard missing a
    # collector tick (dead mid-failover) makes the merged value DROP,
    # which the time-series ring reads as a counter restart and
    # re-adds the shard's whole history as one tick's delta when it
    # returns — a spurious spike exactly in the incident window
    for tid, in_b, out_b, in_r, out_r, reqs in wires:
        t = str(tid)
        sh = str(server)
        bytes_series.append({"labels": {"table": t, "dir": "in",
                                        "shard": sh}, "value": in_b})
        bytes_series.append({"labels": {"table": t, "dir": "out",
                                        "shard": sh}, "value": out_b})
        rows_series.append({"labels": {"table": t, "dir": "in",
                                       "shard": sh}, "value": in_r})
        rows_series.append({"labels": {"table": t, "dir": "out",
                                       "shard": sh}, "value": out_r})
        req_series.append({"labels": {"table": t, "shard": sh},
                           "value": reqs})
    snap = {
        "process": {"role": f"ps_shard_{server}",
                    "endpoint": getattr(client._conns[server], "endpoint",
                                        str(server)),
                    "spans_dropped": int(spans_dropped)},
        "metrics": {
            "ps_server_wire_bytes": {"type": "counter",
                                     "series": bytes_series,
                                     "dropped_series": 0},
            "ps_server_wire_rows": {"type": "counter",
                                    "series": rows_series,
                                    "dropped_series": 0},
            "ps_server_requests": {"type": "counter",
                                   "series": req_series,
                                   "dropped_series": 0},
        },
    }
    return snap, spans


_CMD_NAMES = {3: "pull_sparse", 4: "push_sparse", 5: "pull_dense",
              6: "push_dense", 12: "insert_full", 13: "export",
              17: "global_step", 21: "save_all", 34: "load_cold"}


def server_spans_to_chrome(spans: List[Dict[str, Any]], pid: int,
                           process_name: str) -> List[Dict[str, Any]]:
    """Server-side span records → chrome events. Each gets an "X"
    complete event and an "f" FLOW FINISH keyed by the CLIENT span id
    it served (the wire context), binding to the client span's "s"
    start — the cross-process arrow in the merged timeline. The gate
    (queue) wait renders as a nested slice so time-in-lock is visible
    without opening args."""
    events: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": pid,
         "args": {"name": process_name}}]
    for s in spans:
        name = f"ps_server_{_CMD_NAMES.get(s['cmd'], 'cmd%d' % s['cmd'])}"
        ev = {"name": name, "cat": "server", "ph": "X", "ts": s["ts_us"],
              "dur": max(s["dur_us"], 1), "pid": pid, "tid": 0,
              "args": {"trace_id": f"{s['trace_id']:x}",
                       "span_id": f"{s['span_id']:x}",
                       "table": s["table_id"],
                       "req_bytes": s["req_bytes"],
                       "resp_bytes": s["resp_bytes"],
                       "gate_us": s["gate_us"]}}
        events.append(ev)
        if s["gate_us"] > 0:
            events.append({"name": "gate_wait", "cat": "server", "ph": "X",
                           "ts": s["ts_us"], "dur": s["gate_us"],
                           "pid": pid, "tid": 0})
        events.append({"name": "ps_rpc", "cat": "rpc_flow", "ph": "f",
                       "bp": "e", "id": s["span_id"],
                       "ts": s["ts_us"] + max(s["dur_us"], 1) // 2,
                       "pid": pid, "tid": 0})
    return events


def job_snapshot(client=None, extra: Optional[List[Dict[str, Any]]] = None,
                 drain: bool = False) -> Dict[str, Any]:
    """Convenience: this process's registry snapshot + every PS shard's
    kObsSnap (when ``client`` is an RpcPsClient) + ``extra`` snapshots,
    merged. The one call a driver needs for the job-wide view."""
    from . import registry

    snaps = [registry.snapshot()]
    if client is not None:
        for s in range(client.num_servers):
            snap, _ = fetch_server_obs(client, s, drain=drain)
            snaps.append(snap)
    snaps.extend(extra or [])
    return merge_snapshots(snaps)
