"""Observability plane of the port: the metrics registry, trace spans, the
job-wide aggregation and the crash flight recorder.

The port's own copies of ``paddle_tpu.obs.registry``, ``obs.trace``,
``obs.aggregate`` (the merge of per-process snapshots, and the PS shards'
``kObsSnap`` answer: server wire counters and server spans stitched into
the client's chrome trace) and ``obs.flightrec``. The JAX package's other
legs — ``timeseries``, ``exporter`` and ``slo`` — are not ported (ROADMAP
Queue A item 10); nothing here names them.
"""

from . import aggregate, flightrec, registry, trace
from .flightrec import FlightRecorder
from .registry import (REGISTRY, CounterGroup, Registry, counter, gauge,
                       histogram, metrics_enabled, snapshot)
from .trace import (current_span, mark_retried, span, start_tracing,
                    stop_tracing, tracing_enabled, wire_context)

__all__ = [
    "registry", "trace", "aggregate", "flightrec",
    "Registry", "REGISTRY", "CounterGroup",
    "counter", "gauge", "histogram", "snapshot", "metrics_enabled",
    "span", "start_tracing", "stop_tracing", "tracing_enabled",
    "wire_context", "current_span", "mark_retried",
    "FlightRecorder",
]
