"""Observability plane of the port: the metrics registry, trace spans and
the crash flight recorder.

The port's own copies of ``paddle_tpu.obs.registry``, ``obs.trace`` and
``obs.flightrec``. The JAX package's other legs — ``aggregate`` (the
job-wide merge and the server-span wire), ``timeseries``, ``exporter``
and ``slo`` — are not ported (ROADMAP Queue A item 10); nothing here
names them.
"""

from . import flightrec, registry, trace
from .flightrec import FlightRecorder
from .registry import (REGISTRY, CounterGroup, Registry, counter, gauge,
                       histogram, metrics_enabled, snapshot)
from .trace import (current_span, mark_retried, span, start_tracing,
                    stop_tracing, tracing_enabled, wire_context)

__all__ = [
    "registry", "trace", "flightrec",
    "Registry", "REGISTRY", "CounterGroup",
    "counter", "gauge", "histogram", "snapshot", "metrics_enabled",
    "span", "start_tracing", "stop_tracing", "tracing_enabled",
    "wire_context", "current_span", "mark_retried",
    "FlightRecorder",
]
