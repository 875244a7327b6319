"""Observability plane of the port: the metrics registry, trace spans, the
job-wide aggregation, the time-series ring, the SLO watchdog, the
OpenMetrics exporter and the crash flight recorder.

The port's own copies of ``paddle_tpu.obs``'s seven legs:

- ``registry`` — pre-bound counter/gauge/histogram handles, bounded label
  cardinality, a JSON snapshot;
- ``trace`` — sampled spans whose compact context rides the PS RPC frame
  header;
- ``aggregate`` — the merge of per-process snapshots, and the PS shards'
  ``kObsSnap`` answer (server wire counters and server spans stitched
  into the client's chrome trace);
- ``timeseries`` — the always-on sampler: periodic snapshots into a
  bounded delta-compressed ring (counters as rates, gauges as last,
  histograms as bucket deltas); ``JobCollector`` fans a tick out over
  ``kObsSnap`` so one ring holds the whole job's curves;
- ``exporter`` — a stdlib read-only HTTP endpoint serving OpenMetrics
  text and JSON history;
- ``slo`` — declarative SLO rules with multi-window burn-rate evaluation;
- ``flightrec`` — the crash flight recorder.
"""

from . import aggregate, flightrec, registry, slo, timeseries, trace
from .flightrec import FlightRecorder
from .registry import (REGISTRY, CounterGroup, Registry, counter, gauge,
                       histogram, metrics_enabled, snapshot)
from .slo import Alert, SloRule, SloWatchdog, default_rules
from .timeseries import JobCollector, MetricRing, Sampler
from .trace import (current_span, mark_retried, span, start_tracing,
                    stop_tracing, tracing_enabled, wire_context)

# the exporter stays LAZY (PEP 562): it drags in http.server, which every
# PS shard, communicator and test process importing ps.rpc (and therefore
# obs) would otherwise pay at startup without ever serving
_LAZY_EXPORTER = {"exporter", "ObsExporter", "to_openmetrics",
                  "parse_openmetrics"}


def __getattr__(name):
    if name in _LAZY_EXPORTER:
        # importlib, not `from . import`: the fromlist probe re-enters
        # this __getattr__ before the submodule lands (recursion)
        import importlib

        _exporter = importlib.import_module(".exporter", __name__)
        return _exporter if name == "exporter" else getattr(_exporter, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "registry", "trace", "aggregate", "timeseries", "exporter", "slo",
    "flightrec",
    "Registry", "REGISTRY", "CounterGroup",
    "counter", "gauge", "histogram", "snapshot", "metrics_enabled",
    "span", "start_tracing", "stop_tracing", "tracing_enabled",
    "wire_context", "current_span", "mark_retried",
    "MetricRing", "Sampler", "JobCollector",
    "ObsExporter", "to_openmetrics", "parse_openmetrics",
    "SloRule", "SloWatchdog", "Alert", "default_rules",
    "FlightRecorder",
]
