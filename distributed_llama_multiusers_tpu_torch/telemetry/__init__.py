"""Request-lifecycle tracing and metrics for the serving path.

The port's copy of the JAX package's ``telemetry/`` (pure stdlib there and
here). Three layers:

- **spans.py / trace.py** — per-request lifecycle spans and per-dispatch
  step slices in a bounded host-side ring, exported as Chrome trace-event
  JSON (Perfetto / chrome://tracing loadable): lanes as tracks,
  fused/pipelined steps as slices, admissions/finishes/flushes as
  instants. No syncs in the pipelined dispatch half: slices are stamped at
  consume time, one step behind; monotonic clocks only.
- **metrics.py** — counters, gauges and fixed-bucket log-scale histograms
  (TTFT, inter-token gap, queue wait, step duration) with Prometheus text
  exposition, served at ``GET /metrics`` and bridged from the same
  ``/stats`` snapshot so the two endpoints reconcile.
- **logs.py** — one structured JSON line per request (the summary also
  attached to completion responses) plus startup config lines.

Entry points: ``Telemetry`` (the hub the scheduler and the HTTP server
share), ``GET /metrics`` / ``GET /trace`` (server/http.py) and
``--trace-path`` (dumped on drain).
"""

from .hub import Telemetry
from .logs import JsonLogger, default_logger, log_event
from .metrics import (
    LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    log_buckets,
)
from .spans import RequestTrace, SpanEvent, SpanTracer
from .trace import chrome_trace, dump_chrome_trace, tracer_chrome_trace
from .tracectx import TRACE_HEADER, TraceContext, trace_id_of

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "JsonLogger",
    "LATENCY_BUCKETS_S",
    "MetricsRegistry",
    "RequestTrace",
    "SpanEvent",
    "SpanTracer",
    "TRACE_HEADER",
    "Telemetry",
    "TraceContext",
    "chrome_trace",
    "default_logger",
    "dump_chrome_trace",
    "log_buckets",
    "log_event",
    "trace_id_of",
    "tracer_chrome_trace",
]
