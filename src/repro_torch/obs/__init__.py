"""Observability: device-resident convergence traces, named fit phases
with a span tree, and serving metrics.

- ``obs.trace``   -- ``ConvTrace``, a device ring the solver loops record a
  sample an iteration into (inside their CUDA graphs); fetched once at
  fit exit.
- ``obs.spans``   -- ``span(name)``: a ``torch.profiler`` label, a
  ``SpanTimer``'s per-name totals and a ``SpanTracer``'s tree of
  wall-clock spans, exported as Chrome trace JSON.
- ``obs.metrics`` -- streaming log-bucket latency histograms and labeled
  counters with Prometheus-text and JSON exposition for serving.
"""
from repro_torch.obs.metrics import (Counter, Gauge,  # noqa: F401
                                     LatencyHistogram, MetricsRegistry)
from repro_torch.obs.spans import SpanTimer, SpanTracer, span  # noqa: F401
from repro_torch.obs.trace import (TRACE_COLS, ConvTrace,  # noqa: F401
                                   trace_fetch, trace_init, trace_record,
                                   trace_summary)
