"""Process-wide telemetry: a metrics registry and span-based tracing.

Counterpart of ``learningorchestra_tpu/telemetry/``, its exports less the
XLA compile-cache collector: ``metrics`` and ``tracing`` (spans are
no-ops outside an active trace, so instrumented library code costs
nothing outside a request), ``profile`` (the flight recorder: byte
flows of the card's copies and the store wire, Chrome traces, the
sampling profiler), ``stitch`` (one trace across the services'
processes), ``tsdb`` (the ``__lo_metrics__`` ring and its rollups) and
``slo`` (rules over the ring, ``/health``'s ``degraded``).
"""

from learningorchestra_tpu_torch.telemetry.metrics import (
    MetricsRegistry,
    global_registry,
    register_store,
)
from learningorchestra_tpu_torch.telemetry.tracing import (
    Span,
    Trace,
    activate,
    add_attr,
    annotate,
    attach,
    capture,
    current_correlation_id,
    current_trace,
    mint_correlation_id,
    record_span,
    span,
)

__all__ = [
    "MetricsRegistry",
    "Span",
    "Trace",
    "activate",
    "add_attr",
    "annotate",
    "attach",
    "capture",
    "current_correlation_id",
    "current_trace",
    "global_registry",
    "mint_correlation_id",
    "record_span",
    "register_store",
    "span",
]
