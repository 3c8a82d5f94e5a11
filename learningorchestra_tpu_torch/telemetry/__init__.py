"""Process-wide telemetry: a metrics registry and span-based tracing.

Counterpart of ``learningorchestra_tpu/telemetry/`` (its ``metrics`` and
``tracing`` modules, copied). Spans are no-ops outside an active trace,
so instrumented library code costs nothing outside a request; the REST
middleware that mints correlation IDs, the flight recorder and the
cross-process stitcher come with later slices.
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
