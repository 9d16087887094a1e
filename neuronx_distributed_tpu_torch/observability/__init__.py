"""Host-side observability of the serving engine: the structured tracer
(per-request timelines, Chrome/Perfetto export) and the Prometheus-style
metrics registry, the port's own copies of the JAX package's. Stdlib only;
a disabled tracer costs one attribute check a call site.

The analysis layer on top of them in the JAX package (attribution, SLOs,
the incident recorder) is still to port (ROADMAP A8.8).
"""

from neuronx_distributed_tpu_torch.observability.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    parse_prometheus,
)
from neuronx_distributed_tpu_torch.observability.tracer import (
    Tracer,
    interblock_gaps,
    validate_chrome_trace,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "parse_prometheus",
    "Tracer",
    "interblock_gaps",
    "validate_chrome_trace",
]
