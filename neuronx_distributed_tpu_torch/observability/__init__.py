"""Host-side observability of the serving engine: the structured tracer
(per-request timelines, Chrome/Perfetto export) and the Prometheus-style
metrics registry, and the analysis layer on top of them — per-request
critical-path attribution (``attribution``), declarative SLOs with
multi-window burn-rate alerting (``slo``) and the incident flight recorder
(``incident``). The port's own copies of the JAX package's modules, stdlib
and numpy only; a disabled tracer costs one attribute check a call site,
and an engine without objectives or an incident directory builds neither
monitor nor recorder.
"""

from neuronx_distributed_tpu_torch.observability.attribution import (
    PHASES,
    attribution_report,
    explain_deadline_miss,
    request_attribution,
)
from neuronx_distributed_tpu_torch.observability.incident import (
    INCIDENT_KINDS,
    FlightRecorder,
    validate_incident_bundle,
)
from neuronx_distributed_tpu_torch.observability.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    parse_prometheus,
)
from neuronx_distributed_tpu_torch.observability.slo import (
    DEFAULT_RULES,
    BurnRule,
    SLObjective,
    SLOMonitor,
    default_slos,
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
    "PHASES",
    "request_attribution",
    "attribution_report",
    "explain_deadline_miss",
    "SLObjective",
    "BurnRule",
    "SLOMonitor",
    "DEFAULT_RULES",
    "default_slos",
    "FlightRecorder",
    "INCIDENT_KINDS",
    "validate_incident_bundle",
]
