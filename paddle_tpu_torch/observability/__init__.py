"""paddle_tpu_torch.observability: span tracer and metrics registry.

Copies of `paddle_tpu/observability/{tracer,metrics}.py` (pure Python).
The executor records one `executor/run` span per run (and one span per
op while tracing is on) plus the `executor_runs_total` /
`executor_inflight_runs` heartbeat series; `Predictor.run` records an
`inference/predict` span.
"""

from .metrics import get_registry, MetricsRegistry  # noqa: F401
from .tracer import (trace_span, enable_tracing, disable_tracing,  # noqa: F401
                     tracing_enabled, get_tracer)

__all__ = ["get_registry", "MetricsRegistry", "trace_span",
           "enable_tracing", "disable_tracing", "tracing_enabled",
           "get_tracer"]
