"""paddle_tpu_torch.observability: span tracer, metrics registry, trace
export, the serving request log and the stall watchdog.

Copies of `paddle_tpu/observability/{tracer,metrics,export,request_log,
watchdog}.py` (pure Python). The executor records one `executor/run`
span per run (and one span per op while tracing is on) plus the
`executor_runs_total` / `executor_inflight_runs` heartbeat series;
`Predictor.run` records an `inference/predict` span; the serving engine
publishes its `serving_*` series here, journals request transitions into
an installed `RequestLog`, and calls the watchdog's overload hook when it
sheds. The debug HTTP server, the alert engine, the time-series store
and the training telemetry plane are not ported yet.
"""

from . import export, metrics, request_log, tracer, watchdog  # noqa: F401
from .export import export_chrome_trace, self_times, summarize
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry)
from .request_log import (RequestLog, get_request_log,
                          install_request_log, request_logging,
                          uninstall_request_log)
from .tracer import (Span, Tracer, current_request_id, disable_tracing,
                     enable_tracing, get_tracer, request_scope, trace_span,
                     tracing_enabled)
from .watchdog import (FlightRecorder, ProgressMonitor, Watchdog,
                       dump_flight_record, format_all_stacks, get_watchdog,
                       start_watchdog, stop_watchdog)

__all__ = [
    "Span", "Tracer", "get_tracer", "trace_span", "enable_tracing",
    "disable_tracing", "tracing_enabled", "request_scope",
    "current_request_id",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "export_chrome_trace", "self_times", "summarize",
    "Watchdog", "FlightRecorder", "ProgressMonitor", "start_watchdog",
    "stop_watchdog", "get_watchdog", "dump_flight_record",
    "format_all_stacks",
    "RequestLog", "install_request_log", "uninstall_request_log",
    "get_request_log", "request_logging",
]
