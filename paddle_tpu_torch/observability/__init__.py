"""paddle_tpu_torch.observability: span tracer, metrics registry, trace
export, the serving request log, the stall watchdog, the debug HTTP
server, the time-series store, the alert engine and the training step
logger.

Copies of `paddle_tpu/observability/{tracer,metrics,export,request_log,
watchdog,debug_server,timeseries,alerts,train_stats}.py` (pure Python).
The executor records one `executor/run` span per run (and one span per
op while tracing is on) plus the `executor_runs_total` /
`executor_inflight_runs` heartbeat series; `Predictor.run` records an
`inference/predict` span; the serving engine publishes its `serving_*`
series here, journals request transitions into an installed
`RequestLog`, calls the watchdog's overload hook when it sheds, and
registers its /tickz + /compilez providers with the debug server; the
server's router samples the registry into a `TimeSeriesStore` and
evaluates the alert rules over it (`FleetHealth`). The executor does not
feed the step logger yet (ROADMAP A.3).

    import paddle_tpu_torch as ptt
    port = ptt.observability.start_debug_server()   # curl :port/metrics
"""

from . import (alerts, debug_server, export, metrics,  # noqa: F401
               request_log, timeseries, tracer, train_stats, watchdog)
from .alerts import (AlertEngine, AlertRule, FleetHealth, HealthConfig,
                     builtin_rules)
from .debug_server import (DebugServer, acquire_debug_server,
                           get_debug_server, release_debug_server,
                           start_debug_server, stop_debug_server)
from .export import export_chrome_trace, self_times, summarize
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry)
from .request_log import (RequestLog, get_request_log,
                          install_request_log, request_logging,
                          uninstall_request_log)
from .tracer import (Span, Tracer, current_request_id, disable_tracing,
                     enable_tracing, get_tracer, request_scope, trace_span,
                     tracing_enabled)
from .timeseries import Sampler, TimeSeriesStore
from .train_stats import (StepLogger, attach_step_telemetry,
                          get_step_logger, install_step_logger,
                          recompile_log, step_logging,
                          uninstall_step_logger)
from .watchdog import (FlightRecorder, ProgressMonitor, Watchdog,
                       dump_flight_record, format_all_stacks, get_watchdog,
                       notify_alert, start_watchdog, stop_watchdog)

__all__ = [
    "Span", "Tracer", "get_tracer", "trace_span", "enable_tracing",
    "disable_tracing", "tracing_enabled", "request_scope",
    "current_request_id",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "export_chrome_trace", "self_times", "summarize",
    "DebugServer", "start_debug_server", "stop_debug_server",
    "get_debug_server", "acquire_debug_server", "release_debug_server",
    "Watchdog", "FlightRecorder", "ProgressMonitor", "start_watchdog",
    "stop_watchdog", "get_watchdog", "dump_flight_record",
    "format_all_stacks",
    "StepLogger", "install_step_logger", "uninstall_step_logger",
    "get_step_logger", "step_logging", "attach_step_telemetry",
    "recompile_log",
    "RequestLog", "install_request_log", "uninstall_request_log",
    "get_request_log", "request_logging",
    "TimeSeriesStore", "Sampler",
    "AlertRule", "AlertEngine", "FleetHealth", "HealthConfig",
    "builtin_rules", "notify_alert",
]
