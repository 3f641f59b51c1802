"""paddle_tpu_torch.server — the deployable serving service over the
engine.

A copy of `paddle_tpu/server/` (pure Python) over the port's engine.
`paddle_tpu_torch.serving` is a continuous-batching library (paged KV
arena, fused chunked decode, overlapped pipeline, host-swap preemption,
migration); this package is the wire around it — the reference's
deployable inference surface (`paddle_inference_api.h` + the
multi-trainer/DeviceWorker saturation story) rebuilt as a service
plane:

* `service` — stdlib HTTP/1.1 frontend (`ThreadingHTTPServer`, the
  debug_server idiom): `POST /v1/generate` streams tokens out as SSE
  (client disconnect cancels the request so its KV pages free),
  `GET /healthz` readiness with per-replica gauges, `GET /metrics`
  the shared Prometheus registry. Overload and quota exhaustion map
  to 429 + Retry-After (queue-wait-p50-derived), drain to 503 — never
  an exception escaping a handler thread.
* `router` — front tier over N `ServingEngine` replicas: least-loaded
  admission off the live EngineMetrics gauges, per-tenant token-bucket
  quotas, per-request deadlines that cancel in-flight work, graceful
  drain, and one driver thread per replica. Shed storms fire the
  watchdog overload hook so they leave flight records. Per-tenant
  `SLOConfig` objectives (TTFT/TPOT/e2e, wired like quotas) are scored
  at stream close into `server_slo_{met,missed}_total` + goodput
  counters; `GET /slozv` serves the cross-replica per-tenant
  attainment breakdown.

Quick start:

    import paddle_tpu_torch as ptt
    server = ptt.server.serve(params, gpt_cfg,
                              ptt.server.ServerConfig(replicas=2))
    # curl -N -X POST :{server.port}/v1/generate \
    #      -d '{"prompt": [5, 7, 11], "max_new_tokens": 32}'
    server.shutdown()          # drain, then refcounted engine close()
"""

from .router import (AdapterConfig, DrainingError, QuotaConfig,
                     QuotaExceededError, RebalanceConfig, Router,
                     RouterMetrics, SLOConfig, StreamHandle, TokenBucket)
from .service import GenerationServer, ServerConfig, serve

__all__ = ["GenerationServer", "ServerConfig", "serve", "Router",
           "StreamHandle", "TokenBucket", "QuotaConfig",
           "QuotaExceededError", "DrainingError", "RouterMetrics",
           "SLOConfig", "RebalanceConfig", "AdapterConfig"]
