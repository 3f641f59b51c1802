"""paddle_tpu_torch.serving — continuous-batching inference above the
executor.

Port of `paddle_tpu/serving/`: a paged KV block arena + page tables with
hashed prefix sharing (`kv_cache`), an iteration-level scheduler that
admits by pages needed and interleaves suffix prefills with fused
chunked decode over a device-resident, overlapped pipeline
(`scheduler`), a request-lifecycle engine with bounded admission and
streaming callbacks (`engine`), request/engine metrics (`metrics`) and
deterministic fault injection (`faults`).

Entry points: `inference.create_engine(config, gpt_config)` to serve a
saved model dir, or `ServingEngine(params, cfg)` over a parameter tree
from `models.gpt_decode.collect_gpt_params`.

Not ported yet (ROADMAP A.1): adapters, migration, preemption,
speculation, quantized serving; the mesh (A.8).
"""

from .engine import (DEFAULT_RETRY_AFTER_S, EngineOverloadError,
                     GenerationRequest, ServingConfig, ServingEngine)
from .faults import FaultPlan, InjectedFault
from .kv_cache import ShapeBuckets, SlotKVCache
from .metrics import EngineMetrics, RequestMetrics
from .scheduler import (CompileJournal, ContinuousBatchingScheduler,
                        SequenceEvent)

__all__ = ["ServingEngine", "ServingConfig", "GenerationRequest",
           "EngineOverloadError", "DEFAULT_RETRY_AFTER_S",
           "ShapeBuckets", "SlotKVCache", "CompileJournal",
           "ContinuousBatchingScheduler", "SequenceEvent", "FaultPlan",
           "InjectedFault", "EngineMetrics", "RequestMetrics"]
