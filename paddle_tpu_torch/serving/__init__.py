"""paddle_tpu_torch.serving — continuous-batching inference above the
executor.

Port of `paddle_tpu/serving/`: a paged KV block arena + page tables with
hashed prefix sharing (`kv_cache`), an iteration-level scheduler that
admits by pages needed and interleaves suffix prefills with fused
chunked decode over a device-resident, overlapped pipeline
(`scheduler`, with speculative decoding: a per-slot n-gram drafter and
one verify pass a chunk iteration), a request-lifecycle engine with
bounded admission and streaming callbacks, host-swap preemption and
cross-engine migration (`engine`), the portable migration record
(`migration`), request/engine metrics (`metrics`), deterministic
fault injection (`faults`) and the multi-tenant LoRA adapter pool
(`adapters`). ServingConfig(weight_dtype="int8", kv_dtype="int8")
serves int8 weights and an int8 KV arena with its scale plane.

Entry points: `inference.create_engine(config, gpt_config)` to serve a
saved model dir, or `ServingEngine(params, cfg)` over a parameter tree
from `models.gpt_decode.collect_gpt_params`.

Not ported yet: the mesh (ROADMAP A.8).
"""

from .adapters import (AdapterError, AdapterGeometryError, AdapterPool,
                       AdapterPoolFullError, AdapterReferencedError,
                       UnknownAdapterError, adapter_geometry, make_adapter)
from .engine import (DEFAULT_RETRY_AFTER_S, EngineOverloadError,
                     GenerationRequest, ServingConfig, ServingEngine)
from .faults import FaultPlan, InjectedFault
from .kv_cache import ShapeBuckets, SlotKVCache
from .metrics import EngineMetrics, RequestMetrics
from .migration import (TICKET_VERSION, MigrationError, MigrationTicket,
                        TicketError)
from .scheduler import (CompileJournal, ContinuousBatchingScheduler,
                        SequenceEvent, SwappedSequence)

__all__ = ["ServingEngine", "ServingConfig", "GenerationRequest",
           "EngineOverloadError", "DEFAULT_RETRY_AFTER_S",
           "ShapeBuckets", "SlotKVCache", "CompileJournal",
           "ContinuousBatchingScheduler", "SequenceEvent",
           "SwappedSequence", "FaultPlan", "InjectedFault",
           "EngineMetrics", "RequestMetrics", "MigrationTicket",
           "MigrationError", "TicketError", "TICKET_VERSION",
           "AdapterPool", "AdapterError", "UnknownAdapterError",
           "AdapterGeometryError", "AdapterPoolFullError",
           "AdapterReferencedError", "adapter_geometry", "make_adapter"]
