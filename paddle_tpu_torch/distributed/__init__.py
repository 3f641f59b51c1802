"""Distributed training utilities (reference: python/paddle/distributed/):
the pskv parameter-server bindings, the async Communicator, elastic
membership and the launcher. Port of `paddle_tpu/distributed/`."""
from . import elastic  # noqa: F401
from .elastic import (ElasticController, ElasticAgent,  # noqa: F401
                      SyncElasticTrainer)
from . import communicator  # noqa: F401
from .communicator import Communicator  # noqa: F401
