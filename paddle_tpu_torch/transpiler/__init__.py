"""Program transpilers (reference: python/paddle/fluid/transpiler/).

Port of `paddle_tpu/transpiler/__init__.py`: the parameter-server
DistributeTranspiler. The collective transpilers (`collective.py`) come
with the port's parallelism (ROADMAP A.8), recompute (`recompute.py`)
with A.9's other half.
"""

from .distribute_transpiler import (  # noqa: F401
    DistributeTranspiler, DistributeTranspilerConfig, RoundRobin, HashName,
    PServerSpec, start_pserver, run_pserver)

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig",
           "RoundRobin", "HashName", "PServerSpec", "start_pserver",
           "run_pserver"]
