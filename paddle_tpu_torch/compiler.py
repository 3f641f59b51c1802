"""CompiledProgram: a Program with build and execution strategies attached.

Port of `paddle_tpu/compiler.py` (reference: python/paddle/fluid/
compiler.py:65) on one device: `Executor.run` accepts a CompiledProgram
and runs its `_program`, with the same compile-cache key as the Program
itself. The distribution modes, which in JAX attach a sharding plan to
the jitted step, raise: `with_data_parallel`, `with_sharding` and
`with_collective` come with ROADMAP A.8, `with_recompute` with A.9.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from .framework.core import Program

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy"]


class BuildStrategy:
    """Knob holder (reference: details/build_strategy.h:68), the JAX
    package's fields; none changes a single-device run."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = 0
        self.num_trainers = 1
        self.trainer_id = 0
        self.nccl_comm_num = 1
        self.use_hierarchical_allreduce = False
        self.hierarchical_allreduce_inter_nranks = 1


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 1


def _not_ported(what, item):
    return NotImplementedError(
        f"CompiledProgram.{what} is not ported to paddle_tpu_torch yet "
        f"(ROADMAP {item})")


class CompiledProgram:
    def __init__(self, program: Program):
        self._program = program

    def with_data_parallel(self, loss_name: Optional[str] = None,
                           build_strategy: Optional[BuildStrategy] = None,
                           exec_strategy: Optional[ExecutionStrategy] = None,
                           share_vars_from=None, places=None):
        raise _not_ported("with_data_parallel", "A.8")

    def with_sharding(self, param_shardings: Dict[str, tuple],
                      mesh_shape=None, axis_names=("dp", "mp"),
                      feed_shardings: Optional[Dict[str, tuple]] = None):
        raise _not_ported("with_sharding", "A.8")

    def with_recompute(self, checkpoints: Optional[Sequence[str]] = None):
        raise _not_ported("with_recompute", "A.9")

    def with_collective(self, nranks: Optional[int] = None,
                        axis_name: str = "dp",
                        hierarchical_inter_nranks: int = 1,
                        build_strategy: Optional[BuildStrategy] = None):
        raise _not_ported("with_collective", "A.8")

    def _plan(self):
        """The distribution plan the executor keys its cache on: none on
        one device."""
        return None
