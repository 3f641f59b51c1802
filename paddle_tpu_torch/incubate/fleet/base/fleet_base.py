"""Fleet base: the unified distributed-training facade.

Copy of `paddle_tpu/incubate/fleet/base/fleet_base.py` (it imports no JAX).

Reference: python/paddle/fluid/incubate/fleet/base/fleet_base.py:37 `Fleet`
abstract class + `DistributedOptimizer`. Concrete mode here: parameter
server (incubate/fleet/parameter_server/); the collective mode comes with
the port's parallelism (ROADMAP A.8).
"""

from __future__ import annotations

from typing import List, Optional

from .role_maker import RoleMakerBase, UserDefinedRoleMaker

__all__ = ["Fleet", "DistributedOptimizer", "Mode"]


class Mode:
    COLLECTIVE = 1
    PS = 2


class Fleet:
    def __init__(self, mode: int):
        self._mode = mode
        self._role_maker: Optional[RoleMakerBase] = None
        self._is_initialized = False

    # -- identity ------------------------------------------------------------
    def init(self, role_maker: Optional[RoleMakerBase] = None):
        if role_maker is None:
            role_maker = UserDefinedRoleMaker()
        role_maker.generate_role()
        self._role_maker = role_maker
        self._is_initialized = True

    def _check_init(self):
        if not self._is_initialized:
            raise RuntimeError("fleet.init(role_maker) must be called first")

    def is_first_worker(self) -> bool:
        self._check_init()
        return self._role_maker.is_first_worker()

    def worker_index(self) -> int:
        self._check_init()
        return self._role_maker.worker_index()

    def worker_num(self) -> int:
        self._check_init()
        return self._role_maker.worker_num()

    def is_worker(self) -> bool:
        self._check_init()
        return self._role_maker.is_worker()

    def server_num(self) -> int:
        self._check_init()
        return self._role_maker.server_num()

    def server_index(self) -> int:
        self._check_init()
        return self._role_maker.server_index()

    def is_server(self) -> bool:
        self._check_init()
        return self._role_maker.is_server()

    def worker_endpoints(self) -> List[str]:
        self._check_init()
        return self._role_maker.get_trainer_endpoints()

    def server_endpoints(self) -> List[str]:
        self._check_init()
        return self._role_maker.get_pserver_endpoints()

    # -- lifecycle hooks (mode-specific) -------------------------------------
    def init_worker(self):
        pass

    def init_server(self, *args, **kwargs):
        pass

    def run_server(self):
        pass

    def stop_worker(self):
        pass

    def distributed_optimizer(self, optimizer, strategy=None):
        raise NotImplementedError

    def save_inference_model(self, *args, **kwargs):
        raise NotImplementedError

    def save_persistables(self, *args, **kwargs):
        raise NotImplementedError


class DistributedOptimizer:
    """Wraps a regular Optimizer; minimize() additionally rewrites the
    program for distributed execution (reference fleet_base.py
    DistributedOptimizer)."""

    def __init__(self, optimizer, strategy=None):
        self._optimizer = optimizer
        self._strategy = strategy

    def backward(self, loss, **kw):
        return self._optimizer.backward(loss, **kw)

    def apply_gradients(self, params_grads, *args, **kw):
        return self._optimizer.apply_gradients(params_grads, *args, **kw)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        raise NotImplementedError
