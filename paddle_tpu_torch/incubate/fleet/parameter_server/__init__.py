"""Fleet parameter-server mode.

Copy of `paddle_tpu/incubate/fleet/parameter_server/__init__.py` (it
imports no JAX). Reference: python/paddle/fluid/incubate/fleet/
parameter_server/distribute_transpiler/__init__.py — fleet facade over
DistributeTranspiler: workers transpile + train, servers run
listen_and_serv. Here servers run the pskv KV service
(distributed/csrc/pskv.cc) and workers run the step-plus-host-exchange
trainer program.
"""

from __future__ import annotations

from typing import Optional

from ..base.fleet_base import Fleet, DistributedOptimizer, Mode
from ....transpiler.distribute_transpiler import (
    DistributeTranspiler, DistributeTranspilerConfig, start_pserver)

__all__ = ["fleet", "PSFleet", "TranspilerOptimizer",
           "DistributeTranspilerConfig"]


class PSFleet(Fleet):
    def __init__(self):
        super().__init__(Mode.PS)
        self._transpiler: Optional[DistributeTranspiler] = None
        self._main_program = None
        self._startup_program = None
        self._server = None

    # -- worker lifecycle ----------------------------------------------------
    def init_worker(self):
        """Connect + create/seed tables (first run does it lazily anyway)."""
        self._check_init()

    def run_worker(self):
        pass

    def stop_worker(self):
        if self._main_program is not None:
            plan = getattr(self._main_program, "_ps_plan", None)
            if plan is not None:
                plan.shutdown()

    # -- server lifecycle ----------------------------------------------------
    def init_server(self, model_dir: Optional[str] = None):
        self._check_init()

    def run_server(self, blocking: bool = True):
        """listen_and_serv analog: start the KV service for this server's
        shard. With blocking=False returns the server handle (tests)."""
        self._check_init()
        if self._transpiler is None:
            raise RuntimeError("call distributed_optimizer(...).minimize() "
                               "before run_server()")
        ep = self.server_endpoints()[self.server_index()]
        spec = self._transpiler.get_pserver_program(ep)
        self._server = start_pserver(spec)
        if blocking:
            import time
            try:
                while not self._server.stopped():
                    time.sleep(0.2)
            except KeyboardInterrupt:
                pass
            self.stop_server()
        return self._server

    def stop_server(self):
        if self._server is not None:
            self._server.stop()
            self._server = None

    # -- optimize ------------------------------------------------------------
    def distributed_optimizer(self, optimizer, strategy=None):
        self._check_init()
        self._optimizer = TranspilerOptimizer(self, optimizer, strategy)
        return self._optimizer

    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None,
                             export_for_deployment=True):
        from .... import io
        return io.save_inference_model(dirname, feeded_var_names,
                                       target_vars, executor,
                                       main_program=main_program)

    def save_persistables(self, executor, dirname, main_program=None):
        from .... import io
        return io.save_persistables(executor, dirname,
                                    main_program=main_program)

    @property
    def main_program(self):
        return self._main_program

    @property
    def startup_program(self):
        return self._startup_program


class TranspilerOptimizer(DistributedOptimizer):
    """Wraps a local optimizer; minimize() builds the local optimize ops and
    then transpiles the program for PS mode (server-side optimizers take
    over; trainer keeps forward+backward+clip)."""

    def __init__(self, fleet_: PSFleet, optimizer, strategy=None):
        self._fleet = fleet_
        self._optimizer = optimizer
        if strategy is None:
            strategy = DistributeTranspilerConfig()
        elif not isinstance(strategy, DistributeTranspilerConfig):
            raise TypeError("strategy must be a DistributeTranspilerConfig")
        self._strategy = strategy

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ....framework.core import (default_main_program,
                                        default_startup_program)
        params_grads = self._optimizer.minimize(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set)
        f = self._fleet
        main = loss.block.program
        t = DistributeTranspiler(config=self._strategy)
        sync = self._strategy.sync_mode
        t.transpile(
            trainer_id=max(f.worker_index(), 0),
            program=main,
            pservers=",".join(f.server_endpoints()),
            trainers=f.worker_num(),
            sync_mode=True if sync is None else sync,
            startup_program=startup_program or default_startup_program())
        f._transpiler = t
        f._main_program = t.get_trainer_program()
        f._startup_program = startup_program or default_startup_program()
        return params_grads


fleet = PSFleet()


# reference name aliases (incubate/fleet/parameter_server/
# distribute_transpiler/__init__.py): the PS fleet IS the distribute-
# transpiler flavor here
DistributedTranspiler = PSFleet
