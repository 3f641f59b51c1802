"""Role makers: who am I in the training cluster?

Reference: python/paddle/fluid/incubate/fleet/base/role_maker.py —
RoleMakerBase, UserDefinedRoleMaker, PaddleCloudRoleMaker (env-variable
based), MPISymetricRoleMaker (:111 MPI bootstrap). Copy of
`paddle_tpu/incubate/fleet/base/role_maker.py` (it imports no JAX): no MPI;
the env-variable convention is kept (PADDLE_TRAINER_ID /
PADDLE_TRAINERS_NUM / PADDLE_TRAINER_ENDPOINTS, and for PS mode
TRAINING_ROLE / PADDLE_PSERVERS_IP_PORT_LIST), written by
paddle_tpu_torch.distributed.launch.
"""

from __future__ import annotations

import os
from typing import List, Optional

__all__ = ["Role", "RoleMakerBase", "UserDefinedRoleMaker",
           "PaddleCloudRoleMaker"]


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    def __init__(self):
        self._worker_endpoints: List[str] = []
        self._server_endpoints: List[str] = []
        self._role: Optional[int] = None
        self._current_id: int = 0
        self._generate_called = False

    def generate_role(self):
        self._generate_called = True

    def is_worker(self) -> bool:
        return self._role == Role.WORKER

    def is_server(self) -> bool:
        return self._role == Role.SERVER

    def is_first_worker(self) -> bool:
        return self.is_worker() and self._current_id == 0

    def worker_index(self) -> int:
        return self._current_id

    def server_index(self) -> int:
        return self._current_id

    def worker_num(self) -> int:
        return len(self._worker_endpoints) or 1

    def server_num(self) -> int:
        return len(self._server_endpoints)

    def get_trainer_endpoints(self) -> List[str]:
        return list(self._worker_endpoints)

    def get_pserver_endpoints(self) -> List[str]:
        return list(self._server_endpoints)


class UserDefinedRoleMaker(RoleMakerBase):
    """Explicit role assignment (reference role_maker.py UserDefinedRoleMaker)."""

    def __init__(self, current_id: int = 0, role: int = Role.WORKER,
                 worker_num: int = 1,
                 server_endpoints: Optional[List[str]] = None,
                 worker_endpoints: Optional[List[str]] = None):
        super().__init__()
        self._current_id = current_id
        self._role = role
        self._server_endpoints = list(server_endpoints or [])
        self._worker_endpoints = list(
            worker_endpoints or
            [f"127.0.0.1:{6170 + i}" for i in range(worker_num)])

    def generate_role(self):
        self._generate_called = True


class PaddleCloudRoleMaker(RoleMakerBase):
    """Role from environment variables (reference PaddleCloudRoleMaker),
    as set by `python -m paddle_tpu_torch.distributed.launch`."""

    def __init__(self, is_collective: bool = False):
        super().__init__()
        self._is_collective = is_collective

    def generate_role(self):
        if self._generate_called:
            return
        self._generate_called = True
        if self._is_collective:
            self._role = Role.WORKER
            self._current_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
            eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
            self._worker_endpoints = [e for e in eps.split(",") if e]
            if not self._worker_endpoints:
                n = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
                self._worker_endpoints = [
                    f"127.0.0.1:{6170 + i}" for i in range(n)]
            return
        # parameter-server mode
        training_role = os.environ.get("TRAINING_ROLE", "TRAINER")
        eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        self._server_endpoints = [e for e in eps.split(",") if e]
        trainers = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self._worker_endpoints = [
            f"127.0.0.1:{6170 + i}" for i in range(trainers)]
        if training_role == "PSERVER":
            self._role = Role.SERVER
            cur = (os.environ.get("POD_IP", "127.0.0.1") + ":" +
                   os.environ.get("PADDLE_PORT", "6174"))
            self._current_id = (self._server_endpoints.index(cur)
                                if cur in self._server_endpoints else 0)
        else:
            self._role = Role.WORKER
            self._current_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))


class UserDefinedCollectiveRoleMaker(RoleMakerBase):
    """reference: role_maker.py UserDefinedCollectiveRoleMaker — every
    member is a worker (collective mode has no pservers)."""

    def __init__(self, current_id=0, worker_endpoints=None):
        super().__init__()
        self._role = Role.WORKER
        self._current_id = int(current_id)
        self._worker_endpoints = list(worker_endpoints or [])
        self._trainers_num = len(self._worker_endpoints)

    def generate_role(self):
        self._generate_called = True

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def worker_num(self):
        return self._trainers_num

    def worker_index(self):
        return self._current_id
