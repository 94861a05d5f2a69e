"""Role makers: rank/endpoint discovery.

A copy of the JAX package's ``fleet/base/role_maker.py`` (parity:
the reference's python/paddle/fleet/base/role_maker.py): the PaddleCloud
env-var protocol, so launch scripts port unchanged.  A server-role
process (TRAINING_ROLE=PSERVER) runs ``fleet.init_server`` +
``fleet.run_server`` (distributed/ps_server.py).
"""
from __future__ import annotations

import os


class RoleMakerBase:
    def worker_index(self) -> int:
        from ..  import worker_index

        return worker_index()

    def worker_num(self) -> int:
        from .. import worker_num

        return worker_num()

    def is_worker(self) -> bool:
        return True

    def is_server(self) -> bool:
        return False

    def is_first_worker(self) -> bool:
        return self.worker_index() == 0


class PaddleCloudRoleMaker(RoleMakerBase):
    """Reads the PaddleCloud env protocol: PADDLE_TRAINER_ID /
    PADDLE_TRAINER_ENDPOINTS for workers, and the server role via
    TRAINING_ROLE=PSERVER + PADDLE_PORT/PADDLE_PSERVERS (the reference's
    parameter-server convention)."""

    def __init__(self, is_collective: bool = True):
        self.is_collective = is_collective

    def worker_index(self) -> int:
        return int(os.environ.get("PADDLE_TRAINER_ID", 0))

    def worker_num(self) -> int:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return len(eps.split(",")) if eps else 1

    def is_worker(self) -> bool:
        return os.environ.get("TRAINING_ROLE", "TRAINER").upper() == "TRAINER"

    def is_server(self) -> bool:
        return os.environ.get("TRAINING_ROLE", "").upper() == "PSERVER"

    def server_index(self) -> int:
        return int(os.environ.get("PADDLE_PSERVER_ID", 0))

    def server_num(self) -> int:
        return len(self.get_pserver_endpoints())

    def get_pserver_endpoints(self):
        eps = os.environ.get("PADDLE_PSERVERS", "")
        return [e.strip() for e in eps.split(",") if e.strip()]


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id: int = 0, worker_num: int = 1, role=None,
                 worker_endpoints=None, server_endpoints=None):
        self._id = current_id
        self._num = worker_num
        self._role = role
        self._server_eps = list(server_endpoints or [])

    def worker_index(self) -> int:
        return self._id

    def worker_num(self) -> int:
        return self._num

    def is_server(self) -> bool:
        return str(self._role).upper() in ("SERVER", "PSERVER", "ROLE.SERVER")

    def is_worker(self) -> bool:
        return not self.is_server()

    def get_pserver_endpoints(self):
        return list(self._server_eps)
