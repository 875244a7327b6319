"""Role makers: cluster topology from environment.

The port's own copy of ``paddle_tpu.distributed.role_maker``. Rebuild
of ``fleet/base/role_maker.py`` (PaddleCloudRoleMaker :519 /
UserDefinedRoleMaker :1097): answers who-am-I questions — worker or
server, rank, world sizes, endpoints — from env vars (the PaddleCloud/K8s
convention, same env names for drop-in config compat) or explicit args.
"""

from __future__ import annotations

import enum
import os
from typing import List, Optional

from ..core.enforce import InvalidArgumentError

__all__ = ["Role", "RoleMakerBase", "PaddleCloudRoleMaker", "UserDefinedRoleMaker"]


class Role(enum.IntEnum):
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class RoleMakerBase:
    def is_worker(self) -> bool:
        raise NotImplementedError

    def is_server(self) -> bool:
        raise NotImplementedError

    def is_first_worker(self) -> bool:
        return self.is_worker() and self.worker_index() == 0

    def worker_index(self) -> int:
        raise NotImplementedError

    def server_index(self) -> int:
        raise NotImplementedError

    def worker_num(self) -> int:
        raise NotImplementedError

    def server_num(self) -> int:
        raise NotImplementedError

    def get_trainer_endpoints(self) -> List[str]:
        return []

    def get_pserver_endpoints(self) -> List[str]:
        return []

    def is_cluster(self) -> bool:
        """Whether this role is one process of a cluster, whose tables
        live in server processes (``Fleet``'s ``"auto"`` transport takes
        ``"rpc"`` then). Not in the JAX package, whose ``Fleet`` reads
        ``TRAINING_ROLE`` itself: a role maker that names pserver
        endpoints names a cluster."""
        return bool(self.get_pserver_endpoints())


class PaddleCloudRoleMaker(RoleMakerBase):
    """Env-driven role maker (role_maker.py:1083 _generate_role):

    TRAINING_ROLE           TRAINER | PSERVER
    PADDLE_TRAINER_ID       worker rank
    PADDLE_TRAINERS_NUM     #workers
    PADDLE_TRAINER_ENDPOINTS comma list
    PADDLE_PSERVERS_IP_PORT_LIST comma list
    POD_IP / PADDLE_PORT    this server's endpoint

    A cluster (:meth:`is_cluster`) is ``TRAINING_ROLE`` set together with
    pserver endpoints; endpoints alone, with no role, are not.
    """

    def __init__(self, is_collective: bool = False) -> None:
        self._is_collective = is_collective
        self._role_given = "TRAINING_ROLE" in os.environ
        role = os.environ.get("TRAINING_ROLE", "TRAINER").upper()
        if role not in ("TRAINER", "PSERVER"):
            raise InvalidArgumentError(f"TRAINING_ROLE must be TRAINER/PSERVER, got {role}")
        self._role = Role.WORKER if role == "TRAINER" else Role.SERVER
        self._worker_index = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._worker_num = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self._trainer_endpoints = [
            e for e in os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",") if e
        ]
        self._server_endpoints = [
            e for e in os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "").split(",") if e
        ]
        if self._role == Role.SERVER:
            me = f"{os.environ.get('POD_IP', '127.0.0.1')}:{os.environ.get('PADDLE_PORT', '0')}"
            self._server_index = (
                self._server_endpoints.index(me) if me in self._server_endpoints else 0
            )
        else:
            self._server_index = -1

    def is_worker(self) -> bool:
        return self._role == Role.WORKER

    def is_server(self) -> bool:
        return self._role == Role.SERVER

    def worker_index(self) -> int:
        return self._worker_index

    def server_index(self) -> int:
        return self._server_index

    def worker_num(self) -> int:
        return self._worker_num

    def server_num(self) -> int:
        return max(len(self._server_endpoints), 1)

    def get_trainer_endpoints(self) -> List[str]:
        return list(self._trainer_endpoints)

    def get_pserver_endpoints(self) -> List[str]:
        return list(self._server_endpoints)

    def is_cluster(self) -> bool:
        return self._role_given and bool(self._server_endpoints)


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(
        self,
        current_id: int = 0,
        role: Role = Role.WORKER,
        worker_num: int = 1,
        server_endpoints: Optional[List[str]] = None,
        trainer_endpoints: Optional[List[str]] = None,
    ) -> None:
        self._current_id = current_id
        self._role = role
        self._worker_num = worker_num
        self._server_endpoints = server_endpoints or []
        self._trainer_endpoints = trainer_endpoints or []

    def get_trainer_endpoints(self) -> List[str]:
        return list(self._trainer_endpoints)

    def is_worker(self) -> bool:
        return self._role == Role.WORKER

    def is_server(self) -> bool:
        return self._role == Role.SERVER

    def worker_index(self) -> int:
        return self._current_id if self._role == Role.WORKER else -1

    def server_index(self) -> int:
        return self._current_id if self._role == Role.SERVER else -1

    def worker_num(self) -> int:
        return self._worker_num

    def server_num(self) -> int:
        return max(len(self._server_endpoints), 1)

    def get_pserver_endpoints(self) -> List[str]:
        return list(self._server_endpoints)
