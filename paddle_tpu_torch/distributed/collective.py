"""Process-level collective API (``paddle.distributed`` surface).

Port of ``paddle_tpu.distributed.collective`` (the reference's
python/paddle/distributed/{collective.py, parallel.py}):
``init_parallel_env`` (parallel.py:91), ``new_group`` (collective.py:314),
the eager ``all_reduce``/``all_gather``/``broadcast``/``scatter``/
``alltoall``/``barrier`` (collective.py:580, 798, 893, 266) and the
``TCPStore`` rendezvous (distributed/store/tcp_store.h:91).

The JAX package's bootstrap rides ``jax.distributed`` and its eager
collectives ``jax.experimental.multihost_utils``; here the bootstrap is
``torch.distributed.init_process_group`` and the eager collectives ride
its default group. They take and return numpy, as the JAX package's do,
under its participation contract: EVERY process calls each of them, even
when ``group`` is a subset; ``group`` scopes the result, not who takes
part (a non-member's ``broadcast`` returns its own ``x``, its ``scatter``
None, its ``alltoall`` its own list). In-graph collectives over a mesh
axis are ``ops.collectives`` (on a process mesh:
``core.mesh.make_process_mesh``).

The backend (:func:`init_parallel_env`) is chosen by one explicit rule:
``"nccl"`` when CUDA is there and every rank of this host has its own
card (fewer cards than ranks raises, naming the counts), ``"gloo"`` on
the CPU or when the caller asks for it. No code switches backend on a
failure. Several processes sharing one card therefore run gloo, whose
collectives stage CUDA tensors through the host (``ops.transport``).

``TCPStore`` is the port's own copy of the JAX module's (the reference's
distributed/store/tcp_store.h:91, MasterDaemon + clients): a pure-Python
key-value daemon that one process hosts (``is_master``) and every process
connects to, one JSON line a request. Blocking ``wait`` and atomic
``add`` give barrier and rendezvous semantics. ``fleet.util`` (all-reduce,
all-to-all of bytes, barrier) rides it.

``set(..., ttl=)`` starts a lease on the master's monotonic clock (one
clock for the whole job, so skewed hosts can neither fake-expire a live
member nor keep a dead one alive), and ``list(prefix)`` enumerates the
live keys under a prefix (etcd's get-prefix role):
``distributed.elastic.TcpElasticStore`` and the elastic launcher's
membership ride them. ``get``, ``wait`` and ``list`` do not see an expired
key.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import socketserver
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.enforce import InvalidArgumentError, PreconditionNotMetError, enforce

__all__ = ["Group", "ParallelEnv", "TCPStore", "all_gather", "all_reduce", "alltoall",
           "barrier", "broadcast", "get_rank", "get_world_size", "init_parallel_env",
           "is_initialized", "new_group", "scatter"]


class _StoreState:
    def __init__(self) -> None:
        self.kv: Dict[str, str] = {}
        # lease expiry per key, on the master's monotonic clock
        self.expire: Dict[str, float] = {}
        self.cond = threading.Condition()

    def alive(self, key: str) -> bool:
        exp = self.expire.get(key)
        return exp is None or time.monotonic() <= exp


class _StoreHandler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        state: _StoreState = self.server.state  # type: ignore[attr-defined]
        for line in self.rfile:
            try:
                req = json.loads(line)
            except ValueError:
                break
            cmd = req.get("cmd")
            with state.cond:
                if cmd == "set":
                    state.kv[req["key"]] = req["value"]
                    # ttl (seconds) starts a lease on the master's clock;
                    # absent or 0 is permanent (etcd put-with-lease role)
                    ttl = float(req.get("ttl") or 0.0)
                    if ttl > 0:
                        state.expire[req["key"]] = time.monotonic() + ttl
                    else:
                        state.expire.pop(req["key"], None)
                    state.cond.notify_all()
                    resp = {"ok": True}
                elif cmd == "get":
                    k = req["key"]
                    v = state.kv.get(k) if state.alive(k) else None
                    resp = {"ok": True, "value": v}
                elif cmd == "add":
                    cur = int(state.kv.get(req["key"], "0")) + int(req["delta"])
                    state.kv[req["key"]] = str(cur)
                    state.cond.notify_all()
                    resp = {"ok": True, "value": str(cur)}
                elif cmd == "wait":
                    deadline = time.monotonic() + float(req.get("timeout", 300.0))
                    keys = req["keys"]
                    ok = True
                    while not all(k in state.kv and state.alive(k) for k in keys):
                        left = deadline - time.monotonic()
                        if left <= 0 or not state.cond.wait(timeout=min(left, 1.0)):
                            if time.monotonic() >= deadline:
                                ok = False
                                break
                    resp = {"ok": ok}
                elif cmd == "delete":
                    state.expire.pop(req["key"], None)
                    resp = {"ok": state.kv.pop(req["key"], None) is not None}
                elif cmd == "list":
                    pfx = req.get("prefix", "")
                    resp = {"ok": True,
                            "items": {k: v for k, v in state.kv.items()
                                      if k.startswith(pfx) and state.alive(k)}}
                else:
                    resp = {"ok": False, "error": f"unknown cmd {cmd}"}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


class _StoreServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class TCPStore:
    """Reference ``TCPStore`` (tcp_store.h:91): rank 0 (``is_master``)
    runs the daemon; every rank connects as a client. Blocking ``wait``
    and atomic ``add`` give barrier/rendezvous semantics."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, timeout: float = 300.0) -> None:
        self.timeout = float(timeout)
        self._server: Optional[_StoreServer] = None
        if is_master:
            self._server = _StoreServer((host, port), _StoreHandler)
            self._server.state = _StoreState()  # type: ignore[attr-defined]
            port = self._server.server_address[1]
            threading.Thread(target=self._server.serve_forever,
                             daemon=True, name="tcp-store-server").start()
        self.host, self.port = host, port
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._rfile = self._sock.makefile("rb")
        self._lock = threading.Lock()
        self._barrier_rounds: Dict[str, int] = {}

    def _rpc(self, **req) -> Dict[str, Any]:
        with self._lock:
            # the lock EXISTS to serialize request/response pairing on
            # this one socket — the IO is the protected resource, there
            # is no hot path behind it (store bootstrap control plane)
            self._sock.sendall((json.dumps(req) + "\n").encode())
            line = self._rfile.readline()
        if not line:
            raise PreconditionNotMetError("TCPStore connection closed")
        return json.loads(line)

    def set(self, key: str, value: str, ttl: float = 0.0) -> None:
        """``ttl`` > 0 starts a lease: the key expires from ``get``,
        ``wait`` and ``list`` ``ttl`` seconds after the master receives
        this set, on the master's monotonic clock."""
        self._rpc(cmd="set", key=key, value=value, ttl=float(ttl))

    def get(self, key: str) -> Optional[str]:
        return self._rpc(cmd="get", key=key)["value"]

    def add(self, key: str, delta: int = 1) -> int:
        return int(self._rpc(cmd="add", key=key, delta=delta)["value"])

    def wait(self, keys: Sequence[str], timeout: Optional[float] = None) -> None:
        ok = self._rpc(cmd="wait", keys=list(keys),
                       timeout=timeout or self.timeout)["ok"]
        if not ok:
            raise PreconditionNotMetError(f"TCPStore wait timed out on {keys}")

    def delete(self, key: str) -> bool:
        return self._rpc(cmd="delete", key=key)["ok"]

    def list(self, prefix: str = "") -> Dict[str, str]:
        """The live keys under ``prefix`` and their values."""
        return dict(self._rpc(cmd="list", prefix=prefix)["items"])

    def barrier(self, name: str, world_size: int,
                timeout: Optional[float] = None) -> None:
        # per-round keys: a reused barrier name must re-synchronize each
        # round, so each client tracks its local round counter (all
        # participants call barriers the same number of times)
        rnd = self._barrier_rounds.get(name, 0)
        self._barrier_rounds[name] = rnd + 1
        n = self.add(f"__barrier/{name}/{rnd}/count", 1)
        if n >= world_size:
            self.set(f"__barrier/{name}/{rnd}/done", "1")
        self.wait([f"__barrier/{name}/{rnd}/done"], timeout)

    def close(self) -> None:
        try:
            self._sock.close()
        finally:
            if self._server is not None:
                self._server.shutdown()
                self._server.server_close()


# ---------------------------------------------------------------------------
# the parallel env (parallel.py:91 init_parallel_env / ParallelEnv)
# ---------------------------------------------------------------------------


class ParallelEnv:
    """The launcher's env: ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` /
    ``PADDLE_TRAINER_ENDPOINTS`` (plain ``RANK``/``WORLD_SIZE`` also
    read), as the JAX package reads them."""

    def __init__(self) -> None:
        env = os.environ
        self.rank = int(env.get("PADDLE_TRAINER_ID", env.get("RANK", "0")))
        self.world_size = int(env.get("PADDLE_TRAINERS_NUM", env.get("WORLD_SIZE", "1")))
        eps = env.get("PADDLE_TRAINER_ENDPOINTS", "")
        self.trainer_endpoints: List[str] = eps.split(",") if eps else []
        self.current_endpoint = env.get(
            "PADDLE_CURRENT_ENDPOINT",
            self.trainer_endpoints[self.rank] if self.rank < len(self.trainer_endpoints)
            else "")

    @property
    def nranks(self) -> int:  # the reference's name
        return self.world_size


_parallel_state: Dict[str, Any] = {"initialized": False, "env": None}

#: seconds a collective of the job waits for its group before it raises
PROCESS_GROUP_TIMEOUT = 600.0


def choose_backend(backend: Optional[str], world_size: int) -> str:
    """The backend rule: ``backend`` as asked (``"nccl"`` or ``"gloo"``),
    else ``"nccl"`` when CUDA is there and ``"gloo"`` when it is not.
    NCCL needs a card a rank on this host (``LOCAL_WORLD_SIZE``, else the
    world size: the local launcher runs every rank on one host); fewer
    cards raise."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    enforce(backend in ("nccl", "gloo"),
            f"backend must be 'nccl' or 'gloo', got {backend!r}", InvalidArgumentError)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        enforce(cards >= local,
                f"backend 'nccl' needs a card a rank: {local} ranks on this host, {cards} "
                f"card(s); NCCL refuses two ranks of one communicator on one card. Pass "
                f"backend='gloo' to share a card", InvalidArgumentError)
    return backend


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def init_parallel_env(coordinator_address: Optional[str] = None,
                      backend: Optional[str] = None) -> ParallelEnv:
    """``paddle.distributed.init_parallel_env``: join this process to the
    job's ``torch.distributed`` process group (rank and world from
    :class:`ParallelEnv`; rendezvous at ``coordinator_address``, else
    ``PADDLE_MASTER``, else trainer endpoint 0: ``host:port`` for a TCP
    store or a ``file://`` / ``tcp://`` URL). The backend follows
    :func:`choose_backend`. A world of one without an address records the
    env only, as in the JAX package; with an address it is a job of one
    (a real communicator). Returns the env; a second call returns the
    first's."""
    if _parallel_state["initialized"]:
        return _parallel_state["env"]
    env = ParallelEnv()
    if env.world_size > 1 or coordinator_address is not None:
        import torch.distributed as dist

        addr = coordinator_address or os.environ.get(
            "PADDLE_MASTER", env.trainer_endpoints[0] if env.trainer_endpoints else None)
        enforce(addr is not None,
                "a multi-process job needs a coordinator address (PADDLE_MASTER or trainer "
                "endpoint 0)", PreconditionNotMetError)
        backend = choose_backend(backend, env.world_size)
        kw = {}
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", env.rank % torch.cuda.device_count())
            torch.cuda.set_device(kw["device_id"])
        dist.init_process_group(backend, init_method=_init_method(addr), rank=env.rank,
                                world_size=env.world_size,
                                timeout=datetime.timedelta(seconds=PROCESS_GROUP_TIMEOUT), **kw)
    _parallel_state.update(initialized=True, env=env)
    return env


def is_initialized() -> bool:
    return bool(_parallel_state["initialized"])


def get_rank() -> int:
    if _parallel_state["env"] is not None:
        return _parallel_state["env"].rank
    return ParallelEnv().rank


def get_world_size() -> int:
    if _parallel_state["env"] is not None:
        return _parallel_state["env"].world_size
    return ParallelEnv().world_size


# ---------------------------------------------------------------------------
# groups (collective.py:314 new_group) and the eager collectives
# ---------------------------------------------------------------------------


class Group:
    """A set of ranks (the reference's ``Group`` with its ring id). The
    eager collectives over it run over every process (see the module's
    participation contract); in-graph code uses mesh axes instead."""

    _next_id = 0

    def __init__(self, ranks: Sequence[int]) -> None:
        self.ranks = list(ranks)
        self.id = Group._next_id
        Group._next_id += 1

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __contains__(self, rank: int) -> bool:
        return rank in self.ranks


_default_group: Optional[Group] = None


def _get_group(group: Optional[Group]) -> Group:
    global _default_group
    if group is not None:
        return group
    if _default_group is None:
        _default_group = Group(list(range(get_world_size())))
    return _default_group


def new_group(ranks: Optional[Sequence[int]] = None) -> Group:
    return Group(list(ranks) if ranks is not None else list(range(get_world_size())))


def _wire(x: np.ndarray) -> torch.Tensor:
    """``x`` as a tensor the job's backend moves: on this process's card
    under NCCL, on the CPU under gloo."""
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(x))
    if dist.get_backend() == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def _multi_process() -> bool:
    import torch.distributed as dist

    return get_world_size() > 1 and dist.is_available() and dist.is_initialized()


def _process_allgather(x: np.ndarray) -> List[np.ndarray]:
    """Every process's copy of ``x`` (same shape and dtype on all), by
    global rank."""
    x = np.asarray(x)
    if not _multi_process():
        return [x]
    import torch.distributed as dist

    t = _wire(x)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return [p.cpu().numpy() for p in parts]


_REDUCERS = {
    "sum": lambda xs: np.sum(xs, axis=0),
    "avg": lambda xs: np.mean(xs, axis=0),
    "max": lambda xs: np.max(xs, axis=0),
    "min": lambda xs: np.min(xs, axis=0),
    "prod": lambda xs: np.prod(xs, axis=0),
}


def all_reduce(x, op: str = "sum", group: Optional[Group] = None) -> np.ndarray:
    """Eager all_reduce (collective.py:580) of the group's members' ``x``
    by ``op`` (sum, avg, max, min, prod); every process calls."""
    enforce(op in _REDUCERS, f"unknown reduce op {op}", InvalidArgumentError)
    g = _get_group(group)
    parts = _process_allgather(np.asarray(x))
    parts = [parts[r] for r in g.ranks if r < len(parts)]
    return _REDUCERS[op](np.stack(parts))


def all_gather(x, group: Optional[Group] = None) -> List[np.ndarray]:
    """The group's members' ``x`` in group order; every process calls."""
    g = _get_group(group)
    parts = _process_allgather(np.asarray(x))
    return [parts[r] for r in g.ranks if r < len(parts)]


def broadcast(x, src: int = 0, group: Optional[Group] = None) -> np.ndarray:
    """Global rank ``src``'s ``x`` for the group's members; a non-member
    (or a ``src`` outside the group) gets its own ``x``."""
    g = _get_group(group)
    parts = _process_allgather(np.asarray(x))
    return parts[src] if src in g.ranks and src < len(parts) else np.asarray(x)


def scatter(tensor_list: Optional[Sequence], src: int = 0,
            group: Optional[Group] = None) -> Optional[np.ndarray]:
    """collective.py:893: global rank ``src``'s list, one entry a group
    member, and each member takes its own; a non-member takes None. Every
    process passes a list of the same shapes (the non-source values are
    unread), as in the JAX package."""
    g = _get_group(group)
    enforce(tensor_list is not None and len(tensor_list) == g.nranks,
            "scatter needs one tensor per group rank on every rank (non-src values are "
            "ignored)", InvalidArgumentError)
    if get_world_size() == 1:
        return np.asarray(tensor_list[0])
    import torch.distributed as dist

    t = _wire(np.stack([np.asarray(v) for v in tensor_list]))
    if _multi_process():
        dist.broadcast(t, src=src)
    rank_in_group = g.get_group_rank(get_rank())
    if rank_in_group < 0:
        return None
    return t.cpu().numpy()[rank_in_group]


def alltoall(in_list: Sequence, group: Optional[Group] = None) -> List[np.ndarray]:
    """Member i's entry j goes to member j, in group order; a non-member
    keeps its own list. Every process calls with same-shaped lists."""
    g = _get_group(group)
    enforce(len(in_list) == g.nranks, "alltoall needs one tensor per rank",
            InvalidArgumentError)
    if get_world_size() == 1:
        return [np.asarray(t) for t in in_list]
    rank_in_group = g.get_group_rank(get_rank())
    all_parts = _process_allgather(np.stack([np.asarray(t) for t in in_list]))
    if rank_in_group < 0:
        return [np.asarray(t) for t in in_list]
    return [all_parts[g.ranks[r]][rank_in_group] for r in range(g.nranks)]


def barrier(group: Optional[Group] = None) -> None:
    """collective.py:266: every process waits for all (a no-op in a world
    of one)."""
    if _multi_process():
        import torch.distributed as dist

        dist.barrier()
