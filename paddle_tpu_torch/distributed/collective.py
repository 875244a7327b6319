"""The coordination store of ``paddle.distributed``: ``TCPStore``.

The port's own copy of the ``TCPStore`` half of
``paddle_tpu.distributed.collective`` (the reference's
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

Not ported here (ROADMAP Queue A item 7): the rest of the module, the
process groups, ``init_parallel_env``/``ParallelEnv`` and the eager
tensor collectives.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
import time
from typing import Any, Dict, Optional, Sequence

from ..core.enforce import PreconditionNotMetError

__all__ = ["TCPStore"]


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
