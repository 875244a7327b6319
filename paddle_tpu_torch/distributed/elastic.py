"""Elastic training: membership stores, the TTL'd lease and the manager.

The port's own copy of ``paddle_tpu.distributed.elastic`` (the
reference's fleet/elastic/manager.py:130): nodes heartbeat into a store
prefix, a watcher compares the live host set with the announced job size,
and the launcher (``launch.elastic_launch_local``) HOLDs, RESTARTs or
COMPLETEs its trainers (:class:`ElasticStatus`), rewriting the endpoint
list on a scale event. The PS high-availability failure detector
(``ps/ha.py``) rides the same stores and :class:`Lease`.

- :class:`MemoryStore`: in-process (tests, one-process clusters).
- :class:`FileStore`: one file per key in a shared directory, TTL by the
  write time (processes on one host or a shared filesystem).
- :class:`TcpElasticStore`: over the job's ``collective.TCPStore``, whose
  leases expire on the master's clock (etcd's lease role).
- :class:`ElasticManager`: the membership and decision loop of one node;
  the decision is a pure function of (live hosts, announced np, time since
  the host set last changed), as in the reference.
"""

from __future__ import annotations

import enum
import json
import os
import threading
import time
import urllib.parse
from typing import Dict, List, Optional

from ..core import sync as _sync

__all__ = ["ElasticManager", "ElasticStatus", "FileStore", "Lease", "MemoryStore",
           "TcpElasticStore", "desired_np_key", "set_desired_np", "store_from_spec"]


def desired_np_key(job_id: str) -> str:
    return f"elastic/{job_id}/desired_np"


def set_desired_np(store, job_id: str, np_: int) -> None:
    """Publish a target trainer world size for ``job_id`` (the
    autoscaler's lever). Every node's :class:`ElasticManager` adopts it on
    its next watch tick, clamped to its own [min_np, max_np], and the
    quorum check turns the mismatch into HOLD/RESTART decisions."""
    store.put(desired_np_key(job_id), json.dumps({"np": int(np_)}))


class ElasticStatus(enum.Enum):   # manager.py:53
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class MemoryStore:
    """In-process key-value store with a TTL per key."""

    def __init__(self) -> None:
        self._d: Dict[str, tuple] = {}
        self._lock = _sync.Lock()

    def put(self, key: str, value: str, ttl: float = 0.0) -> None:
        with self._lock:
            self._d[key] = (value, time.monotonic() + ttl if ttl else None)

    def get(self, key: str) -> Optional[str]:
        with self._lock:
            v = self._d.get(key)
            if v is None or (v[1] is not None and time.monotonic() > v[1]):
                return None
            return v[0]

    def list_prefix(self, prefix: str) -> Dict[str, str]:
        with self._lock:
            now = time.monotonic()
            return {k: v for k, (v, exp) in self._d.items()
                    if k.startswith(prefix) and (exp is None or now <= exp)}

    def delete(self, key: str) -> None:
        with self._lock:
            self._d.pop(key, None)


#: suffix of a FileStore put's temporary file; ``list_prefix`` skips such
#: names (no key of the package ends with it)
_TMP_SUFFIX = ".put-tmp"


class FileStore:
    """The same interface over a shared directory: one file per key
    (percent-encoded name), the TTL counted from the write's wall time. A
    put writes a temporary file and renames it over the key's, so a reader
    sees the old value or the new one, never a truncated file (a lease
    read mid-write would look expired)."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, urllib.parse.quote(key, safe=""))

    def put(self, key: str, value: str, ttl: float = 0.0) -> None:
        path = self._path(key)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}{_TMP_SUFFIX}"
        with open(tmp, "w") as f:
            json.dump({"v": value, "ttl": ttl, "t": time.time()}, f)
        os.replace(tmp, path)

    def get(self, key: str) -> Optional[str]:
        try:
            with open(self._path(key)) as f:
                blob = json.load(f)
        except (OSError, ValueError):
            return None
        if blob["ttl"] and time.time() > blob["t"] + blob["ttl"]:
            return None
        return blob["v"]

    def list_prefix(self, prefix: str) -> Dict[str, str]:
        out = {}
        for name in os.listdir(self.root):
            if name.endswith(_TMP_SUFFIX):
                continue
            key = urllib.parse.unquote(name)
            if key.startswith(prefix):
                v = self.get(key)
                if v is not None:
                    out[key] = v
        return out

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except OSError:
            pass


class TcpElasticStore:
    """The elastic store over the job's :class:`~.collective.TCPStore`:
    ``put(key, value, ttl)`` is a lease on the master's monotonic clock,
    so skewed node clocks can neither fake-expire a live member nor keep a
    dead one alive. One per node over the same (host, port); the launcher
    or rank 0 passes ``is_master=True``."""

    def __init__(self, tcp_store=None, host: str = "127.0.0.1",
                 port: int = 0, is_master: bool = False) -> None:
        if tcp_store is None:
            from .collective import TCPStore

            tcp_store = TCPStore(host=host, port=port, is_master=is_master)
        self.store = tcp_store
        self.host, self.port = self.store.host, self.store.port

    def put(self, key: str, value: str, ttl: float = 0.0) -> None:
        self.store.set(key, value, ttl=ttl)

    def get(self, key: str) -> Optional[str]:
        return self.store.get(key)

    def list_prefix(self, prefix: str) -> Dict[str, str]:
        return self.store.list(prefix)

    def delete(self, key: str) -> None:
        self.store.delete(key)

    def close(self) -> None:
        self.store.close()


class Lease:
    """One TTL'd liveness key over any elastic store. ``start()``
    refreshes the key from a daemon thread every ``interval`` (default
    ``ttl / 3``); a holder that dies stops refreshing and the key expires
    after ``ttl`` on the store's clock. ``release()`` deletes the key at
    once (graceful deregistration); ``stop()`` leaves it to expire (how a
    crash looks to watchers)."""

    def __init__(self, store, key: str, value: str = "", ttl: float = 1.0,
                 interval: Optional[float] = None) -> None:
        self.store = store
        self.key = key
        self.value = value
        self.ttl = ttl
        self.interval = interval if interval is not None else ttl / 3.0
        self._stop = _sync.Event()
        self._thread: Optional[threading.Thread] = None

    def refresh(self, value: Optional[str] = None) -> None:
        if value is not None:
            self.value = value
        self.store.put(self.key, self.value, ttl=self.ttl)

    def start(self) -> "Lease":
        self.refresh()
        self._thread = _sync.Thread(target=self._loop, daemon=True, name=f"lease:{self.key}")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.refresh()

    def stop(self) -> None:
        """Stop refreshing; the key expires by TTL (crash semantics)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval)

    def release(self) -> None:
        """Graceful deregistration: stop and delete the key now."""
        self.stop()
        self.store.delete(self.key)

    @staticmethod
    def alive(store, key: str) -> bool:
        return store.get(key) is not None


def store_from_spec(spec: str):
    """An elastic store from a launcher-style spec: ``file:<dir>``,
    ``tcp:<host>:<port>`` (a client of a running ``TCPStore`` master) or
    ``memory:``."""
    kind, _, rest = spec.partition(":")
    if kind == "file":
        return FileStore(rest)
    if kind == "tcp":
        host, _, port = rest.rpartition(":")
        return TcpElasticStore(host=host or "127.0.0.1", port=int(port))
    if kind == "memory":
        return MemoryStore()
    raise ValueError(f"unknown elastic store spec {spec!r} "
                     f"(file:<dir> | tcp:<host>:<port> | memory:)")


class ElasticManager:
    """Membership and decision loop for one node: ``start()`` heartbeats
    the node's key under ``elastic/<job>/nodes/``; ``watch_once()``
    returns the :class:`ElasticStatus` the launcher acts on."""

    def __init__(
        self,
        store,
        job_id: str,
        np: int,                      # announced world size
        host: str,
        heartbeat_interval: float = 1.0,
        heartbeat_ttl: float = 4.0,
        elastic_timeout: float = 10.0,
        min_np: Optional[int] = None,
        max_np: Optional[int] = None,
    ) -> None:
        self.store = store
        self.job_id = job_id
        self.np = np
        self.min_np = min_np if min_np is not None else np
        self.max_np = max_np if max_np is not None else np
        self.host = host
        self._hb_int = heartbeat_interval
        self._hb_ttl = heartbeat_ttl
        self._timeout = elastic_timeout
        self._prefix = f"elastic/{job_id}/nodes/"
        self._stop = _sync.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_change = time.monotonic()
        self._known: List[str] = []

    # -- heartbeat (lease_heartbeat, manager.py:250) -----------------------

    def start(self) -> None:
        self._beat()
        self._thread = _sync.Thread(target=self._loop, daemon=True, name="lease-heartbeat")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2 * self._hb_int)
        self.store.delete(self._prefix + self.host)

    def _beat(self) -> None:
        self.store.put(self._prefix + self.host, json.dumps(
            {"host": self.host, "t": time.time()}), ttl=self._hb_ttl)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._beat()
            self._stop.wait(self._hb_int)

    # -- membership --------------------------------------------------------

    def member_key(self, name: str) -> str:
        """The store key of one member's heartbeat (a supervisor that
        beats on behalf of its processes writes it)."""
        return self._prefix + name

    def alive_hosts(self) -> List[str]:
        return sorted(k[len(self._prefix):]
                      for k in self.store.list_prefix(self._prefix))

    # -- decision (watch loop, manager.py:439-532) -------------------------

    def desired_np(self) -> Optional[int]:
        """The published target world size (``set_desired_np``), or
        None when none was published."""
        raw = self.store.get(desired_np_key(self.job_id))
        if raw is None:
            return None
        try:
            return int(json.loads(raw).get("np"))
        except (ValueError, TypeError):
            return None

    def adopt_desired_np(self) -> bool:
        """Clamp the published target into [min_np, max_np] and adopt it
        as ``self.np``; True when the announced size changed."""
        want = self.desired_np()
        if want is None:
            return False
        want = max(self.min_np, min(int(want), self.max_np))
        if want == self.np:
            return False
        self.np = want
        return True

    def watch_once(self) -> ElasticStatus:
        self.adopt_desired_np()
        hosts = self.alive_hosts()
        n = len(hosts)
        if hosts != self._known:
            self._known = hosts
            self._last_change = time.monotonic()
        if n == self.np:
            return ElasticStatus.HOLD          # healthy, keep running
        waited = time.monotonic() - self._last_change
        if n > self.np:
            if n <= self.max_np:
                return ElasticStatus.RESTART   # scale out: adopt the larger world
            return ElasticStatus.HOLD          # beyond max_np: ignore the extras
        # n < np: a node died
        if n < self.min_np:
            if waited > self._timeout:
                return ElasticStatus.ERROR     # unrecoverable below min_np
            return ElasticStatus.HOLD          # grace period: the node may return
        if waited > self._timeout:
            return ElasticStatus.RESTART       # fault tolerance: shrink the world
        return ElasticStatus.HOLD

    def adopt_world(self) -> int:
        """After RESTART: the new world size, with the live hosts written
        to ``elastic/<job>/endpoints`` (the endpoint rewrite,
        manager.py:465)."""
        hosts = self.alive_hosts()
        self.np = max(min(len(hosts), self.max_np), self.min_np)
        self.store.put(f"elastic/{self.job_id}/endpoints", json.dumps(hosts[:self.np]))
        return self.np
