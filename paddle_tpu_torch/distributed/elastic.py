"""Elastic membership stores and the TTL'd lease.

The port's own copy of the store half of
``paddle_tpu.distributed.elastic``: the key-value stores with per-key TTL
that membership and the PS high-availability failure detector
(``ps/ha.py``) heartbeat into, and :class:`Lease`, one TTL'd liveness key
refreshed from a daemon thread.

- :class:`MemoryStore`: in-process (tests, one-process clusters).
- :class:`FileStore`: one file per key in a shared directory, TTL by the
  write time (processes on one host or a shared filesystem).
- :class:`TcpElasticStore` and the ``tcp:`` spec raise
  :class:`~paddle_tpu_torch.core.enforce.UnavailableError`: they need the
  ``TCPStore``'s leases (``set(..., ttl=)``) and prefix ``list``, which
  come with the elastic launcher (ROADMAP Queue A item 8), as do
  ``ElasticManager`` and ``elastic_launch_local``.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.parse
from typing import Dict, Optional

from ..core import sync as _sync
from ..core.enforce import UnavailableError

__all__ = ["FileStore", "Lease", "MemoryStore", "TcpElasticStore", "store_from_spec"]

_TCP_MISSING = ("TcpElasticStore needs the TCPStore's leases (set(..., ttl=)) and prefix "
                "list, which are not ported yet (ROADMAP Queue A item 8, the elastic "
                "launcher); use MemoryStore or FileStore")


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


class FileStore:
    """The same interface over a shared directory: one file per key
    (percent-encoded name), the TTL counted from the write's wall time."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, urllib.parse.quote(key, safe=""))

    def put(self, key: str, value: str, ttl: float = 0.0) -> None:
        with open(self._path(key), "w") as f:
            json.dump({"v": value, "ttl": ttl, "t": time.time()}, f)

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
    """The elastic store over the cluster's ``TCPStore``: not ported
    (see the module docstring); constructing one raises."""

    def __init__(self, *args, **kwargs) -> None:
        raise UnavailableError(_TCP_MISSING)


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
    """An elastic store from a launcher-style spec: ``file:<dir>`` or
    ``memory:``; ``tcp:<host>:<port>`` raises (see the module
    docstring)."""
    kind, _, rest = spec.partition(":")
    if kind == "file":
        return FileStore(rest)
    if kind == "tcp":
        raise UnavailableError(_TCP_MISSING)
    if kind == "memory":
        return MemoryStore()
    raise ValueError(f"unknown elastic store spec {spec!r} "
                     f"(file:<dir> | tcp:<host>:<port> | memory:)")
