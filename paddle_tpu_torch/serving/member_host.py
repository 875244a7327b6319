"""Multi-host fleet members: one serving member per OS process, the port's
own copy of ``paddle_tpu.serving.member_host``.

- **child**: ``python -m paddle_tpu_torch.serving.member_host '<json>'``
  builds a full member in its own process: ``store_from_spec`` →
  :class:`~.replica.ServingReplica` (it subscribes to the training job's
  oplog feed through the same elastic store the cluster uses; a ``file:``
  spec crosses the process boundary), digest catch-up against the shard
  primary, ``HotEmbeddingTier(create_on_miss=False)`` on the config's
  ``device`` (default ``"cuda"``) and a
  :class:`~.lookup.CachedLookup`, a raw-rows
  :class:`~.frontend.ServingFrontend` (``infer=None``: the pipeline's
  retrieval fan-out wants embedding rows; scoring happens upstream), and a
  :class:`~.rollout.DenseModel` rollout identity whose sink puts the
  tower on that device. It then serves a length-prefixed binary TCP
  protocol and prints ``MEMBER_READY <lease_endpoint> <serve_addr>``
  (or ``MEMBER_FAILED <reason>``).
- **parent**: :func:`spawn_member` launches the child and wraps it in a
  standard :class:`~.fleet.FleetMember` whose pieces are proxies:
  :class:`RemoteFrontend` (a socket a worker thread, the router's
  frontend duck type), :class:`RemoteModel` (rollout ``set``/``identity``
  over the wire), and a replica shim whose ``status()`` is an RPC and
  whose liveness is the child's PID. ``lookup`` is None: a subprocess
  member joins cold (residency lives in the child).

``FleetMember.crash()`` SIGKILLs the child, so its observer lease expires
by TTL and the fleet's lease watch finds the death as it would a host
loss. The child watches its stdin and exits on EOF, so a dead parent
leaks no member process. A child pays a torch import and, on the card, a
CUDA context before it is ready (``ready_timeout_s``); its lease runs
from the replica's start, so ``hb_ttl`` must cover pauses of the child's
heartbeat thread after that.

The frames are the JAX module's byte for byte: request ``u32 length | u8
op | payload``, response ``u32 length | u8 status (0 ok / 1 error) |
payload``.
"""

from __future__ import annotations

import json
import os
import queue
import socket
import struct
import subprocess
import sys
# lock discipline (the JAX module's): `_MemberClient._mu` serializes one
# control socket a client and is a leaf (held across the round trip: the
# control plane is low-rate); `RemoteFrontend._mu` fences the inflight count
# and is a leaf
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core import sync as _sync
from ..core.device import resolve_device
from ..core.enforce import enforce
from .frontend import (DeadlineExceeded, PendingResult, RequestRejected,
                       _Request)

__all__ = ["spawn_member", "RemoteFrontend", "RemoteModel"]

#: what a member process runs (``python -m``)
CHILD_MODULE = "paddle_tpu_torch.serving.member_host"
#: the directory that holds the package (the child's import root)
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# wire ops (u8). Frame: u32 little-endian length | u8 op | payload;
# response: u32 length | u8 status (0 ok / 1 error) | payload.
_OP_LOOKUP = 1      # f32 deadline_ms | u32 n | n×u64 keys → u32 r | u32 c | f32
_OP_STATS = 2       # → JSON {replica, frontend, lookup, idle, stopped}
_OP_MODEL_SET = 3   # u32 jlen | JSON {version, expect_digest} | f32 flat
_OP_MODEL_GET = 4   # → JSON {version, digest}
_OP_RESET = 5       # reset frontend stats
_OP_WARM = 6        # u32 n | n×u64 keys → JSON {rows} (bulk admit)
_OP_STOP = 7        # graceful member shutdown
_ST_OK, _ST_ERR = 0, 1

#: error classes that cross the wire by name (everything else lands as
#: RuntimeError on the parent side)
_WIRE_ERRORS = {"DeadlineExceeded": DeadlineExceeded,
                "RequestRejected": RequestRejected}


# ---------------------------------------------------------------------------
# framing (shared by both sides)
# ---------------------------------------------------------------------------

def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("member connection closed")
        buf += chunk
    return bytes(buf)


def _send_frame(sock: socket.socket, tag: int, payload: bytes = b"") -> None:
    sock.sendall(struct.pack("<IB", len(payload) + 1, tag) + payload)


def _recv_frame(sock: socket.socket) -> Tuple[int, bytes]:
    (length,) = struct.unpack("<I", _recv_exact(sock, 4))
    enforce(1 <= length <= (1 << 30), f"member frame length {length} insane")
    body = _recv_exact(sock, length)
    return body[0], body[1:]


def _err_payload(e: BaseException) -> bytes:
    return f"{type(e).__name__}|{e}".encode()


def _raise_wire_error(payload: bytes) -> None:
    name, _, msg = payload.decode(errors="replace").partition("|")
    raise _WIRE_ERRORS.get(name, RuntimeError)(msg or name)


# ---------------------------------------------------------------------------
# parent side: proxies + spawn
# ---------------------------------------------------------------------------

class _MemberClient:
    """One control socket to the child, RPCs serialized under a lock
    (the control plane — stats/model/stop — is low-rate; the lookup hot
    path gets its own per-worker sockets in RemoteFrontend)."""

    def __init__(self, addr: str, connect_timeout_s: float = 10.0) -> None:
        host, port = addr.rsplit(":", 1)
        self._addr = (host, int(port))
        self._timeout = connect_timeout_s
        self._mu = _sync.Lock()
        self._sock: Optional[socket.socket] = None

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self._addr, timeout=self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def call(self, tag: int, payload: bytes = b"",
             timeout_s: float = 30.0) -> bytes:
        with self._mu:
            # one reconnect attempt: a fresh socket either works now or
            # the member is gone — the caller (router/fleet) owns retry
            # policy, a hidden retry loop here would double it
            for attempt in (0, 1):
                try:
                    if self._sock is None:
                        self._sock = self._connect()
                    self._sock.settimeout(timeout_s)
                    _send_frame(self._sock, tag, payload)
                    status, body = _recv_frame(self._sock)
                    break
                except (OSError, ConnectionError):
                    self._drop_locked()
                    if attempt:
                        raise
            if status == _ST_ERR:
                _raise_wire_error(body)
            return body

    def _drop_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._mu:
            self._drop_locked()


class RemoteFrontend:
    """Router-facing frontend duck type over the wire: ``submit`` hands
    the request to a worker pool (one socket per worker — concurrent
    lookups don't serialize), the child's REAL frontend does the
    coalescing/deadline work. The sub-request header carries the
    deadline verbatim — including a non-positive one (the router's
    expired-budget contract: the member drops it, not the proxy)."""

    def __init__(self, addr: str, workers: int = 4, queue_cap: int = 1024,
                 default_deadline_ms: float = 2000.0,
                 clock: Callable[[], float] = time.perf_counter,
                 idle_pop_s: float = 0.02) -> None:
        host, port = addr.rsplit(":", 1)
        self._addr = (host, int(port))
        self._clock = clock
        self.idle_pop_s = float(idle_pop_s)
        self.default_deadline_ms = float(default_deadline_ms)
        self._q: "queue.Queue[_Request]" = _sync.Queue(maxsize=queue_cap)
        self._stopping = _sync.Event()
        self._mu = _sync.Lock()
        self._inflight = 0
        self.proxy_errors = 0
        self._threads = []
        for i in range(int(workers)):
            t = _sync.Thread(target=self._worker, daemon=True,
                             name=f"member-proxy:{addr}#{i}")
            t.start()
            self._threads.append(t)

    def submit(self, keys, dense=None,
               deadline_ms: Optional[float] = None) -> PendingResult:
        if self._stopping.is_set():
            raise RequestRejected("member proxy stopped")
        dl_ms = (deadline_ms if deadline_ms is not None
                 else self.default_deadline_ms)
        keys = np.ascontiguousarray(keys, np.uint64).reshape(-1)
        req = _Request(keys, dense, self._clock() + dl_ms / 1e3)
        try:
            self._q.put_nowait(req)
        except queue.Full:
            raise RequestRejected("member proxy queue full") from None
        return PendingResult(req)

    def _worker(self) -> None:
        sock: Optional[socket.socket] = None
        while True:
            try:
                req = self._q.get(timeout=self.idle_pop_s)
            except queue.Empty:
                if self._stopping.is_set():
                    if sock is not None:
                        sock.close()
                    return
                continue
            with self._mu:
                self._inflight += 1
            try:
                if sock is None:
                    sock = socket.create_connection(self._addr, timeout=10.0)
                    sock.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                rem_ms = (req.deadline - self._clock()) * 1e3
                payload = (struct.pack("<fI", rem_ms, len(req.keys))
                           + np.ascontiguousarray(req.keys,
                                                  np.uint64).tobytes())
                sock.settimeout(max(rem_ms, 0.0) / 1e3 + 30.0)
                _send_frame(sock, _OP_LOOKUP, payload)
                status, body = _recv_frame(sock)
                if status == _ST_ERR:
                    _raise_wire_error(body)
                r, c = struct.unpack_from("<II", body)
                rows = np.frombuffer(body, np.float32, r * c,
                                     8).reshape(r, c).copy()
                req.deliver(rows)
            except BaseException as e:  # noqa: BLE001 — delivered to caller
                if sock is not None and isinstance(
                        e, (OSError, ConnectionError)):
                    sock.close()
                    sock = None
                with self._mu:
                    self.proxy_errors += 1
                req.fail(e)
            finally:
                with self._mu:
                    self._inflight -= 1

    # -- router/fleet surface ---------------------------------------------

    @property
    def queue_depth(self) -> int:
        with self._mu:
            inflight = self._inflight
        return self._q.qsize() + inflight

    @property
    def stopped(self) -> bool:
        return self._stopping.is_set()

    def idle(self) -> bool:
        with self._mu:
            inflight = self._inflight
        return self._q.qsize() == 0 and inflight == 0

    def stats(self) -> Dict[str, Any]:
        """The CHILD frontend's stats (the real served/shed/latency
        numbers), annotated with proxy-side depth/errors."""
        ctl = _MemberClient(f"{self._addr[0]}:{self._addr[1]}")
        try:
            out = json.loads(ctl.call(_OP_STATS).decode()).get(
                "frontend", {})
        except (OSError, ConnectionError, RuntimeError) as e:
            out = {"proxy_unreachable": str(e)}
        finally:
            ctl.close()
        with self._mu:
            out["proxy_errors"] = self.proxy_errors
        out["proxy_queue_depth"] = self._q.qsize()
        return out

    def reset_stats(self) -> None:
        with self._mu:
            self.proxy_errors = 0

    def stop(self) -> None:
        self._stopping.set()
        for t in self._threads:
            t.join(timeout=10)
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            req.fail(RequestRejected("frontend stopped"))


class RemoteModel:
    """Rollout identity over the wire (the RolloutManager member
    protocol: ``set(version, flat, expect_digest)`` / ``identity()``).
    Digest pinning runs in the CHILD (its DenseModel refuses mismatched
    bytes); the refusal surfaces here as the wire error."""

    def __init__(self, ctl: _MemberClient) -> None:
        self._ctl = ctl

    def set(self, version: int, flat: np.ndarray,
            expect_digest: Optional[int] = None) -> int:
        flat = np.ascontiguousarray(flat, np.float32)
        hdr = json.dumps({"version": int(version),
                          "expect_digest": expect_digest}).encode()
        out = self._ctl.call(_OP_MODEL_SET,
                             struct.pack("<I", len(hdr)) + hdr
                             + flat.tobytes())
        return int(json.loads(out.decode())["digest"])

    def identity(self) -> Tuple[int, int]:
        doc = json.loads(self._ctl.call(_OP_MODEL_GET).decode())
        return int(doc["version"]), int(doc["digest"])


class _RemoteReplica:
    """Replica-shaped shim: endpoint is the CHILD's lease endpoint (the
    fleet's lease watch and the primary's shipper both key on it),
    liveness is the child PID, status() is an RPC. ``.server`` is self
    so ``member.replica.server.stopped`` keeps working."""

    def __init__(self, endpoint: str, ctl: _MemberClient,
                 proc: subprocess.Popen) -> None:
        self.endpoint = endpoint
        self._ctl = ctl
        self._proc = proc
        self.server = self          # .server.stopped duck type

    @property
    def stopped(self) -> bool:
        return self._proc.poll() is not None

    def status(self) -> Dict[str, Any]:
        try:
            doc = json.loads(self._ctl.call(_OP_STATS).decode())
            out = doc.get("replica", {})
            out["multi_host"] = True
            out["pid"] = self._proc.pid
            return out
        except (OSError, ConnectionError, RuntimeError) as e:
            return {"endpoint": self.endpoint, "multi_host": True,
                    "pid": self._proc.pid, "unreachable": str(e)}

    def kill(self) -> None:
        """SIGKILL — the lease expires by TTL, exactly a host loss."""
        self._ctl.close()
        if self._proc.poll() is None:
            self._proc.kill()
        self._proc.wait(timeout=10)

    def stop(self) -> None:
        try:
            self._ctl.call(_OP_STOP, timeout_s=10.0)
        except (OSError, ConnectionError, RuntimeError):
            pass                     # already gone — reap below
        self._ctl.close()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait(timeout=10)

    def close(self) -> None:
        self.stop()


def spawn_member(store_spec: str, job_id: str, *, shard: int = 0,
                 table_id: int = 0, embedx_dim: int = 8,
                 shard_num: int = 4, capacity: int = 1 << 15,
                 dense_len: int = 16,
                 freshness_budget_s: float = 30.0,
                 max_batch: int = 64, max_delay_us: int = 1000,
                 queue_cap: int = 2048,
                 default_deadline_ms: float = 2000.0,
                 prime_pow2_max: int = 0,
                 hb_interval: float = 0.05, hb_ttl: float = 0.5,
                 proxy_workers: int = 4,
                 ready_timeout_s: float = 120.0,
                 host: str = "127.0.0.1",
                 device: Optional[str] = None):
    """Launch one member child process and wrap it as a FleetMember
    (``lookup=None`` — cold join; warming happens inside the child via
    the WARM op if the caller wants it). ``store_spec`` must be a spec
    both processes can reach — ``file:<dir>`` in practice. ``device``
    (default ``"cuda"``; raises without a GPU unless ``"cpu"``) is where
    the child keeps its tier, gathers and dense tower. The child runs
    ``python -m paddle_tpu_torch.serving.member_host`` with this checkout
    first on its ``PYTHONPATH``."""
    from .fleet import FleetMember    # local: avoid import cycle
    dev = resolve_device(device)
    cfg = {"store": store_spec, "job_id": job_id, "shard": int(shard),
           "table_id": int(table_id), "embedx_dim": int(embedx_dim),
           "shard_num": int(shard_num), "capacity": int(capacity),
           "dense_len": int(dense_len),
           "freshness_budget_s": float(freshness_budget_s),
           "max_batch": int(max_batch), "max_delay_us": int(max_delay_us),
           "queue_cap": int(queue_cap),
           "default_deadline_ms": float(default_deadline_ms),
           "prime_pow2_max": int(prime_pow2_max),
           "hb_interval": float(hb_interval), "hb_ttl": float(hb_ttl),
           "host": host, "device": str(dev)}
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_CHECKOUT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.Popen(
        [sys.executable, "-m", CHILD_MODULE, json.dumps(cfg)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, env=env)
    lines: "queue.Queue[str]" = _sync.Queue(maxsize=256)
    log: deque = deque(maxlen=64)

    def _read_stdout() -> None:
        for line in proc.stdout:     # drains for the child's lifetime
            log.append(line.rstrip())
            try:
                lines.put_nowait(line.strip())
            except queue.Full:
                pass

    reader = _sync.Thread(target=_read_stdout, daemon=True,
                          name=f"member-stdout:{job_id}/{shard}")
    reader.start()
    deadline = time.perf_counter() + float(ready_timeout_s)
    lease_ep = serve_addr = None
    while True:
        rem = deadline - time.perf_counter()
        if rem <= 0 or proc.poll() is not None:
            proc.kill()
            raise TimeoutError(
                f"member child never became ready (rc={proc.poll()}); "
                f"last output: {list(log)[-5:]}")
        try:
            line = lines.get(timeout=min(rem, 0.5))
        except queue.Empty:
            continue
        if line.startswith("MEMBER_READY "):
            _, lease_ep, serve_addr = line.split()
            break
        if line.startswith("MEMBER_FAILED"):
            proc.kill()
            raise RuntimeError(f"member child failed: {line}")
    ctl = _MemberClient(serve_addr)
    frontend = RemoteFrontend(serve_addr, workers=proxy_workers,
                              queue_cap=queue_cap,
                              default_deadline_ms=default_deadline_ms)
    replica = _RemoteReplica(lease_ep, ctl, proc)
    model = RemoteModel(ctl)

    def _reap() -> None:
        try:
            proc.stdin.close()
        except OSError:
            pass
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)

    member = FleetMember(replica, None, frontend, model=model,
                         extra_close=_reap)
    member.serve_addr = serve_addr
    member.warm = lambda keys: json.loads(ctl.call(
        _OP_WARM, struct.pack("<I", len(keys))
        + np.ascontiguousarray(keys, np.uint64).tobytes(),
        timeout_s=120.0).decode())["rows"]
    return member


# ---------------------------------------------------------------------------
# child side
# ---------------------------------------------------------------------------

def _child_main(cfg: Dict[str, Any]) -> int:
    # heavyweight imports live here: the parent pays none of them
    from ..distributed.elastic import store_from_spec
    from ..ps.ha import RoutingTable
    from ..ps.hot_tier import HotEmbeddingTier, HotTierConfig
    import torch

    from ..ps.accessor import AccessorConfig
    from ..ps.rpc import RpcPsClient
    from ..ps.sgd_rule import SGDRuleConfig
    from ..ps.table import TableConfig
    from .frontend import FrontendConfig, ServingFrontend
    from .lookup import CachedLookup
    from .replica import ServingReplica
    from .rollout import DenseModel

    dev = resolve_device(cfg.get("device"))
    store = store_from_spec(cfg["store"])
    job_id = str(cfg["job_id"])
    shard = int(cfg.get("shard", 0))
    table_id = int(cfg.get("table_id", 0))
    xd = int(cfg.get("embedx_dim", 8))
    rep = ServingReplica(store, job_id, shard=shard,
                         host=str(cfg.get("host", "127.0.0.1")),
                         hb_interval=float(cfg.get("hb_interval", 0.05)),
                         hb_ttl=float(cfg.get("hb_ttl", 0.5)))
    serve = rep.client()
    tcfg = TableConfig(shard_num=int(cfg.get("shard_num", 4)),
                       accessor_config=AccessorConfig(
                           embedx_dim=xd, embedx_threshold=0.0,
                           sgd=SGDRuleConfig(initial_range=0.01)))
    view = rep.serve_view(table_id, tcfg, client=serve)

    # digest catch-up against the shard primary (same recipe as the
    # in-process fleet bench, but resolved through the routing document
    # — the only cross-process handle we have)
    rt = RoutingTable(store, job_id)
    deadline = time.perf_counter() + float(cfg.get("catchup_timeout_s", 60.0))
    prim_cli, prim_ep = None, None
    delay = 0.005
    while True:
        try:
            _, shards = rt.read()
            ep = shards[shard]["primary"] if shard < len(shards) else None
            if ep and ep != prim_ep:
                if prim_cli is not None:
                    prim_cli.close()
                prim_cli = RpcPsClient([ep], qos="serve")
                prim_ep = ep
            if prim_cli is not None and \
                    prim_cli.digest(table_id)[0] == serve.digest(table_id)[0]:
                break
        except Exception:  # noqa: BLE001 — primary mid-failover; retry
            pass
        if time.perf_counter() > deadline:
            print("MEMBER_FAILED catch-up timeout", flush=True)
            return 2
        time.sleep(delay)
        delay = min(delay * 2, 0.1)
    if prim_cli is not None:
        prim_cli.close()

    tier = HotEmbeddingTier(view, HotTierConfig(
        capacity=int(cfg.get("capacity", 1 << 15)), create_on_miss=False), device=dev)
    lookup = CachedLookup(tier, replica=rep,
                          freshness_budget_s=float(
                              cfg.get("freshness_budget_s", 30.0)))
    # the live tower on the member's device (what a dense infer would read)
    live: Dict[str, Any] = {}
    model = DenseModel(lambda flat: flat,
                       np.zeros(int(cfg.get("dense_len", 16)), np.float32),
                       sink=lambda flat: live.__setitem__(
                           "tower", torch.from_numpy(np.array(flat)).to(dev)))
    fe = ServingFrontend(lookup, infer=None,
                         config=FrontendConfig(
                             max_batch=int(cfg.get("max_batch", 64)),
                             max_delay_us=int(cfg.get("max_delay_us", 1000)),
                             queue_cap=int(cfg.get("queue_cap", 2048)),
                             default_deadline_ms=float(
                                 cfg.get("default_deadline_ms", 2000.0))),
                         replica_label=rep.endpoint)
    # warm the gather's kernels at batch sizes 1, 2, 4, ... (a kernel's
    # first launch pays its module load), then drop the residency this
    # left behind (a cold join stays cold)
    prime = int(cfg.get("prime_pow2_max", 0))
    if prime > 0:
        b = 1
        while b <= prime:
            lookup.lookup(np.arange(b, dtype=np.uint64))
            b <<= 1
        tier.drop()

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((str(cfg.get("host", "127.0.0.1")),
              int(cfg.get("serve_port", 0))))
    srv.listen(64)
    serve_addr = f"{srv.getsockname()[0]}:{srv.getsockname()[1]}"
    # the child's own interpreter: plain threading (the sync shims serve
    # schedule exploration inside one process)
    stop_ev = threading.Event()

    def _on_parent_eof() -> None:
        # parent death (or deliberate stdin close) must never leak a
        # member process holding a lease + TCP port
        try:
            sys.stdin.buffer.read()
        except OSError:
            pass
        stop_ev.set()
        os._exit(0)

    threading.Thread(
        target=_on_parent_eof, daemon=True,
        name="member-parent-watch").start()

    def _handle(conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while not stop_ev.is_set():
                try:
                    tag, payload = _recv_frame(conn)
                except (ConnectionError, OSError):
                    return
                try:
                    if tag == _OP_LOOKUP:
                        dl_ms, n = struct.unpack_from("<fI", payload)
                        keys = np.frombuffer(payload, np.uint64, n, 8)
                        rows = fe.submit(keys, None,
                                         deadline_ms=float(dl_ms)).result(
                            timeout=max(dl_ms, 0.0) / 1e3 + 30.0)
                        rows = np.ascontiguousarray(rows, np.float32)
                        if rows.ndim == 1:
                            rows = rows[None, :]
                        out = (struct.pack("<II", rows.shape[0],
                                           rows.shape[1]) + rows.tobytes())
                        _send_frame(conn, _ST_OK, out)
                    elif tag == _OP_STATS:
                        doc = {"replica": rep.status(),
                               "frontend": fe.stats(),
                               "lookup": lookup.stats(),
                               "idle": fe.idle(), "stopped": fe.stopped}
                        _send_frame(conn, _ST_OK, json.dumps(doc).encode())
                    elif tag == _OP_MODEL_SET:
                        (jlen,) = struct.unpack_from("<I", payload)
                        hdr = json.loads(payload[4:4 + jlen].decode())
                        flat = np.frombuffer(payload, np.float32,
                                             offset=4 + jlen)
                        dg = model.set(int(hdr["version"]), flat,
                                       expect_digest=hdr.get("expect_digest"))
                        _send_frame(conn, _ST_OK,
                                    json.dumps({"digest": dg}).encode())
                    elif tag == _OP_MODEL_GET:
                        v, dg = model.identity()
                        _send_frame(conn, _ST_OK, json.dumps(
                            {"version": v, "digest": dg}).encode())
                    elif tag == _OP_RESET:
                        fe.reset_stats()
                        _send_frame(conn, _ST_OK)
                    elif tag == _OP_WARM:
                        (n,) = struct.unpack_from("<I", payload)
                        keys = np.frombuffer(payload, np.uint64, n, 4)
                        rows = lookup.admit(keys)
                        _send_frame(conn, _ST_OK, json.dumps(
                            {"rows": int(rows)}).encode())
                    elif tag == _OP_STOP:
                        _send_frame(conn, _ST_OK)
                        stop_ev.set()
                        return
                    else:
                        _send_frame(conn, _ST_ERR,
                                    f"RuntimeError|unknown op {tag}".encode())
                except BaseException as e:  # noqa: BLE001 — to the wire
                    try:
                        _send_frame(conn, _ST_ERR, _err_payload(e))
                    except OSError:
                        return
        finally:
            conn.close()

    print(f"MEMBER_READY {rep.endpoint} {serve_addr}", flush=True)
    srv.settimeout(0.2)
    handlers: List[threading.Thread] = []
    while not stop_ev.is_set():
        try:
            conn, peer = srv.accept()
        except socket.timeout:
            continue
        except OSError:
            break
        t = threading.Thread(
            target=_handle, args=(conn,), daemon=True,
            name=f"member-conn:{peer[1]}")
        t.start()
        handlers.append(t)
        handlers = [h for h in handlers if h.is_alive()]
    srv.close()
    fe.stop()
    rep.close()
    return 0


def main(argv: List[str]) -> int:
    enforce(len(argv) == 1, f"usage: python -m {CHILD_MODULE} '<json config>'")
    try:
        return _child_main(json.loads(argv[0]))
    except BaseException as e:
        # the parent reads stdout only: say why before dying
        print(f"MEMBER_FAILED {type(e).__name__}: {e}", flush=True)
        raise


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
